"""The QCQP handler, the package's public entry object
(JAX counterpart: qcqp_tpu/api.py).

Mirrors the behavioral contract of the reference class (reference:
qcqp/qcqp.py:367-432): canonicalize once, dispatch suggest/improve by method
constant, sync the flat iterate with the modeling variables, return
(objective, max violation) pairs with the maximize sign convention
un-negated on report.

The port runs every method of the JAX handler: the RANDOM, SDR and
SPECTRAL suggests and the COORD_DESCENT, ADMM, DCCP and IPOPT improves
(single restarts through `improve`, restart batches through `solve`).
The relaxations' solutions are cached on the handler (`sdr_sol`,
`sdr_bound`, `mu`, `_sigma_chol`; `spectral_sol`, `spectral_bound`), as in
the JAX handler, and carried by save_state / load_state; on a CUDA float32
form they are solved on the card (solvers/sdp.py).  On such a form a
single-restart ADMM goes through K3, with its one-time setup cached per
rho on the handler, and a single-restart DCCP through K4, with its setup
cached once, as the JAX handler does.

Randomness is a torch.Generator on the form's device, seeded by the `seed`
argument; `improve` before any `suggest` auto-suggests RANDOM, as in the
JAX package.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from . import settings as s
from .core import default_device, default_dtype, eval_objective, max_violation
from .expressions import Problem, canonicalize
from .kernels import admm_kernel, ccp_kernel
from .parallel.restarts import _fused_default, sdr_sampler, solve_restarts
from .solvers.admm import improve_admm, min_valid_rho
from .solvers.ccp import improve_ccp
from .solvers.coord_descent import improve_coord_descent
from .solvers.nlp import improve_nlp
from .solvers.sdp import solve_sdr, solve_spectral

logger = logging.getLogger("qcqp_tpu_torch")


def enable_file_log(path: str = "qcqp.log", level=logging.INFO) -> None:
    """Opt-in file logging, the reference's qcqp.log pattern
    (reference: qcqp/qcqp.py:39)."""
    handler = logging.FileHandler(path, mode="w")
    handler.setFormatter(logging.Formatter("%(levelname)s:%(name)s:%(message)s"))
    logger.addHandler(handler)
    logger.setLevel(level)


class QCQP:
    def __init__(self, prob: Problem, seed: int = 0, dtype=None,
                 device=None, check_dcp: bool = True):
        """device: where the form lives (default: the current CUDA device,
        core.default_device, as the JAX package defaults to its accelerator
        backend; without a card the caller must pass device="cpu").
        dtype: default float64 on the CPU, float32 on CUDA, as the JAX
        package picks by backend (qcqp_tpu/api.py:63-66)."""
        device = default_device(device)
        if dtype is None:
            dtype = default_dtype(device)
        logger.info("QCQP on %s, %s", device, dtype)
        self.prob = prob
        self.device = device
        self.qcqp_form, self.layout, self.maximize_flag = canonicalize(
            prob, dtype, device)
        self.n = self.layout.n
        self.m = self.qcqp_form.m
        if check_dcp and prob.is_dcp():
            logger.warning(
                "Problem is already convex; specifying solve method is unnecessary."
            )
        self.spectral_sol = None
        self.spectral_bound = None
        self.sdr_sol = None
        self.sdr_bound = None
        self.mu = None
        self._sigma_chol = None
        self.generator = torch.Generator(device=device).manual_seed(seed)
        self._admm_fused = {}      # rho (or None) -> ADMMFusedData
        self._ccp_fused = None     # CCPFusedData

    # -- reporting ---------------------------------------------------------
    def _report(self, x: torch.Tensor) -> tuple:
        form = self.qcqp_form
        x = x.to(form.dtype)
        return self._assign(x, eval_objective(form, x), max_violation(form, x))

    def _assign(self, x, f, v) -> tuple:
        """Write x to the variables and return (objective, violation), the
        objective un-negated for a maximization; one host read."""
        out = torch.cat([x, torch.stack([f, v])]).cpu().numpy()
        self.layout.assign(out[:-2])
        f0 = float(out[-2])
        if self.maximize_flag:
            f0 = -f0
        return f0, float(out[-1])

    # -- suggest -----------------------------------------------------------
    def suggest(self, method: str = s.RANDOM, eps: float = 1e-8, **kwargs):
        """RANDOM: a standard normal point.  SPECTRAL: the spectral
        relaxation's point (solved once, cached).  SDR: a sample of
        N(mu, Sigma) from the Shor relaxation's lifted solution X (solved
        once, cached; see parallel/restarts.sdr_sampler).  kwargs go to
        solve_spectral or solve_sdr."""
        if method not in s.suggest_methods:
            raise ValueError(f"Unknown suggest method: {method}")
        if method == s.RANDOM:
            x = torch.randn((self.n,), generator=self.generator,
                            dtype=self.qcqp_form.dtype, device=self.device)
        elif method == s.SPECTRAL:
            if self.spectral_sol is None:
                xs, bound = solve_spectral(self.qcqp_form, **kwargs)
                self.spectral_sol = xs
                self.spectral_bound = float(bound)
                if self.maximize_flag:
                    self.spectral_bound *= -1
            x = self.spectral_sol
        else:                                   # SDR
            if self.sdr_sol is None:
                X, bound = solve_sdr(self.qcqp_form, **kwargs)
                self.sdr_sol = X
                self.sdr_bound = float(bound)
                if self.maximize_flag:
                    self.sdr_bound *= -1
                self.mu, self._sigma_chol = sdr_sampler(X, eps)
            xi = torch.randn((self.n,), generator=self.generator,
                             dtype=self.mu.dtype, device=self.device)
            x = self.mu + self._sigma_chol @ xi
        return self._report(x)

    # -- improve -----------------------------------------------------------
    def _improve_one(self, method: str, x0: torch.Tensor, **kwargs):
        if method == s.COORD_DESCENT:
            return improve_coord_descent(
                self.qcqp_form, x0,
                num_iters=kwargs.get("num_iters", 1000),
                viol_tol=kwargs.get("viol_tol", 1e-2),
                tol=kwargs.get("tol", 1e-4),
                phase1=kwargs.get("phase1", True),
            )
        if method == s.ADMM:
            return self._improve_admm(x0, **kwargs)
        if method == s.DCCP:
            return self._improve_ccp(x0, **kwargs)
        if method == s.IPOPT:
            return improve_nlp(self.qcqp_form, x0[None], **{
                k: v for k, v in kwargs.items()
                if k in ("num_outer", "num_inner", "mu0")})[0]
        raise ValueError(f"Unknown improve method: {method}")

    def _improve_ccp(self, x0: torch.Tensor, **kwargs):
        form = self.qcqp_form
        tau = kwargs.get("tau", 0.005)
        if (kwargs.get("use_fused", _fused_default(form))
                and not kwargs.get("use_eigen_split", False)
                and ccp_kernel.takes(form)):
            # K4, with the one-time setup cached on the handler; a single
            # restart spends 40 inner trips by default, as the JAX handler
            # does (qcqp_tpu/api.py:205-209)
            if self._ccp_fused is None:
                self._ccp_fused = ccp_kernel.CCPFusedData(form)
            out = ccp_kernel.improve_ccp_fused(
                form, x0[None], tau=tau, data=self._ccp_fused,
                inner_iters=kwargs.get("inner_iters", 40),
                **{k: v for k, v in kwargs.items()
                   if k in ("max_iter", "mu", "tau_max", "warm_inner")})
            return out[0].to(form.dtype)
        return improve_ccp(
            form, x0, tau=tau,
            use_eigen_split=kwargs.get("use_eigen_split", False),
            **{k: v for k, v in kwargs.items()
               if k in ("max_iter", "mu", "tau_max", "inner_iters")})

    def _improve_admm(self, x0: torch.Tensor, **kwargs):
        form = self.qcqp_form
        rho = kwargs.get("rho", None)
        if rho is not None:
            min_rho = float(min_valid_rho(form))
            if rho < min_rho:
                raise ValueError(
                    f"rho parameter is too small, need at least {min_rho:.3f}."
                )
        common = dict(num_iters=kwargs.get("num_iters", 1000),
                      viol_lim=kwargs.get("viol_lim", 1e4),
                      tol=kwargs.get("tol", 1e-2),
                      phase1=kwargs.get("phase1", True))
        if (admm_kernel.takes(form)
                and kwargs.get("use_fused", _fused_default(form))):
            # K3, with the one-time setup cached per rho like the
            # reference's z-solver cache (qcqp/qcqp.py:224-227)
            key = None if rho is None else float(rho)
            data = self._admm_fused.get(key)
            if data is None:
                data = self._admm_fused[key] = admm_kernel.ADMMFusedData(
                    form, rho)
            out = admm_kernel.improve_admm_fused(form, x0[None], rho=rho,
                                                 data=data, **common)
            return out[0].to(form.dtype)
        return improve_admm(form, x0, rho, **common)

    def improve(self, method, **kwargs):
        methods = method if isinstance(method, list) else [method]
        for mth in methods:
            if mth not in s.improve_methods:
                raise ValueError(f"Unknown improve method(s): {methods}")
        # Auto-suggest if no variable has a value yet (qcqp.py:427-428).
        if any(v.value is None for v in self.prob.variables()):
            self.suggest()
        result = None
        for mth in methods:
            x0 = torch.as_tensor(self.layout.flatten(),
                                 dtype=self.qcqp_form.dtype,
                                 device=self.device)
            x = self._improve_one(mth, x0, **kwargs)
            result = self._report(x)
            logger.info("improve(%s): objective %.6f, violation %.6f",
                        mth, result[0], result[1])
        return result

    # -- checkpoint / resume -----------------------------------------------
    def save_state(self, path: str) -> None:
        """Persist the generator state, the SDR and spectral caches and the
        variable values, so a run resumes without re-solving an SDP (.npz;
        the JAX handler's fields, qcqp_tpu/api.py:249-270, with the
        generator state in place of the PRNG key).  A JAX handler's file
        loads through convert.load_jax_state instead."""
        payload = {"torch_rng_state": self.generator.get_state().numpy()}
        if self.sdr_sol is not None:
            payload.update(sdr_sol=self.sdr_sol.cpu().numpy(),
                           sdr_bound=np.asarray(self.sdr_bound),
                           mu=self.mu.cpu().numpy(),
                           sigma_chol=self._sigma_chol.cpu().numpy())
        if self.spectral_sol is not None:
            payload.update(spectral_sol=self.spectral_sol.cpu().numpy(),
                           spectral_bound=np.asarray(self.spectral_bound))
        try:
            payload["x"] = self.layout.flatten()
        except ValueError:
            pass
        np.savez(path, **payload)

    def load_state(self, path: str) -> None:
        if not path.endswith(".npz"):
            path = path + ".npz"
        with np.load(path) as z:
            if "torch_rng_state" in z.files:
                self.generator.set_state(
                    torch.from_numpy(z["torch_rng_state"].copy()))
            self._load_relaxations(z)
            if "x" in z.files:
                self.layout.assign(z["x"])

    def _load_relaxations(self, z) -> None:
        """The SDR and spectral caches of a saved state (this package's or
        the JAX handler's .npz), onto the handler's device and dtype."""
        def t(name):
            return torch.as_tensor(z[name], dtype=self.qcqp_form.dtype,
                                   device=self.device)
        if "sdr_sol" in z.files:
            self.sdr_sol = t("sdr_sol")
            self.sdr_bound = float(z["sdr_bound"])
            self.mu = t("mu")
            self._sigma_chol = t("sigma_chol")
        if "spectral_sol" in z.files:
            self.spectral_sol = t("spectral_sol")
            self.spectral_bound = float(z["spectral_bound"])

    # -- batched multi-restart solve ---------------------------------------
    def solve(self, num_restarts: int = 32, suggest: str = s.RANDOM,
              improve=s.COORD_DESCENT,
              generator: Optional[torch.Generator] = None, **kwargs):
        """Run `num_restarts` suggest+improve chains as one batch and keep
        the best point under the (violation bucket, objective) order."""
        x, f, v = solve_restarts(
            self.qcqp_form, num_restarts,
            self.generator if generator is None else generator,
            suggest=suggest, improve=improve, handler=self, **kwargs)
        return self._assign(x, f, v)
