"""Scenario-parallel serving: a batch of independent QCQP instances solved
together (JAX counterpart: examples/scenario_serving.py).

Pipeline: generate an instance bank -> write/load it through the native
threaded problem-bank IO -> batched SDR relaxation (on the card, the
instances in one batch) -> Gaussian rounding -> batched multi-start
coordinate descent (on the card, one K1 launch for every scenario and
restart) -> per-scenario best points.
Run: python -m qcqp_tpu_torch.examples.scenario_serving
"""

import os
import tempfile

import numpy as np
import torch

import qcqp_tpu_torch
from qcqp_tpu_torch import native
from qcqp_tpu_torch.parallel.scenarios import (forms_from_bank,
                                               solve_scenarios, stack_forms)
from qcqp_tpu_torch.solvers.sdp import solve_sdr_batch

S, n, m = 8, 12, 12  # scenarios x problem size


def problem(qt):
    """The example's S boolean least-squares Problems, built with the
    package module `qt`, in order (one numpy generator draws them all)."""
    rng = np.random.default_rng(0)
    probs = []
    for _ in range(S):
        A = rng.standard_normal((m, n))
        b = rng.standard_normal(m)
        x = qt.Variable(n)
        probs.append(qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                                [qt.square(x) == 1]))
    return probs


def main(workdir=None, device=None, generator=None) -> dict:
    """Write the bank into `workdir` (default: a temporary directory,
    removed on return), load it onto `device`, solve; returns every
    printed number, and the loaded stack's device and dtype."""
    qt = qcqp_tpu_torch
    # --- build S boolean least-squares instances and persist them as a
    # bank (canonicalized in float64 on the host) ---------------------------
    forms = [qt.canonicalize(prob, torch.float64, "cpu")[0]
             for prob in problem(qt)]
    stacked = stack_forms(forms)
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        bank = os.path.join(tmp, "instances.qcqp")
        native.bank_write(bank, *(a.numpy() for a in stacked))
        print(f"bank: {S} instances (n={n}, m={m}) ->", bank)

        # --- load the batch back and solve end-to-end ----------------------
        loaded = forms_from_bank(bank, device=device)
    out = {"device": str(loaded.device), "dtype": str(loaded.dtype),
           "S": S, "n": n, "m": m}

    # batched SDR bounds (one batched splitting solve)
    X, bounds, rp, rd = solve_sdr_batch(loaded, max_iters=4000, tol=1e-7)
    out["sdr_bounds"] = b_ = bounds.double().cpu().numpy()
    out["sdr_max_residual"] = float(torch.maximum(rp, rd).max())
    print("SDR bounds:", np.round(b_, 3))

    # batched suggest+improve+reduce: 64 restarts per scenario
    if generator is None:
        generator = torch.Generator(device=loaded.device).manual_seed(0)
    xs, fs, vs = solve_scenarios(loaded, num_restarts=64,
                                 generator=generator,
                                 improve=qt.COORD_DESCENT)
    out["x_shape"] = tuple(xs.shape)
    out["best_f"] = fs_ = fs.double().cpu().numpy()
    out["best_viol"] = vs_ = vs.double().cpu().numpy()
    print("best objectives:", np.round(fs_, 3))
    print("max violations :", np.round(vs_, 4))
    assert (vs_ < 1e-2).all()
    assert (fs_ >= b_ - 1e-3).all()
    print("all scenarios feasible; objectives dominate their SDR lower bounds")
    return out


if __name__ == "__main__":
    main()
