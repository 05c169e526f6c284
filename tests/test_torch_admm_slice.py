"""The ADMM slice end to end on the CPU: qcqp_tpu_torch's improve_chain,
solve_restarts and QCQP handler with ADMM, against qcqp_tpu's from the same
numpy starts, the routing rule to K3 and away from it, the per-rho setup
cache, the rho check, and the example chain CD -> ADMM(phase1=False) of
examples/boolean_least_squares.py:45-47."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import qcqp_tpu as jqt
from qcqp_tpu import core as jcore
from qcqp_tpu.core import QCQPForm as JForm
from qcqp_tpu.parallel import restarts as jrestarts

import qcqp_tpu_torch as tqt
from qcqp_tpu_torch import core as tcore
from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.kernels import admm_kernel
from qcqp_tpu_torch.parallel import restarts as trestarts
from qcqp_tpu_torch.solvers import admm as tadmm

torch.set_num_threads(1)


def boolean_ls(qt, n=8, m=12, seed=4):
    rs = np.random.RandomState(seed)
    A, b = rs.randn(m, n), rs.randn(m)
    x = qt.Variable(n)
    return qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                      [qt.square(x) == 1]), x


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("fused", [False, True])
def test_improve_chain_and_best_point_match_jax(fused):
    """Unfused in float64 (the same algorithm: best points agree to 1e-8)
    and fused in float32 (the port's plain K3 against JAX's interpret-mode
    kernel: on this nonconvex form float32 roundoff sends single restarts
    on other paths, so over 128 restarts the best point's violation and
    the 10th and 50th percentiles of the violations agree to 3e-2)."""
    jprob, _ = boolean_ls(jqt)
    jform = jqt.QCQP(jprob).qcqp_form
    arrays = [np.asarray(a) for a in jform]
    if fused:
        arrays = [a.astype(np.float32) if a.dtype == np.float64 else a
                  for a in arrays]
        jform = JForm(*(jnp.asarray(a) for a in arrays))
    tform = form_from_numpy(
        *arrays, device="cpu",
        dtype=torch.float32 if fused else torch.float64)
    xs = np.random.default_rng(5).standard_normal((128, tform.n))
    xs = xs.astype(arrays[0].dtype)
    kw = dict(num_iters=40, use_fused=fused)
    xj = jrestarts.improve_chain(jform, jnp.asarray(xs), jqt.ADMM,
                                 interpret=True, **kw)
    _, fj, vj = jrestarts.best_point(jform, xj)
    xt = trestarts.improve_chain(tform, torch.from_numpy(xs), tqt.ADMM, **kw)
    assert xt.dtype == tform.dtype
    _, ft, vt = trestarts.best_point(tform, xt)
    if fused:
        assert float(vt) <= float(vj) + 3e-2
        pj = np.percentile(np.asarray(jrestarts.jax.vmap(
            lambda z: jcore.max_violation(jform, z))(xj)), [10, 50])
        pt = np.percentile(tcore.max_violation_batch(tform, xt).numpy(),
                           [10, 50])
        np.testing.assert_allclose(pt, pj, atol=3e-2)
    else:
        np.testing.assert_allclose(float(ft), float(fj), rtol=1e-8)
        np.testing.assert_allclose(float(vt), float(vj), atol=1e-8)


def test_solve_restarts_routes_admm_through_k3(monkeypatch):
    """With the CUDA-float32 default patched on, solve_restarts(improve=ADMM)
    builds the setup once and runs improve_admm_fused (here the plain K3),
    alone and after CD; use_fused=False takes the unfused path."""
    monkeypatch.setattr(trestarts, "_fused_default", lambda form: True)
    calls = _spy(monkeypatch, admm_kernel, "improve_admm_fused")
    setups = _spy(monkeypatch, admm_kernel, "ADMMFusedData")
    prob, _ = boolean_ls(tqt)
    form = tqt.QCQP(prob, dtype=np.float32, device="cpu").qcqp_form
    gen = lambda: torch.Generator().manual_seed(0)
    x, f, v = trestarts.solve_restarts(form, 32, gen(), improve=tqt.ADMM,
                                       num_iters=10)
    assert calls and len(setups) == 1
    assert x.shape == (form.n,) and torch.isfinite(f)
    calls.clear()
    trestarts.solve_restarts(form, 32, gen(),
                             improve=[tqt.COORD_DESCENT, tqt.ADMM],
                             num_iters=10)
    assert calls
    calls.clear()
    unfused = _spy(monkeypatch, trestarts, "improve_admm_batch")
    trestarts.solve_restarts(form, 8, gen(), improve=tqt.ADMM,
                             num_iters=5, use_fused=False)
    assert unfused and not calls


def test_routing_rule_wide_and_unconstrained(monkeypatch):
    """The rule is decided before any launch: n > MAX_N and m == 0 run the
    unfused improve_admm_batch, never the kernel's wrapper."""
    phases = _spy(monkeypatch, admm_kernel, "admm_phase")
    unfused = _spy(monkeypatch, tadmm, "improve_admm_batch")
    prob, _ = boolean_ls(tqt, n=6, m=9)
    form = tqt.QCQP(prob, dtype=np.float32, device="cpu").qcqp_form
    xs = torch.randn(4, 6, generator=torch.Generator().manual_seed(1))
    monkeypatch.setattr(admm_kernel, "MAX_N", 4)
    out = admm_kernel.improve_admm_fused(form, xs, num_iters=5)
    assert unfused and not phases and out.shape == xs.shape
    monkeypatch.setattr(admm_kernel, "MAX_N", 1024)
    unfused.clear()
    admm_kernel.improve_admm_fused(form, xs, num_iters=5)
    assert phases and not unfused
    phases.clear()
    P0 = np.eye(3)[None] * 2.0
    f0 = form_from_numpy(P0, np.ones((1, 3)), np.zeros(1), np.zeros(0, bool),
                         device="cpu", dtype=torch.float32)
    out = admm_kernel.improve_admm_fused(f0, torch.zeros(2, 3))
    assert unfused and not phases
    np.testing.assert_allclose(out.numpy(), -0.25, atol=1e-6)


def test_handler_improve_admm_through_k3_and_cache(monkeypatch):
    """QCQP.improve(ADMM) takes K3 when fused is on (use_fused=True stands
    in for the CUDA default on the CPU) and caches one setup per rho."""
    prob, _ = boolean_ls(tqt, n=6, m=9, seed=0)
    h = tqt.QCQP(prob, dtype=np.float32, device="cpu")
    h.suggest(tqt.RANDOM)
    calls = _spy(monkeypatch, admm_kernel, "improve_admm_fused")
    f1, v1 = h.improve(tqt.ADMM, use_fused=True, num_iters=60)
    assert calls and np.isfinite(f1)
    h.improve(tqt.ADMM, use_fused=True, num_iters=60)
    assert len(h._admm_fused) == 1
    h.improve(tqt.ADMM, use_fused=True, num_iters=10, rho=5.0)
    assert set(h._admm_fused) == {None, 5.0}
    # QCQP.solve with ADMM goes through the same kernel path
    calls.clear()
    h.solve(num_restarts=8, improve=tqt.ADMM, use_fused=True, num_iters=10)
    assert calls


def test_rho_below_minimum_raises():
    x = tqt.Variable(3)
    W = np.array([[1.0, 2.0, 0.0], [2.0, -1.0, 0.0], [0.0, 0.0, -3.0]])
    prob = tqt.Problem(tqt.Minimize(tqt.quad_form(x, W)),
                       [tqt.square(x) <= 1])
    h = tqt.QCQP(prob, device="cpu")
    min_rho = float(tadmm.min_valid_rho(h.qcqp_form))
    assert min_rho > 0
    with pytest.raises(ValueError, match="rho parameter is too small"):
        h.improve(tqt.ADMM, rho=0.5 * min_rho)
    f, v = h.improve(tqt.ADMM, rho=2.0 * min_rho, num_iters=20)
    assert np.isfinite(f)


@pytest.mark.parametrize("fused", [False, True])
def test_example_chain_cd_then_admm(fused):
    """examples/boolean_least_squares.py:45-47 with RANDOM in place of SDR:
    improve(CD), then improve(ADMM, phase1=False) ends no worse than CD's
    point under `better`."""
    prob, x = boolean_ls(tqt, n=10, m=15, seed=1)
    h = tqt.QCQP(prob, seed=2, device="cpu",
                 dtype=np.float32 if fused else np.float64)
    h.suggest(tqt.RANDOM)
    h.improve(tqt.COORD_DESCENT)
    x_cd = torch.as_tensor(x.value, dtype=h.qcqp_form.dtype)
    h.improve(tqt.ADMM, phase1=False, use_fused=fused)
    x_admm = torch.as_tensor(x.value, dtype=h.qcqp_form.dtype)
    form = h.qcqp_form
    vb_a, fa = tcore.better_key(form, x_admm)
    vb_c, fc = tcore.better_key(form, x_cd)
    assert (vb_a < vb_c) or (vb_a == vb_c and fa <= fc + 1e-5 * abs(fc))
