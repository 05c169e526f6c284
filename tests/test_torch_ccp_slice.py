"""The DCCP slice end to end on the CPU: qcqp_tpu_torch's improve_chain,
solve_restarts and QCQP handler with DCCP against qcqp_tpu's from the same
numpy starts, the kwarg forwarding of tests/test_parallel.py:195-225, the
routing to K4 and away from it, the handler's set-up cache, and the
default device of make_form, random_form, form_from_numpy and
canonicalize."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import qcqp_tpu as jqt
from qcqp_tpu.parallel import restarts as jrestarts

import qcqp_tpu_torch as tqt
from qcqp_tpu_torch import core as tcore
from qcqp_tpu_torch import convert, expressions
from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.kernels import ccp_kernel
from qcqp_tpu_torch.parallel import restarts as trestarts
from qcqp_tpu_torch.solvers import ccp as ccp_solver

torch.set_num_threads(1)


def boolean_ls(qt, n=5, m=8, seed=3):
    rs = np.random.RandomState(seed)
    A, b = rs.randn(m, n), rs.randn(m)
    x = qt.Variable(n)
    return qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                      [qt.square(x) == 1]), x


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*a, **kw):
        calls.append(kw)
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_improve_chain_and_best_point_match_jax():
    """The unfused route in float64 against the JAX package's vmapped
    improve_ccp from the same starts: the same algorithm, so the best
    points agree to 1e-8."""
    jprob, _ = boolean_ls(jqt)
    jform = jqt.QCQP(jprob).qcqp_form
    tform = form_from_numpy(*(np.asarray(a) for a in jform), device="cpu")
    xs = np.random.default_rng(5).standard_normal((16, tform.n))
    kw = dict(max_iter=10, inner_iters=30, tau=0.05)
    xj = jrestarts.improve_chain(jform, jnp.asarray(xs), jqt.DCCP, **kw)
    _, fj, vj = jrestarts.best_point(jform, xj)
    xt = trestarts.improve_chain(tform, torch.from_numpy(xs), tqt.DCCP, **kw)
    assert xt.dtype == torch.float64
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-8)
    _, ft, vt = trestarts.best_point(tform, xt)
    np.testing.assert_allclose(float(ft), float(fj), rtol=1e-8)
    np.testing.assert_allclose(float(vt), float(vj), atol=1e-8)


def test_improve_chain_forwards_stage_kwargs(monkeypatch):
    """tests/test_parallel.py:195-225 for the DCCP stage: the filtered
    kwargs reach the unfused improve, and the fused one gets its own set;
    foreign kwargs are filtered out."""
    prob, _ = boolean_ls(tqt, n=4, m=6, seed=9)
    form = tqt.QCQP(prob, device="cpu").qcqp_form
    xs = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 4)))
    seen = _spy(monkeypatch, ccp_solver, "improve_ccp_batch")
    trestarts.improve_chain(form, xs, [tqt.DCCP], max_iter=7, tau=0.1,
                            inner_iters=11, rho=99.0, num_outer=3)
    assert seen[0]["max_iter"] == 7 and seen[0]["tau"] == 0.1
    assert seen[0]["inner_iters"] == 11
    assert "rho" not in seen[0] and "num_outer" not in seen[0]
    fused = _spy(monkeypatch, ccp_kernel, "improve_ccp_fused")
    trestarts.improve_chain(form, xs.float(), [tqt.DCCP], use_fused=True,
                            max_iter=2, tau=0.1, inner_iters=3,
                            warm_inner=False, rho=99.0, use_eigen_split=False)
    assert fused[0]["max_iter"] == 2 and fused[0]["tau"] == 0.1
    assert fused[0]["inner_iters"] == 3 and fused[0]["warm_inner"] is False
    assert "rho" not in fused[0] and "use_eigen_split" not in fused[0]


def test_solve_restarts_routes_dccp_through_k4(monkeypatch):
    """With the CUDA-float32 default patched on, solve_restarts(improve=
    DCCP) builds the set-up once and runs improve_ccp_fused (here the plain
    K4); use_eigen_split and use_fused=False take the unfused path."""
    monkeypatch.setattr(trestarts, "_fused_default", lambda form: True)
    calls = _spy(monkeypatch, ccp_kernel, "improve_ccp_fused")
    setups = _spy(monkeypatch, ccp_kernel, "CCPFusedData")
    unfused = _spy(monkeypatch, ccp_solver, "improve_ccp_batch")
    prob, _ = boolean_ls(tqt)
    form = tqt.QCQP(prob, dtype=np.float32, device="cpu").qcqp_form
    gen = lambda: torch.Generator().manual_seed(0)
    x, f, v = trestarts.solve_restarts(form, 70, gen(), improve=tqt.DCCP)
    assert len(calls) == 1 and len(setups) == 1 and not unfused
    assert calls[0]["data"] is not None
    assert x.shape == (form.n,) and float(v) < 1e-2
    calls.clear()
    for extra in (dict(use_eigen_split=True), dict(use_fused=False)):
        trestarts.solve_restarts(form, 4, gen(), improve=tqt.DCCP,
                                 max_iter=3, inner_iters=5, **extra)
    assert len(unfused) == 2 and not calls


def test_handler_improve_matches_jax():
    """QCQP.improve(DCCP) on the CPU (unfused, float64) against the JAX
    handler from the same start, with capped iterations."""
    jprob, jx = boolean_ls(jqt)
    tprob, tx = boolean_ls(tqt)
    jh, th = jqt.QCQP(jprob), tqt.QCQP(tprob, device="cpu")
    x0 = np.random.default_rng(3).standard_normal(5)
    jx.value, tx.value = x0.copy(), x0.copy()
    kw = dict(max_iter=8, inner_iters=40)
    fj, vj = jh.improve(jqt.DCCP, **kw)
    ft, vt = th.improve(tqt.DCCP, **kw)
    np.testing.assert_allclose(ft, fj, rtol=1e-8)
    np.testing.assert_allclose(vt, vj, atol=1e-8)
    np.testing.assert_allclose(tx.value, jx.value, atol=1e-8)


def test_handler_routes_through_k4_and_caches(monkeypatch):
    """use_fused=True stands in for the CUDA default on the CPU: the
    single restart goes through K4 (its plain version here) with 40 inner
    trips and one cached set-up; use_eigen_split takes the unfused path;
    QCQP.solve(DCCP) reaches a feasible point on both routes."""
    np.random.seed(1)
    x = tqt.Variable(3)
    prob = tqt.Problem(tqt.Minimize(tqt.sum_squares(x)),
                       [tqt.square(x) == 1])
    h = tqt.QCQP(prob, dtype=np.float32, device="cpu")
    h.suggest(tqt.RANDOM)
    calls = _spy(monkeypatch, ccp_kernel, "improve_ccp_fused")
    f, v = h.improve(tqt.DCCP, use_fused=True)
    assert len(calls) == 1 and calls[0]["inner_iters"] == 40
    assert v < 1e-2 and abs(f - 3.0) < 1e-2
    setup = h._ccp_fused
    h.improve(tqt.DCCP, use_fused=True, max_iter=5)
    assert h._ccp_fused is setup and len(calls) == 2
    h.improve(tqt.DCCP, use_fused=True, use_eigen_split=True, max_iter=5,
              inner_iters=10)
    assert len(calls) == 2
    f, v = h.solve(num_restarts=8, improve=tqt.DCCP, use_fused=True)
    assert len(calls) == 3 and v < 1e-2
    h64 = tqt.QCQP(prob, device="cpu")
    f, v = h64.solve(num_restarts=4, improve=tqt.DCCP, inner_iters=40)
    assert v < 1e-2 and abs(f - 3.0) < 1e-2


def test_example_chain_cd_then_dccp():
    """The reference's examples chain an improve after another
    (tests/test_api_examples.py:47): CD, then DCCP, ends no worse than
    CD's point under `better` (DCCP's own fold)."""
    prob, x = boolean_ls(tqt, n=6, m=10, seed=1)
    h = tqt.QCQP(prob, seed=2, device="cpu")
    h.suggest(tqt.RANDOM)
    h.improve(tqt.COORD_DESCENT)
    x_cd = torch.as_tensor(x.value)
    h.improve(tqt.DCCP, max_iter=10, inner_iters=30)
    x_ccp = torch.as_tensor(x.value)
    vb_a, fa = tcore.better_key(h.qcqp_form, x_ccp)
    vb_c, fc = tcore.better_key(h.qcqp_form, x_cd)
    assert (vb_a < vb_c) or (vb_a == vb_c and fa <= fc + 1e-9 * abs(fc))


@pytest.mark.parametrize("cuda", [False, True])
def test_forms_land_on_the_default_device(monkeypatch, cuda):
    """With no device named, make_form, random_form, form_from_numpy,
    canonicalize and QCQP put the form on the current CUDA device (cuda:0
    on one card), and without a card they raise instead of falling back to
    the CPU; a device the caller names is honoured, and the dtype follows
    the device.  With CUDA mocked as present (its current device 0) only
    the choice is checked (no tensor is made on a card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert tcore.default_device("cpu") == torch.device("cpu")
    if cuda:
        assert tcore.default_device() == torch.device("cuda:0")
        return
    P = np.stack([np.eye(2), -np.eye(2)])
    prob, _ = boolean_ls(tqt, n=3, m=4)
    makers = [
        lambda **kw: tcore.make_form(P, np.zeros((2, 2)), np.zeros(2),
                                     [True], **kw),
        lambda **kw: tcore.random_form(np.random.default_rng(0), 3, 2, **kw),
        lambda **kw: convert.form_from_numpy(P, np.zeros((2, 2)),
                                             np.zeros(2), [True], **kw),
        lambda **kw: expressions.canonicalize(prob, **kw)[0],
        lambda **kw: tqt.QCQP(prob, **kw).qcqp_form,
    ]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcore.default_device()
    for make in makers:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
        form = make(device="cpu")
        assert form.device == torch.device("cpu")
        assert form.dtype == torch.float64
