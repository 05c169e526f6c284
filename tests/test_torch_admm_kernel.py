"""K3's plain version (qcqp_tpu_torch/kernels/admm_kernel.py, what the
wrapper runs on CPU tensors) against the JAX whole-phase Pallas kernels
(qcqp_tpu/kernels/admm_pallas.py, improve_admm_fused(interpret=True)), in
float32 on the CPU, on the cases of tests/test_admm_pallas.py.

The two sum in different orders (the port in the CUDA kernel's order, the
JAX kernel by MXU matmuls and lane reductions), so they agree to float32
roundoff, not bit for bit.  Lockstep cases (convex, inequality-only, few
iterations, 12 Newton trips so the secular root is exact) compare pointwise
at the atol that tests/test_admm_pallas.py:99 allows between its own two
paths; nonconvex cases compare by statistics as tests/test_admm_pallas.py:
30-55 does.  The setup tensors are computed by the same numpy calls in both
packages and are compared bit for bit; identity at zero iterations and
restart-permutation invariance are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import qcqp_tpu  # noqa: F401
from qcqp_tpu.core import QCQPForm as JForm
from qcqp_tpu.kernels import admm_pallas as jk

from qcqp_tpu_torch import core as tcore
from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.kernels import admm_kernel as tk

torch.set_num_threads(1)
F32 = np.float32


def _random_arrays(n, m, seed, eq_frac=0.5):
    """tests/test_admm_pallas.py:19-27."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    is_eq = rng.random(m) < eq_frac
    return P.astype(F32), q.astype(F32), r.astype(F32), is_eq


def _convex_ineq_arrays(n, m, seed):
    """tests/test_admm_pallas.py:58-72."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((m, n, n)) / np.sqrt(n)
    Pc = np.einsum("mij,mkj->mik", B, B) + 0.1 * np.eye(n)
    A0 = rng.standard_normal((n, n)) / np.sqrt(n)
    P0 = A0 @ A0.T + 0.1 * np.eye(n)
    P = np.concatenate([P0[None], Pc])
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = np.concatenate([rng.standard_normal(1),
                        -np.abs(rng.standard_normal(m)) - 0.5])
    return P.astype(F32), q.astype(F32), r.astype(F32), np.zeros(m, bool)


def _forms(arrays):
    jf = JForm(*(jnp.asarray(a) for a in arrays))
    return jf, form_from_numpy(*arrays, device="cpu", dtype=torch.float32)


def _jax(jf, xs, **kw):
    return np.asarray(jk.improve_admm_fused(jf, jnp.asarray(xs, jnp.float32),
                                            interpret=True, **kw))


def _port(tf, xs, **kw):
    out = tk.improve_admm_fused(tf, torch.from_numpy(np.asarray(xs, F32)),
                                **kw)
    assert out.dtype == torch.float32
    return out.numpy()


def _viols(arrays, xs):
    P, q, r, is_eq = (a.astype(np.float64) if a.dtype == F32 else a
                      for a in arrays)
    f = np.einsum("ri,kij,rj->rk", xs, P, xs) + xs @ q.T + r
    v = np.where(is_eq, np.abs(f[:, 1:]), np.maximum(f[:, 1:], 0.0))
    return v.max(axis=1), f[:, 0]


@pytest.mark.parametrize("n,m,iters", [(8, 6, 1), (33, 7, 1), (120, 12, 1),
                                       (8, 6, 3)])
def test_lockstep_parity_with_jax(n, m, iters):
    arrays = _convex_ineq_arrays(n, m, seed=n + m)
    jf, tf = _forms(arrays)
    xs = np.random.default_rng(1).standard_normal((4, n)).astype(F32)
    xj = _jax(jf, xs, num_iters=iters, nw_trips=12)
    xt = _port(tf, xs, num_iters=iters, nw_trips=12)
    scale = np.abs(xj).max() + 1.0
    atol = (2e-5 if iters == 1 else 3e-4 * iters) * scale
    np.testing.assert_allclose(xt, xj, atol=atol, rtol=0)


@pytest.mark.parametrize("seed,eq_frac", [(0, 0.5), (1, 0.0), (2, 1.0)])
def test_statistical_parity_with_jax(seed, eq_frac):
    arrays = _random_arrays(8, 6, seed, eq_frac)
    jf, tf = _forms(arrays)
    xs = np.random.default_rng(seed + 100).standard_normal((8, 8))
    xj = _jax(jf, xs, num_iters=100)
    xt = _port(tf, xs, num_iters=100)
    vj, fj = _viols(arrays, xj.astype(np.float64))
    vt, ft = _viols(arrays, xt.astype(np.float64))
    np.testing.assert_allclose(np.sort(vt), np.sort(vj), atol=3e-2)
    assert np.floor(vt.min() / 1e-2) <= np.floor(vj.min() / 1e-2)
    if eq_frac == 0.0:
        feas = (vt < 1e-2) & (vj < 1e-2)
        assert feas.any()
        best = fj[feas].min()
        assert ft[feas].min() <= best + 1e-2 + 5e-3 * abs(best)


def _wide_root_arrays():
    """tests/test_admm_pallas.py:103-122: a concave row whose secular root
    lies beyond the 2^10 doubling budget."""
    n = 4
    P = np.stack([np.eye(n), -1e-4 * np.eye(n)])
    return (P.astype(F32), np.zeros((2, n), F32),
            np.array([0.0, 0.25], F32), np.zeros(1, bool))


def test_wide_root_rescue():
    arrays = _wide_root_arrays()
    jf, tf = _forms(arrays)
    xs = 0.01 * np.ones((1, 4), F32)
    out = _port(tf, xs, num_iters=200)
    assert tk.ADMMFusedData(tf).need_dbl
    assert np.isfinite(out).all()
    assert _viols(arrays, out.astype(np.float64))[0][0] < 1e-2
    assert _viols(arrays, _jax(jf, xs, num_iters=200)
                  .astype(np.float64))[0][0] < 1e-2


def test_never_worse_than_start():
    arrays = _random_arrays(10, 7, 5)
    _, tf = _forms(arrays)
    xs = torch.from_numpy(np.random.default_rng(9).standard_normal((4, 10))
                          .astype(F32))
    out = tk.improve_admm_fused(tf, xs, num_iters=60)
    torch.testing.assert_close(tcore.better_batch(tf, out, xs), out,
                               rtol=0, atol=0)


def _few_restarts(arrays, xs, **kw):
    """tests/test_admm_pallas.py:137-144 and :172-180 check shape and
    finiteness.  With so few restarts no statistic exists, and on these
    nonconvex forms a float32 roundoff difference can flip a discrete
    choice (a violation bucket in the better-fold, a projection branch)
    from the second iteration on, so the comparison with JAX is the
    single-step lockstep one (12 Newton trips, atol of
    tests/test_admm_pallas.py:99).  The full run is also held to never
    being worse than its start."""
    jf, tf = _forms(arrays)
    out = _port(tf, xs, **kw)
    assert out.shape == xs.shape and np.isfinite(out).all()
    x0 = torch.from_numpy(xs)
    torch.testing.assert_close(
        tcore.better_batch(tf, torch.from_numpy(out), x0),
        torch.from_numpy(out), rtol=0, atol=0)
    kw = dict(kw, num_iters=1, nw_trips=12)
    xj = _jax(jf, xs, **kw)
    scale = np.abs(xj).max() + 1.0
    np.testing.assert_allclose(_port(tf, xs, **kw), xj, atol=2e-5 * scale,
                               rtol=0)


@pytest.mark.parametrize("R", [1, 3])
def test_small_batches(R):
    xs = np.random.default_rng(4 + R).standard_normal((R, 6)).astype(F32)
    _few_restarts(_random_arrays(6, 4, 3), xs, num_iters=30)


def test_phase1_false():
    xs = np.sign(np.random.default_rng(8).standard_normal((2, 6))).astype(F32)
    _few_restarts(_random_arrays(6, 4, 7), xs, num_iters=40, phase1=False)


@pytest.mark.parametrize("case", ["dense", "wide", "rho"])
def test_setup_tensors_equal_jax(case):
    """The port's ADMMFusedData against JAX's ADMMFusedData(form).tensors on
    the real (unpadded) rows, bit for bit."""
    arrays = (_wide_root_arrays() if case == "wide"
              else _random_arrays(9, 7, 11))
    rho = 3.5 if case == "rho" else None
    jf, tf = _forms(arrays)
    jd, td = jk.ADMMFusedData(jf, rho), tk.ADMMFusedData(tf, rho)
    m = td.m
    Q, lam3, qhat3, r3, eq3, lmax3, lmin3, W, P0, q0, rho_arr = (
        np.asarray(t) for t in jd.tensors)
    pairs = [(td.Q, Q[:m]), (td.lam, lam3[:m, 0]), (td.qhat, qhat3[:m, 0]),
             (td.r, r3[:m, 0, 0]), (td.eq, eq3[:m, 0, 0]),
             (td.lmax, lmax3[:m, 0, 0]), (td.lmin, lmin3[:m, 0, 0]),
             (td.W, W), (td.P0, P0), (td.q0, q0[0]),
             (td.rho32, rho_arr[0, 0])]
    for port, ref in pairs:
        assert port.dtype == torch.float32 and port.is_contiguous()
        np.testing.assert_array_equal(port.numpy(), ref)
    assert (td.rho, td.need_dbl, m) == (jd.rho, jd.need_dbl, jd.m)
    assert td.r0 == np.float32(jd.r0)


def test_identity_at_zero_iterations():
    arrays = _random_arrays(7, 5, 2)
    _, tf = _forms(arrays)
    d = tk.ADMMFusedData(tf)
    xs = torch.from_numpy(np.random.default_rng(0).standard_normal((5, 7))
                          .astype(F32))
    for phase in (1, 2):
        assert torch.equal(tk.admm_phase(d, xs, phase, num_iters=0), xs)
    assert torch.equal(tk.improve_admm_fused(tf, xs, num_iters=0, data=d), xs)


@pytest.mark.parametrize("boolean", [False, True])
def test_restart_permutation_invariance(boolean):
    """Every gate is per restart: a restart's result does not depend on
    its neighbours in the batch (bit for bit)."""
    if boolean:                        # semidefinite rows: the doubling path
        n = 6
        P = np.zeros((n + 1, n, n), F32)
        A = np.random.default_rng(1).standard_normal((9, n))
        P[0] = A.T @ A
        for i in range(n):
            P[1 + i, i, i] = 1.0
        q = np.zeros((n + 1, n), F32)
        r = np.zeros(n + 1, F32)
        r[1:] = -1.0
        arrays = (P, q, r, np.ones(n, bool))
    else:
        arrays = _random_arrays(7, 5, 6)
    _, tf = _forms(arrays)
    d = tk.ADMMFusedData(tf)
    assert d.need_dbl == boolean
    n = tf.n
    xs = torch.from_numpy(np.random.default_rng(2).standard_normal((9, n))
                          .astype(F32))
    perm = torch.from_numpy(np.random.default_rng(3).permutation(9))
    for phase in (1, 2):
        full = tk.admm_phase(d, xs, phase, num_iters=25)
        assert torch.equal(tk.admm_phase(d, xs[perm], phase, num_iters=25),
                           full[perm])
        assert torch.equal(tk.admm_phase(d, xs[4:5], phase, num_iters=25),
                           full[4:5])


def test_tree_sum_and_rowvec_order():
    """The plain version's sums are the kernel's: a 32-lane shuffle tree per
    warp, warps in order; products summed over k in order."""
    v = torch.randn(3, 70, generator=torch.Generator().manual_seed(0))
    pad = torch.nn.functional.pad(v, (0, 26)).reshape(3, 3, 32)
    for h in (16, 8, 4, 2, 1):
        pad = pad[..., :h] + pad[..., h:2 * h]
    want = (pad[..., 0, 0] + pad[..., 1, 0]) + pad[..., 2, 0]
    assert torch.equal(tk._tree_sum(v), want)
    x = torch.randn(2, 5, dtype=torch.float64)
    M = torch.randn(5, 5, dtype=torch.float64)
    torch.testing.assert_close(tk._rowvec(x, M), x @ M, rtol=1e-14,
                               atol=1e-14)
