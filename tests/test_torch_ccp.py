"""The port's penalty CCP (qcqp_tpu_torch/solvers/ccp.py, the unfused DCCP
route) and DC splits (qcqp_tpu_torch/core.py) against the JAX package's
(qcqp_tpu/solvers/ccp.py under jax.vmap, qcqp_tpu/core.py), in float64 on
the CPU from the same numpy inputs.

Both run the same algorithm in float64; they differ only in summation
order and eigh routine, so at the caps used here they agree to 1e-9 (the
eigenvector signs differ, which the rotations undo).  jax.vmap of a
while_loop freezes each lane once its own condition fails; the port's
masked loops must do the same, which test_lanes_freeze_on_their_own pins.
The two quality tests of tests/test_ccp.py are repeated on the port.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import qcqp_tpu  # noqa: F401  (float64 on)
from qcqp_tpu import core as jcore
from qcqp_tpu.core import QCQPForm as JForm
from qcqp_tpu.solvers.ccp import improve_ccp as jax_improve_ccp

from qcqp_tpu_torch import core as tcore
from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.solvers import ccp as tccp

torch.set_num_threads(1)


def _arrays(n, m, seed, eq_frac=0.3):
    """tests/test_ccp.py:15-23."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    return P, q, r, rng.random(m) < eq_frac


def _forms(arrays):
    return (JForm(*(jnp.asarray(a) for a in arrays)),
            form_from_numpy(*arrays, device="cpu"))


def _jax_batch(jf, xs, **kw):
    return np.asarray(jax.vmap(lambda x: jax_improve_ccp(jf, x, **kw))(
        jnp.asarray(xs)))


@pytest.mark.parametrize("eigen", [False, True])
def test_dc_split_matches_jax(eigen):
    """P1 - P2 = P with both parts PSD, equal to the JAX split to 1e-12
    (eigvalsh / eigh of the same float64 matrices)."""
    arrays = _arrays(7, 4, 0, eq_frac=0.5)
    jf, tf = _forms(arrays)
    split_j = jcore.dc_split_eigen if eigen else jcore.dc_split
    split_t = tcore.dc_split_eigen if eigen else tcore.dc_split
    (P1j, P2j), (P1t, P2t) = split_j(jf), split_t(tf)
    np.testing.assert_allclose(P1t.numpy(), np.asarray(P1j), atol=1e-12)
    np.testing.assert_allclose(P2t.numpy(), np.asarray(P2j), atol=1e-12)
    np.testing.assert_allclose((P1t - P2t).numpy(), arrays[0], atol=1e-12)
    for M in (P1t, P2t):
        assert torch.linalg.eigvalsh(M).min() > -1e-10


@pytest.mark.parametrize("kw", [
    dict(max_iter=3, inner_iters=20),
    dict(max_iter=8, inner_iters=30, tau=0.05),
    dict(max_iter=4, inner_iters=15, use_eigen_split=True),
])
def test_improve_ccp_batch_matches_vmapped_jax(kw):
    arrays = _arrays(6, 4, 1, eq_frac=0.5)
    jf, tf = _forms(arrays)
    xs = np.random.default_rng(2).standard_normal((5, 6))
    out = tccp.improve_ccp_batch(tf, torch.from_numpy(xs), **kw)
    assert out.dtype == torch.float64 and out.shape == xs.shape
    np.testing.assert_allclose(out.numpy(), _jax_batch(jf, xs, **kw),
                               atol=1e-9, rtol=0)
    # the single-restart entry point is the batch of one
    np.testing.assert_allclose(
        tccp.improve_ccp(tf, torch.from_numpy(xs[1]), **kw).numpy(),
        out[1].numpy(), atol=1e-12, rtol=0)


def _boolean_ls_arrays(n=5, m=8, seed=3):
    rs = np.random.RandomState(seed)
    A, b = rs.randn(m, n), rs.randn(m)
    P = np.zeros((n + 1, n, n))
    P[0] = A.T @ A
    for i in range(n):
        P[1 + i, i, i] = 1.0
    q = np.zeros((n + 1, n))
    q[0] = -2.0 * A.T @ b
    r = -np.ones(n + 1)
    r[0] = b @ b
    return P, q, r, np.ones(n, bool), A, b


def test_lanes_freeze_on_their_own():
    """A lane whose outer loop has exited is not updated while the other
    lanes run on, as under jax.vmap: a start at the best sign vector of a
    boolean least-squares problem stalls feasible at once, random starts
    keep going.  Each lane's result equals its result alone and the
    vmapped JAX result; the early lane gives the same point under any cap
    past its exit, the others do not."""
    P, q, r, eq, A, b = _boolean_ls_arrays()
    jf, tf = _forms((P, q, r, eq))
    n = A.shape[1]
    signs = np.array([[1.0 if k >> i & 1 else -1.0 for i in range(n)]
                      for k in range(1 << n)])
    best = signs[np.argmin(np.sum((signs @ A.T - b) ** 2, axis=1))]
    rng = np.random.default_rng(4)
    xs = np.stack([rng.standard_normal(n), best, rng.standard_normal(n)])
    kw = dict(max_iter=12, inner_iters=25)
    out = tccp.improve_ccp_batch(tf, torch.from_numpy(xs), **kw).numpy()
    np.testing.assert_allclose(out, _jax_batch(jf, xs, **kw), atol=1e-9,
                               rtol=0)
    for i in range(3):
        alone = tccp.improve_ccp_batch(tf, torch.from_numpy(xs[i:i + 1]),
                                       **kw).numpy()
        np.testing.assert_allclose(alone[0], out[i], atol=1e-12, rtol=0)
    short = tccp.improve_ccp_batch(tf, torch.from_numpy(xs), max_iter=2,
                                   inner_iters=25).numpy()
    np.testing.assert_allclose(short[1], out[1], atol=1e-12, rtol=0)
    assert np.abs(short[[0, 2]] - out[[0, 2]]).max() > 1e-6
    v = tcore.max_violation_batch(tf, torch.from_numpy(out))
    assert v[1] < 1e-8


def test_ccp_early_exit_quality_parity():
    """tests/test_ccp.py:26-41 on the port: the early exits land in the
    same violation bucket as the full 60 x 200 schedule, at a comparable
    objective (the three starts as one batch)."""
    _, tf = _forms(_arrays(8, 6, 0))
    x0 = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 8)))
    x_full = tccp.improve_ccp_batch(tf, x0, stall_tol=0.0, inner_tol=0.0)
    x_exit = tccp.improve_ccp_batch(tf, x0)
    vf = tcore.max_violation_batch(tf, x_full).numpy()
    ve = tcore.max_violation_batch(tf, x_exit).numpy()
    ff = tcore.eval_objective_batch(tf, x_full).numpy()
    fe = tcore.eval_objective_batch(tf, x_exit).numpy()
    for i in range(3):
        assert np.floor(ve[i] / 1e-2) <= np.floor(vf[i] / 1e-2)
        if vf[i] < 1e-2 and ve[i] < 1e-2:
            assert fe[i] <= ff[i] + 1e-2 + 0.05 * abs(ff[i])


def test_ccp_never_worse_than_start():
    """tests/test_ccp.py:44-50 on the port."""
    _, tf = _forms(_arrays(6, 5, 3))
    x0 = torch.from_numpy(np.random.default_rng(4).standard_normal(6))
    out = tccp.improve_ccp(tf, x0)
    np.testing.assert_array_equal(tcore.better(tf, out, x0).numpy(),
                                  out.numpy())
