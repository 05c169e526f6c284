"""K4's plain version (qcqp_tpu_torch/kernels/ccp_kernel.py, what the
wrapper runs on CPU tensors) against the JAX whole-improve Pallas kernel
(qcqp_tpu/kernels/ccp_pallas.py in interpret=True), in float32 on the CPU.

Both are tile-lockstep over 64 restarts with the same gates, so a full
tile compares pointwise.  They sum in different orders (the port in the
CUDA kernel's order, the JAX kernel by matmuls and lane reductions), so
they agree to float32 roundoff amplified by a few CCP steps, not bit for
bit: atol 5e-4, the tolerance tests/test_ccp_pallas.py:40 allows between
the JAX kernel and the vmapped path, at the caps of those cases
(warm_inner=False, 15 Newton trips, 3 x 20).  The comparison is on the raw
kernel output, before the better-fold: on these random forms the fold
keeps every start, which would make it trivial.  At the fused defaults
the trajectories are compared by their statistics.  The set-up tensors
are computed by the same numpy calls in both packages and are compared
bit for bit; identity at max_iter=0 and invariance under permutations
inside a tile and of whole tiles are exact.
"""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import qcqp_tpu  # noqa: F401
from qcqp_tpu import core as jcore
from qcqp_tpu.core import random_form
from qcqp_tpu.kernels import ccp_pallas as jk

from qcqp_tpu_torch import core as tcore
from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.kernels import ccp_kernel as tk
from qcqp_tpu_torch.solvers import ccp as tccp

torch.set_num_threads(1)
F32 = np.float32
KNOBS = dict(tau=0.005, mu=1.4, tau_max=1e8, max_iter=60, inner_iters=10,
             rho=1.0, stall_tol=1e-6, inner_tol=1e-5, viol_exit_tol=1e-4,
             warm_inner=True, n_newton=5)


def _forms(n, m, eq_frac, seed):
    rng = np.random.default_rng(seed)
    jf = random_form(rng, n=n, m=m, eq_frac=eq_frac, dtype=np.float32)
    tf = form_from_numpy(*(np.asarray(a) for a in jf), device="cpu",
                         dtype=torch.float32)
    return jf, tf, rng


def _jax_raw(monkeypatch, jf, xs, **kw):
    """The JAX kernel's output before its better-fold: `_ccp_improve` run
    eagerly with `better` returning its second argument."""
    monkeypatch.setattr(jcore, "better", lambda form, a, b, tol=1e-4: b)
    k = dict(KNOBS, **kw)
    d = jk.CCPFusedData(jf)
    out = jk._ccp_improve.__wrapped__(
        d.tensors, d.form32, jnp.asarray(xs, jnp.float32), m=int(jf.m),
        E=d.E, tau0=k["tau"], mu=k["mu"], tau_max=k["tau_max"],
        max_iter=k["max_iter"], inner_iters=k["inner_iters"], rho0=k["rho"],
        stall_tol=k["stall_tol"], inner_tol=k["inner_tol"],
        viol_exit_tol=k["viol_exit_tol"], warm_inner=k["warm_inner"],
        n_newton=k["n_newton"], interpret=True)
    monkeypatch.undo()
    return np.asarray(out)


@pytest.mark.parametrize("n,m,eqf,seed", [
    (8, 5, 0.5, 0), (6, 4, 1.0, 1), (9, 7, 0.3, 2), (5, 0, 0.0, 3)])
def test_lockstep_parity_with_jax(monkeypatch, n, m, eqf, seed):
    """tests/test_ccp_pallas.py:23-41's cases (and m = 0, which K4 takes):
    the plain K4 against the JAX kernel on a full tile, pointwise."""
    jf, tf, rng = _forms(n, m, eqf, seed)
    xs = rng.standard_normal((tk.L_TILE, n)).astype(F32)
    kw = dict(warm_inner=False, n_newton=15, max_iter=3, inner_iters=20)
    xj = _jax_raw(monkeypatch, jf, xs, **kw)
    xt = tk.ccp_improve(tk.CCPFusedData(tf), torch.from_numpy(xs),
                        **kw).numpy()
    assert np.abs(xt - xs).max() > 1.0           # the iterates moved
    np.testing.assert_allclose(xt, xj, rtol=0, atol=5e-4)
    # and the improve with its fold, as tests/test_ccp_pallas.py:38 calls it
    fj = np.asarray(jk.improve_ccp_fused(jf, jnp.asarray(xs),
                                         interpret=True, **kw))
    ft = tk.improve_ccp_fused(tf, torch.from_numpy(xs), **kw).numpy()
    np.testing.assert_allclose(ft, fj, rtol=0, atol=5e-4)


def _boolean_ls6():
    """tests/test_ccp_pallas.py:44-62."""
    np.random.seed(1)
    n, m = 6, 9
    A = np.random.randn(m, n)
    b = np.random.randn(m, 1).ravel()
    P = np.zeros((n + 1, n, n))
    P[0] = A.T @ A
    for i in range(n):
        P[1 + i, i, i] = 1.0
    q = np.zeros((n + 1, n))
    q[0] = -2.0 * A.T @ b
    r = np.zeros(n + 1)
    r[0] = float(b @ b)
    r[1:] = -1.0
    arrays = (P.astype(F32), q.astype(F32), r.astype(F32), np.ones(n, bool))
    signs = np.array([[1.0 if k >> i & 1 else -1.0 for i in range(n)]
                      for k in range(1 << n)])
    best = float(np.min(np.sum((signs @ A.T - b) ** 2, axis=1)))
    return arrays, best


def test_boolean_ls_at_fused_defaults():
    """tests/test_ccp_pallas.py:44-74 on both kernels, 8 numpy starts: at
    least 6 land feasible in each, the best feasible objective within 3x
    the brute-force optimum, and the two agree on the statistics (feasible
    count within 1, best feasible objective within 1e-3 relative)."""
    arrays, best = _boolean_ls6()
    jf = jcore.QCQPForm(*(jnp.asarray(a) for a in arrays))
    tf = form_from_numpy(*arrays, device="cpu", dtype=torch.float32)
    xs = np.random.default_rng(5).standard_normal((8, 6)).astype(F32)
    oj = np.array(jk.improve_ccp_fused(jf, jnp.asarray(xs), max_iter=45,
                                       interpret=True))
    ot = tk.improve_ccp_fused(tf, torch.from_numpy(xs), max_iter=45)
    vt = tcore.max_violation_batch(tf, ot).numpy()
    ft = tcore.eval_objective_batch(tf, ot).numpy()
    vj = tcore.max_violation_batch(tf, torch.from_numpy(oj)).numpy()
    fj = tcore.eval_objective_batch(tf, torch.from_numpy(oj)).numpy()
    feas_t, feas_j = vt < 1e-2, vj < 1e-2
    assert feas_t.sum() >= 6 and feas_j.sum() >= 6
    assert abs(int(feas_t.sum()) - int(feas_j.sum())) <= 1
    bt, bj = ft[feas_t].min(), fj[feas_j].min()
    assert bt <= 3 * best
    assert abs(bt - bj) <= 1e-3 * abs(bj)


@pytest.mark.parametrize("case", ["mixed", "all_eq", "no_eq", "m0"])
def test_setup_tensors_equal_jax(case):
    n, m, eqf = {"mixed": (7, 5, 0.5), "all_eq": (6, 4, 1.0),
                 "no_eq": (6, 4, 0.0), "m0": (5, 0, 0.0)}[case]
    jf, tf, _ = _forms(n, m, eqf, 11)
    jd, td = jk.CCPFusedData(jf), tk.CCPFusedData(tf)
    V, lam, lam1, qhat, q, shift, r, eqp = (np.asarray(t)
                                            for t in jd.tensors)
    pairs = [(td.V, V), (td.VT, np.swapaxes(V, 1, 2)), (td.lam0, lam[:, 0]),
             (td.lam1, lam1[:, 0]), (td.qhat, qhat[:, 0]), (td.q, q[:, 0]),
             (td.shift, shift[:, 0, 0]), (td.r, r[:, 0, 0]),
             (td.eq, eqp[:, 0, 0])]
    for port, ref in pairs:
        assert port.dtype == torch.float32 and port.is_contiguous()
        np.testing.assert_array_equal(port.numpy(), ref)
    assert (td.m, td.n, td.E) == (jd.m, jd.n, jd.E)


def test_identity_at_zero_iterations():
    _, tf, rng = _forms(7, 5, 0.5, 2)
    xs = torch.from_numpy(rng.standard_normal((70, 7)).astype(F32))
    d = tk.CCPFusedData(tf)
    assert torch.equal(tk.ccp_improve(d, xs, max_iter=0), xs)
    assert torch.equal(tk.improve_ccp_fused(tf, xs, max_iter=0, data=d), xs)


def test_permutations_inside_a_tile_and_of_tiles():
    """The gates are per tile: permuting lanes inside a tile, or whole
    tiles, permutes the output exactly; the trip counts follow the tiles.
    The last tile is ragged (zero lanes fill it)."""
    _, tf, rng = _forms(6, 4, 0.5, 3)
    d = tk.CCPFusedData(tf)
    xs = torch.from_numpy(rng.standard_normal((140, 6)).astype(F32))
    kw = dict(max_iter=6, inner_iters=4)
    full = tk.ccp_improve(d, xs, **kw)
    trips = tk.ccp_improve_ref.trips.clone()
    assert trips.shape == (3, 2) and bool((trips[:, 0] == 6).all())
    inside = torch.cat([torch.randperm(64, generator=torch.Generator()
                                       .manual_seed(0)),
                        torch.arange(64, 140)])
    assert torch.equal(tk.ccp_improve(d, xs[inside], **kw), full[inside])
    tiles = torch.cat([torch.arange(64, 128), torch.arange(64),
                       torch.arange(128, 140)])
    assert torch.equal(tk.ccp_improve(d, xs[tiles], **kw), full[tiles])


def test_routing_rule(monkeypatch):
    """Decided before any launch: n > MAX_N runs the unfused
    improve_ccp_batch with the JAX fallback's knobs, never the wrapper."""
    calls, unfused = [], []
    orig_k, orig_u = tk.ccp_improve, tccp.improve_ccp_batch
    monkeypatch.setattr(tk, "ccp_improve",
                        lambda *a, **k: calls.append(1) or orig_k(*a, **k))
    monkeypatch.setattr(tccp, "improve_ccp_batch",
                        lambda *a, **k: unfused.append(k) or orig_u(*a, **k))
    _, tf, rng = _forms(6, 3, 0.5, 4)
    xs = torch.from_numpy(rng.standard_normal((2, 6)).astype(F32))
    monkeypatch.setattr(tk, "MAX_N", 4)
    out = tk.improve_ccp_fused(tf, xs, max_iter=2, inner_iters=5)
    assert unfused and not calls and out.shape == (2, 6)
    assert unfused[0]["max_iter"] == 2 and unfused[0]["inner_iters"] == 5
    monkeypatch.setattr(tk, "MAX_N", 256)
    unfused.clear()
    tk.improve_ccp_fused(tf, xs, max_iter=2, inner_iters=5)
    assert calls and not unfused


def test_max_n_is_the_shared_memory_limit():
    """MAX_N's block fits the 227 KB (232,448 B) of shared memory an H100
    block can have, and MAX_N is the widest n an instantiation of K4 takes:
    32 times the wide one's coordinate groups (kCptWide in
    csrc/ccp_impl.cuh).  The name is kept from when shared memory set
    MAX_N."""
    assert tk.shared_bytes(tk.MAX_N) <= 232448
    assert tk.shared_bytes(tk.MAX_N) == 4 * 3 * 64 * tk.MAX_N
    csrc = os.path.join(os.path.dirname(tk.__file__), os.pardir, "csrc")
    with open(os.path.join(csrc, "ccp_impl.cuh")) as f:
        cpt_wide = re.search(r"\bkCptWide\s*=\s*(\d+)", f.read())
    assert cpt_wide is not None
    assert tk.MAX_N == 32 * int(cpt_wide.group(1))
