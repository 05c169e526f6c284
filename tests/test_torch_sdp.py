"""qcqp_tpu_torch.solvers.sdp against qcqp_tpu.solvers.sdp on the CPU.

The same numpy forms go to both packages.  Tolerances: 1e-10 relative for
the float64 data and single steps (matmul sums are ordered differently);
1e-7 relative for float64 solves at a fixed budget; 1e-4 of X's magnitude
for the float32 routes (X, rp and rd: the residuals are norms of
differences of iterates of that magnitude).

The float32 warm and vec routes are compared on a dense form whose lifted
iterate has no exactly equal diagonal entries: on boolean least squares
(x_i^2 == 1) in float32 the first iterate's diagonal has entries equal to
the last bit (4 of its 11 are 1.0000006), the Jacobi rotation of a tied
pair is +-pi/4 by the sign of a rounding error, two sweeps leave the
projection unconverged, and either package's trajectory is one of two
equally valid ones.  On float64 data the ties fall the same way in both
packages, so the vec route is also held on boolean least squares there
(K5 itself runs in float32 on either data type).

JAX's _cone_proj_vec calls eigh_jacobi_vec without `interpret`
(qcqp_tpu/solvers/sdp.py:233-236), which cannot lower on the CPU, so the
vec test patches the module attribute with interpret=True before the JAX
solve_sdp is first traced with psd_method="vec"."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qcqp_tpu import core as jcore
from qcqp_tpu.kernels import eigh_pallas
from qcqp_tpu.solvers import sdp as js

from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.core import QCQPForm
from qcqp_tpu_torch.solvers import sdp as ts

torch.set_num_threads(1)


def boolean_ls(n=10, m=15, seed=1):
    rs = np.random.RandomState(seed)
    A, b = rs.randn(m, n), rs.randn(m)
    P = np.zeros((n + 1, n, n))
    P[0] = A.T @ A
    P[1:, np.arange(n), np.arange(n)] = np.eye(n)
    q = np.zeros((n + 1, n))
    q[0] = -2.0 * A.T @ b
    r = -np.ones(n + 1)
    r[0] = b @ b
    return P, q, r, np.ones(n, bool)


def dense(n=8, m=5, seed=0):
    """A bounded SDR without ties: a positive definite objective, random
    rows (every other one made convex), inequalities and equalities."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    B = rng.standard_normal((n, n)) / np.sqrt(n)
    P[0] = B.T @ B + 0.5 * np.eye(n)
    P[1::2] += np.eye(n)
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    r[1:] = -np.abs(r[1:]) - 0.5
    return P, q, r, rng.random(m) < 0.4


def forms(arrays, dtype=np.float64):
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    jf = jcore.QCQPForm(*(jnp.asarray(a, dtype) for a in arrays[:3]),
                        jnp.asarray(arrays[3]))
    return jf, form_from_numpy(*arrays, device="cpu", dtype=tdt)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("kind", ["sdr_bls", "sdr_dense"])
def test_build_sdp_matches_jax(kind):
    arrays = boolean_ls() if kind == "sdr_bls" else dense()
    jf, tf = forms(arrays)
    jd, td = js._sdr_data(jf), ts._sdr_data(tf)
    for name in js.SDPData._fields:
        a, b = getattr(td, name).numpy(), np.asarray(getattr(jd, name))
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name == "incons":      # a residual at rounding level
            assert abs(float(a) - float(b)) < 1e-12
        else:
            assert rel(a, b) < 1e-10, name


def test_build_sdp_batched_equals_single():
    """The stacked build (solve_sdr_batch's) is the single build per
    instance."""
    arrays = [dense(seed=s) for s in (1, 2)]
    stacked = QCQPForm(*(torch.from_numpy(np.stack([a[i] for a in arrays]))
                         for i in range(4)))
    db = ts._sdr_data(stacked)
    for s, arr in enumerate(arrays):
        d1 = ts._sdr_data(form_from_numpy(*arr, device="cpu"))
        for name in ts.SDPData._fields:
            a, b = getattr(db, name)[s], getattr(d1, name)
            if name == "incons":      # a residual at rounding level
                assert abs(float(a) - float(b)) < 1e-14
            else:
                assert rel(a, b) < 1e-12, name


def test_affine_prox_and_cone_steps_match_jax():
    """One affine prox and one step of each cone projection, float64 at
    1e-10 (vec runs its eigh in float32: 1e-5), float32 NS and vec at
    1e-5."""
    jf, tf = forms(dense())
    jd, td = js._sdr_data(jf), ts._sdr_data(tf)
    N, k = td.W0.shape[-1], td.b.shape[-1]
    rng = np.random.default_rng(3)
    X = rng.standard_normal((N, N))
    X = 0.5 * (X + X.T)
    s = rng.standard_normal(k)
    V = np.linalg.qr(rng.standard_normal((N, N)))[0]
    outs_j = js._affine_prox(jd, jnp.asarray(X), jnp.asarray(s), 1.7)
    outs_t = ts._affine_prox(td, torch.from_numpy(X), torch.from_numpy(s),
                             torch.tensor(1.7, dtype=torch.float64))
    for a, b in zip(outs_t, outs_j):
        assert rel(a, b) < 1e-10
    Xt, st, Vt = (torch.from_numpy(a) for a in (X, s, V))
    Xj, sj, Vj = (jnp.asarray(a) for a in (X, s, V))
    pairs = [(ts._cone_proj(Xt, st), js._cone_proj(Xj, sj), 1e-10),
             (ts._cone_proj_ns(Xt, st), js._cone_proj_ns(Xj, sj), 1e-10),
             (ts._cone_proj_warm(Xt, st, Vt), js._cone_proj_warm(Xj, sj, Vj),
              1e-10)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(eigh_pallas, "eigh_jacobi_vec", functools.partial(
            eigh_pallas.eigh_jacobi_vec, interpret=True))
        pairs.append((ts._cone_proj_vec(Xt, st, Vt),
                      js._cone_proj_vec(Xj, sj, Vj), 1e-5))
        X32, s32, V32 = (a.astype(np.float32) for a in (X, s, V))
        pairs.append((ts._cone_proj_vec(*(torch.from_numpy(a) for a in
                                          (X32, s32, V32))),
                      js._cone_proj_vec(*(jnp.asarray(a) for a in
                                          (X32, s32, V32))), 1e-5))
    pairs.append((ts._cone_proj_ns(torch.from_numpy(X.astype(np.float32)),
                                   torch.from_numpy(s.astype(np.float32))),
                  js._cone_proj_ns(jnp.asarray(X, jnp.float32),
                                   jnp.asarray(s, jnp.float32)), 1e-5))
    for mine, theirs, tol in pairs:
        for a, b in zip(mine, theirs):
            assert a.dtype == torch.from_numpy(np.array(b)).dtype
            assert rel(a, b) < tol


def _compare_solves(jd, td, tol_rel, f32, **kw):
    sj = js.solve_sdp(jd, tol=0.0, **kw)
    st = ts.solve_sdp(td, tol=0.0, **kw)
    assert int(st.iterations) == int(sj.iterations) == kw["max_iters"]
    Xn = np.abs(np.asarray(sj.X)).max()
    if f32:
        assert rel(st.X, sj.X) < tol_rel
        for a, b in ((st.primal_res, sj.primal_res),
                     (st.dual_res, sj.dual_res)):
            assert abs(float(a) - float(b)) < tol_rel * Xn
    else:
        for a, b in ((st.X, sj.X), (st.primal_res, sj.primal_res),
                     (st.dual_res, sj.dual_res), (st.state.Y, sj.state.Y),
                     (st.state.rho, sj.state.rho)):
            assert rel(a, b) < tol_rel
    assert int(st.status_code) == int(sj.status_code)
    return st, sj


@pytest.mark.parametrize("psd,iters,kw", [
    # AA on; 60 iterations, before the residuals reach rounding level
    ("eigh", 60, {}),
    ("ns", 200, dict(accel_mem=0, alpha=1.0)),
    ("warm", 200, dict(accel_mem=0, alpha=1.6, detect_certificates=False))])
def test_solve_sdp_float64_matches_jax(psd, iters, kw):
    jf, tf = forms(dense())
    _compare_solves(js._sdr_data(jf), ts._sdr_data(tf), 1e-7, False,
                    max_iters=iters, psd_method=psd, **kw)


@pytest.mark.parametrize("psd", ["ns", "warm"])
def test_solve_sdp_float32_matches_jax(psd):
    jf, tf = forms(dense(), np.float32)
    _compare_solves(js._sdr_data(jf), ts._sdr_data(tf), 1e-4, True,
                    max_iters=200, psd_method=psd, accel_mem=0,
                    alpha=1.0 if psd == "ns" else 1.6,
                    detect_certificates=False)


@pytest.mark.parametrize("case,iters", [("boolean_ls_f64", 25),
                                        ("dense_f32", 30)])
def test_solve_sdp_vec_matches_jax(monkeypatch, case, iters):
    """The vec route (K5a's plain version here, the Pallas kernel in
    interpret mode there) at the settings solve_sdr_batch gives it; K5
    computes in float32 on either data type.  Boolean least squares (n =
    10) runs on float64 data: on float32 data its ties break by rounding
    (see the module docstring)."""
    monkeypatch.setattr(eigh_pallas, "eigh_jacobi_vec", functools.partial(
        eigh_pallas.eigh_jacobi_vec, interpret=True))
    if case == "boolean_ls_f64":
        jf, tf = forms(boolean_ls())
    else:
        jf, tf = forms(dense(), np.float32)
    st, _ = _compare_solves(js._sdr_data(jf), ts._sdr_data(tf), 1e-4, True,
                            max_iters=iters, psd_method="vec",
                            warm_sweeps=2, accel_mem=0, alpha=1.6,
                            detect_certificates=False)
    assert st.X.dtype == tf.dtype


def test_solve_sdp_batched_equals_single_and_freezes():
    """Two instances in one batched loop: each stops at its own iteration
    (the other runs on) and ends where it would alone; the batched state
    warm-starts the batch again."""
    arrays = [dense(seed=0), dense(seed=1)]
    n = 8
    stack = [np.stack([a[i] for a in arrays]) for i in range(4)]
    stacked = QCQPForm(*(torch.from_numpy(a) for a in stack))
    sb = ts.solve_sdp(ts._sdr_data(stacked), max_iters=3000, tol=1e-8)
    for s, arr in enumerate(arrays):
        s1 = ts.solve_sdp(ts._sdr_data(form_from_numpy(*arr, device="cpu")),
                          max_iters=3000, tol=1e-8)
        # the batched products round differently from the single ones:
        # the two agree to the solve's tolerance
        assert int(sb.iterations[s]) == int(s1.iterations)
        assert rel(sb.X[s], s1.X) < 1e-6
        assert rel(sb.objective[s], s1.objective) < 1e-6
    assert int(sb.iterations[0]) != int(sb.iterations[1])
    assert sb.X.shape == (2, n + 1, n + 1)
    again = ts.solve_sdp(ts._sdr_data(stacked), max_iters=3000, tol=1e-8,
                         init=sb.state)
    assert int(again.iterations.max()) < int(sb.iterations.min())


def test_solve_sdp_counts_masked_tail():
    """After the instance finishes the loop runs masked no-ops up to the
    host's next read of "any active"; solve_sdp.masked_tail counts them,
    and a solve cut by max_iters has none."""
    data = ts._sdr_data(forms(dense())[1])
    before = ts.solve_sdp.masked_tail
    its = int(ts.solve_sdp(data, max_iters=3000, tol=1e-8).iterations)
    assert 0 < its < 3000
    assert ts.solve_sdp.masked_tail - before == -its % ts._CHECK_EVERY
    before = ts.solve_sdp.masked_tail
    cut = ts.solve_sdp(data, max_iters=its - 1, tol=1e-8)
    assert int(cut.iterations) == its - 1
    assert ts.solve_sdp.masked_tail == before


def test_warm_route_float32_bound_close_to_float64():
    """tests/test_f32.py:64-73: the float32 warm-Jacobi route reaches the
    float64 bound within 5e-3."""
    arrays = boolean_ls(8, 12, 3)
    f32 = form_from_numpy(*arrays, device="cpu", dtype=torch.float32)
    s32 = ts.solve_sdp(ts._sdr_data(f32), max_iters=8000, tol=2e-5,
                       psd_method="warm")
    _, b64 = ts.solve_sdr(form_from_numpy(*arrays, device="cpu"),
                          max_iters=20000, tol=1e-8)
    assert abs(float(s32.objective) - float(b64)) <= 5e-3
