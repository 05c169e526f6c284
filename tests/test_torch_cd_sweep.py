"""K1 (qcqp_tpu_torch/kernels/cd_sweep_kernel.py) against the JAX
whole-sweep Pallas kernel (qcqp_tpu/kernels/cd_sweep_pallas.py, interpret
mode), and the fused CD solver against its JAX counterpart, in float32 on
the CPU, where the wrappers run the plain PyTorch versions.

Phase-1 outcomes on these barely-feasible R = 128 instances are chaotic in
the probe trajectory, and the two packages round the quadratic formula a few
ulps apart, so parity is statistical: the margins of
tests/test_cd_sweep_pallas.py:104-110, applied to results pooled over five
seeds per configuration.  Restart independence, the zero-sweep identity, the
alive gate and the phase-2 feasibility gate are exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import qcqp_tpu  # noqa: F401
from qcqp_tpu.core import QCQPForm as JForm
from qcqp_tpu.kernels import cd_sweep_pallas as jk
from qcqp_tpu.solvers import coord_descent_fused as jfused

from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.kernels import cd_sweep_kernel as tk
from qcqp_tpu_torch.solvers import coord_descent_fused as tfused

torch.set_num_threads(1)
F32 = np.float32
SEEDS = range(5)
SWEEPS = 6


def _arrays(n, m, seed, eq_frac=0.5):
    """tests/test_cd_sweep_pallas.py:12-22."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = (0.5 * (A + np.swapaxes(A, -1, -2))).astype(F32)
    q = (rng.standard_normal((m + 1, n)) / np.sqrt(n)).astype(F32)
    r = rng.standard_normal(m + 1).astype(F32)
    is_eq = rng.random(m) < eq_frac
    eq_idx = tuple(int(i) for i in np.nonzero(is_eq)[0])
    return (P, q, r, is_eq), eq_idx, rng


def _quality(arrays, xs):
    """(violation, objective) per restart, in float64."""
    P, q, r, is_eq = (a.astype(np.float64) if a.dtype == F32 else a
                      for a in arrays)
    xs = np.asarray(xs, np.float64)
    f = np.einsum("ri,kij,rj->rk", xs, P, xs) + xs @ q.T + r
    v = f[:, 1:]
    viol = np.where(is_eq, np.abs(v), np.maximum(v, 0.0))
    return (viol.max(axis=1) if viol.shape[1] else np.zeros(len(xs)),
            f[:, 0])


def _margins(v_ref, v_new, best_pairs):
    """tests/test_cd_sweep_pallas.py:104-110, on pooled seeds."""
    feas_ref, feas_new = v_ref < 1e-2, v_new < 1e-2
    assert feas_new.mean() >= max(feas_ref.mean() * 0.2,
                                  feas_ref.mean() - 0.08)
    assert np.median(v_new) <= np.median(v_ref) * 2.5 + 1e-2
    for ref_best, new_best in best_pairs:
        scale = 1.0 + abs(ref_best)
        assert new_best <= ref_best + 1.0 * scale


def _best(v, o):
    feas = v < 1e-2
    return float(o[feas].min()) if feas.any() else None


def _run_pooled(n, m, eq_frac, jax_fn, torch_fn, never_worse=False,
                restarts=128):
    """never_worse: no restart of the port ends with a larger violation
    than its start."""
    v_ref, v_new, best_pairs = [], [], []
    for seed in SEEDS:
        arrays, eq_idx, rng = _arrays(n, m, seed, eq_frac)
        xs = rng.standard_normal((restarts, n)).astype(F32)
        xj = np.asarray(jax_fn(arrays, eq_idx, xs))
        xt = torch_fn(arrays, eq_idx, xs)
        vj, oj = _quality(arrays, xj)
        vt, ot = _quality(arrays, xt)
        if never_worse:
            assert (vt <= _quality(arrays, xs)[0] + 1e-3).all()
        v_ref.append(vj)
        v_new.append(vt)
        bj, bt = _best(vj, oj), _best(vt, ot)
        if bj is not None and bt is not None:
            best_pairs.append((bj, bt))
    _margins(np.concatenate(v_ref), np.concatenate(v_new), best_pairs)


def _jax_two_phase(arrays, eq_idx, xs, **kw):
    P, q, r, _ = arrays
    return jk.two_phase_sweeps(jnp.asarray(P), jnp.asarray(q), jnp.asarray(r),
                               eq_idx, jnp.asarray(xs), num_iters=SWEEPS,
                               interpret=True, **kw)


def _torch_k1(fn, arrays, eq_idx, xs, **kw):
    P, q, r, _ = arrays
    return fn(*map(torch.from_numpy, (P, q, r)), eq_idx,
              torch.from_numpy(xs), num_iters=SWEEPS, **kw).numpy()


@pytest.mark.parametrize("n,m,eq_frac",
                         [(8, 4, 0.5), (7, 3, 0.0), (7, 3, 1.0)])
def test_two_phase_matches_jax_pooled(n, m, eq_frac):
    _run_pooled(n, m, eq_frac, _jax_two_phase,
                lambda a, e, x: _torch_k1(tk.two_phase_sweeps, a, e, x))


def test_phase1_matches_jax_pooled():
    def jax_fn(arrays, eq_idx, xs):
        P, q, r, _ = arrays
        return jk.phase1_sweeps(jnp.asarray(P), jnp.asarray(q),
                                jnp.asarray(r), eq_idx, jnp.asarray(xs),
                                num_iters=SWEEPS, interpret=True)
    _run_pooled(8, 4, 0.5, jax_fn,
                lambda a, e, x: _torch_k1(tk.phase1_sweeps, a, e, x),
                never_worse=True)


def test_zero_sweeps_is_identity():
    arrays, eq_idx, rng = _arrays(8, 4, 3)
    xs = rng.standard_normal((128, 8)).astype(F32)
    P, q, r, _ = map(torch.from_numpy, arrays)
    for fn in (tk.two_phase_sweeps, tk.phase1_sweeps):
        out = fn(P, q, r, eq_idx, torch.from_numpy(xs), num_iters=0)
        np.testing.assert_array_equal(out.numpy(), xs)
    np.testing.assert_array_equal(
        np.asarray(jk.two_phase_sweeps(*map(jnp.asarray, arrays[:3]), eq_idx,
                                       jnp.asarray(xs), num_iters=0,
                                       interpret=True)), xs)


def test_feasible_start_untouched():
    """Lanes already under viol_tol never move in phase 1 (alive gate)."""
    arrays, eq_idx, _ = _arrays(6, 3, 4, eq_frac=0.0)
    P, q, r, _ = arrays
    r = r.copy()
    r[1:] = -1.0
    xs = torch.zeros((128, 6), dtype=torch.float32)
    out = tk.phase1_sweeps(*map(torch.from_numpy, (P, q, r)), eq_idx, xs,
                           num_iters=5)
    np.testing.assert_array_equal(out.numpy(), 0.0)


def test_infeasible_lanes_gated_out_of_phase2():
    """Lanes that end phase 1 above viol_tol never enter phase 2."""
    arrays, eq_idx, rng = _arrays(8, 4, 9, eq_frac=1.0)
    xs = torch.from_numpy((10.0 + rng.standard_normal((128, 8))).astype(F32))
    P, q, r, _ = map(torch.from_numpy, arrays)
    x1 = tk.phase1_sweeps(P, q, r, eq_idx, xs, num_iters=3).numpy()
    x2 = tk.two_phase_sweeps(P, q, r, eq_idx, xs, num_iters=3).numpy()
    v1, _ = _quality(arrays, x1)
    bad = v1 >= 1e-2
    assert bad.any()
    np.testing.assert_array_equal(x2[bad], x1[bad])


@pytest.mark.parametrize("eq_frac", [0.5, 0.0])
def test_restart_permutation_leaves_lanes_unchanged(eq_frac):
    arrays, eq_idx, rng = _arrays(9, 5, 11, eq_frac)
    xs = rng.standard_normal((128, 9)).astype(F32)
    perm = np.random.default_rng(1).permutation(128)
    P, q, r, _ = map(torch.from_numpy, arrays)
    out = tk.two_phase_sweeps(P, q, r, eq_idx, torch.from_numpy(xs),
                              num_iters=6).numpy()
    out_p = tk.two_phase_sweeps(P, q, r, eq_idx, torch.from_numpy(xs[perm]),
                                num_iters=6).numpy()
    np.testing.assert_array_equal(out_p, out[perm])
    # a ragged batch (no 128-lane padding) gives the same lanes
    out_r = tk.two_phase_sweeps(P, q, r, eq_idx,
                                torch.from_numpy(xs[:100]),
                                num_iters=6).numpy()
    np.testing.assert_array_equal(out_r, out[:100])


def test_skip_phase1_descends_objective():
    """test_cd_sweep_pallas.py:113-135 on the port."""
    arrays, eq_idx, rng = _arrays(10, 5, 7, eq_frac=0.0)
    P, q, r, is_eq = (a.copy() for a in arrays)
    r[1:] = r[1:] - 5.0
    P[0] = P[0] + 3.0 * np.eye(10, dtype=F32)
    xs = (0.01 * rng.standard_normal((128, 10))).astype(F32)
    v0, o0 = _quality((P, q, r, is_eq), xs)
    assert (v0 < 1e-2).all()
    out = tk.two_phase_sweeps(*map(torch.from_numpy, (P, q, r)), eq_idx,
                              torch.from_numpy(xs), num_iters=10,
                              phase1=False).numpy()
    v1, o1 = _quality((P, q, r, is_eq), out)
    assert (o1 <= o0 + 1e-4).all()
    assert (v1 < 1e-2 + 1e-4).all()
    assert np.median(o1) < np.median(o0) - 0.1


def test_fused_k2_route_matches_jax_pooled():
    """Phase 1 at the batch level with K2 per coordinate (the mega=False
    route) against coord_descent_phase1_fused."""
    def jax_fn(arrays, eq_idx, xs):
        form = JForm(*map(jnp.asarray, arrays))
        return jfused.coord_descent_phase1_fused(
            form, jnp.asarray(xs), num_iters=SWEEPS, interpret=True,
            eq_idx=eq_idx)

    def torch_fn(arrays, eq_idx, xs):
        form = form_from_numpy(*arrays, device="cpu", dtype=torch.float32)
        return tfused.coord_descent_phase1_fused(
            form, torch.from_numpy(xs), num_iters=SWEEPS,
            eq_idx=eq_idx).numpy()
    _run_pooled(7, 3, 0.5, jax_fn, torch_fn, never_worse=True)


def test_default_route_above_128_matches_jax_pooled():
    """The K2 route at n = 130 (mega=False: phase 1 through K2 once per
    coordinate, here its plain version, then the unfused phase 2) against
    the JAX package's default route there, its Pallas K2 in
    interpret=True.  The port's default at n = 130 is K1
    (tests/test_torch_cd_route.py)."""
    def jax_fn(arrays, eq_idx, xs):
        form = JForm(*map(jnp.asarray, arrays))
        assert not jfused._mega_fits(form)
        return jfused.improve_coord_descent_fused(
            form, jnp.asarray(xs), num_iters=2, interpret=True)

    def torch_fn(arrays, eq_idx, xs):
        form = form_from_numpy(*arrays, device="cpu", dtype=torch.float32)
        assert tk.holds(form.n, form.m, len(eq_idx))
        return tfused.improve_coord_descent_fused(
            form, torch.from_numpy(xs), num_iters=2, mega=False).numpy()
    _run_pooled(130, 4, 0.5, jax_fn, torch_fn, never_worse=True, restarts=64)


def test_improve_fused_routes():
    """mega (the default wherever K1 holds a restart) is K1; mega=False is
    phase 1 through K2 then the unfused phase 2 on the feasible restarts;
    the generic K2 variant (eq_idx=None) equals the split one."""
    arrays, eq_idx, rng = _arrays(7, 4, 13)
    form = form_from_numpy(*arrays, device="cpu", dtype=torch.float32)
    xs = torch.from_numpy(rng.standard_normal((40, 7)).astype(F32))
    assert tk.holds(form.n, form.m, len(eq_idx))
    mega = tfused.improve_coord_descent_fused(form, xs, num_iters=5)
    np.testing.assert_array_equal(
        mega.numpy(), tk.two_phase_sweeps_ref(form.P, form.q, form.r, eq_idx,
                                              xs, num_iters=5).numpy())
    split = tfused.improve_coord_descent_fused(form, xs, num_iters=5,
                                               mega=False)
    np.testing.assert_array_equal(
        tfused.coord_descent_phase1_fused(form, xs, 5, eq_idx=eq_idx).numpy(),
        tfused.coord_descent_phase1_fused(form, xs, 5, eq_idx=None).numpy())
    v_m, _ = _quality(arrays, mega.numpy())
    v_s, _ = _quality(arrays, split.numpy())
    v0, _ = _quality(arrays, xs.numpy())
    assert (v_m <= v0 + 1e-3).all() and (v_s <= v0 + 1e-3).all()
    # the card's rule: K1 at n = 129 too, where the JAX package's TPU
    # budget routes to K2; both take K1 at this form's n = 7
    big = [np.zeros((2, 129, 129)), np.zeros((2, 129)), np.zeros(2), [False]]
    assert tk.holds(129, 1, 0)
    assert not jfused._mega_fits(JForm(*map(jnp.asarray, big)))
    assert jfused._mega_fits(JForm(*map(jnp.asarray, arrays)))


def test_jax_cpu_vmap_unaffected():
    """Importing the port next to the JAX package leaves JAX's x64 mode and
    backend as the JAX package set them."""
    assert jax.config.jax_enable_x64
    assert jax.default_backend() == "cpu"
