"""tests/test_bisect_quality.py on the port, under the CD contract of
statistical parity: the fused CD's relative-tolerance slack bisection (K1's
plain version, through improve_coord_descent_fused) against the unfused
absolute-tolerance path (solvers/coord_descent.improve_coord_descent_batch),
with the data scaled over four orders of magnitude, in float32 on the CPU.

The JAX test asserts on the 128 starts of one seed.  Phase 1 is chaotic in
the probe trajectory: the two packages round the quadratic formula and the
row sums a few ulps apart, and after one sweep, while no lane has stopped,
lanes of the two packages already part by more than 1e-5.  So the same
three conditions are asserted on the lanes pooled over SEEDS, which hold
the JAX test's seed 1.

The third condition (the best lane lands in the unfused path's 1e-2
violation bucket or better) is a statistic of one lane of the pool, and
the JAX fused path's own best lane moves by many buckets when its starts
move by one ulp.  So the port's best lane is held to the unfused path's
bucket or to the worst bucket the JAX fused path reaches from the same
starts and from the starts one ulp away, whichever is larger.  Beside it,
the port's fused lanes meet the margins of
tests/test_cd_sweep_pallas.py:104-110 against the JAX fused path's
(interpret=True), as tests/test_torch_cd_sweep.py holds K1.

`JAX_PLATFORMS=cpu python -m tests.test_torch_bisect_quality` prints the
pooled statistics, the lanes the packages part on after one sweep, and
the lanes on which the Pallas kernel's tile semantics (a stopped lane's
violation re-derived from the drifting F, which can revive it;
qcqp_tpu/kernels/cd_sweep_pallas.py:177-197) would change the port's
per-lane stop.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qcqp_tpu.core import QCQPForm as JForm
from qcqp_tpu.solvers.coord_descent_fused import (
    improve_coord_descent_fused as j_fused)

from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.solvers.coord_descent import improve_coord_descent_batch
from qcqp_tpu_torch.solvers.coord_descent_fused import (
    improve_coord_descent_fused)
from .test_torch_cd_sweep import _best, _margins, _quality

torch.set_num_threads(1)
SEEDS = (1, 2, 3, 4, 5)
SWEEPS = 10
F32 = np.float32


def _arrays(scale, n=10, m=8, seed=0):
    """tests/test_bisect_quality.py:_form as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2)) * scale
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n) * scale
    r = rng.standard_normal(m + 1) * scale
    is_eq = rng.random(m) < 0.5
    return P.astype(F32), q.astype(F32), r.astype(F32), is_eq


@pytest.fixture(scope="module", params=[1e-2, 1.0, 1e2])
def pooled(request):
    """Per scale: (violation, objective) of every lane of every seed for
    the port's fused and unfused paths and the JAX fused path, the JAX
    fused path's best violation from the starts one ulp up, and the pairs
    of best feasible objectives (JAX fused, port fused) by seed.  The
    fused paths take all seeds' starts in one call: K1's plain version
    runs every lane on its own, and the JAX kernel every 128-lane tile (a
    seed's starts) on its own.  The unfused path refreshes P x by a matmul
    whose sums depend on the batch, so it runs seed by seed."""
    scale = request.param
    arrays = _arrays(scale)
    jform = JForm(*map(jnp.asarray, arrays))
    tform = form_from_numpy(*arrays, device="cpu", dtype=torch.float32)
    starts = [np.random.default_rng(seed).standard_normal((128, 10))
              .astype(F32) for seed in SEEDS]
    xs = np.concatenate(starts)

    def jax_fused(x):
        return np.asarray(j_fused(jform, jnp.asarray(x), num_iters=SWEEPS,
                                  interpret=True))
    out = {
        "fused": improve_coord_descent_fused(
            tform, torch.from_numpy(xs), num_iters=SWEEPS).numpy(),
        "unfused": np.concatenate([improve_coord_descent_batch(
            tform, torch.from_numpy(x), num_iters=SWEEPS).numpy()
            for x in starts]),
        "jax": jax_fused(xs)}
    out = {name: _quality(arrays, x) for name, x in out.items()}
    jax_ulp_best = _quality(arrays, jax_fused(
        np.nextafter(xs, F32(np.inf))))[0].min()
    best_pairs = []
    for lanes in np.split(np.arange(len(xs)), len(SEEDS)):
        bj, bt = (_best(v[lanes], o[lanes])
                  for v, o in (out["jax"], out["fused"]))
        if bj is not None and bt is not None:
            best_pairs.append((bj, bt))
    return scale, out, jax_ulp_best, best_pairs


def _bucket(v):
    return np.floor(v / 1e-2)


def test_relative_bisection_quality_across_scales(pooled):
    """tests/test_bisect_quality.py:35-53's three conditions on the pooled
    lanes of the port's pair, in raw units (at scale 0.01 both paths start
    almost feasible; at scale 100 the relative term dominates)."""
    scale, out, jax_ulp_best, _ = pooled
    vf, vu, vj = out["fused"][0], out["unfused"][0], out["jax"][0]
    assert np.median(vf) <= np.median(vu) * 1.5 + 1e-4 * scale
    assert (vf < 1e-2).mean() >= (vu < 1e-2).mean() - 0.1
    jax_spread = max(_bucket(vj.min()), _bucket(jax_ulp_best))
    assert _bucket(vf.min()) <= max(_bucket(vu.min()), jax_spread)


def test_fused_quality_matches_jax_fused_pooled(pooled):
    """The port's fused lanes against the JAX fused path's on the same
    starts: tests/test_cd_sweep_pallas.py:104-110's margins, pooled."""
    _, out, _, best_pairs = pooled
    _margins(out["jax"][0], out["fused"][0], best_pairs)


def _tile_phase1_loop(ctx, x, num_iters, tol, viol_tol, n_bisect):
    """The port's phase-1 loop with the Pallas kernel's tile semantics
    (cd_sweep_pallas.py:124-197): every lane of the batch sweeps while any
    is alive, a stopped lane keeps its point but its F and violation are
    re-derived each sweep, and its warm bracket is kept.  Counts in
    `revived` the stopped lanes whose violation rose back to viol_tol."""
    from qcqp_tpu_torch.kernels.onevar_kernel import (
        bisect_accept, feasible_point_rows_split, viol_of_split)
    n, R = x.shape
    wl = torch.full((n, R), float("inf"))
    wh = torch.full((n, R), float("inf"))
    viol_last = torch.full((R,), float("inf"))
    changed = torch.ones(R, dtype=torch.bool)
    for _ in range(num_iters):
        alive = (viol_last >= viol_tol) & changed
        if not alive.any():
            break
        F = ctx.refresh_F(x)
        ch = torch.zeros(R, dtype=torch.bool)
        for k in range(n):
            xk, t2, t1, t0 = ctx.restriction(k, x, F)
            t2c, t1c, t0c, act, (p2, q2, r2, act2) = ctx.rows(t2, t1, t0)
            viol = torch.where(act > 0.5, ctx.viols_from_F(F),
                               0.0).amax(dim=0)
            v, (wlo, whi) = bisect_accept(
                lambda s: feasible_point_rows_split(
                    t2c, t1c, t0c, act, p2, q2, r2, act2, xk, s, tol),
                xk, viol, tol, viol_tol, n_bisect,
                viol_of_split(t2c, t1c, t0c, act, p2, q2, r2, act2),
                warm=(wl[k], wh[k]))
            wl[k] = torch.where(alive, wlo, wl[k])
            wh[k] = torch.where(alive, whi, wh[k])
            v = torch.where(alive, v, xk)
            ch |= v != xk
            F = t2 * (v * v) + t1 * v + t0
            x[k] = v
        new_viol = ctx.max_viol(F)
        _tile_phase1_loop.revived += int(
            (~alive & changed & (new_viol >= viol_tol)).sum())
        viol_last = new_viol
        changed = torch.where(alive, ch, changed)
    return x


def _report():
    """The numbers behind ROADMAP's verdict on this recipe."""
    from qcqp_tpu.kernels import cd_sweep_pallas as jk
    from qcqp_tpu_torch.kernels import cd_sweep_kernel as tk

    class Req:
        pass
    for scale in (1e-2, 1.0, 1e2):
        req = Req()
        req.param = scale
        _, out, jax_ulp_best, _ = pooled.__wrapped__(req)
        print(f"scale {scale}: seeds {SEEDS}, {len(out['fused'][0])} lanes")
        for name, (v, _) in out.items():
            print(f"  {name:8s} median viol {np.median(v):.6g}, feasible "
                  f"{(v < 1e-2).mean():.4f}, best lane {v.min():.6g} "
                  f"(bucket {int(_bucket(v.min()))})")
        print(f"  jax from starts one ulp up: best lane {jax_ulp_best:.6g} "
              f"(bucket {int(_bucket(jax_ulp_best))})")
        arrays = _arrays(scale)
        P, q, r, is_eq = arrays
        eq = tuple(int(i) for i in np.nonzero(is_eq)[0])
        tensors = [torch.from_numpy(a) for a in (P, q, r)]
        parted, moved = [], 0
        tk._phase1_loop_saved = tk._phase1_loop
        _tile_phase1_loop.revived = 0
        for seed in SEEDS:
            xs = np.random.default_rng(seed).standard_normal((128, 10))
            xs = xs.astype(F32)
            xj = np.asarray(jk.phase1_sweeps(
                *map(jnp.asarray, (P, q, r)), eq, jnp.asarray(xs),
                num_iters=1, interpret=True))
            xt = tk.phase1_sweeps_ref(*tensors, eq, torch.from_numpy(xs),
                                      num_iters=1).numpy()
            d = np.abs(xj - xt).max(axis=1)
            parted.append(int((d > 1e-5 * (1 + np.abs(xj).max(axis=1)))
                              .sum()))
            per_lane = tk.two_phase_sweeps_ref(
                *tensors, eq, torch.from_numpy(xs), num_iters=SWEEPS)
            tk._phase1_loop = _tile_phase1_loop
            try:
                tile = tk.two_phase_sweeps_ref(
                    *tensors, eq, torch.from_numpy(xs), num_iters=SWEEPS)
            finally:
                tk._phase1_loop = tk._phase1_loop_saved
            moved += int((per_lane != tile).any(dim=1).sum())
        print(f"  lanes parted from JAX's by > 1e-5 after one phase-1 "
              f"sweep, by seed: {parted}")
        print(f"  tile semantics: {_tile_phase1_loop.revived} lanes "
              f"revived, {moved} of {128 * len(SEEDS)} lanes changed")


if __name__ == "__main__":
    import jax
    jax.config.update("jax_platforms", "cpu")
    _report()
