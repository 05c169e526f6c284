"""The CUDA kernels K1 to K5 on the card, against their plain PyTorch
versions, the SDR suggest on the card, and the distributed module on one
card (worker processes: an NCCL world of one, two gloo ranks on cuda:0,
and the refusal of two NCCL ranks on one card).  Marked `gpu`: without a
CUDA device every test skips.  This file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

The kernels are built with -fmad=false and the plain versions run one
correctly rounded operation per PyTorch op, in the kernels' order, so the
comparisons are exact.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _viol_of(p, q, r, eq, act, x):
    val = p * x ** 2 + q * x + r
    vi = np.where(eq, np.abs(val), np.maximum(val, 0.0))
    return np.where(act, vi, 0.0).max(axis=0)


def _k2_inputs(seed, m, R, row_eq):
    rng = np.random.default_rng(seed)
    p, q, r = (rng.standard_normal((m, R)).astype(np.float32)
               for _ in range(3))
    eq_row = rng.random(m) < 0.5
    eq = (np.ascontiguousarray(np.broadcast_to(eq_row[:, None], (m, R)))
          if row_eq else rng.random((m, R)) < 0.5)
    act = rng.random((m, R)) < 0.9
    xk = rng.standard_normal(R).astype(np.float32)
    viol = _viol_of(p, q, r, eq, act, xk).astype(np.float32)
    eq_idx = tuple(int(i) for i in np.nonzero(eq_row)[0]) if row_eq else None
    return (p, q, r, eq, act, xk, viol), eq_idx


@pytest.mark.parametrize("row_eq", [False, True])
@pytest.mark.parametrize("m,R", [(7, 256), (50, 1000)])
def test_k2_kernel_equals_plain(cuda, row_eq, m, R):
    from qcqp_tpu_torch.kernels import onevar_kernel as tk
    arrays, eq_idx = _k2_inputs(m + R, m, R, row_eq)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    before = tk.phase1_coordinate_update.launches
    v = tk.phase1_coordinate_update(*args, eq_idx=eq_idx)
    assert tk.phase1_coordinate_update.launches == before + 1
    ref = tk.phase1_coordinate_update_ref(*args, eq_idx=eq_idx)
    torch.cuda.synchronize()
    assert torch.equal(v, ref)


# (variant, m, E, R): rows (2m generic, m + E split) on both sides of 32
# and 64 (lane l owns rows l mod 32), E = 0 and E = m, ragged R (no
# multiple of a block's 4 warps), and no rows at all (nothing moves).
K2_CASES = [("generic", 16, None, 33), ("generic", 33, None, 300),
            ("generic", 31, None, 1), ("split", 31, 0, 1),
            ("split", 16, 16, 300), ("split", 20, 13, 33),
            ("split", 63, 0, 300), ("split", 32, 32, 1),
            ("split", 40, 25, 33), ("split", 0, 0, 5)]


def _k2_split_inputs(seed, m, e, R):
    """Random rows with exactly e equality rows, as tensors, and eq_idx."""
    rng = np.random.default_rng(seed)
    eq_row = np.zeros(m, bool)
    eq_row[rng.permutation(m)[:e]] = True
    p, q, r = (rng.standard_normal((m, R)).astype(np.float32)
               for _ in range(3))
    eq = np.ascontiguousarray(np.broadcast_to(eq_row[:, None], (m, R)))
    act = rng.random((m, R)) < 0.9
    xk = rng.standard_normal(R).astype(np.float32)
    viol = (_viol_of(p, q, r, eq, act, xk) if m else np.zeros(R))
    return ((p, q, r, eq, act, xk, viol.astype(np.float32)),
            tuple(int(i) for i in np.nonzero(eq_row)[0]))


def _k2_holds(cuda, variant, m, e, R, seed):
    """K2 against its plain version, every lane bit for bit, one launch."""
    from qcqp_tpu_torch.kernels import onevar_kernel as tk
    if variant == "split":
        arrays, eq_idx = _k2_split_inputs(seed, m, e, R)
    else:
        arrays, eq_idx = _k2_inputs(seed, m, R, False)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
            for a in arrays]
    before = tk.phase1_coordinate_update.launches
    v = tk.phase1_coordinate_update(*args, eq_idx=eq_idx)
    assert tk.phase1_coordinate_update.launches == before + 1
    ref = tk.phase1_coordinate_update_ref(*args, eq_idx=eq_idx)
    torch.cuda.synchronize()
    assert torch.equal(v, ref)
    assert (v != args[5]).any() == (m > 0)


@pytest.mark.parametrize("variant,m,e,R", K2_CASES)
def test_k2_kernel_equals_plain_across_lanes(cuda, variant, m, e, R):
    _k2_holds(cuda, variant, m, e, R, m + R)


@pytest.mark.parametrize("variant,m,e,R,block_max", [
    ("split", 40, 25, 33, 1024), ("generic", 20, None, 300, 1024),
    ("split", 4843, 4843, 2, None)])
def test_k2_global_rows_equal_plain(cuda, monkeypatch, variant, m, e, R,
                                    block_max):
    """The global-memory rows: forced at small m by a smaller block limit,
    and at m = E = 4,843, whose 232,464-byte warp slice exceeds a block's
    shared memory."""
    from qcqp_tpu_torch.kernels import onevar_kernel as tk
    if block_max is not None:
        monkeypatch.setattr(tk, "SMEM_BLOCK_MAX", block_max)
    assert tk.launch_geometry(m, e or 0, variant == "split")[3]
    _k2_holds(cuda, variant, m, e, R, 7)


def test_k2_route_above_128_equals_plain(cuda, monkeypatch):
    """The K2 route at n = 130 (mega=False: phase 1 through K2 once per
    coordinate, then the unfused phase 2) equals, on every restart, the
    same route with K2's plain version in K2's place."""
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels import cd_sweep_kernel as k1
    from qcqp_tpu_torch.kernels import onevar_kernel as tk
    from qcqp_tpu_torch.solvers import coord_descent_fused as fused
    arrays, rng = _k1_form(130, 4, 1, 0.5)
    form = form_from_numpy(*arrays, device=cuda, dtype=torch.float32)
    xs = torch.from_numpy(
        (0.5 * rng.standard_normal((70, 130))).astype(np.float32)).to(cuda)
    before = (k1.two_phase_sweeps.launches,
              tk.phase1_coordinate_update.launches)
    out = fused.improve_coord_descent_fused(form, xs, num_iters=2,
                                            mega=False)
    assert k1.two_phase_sweeps.launches == before[0]
    assert tk.phase1_coordinate_update.launches >= before[1] + 130
    monkeypatch.setattr(fused, "phase1_coordinate_update",
                        tk.phase1_coordinate_update_ref)
    want = fused.improve_coord_descent_fused(form, xs, num_iters=2,
                                             mega=False)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert (out != xs).any()


def test_default_route_at_n256_is_one_k1_launch(cuda):
    """bench.py's form at n = 256, m = 20 through solve_restarts with no
    mega= argument: one K1 launch, no K2 launch, a finite best point; K1
    on the same starts gives that best point."""
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels import cd_sweep_kernel as k1
    from qcqp_tpu_torch.kernels import onevar_kernel as tk
    from qcqp_tpu_torch.parallel.restarts import (best_point, solve_restarts,
                                                  suggest_batch)
    rng = np.random.default_rng(0)
    n, m = 256, 20
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    arrays = (0.5 * (A + np.swapaxes(A, -1, -2)),
              rng.standard_normal((m + 1, n)) / np.sqrt(n),
              rng.standard_normal(m + 1), rng.random(m) < 0.5)
    form = form_from_numpy(*arrays, device=cuda, dtype=torch.float32)
    before = (k1.two_phase_sweeps.launches,
              tk.phase1_coordinate_update.launches)
    x, f, v = solve_restarts(form, 1024, torch.Generator(
        device=cuda).manual_seed(1), num_iters=10)
    assert (k1.two_phase_sweeps.launches - before[0],
            tk.phase1_coordinate_update.launches - before[1]) == (1, 0)
    assert x.shape == (n,) and torch.isfinite(x).all()
    assert bool(torch.isfinite(f)) and bool(torch.isfinite(v))
    xs = suggest_batch(form, 1024, torch.Generator(device=cuda).manual_seed(1))
    out = k1.two_phase_sweeps(form.P, form.q, form.r, form.eq_idx(), xs,
                              num_iters=10)
    assert all(torch.equal(a, b)
               for a, b in zip(best_point(form, out), (x, f, v)))


def _k1_form(n, m, seed, eq_frac):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    P[0] += 2.0 * np.eye(n)
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    r[1:] = np.abs(r[1:]) * -0.5           # a region of feasible starts
    is_eq = rng.random(m) < eq_frac
    return (P, q, r, is_eq), rng


def _k1_holds(form, xs, num_iters):
    """K1 against its plain version, every lane bit for bit, both
    wrappers; the identity at num_iters=0; a restart permutation moves
    the output's rows with it."""
    from qcqp_tpu_torch.kernels import cd_sweep_kernel as tk
    eq_idx = form.eq_idx()
    args = (form.P, form.q, form.r, eq_idx)
    for fn, ref in ((tk.two_phase_sweeps, tk.two_phase_sweeps_ref),
                    (tk.phase1_sweeps, tk.phase1_sweeps_ref)):
        before = fn.launches
        out = fn(*args, xs, num_iters=num_iters)
        assert fn.launches == before + 1
        want = ref(*args, xs, num_iters=num_iters)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        if fn is tk.two_phase_sweeps:
            full = out
    assert torch.equal(tk.two_phase_sweeps(*args, xs, num_iters=0), xs)
    R = xs.shape[0]
    perm = torch.randperm(R, generator=torch.Generator().manual_seed(0))
    perm = perm.to(xs.device)
    permuted = tk.two_phase_sweeps(*args, xs[perm], num_iters=num_iters)
    assert torch.equal(permuted, full[perm])


# (n, m, share of equality rows, R, sweeps): m + 1 and m + E on both sides
# of 32 and 64 (one warp's lanes own rows i = lane mod 32), n = 1 at
# m = 1,278 and n = 128 at m = 78, n = 8 at m = 300; above n = 128, where
# the CD route sends K1 by the card's rule, n = 129 and 256 with m + 1 and
# m + E on both sides of 32, and (128, 79); R = 1 and 300 (no multiple of
# a block's 4 warps).
K1_CASES = [(9, 5, 0.0, 300, 8), (9, 5, 0.5, 300, 8), (9, 5, 1.0, 300, 8),
            (9, 30, 0.0, 300, 6), (9, 30, 1.0, 1, 6),
            (9, 31, 0.0, 1, 6), (9, 31, 1.0, 300, 6),
            (9, 32, 0.0, 300, 6), (9, 32, 1.0, 300, 6),
            (9, 63, 0.0, 300, 4), (9, 63, 1.0, 1, 4),
            (9, 64, 0.0, 1, 4), (9, 64, 1.0, 300, 4),
            (1, 1278, 0.0, 100, 4), (1, 1278, 1.0, 30, 4),
            (128, 78, 0.0, 300, 2), (128, 78, 1.0, 300, 2),
            (8, 300, 0.0, 300, 4), (8, 300, 1.0, 300, 4),
            (129, 30, 1.0, 300, 1), (129, 32, 0.0, 1, 1),
            (256, 20, 0.5, 1, 1), (256, 32, 0.0, 300, 1),
            (128, 79, 0.0, 300, 1)]


@pytest.mark.parametrize("n,m,eq_frac,R,sweeps", K1_CASES)
def test_k1_kernel_equals_plain(cuda, n, m, eq_frac, R, sweeps):
    from qcqp_tpu_torch.convert import form_from_numpy
    arrays, rng = _k1_form(n, m, n + m + R, eq_frac)
    form = form_from_numpy(*arrays, device=cuda, dtype=torch.float32)
    xs = torch.from_numpy(
        (0.5 * rng.standard_normal((R, n))).astype(np.float32)).to(cuda)
    _k1_holds(form, xs, sweeps)


def _k1_tie_form(n):
    """Integer data that forces ties: a constant objective, so that every
    feasible phase-2 candidate has the value 0, and rows x_i^2 <= c_i
    (c_i = 1 or 4) with rows 0 and 1 repeated (equal witness candidates).
    From x_i = 0 the two bounds -sqrt(c_i) and +sqrt(c_i) tie in value and
    in distance, and the lower index (the a bound) must win."""
    m = n + 2
    P = np.zeros((m + 1, n, n))
    r = np.zeros(m + 1)
    for i in range(m):
        P[1 + i, i % n, i % n] = 1.0
        r[1 + i] = -1.0 - 3.0 * ((i % n) % 2)
    return P, np.zeros((m + 1, n)), r


@pytest.mark.parametrize("eq", [False, True])
def test_k1_kernel_equals_plain_on_ties(cuda, eq):
    from qcqp_tpu_torch.convert import form_from_numpy
    P, q, r = _k1_tie_form(5)
    is_eq = np.full(P.shape[0] - 1, eq)
    form = form_from_numpy(P, q, r, is_eq, device=cuda, dtype=torch.float32)
    rng = np.random.default_rng(4)
    xs = torch.from_numpy(rng.integers(-1, 2, (300, 5)).astype(np.float32))
    _k1_holds(form, xs.to(cuda), 6)


def _k1_stack(cuda, S, n, m, R, seed):
    """S forms of one shape, each with its own equality pattern (E = 0, m,
    about m/2 and about m/4 in turn), stacked on the card, and (S, R, n)
    starts."""
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.parallel.scenarios import stack_forms
    forms = []
    for s in range(S):
        arrays, rng = _k1_form(n, m, seed + s, (0.0, 1.0, 0.5, 0.25)[s % 4])
        forms.append(form_from_numpy(*arrays, device=cuda,
                                     dtype=torch.float32))
    xs = torch.from_numpy((0.5 * rng.standard_normal((S, R, n)))
                          .astype(np.float32)).to(cuda)
    return stack_forms(forms), [f.eq_idx() for f in forms], xs


def test_k1_stacked_launch_equals_plain(cuda):
    """One K1 launch over a stack of S = 4 forms with different E (0, m
    and between), R = 33 a scenario, one sweep, equals the plain version
    run scenario by scenario, every lane bit for bit; both wrappers, one
    launch each."""
    from qcqp_tpu_torch.kernels import cd_sweep_kernel as tk
    st, eqs, xs = _k1_stack(cuda, 4, 9, 30, 33, 40)
    assert len({len(e) for e in eqs}) == 4 and {0, 30} <= {len(e)
                                                           for e in eqs}
    args = (st.P, st.q, st.r, eqs)
    for fn, ref in ((tk.two_phase_sweeps, tk.two_phase_sweeps_ref),
                    (tk.phase1_sweeps, tk.phase1_sweeps_ref)):
        before = fn.launches
        out = fn(*args, xs, num_iters=1)
        assert fn.launches == before + 1
        want = ref(*args, xs, num_iters=1)
        torch.cuda.synchronize()
        assert out.shape == xs.shape and torch.equal(out, want)
        assert (out != xs).any()


def test_k1_stacked_launch_equals_single_launches(cuda):
    """The stacked launch equals S single-form launches on the same
    starts, every lane bit for bit, with E different per scenario."""
    from qcqp_tpu_torch.kernels import cd_sweep_kernel as tk
    st, eqs, xs = _k1_stack(cuda, 4, 9, 70, 33, 50)
    before = tk.two_phase_sweeps.launches
    out = tk.two_phase_sweeps(st.P, st.q, st.r, eqs, xs, num_iters=3)
    assert tk.two_phase_sweeps.launches == before + 1
    for s in range(4):
        one = tk.two_phase_sweeps(st.P[s], st.q[s], st.r[s], eqs[s], xs[s],
                                  num_iters=3)
        torch.cuda.synchronize()
        assert torch.equal(out[s], one)


def test_k1_stack_of_one_equals_single_form(cuda):
    """S = 1 is the single-form launch: the same bits as the call on the
    form itself."""
    from qcqp_tpu_torch.kernels import cd_sweep_kernel as tk
    st, eqs, xs = _k1_stack(cuda, 1, 9, 30, 300, 60)
    out = tk.two_phase_sweeps(st.P, st.q, st.r, eqs, xs, num_iters=4)
    one = tk.two_phase_sweeps(st.P[0], st.q[0], st.r[0], eqs[0], xs[0],
                              num_iters=4)
    torch.cuda.synchronize()
    assert out.shape == (1, 300, 9) and torch.equal(out[0], one)


def test_solve_scenarios_on_the_card(cuda):
    """solve_scenarios on a CUDA float32 stack launches K1 once for all
    S x R restarts, and each scenario equals solve_restarts on its form
    from the generator after the draws of the scenarios before it, bit
    for bit."""
    from qcqp_tpu_torch.kernels import cd_sweep_kernel as tk
    from qcqp_tpu_torch.parallel.restarts import solve_restarts
    from qcqp_tpu_torch.parallel.scenarios import scenario, solve_scenarios
    st, _, _ = _k1_stack(cuda, 4, 9, 30, 1, 70)
    gen = lambda: torch.Generator(device=cuda).manual_seed(5)  # noqa: E731
    before = tk.two_phase_sweeps.launches
    xs, fs, vs = solve_scenarios(st, 64, gen(), num_iters=10)
    assert tk.two_phase_sweeps.launches == before + 1
    assert xs.shape == (4, 9) and fs.shape == vs.shape == (4,)
    g = gen()
    for s in range(4):
        x, f, v = solve_restarts(scenario(st, s), 64, g, num_iters=10)
        assert torch.equal(x, xs[s]) and torch.equal(f, fs[s])
        assert torch.equal(v, vs[s])


def test_kernels_refuse_what_they_do_not_take(cuda):
    from qcqp_tpu_torch.kernels import cd_sweep_kernel as k1
    from qcqp_tpu_torch.kernels import onevar_kernel as k2
    arrays, _ = _k2_inputs(0, 4, 64, False)
    args64 = [torch.from_numpy(a).to(cuda) for a in arrays]
    args64 = [a.double() if a.is_floating_point() else a for a in args64]
    with pytest.raises(TypeError):
        k2.phase1_coordinate_update(*args64)
    (P, q, r, is_eq), _ = _k1_form(5, 2, 0, 0.5)
    P, q, r = (torch.tensor(a, device=cuda) for a in (P, q, r))   # float64
    with pytest.raises(TypeError):
        k1.two_phase_sweeps(P, q, r, (), torch.zeros((8, 5), device=cuda,
                                                     dtype=torch.float64))
    # one restart's state above the 227 KB a block may hold: 4 (3n +
    # 4 (m+1) + 5 (m+E)) = 392,112 bytes at n = 8, m = E = 7,000
    n, m = 8, 7000
    P, q, r = (torch.zeros(s, device=cuda) for s in ((m + 1, n, n),
                                                     (m + 1, n), (m + 1,)))
    before = k1.two_phase_sweeps.launches
    with pytest.raises(ValueError, match="shared memory"):
        k1.two_phase_sweeps(P, q, r, tuple(range(m)),
                            torch.zeros((4, n), device=cuda))
    assert k1.two_phase_sweeps.launches == before


def _k3_form(kind):
    """A dense random form with equality rows, or boolean least squares
    (semidefinite rows: K3's bracket doubling runs)."""
    rng = np.random.default_rng(5)
    if kind == "dense":
        n, m = 37, 6
        A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
        P = 0.5 * (A + np.swapaxes(A, -1, -2))
        q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
        r = rng.standard_normal(m + 1)
        return (P, q, r, rng.random(m) < 0.5), rng
    n = 10
    A, b = rng.standard_normal((15, n)), rng.standard_normal(15)
    P = np.zeros((n + 1, n, n))
    P[0] = A.T @ A
    P[1:, np.arange(n), np.arange(n)] = np.eye(n)
    q = np.zeros((n + 1, n))
    q[0] = -2.0 * A.T @ b
    r = -np.ones(n + 1)
    r[0] = b @ b
    return (P, q, r, np.ones(n, bool)), rng


@pytest.mark.parametrize("kind", ["dense", "boolean"])
def test_k3_kernel_equals_plain(cuda, kind):
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels import admm_kernel as tk
    arrays, rng = _k3_form(kind)
    form = form_from_numpy(*arrays, device=cuda, dtype=torch.float32)
    d = tk.ADMMFusedData(form)
    assert d.need_dbl == (kind == "boolean")
    xs = torch.from_numpy(rng.standard_normal((37, form.n))
                          .astype(np.float32)).to(cuda)
    for phase in (1, 2):
        want = tk.admm_phase_ref(d, xs, phase, num_iters=30)
        before = tk.admm_phase.launches
        out = tk.admm_phase(d, xs, phase, num_iters=30)
        assert tk.admm_phase.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(out, want), phase
        assert torch.equal(tk.admm_phase(d, xs, phase, num_iters=0), xs)
        perm = torch.randperm(37, generator=torch.Generator().manual_seed(0))
        perm = perm.to(cuda)
        assert torch.equal(tk.admm_phase(d, xs[perm], phase, num_iters=30),
                           want[perm])
    out = tk.improve_admm_fused(form, xs, num_iters=30, data=d)
    assert torch.equal(out, tk.improve_admm_fused_ref(form, xs, num_iters=30,
                                                      data=d))


def _k3_shape_form(n, m, dbl, seed):
    """A dense random form with equality rows; with dbl, constraint 1 is
    semidefinite, so K3's bracket doubling runs."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    is_eq = rng.random(m) < 0.5
    if dbl:
        B = rng.standard_normal((n, n))
        P[1] = B @ B.T / n
        r[1] = -abs(r[1]) - 0.5
        is_eq[0] = False
    return (P, q, r, is_eq), rng


# (n, m, R, need_dbl, chunk rows): n across the 32-coordinate chunks a
# lane owns, the whole-slab limit (160) and one past it (161: Q_i streamed
# in chunks); R = 1, 40 and "block" (a full block of the most warps that
# fit, 16, or 8 at n = 160, and a ragged one); need_dbl on and off; the
# chunked storage forced at n = 37 with 8-row chunks (5 chunks, the last
# of 5 rows).
K3_CASES = [(1, 1, 1, True, None), (33, 4, "block", False, None),
            (65, 2, 40, True, None), (160, 2, "block", False, None),
            (161, 2, 5, True, None), (37, 3, "block", True, 8),
            (37, 3, 40, False, 8)]


@pytest.mark.parametrize("n,m,R,dbl,rows", K3_CASES)
def test_k3_shapes_equal_plain(cuda, n, m, R, dbl, rows):
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels import admm_kernel as tk
    arrays, rng = _k3_shape_form(n, m, dbl, n + m)
    form = form_from_numpy(*arrays, device=cuda, dtype=torch.float32)
    d = tk.ADMMFusedData(form)
    assert d.need_dbl == dbl
    geometry = None
    if R == "block" or rows:       # the largest block that fits, or chunks
        warps, r_, _ = tk.launch_geometry(n, m)
        R = warps + 1 if R == "block" else R
        geometry = (warps, rows or r_, None)
    xs = torch.from_numpy((0.5 * rng.standard_normal((R, n)))
                          .astype(np.float32)).to(cuda)
    for phase in (1, 2):
        out = tk._launch(d, xs, phase, 15, 1e-2, 1e4, 1e-4, tk.NW_TRIPS,
                         geometry=geometry)
        torch.cuda.synchronize()
        assert torch.equal(out, tk.admm_phase_ref(d, xs, phase,
                                                  num_iters=15)), phase


def test_k3_refuses_what_it_does_not_take(cuda):
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels import admm_kernel as tk
    arrays, rng = _k3_form("dense")
    form = form_from_numpy(*arrays, device=cuda, dtype=torch.float32)
    d = tk.ADMMFusedData(form)
    xs = torch.from_numpy(rng.standard_normal((8, form.n))).to(cuda)
    with pytest.raises(TypeError):
        tk.admm_phase(d, xs, 1, num_iters=3)                 # float64
    with pytest.raises(ValueError):
        tk.admm_phase(d, xs.float().T.contiguous().T, 1, num_iters=3)


def test_golden_through_handler(cuda):
    import qcqp_tpu_torch as qt
    from qcqp_tpu_torch.kernels.cd_sweep_kernel import two_phase_sweeps
    rs = np.random.RandomState(1)
    A = rs.randn(15, 10)
    b = rs.randn(15, 1).ravel()
    x = qt.Variable(10)
    prob = qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                      [qt.square(x) == 1])
    h = qt.QCQP(prob)                  # defaults to the card, float32
    assert h.device.type == "cuda" and h.qcqp_form.dtype == torch.float32
    before = two_phase_sweeps.launches
    f, v = h.solve(num_restarts=256, num_iters=50)
    assert two_phase_sweeps.launches == before + 1
    assert v < 1e-2 and 35.551 - 0.1 <= f <= 35.551 + 2e-2


def _k4_form(kind):
    """Forms for K4: dense random with equality rows (n <= 128: 8 lanes a
    thread), wide (n > 128: 16 lanes a thread), boolean least squares
    (every row an equality) and no constraints (m = 0)."""
    rng = np.random.default_rng(6)
    if kind == "boolean":
        return _k3_form("boolean")[0], rng
    n, m = {"dense": (37, 6), "wide": (150, 3), "m0": (12, 0)}[kind]
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    return (P, q, r, rng.random(m) < 0.5), rng


@pytest.mark.parametrize("kind", ["dense", "wide", "boolean", "m0"])
def test_k4_kernel_equals_plain(cuda, kind):
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels import ccp_kernel as tk
    arrays, rng = _k4_form(kind)
    form = form_from_numpy(*arrays, device=cuda, dtype=torch.float32)
    d = tk.CCPFusedData(form)
    xs = torch.from_numpy(rng.standard_normal((130, form.n))
                          .astype(np.float32)).to(cuda)
    kw = dict(max_iter=4, inner_iters=5)
    want = tk.ccp_improve_ref(d, xs, **kw)
    before = tk.ccp_improve.launches
    out = tk.ccp_improve(d, xs, **kw)
    assert tk.ccp_improve.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert torch.equal(tk.ccp_improve(d, xs, max_iter=0), xs)
    # lanes permuted inside the first tile, then whole tiles permuted
    # (the last tile is ragged: 2 real lanes and 62 zero lanes)
    perm = torch.cat([torch.randperm(64, generator=torch.Generator()
                                     .manual_seed(1)),
                      torch.arange(64, 130)]).to(cuda)
    assert torch.equal(tk.ccp_improve(d, xs[perm], **kw), want[perm])
    tiles = torch.cat([torch.arange(64, 128), torch.arange(64),
                       torch.arange(128, 130)]).to(cuda)
    assert torch.equal(tk.ccp_improve(d, xs[tiles], **kw), want[tiles])
    fused = tk.improve_ccp_fused(form, xs, data=d, **kw)
    assert torch.equal(fused, tk.improve_ccp_fused_ref(form, xs, data=d,
                                                       **kw))


def test_k4_refuses_what_it_does_not_take(cuda):
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels import ccp_kernel as tk
    arrays, rng = _k4_form("dense")
    form = form_from_numpy(*arrays, device=cuda, dtype=torch.float32)
    d = tk.CCPFusedData(form)
    xs = torch.from_numpy(rng.standard_normal((8, form.n))).to(cuda)
    with pytest.raises(TypeError):
        tk.ccp_improve(d, xs, max_iter=2)                    # float64
    with pytest.raises(ValueError):
        tk.ccp_improve(d, xs.float().T.contiguous().T, max_iter=2)


def test_k4_golden_through_handler(cuda):
    """QCQP(prob).improve(DCCP) on the default device goes through K4 once
    (tests/test_ccp_pallas.py:99-125)."""
    import qcqp_tpu_torch as qt
    from qcqp_tpu_torch.kernels import ccp_kernel as tk
    x = qt.Variable(3)
    prob = qt.Problem(qt.Minimize(qt.sum_squares(x)), [qt.square(x) == 1])
    h = qt.QCQP(prob)
    assert h.device.type == "cuda"
    h.suggest(qt.RANDOM)
    before = tk.ccp_improve.launches
    f, v = h.improve(qt.DCCP)
    assert tk.ccp_improve.launches == before + 1
    assert v < 1e-2


@pytest.mark.parametrize("B,n0,sweeps,rounds", [
    (16, 24, 2, None), (3, 24, 2, 57),
    (2, 200, 1, None),                  # n = 256: the global-memory code
    # the storages' edges (eigh_kernel.launch_geometry): one warp a matrix
    # up to n0 = 32, several a block (a ragged last one at B = 301); one
    # block a matrix from 33, 2 to 6 column chunks a lane; shared memory
    # up to 169
    (4, 1, 2, None), (132, 25, 2, None), (301, 25, 2, None),
    (7, 32, 2, None), (7, 33, 2, None), (3, 64, 1, None), (3, 65, 1, None),
    (3, 128, 1, None), (3, 129, 1, None), (2, 169, 1, None),
    (2, 170, 1, 100)])
def test_k5_kernel_equals_plain(cuda, B, n0, sweeps, rounds):
    from qcqp_tpu_torch.kernels import eigh_kernel as tk
    A = np.random.default_rng(B + n0).standard_normal((B, n0, n0))
    A = torch.from_numpy((0.5 * (A + np.swapaxes(A, -1, -2)))
                         .astype(np.float32)).to(cuda)
    before = tk.eigh_jacobi_vec.launches
    lam, V = tk.eigh_jacobi_vec(A, sweeps=sweeps, _rounds=rounds)
    assert tk.eigh_jacobi_vec.launches == before + 1
    lam_p, V_p = tk.eigh_jacobi_vec_ref(A, sweeps=sweeps, _rounds=rounds)
    torch.cuda.synchronize()
    assert torch.equal(lam, lam_p) and torch.equal(V, V_p)


def test_k5_schedule_is_made_once_per_shape(cuda):
    """The vec SDP loop launches K5 at one shape every iteration: the
    real-pair schedule is built and copied to the card once."""
    from qcqp_tpu_torch.kernels import eigh_kernel as tk
    A = torch.eye(25, device=cuda).expand(2, 25, 25).contiguous()
    tk.eigh_jacobi_vec(A, sweeps=2)
    misses = tk._device_schedule.cache_info().misses
    lam, V = tk.eigh_jacobi_vec(A, sweeps=2)
    assert tk._device_schedule.cache_info().misses == misses
    assert torch.equal(lam, torch.ones(2, 25, device=cuda))


def test_k5b_wrapper_launches_k5(cuda):
    """eigh_jacobi launches the same kernel; against its matmul plain
    version (rounded differently) at the LAPACK-level tolerance."""
    from qcqp_tpu_torch.kernels import eigh_kernel as tk
    A = np.random.default_rng(0).standard_normal((3, 40, 40))
    A = torch.from_numpy((0.5 * (A + np.swapaxes(A, -1, -2)))
                         .astype(np.float32)).to(cuda)
    before = tk.eigh_jacobi.launches
    lam, V = tk.eigh_jacobi(A, sweeps=8)
    assert tk.eigh_jacobi.launches == before + 1
    lam_p, V_p = tk.eigh_jacobi_ref(A, sweeps=8)
    scale = float(lam_p.abs().max())
    assert float((lam - lam_p).abs().max()) < 1e-4 * scale
    rec = V @ torch.diag_embed(lam) @ V.transpose(-1, -2)
    assert float((rec - A).abs().max()) < 1e-4 * scale


def test_sdp_vec_lockstep_with_plain_version(cuda, monkeypatch):
    """solve_sdp(psd_method="vec") on the card, 10 iterations, equals the
    same solve with K5's plain version in place of the kernel, bit for
    bit."""
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels import eigh_kernel as tk
    from qcqp_tpu_torch.solvers import sdp
    arrays, _ = _k3_form("boolean")
    data = sdp._sdr_data(form_from_numpy(*arrays, device=cuda,
                                         dtype=torch.float32))
    kw = dict(max_iters=10, tol=0.0, psd_method="vec", accel_mem=0,
              alpha=1.6, detect_certificates=False)
    before = tk.eigh_jacobi_vec.launches
    sol = sdp.solve_sdp(data, **kw)
    assert tk.eigh_jacobi_vec.launches == before + 10
    monkeypatch.setattr(tk, "eigh_jacobi_vec", tk.eigh_jacobi_vec_ref)
    plain = sdp.solve_sdp(data, **kw)
    for a, b in ((sol.X, plain.X), (sol.primal_res, plain.primal_res),
                 (sol.dual_res, plain.dual_res)):
        assert torch.equal(a, b)


def test_sdr_suggest_on_the_card(cuda):
    """QCQP(prob).suggest(SDR) on the default device: the float32 SDR on
    the card, accepted with no float64 re-solve, the boolean-LS golden
    28.750 within 2e-2."""
    import qcqp_tpu_torch as qt
    from qcqp_tpu_torch.solvers import sdp
    rs = np.random.RandomState(1)
    A, b = rs.randn(15, 10), rs.randn(15, 1).ravel()
    x = qt.Variable(10)
    h = qt.QCQP(qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                           [qt.square(x) == 1]))
    assert h.device.type == "cuda"
    before = sdp.solve_sdr.resolves
    h.suggest(qt.SDR)
    assert sdp.solve_sdr.resolves == before
    assert h.mu.is_cuda and abs(h.sdr_bound - 28.750) < 2e-2


def _bls_problem(qt):
    rs = np.random.RandomState(1)
    A, b = rs.randn(15, 10), rs.randn(15, 1).ravel()
    x = qt.Variable(10)
    return qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                      [qt.square(x) == 1])


def test_spectral_suggest_on_the_card(cuda):
    """QCQP(prob).suggest(SPECTRAL) on the default device, float32: the
    route taken is reported, the point lies on the card, and the bound and
    point are finite, within 2e-2 of the JAX package's float64 bound
    13.7365 (the SDR goldens' tolerance) and below the SDR bound
    28.750."""
    import qcqp_tpu_torch as qt
    from qcqp_tpu_torch.solvers import sdp
    h = qt.QCQP(_bls_problem(qt))
    assert h.device.type == "cuda" and h.qcqp_form.dtype == torch.float32
    sdp._solve_single.route = None
    h.suggest(qt.SPECTRAL)
    assert sdp._solve_single.route in ("device", "ns_steps=20", "float64")
    assert h.spectral_sol.is_cuda
    assert torch.isfinite(h.spectral_sol).all()
    assert abs(h.spectral_bound - 13.736533) < 2e-2
    assert h.spectral_bound <= 28.750


def _convex_nlp_arrays(seed, n=8, m_in=4):
    """tests/test_nlp.py:20-35's convex instance, as numpy arrays."""
    rng = np.random.default_rng(seed)
    k = m_in + 2
    P = np.zeros((k, n, n))
    q = rng.standard_normal((k, n))
    r = np.zeros(k)
    for i in range(m_in + 1):
        A = rng.standard_normal((n, n)) / np.sqrt(n)
        P[i] = A @ A.T + 0.1 * np.eye(n)
    r[1:m_in + 1] = -rng.uniform(0.5, 2.0, m_in)
    is_eq = np.zeros(m_in + 1, bool)
    is_eq[-1] = True
    return 0.5 * (P + np.swapaxes(P, -1, -2)), q, r, is_eq


def test_nlp_float32_on_the_card(cuda):
    """improve_nlp in float32 on the card, 64 random starts of a dense
    random form (n = 20, m = 8, half equalities): every lane finite and
    none worse than its start under `better`."""
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.core import (eval_objective_batch,
                                     max_violation_batch)
    from qcqp_tpu_torch.solvers.nlp import improve_nlp
    rng = np.random.default_rng(12)
    n, m = 20, 8
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    form = form_from_numpy(0.5 * (A + np.swapaxes(A, -1, -2)),
                           rng.standard_normal((m + 1, n)) / np.sqrt(n),
                           rng.standard_normal(m + 1), rng.random(m) < 0.5,
                           device=cuda, dtype=torch.float32)
    xs = torch.from_numpy(rng.standard_normal((64, n)).astype(np.float32))
    xs = xs.to(cuda)
    x = improve_nlp(form, xs)
    assert x.dtype == torch.float32 and torch.isfinite(x).all()

    def key(z):
        return (torch.floor(max_violation_batch(form, z) / 1e-4),
                eval_objective_batch(form, z))
    (vb0, f0), (vb, f) = key(xs), key(x)
    assert bool(((vb < vb0) | ((vb == vb0) & (f <= f0))).all())


def test_nlp_card_float64_matches_cpu(cuda):
    """The port in float64 on the card against the port in float64 on the
    CPU, 16 starts of tests/test_nlp.py's convex instance (seed 1): every
    lane that the CPU run determines (x moves by less than 1e-9 when the
    starts move by a few ulps) within 1e-7, as tests/test_torch_nlp.py
    holds the port against the JAX package."""
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.solvers.nlp import improve_nlp
    arrays = _convex_nlp_arrays(1)
    cpu = form_from_numpy(*arrays, device="cpu", dtype=torch.float64)
    card = form_from_numpy(*arrays, device=cuda, dtype=torch.float64)
    X0 = np.random.default_rng(40).standard_normal((16, 8))
    Xs = np.concatenate([X0] + [
        X0 * (1.0 + 4e-16 * np.random.default_rng(50 + s)
              .standard_normal(X0.shape)) for s in range(3)])
    xc = improve_nlp(cpu, torch.from_numpy(Xs)).numpy().reshape(4, 16, 8)
    spread = np.abs(xc[1:] - xc[0]).max(axis=(0, 2))
    determined = spread < 1e-9
    assert determined.sum() >= 8
    xg = improve_nlp(card, torch.from_numpy(X0).to(cuda)).cpu().numpy()
    np.testing.assert_allclose(xg[determined], xc[0][determined], rtol=0,
                               atol=1e-7)


# The distributed module on one card: worker processes
# (tests/torch_distributed_worker.py) join a process group and compute on
# cuda:0.  NCCL takes one rank a card, so the two-rank run uses gloo.

def _dist_form():
    rng = np.random.default_rng(21)
    A = rng.standard_normal((9, 12, 12)) / np.sqrt(12)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((9, 12)) / np.sqrt(12)
    r = rng.standard_normal(9)
    return [P, q, r, rng.random(8) < 0.5]


def _dist_run(tmp_path, nproc, backend, cases):
    from qcqp_tpu_torch.kernels import _build
    from .torch_distributed_worker import run_workers
    _build.library()                 # built once here, loaded by the workers
    return run_workers(nproc, cases, str(tmp_path), device="cuda:0",
                       backend=backend, timeout=300.0, pg_timeout=120.0)


def test_nccl_world_of_one_equals_one_process(cuda, tmp_path):
    """solve_restarts(mesh=make_mesh()) in an NCCL world of one on cuda:0
    equals solve_restarts without a mesh, bit for bit, through one K1
    launch."""
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.parallel import restarts
    arrays = _dist_form()
    case = {"name": "cd", "kind": "restarts", "arrays": arrays,
            "dtype": "float32", "R": 256, "seed": 5,
            "kw": {"num_iters": 10}}
    got = _dist_run(tmp_path, 1, "nccl", [case])[0]["cd"]
    assert got["launches"] == {"k1": 1, "k3": 0, "k4": 0}
    form = form_from_numpy(*arrays, device="cuda", dtype=torch.float32)
    x, f, v = restarts.solve_restarts(
        form, 256, torch.Generator(device="cuda").manual_seed(5),
        num_iters=10)
    assert np.array_equal(got["x"], x.cpu().numpy())
    assert got["f"] == f.item() and got["v"] == v.item()


class _Gathered:
    """Two ranks' candidates stacked in one process: what pick_across's
    all_gather returns on the ranks."""

    def __init__(self, parts):
        self.parts = parts

    def all_gather(self, t, axis):
        return self.parts


def test_gloo_two_ranks_on_one_card_run_the_kernels(cuda, tmp_path):
    """Two gloo ranks, both on cuda:0: CD (K1), ADMM (K3, two phases) and
    DCCP (K4, one 64-lane tile a rank) each run once a rank on the rank's
    block; each block equals those rows of the one-process chain bit for
    bit, and the best point, the same on both ranks, is the pick of the
    two blocks' candidates bit for bit.  Against the one-process best it
    holds to 1e-5 relative in f, with the same violation bucket: the
    objective is an (R, n) x (n, n) cuBLAS product whose rows' rounding
    depends on R (PERF.md)."""
    from qcqp_tpu_torch import settings as s
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.core import violation_bucket
    from qcqp_tpu_torch.parallel import restarts
    arrays = _dist_form()
    runs = {"cd": (s.COORD_DESCENT, 256, {"num_iters": 10},
                   {"k1": 1, "k3": 0, "k4": 0}),
            "admm": (s.ADMM, 128, {"num_iters": 20},
                     {"k1": 0, "k3": 2, "k4": 0}),
            "dccp": (s.DCCP, 128, {"max_iter": 4},
                     {"k1": 0, "k3": 0, "k4": 1})}
    cases = [{"name": name, "kind": "restarts", "arrays": arrays,
              "dtype": "float32", "R": R, "seed": 7,
              "kw": dict(kw, improve=improve)}
             for name, (improve, R, kw, _) in runs.items()]
    ranks = _dist_run(tmp_path, 2, "gloo", cases)
    form = form_from_numpy(*arrays, device="cuda", dtype=torch.float32)
    for name, (improve, R, kw, launches) in runs.items():
        gen = torch.Generator(device="cuda").manual_seed(7)
        xs = restarts.suggest_batch(form, R, gen)
        full = restarts.improve_chain(
            form, xs, improve,
            **restarts.fused_setups(form, improve, dict(kw, use_fused=True)))
        cands = torch.stack([restarts.candidate(form, h)
                             for h in full.chunk(2)])
        pick = restarts.pick_across(cands[0], _Gathered(cands), "r", R)
        x1, f1, v1 = restarts.best_point(form, full)
        for rank in ranks:
            got = rank[name]
            assert got["launches"] == launches
            c = got["coords"]["r"]
            half = full[c * R // 2:(c + 1) * R // 2].cpu().numpy()
            assert np.array_equal(got["shard"], half)
            for key, want in zip(("x", "f", "v"), pick):
                assert np.array_equal(got[key], want.cpu().numpy())
            assert (violation_bucket(torch.tensor(got["v"]))
                    == violation_bucket(v1.cpu()))
            assert abs(float(got["f"]) - f1.item()) <= 1e-5 * abs(f1.item())


def test_two_nccl_ranks_on_one_card_raise(cuda, tmp_path):
    """Two NCCL ranks on cuda:0 both fail in initialize with the message,
    before any collective; no fallback to gloo."""
    from .torch_distributed_worker import finish, start_workers
    job = {"device": "cuda:0", "backend": "nccl", "timeout": 60.0,
           "cases": []}
    results = finish(start_workers(2, job, str(tmp_path)), timeout=180.0)
    for rc, _, err in results:
        assert rc != 0
        assert "one card per process" in err


# -- the tooling: the examples, the traces and the scaling script -----------

# card against CPU from the same start: float64 is determined (the card
# meets the CPU to 1e-12 on the bench form; the ADMM trace at proj_tol =
# 1e-12, since each projection's bisection stops within proj_tol and on
# boolean least squares a round-off difference moves where it stops: at
# the default 1e-6 the card parted from the CPU by 5.2e-7 in z); in
# float32 the card's eighs (cuSOLVER) are less accurate than LAPACK's,
# and on boolean least squares the histories stay within 1e-3
# (chip_smoke.py's TRACE_RTOL has the bench form's gaps)
TRACE_RTOL = {torch.float64: 1e-9, torch.float32: 1e-3}
PROJ_TOL = {torch.float64: 1e-12, torch.float32: 1e-6}
# the beamforming DCCP on the card, float32 through K4: see chip_smoke.py's
# BEAMFORMING_DCCP_VIOL (the float64 route's golden is 1e-4)
BEAMFORMING_DCCP_VIOL = 1e-3
EXAMPLE_SDR_GOLDENS = {"boolean_least_squares": 28.750, "maxcut": 57.207,
                       "circle_packing": 5.000,
                       "secondary_user_beamforming": 1.970}


@pytest.mark.parametrize("name", ["boolean_least_squares", "maxcut",
                                  "circle_packing",
                                  "secondary_user_beamforming",
                                  "scenario_serving"])
def test_example_on_the_card(cuda, name, tmp_path):
    """Each example's main() on its default device, the card in float32:
    the SDR goldens within 2e-2 with no float64 re-solve, the boolean-LS
    best of 256 within 2e-2 of 35.550, the beamforming DCCP at violation
    < BEAMFORMING_DCCP_VIOL and f <= 2.5, every (f, v) finite (scenario
    serving asserts its own feasibility and bounds)."""
    import importlib
    from qcqp_tpu_torch.solvers import sdp
    mod = importlib.import_module(f"qcqp_tpu_torch.examples.{name}")
    resolves = sdp.solve_sdr.resolves
    out = (mod.main(workdir=str(tmp_path)) if name == "scenario_serving"
           else mod.main())
    assert out["device"].startswith("cuda")
    assert out["dtype"] == "torch.float32"
    pairs = [v for k, v in out.items()
             if isinstance(v, tuple) and len(v) == 2 and k != "x_shape"]
    assert all(np.isfinite(x) for p in pairs for x in p)
    if name in EXAMPLE_SDR_GOLDENS:
        assert abs(out["sdr_bound"] - EXAMPLE_SDR_GOLDENS[name]) <= 2e-2
        assert sdp.solve_sdr.resolves == resolves
    if name == "boolean_least_squares":
        f, v = out["best_of_256"]
        assert v < 1e-2 and abs(f - 35.550) <= 2e-2
    if name == "secondary_user_beamforming":
        f, v = out["dccp"]
        assert v < BEAMFORMING_DCCP_VIOL and f <= 2.5


def _bls_forms(dtype=torch.float32):
    """The boolean-LS example's form on the card and on the CPU, and a
    numpy start."""
    from qcqp_tpu_torch.convert import form_from_numpy
    rs = np.random.RandomState(1)
    A, b = rs.randn(15, 10), rs.randn(15, 1).ravel()
    P = np.zeros((11, 10, 10))
    P[0] = A.T @ A
    P[1 + np.arange(10), np.arange(10), np.arange(10)] = 1.0
    q = np.zeros((11, 10))
    q[0] = -2.0 * A.T @ b
    r = -np.ones(11)
    r[0] = b @ b
    arrays = (P, q, r, np.ones(10, bool))
    return ({dev: form_from_numpy(*arrays, device=dev, dtype=dtype)
             for dev in ("cuda", "cpu")},
            np.random.default_rng(0).standard_normal(10))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["admm", "sdp"])
def test_trace_on_the_card_matches_the_cpu(cuda, kind, dtype):
    """admm_trace and sdp_trace on the card against the same trace on the
    CPU in the same dtype, from the same start: each history within
    TRACE_RTOL of the CPU's, relative to 1 + |CPU value|."""
    from qcqp_tpu_torch import diagnostics as dg
    forms, x0 = _bls_forms(dtype)
    run = ((lambda d: dg.admm_trace(forms[d], x0, iters=200,
                                    proj_tol=PROJ_TOL[dtype]))
           if kind == "admm" else (lambda d: dg.sdp_trace(forms[d],
                                                          iters=300)))
    card, cpu = run("cuda"), run("cpu")
    for k, v in card.items():
        assert v.is_cuda and torch.isfinite(v).all()
        gap = ((v.cpu().double() - cpu[k].double()).abs()
               / (1.0 + cpu[k].double().abs())).max()
        assert float(gap) <= TRACE_RTOL[dtype], (k, float(gap))


def test_cd_and_ccp_traces_on_the_card(cuda):
    """cd_trace and ccp_trace on the card: the properties of
    tests/test_aux.py (CD phase 1 parts from the CPU at round-off):
    violations non-increasing to within one `better` bucket, CD's final
    violation under 1e-2, the tau schedule exact."""
    from qcqp_tpu_torch import diagnostics as dg
    forms, x0 = _bls_forms()
    cd = dg.cd_trace(forms["cuda"], x0, sweeps=20)
    v = cd["violation"].cpu().numpy()
    assert cd["x"].is_cuda and v[-1] < 1e-2 and v[-1] <= v[0]
    tr = dg.ccp_trace(forms["cuda"], x0, outers=8, tau=0.01, mu=2.0)
    assert torch.equal(tr["tau"].cpu(),
                       0.01 * 2.0 ** torch.arange(8, dtype=torch.float32))
    assert (np.diff(tr["violation"].cpu().numpy()) <= 1e-4 + 1e-6).all()


def test_scaling_script_on_one_card(cuda, monkeypatch):
    """benchmarks/scaling.py on one card: a world of one NCCL rank gives a
    rate, and its restart solve's collectives are one all_gather of
    n + 3 float32 numbers."""
    from qcqp_tpu_torch.benchmarks import scaling
    for name, value in (("N", 8), ("M", 4), ("R", 64), ("SWEEPS", 2)):
        monkeypatch.setattr(scaling, name, value)
    out = scaling.collective_report(1, device="cuda")
    assert out["ranks"][0]["bytes"] == {"all_gather": (8 + 3) * 4}
    assert scaling.run(1, device="cuda")["weak"]["restarts_s"] > 0
