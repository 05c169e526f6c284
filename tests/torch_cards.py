"""The distributed path on four ranks, one a device: the cases the ranks
run (tests/torch_distributed_worker.py) and what the parent process holds
them against.  tests/test_torch_gpu_cards.py runs them as NCCL ranks, one
a card, at the bench's sizes (FULL); tests/test_torch_cards_cpu.py runs
the same cases and checks as gloo ranks on the CPU at small sizes
(SMALL), so that the control flow is rehearsed without a card.

The parent computes every reference on its own device (cuda:0, or the
CPU) from the same seeds:
  * restarts (CD through K1, ADMM through K3, DCCP through K4, and an SDR
    suggest broadcast from the first rank): each rank's improved block
    equals the same rows of the one-process chain bit for bit (K1's and
    K3's lanes are independent, and each rank's K4 block is whole 64-lane
    tiles); the best point is the exact pick over the four blocks'
    candidates, and within BEST_F_RTOL of the one-process f with the same
    violation bucket;
  * scenarios from one float64 bank, each rank loading its own block, on
    (s = 4, r = 1) and (s = 2, r = 2) meshes: every lane equal to the
    one-process solve_scenarios from the same starts, each scenario's
    best the exact pick, its f within BEST_F_RTOL of the one-process f
    relative to the size of the objective's terms;
  * the 2-D ADMM on a (2, 2) mesh against improve_admm_2d on a mesh of
    one (tests/test_torch_mesh2d.py:114-117 and tests/test_mesh2d.py:
    100-101: NCCL's ring sums in another order than one process), on the
    bench form, where no lane becomes feasible in 50 iterations, and on
    tests/test_mesh2d.py's inequality form at the bench's widths, where
    most do;
  * every rank's form, built without device=, and every collective's
    payload lie on the rank's own device.

This module imports neither JAX nor the JAX package.
"""

from typing import NamedTuple

import numpy as np
import torch

from qcqp_tpu_torch import settings as s
from qcqp_tpu_torch.benchmarks.cd_routes import bench_form

# The best point's f is an (R, n) x (n, n) cuBLAS product whose rows'
# rounding depends on R; the cross-rank pick is exact over the ranks' own
# values, and against the one-process best it holds to this (chip_smoke.py).
BEST_F_RTOL = 1e-5
WORLD = 4


class Sizes(NamedTuple):
    n: int              # the bench form's size
    m: int
    sweeps: int         # CD sweeps
    cd: int             # restarts of each improve, over all ranks
    admm: int
    admm_iters: int
    dccp: int           # a multiple of 4 x 64: whole K4 tiles a rank
    dccp_kw: dict
    sdr: int
    S: int              # scenarios in the bank, R_scen restarts each
    R_scen: int
    R_2d: int
    iters_2d: int


# bench.py's form and the one-card CD shape (10,240 a rank); the
# serving bank (S = 132, R = 64, instance s from seed s)
FULL = Sizes(n=100, m=50, sweeps=10, cd=40960, admm=4096, admm_iters=50,
             dccp=512, dccp_kw={}, sdr=256, S=132, R_scen=64, R_2d=1024,
             iters_2d=50)
SMALL = Sizes(n=8, m=6, sweeps=5, cd=64, admm=64, admm_iters=20, dccp=256,
              dccp_kw={"max_iter": 3}, sdr=32, S=8, R_scen=8, R_2d=16,
              iters_2d=30)

# each restart-sharded solve's kernel calls (and, on a card, launches) a
# rank
LAUNCHES = {"cd": {"k1": 1, "k3": 0, "k4": 0},
            "admm": {"k1": 0, "k3": 2, "k4": 0},
            "dccp": {"k1": 0, "k3": 0, "k4": 1},
            "sdr": {"k1": 1, "k3": 0, "k4": 0}}
SEEDS = {"cd": 1, "admm": 2, "dccp": 3, "sdr": 4, "scen_41": 5,
         "scen_22": 5, "solve2d": 6}
SCEN_MESHES = {"scen_41": [("s", 4), ("r", 1)],
               "scen_22": [("s", 2), ("r", 2)]}
MESH_2D = [("r", 2), ("c", 2)]
FORMS_2D = ("bench", "ineq")


def bls_arrays():
    """Boolean least squares, n = 10 (examples/boolean_least_squares.py's
    data, seed 1): minimize ||A x - b||^2 s.t. x_i^2 == 1, canonicalized
    by the port on the CPU in float64."""
    import qcqp_tpu_torch as qt
    from qcqp_tpu_torch.expressions import canonicalize
    rs = np.random.RandomState(1)
    A, b = rs.randn(15, 10), rs.randn(15, 1).ravel()
    x = qt.Variable(10)
    prob = qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                      [qt.square(x) == 1])
    form = canonicalize(prob, np.float64, "cpu")[0]
    return tuple(t.numpy() for t in form)


def ineq_form(n, m, seed=0):
    """tests/test_mesh2d.py:13-22 with no equalities: inequalities whose
    r is shifted by -1, so that a consensus reaches feasible points."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1) - 1.0
    return P, q, r, np.zeros(m, bool)


def form_2d(which, sz):
    return (bench_form if which == "bench" else ineq_form)(sz.n, sz.m)


def chains(sz):
    """name: (arrays, improve, R, kwargs) of the restart-sharded solves."""
    bench = bench_form(sz.n, sz.m)
    return {"cd": (bench, s.COORD_DESCENT, sz.cd, {"num_iters": sz.sweeps}),
            "admm": (bench, s.ADMM, sz.admm, {"num_iters": sz.admm_iters}),
            "dccp": (bench, s.DCCP, sz.dccp, dict(sz.dccp_kw)),
            "sdr": (bls_arrays(), s.COORD_DESCENT, sz.sdr,
                    {"suggest": s.SDR, "num_iters": sz.sweeps})}


def write_bank(sz, path):
    """The scenario bank: S bench forms, instance i from seed i, float64."""
    from qcqp_tpu_torch import native
    forms = [bench_form(sz.n, sz.m, seed=i) for i in range(sz.S)]
    native.bank_write(path, *(np.stack(a) for a in zip(*forms)))
    return path


def form32(arrays, device):
    from qcqp_tpu_torch.convert import form_from_numpy
    return form_from_numpy(*arrays, device=device, dtype=torch.float32)


def gen(seed, device):
    return torch.Generator(device=device).manual_seed(seed)


def draw_2d(sz, device):
    """The starts solve_restarts_2d draws (seed SEEDS["solve2d"]), which
    the improve_admm_2d case takes as given."""
    from qcqp_tpu_torch.parallel.restarts import suggest_batch
    form = form32(bench_form(sz.n, sz.m), device)
    return suggest_batch(form, sz.R_2d, gen(SEEDS["solve2d"], device))


def cases(sz, bank, device):
    """Every case of the run, in the order every rank runs them; `device`
    is the parent's, on which the 2-D starts are drawn."""
    out = [{"name": name, "kind": "restarts", "arrays": arrays,
            "dtype": "float32", "R": R, "seed": SEEDS[name],
            "default_device": True, "fused_cpu": device.type == "cpu",
            "kw": dict(kw, improve=improve)}
           for name, (arrays, improve, R, kw) in chains(sz).items()]
    out += [{"name": name, "kind": "scenarios_bank", "mesh": grid,
             "bank": bank, "S": sz.S, "R": sz.R_scen, "seed": SEEDS[name],
             "fused_cpu": device.type == "cpu",
             "kw": {"num_iters": sz.sweeps}}
            for name, grid in SCEN_MESHES.items()]
    xs = draw_2d(sz, device).cpu().numpy()
    out += [{"name": f"admm2d_{which}", "kind": "admm2d", "mesh": MESH_2D,
             "arrays": form_2d(which, sz), "dtype": "float32",
             "default_device": True, "xs": xs,
             "kw": {"num_iters": sz.iters_2d}} for which in FORMS_2D]
    out += [{"name": "solve2d", "kind": "solve2d", "mesh": MESH_2D,
             "arrays": bench_form(sz.n, sz.m), "dtype": "float32",
             "R": sz.R_2d, "seed": SEEDS["solve2d"],
             "kw": {"num_iters": sz.iters_2d}}]
    return out


def run(sz, tmpdir, device, backend, timeout):
    """Write the bank, run every case on WORLD ranks (on a card rank r on
    cuda:r), and return (each rank's results, the bank's path)."""
    import os
    from .torch_distributed_worker import run_workers
    bank = write_bank(sz, os.path.join(tmpdir, "bank.qb"))
    ranks = run_workers(WORLD, cases(sz, bank, device),
                        os.path.join(tmpdir, "ranks"), timeout=timeout,
                        device=device.type,
                        backend=backend, pg_timeout=240.0)
    return ranks, bank


def check_workers(ranks, device):
    """WORLD ranks, rank r on its own device, none of them importing JAX."""
    infos = [r["_info"] for r in ranks]
    assert [i["pid"] for i in infos] == list(range(WORLD))
    assert all(i["world"] == WORLD for i in infos)
    assert [i["device"] for i in infos] == [own_device(r, device)
                                            for r in range(WORLD)]
    assert not any(i["jax_imported"] for i in infos)


# ------------------------------------------------------------------ checks

def equal(a, b):
    """Bit for bit (NaN included), numpy or torch, on any device."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else b
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


def own_device(rank, device):
    """The device rank `rank` works on when the parent works on `device`:
    on cards cuda:<rank>, else the CPU."""
    from .torch_distributed_worker import rank_device
    return rank_device(device.type, rank)


class _Gathered:
    """The blocks' candidates stacked in one process: what pick_across's
    all_gather returns on the ranks."""

    def __init__(self, parts):
        self.parts = parts

    def all_gather(self, t, axis):
        return self.parts


def pick_of_blocks(form, full, parts):
    """The best point of `full` (R, n) as the ranks pick it: one candidate
    a contiguous block, then pick_across's exact pick."""
    from qcqp_tpu_torch.parallel.restarts import candidate, pick_across
    cands = torch.stack([candidate(form, b) for b in full.chunk(parts)])
    return pick_across(cands[0], _Gathered(cands), "r", full.shape[0])


def one_process_chain(form, R, seed, improve, kw):
    """solve_restarts without a mesh on the form's device, through the
    kernels' route: (the improve chain's output (R, n), the best point)."""
    from qcqp_tpu_torch.parallel import restarts
    seen, real = [], restarts.improve_chain

    def chain(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]
    restarts.improve_chain = chain
    try:
        best = restarts.solve_restarts(form, R, gen(seed, form.device),
                                       improve=improve, use_fused=True, **kw)
    finally:
        restarts.improve_chain = real
    return seen[0], best


def check_restarts(ranks, name, sz, device):
    """A restart-sharded solve (module docstring), its kernel calls a rank
    and its collectives: one all_gather of n + 3 numbers (and for the SDR
    one broadcast of the sampler, 1 + n + n^2 float64 numbers)."""
    from qcqp_tpu_torch.core import violation_bucket
    arrays, improve, R, kw = chains(sz)[name]
    form = form32(arrays, device)
    full, (x1, f1, v1) = one_process_chain(form, R, SEEDS[name], improve, kw)
    pick = pick_of_blocks(form, full, WORLD)
    blocks = full.chunk(WORLD)
    n = form.n
    calls, nbytes = {"all_gather": 1}, {"all_gather": (n + 3) * 4}
    if kw.get("suggest") == s.SDR:
        calls["broadcast"], nbytes["broadcast"] = 1, (1 + n + n * n) * 8
    for rank, res in enumerate(ranks):
        got = res[name]
        assert got["coords"] == {"r": rank}
        assert equal(got["shard"], blocks[rank]), (name, rank)
        for key, want in zip(("x", "f", "v"), pick):
            assert equal(got[key], want), (name, rank, key)
        assert bool(violation_bucket(torch.tensor(got["v"]))
                    == violation_bucket(v1.cpu()))
        assert abs(float(got["f"]) - f1.item()) <= BEST_F_RTOL * abs(
            f1.item()), (name, float(got["f"]), f1.item())
        assert got["launches" if device.type == "cuda" else "calls"] \
            == LAUNCHES[name]
        assert got["mesh_calls"] == calls and got["mesh_bytes"] == nbytes
        here = own_device(rank, device)
        assert got["form_device"] == here
        assert got["payload_devices"] == [here]


def one_process_scenarios(sz, bank, device):
    """solve_scenarios of the whole bank on `device`, through K1's stacked
    route: (the stack, the improved lanes (S, R, n), the best points)."""
    from qcqp_tpu_torch.parallel import scenarios
    stacked = scenarios.forms_from_bank(bank, device=device,
                                        dtype=torch.float32)
    seen, real = [], scenarios._improve_from_starts

    def improve(*a, **k):
        seen.append(real(*a, **k))
        return seen[-1]
    scenarios._improve_from_starts = improve
    try:
        best = scenarios.solve_scenarios(
            stacked, sz.R_scen, gen(SEEDS["scen_41"], device),
            num_iters=sz.sweeps, use_fused=True)
    finally:
        scenarios._improve_from_starts = real
    return stacked, seen[0], best


def objective_terms(stacked, xs):
    """|x' P0 x| + |q0' x| + |r0| of each scenario's point xs (S, n): the
    size of the terms each objective sums."""
    P0, q0, r0 = stacked.P[:, 0], stacked.q[:, 0], stacked.r[:, 0]
    return (torch.einsum("si,sij,sj->s", xs, P0, xs).abs()
            + torch.einsum("si,si->s", q0, xs).abs() + r0.abs())


def check_scenarios(ranks, name, sz, stacked, full, best, device):
    """A scenario-sharded solve from one bank (module docstring)."""
    from qcqp_tpu_torch.core import violation_bucket
    from qcqp_tpu_torch.parallel.mesh import block
    from qcqp_tpu_torch.parallel.restarts import candidate, pick_across
    from qcqp_tpu_torch.parallel.scenarios import scenario
    grid = dict(SCEN_MESHES[name])
    s_size, r_size = grid["s"], grid["r"]
    S, R, n = full.shape
    cands = torch.stack([
        torch.stack([candidate(scenario(stacked, i), full[i, lo:hi])
                     for i in range(S)])
        for lo, hi in (block(R, r_size, c) for c in range(r_size))])
    pick = pick_across(cands[0], _Gathered(cands), "r", R)
    if r_size == 1:                  # one block a scenario: its best point
        assert all(equal(a, b) for a, b in zip(pick, best))
    scale = objective_terms(stacked, best[0]).cpu().numpy()
    batch = S // s_size
    for rank, res in enumerate(ranks):
        got = res[name]
        cs, cr = got["coords"]["s"], got["coords"]["r"]
        assert rank == cs * r_size + cr
        assert got["scenarios"] == [cs * batch, (cs + 1) * batch]
        lo, hi = block(R, r_size, cr)
        assert equal(got["block"], full[cs * batch:(cs + 1) * batch, lo:hi])
        for key, want in zip(("x", "f", "v"), pick):
            assert equal(got[key], want), (name, rank, key)
        assert bool((violation_bucket(torch.from_numpy(got["v"]))
                     == violation_bucket(best[2].cpu())).all())
        # f against one card's, to BEST_F_RTOL of the size of the
        # objective's terms at one card's best x: a block-sized product
        # rounds f by a few ulps of those terms, which is no bound
        # relative to f where they cancel (scenario 118 on the card:
        # f = -1.05e-4 from terms of 1.44, the same lane's f 9.5e-7 apart
        # in the 32- and 64-row products)
        f1 = best[1].cpu().numpy()
        off = np.nonzero(np.abs(got["f"] - f1) > BEST_F_RTOL * scale)[0]
        assert not len(off), [
            (int(i), float(got["f"][i]), float(f1[i]), float(scale[i]),
             equal(got["x"][i], best[0][int(i)]))
            for i in off[:8]]
        assert got["launches" if device.type == "cuda" else "calls"] \
            == {"k1": 1, "k3": 0, "k4": 0}
        # the best points over r (batch candidates of n + 3), then every
        # scenario's over s (batch rows of n + 2)
        assert got["mesh_calls"] == {"all_gather": 2}
        assert got["mesh_bytes"] == {"all_gather":
                                     batch * (2 * n + 5) * 4}
        here = own_device(rank, device)
        assert got["form_device"] == here
        assert got["payload_devices"] == [here]


# Float32 sums in another order can send a lane of the nonconvex ADMM to
# another point, feasible or not: 2 of the inequality form's 1,024 lanes
# on four NCCL cards (f 0.42 apart at most), and 2 of its 891 lanes
# feasible in both as four gloo ranks on the CPU (f 0.27 and 0.89 apart),
# at R_2d = 1,024 of FULL.  A consensus that drops or doubles one rank's
# sum moves nearly every lane (check_2d).  So f holds on all but this
# share of the lanes.
PARTED = 0.01


def check_2d(ranks, which, sz, device):
    """The (2, 2) 2-D ADMM of FORMS_2D's `which`: the same batch on every
    rank; against improve_admm_2d on a mesh of one from the same starts a
    feasible share no lower; f within 5% (rtol 0.05, atol 0.05) on the
    lanes feasible in both and on all lanes, but for PARTED of either;
    and each restart's violation within the consensus scale (rtol 0.1,
    atol 5e-2).  The inequality form must have lanes feasible in both.
    (Four gloo ranks on the CPU at the bench's sizes, R = 256: f 0.146 and
    0.072 apart at most on the two forms, and 0.0043 and 0.0006 at the
    99th percentile; with one rank's consensus sum dropped or doubled,
    20-31 apart at the 99th percentile, the inequality form's feasible
    share 0.)  For the bench form also solve_restarts_2d's best point,
    the exact pick over the two restart blocks of that batch."""
    from qcqp_tpu_torch.core import eval_objective_batch, max_violation_batch
    from qcqp_tpu_torch.parallel import mesh2d
    name = f"admm2d_{which}"
    out2d = ranks[0][name]["xs"]
    for rank, res in enumerate(ranks):
        assert equal(res[name]["xs"], out2d)
        here = own_device(rank, device)
        assert res[name]["form_device"] == here
        assert res[name]["payload_devices"] == [here]
        calls = res[name]["calls"]
        assert calls["all_gather"] == 1 and calls["all_reduce"] > 0
    form = form32(form_2d(which, sz), device)
    xs = draw_2d(sz, device)
    ref = mesh2d.improve_admm_2d(form, xs, mesh2d.make_mesh_2d(1, 1),
                                 num_iters=sz.iters_2d)
    got = torch.from_numpy(out2d).to(device)
    v2d, v1d = (max_violation_batch(form, o).cpu().numpy()
                for o in (got, ref))
    f2d, f1d = (eval_objective_batch(form, o).cpu().numpy()
                for o in (got, ref))
    feas = (v2d < 1e-2) & (v1d < 1e-2)
    parted = np.abs(f2d - f1d) > 0.05 + 0.05 * np.abs(f1d)
    readings = {"feasible_share_2d": float((v2d < 1e-2).mean()),
                "feasible_share_1": float((v1d < 1e-2).mean()),
                "both_feasible": int(feas.sum()),
                "f_parted": int(parted.sum()),
                "f_parted_feasible": int((parted & feas).sum()),
                "max_abs_f_gap": float(np.abs(f2d - f1d).max()),
                "max_abs_viol_gap": float(np.abs(v2d - v1d).max())}
    assert (v2d < 1e-2).mean() >= (v1d < 1e-2).mean(), readings
    if which == "ineq":
        assert feas.any(), readings
    assert (parted & feas).sum() <= PARTED * feas.sum(), readings
    assert parted.mean() <= PARTED, readings
    np.testing.assert_allclose(v2d, v1d, rtol=0.1, atol=5e-2)
    if which == "bench":
        pick = pick_of_blocks(form, got, 2)
        for res in ranks:
            for key, want in zip(("x", "f", "v"), pick):
                assert equal(res["solve2d"][key], want), key
    return readings
