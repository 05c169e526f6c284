"""The mesh cases of tests/test_parallel.py for qcqp_tpu_torch, over gloo
process groups on the CPU: restarts sharded over 2 and 4 processes against
the one-process solve and against the JAX package's solve_restarts on its
8 virtual devices from the same numpy draw, the padding edges, K1, K3 and
K4 run per rank (their plain versions on CPU tensors), the cross-rank best
point (ties to the lowest global restart index, a NaN violation last),
admm_phase1_sharded, and the scenarios over a mesh, solve_scenarios_sharded
against the JAX package's.

The workers are tests/torch_distributed_worker.py, started once per world
size for the whole file (module fixture), each with a process-group
timeout and a wall-clock timeout."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import numpy.testing as npt
from jax.sharding import Mesh as JMesh

import qcqp_tpu as jqt
from qcqp_tpu.parallel import restarts as jrestarts
from qcqp_tpu.parallel import scenarios as jscen
from qcqp_tpu.parallel.mesh import admm_phase1_sharded as jadmm_sharded

import qcqp_tpu_torch as tqt
from qcqp_tpu_torch import core as tcore
from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.kernels.projection import precompute_eigh
from qcqp_tpu_torch.parallel import Mesh, make_mesh, make_mesh_2d
from qcqp_tpu_torch.parallel import restarts as trestarts
from qcqp_tpu_torch.parallel import scenarios as tscen
from qcqp_tpu_torch.solvers.admm import admm_phase1

from .test_cd import boolean_ls_form
from .torch_distributed_worker import run_workers

torch.set_num_threads(1)

R_SHARD = 32                      # tests/test_parallel.py:229
PAD_RS = (1, 7, 130)              # tests/test_parallel.py:187
S_SCEN, R_SCEN = 4, 16


def _arrays(jform, dtype=np.float64):
    return [np.asarray(a).astype(dtype) if np.asarray(a).dtype != bool
            else np.asarray(a) for a in jform]


def _port(arrays):
    dtype = torch.float32 if arrays[0].dtype == np.float32 else torch.float64
    return form_from_numpy(*arrays, device="cpu", dtype=dtype)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _admm_form():
    """tests/test_parallel.py:254-262."""
    n = 4
    x = jqt.Variable(n)
    prob = jqt.Problem(jqt.Minimize(jqt.sum_squares(x)),
                       [jqt.sum_squares(x) <= 1,
                        jqt.sum_squares(x - np.full(n, 0.5)) <= 1,
                        jqt.square(x) <= 4])
    return jqt.canonicalize(prob)[0]


def _tie_arrays(n=4):
    """min ||x||^2 s.t. x_i^2 <= 1: x and -x tie bit for bit."""
    P = np.zeros((n + 1, n, n))
    P[0] = np.eye(n)
    for i in range(n):
        P[1 + i, i, i] = 1.0
    r = -np.ones(n + 1)
    r[0] = 0.0
    return [P, np.zeros((n + 1, n)), r, np.zeros(n, bool)]


def _tie_starts(first, R=16):
    """Infeasible rows (|x_i| > 1) but for a feasible pair x and -x at
    global indices 3 (block 0 of 2) and 12 (block 1); `first` is the sign
    of the one at index 3."""
    rng = np.random.default_rng(0)
    xs = np.sign(rng.standard_normal((R, 4))) * (1.5 + rng.random((R, 4)))
    x = np.array([0.5, -0.2, 0.1, 0.3])
    xs[3], xs[12] = first * x, -first * x
    return xs


def _nan_starts(R=16):
    xs = _tie_starts(1.0, R)
    xs[12] = 3.0
    xs[0] = np.nan                 # block 0: its violation is NaN
    xs[10] = [0.1, 0.2, -0.1, 0.0]  # block 1: the only feasible row
    return xs


def _jax_draw(jform, R, key):
    return np.asarray(jrestarts.suggest_batch(jform, R, key))


def _scenario_forms():
    return [boolean_ls_form(n=6, m=8, seed=s)[0] for s in range(S_SCEN)]


def _scenario_starts():
    """The JAX solve_scenarios_sharded draw (qcqp_tpu/parallel/
    scenarios.py:110-116): one key a scenario."""
    keys = jax.random.split(jax.random.PRNGKey(0), S_SCEN)
    return np.stack([_jax_draw(f, R_SCEN, k)
                     for f, k in zip(_scenario_forms(), keys)])


def _cases(nproc):
    bls = _arrays(boolean_ls_form(n=6, m=9, seed=4)[0])
    cases = [
        {"name": "sharded", "kind": "restarts", "arrays": bls, "R": R_SHARD,
         "seed": 1},
        {"name": "from_jax", "kind": "restarts", "arrays": bls,
         "R": R_SHARD, "starts": _jax_draw(boolean_ls_form(6, 9, 4)[0],
                                           R_SHARD, jax.random.PRNGKey(1))},
        {"name": "admm_phase1", "kind": "admm_phase1", "axis": "c",
         "arrays": _arrays(_admm_form()), "x0": np.full(4, 3.0),
         "kw": {"num_iters": 300}},
    ]
    f32 = _arrays(boolean_ls_form(n=8, m=12, seed=3)[0], np.float32)
    if nproc == 2:
        cases += [
            {"name": "fused_cd_admm", "kind": "restarts", "arrays": f32,
             "dtype": "float32", "R": 128, "fused_cpu": True,
             "kw": {"improve": [tqt.COORD_DESCENT, tqt.ADMM],
                    "num_iters": 10}},
            {"name": "fused_dccp", "kind": "restarts", "arrays": f32,
             "dtype": "float32", "R": 128, "fused_cpu": True,
             "kw": {"improve": tqt.DCCP, "max_iter": 3}},
            {"name": "tie_plus", "kind": "restarts", "arrays": _tie_arrays(),
             "R": 16, "starts": _tie_starts(1.0), "kw": {"improve": []}},
            {"name": "tie_minus", "kind": "restarts",
             "arrays": _tie_arrays(), "R": 16, "starts": _tie_starts(-1.0),
             "kw": {"improve": []}},
            {"name": "nan", "kind": "restarts", "arrays": _tie_arrays(),
             "R": 16, "starts": _nan_starts(), "kw": {"improve": []}},
        ]
        for R in (10, 1):
            cases.append({"name": f"scen_mesh_{R}", "kind": "scenarios",
                          "arrays": _arrays(jscen.stack_forms(
                              _scenario_forms()[:3])),
                          "R": R, "seed": 2, "kw": {"num_iters": 20}})
    else:
        pad = _arrays(boolean_ls_form(n=6, m=9, seed=7)[0], np.float32)
        eq_idx = tuple(int(i) for i in np.nonzero(pad[3])[0])
        for R in PAD_RS:
            cases.append({"name": f"pad_{R}", "kind": "restarts",
                          "arrays": pad, "dtype": "float32", "R": R,
                          "seed": R, "fused_cpu": True,
                          "kw": {"eq_idx": eq_idx, "num_iters": 5}})
        stack = _arrays(jscen.stack_forms(_scenario_forms()))
        grid = [("s", 2), ("r", 2)]
        cases += [
            {"name": "scen_sharded_jax", "kind": "scenarios_sharded",
             "arrays": stack, "mesh": grid, "starts": _scenario_starts(),
             "kw": {"num_iters": 100}},
            {"name": "scen_sharded", "kind": "scenarios_sharded",
             "arrays": stack, "mesh": grid, "R": 7, "seed": 4,
             "kw": {"num_iters": 20}},
            {"name": "scen_sharded_bad_s", "kind": "scenarios_sharded",
             "arrays": _arrays(jscen.stack_forms(_scenario_forms()[:3])),
             "mesh": grid, "R": 4, "raises": "ValueError"},
        ]
    return cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return {nproc: run_workers(nproc, _cases(nproc),
                               str(tmp_path_factory.mktemp(f"w{nproc}")))
            for nproc in (2, 4)}


def _same_on_every_rank(ranks, name, keys=("x", "f", "v")):
    for r in ranks[1:]:
        for k in keys:
            npt.assert_array_equal(r[name][k], ranks[0][name][k])
    return ranks[0][name]


@pytest.mark.parametrize("nproc", [2, 4])
def test_workers_join_and_import_no_jax(runs, nproc):
    infos = [r["_info"] for r in runs[nproc]]
    assert [i["pid"] for i in infos] == list(range(nproc))
    assert all(i["world"] == nproc for i in infos)
    assert [i["coordinator"] for i in infos] == [True] + [False] * (nproc - 1)
    assert not any(i["jax_imported"] for i in infos)


@pytest.mark.parametrize("nproc", [2, 4])
def test_sharded_matches_unsharded(runs, nproc):
    """tests/test_parallel.py:228-235: the same generator seed, 32 restarts
    sharded over the ranks against the one-process solve, x and f to
    1e-10; each rank's block of the improved batch equals those rows of
    the one-process chain."""
    got = _same_on_every_rank(runs[nproc], "sharded")
    form = _port(_arrays(boolean_ls_form(n=6, m=9, seed=4)[0]))
    x, f, v = trestarts.solve_restarts(form, R_SHARD, _gen(1))
    npt.assert_allclose(got["x"], x.numpy(), atol=1e-10)
    assert float(got["f"]) == pytest.approx(float(f), abs=1e-10)
    xs = trestarts.improve_chain(form, trestarts.suggest_batch(
        form, R_SHARD, _gen(1)), tqt.COORD_DESCENT)
    for rank in runs[nproc]:
        c = rank["sharded"]["coords"]["r"]
        blk = R_SHARD // nproc
        npt.assert_allclose(rank["sharded"]["shard"],
                            xs[c * blk:(c + 1) * blk].numpy(), atol=1e-10)


@pytest.mark.parametrize("nproc", [2, 4])
def test_from_jax_draw_matches_jax_mesh(runs, nproc):
    """The port sharded over nproc processes from the JAX package's numpy
    draw against the JAX package's solve_restarts(mesh=make_mesh()) on its
    8 virtual devices: the same chain, so the best objective to 1e-9
    relative (tests/test_torch_api.py's tolerance for this chain) and the
    best point to 1e-8."""
    got = _same_on_every_rank(runs[nproc], "from_jax")
    jform = boolean_ls_form(n=6, m=9, seed=4)[0]
    xj, fj, vj = jrestarts.solve_restarts(jform, R_SHARD,
                                          jax.random.PRNGKey(1),
                                          mesh=jrestarts.make_mesh())
    npt.assert_allclose(float(got["f"]), float(fj), rtol=1e-9)
    npt.assert_allclose(float(got["v"]), float(vj), atol=1e-9)
    npt.assert_allclose(got["x"], np.asarray(xj), atol=1e-8)


@pytest.mark.parametrize("nproc", [2, 4])
def test_admm_phase1_sharded_matches(runs, nproc):
    """tests/test_parallel.py:254-271: the constraint-sharded feasibility
    ADMM (m = 3 padded to a multiple of the ranks) against the port's
    admm_phase1 and against the JAX package's admm_phase1_sharded on its
    8 virtual devices, from the same x0, to 1e-6; feasible."""
    z = _same_on_every_rank(runs[nproc], "admm_phase1", ("z",))["z"]
    jform = _admm_form()
    form = _port(_arrays(jform))
    x0 = torch.full((4,), 3.0, dtype=torch.float64)
    z_ref = admm_phase1(form, precompute_eigh(form), x0[None], 1e-2, 300)[0]
    assert float(tcore.max_violation(form, torch.from_numpy(z))) < 1e-2
    npt.assert_allclose(z, z_ref.numpy(), atol=1e-6)
    zj = jadmm_sharded(jform, jnp.full(4, 3.0), jrestarts.make_mesh(axis="c"),
                       num_iters=300)
    npt.assert_allclose(z, np.asarray(zj), atol=1e-6)


@pytest.mark.parametrize("R", PAD_RS)
def test_padding_edges(runs, monkeypatch, R):
    """tests/test_parallel.py:179-192 at 4 ranks, K1's route (its plain
    version): R pads to a multiple of 4 (a rank may hold padded restarts
    only); the best point is finite and equals the one-process best of the
    same padded draw to 1e-6."""
    got = _same_on_every_rank(runs[4], f"pad_{R}")
    assert got["x"].shape == (6,) and np.isfinite(got["x"]).all()
    assert np.isfinite(got["f"])
    monkeypatch.setattr(trestarts, "_fused_default", lambda form: True)
    arrays = _arrays(boolean_ls_form(n=6, m=9, seed=7)[0], np.float32)
    form = _port(arrays)
    eq_idx = tuple(int(i) for i in np.nonzero(arrays[3])[0])
    x, f, v = trestarts.solve_restarts(form, -(-R // 4) * 4, _gen(R),
                                       eq_idx=eq_idx, num_iters=5)
    npt.assert_allclose(got["x"], x.numpy(), atol=1e-6)
    npt.assert_allclose(got["f"], f.numpy(), rtol=1e-6)
    assert all(r[f"pad_{R}"]["calls"]["k1"] == 1 for r in runs[4])


@pytest.mark.parametrize("case,kernels", [
    ("fused_cd_admm", {"k1": 1, "k3": 2, "k4": 0}),
    ("fused_dccp", {"k1": 0, "k3": 0, "k4": 1})])
def test_kernels_run_per_rank(runs, monkeypatch, case, kernels):
    """tests/test_parallel.py:90-146: with the kernels' route taken (as on
    a CUDA float32 form; patched on here, so the wrappers run their plain
    versions), each rank calls K1 once, K3 twice (its two phases) and K4
    once on its block, and the best point equals the one-process solve's
    (K4 is lockstep over tiles of 64 lanes: 64 lanes a rank keep its
    tiles)."""
    got = _same_on_every_rank(runs[2], case)
    for rank in runs[2]:
        assert rank[case]["calls"] == kernels
    monkeypatch.setattr(trestarts, "_fused_default", lambda form: True)
    form = _port(_arrays(boolean_ls_form(n=8, m=12, seed=3)[0], np.float32))
    kw = ({"improve": [tqt.COORD_DESCENT, tqt.ADMM], "num_iters": 10}
          if case == "fused_cd_admm" else {"improve": tqt.DCCP,
                                           "max_iter": 3})
    x, f, v = trestarts.solve_restarts(form, 128, _gen(0), **kw)
    npt.assert_allclose(got["x"], x.numpy(), atol=1e-6)
    npt.assert_allclose(got["f"], f.numpy(), rtol=1e-6)
    npt.assert_allclose(got["v"], v.numpy(), atol=1e-6)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_cross_rank_tie_goes_to_lowest_index(runs, sign):
    """x and -x tie bit for bit in (bucket, f) at global indices 3 (rank
    0) and 12 (rank 1): the winner is the one at index 3, as best_point
    over the whole batch returns."""
    name = "tie_plus" if sign > 0 else "tie_minus"
    got = _same_on_every_rank(runs[2], name)
    xs = _tie_starts(sign)
    npt.assert_array_equal(got["x"], xs[3])
    form = _port(_tie_arrays())
    x, f, v = trestarts.best_point(form, torch.from_numpy(xs))
    npt.assert_array_equal(got["x"], x.numpy())
    assert got["f"] == f.item() and got["v"] == v.item() == 0.0


def test_nan_violation_ranks_last_across_ranks(runs):
    """A NaN start on rank 0 (its violation NaN, bucket last): the winner
    is rank 1's feasible row, as best_point over the whole batch."""
    got = _same_on_every_rank(runs[2], "nan")
    xs = _nan_starts()
    npt.assert_array_equal(got["x"], xs[10])
    x, f, v = trestarts.best_point(_port(_tie_arrays()), torch.from_numpy(xs))
    npt.assert_array_equal(got["x"], x.numpy())
    assert np.isfinite(got["f"]) and got["v"] == 0.0


@pytest.mark.parametrize("R", [10, 1])
def test_solve_scenarios_over_a_mesh(runs, R):
    """solve_scenarios(mesh=...) shards each scenario's restarts over 2
    ranks in contiguous blocks, without padding (R = 1 leaves rank 1's
    block empty): equal to the one-process solve_scenarios to 1e-10."""
    got = _same_on_every_rank(runs[2], f"scen_mesh_{R}")
    stack = tscen.stack_forms([_port(_arrays(f))
                               for f in _scenario_forms()[:3]])
    xs, fs, vs = tscen.solve_scenarios(stack, R, _gen(2), num_iters=20)
    npt.assert_allclose(got["x"], xs.numpy(), atol=1e-10)
    npt.assert_allclose(got["f"], fs.numpy(), atol=1e-10)
    npt.assert_allclose(got["v"], vs.numpy(), atol=1e-10)


def test_solve_scenarios_sharded_matches_jax(runs):
    """solve_scenarios_sharded on an (s = 2, r = 2) mesh of 4 ranks from
    the JAX package's draw against its solve_scenarios_sharded on 4 of its
    virtual devices: each scenario's best objective to 1e-8 relative and
    violation to 1e-8 (tests/test_torch_scenarios.py's tolerance)."""
    got = _same_on_every_rank(runs[4], "scen_sharded_jax")
    jforms = _scenario_forms()
    jmesh = JMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("s", "r"))
    xj, fj, vj = (np.asarray(a) for a in jscen.solve_scenarios_sharded(
        jscen.stack_forms(jforms), R_SCEN, jax.random.PRNGKey(0), jmesh,
        num_iters=100))
    assert got["x"].shape == (S_SCEN, 6)
    npt.assert_allclose(got["f"], fj, rtol=1e-8)
    npt.assert_allclose(got["v"], vj, rtol=0, atol=1e-8)
    npt.assert_allclose(got["x"], xj, atol=1e-6)


def test_solve_scenarios_sharded_own_draw(runs):
    """With the port's own draw: R = 7 pads to 8 over r = 2, and every
    rank returns all 4 scenarios, equal to the one-process solve_scenarios
    of 8 restarts from the same seed to 1e-10."""
    got = _same_on_every_rank(runs[4], "scen_sharded")
    stack = tscen.stack_forms([_port(_arrays(f)) for f in _scenario_forms()])
    xs, fs, vs = tscen.solve_scenarios(stack, 8, _gen(4), num_iters=20)
    npt.assert_allclose(got["x"], xs.numpy(), atol=1e-10)
    npt.assert_allclose(got["f"], fs.numpy(), atol=1e-10)
    npt.assert_allclose(got["v"], vs.numpy(), atol=1e-10)


def test_solve_scenarios_sharded_rejects_ragged_s(runs):
    """S = 3 on an s axis of 2 raises ValueError on every rank."""
    for rank in runs[4]:
        assert rank["scen_sharded_bad_s"]["raised"] == "ValueError"
        assert "not a multiple" in rank["scen_sharded_bad_s"]["message"]


def test_mesh_without_a_process_group():
    """Without a process group a mesh is this process alone: make_mesh()
    has one rank, solve_restarts over it equals the solve without it bit
    for bit, and a mesh larger than the world raises ValueError."""
    mesh = make_mesh()
    assert mesh.size == 1 and dict(mesh.shape) == {"r": 1}
    form = _port(_arrays(boolean_ls_form(n=6, m=9, seed=4)[0]))
    a = trestarts.solve_restarts(form, 8, _gen(3), num_iters=5)
    b = trestarts.solve_restarts(form, 8, _gen(3), num_iters=5, mesh=mesh)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    with pytest.raises(ValueError, match="need 2 processes"):
        make_mesh_2d(2, 1)
    with pytest.raises(ValueError, match="need 2 processes"):
        Mesh([("s", 1), ("r", 2)])
    with pytest.raises(ValueError, match="distinct ranks"):
        Mesh([("r", 1)], ranks=[0, 0])
