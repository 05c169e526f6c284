"""The five cases of tests/test_mesh2d.py for qcqp_tpu_torch's 2-D
(restarts x constraints) mesh program, over gloo process groups on the
CPU, and improve_admm_2d against the JAX package's on the same numpy
starts.

The port runs one process per device, so a mesh of 8 is 8 processes of
torch: the JAX tests' (2, 4) mesh of 8 virtual devices becomes a (2, 2)
mesh of 4 processes (a (4, 1) one for solve_restarts_2d's (4, 2)), which
still splits both axes, pads the constraints (m = 7 and 10 over 2) and
keeps the file well inside its time; the workers are started once for the
whole file."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import numpy.testing as npt

from qcqp_tpu.core import QCQPForm as JForm
from qcqp_tpu.parallel import make_mesh_2d as jmake_mesh_2d
from qcqp_tpu.parallel import improve_admm_2d as jimprove_admm_2d

from qcqp_tpu_torch import core as tcore
from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.solvers.admm import improve_admm_batch

from .torch_distributed_worker import run_workers

torch.set_num_threads(1)


def _random_arrays(n, m, seed, eq_frac=0.0):
    """tests/test_mesh2d.py:13-22."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1) - 1.0
    is_eq = rng.random(m) < eq_frac
    return [P, q, r, is_eq]


def _draw(key, R, n):
    return np.array(jax.random.normal(jax.random.PRNGKey(key), (R, n),
                                      jnp.float64))


def _port(arrays):
    return form_from_numpy(*arrays, device="cpu", dtype=torch.float64)


def _jform(arrays):
    return JForm(*(jnp.asarray(a) for a in arrays))


def _viols(arrays, xs):
    return tcore.max_violation_batch(_port(arrays), torch.from_numpy(xs)
                                     ).numpy()


def _objs(arrays, xs):
    return tcore.eval_objective_batch(_port(arrays), torch.from_numpy(xs)
                                      ).numpy()


# name: (arrays, xs, num_iters), as tests/test_mesh2d.py
CASES = {
    "quality": (_random_arrays(8, 10, 0), _draw(0, 8, 8), 200),
    "padding": (_random_arrays(6, 7, 1), _draw(1, 4, 6), 100),
    "m512": (_random_arrays(16, 512, 3), _draw(3, 4, 16), 40),
}
SOLVE = _random_arrays(6, 6, 2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    grid = [("r", 2), ("c", 2)]
    cases = [{"name": name, "kind": "admm2d", "mesh": grid, "arrays": a,
              "xs": xs, "kw": {"num_iters": it}}
             for name, (a, xs, it) in CASES.items()]
    cases += [
        {"name": "solve", "kind": "solve2d", "mesh": [("r", 4), ("c", 1)],
         "arrays": SOLVE, "R": 16, "kw": {"num_iters": 200}},
        {"name": "solve_c", "kind": "solve2d", "mesh": grid,
         "arrays": SOLVE, "R": 15, "seed": 3, "kw": {"num_iters": 200}},
        {"name": "bad_R", "kind": "admm2d", "mesh": grid,
         "arrays": _random_arrays(4, 4, 3), "xs": np.zeros((3, 4)),
         "raises": "ValueError"},
        {"name": "too_few", "kind": "make_mesh_2d", "shape": (4, 2),
         "raises": "ValueError"},
    ]
    return run_workers(4, cases, str(tmp_path_factory.mktemp("mesh2d")))


def _same(ranks, name, key="xs"):
    for r in ranks[1:]:
        npt.assert_array_equal(r[name][key], ranks[0][name][key])
    return ranks[0][name][key]


def test_mesh2d_matches_single_device_quality(ranks):
    """tests/test_mesh2d.py:25-45: quality parity per restart with the
    one-process batched ADMM (the same algorithm, another summation
    order): a feasible share no lower, objectives within 5% where both
    are feasible."""
    arrays, xs, it = CASES["quality"]
    out2d = _same(ranks, "quality")
    out1d = improve_admm_batch(_port(arrays), torch.from_numpy(xs),
                               num_iters=it).numpy()
    v2d, v1d = _viols(arrays, out2d), _viols(arrays, out1d)
    f2d, f1d = _objs(arrays, out2d), _objs(arrays, out1d)
    assert (v2d < 1e-2).mean() >= (v1d < 1e-2).mean() - 1e-9
    feas = (v2d < 1e-2) & (v1d < 1e-2)
    assert feas.any()
    npt.assert_allclose(f2d[feas], f1d[feas], rtol=0.05, atol=0.05)


def test_mesh2d_constraint_padding(ranks):
    """tests/test_mesh2d.py:48-57: m = 7 over 2 constraint ranks pads one
    trivial row; finite, and no restart's violation rises; the
    collectives each rank made."""
    arrays, xs, it = CASES["padding"]
    out = _same(ranks, "padding")
    assert out.shape == (4, 6) and np.isfinite(out).all()
    assert (_viols(arrays, out) <= _viols(arrays, xs) + 1e-6).all()
    # one all_reduce an iteration, the same count on the two constraint
    # ranks of a restart block; one all_gather over "r" for the result
    calls = {}
    for r in ranks:
        c = r["padding"]["calls"]
        assert c["all_gather"] == 1 and 0 < c["all_reduce"] <= 2 * it
        calls.setdefault(r["padding"]["coords"]["r"], set()).add(
            c["all_reduce"])
    assert all(len(v) == 1 for v in calls.values())


def test_solve_restarts_2d_end_to_end(ranks):
    """tests/test_mesh2d.py:60-67 on a (4, 1) mesh: feasible, and the
    returned objective is the objective at x; the same on every rank."""
    x, f, v = (_same(ranks, "solve", k) for k in ("x", "f", "v"))
    assert float(v) < 1e-2
    npt.assert_allclose(float(f), float(_objs(SOLVE, x[None])[0]),
                        rtol=1e-6)


def test_solve_restarts_2d_on_both_axes(ranks):
    """On a (2, 2) mesh R = 15 pads to 16; the best point is the same on
    every rank and no worse, in the (violation bucket, objective) order,
    than the best of the one-process ADMM from the same 16 starts at the
    parity tolerances above."""
    x, f, v = (_same(ranks, "solve_c", k) for k in ("x", "f", "v"))
    form = _port(SOLVE)
    xs = torch.randn((16, 6), generator=torch.Generator().manual_seed(3),
                     dtype=torch.float64)
    out = improve_admm_batch(form, xs, num_iters=200)
    from qcqp_tpu_torch.parallel.restarts import best_point
    _, f1, v1 = best_point(form, out)
    assert float(v) < 1e-2 or float(v) <= float(v1) + 1e-6
    if float(v) < 1e-2 and float(v1) < 1e-2:
        assert float(f) <= float(f1) + 0.05 * abs(float(f1)) + 0.05


def test_mesh2d_rejects_bad_restart_count(ranks):
    """tests/test_mesh2d.py:70-75: R = 3 on a restart axis of 2 raises
    ValueError, and so does a (4, 2) mesh on 4 processes."""
    for r in ranks:
        assert r["bad_R"]["raised"] == "ValueError"
        assert "not a multiple" in r["bad_R"]["message"]
        assert r["too_few"]["raised"] == "ValueError"
        assert "need 8 processes" in r["too_few"]["message"]


def test_mesh2d_large_m_512_parity(ranks):
    """tests/test_mesh2d.py:78-101: m = 512 over 2 constraint ranks,
    40 iterations: finite, no violation rises, and the violations agree
    with the one-process batched ADMM to the consensus scale."""
    arrays, xs, it = CASES["m512"]
    out2d = _same(ranks, "m512")
    out1d = improve_admm_batch(_port(arrays), torch.from_numpy(xs),
                               num_iters=it).numpy()
    v2d, v1d, v0 = (_viols(arrays, a) for a in (out2d, out1d, xs))
    assert np.isfinite(out2d).all()
    assert (v2d <= v0 + 1e-6).all()
    npt.assert_allclose(v2d, v1d, rtol=0.1, atol=5e-2)


def _jax_2d(arrays, xs, it):
    mesh = jmake_mesh_2d(2, 4)
    return np.asarray(jimprove_admm_2d(_jform(arrays), jnp.asarray(xs),
                                       mesh, num_iters=it))


@pytest.mark.parametrize("name", ["quality", "padding"])
def test_improve_admm_2d_matches_jax(ranks, name):
    """improve_admm_2d on the (2, 2) mesh against the JAX package's on its
    (2, 4) mesh from the same numpy starts.  Lane for lane to 1e-6 where
    the JAX result is determined (its lane moves by less than 1e-9 when
    its starts move by a few ulps, tests/test_torch_nlp.py's
    `_jax_spread` approach; the perturbed starts ride in the same call,
    since each lane's loop is its own); on the other lanes, quality parity
    as tests/test_mesh2d.py holds it: as many feasible as JAX's, and
    objectives within 5% where both are feasible."""
    arrays, xs, it = CASES[name]
    out = _same(ranks, name)
    R = xs.shape[0]
    xp = [xs * (1.0 + 4e-16 * np.random.default_rng(70 + s)
                .standard_normal(xs.shape)) for s in range(2)]
    runs = _jax_2d(arrays, np.concatenate([xs] + xp), it).reshape(3, R, -1)
    xj = runs[0]
    spread = np.abs(runs[1:] - xj).max(axis=(0, 2))
    held = spread < 1e-9
    assert held.any()
    npt.assert_allclose(out[held], xj[held], atol=1e-6)
    vj, vt = _viols(arrays, xj), _viols(arrays, out)
    fj, ft = _objs(arrays, xj), _objs(arrays, out)
    free = ~held
    assert (vt[free] < 1e-2).sum() >= (vj[free] < 1e-2).sum()
    both = free & (vt < 1e-2) & (vj < 1e-2)
    npt.assert_allclose(ft[both], fj[both], rtol=0.05, atol=0.05)
