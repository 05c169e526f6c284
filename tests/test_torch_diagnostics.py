"""qcqp_tpu_torch.diagnostics against qcqp_tpu.diagnostics on the CPU, in
float64, from the same numpy inputs on the recipes of
tests/test_aux.py:44-70 and 130-145; the port's copies of those four
tests; `timed` writing into `results`; `torch_profile` writing a trace
of a CPU solve that parses.

Each history is held to the JAX package's at 1e-6 relative (|a - b| <=
1e-6 (1 + |b|)) where the trace is determined.  One is not: ADMM from the
zero start of test_aux.py's recipe.  Each projection's multiplier
bisection stops within proj_tol (default 1e-6), and from that start a
round-off difference moves where it stops, so the two packages part by
up to about proj_tol there.  That recipe is held at proj_tol=1e-12
(where they meet to 1e-11), and the default proj_tol from a random
start (where they meet to 1e-13).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qcqp_tpu import core as jcore
from qcqp_tpu import diagnostics as jd

from qcqp_tpu_torch import diagnostics as td
from qcqp_tpu_torch.convert import form_from_numpy

from .test_cd import boolean_ls_form

torch.set_num_threads(1)
RTOL = 1e-6


def _port(form):
    return form_from_numpy(*(np.asarray(a) for a in form), device="cpu",
                           dtype=torch.float64)


def _assert_history(t, j, keys):
    for k in keys:
        a, b = t[k].numpy(), np.asarray(j[k])
        assert a.shape == b.shape, k
        gap = float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))
        assert gap <= RTOL, (k, gap)


def test_cd_trace_matches_jax():
    form, _, _ = boolean_ls_form(n=6, m=9, seed=2)
    x0 = np.random.default_rng(0).standard_normal(6)
    j = jd.cd_trace(form, jnp.asarray(x0), sweeps=20)
    t = td.cd_trace(_port(form), x0, sweeps=20)
    _assert_history(t, j, ("x", "objective", "violation"))


@pytest.mark.parametrize("start,proj_tol", [("zeros", 1e-12),
                                            ("random", 1e-6)])
def test_admm_trace_matches_jax(start, proj_tol):
    form, _, _ = boolean_ls_form(n=5, m=7, seed=3)
    x0 = (np.zeros(5) if start == "zeros"
          else np.random.default_rng(0).standard_normal(5))
    j = jd.admm_trace(form, jnp.asarray(x0), iters=50, proj_tol=proj_tol)
    t = td.admm_trace(_port(form), x0, iters=50, proj_tol=proj_tol)
    _assert_history(t, j, ("z", "z_residual", "violation", "objective"))


def test_ccp_trace_matches_jax():
    rng = np.random.default_rng(1)
    form = jcore.random_form(rng, n=5, m=3, eq_frac=0.5)
    x0 = rng.standard_normal(5)
    j = jd.ccp_trace(form, jnp.asarray(x0), outers=8, tau=0.01, mu=2.0)
    t = td.ccp_trace(_port(form), x0, outers=8, tau=0.01, mu=2.0)
    _assert_history(t, j, ("x", "tau", "objective", "violation"))


def test_sdp_trace_matches_jax():
    form, _, _ = boolean_ls_form(n=6, m=9, seed=4)
    j = jd.sdp_trace(form, iters=300)
    t = td.sdp_trace(_port(form), iters=300)
    _assert_history(t, j, ("X", "primal_residual", "objective"))


# the port's copies of tests/test_aux.py's four trace tests

def test_cd_trace_monotone_violation():
    form, _, _ = boolean_ls_form(n=6, m=9, seed=2)
    rng = np.random.default_rng(0)
    out = td.cd_trace(_port(form), rng.standard_normal(6), sweeps=20)
    v = out["violation"].numpy()
    assert v[-1] < 1e-2
    assert v[-1] <= v[0] + 1e-12


def test_admm_trace_shapes():
    form, _, _ = boolean_ls_form(n=5, m=7, seed=3)
    out = td.admm_trace(_port(form), torch.zeros(5, dtype=torch.float64),
                        iters=50)
    assert out["violation"].shape == (50,)
    assert torch.isfinite(out["objective"]).all()


def test_sdp_trace_residual_decreases():
    form, _, _ = boolean_ls_form(n=6, m=9, seed=4)
    out = td.sdp_trace(_port(form), iters=1500)
    rp = out["primal_residual"].numpy()
    assert rp[-1] < 1e-4
    assert rp[-1] < rp[10]


def test_ccp_trace_shapes_and_tau_schedule():
    rng = np.random.default_rng(1)
    form = jcore.random_form(rng, n=5, m=3, eq_frac=0.5)
    x0 = rng.standard_normal(5)
    tr = td.ccp_trace(_port(form), x0, outers=8, tau=0.01, mu=2.0)
    assert tr["tau"].shape == (8,)
    np.testing.assert_allclose(tr["tau"].numpy(),
                               0.01 * 2.0 ** np.arange(8), rtol=1e-6)
    # each step folds through `better` (bucketized at 1e-4): violations
    # never increase beyond one bucket
    v = tr["violation"].numpy()
    assert (np.diff(v) <= 1e-4 + 1e-9).all()


def test_traces_stay_on_the_form():
    """Each trace returns tensors on the form's device, in its dtype, from
    a numpy start."""
    form, _, _ = boolean_ls_form(n=5, m=7, seed=3)
    f32 = form_from_numpy(*(np.asarray(a) for a in form), device="cpu",
                          dtype=torch.float32)
    x0 = np.random.default_rng(0).standard_normal(5)
    for out in (td.cd_trace(f32, x0, sweeps=2),
                td.admm_trace(f32, x0, iters=3),
                td.ccp_trace(f32, x0, outers=2, inner_iters=3),
                td.sdp_trace(f32, iters=3)):
        for v in out.values():
            assert v.dtype == torch.float32 and v.device.type == "cpu"


def test_timed_writes_results_or_prints(capsys):
    results = {}
    with td.timed("solve", results):
        torch.ones(100).sum()
    assert set(results) == {"solve"} and results["solve"] >= 0.0
    with td.timed("print"):
        pass
    assert capsys.readouterr().out.startswith("[qcqp_tpu_torch] print: ")


def test_torch_profile_writes_a_trace(tmp_path):
    """A trace of a CPU solve that parses, with the solve's operators."""
    import qcqp_tpu_torch as tqt
    form, _, _ = boolean_ls_form(n=5, m=7, seed=3)
    logdir = str(tmp_path / "prof")
    with td.torch_profile(logdir) as prof:
        tqt.solve_restarts(_port(form), 4, torch.Generator().manual_seed(0),
                           num_iters=2)
    assert prof.trace_path == os.path.join(logdir, "trace.json")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
