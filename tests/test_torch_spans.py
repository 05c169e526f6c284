"""The program's named spans (qcqp_tpu_torch.diagnostics.span) on the CPU:
which spans a traced solve writes and how they nest, that a span costs no
record_function op where no profiler records, that the answers are the
same bits with the profiler on and off, and the benchmark's reader of
those spans (portbench/layer_metrics/driver_idle_ms_per_solve.py) on
hand-made runs."""

import json

import numpy as np
import pytest
import torch

from portbench.layer_metrics import driver_idle_ms_per_solve as idle_metric
from qcqp_tpu_torch import diagnostics
from qcqp_tpu_torch.core import make_form
from qcqp_tpu_torch.parallel.restarts import make_mesh, solve_restarts
from qcqp_tpu_torch.parallel.scenarios import solve_scenarios, stack_forms

torch.set_num_threads(1)


def _form(seed=0, n=6, m=4):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    q = rng.standard_normal((m + 1, n))
    r = -np.abs(rng.standard_normal(m + 1)) - 1.0
    is_eq = np.arange(m) < 1
    return make_form(P, q, r, is_eq, device="cpu", dtype=torch.float64)


# (improve, kwargs, mesh, the spans in the order they open)
CASES = {
    "cd": ("coord-descent", {"num_iters": 3}, False,
           ["qcqp.solve_restarts", "qcqp.suggest",
            "qcqp.improve.coord-descent", "qcqp.best"]),
    "cd-k1": ("coord-descent", {"num_iters": 3, "use_fused": True}, False,
              ["qcqp.solve_restarts", "qcqp.suggest",
               "qcqp.improve.coord-descent", "qcqp.k1.host", "qcqp.best"]),
    "dccp-fused": ("dccp", {"use_fused": True, "max_iter": 3}, False,
                   ["qcqp.solve_restarts", "qcqp.setup", "qcqp.suggest",
                    "qcqp.improve.dccp", "qcqp.best"]),
    "cd-mesh": ("coord-descent", {"num_iters": 3}, True,
                ["qcqp.solve_restarts", "qcqp.suggest",
                 "qcqp.improve.coord-descent", "qcqp.best",
                 "qcqp.gather"]),
}


def _solve(case, seed=1):
    improve, kwargs, mesh, _ = CASES[case]
    return solve_restarts(_form(), 16, torch.Generator().manual_seed(seed),
                          improve=improve,
                          mesh=make_mesh() if mesh else None, **kwargs)


def _spans(path):
    """The trace's spans of the program, [(name, start, end)] by start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("qcqp.")),
                  key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("case", list(CASES))
def test_a_traced_solve_writes_its_spans(case, tmp_path):
    with diagnostics.torch_profile(str(tmp_path)) as prof:
        _solve(case)
    spans = _spans(prof.trace_path)
    assert [s[0] for s in spans] == CASES[case][3]
    top = spans[0]
    assert all(_inside(s, top) for s in spans[1:])
    if case == "cd-k1":
        improve, k1 = spans[2], spans[3]
        assert _inside(k1, improve)


def test_a_traced_scenario_solve_writes_its_spans(tmp_path):
    stacked = stack_forms([_form(0), _form(1)])
    with diagnostics.torch_profile(str(tmp_path)) as prof:
        solve_scenarios(stacked, 8, torch.Generator().manual_seed(2),
                        num_iters=3, use_fused=True)
    spans = _spans(prof.trace_path)
    assert [s[0] for s in spans] == [
        "qcqp.solve_scenarios", "qcqp.suggest", "qcqp.improve.coord-descent",
        "qcqp.k1.host", "qcqp.best", "qcqp.best"]
    assert all(_inside(s, spans[0]) for s in spans[1:])
    assert _inside(spans[3], spans[2])


def test_no_profiler_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) was called")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = diagnostics.span("qcqp.a"), diagnostics.span("qcqp.b")
    assert a is b
    with a:
        with b:
            pass


def test_a_running_profiler_records_the_span(monkeypatch, tmp_path):
    names = []
    real = torch.profiler.record_function

    def spy(name):
        names.append(name)
        return real(name)
    monkeypatch.setattr(torch.profiler, "record_function", spy)
    with diagnostics.torch_profile(str(tmp_path)):
        with diagnostics.span("qcqp.a"):
            pass
    assert names == ["qcqp.a"]


@pytest.mark.parametrize("case", list(CASES))
def test_the_answers_are_the_same_bits_traced(case, tmp_path):
    plain = _solve(case)
    with diagnostics.torch_profile(str(tmp_path)):
        traced = _solve(case)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def _rank(idle, solves=10, launches=None):
    return {"solves": solves,
            "trace": {"window_s": 30.0, "busy_s": 29.0,
                      "launches": ({"cd_sweep_kernel": [0.04] * solves}
                                   if launches is None else launches),
                      "idle": idle}}


def _run(*ranks):
    return {"ranks": list(ranks), "traced": True}


def test_the_reader_sums_only_the_program_spans():
    r = _rank([["qcqp.k1.host/cudaMemcpyAsync", 0.5],
               ["portbench.solve/cudaStreamSynchronize", 0.3],
               ["qcqp.solve_restarts", 0.25],
               ["portbench.read/qcqp.best", 0.2],
               ["host", 0.1]])
    assert idle_metric.read(_run(r)) == pytest.approx(1e3 * 0.75 / 10)


def test_the_reader_divides_by_the_solves():
    idle = [["qcqp.setup/cudaMemcpyAsync", 0.6]]
    assert idle_metric.read(_run(_rank(idle, solves=6))) == pytest.approx(
        100.0)
    assert idle_metric.read(_run(_rank(idle, solves=3))) == pytest.approx(
        200.0)


def test_the_reader_takes_the_idlest_rank():
    ranks = [_rank([["qcqp.suggest/aten::cat", s]]) for s in
             (0.1, 0.4, 0.2, 0.0)]
    assert idle_metric.read(_run(*ranks)) == pytest.approx(40.0)
    assert idle_metric.read(_run(_rank([]))) == 0.0


def test_the_reader_finds_nothing_without_launches():
    busy = _rank([["qcqp.best", 0.3]])
    empty = _rank([["qcqp.best", 0.3]], launches={})
    assert idle_metric.read(_run(empty)) is None
    assert idle_metric.read(_run(busy, empty)) is None


def test_the_reader_finds_nothing_in_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(diagnostics, "span")
    assert idle_metric.read(_run(_rank([["qcqp.best", 0.3]]))) is None
