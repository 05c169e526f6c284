"""BENCHMARK.json against the benchmark's contract, and every cell against
the files it names."""

import json
import os
import re

import pytest

from portbench.harness import spec

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32
    for path in BENCH["paths"]:
        assert os.path.isdir(os.path.join(spec.ROOT, path))
        assert not path.startswith("/") and ".." not in path
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in METRICS]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.fullmatch(name), name
    for m in METRICS:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[kind]}) == len(BENCH[kind])
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    texts = [e["why"] for e in BENCH["configs"] + BENCH["workloads"]]
    texts += [c["source"] for c in BENCH["configs"]]
    texts += [m["layer"] for m in BENCH["per_layer"]]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_cells_and_metrics_agree():
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(CELLS) // 4)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(CELLS)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in METRICS:
        for w in m.get("workloads", []):
            assert w in CELLS
    for name in CELLS:
        ends = {m["name"] for m in spec.metrics_of(BENCH, "end_to_end",
                                                   name)}
        assert "setup_s" in ends and len(ends) >= 2
        layers = spec.metrics_of(BENCH, "per_layer", name)
        assert layers
        for m in layers:
            assert m["moves"] in ends, (name, m["name"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = spec.Cell(name, BENCH)
    P, q, r, is_eq = cell.problem()
    n, m = cell.config["n"], cell.config["m"]
    assert P.shape == (m + 1, n, n) and q.shape == (m + 1, n)
    assert r.shape == (m + 1,) and is_eq.shape == (m,)
    assert int(is_eq.sum()) == cell.config["equalities"]
    assert (P == P.transpose(0, 2, 1)).all()
    assert cell.reference().improve
    assert cell.suggest_reference().draw
    for m_ in cell.end_to_end:
        assert spec.load("end_to_end", m_["name"]).read
    for m_ in cell.per_layer:
        assert spec.load("layer_metrics", m_["name"]).read
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    with open(os.path.join(spec.BENCH_DIR, "limits", f"{name}.json")) as f:
        assert "readings" in json.load(f)


def test_a_mix_without_its_reference_stops_the_run():
    """A suggest or an improve that reference/ has no file for raises a
    LookupError naming the file, before the run's set-up."""
    cell = spec.Cell(CELLS[0], BENCH)
    for key, path in (("suggest", "suggest_sdr.py"), ("improve", "ipopt.py")):
        cell.mix = dict(cell.mix, **{key: path[:-3].split("_")[-1]})
        getter = (cell.suggest_reference if key == "suggest"
                  else cell.reference)
        with pytest.raises(LookupError, match=path):
            getter()
        cell = spec.Cell(CELLS[0], BENCH)


def test_the_instance_is_the_configurations():
    """bench.py's instance: seed 0's dense form (22 equalities)."""
    for name in CELLS:
        cell = spec.Cell(name, BENCH)
        a, b = cell.problem(), cell.problem()
        assert all((x == y).all() for x, y in zip(a, b))
    rng = __import__("numpy").random.default_rng(0)
    A = rng.standard_normal((51, 100, 100)) / 10.0
    dense = spec.Cell("dense100.cd-r10240", BENCH).problem()
    assert (dense[0] == 0.5 * (A + A.transpose(0, 2, 1))).all()


def test_bounds_follow_the_rule_of_five():
    """Every bound but setup_s's is at least 1% (the rule never goes
    under it); setup_s's is the ceiling, 0.25."""
    for m in BENCH["end_to_end"]:
        assert m["bound"] >= 0.01
        if m["name"] == "setup_s":
            assert m["bound"] == 0.25
