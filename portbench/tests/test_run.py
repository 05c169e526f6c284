"""The command line: no card, no result; the last line's shape; and on a
card (marked `gpu`) a short run of the real command, and the control of
`correct` at each cell's own size."""

import json
import os
import subprocess
import sys

import pytest

from portbench import run
from portbench.harness import spec

RUN = [sys.executable, os.path.join(spec.BENCH_DIR, "run.py")]


def test_no_card_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(RUN + ["--workload", "dense100.cd-r10240", "--seed",
                                "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.ROOT,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and portbench/, the run
    fails and prints nothing."""
    import shutil
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    script = ("import sys; sys.path.insert(0, '.');"
              "from portbench import run;"
              "r = run.measure('dense100.cd-r10240', 1, 0.2, False,"
              " device='cpu', hooks=['portbench.tests.hooks:tiny'])")
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, cwd=tmp_path,
                         env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "qcqp_tpu_torch" in out.stderr


def _shape(r, cell, traced, chips):
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert isinstance(r["correct"], bool)
    c = spec.Cell(cell)
    names = {m["name"] for m in (c.per_layer if traced else c.end_to_end)}
    assert set(r["metrics"]) <= names
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert r["device"]["count"] == chips
    if traced:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(r["breakdown"]["device_ops"]) <= 10
        assert len(r["breakdown"]["idle_gaps"]) <= 10
    for check in r["checks"].values():
        assert set(check) == {"value", "limit"}


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_shape_on_the_cpu(traced):
    r = run.measure("dense100.cd-r10240", 3, 0.3, traced, device="cpu",
                    hooks=["portbench.tests.hooks:tiny"])
    assert set(r["metrics"]) == ({"device_idle_pct"} if traced else
                                 {"restarts_per_s", "solve_ms_p95",
                                  "setup_s"})
    json.loads(json.dumps(run._clean(r)))
    _shape(r, "dense100.cd-r10240", traced, 1)


@pytest.mark.gpu
def test_a_short_run_on_the_card(card):
    out = subprocess.run(RUN + ["--workload", "dense100.cd-r10240", "--seed",
                                "2147483659", "--seconds", "2",
                                "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.ROOT,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.splitlines()[-1])
    assert r["correct"] is True
    assert set(r["metrics"]) == {"restarts_per_s", "solve_ms_p95",
                                 "setup_s"}
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert r["device"]["memory_peak_bytes"] > 0


# the seeds the limits' upper readings were read on (limits/<cell>.json)
CONTROL_SEEDS = {"dense100.cd-r10240": (3300000101, 3300000102, 3300000103),
                 "dense100.dccp-r10240": (3300000121, 3300000122,
                                          3300000123),
                 "dense100.cd-r40960-x4": (3400000201, 3400000202,
                                           3400000203)}


@pytest.mark.gpu
@pytest.mark.parametrize("cell,seed", [(c, s) for c, seeds in
                                       CONTROL_SEEDS.items() for s in seeds])
def test_the_control_is_not_correct(card, cell, seed):
    """The control (hooks.control: the reference with TF32 on in the
    program's place) at the cell's own size, one solve in the window,
    judged by the harness's own comparison: not correct.  Its readings
    are printed (pytest -s)."""
    import torch
    if spec.Cell(cell).chips > torch.cuda.device_count():
        pytest.skip(f"{cell} needs {spec.Cell(cell).chips} cards")
    r = run.measure(cell, seed, 0.0, False,
                    hooks=["portbench.tests.hooks:control"])
    print(json.dumps({"control": cell, "seed": seed,
                      "readings": run._clean(r["readings"]),
                      "checks": run._clean(r["checks"])}), flush=True)
    assert r["correct"] is False, r["checks"]
