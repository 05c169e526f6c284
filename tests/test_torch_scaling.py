"""qcqp_tpu_torch.benchmarks.scaling on the CPU: gloo ranks in worker
processes of the script itself (each with a process-group timeout; the
launcher kills what is left).  The collective inventory of a sharded
restart solve is exactly one all_gather of n + 3 float64 numbers a rank;
the 2-D ADMM's is one all_reduce of the rank's (R / nr, n) consensus
sums an iteration over "c" and one all_gather of its (R / nr, n) result
over "r"; the timed run gives finite weak and strong rates, and the
study their efficiencies; without a card the script refuses to run
unless it is told --device cpu."""

import numpy as np
import pytest
import torch

from qcqp_tpu_torch.benchmarks import scaling

@pytest.fixture
def small(monkeypatch):
    """The script's SCALE_N, SCALE_M, SCALE_R and SCALE_SWEEPS, cut."""
    for name, value in (("N", 8), ("M", 4), ("R", 16), ("SWEEPS", 2)):
        monkeypatch.setattr(scaling, name, value)


def test_collective_report_is_one_all_gather(small, capsys):
    out = scaling.collective_report(2, device="cpu")
    want = {"all_gather": (8 + 3) * 8}
    assert [r["calls"] for r in out["ranks"]] == [{"all_gather": 1}] * 2
    assert [r["bytes"] for r in out["ranks"]] == [want] * 2
    assert out["total_bytes"] == 2 * 88
    assert "restarts communicate only in the best-point reduction" in \
        capsys.readouterr().out


def test_collective_report_2d_bytes_per_iteration():
    out = scaling.collective_report_2d(m_big=12, nr=1, nc=2, device="cpu")
    block = 8 * 16 * 8                      # (R / nr, n) float64
    for r in out["ranks"]:
        t = r["iterations"]
        assert t > 0
        assert r["calls"] == {"all_reduce": t, "all_gather": 1}
        assert r["bytes"] == {"all_reduce": t * block, "all_gather": block}
        assert r["all_reduces_per_iteration"] == 1.0
        assert r["bytes_per_all_reduce"] == block
    assert [r["coords"] for r in out["ranks"]] == [{"r": 0, "c": 0},
                                                   {"r": 0, "c": 1}]


def test_run_gives_a_rate(small):
    out = scaling.run(2, device="cpu")
    for kind in ("weak", "strong"):
        rate = out[kind]["restarts_s"]
        assert out[kind]["R"] == 32 and np.isfinite(rate) and rate > 0


def test_no_card_no_silent_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        scaling.main([])


def test_study_weak_and_strong(small, capsys):
    """The study on gloo ranks at the cut size: per world the weak batch
    grows with the ranks and the strong one stays at R times the largest
    world, the first world's efficiencies are 1, the all_gather's share
    is a fraction, and every world's collective inventory is checked and
    printed."""
    rows = {row["world"]: row for row in scaling.study([1, 2], "cpu")}
    assert [rows[w]["weak"]["R"] for w in (1, 2)] == [16, 32]
    assert [rows[w]["strong"]["R"] for w in (1, 2)] == [32, 32]
    assert rows[1]["weak"]["efficiency"] == rows[1]["strong"]["efficiency"] \
        == 1.0
    for row in rows.values():
        assert 0 < row["all_gather_share"] and np.isfinite(
            row["weak"]["efficiency"])
        assert [r["bytes"] for r in row["ranks"]] == [
            {"all_gather": (8 + 3) * 8}] * row["world"]
    out = capsys.readouterr().out
    assert "1 ranks: weak R=16" in out and "2 ranks: weak R=32" in out
    assert "collectives of the 2-rank restart pipeline" in out
