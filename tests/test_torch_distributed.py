"""qcqp_tpu_torch's multi-process runtime (parallel/launch.py), the port of
tests/test_distributed.py: real localhost processes join a gloo process
group on the CPU through launch.initialize (by arguments, and under
torchrun from its environment variables), build the global mesh and run
solve_restarts_distributed; the best point must agree bit for bit across
processes and match a one-process run of the same program.  Also: a rank
that fails fails the run inside its timeout, with its error on stderr;
the NCCL one-card-per-process check; the arguments initialize refuses."""

import datetime
import threading

import numpy as np
import numpy.testing as npt
import pytest
import torch
import torch.distributed as dist

from qcqp_tpu_torch.parallel import launch

from .torch_distributed_worker import (finish, free_port, run_workers,
                                       start_workers)


def _form_arrays():
    """tests/distributed_worker.py:28-38: boolean least squares, n = 8."""
    rs = np.random.RandomState(1)
    A, b = rs.randn(12, 8), rs.randn(12)
    P = np.zeros((9, 8, 8))
    P[0] = A.T @ A
    P[1 + np.arange(8), np.arange(8), np.arange(8)] = 1.0
    q = np.zeros((9, 8))
    q[0] = -2.0 * A.T @ b
    r = -np.ones(9)
    r[0] = b @ b
    return [P, q, r, np.ones(8, bool)]


CASE = {"name": "solve", "kind": "distributed", "arrays": _form_arrays(),
        "R": 64, "seed": 0, "kw": {"num_iters": 50}}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return run_workers(2, [CASE], str(tmp_path_factory.mktemp("two")))


@pytest.fixture(scope="module")
def one(tmp_path_factory):
    return run_workers(1, [CASE], str(tmp_path_factory.mktemp("one")))


def test_two_process_matches_single_process(two, one):
    """tests/test_distributed.py:66-80: the replicated best point agrees
    across processes bit for bit, is feasible, and equals the one-process
    run's to 1e-10."""
    a, b = (r["solve"] for r in two)
    assert [r["_info"]["pid"] for r in two] == [0, 1]
    assert a["world"] == b["world"] == 2
    assert a["coordinator"] and not b["coordinator"]
    for k in ("x", "f", "v"):
        npt.assert_array_equal(a[k], b[k])
    assert a["v"] < 1e-2
    solo = one[0]["solve"]
    assert solo["world"] == 1 and solo["coordinator"]
    npt.assert_allclose(solo["x"], a["x"], atol=1e-10)
    assert float(solo["f"]) == pytest.approx(float(a["f"]), abs=1e-10)


def test_each_process_solves_its_block(two):
    """Each process ran the chain on its contiguous half of the 64
    restarts, and no worker imported jax."""
    for rank in two:
        assert rank["solve"]["shard"].shape == (32, 8)
        assert rank["_info"]["device"] == "cpu"
        assert not rank["_info"]["jax_imported"]
    assert not np.array_equal(two[0]["solve"]["shard"],
                              two[1]["solve"]["shard"])


def test_torchrun_environment(tmp_path, two):
    """Under torchrun initialize() reads MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK and LOCAL_RANK (the agent serves the store): the
    same best point as the explicit launch."""
    ranks = run_workers(2, [CASE], str(tmp_path), torchrun=True)
    for rank in ranks:
        for k in ("x", "f", "v"):
            npt.assert_array_equal(rank["solve"][k], two[0]["solve"][k])
    assert [r["_info"]["coordinator"] for r in ranks] == [True, False]


def test_a_failing_rank_fails_the_run(tmp_path):
    """Rank 1 raises before the collective that rank 0 waits in: both
    exit non-zero inside the timeout, rank 1's error on its stderr."""
    bad = dict(CASE, fail_on=1)
    job = {"device": "cpu", "backend": None, "timeout": 30.0,
           "cases": [bad]}
    results = finish(start_workers(2, job, str(tmp_path)), timeout=120.0)
    assert results[1][0] != 0
    assert "rank 1 fails on purpose" in results[1][2]
    assert results[0][0] != 0
    assert "[killed after" not in results[0][2]


def test_initialize_refuses_what_it_cannot_do(monkeypatch):
    """A process drives one device (local_device_count other than 1
    raises), and without a card it names no default device."""
    with pytest.raises(ValueError, match="one device"):
        launch.initialize("127.0.0.1:1", 1, 0, local_device_count=2,
                          device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        launch.initialize("127.0.0.1:1", 1, 0)
    assert not launch.is_initialized() and launch.is_coordinator()


@pytest.mark.parametrize("shared", [True, False])
def test_nccl_ranks_on_one_card_raise(monkeypatch, shared):
    """The check initialize makes before an NCCL group: two ranks that
    report the same card both raise (NCCL would refuse them); two cards
    pass.  Run on two threads against one store, the card names faked."""
    monkeypatch.setattr(launch, "_device_id",
                        lambda d: "host card" if shared else f"host {d}")
    port = free_port()
    errors = [None, None]

    def rank(r):
        store = dist.TCPStore("127.0.0.1", port, 2, is_master=r == 0,
                              timeout=datetime.timedelta(seconds=30))
        try:
            launch._one_rank_per_device(store, f"cuda:{r}", 2, r)
        except RuntimeError as e:
            errors[r] = str(e)
    threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    if shared:
        assert all(e and "one card per process" in e and "gloo" in e
                   for e in errors)
    else:
        assert errors == [None, None]
