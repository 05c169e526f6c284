"""Which device the port puts things on, on the CPU: core.default_device
follows the current CUDA device (faked here) and raises without a card;
a kernel wrapper refuses tensors on two cards; launch.initialize binds an
NCCL group to the rank's card; an NCCL collective refuses a payload off
it; the test launcher gives rank r the card cuda:r for device "cuda"; and
benchmarks/scaling.py's --worlds raises when the cards are too few."""

import os
import pickle
import types

import pytest
import torch

from qcqp_tpu_torch import core
from qcqp_tpu_torch.benchmarks import scaling
from qcqp_tpu_torch.kernels.onevar_kernel import _check_cuda
from qcqp_tpu_torch.parallel import launch, mesh

from . import torch_distributed_worker as worker


def _fake_cards(monkeypatch, count, current=0):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)


def test_default_device_is_the_current_card(monkeypatch):
    _fake_cards(monkeypatch, 4, current=2)
    assert core.default_device() == torch.device("cuda", 2)
    assert core.default_device("cuda:1") == torch.device("cuda", 1)
    assert core.default_device("cpu") == torch.device("cpu")


def test_default_device_on_one_card_is_cuda0(monkeypatch):
    _fake_cards(monkeypatch, 1)
    assert core.default_device() == torch.device("cuda", 0)


def test_default_device_raises_without_a_card(monkeypatch):
    _fake_cards(monkeypatch, 0)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        core.default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        core.make_form([[[1.0]]], [[0.0]], [0.0], [])
    assert core.default_device("cpu") == torch.device("cpu")


class _OnCard:
    """Stands in for a float32 CUDA tensor on cuda:<index>."""

    def __init__(self, index, shape=(2,)):
        self.is_cuda, self.dtype = True, torch.float32
        self.device, self.shape = torch.device("cuda", index), shape

    def is_contiguous(self):
        return True


def test_wrapper_check_refuses_two_cards():
    """The wrappers' common check: every tensor on the first one's card,
    else ValueError (nothing is copied over); one card passes."""
    _check_cuda("k", [_OnCard(1), _OnCard(1)], [(2,), (2,)])
    with pytest.raises(ValueError, match="cuda:1 and cuda:2"):
        _check_cuda("k", [_OnCard(1), _OnCard(2)], [(2,), (2,)])
    with pytest.raises(TypeError, match="float32 CUDA"):
        _check_cuda("k", [_OnCard(1), torch.zeros(2)], [(2,), (2,)])


def _initialize(monkeypatch, device, backend=None):
    """launch.initialize with the store, the one-card check, set_device
    and init_process_group recorded instead of run."""
    seen = {}
    monkeypatch.setattr(launch, "_bound", None)
    monkeypatch.setattr(launch.dist, "TCPStore", lambda *a, **k: "store")
    monkeypatch.setattr(launch, "_one_rank_per_device",
                        lambda *a: seen.setdefault("one_a_card", a[1]))
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.setdefault("current", d))
    monkeypatch.setattr(launch.dist, "init_process_group",
                        lambda backend, **kw: seen.update(backend=backend,
                                                          **kw))
    got = launch.initialize("127.0.0.1:1", 4, 2, device=device,
                            backend=backend)
    return got, seen


def test_initialize_binds_nccl_to_the_ranks_card(monkeypatch):
    dev, seen = _initialize(monkeypatch, "cuda:2")
    assert dev == torch.device("cuda", 2)
    assert seen["backend"] == "nccl" and seen["device_id"] == dev
    assert seen["current"] == dev and seen["one_a_card"] == dev
    assert (seen["world_size"], seen["rank"]) == (4, 2)
    assert launch.bound_device() == dev


def test_initialize_gloo_binds_nothing(monkeypatch):
    dev, seen = _initialize(monkeypatch, "cpu")
    assert dev == torch.device("cpu") and seen["backend"] == "gloo"
    assert "device_id" not in seen and "one_a_card" not in seen
    assert launch.bound_device() is None


def test_nccl_payload_must_lie_on_the_ranks_card(monkeypatch):
    """_staged hands NCCL its tensor as it is, so a payload off the card
    launch.initialize bound the communicators to raises, whatever the
    current device is."""
    monkeypatch.setattr(mesh.dist, "get_backend", lambda group: "nccl")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    monkeypatch.setattr(launch, "_bound", torch.device("cuda", 1))
    with pytest.raises(ValueError, match="this rank's card is cuda:1"):
        mesh._staged(torch.zeros(3), "group")
    monkeypatch.setattr(launch, "_bound", torch.device("cpu"))
    t = torch.zeros(3)
    buf, back = mesh._staged(t, "group")
    assert buf is t and back(buf) is t
    monkeypatch.setattr(mesh.dist, "get_backend", lambda group: "gloo")
    t = torch.zeros(3)
    buf, back = mesh._staged(t, "group")
    assert buf is t and back(buf) is t


class _Worker:
    """subprocess.Popen for the launcher: reads the job it was handed and
    writes the result file a worker writes, with the job's device."""

    def __init__(self, cmd, **kw):
        _, _, pid, job_path, outdir = cmd[-5:]
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        with open(os.path.join(outdir, f"{pid}.pkl"), "wb") as f:
            pickle.dump({"_info": {"device": job["device"],
                                   "job": os.path.basename(job_path)}}, f)
        self.returncode = 0

    def communicate(self, timeout=None):
        return "", ""

    def poll(self):
        return 0


def test_run_workers_gives_rank_r_card_r(monkeypatch, tmp_path):
    monkeypatch.setattr(worker, "subprocess",
                        types.SimpleNamespace(Popen=_Worker, PIPE=None,
                                              TimeoutExpired=TimeoutError))
    ranks = worker.run_workers(4, [], str(tmp_path / "a"), device="cuda",
                               backend="nccl")
    assert [r["_info"]["device"] for r in ranks] == [
        f"cuda:{r}" for r in range(4)]
    assert [r["_info"]["job"] for r in ranks] == [
        f"job{r}.pkl" for r in range(4)]
    ranks = worker.run_workers(2, [], str(tmp_path / "b"), device="cuda:0",
                               backend="gloo")
    assert [r["_info"]["device"] for r in ranks] == ["cuda:0", "cuda:0"]
    assert worker.rank_device("cpu", 3) == "cpu"


def test_scaling_worlds_raise_when_cards_are_short(monkeypatch):
    _fake_cards(monkeypatch, 2)
    with pytest.raises(SystemExit, match="needs 4 cards"):
        scaling.main(["--worlds", "1,2,4"])
    assert scaling._worlds("2,1", "cuda") == [1, 2]
    assert scaling._worlds(None, "cuda") == [1, 2]       # as before: silent
    _fake_cards(monkeypatch, 4)
    assert scaling._worlds("1,2,4", "cuda") == [1, 2, 4]
    _fake_cards(monkeypatch, 0)
    with pytest.raises(SystemExit, match="--device cpu"):
        scaling.main(["--worlds", "1"])
    assert scaling._worlds("1,2,4", "cpu") == [1, 2, 4]
