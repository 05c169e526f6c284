"""Multi-process runtime: the torch.distributed bootstrap and the global mesh
(JAX counterpart: qcqp_tpu/parallel/launch.py).

The reference is single-process (SURVEY.md section 2c; the closest marker
is the author's `# TODO: parallel` at qcqp/qcqp.py:234).  The port runs
one process per device: each calls `initialize(...)`, which binds it to
its device and joins the process group; `global_mesh()` is then the 1-D
mesh over every process, and every process runs the same
`solve_restarts(..., mesh=...)` with identical arguments, so that each
solves its block of the restarts and all of them return the same best
point (parallel/restarts.py).

The backend follows the device unless the caller names it: NCCL for CUDA,
gloo for the CPU.  An NCCL group binds its communicators to the rank's
card (`device_id`), which is also the process' current CUDA device, so
that a form built without device= lands on it (core.default_device).
NCCL cannot run two ranks on one card; `initialize` checks that no two
NCCL ranks share a device before it joins the group and raises if they
do, without falling back to gloo (gloo can: each rank computes on the
card and the collectives go through host memory, parallel/mesh.py).  A
process-group timeout bounds every collective, so a rank that dies
cannot hang the others for ever.

Typical use, one command per process (the JAX package runs one per host):

    # process 0                              # process 1
    dev = initialize("10.0.0.1:8476", 2, 0)  dev = initialize(..., 2, 1)
    form = form_from_numpy(*arrays, device=dev)
    x, f, v = solve_restarts_distributed(
        form, 10**5, torch.Generator(device=dev).manual_seed(0))
    if is_coordinator(): report(f, v)
    shutdown()

or under torchrun, which sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK
and LOCAL_RANK: `initialize()` with no arguments reads them.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh
from .restarts import make_mesh, solve_restarts

# the card this process' NCCL communicators are bound to (initialize)
_bound: Optional[torch.device] = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_count: Optional[int] = None, *,
               device=None, backend: Optional[str] = None,
               timeout: float = 600.0) -> torch.device:
    """Join the process group as one process of a multi-process run, and
    return this process' device.

    coordinator_address: "host:port" of process 0 (every process passes
        the same; process 0 serves it).  Default: MASTER_ADDR:MASTER_PORT.
    num_processes, process_id: default WORLD_SIZE and RANK.
    local_device_count: the JAX package's count of virtual CPU devices a
        process exposes.  A process of the port has one device: None or 1,
        anything else raises ValueError.
    device: this process' device.  Default: cuda:<LOCAL_RANK mod the
        card count> (LOCAL_RANK defaults to process_id); without a card
        this raises, and a CPU run passes device="cpu".
    backend: "nccl" or "gloo"; default NCCL on CUDA, gloo on the CPU.
    timeout: seconds any collective may wait for the other ranks.
    """
    if local_device_count not in (None, 1):
        raise ValueError(
            f"local_device_count={local_device_count}: a qcqp_tpu_torch "
            "process drives one device; start one process per device")
    env = os.environ
    if coordinator_address is None:
        coordinator_address = (f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                               f"{env['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("qcqp_tpu_torch: no CUDA device is available; "
                               "pass device=\"cpu\" to run on the CPU")
        local = int(env.get("LOCAL_RANK", process_id))
        device = f"cuda:{local % torch.cuda.device_count()}"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    host, port = coordinator_address.rsplit(":", 1)
    wait = datetime.timedelta(seconds=timeout)
    # under torchrun the agent serves the store at MASTER_PORT
    serve = (process_id == 0
             and env.get("TORCHELASTIC_USE_AGENT_STORE") != "True")
    store = dist.TCPStore(host, int(port), num_processes, is_master=serve,
                          timeout=wait)
    bind = {}
    if backend == "nccl":
        _one_rank_per_device(store, device, num_processes, process_id)
        # the communicators bind to this rank's card, not the current one
        bind["device_id"] = device
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=wait, **bind)
    global _bound
    _bound = bind.get("device_id")
    return device


def bound_device() -> Optional[torch.device]:
    """The card this process' NCCL communicators are bound to, or None
    (no NCCL group joined through initialize)."""
    return _bound


def _device_id(device: torch.device) -> str:
    """The host and the physical card (its UUID where torch reports one,
    which CUDA_VISIBLE_DEVICES does not renumber)."""
    props = torch.cuda.get_device_properties(device)
    card = getattr(props, "uuid", None) or f"index {device.index}"
    return f"{socket.gethostname()} {card}"


def _one_rank_per_device(store, device, world, rank):
    """Raise on every rank if two NCCL ranks would share a card: NCCL
    refuses them ("Duplicate GPU detected") at its first collective."""
    mine = _device_id(device)
    store.set(f"qcqp_device/{rank}", mine)
    ids = [store.get(f"qcqp_device/{r}").decode() for r in range(world)]
    store.set(f"qcqp_device_read/{rank}", "1")
    if rank == 0:          # keep the store up until every rank has read
        store.wait([f"qcqp_device_read/{r}" for r in range(world)])
    shared = [r for r in range(world) if r != rank and ids[r] == mine]
    if shared:
        raise RuntimeError(
            f"backend=\"nccl\" needs one card per process: rank {rank} and "
            f"rank(s) {shared} are all on {device} ({mine}), which NCCL "
            "refuses; give each process its own card, or pass "
            "backend=\"gloo\"")


def is_initialized() -> bool:
    """True once this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def is_coordinator() -> bool:
    """True on process 0, the conventional reporting process (and in a
    process that joined no group)."""
    return not is_initialized() or dist.get_rank() == 0


def global_mesh(axis: str = "r", ranks: Optional[Sequence[int]] = None
                ) -> Mesh:
    """1-D mesh over every process of the run (or over `ranks`): the
    restart axis."""
    return make_mesh(ranks, axis)


def solve_restarts_distributed(form, num_restarts: int, generator=None,
                               mesh: Optional[Mesh] = None, **kwargs):
    """`solve_restarts` over the global mesh.

    Every process calls this with identical (form, num_restarts, generator
    seed, kwargs), its form on its own device; each solves its block of
    the restarts and every process returns the same (x, f, v)."""
    if mesh is None:
        mesh = global_mesh()
    return solve_restarts(form, num_restarts, generator, mesh=mesh,
                          **kwargs)


def shutdown() -> None:
    """Leave the process group."""
    global _bound
    _bound = None
    if is_initialized():
        dist.destroy_process_group()
