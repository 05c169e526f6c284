"""Restart-throughput scaling over a mesh of processes, and the collective
inventory of the sharded pipelines (JAX counterpart: benchmarks/scaling.py).

The JAX script measures its sharded restart pipeline on N virtual CPU
devices of one process and reads the collectives from the compiled HLO.
The port runs one process per device (parallel/launch.py), so this script
starts `world` worker processes (`--worker SPEC`, each a rank of one
torch.distributed group), each running the same solve_restarts over
global_mesh(), and reads the collectives from each rank's Mesh.calls and
Mesh.bytes.  Run:

    python -m qcqp_tpu_torch.benchmarks.scaling               # NCCL ranks
    python -m qcqp_tpu_torch.benchmarks.scaling --device cpu  # gloo ranks

On the CPU the world sizes are 1, 2, 4 and 8 gloo ranks of one thread
each; on CUDA they go up to the card count, one NCCL rank a card (a
machine with one card gives world 1 only, and no scaling figure).  The
problem size comes from SCALE_N, SCALE_M, SCALE_R and SCALE_SWEEPS
(default 40, 20, 256, 5).  Prints restarts/s and parallel efficiency per
world size, then the collective inventory of the restart pipeline and of
the 2-D (restarts x constraints) ADMM.
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

N = int(os.environ.get("SCALE_N", 40))
M = int(os.environ.get("SCALE_M", 20))
R = int(os.environ.get("SCALE_R", 256))
SWEEPS = int(os.environ.get("SCALE_SWEEPS", 5))

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _launch(world: int, job: dict, device: str, timeout: float = 600.0):
    """Run `job` on `world` worker processes, rank r on cuda:r (NCCL) or
    on the CPU (gloo, one thread a rank); returns each rank's result.
    Every worker is killed if it is still running when this returns."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        try:
            for rank in range(world):
                spec = os.path.join(tmp, f"{rank}.json")
                with open(spec, "w") as f:
                    json.dump(dict(job, world=world, rank=rank,
                                   device=device,
                                   coordinator=f"127.0.0.1:{port}"), f)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "qcqp_tpu_torch.benchmarks.scaling",
                     "--worker", spec], env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True))
            deadline = time.monotonic() + timeout
            outs = [p.communicate(timeout=max(1.0, deadline
                                              - time.monotonic()))
                    for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"scaling worker exited {p.returncode}:\n"
                               f"{err[-3000:]}")
    return [json.loads(out.splitlines()[-1]) for out, _ in outs]


def _worker(spec_path: str) -> None:
    """(run as `--worker SPEC`) one rank: join the group, run the job,
    print its result as one JSON line."""
    import torch
    from qcqp_tpu_torch.parallel import launch
    with open(spec_path) as f:
        spec = json.load(f)
    cpu = spec["device"] == "cpu"
    if cpu:
        torch.set_num_threads(1)
    device = launch.initialize(
        spec["coordinator"], spec["world"], spec["rank"],
        device="cpu" if cpu else f"cuda:{spec['rank']}", timeout=120.0)
    try:
        out = _JOBS[spec["job"]](spec, device)
    finally:
        launch.shutdown()
    print(json.dumps(out), flush=True)


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _bench_form(spec, device):
    from qcqp_tpu_torch.core import random_form
    return random_form(np.random.default_rng(0), n=spec["n"], m=spec["m"],
                       device=device)


def _job_run(spec, device):
    """A warm-up solve, then one timed solve_restarts over global_mesh()."""
    import torch
    import torch.distributed as dist
    from qcqp_tpu_torch.parallel.launch import global_mesh
    from qcqp_tpu_torch.parallel.restarts import solve_restarts
    form = _bench_form(spec, device)
    mesh = global_mesh()

    def solve(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return solve_restarts(form, spec["R"], gen, mesh=mesh,
                              num_iters=spec["sweeps"])
    solve(0)
    _sync(device)
    dist.barrier()
    t0 = time.perf_counter()
    solve(1)
    _sync(device)
    return {"seconds": time.perf_counter() - t0}


def _job_collectives(spec, device):
    """One solve_restarts over global_mesh(): the mesh's collectives."""
    import torch
    from qcqp_tpu_torch.parallel.launch import global_mesh
    from qcqp_tpu_torch.parallel.restarts import solve_restarts
    form = _bench_form(spec, device)
    mesh = global_mesh()
    gen = torch.Generator(device=device).manual_seed(0)
    solve_restarts(form, spec["R"], gen, mesh=mesh,
                   num_iters=spec["sweeps"])
    return {"calls": dict(mesh.calls), "bytes": dict(mesh.bytes),
            "itemsize": form.P.element_size()}


def _form_2d(m_big, device):
    """benchmarks/scaling.py:129-136: n = 16, m = m_big, default_rng(0)."""
    from qcqp_tpu_torch.convert import form_from_numpy
    rng = np.random.default_rng(0)
    A = rng.standard_normal((m_big + 1, 16, 16)) / 4.0
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m_big + 1, 16)) / 4.0
    r = rng.standard_normal(m_big + 1) - 1.0
    return form_from_numpy(P, q, r, np.zeros(m_big, bool), device=device)


def _job_collectives_2d(spec, device):
    """improve_admm_2d on an (nr, nc) mesh, R = 8, 30 iterations: the
    mesh's collectives and the iterations run (each iteration of either
    phase projects this rank's constraints once)."""
    import torch
    from qcqp_tpu_torch.parallel import mesh2d
    form = _form_2d(spec["m_big"], device)
    mesh = mesh2d.make_mesh_2d(spec["nr"], spec["nc"])
    xs = torch.randn((spec["R"], 16), generator=torch.Generator(
        device=device).manual_seed(0), dtype=form.dtype, device=device)
    real, iters = mesh2d.project_onecons, [0]

    def project(*a, **kw):
        iters[0] += 1
        return real(*a, **kw)
    mesh2d.project_onecons = project
    try:
        _sync(device)
        t0 = time.perf_counter()
        mesh2d.improve_admm_2d(form, xs, mesh, num_iters=30)
        _sync(device)
        seconds = time.perf_counter() - t0
    finally:
        mesh2d.project_onecons = real
    return {"calls": dict(mesh.calls), "bytes": dict(mesh.bytes),
            "iterations": iters[0], "seconds": seconds,
            "itemsize": form.P.element_size(), "coords": mesh.coords}


_JOBS = {"run": _job_run, "collectives": _job_collectives,
         "collectives_2d": _job_collectives_2d}


def _size():
    return {"n": N, "m": M, "R": R, "sweeps": SWEEPS}


def run(world: int, device: str = "cuda") -> float:
    """Restarts/s of solve_restarts over `world` ranks (one timed solve
    after a warm-up, the slowest rank's time)."""
    size = _size()
    res = _launch(world, dict(job="run", **size), device)
    return size["R"] / max(r["seconds"] for r in res)


def collective_report(world: int, device: str = "cuda") -> dict:
    """The collectives of one sharded restart solve, per rank, from its
    Mesh.calls and Mesh.bytes, against the analytic inventory: the
    restart axis is embarrassingly parallel, so a solve's whole traffic is
    the best-point reduction, one all_gather of n + 3 numbers a rank
    (parallel/restarts.pick_across).  Raises AssertionError otherwise."""
    size = _size()
    res = _launch(world, dict(job="collectives", **size), device)
    itemsize = res[0]["itemsize"]
    expect = {"calls": {"all_gather": 1},
              "bytes": {"all_gather": (size["n"] + 3) * itemsize}}
    print(f"\n== collectives of the {world}-rank restart pipeline "
          f"(R={size['R']}, n={size['n']}, m={size['m']}, {device}) ==")
    for rank, r in enumerate(res):
        for kind in sorted(r["calls"]):
            print(f"  rank {rank}: {kind:12s} x{r['calls'][kind]}  "
                  f"{r['bytes'][kind]:8d} B")
    total = sum(sum(r["bytes"].values()) for r in res)
    print(f"  TOTAL per solve: {total} bytes sent by {world} ranks "
          f"(restarts communicate only in the best-point reduction)")
    print(f"  constraint-sharded ADMM: one all_reduce of the consensus z an "
          f"iteration = n*{itemsize} = {size['n'] * itemsize} B/iteration "
          f"(parallel/mesh.py)")
    out = {"world": world, "ranks": res, "expected": expect,
           "total_bytes": total}
    bad = [r for r in res if {k: r[k] for k in ("calls", "bytes")}
           != expect]
    if bad:
        raise AssertionError(f"collective inventory {bad} != {expect}")
    return out


def collective_report_2d(m_big: int = 512, nr: int = 2, nc: int = 4,
                         device: str = "cpu") -> dict:
    """The collectives of the 2-D (restarts x constraints) ADMM on an
    (nr, nc) mesh, R = 8 restarts, n = 16, m = m_big, 30 iterations: one
    all_reduce of this rank's (R / nr, n) consensus sums over "c" an
    iteration, and one all_gather of the (R / nr, n) result over "r".
    Raises AssertionError if a rank's counts differ from that."""
    R2 = 8
    res = _launch(nr * nc, dict(job="collectives_2d", m_big=m_big, nr=nr,
                                nc=nc, R=R2), device)
    print(f"\n== collectives of the {nr}x{nc}-mesh 2-D ADMM "
          f"(R={R2}, n=16, m={m_big}, 30 iterations, {device}) ==")
    bad = []
    for rank, r in enumerate(res):
        block = R2 // nr * 16 * r["itemsize"]
        each = r["bytes"].get("all_reduce", 0) / max(
            r["calls"].get("all_reduce", 0), 1)
        r.update(all_reduces_per_iteration=r["calls"].get("all_reduce", 0)
                 / max(r["iterations"], 1), bytes_per_all_reduce=each,
                 expected_bytes_per_all_reduce=block)
        print(f"  rank {rank} {r['coords']}: {r['iterations']} iterations, "
              f"{r['calls'].get('all_reduce', 0)} all_reduce over c "
              f"({each:.0f} B each, "
              f"{r['all_reduces_per_iteration']:.2f} an iteration), "
              f"{r['calls'].get('all_gather', 0)} all_gather over r "
              f"({r['bytes'].get('all_gather', 0)} B)")
        if (r["calls"] != {"all_reduce": r["iterations"], "all_gather": 1}
                or r["bytes"] != {"all_reduce": r["iterations"] * block,
                                  "all_gather": block}):
            bad.append(rank)
    secs = max(r["seconds"] for r in res)
    print(f"  m={m_big} throughput: {R2 / secs:.2f} restarts/s "
          f"(30 iters, {nr}x{nc} mesh; host-bound on the CPU: the bytes, "
          f"not the speedup, are the scaling evidence)")
    if bad:
        raise AssertionError(f"2-D inventory of ranks {bad}: {res}")
    return {"ranks": res, "seconds": secs}


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                      help="cuda: one NCCL rank a card (the default); "
                           "cpu: gloo ranks on the CPU")
    args.add_argument("--worker", metavar="SPEC",
                      help="(internal) one rank of a measurement")
    args = args.parse_args(argv)
    if args.worker:
        return _worker(args.worker)
    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("scaling: no CUDA device; pass --device cpu "
                             "to run gloo ranks on the CPU")
        cards = torch.cuda.device_count()
        worlds = [w for w in (1, 2, 4, 8) if w <= cards]
    else:
        worlds = [1, 2, 4, 8]
    base = run(1, args.device)
    print(f"1 rank  : {base:9.1f} restarts/s  (eff 100.0%)")
    for world in worlds[1:]:
        rate = run(world, args.device)
        eff = rate / (base * world) * 100
        print(f"{world} ranks : {rate:9.1f} restarts/s  (eff {eff:5.1f}%)")
    if len(worlds) == 1:
        print("one card: no scaling figure (a world of w NCCL ranks needs "
              "w cards; --device cpu runs gloo ranks)")
    collective_report(worlds[-1], args.device)
    if args.device == "cpu" or torch.cuda.device_count() >= 8:
        collective_report_2d(device=args.device)
    else:
        print("\n2-D ADMM inventory: the (2, 4) mesh needs 8 cards, this "
              f"machine has {torch.cuda.device_count()}; --device cpu "
              "gives it on gloo ranks (float64 there, float32 on a card)")


if __name__ == "__main__":
    main()
