"""Restart-throughput scaling over a mesh of processes, and the collective
inventory of the sharded pipelines (JAX counterpart: benchmarks/scaling.py).

The JAX script measures its sharded restart pipeline on N virtual CPU
devices of one process and reads the collectives from the compiled HLO.
The port runs one process per device (parallel/launch.py), so this script
starts `world` worker processes (`--worker SPEC`, each a rank of one
torch.distributed group), each running the same solve_restarts over
global_mesh(), and reads the collectives from each rank's Mesh.calls and
Mesh.bytes.  Run:

    python -m qcqp_tpu_torch.benchmarks.scaling                # NCCL ranks
    python -m qcqp_tpu_torch.benchmarks.scaling --worlds 1,2,4
    SCALE_N=40 SCALE_M=20 SCALE_R=64 SCALE_SWEEPS=5 \
        python -m qcqp_tpu_torch.benchmarks.scaling --device cpu  # gloo

On the CPU the world sizes are 1, 2, 4 and 8 gloo ranks of one thread
each; on CUDA they go up to the card count, one NCCL rank a card (a
machine with one card gives world 1 only, and no scaling figure).
--worlds names the world sizes instead, and on CUDA raises when the
machine has fewer cards than the largest.

The form is bench.py's (cd_routes.bench_form: n = SCALE_N, m = SCALE_M,
seed 0; float32 on a card, float64 on the CPU).  Per world: weak scaling
at SCALE_R restarts a rank and strong scaling at SCALE_R times the
largest world in all, SCALE_SWEEPS CD sweeps, each a warm-up solve then
REPEATS timed solves (the slowest rank's time, median over the repeats);
the best point's all_gather of n + 3 numbers timed alone and its share of
a weak solve; and each rank's collectives of one solve against the
analytic count.  The defaults (100, 50, 10,240, 10) are the one-card CD
shape; the CPU wants the smaller sizes above.  Prints the cards' names
and power limits (nvidia-smi), restarts/s and parallel efficiency per
world size, the collective inventory of each world's restart pipeline,
then that of the 2-D (restarts x constraints) ADMM.
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

from .cd_routes import bench_form

N = int(os.environ.get("SCALE_N", 100))
M = int(os.environ.get("SCALE_M", 50))
R = int(os.environ.get("SCALE_R", 10240))
SWEEPS = int(os.environ.get("SCALE_SWEEPS", 10))
REPEATS = 3

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


def _job_run(spec, device):
    """One rank of run(): after a warm-up solve each, REPEATS timed weak
    and strong solves over global_mesh(), the all_gather of n + 3 numbers
    timed alone, and the mesh's collectives of one weak solve."""
    import torch
    import torch.distributed as dist
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.parallel.launch import global_mesh
    from qcqp_tpu_torch.parallel.restarts import solve_restarts
    form = form_from_numpy(*bench_form(spec["n"], spec["m"]), device=device)
    mesh = global_mesh()

    def timed(fn):
        _sync(device)
        dist.barrier()
        t0 = time.perf_counter()
        fn()
        _sync(device)
        return time.perf_counter() - t0

    def solve(R, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return solve_restarts(form, R, gen, mesh=mesh,
                              num_iters=spec["sweeps"])
    out = {}
    for kind in ("weak", "strong"):
        solve(spec[kind], 0)
        out[kind] = [timed(lambda: solve(spec[kind], 1 + i))
                     for i in range(spec["repeats"])]
    cand = torch.zeros(form.n + 3, dtype=form.dtype, device=device)
    mesh.all_gather(cand, "r")
    out["all_gather"] = [timed(lambda: mesh.all_gather(cand, "r"))
                         for _ in range(10)]
    mesh.calls.clear()
    mesh.bytes.clear()
    solve(spec["weak"], 0)
    out.update(calls=dict(mesh.calls), bytes=dict(mesh.bytes),
               itemsize=form.P.element_size())
    return out


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


_JOBS = {"run": _job_run, "collectives_2d": _job_collectives_2d}


def run(world: int, device: str = "cuda", strong=None) -> dict:
    """One launch of `world` ranks (_job_run): weak scaling at R restarts
    a rank and strong scaling at `strong` in all (default R * world), each
    as its restarts, the median over the repeats of the slowest rank's ms
    and restarts/s; the all_gather's ms (the same median) and its share of
    a weak solve; and each rank's result."""
    size = {"n": N, "m": M, "sweeps": SWEEPS, "repeats": REPEATS,
            "weak": R * world, "strong": R * world if strong is None
            else strong}
    res = _launch(world, dict(job="run", **size), device)

    def median_ms(key):
        return float(np.median(np.max([r[key] for r in res], axis=0))) * 1e3
    out = {"world": world, "ranks": res}
    for kind in ("weak", "strong"):
        ms = median_ms(kind)
        out[kind] = {"R": size[kind], "ms": ms,
                     "restarts_s": size[kind] / ms * 1e3}
    out["all_gather_ms"] = median_ms("all_gather")
    out["all_gather_share"] = out["all_gather_ms"] / out["weak"]["ms"]
    return out


def collective_report(world: int, device: str = "cuda",
                      ranks=None) -> dict:
    """The collectives of one sharded restart solve, per rank, from its
    Mesh.calls and Mesh.bytes, against the analytic inventory: the
    restart axis is embarrassingly parallel, so a solve's whole traffic is
    the best-point reduction, one all_gather of n + 3 numbers a rank
    (parallel/restarts.pick_across).  ranks: run(world)'s, which it runs
    when none are given.  Raises AssertionError otherwise."""
    res = run(world, device)["ranks"] if ranks is None else ranks
    itemsize = res[0]["itemsize"]
    expect = {"calls": {"all_gather": 1},
              "bytes": {"all_gather": (N + 3) * itemsize}}
    print(f"\n== collectives of the {world}-rank restart pipeline "
          f"(R={R * world}, n={N}, m={M}, {device}) ==")
    for rank, r in enumerate(res):
        for kind in sorted(r["calls"]):
            print(f"  rank {rank}: {kind:12s} x{r['calls'][kind]}  "
                  f"{r['bytes'][kind]:8d} B")
    total = sum(sum(r["bytes"].values()) for r in res)
    print(f"  TOTAL per solve: {total} bytes sent by {world} ranks "
          f"(restarts communicate only in the best-point reduction)")
    print(f"  constraint-sharded ADMM: one all_reduce of the consensus z an "
          f"iteration = n*{itemsize} = {N * itemsize} B/iteration "
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


def study(worlds, device: str = "cuda") -> list:
    """run() at each world size, strong scaling at R times the largest,
    with parallel efficiency against the first world (restarts/s a rank
    over its restarts/s a rank), each printed on one line, then each
    world's collective inventory (collective_report).  Returns the rows."""
    rows = []
    for world in worlds:
        row = run(world, device, strong=R * worlds[-1])
        rows.append(row)
        for kind in ("weak", "strong"):
            first = rows[0][kind]["restarts_s"] / worlds[0]
            row[kind]["efficiency"] = row[kind]["restarts_s"] / world / first
        print(f"{world} ranks: " + "; ".join(
            f"{kind} R={row[kind]['R']} {row[kind]['ms']} ms "
            f"{row[kind]['restarts_s']} restarts/s eff "
            f"{row[kind]['efficiency']}" for kind in ("weak", "strong"))
            + f"; all_gather {row['all_gather_ms']} ms "
            f"({row['all_gather_share']} of a weak solve)", flush=True)
    for row in rows:
        collective_report(row["world"], device, row["ranks"])
    return rows


def _cards(device):
    """Each card's index, name and power limit as nvidia-smi prints them
    (none on the CPU)."""
    if device == "cpu":
        return []
    out = subprocess.run(["nvidia-smi", "--query-gpu=index,name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def _worlds(arg, device):
    """The world sizes: --worlds "1,2,4", which on CUDA must not exceed
    the card count (one NCCL rank a card); by default 1, 2, 4 and 8, on
    CUDA only those the cards hold."""
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("scaling: no CUDA device; pass --device cpu "
                         "to run gloo ranks on the CPU")
    cards = torch.cuda.device_count() if device == "cuda" else None
    if arg is None:
        return [w for w in (1, 2, 4, 8) if cards is None or w <= cards]
    worlds = sorted({int(w) for w in arg.split(",")})
    if worlds[0] < 1:
        raise SystemExit(f"scaling: --worlds {arg}: world sizes are >= 1")
    if cards is not None and worlds[-1] > cards:
        raise SystemExit(f"scaling: --worlds {arg} needs {worlds[-1]} "
                         f"cards (one NCCL rank a card), this machine has "
                         f"{cards}")
    return worlds


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                      help="cuda: one NCCL rank a card (the default); "
                           "cpu: gloo ranks on the CPU")
    args.add_argument("--worlds", metavar="1,2,4",
                      help="the world sizes; on CUDA it raises when the "
                           "machine has fewer cards than the largest")
    args.add_argument("--worker", metavar="SPEC",
                      help="(internal) one rank of a measurement")
    args = args.parse_args(argv)
    if args.worker:
        return _worker(args.worker)
    import torch
    worlds = _worlds(args.worlds, args.device)
    for card in _cards(args.device):
        print(f"card {card}")
    rows = study(worlds, args.device)
    if len(worlds) == 1:
        print("one world: no scaling figure (a world of w NCCL ranks needs "
              "w cards; --device cpu runs gloo ranks)")
    if args.device == "cpu" or torch.cuda.device_count() >= 8:
        collective_report_2d(device=args.device)
    else:
        print("\n2-D ADMM inventory: the (2, 4) mesh needs 8 cards, this "
              f"machine has {torch.cuda.device_count()}; --device cpu "
              "gives it on gloo ranks (float64 there, float32 on a card)")
    return rows


if __name__ == "__main__":
    main()
