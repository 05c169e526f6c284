"""Run one cell of the benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program (qcqp_tpu_torch).  The
cell (BENCHMARK.json `workloads`) names its configuration, its traffic
mix and its chips; harness/spec.py finds their files.  One chip: the run
is this process.  More: this process starts one rank a card
(harness/rank.py under `--rank`) on a free localhost port, and combines
what they report.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (with --trace 0 the cell's end-to-end metrics, with
--trace 1 its per-layer metrics), device, with --trace 1 breakdown, and
last `checks`, each compared number with its limit; the same numbers are
the last lines of standard error.  A machine without the cards the cell
asks for, or a process that holds JAX or the JAX package once the window
has closed, exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()      # CLOCK_MONOTONIC: one clock for every process

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from portbench.harness import compare, spec, trace  # noqa: E402
from portbench.harness.rank import banned_modules, run_rank  # noqa: E402


class NoResult(Exception):
    """The run prints no result and exits non-zero."""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn(job: dict, timeout: float = 330.0):
    """The cell's ranks as processes, rank r on card r, each reporting one
    JSON line; every one has ended when this returns."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if job.get("device") == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs = []
    try:
        for rank in range(job["world"]):
            spec_json = json.dumps(dict(job, rank=rank,
                                        coordinator=f"127.0.0.1:{port}"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(_HERE, "run.py"), "--rank",
                 spec_json], env=env, stdout=subprocess.PIPE, text=True))
        deadline = time.monotonic() + timeout
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                [0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for p in procs:
        if p.returncode != 0:
            raise NoResult(f"a rank exited with {p.returncode}")
    return [json.loads(out.splitlines()[-1]) for out in outs]


def _device(chips: int, cpu: bool) -> dict:
    if cpu:
        return {"platform": "cpu", "kind": "cpu", "count": chips}
    import torch
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True).stdout.strip()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "power_limit": power}


def measure(workload: str, seed: int, seconds: float, traced: bool,
            device: str = "cuda", hooks=()) -> dict:
    """One run of the cell, as the result object (without printing).
    device="cpu" runs it on the CPU with the program's plain versions, for
    the harness's own tests; the command line never does."""
    cell = spec.Cell(workload)
    cpu = device == "cpu"
    if not cpu:
        import torch
        if not torch.cuda.is_available():
            raise NoResult("no CUDA device is available")
        if torch.cuda.device_count() < cell.chips:
            raise NoResult(f"the cell asks for {cell.chips} cards, the "
                           f"machine has {torch.cuda.device_count()}")
    job = {"workload": workload, "seed": seed, "seconds": seconds,
           "trace": traced, "device": device, "world": cell.chips,
           "t0": T0, "hooks": list(hooks)}
    if cell.chips == 1:
        ranks = [run_rank(job)]
    else:
        ranks = _spawn(job)
    found = banned_modules() + [m for r in ranks for m in r["banned"]]
    if found:
        raise NoResult("loaded after the window: " + ", ".join(
            sorted(set(found))))
    run = {"cell": cell, "ranks": ranks, "traced": traced}
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in getattr(cell, kind):
        value = spec.load(kind if kind == "end_to_end" else "layer_metrics",
                          m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(r["failed"] for r in ranks)
    numbers = compare.combine([r["numbers"] for r in ranks])
    correct, checks = compare.judge(numbers, cell.limits, failed)
    dev = _device(cell.chips, cpu)
    if not cpu:
        dev["memory_peak_bytes"] = max(r["memory_peak_bytes"]
                                       for r in ranks)
    result = {"correct": correct, "attempted": ranks[0]["solves"],
              "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        tr = [r["trace"] for r in ranks]
        dev["busy_s"] = sum(t["busy_s"] for t in tr) / len(tr)
        dev["window_s"] = max(t["window_s"] for t in tr)
        slow = max(tr, key=lambda t: t["window_s"] - t["busy_s"])
        result["breakdown"] = {"device_ops": trace.device_ops(
            slow["launches"]), "idle_gaps": slow["idle"]}
    result["readings"] = dict(numbers, check_s=max(r["check_s"]
                                                   for r in ranks),
                              setup_marks=ranks[0]["setup_marks"])
    result["checks"] = checks
    return result


def _clean(obj):
    """Non-finite floats as strings, so that the line stays JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: _clean(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_clean(v) for v in obj]
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.rank is not None:                         # one rank of a cell
        out = run_rank(json.loads(a.rank))
        print(json.dumps(_clean(out)), flush=True)
        return 0
    if a.workload is None or a.seed is None or a.seconds is None:
        ap.error("--workload, --seed and --seconds are required")
    try:
        result = measure(a.workload, a.seed, a.seconds, bool(a.trace))
    except NoResult as e:
        print(f"portbench: no result: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(_clean(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
