"""A profiled window, reduced: the device's busy time, each kernel's
launches, and the idle stretches named by what the host was doing.

The harness profiles the window with torch.profiler (CPU and CUDA
activities) and exports its Chrome trace to a temporary file; this module
reads that file.  The window is the span the harness records around it
(`WINDOW`); the device's work is every kernel, copy and fill (categories
`kernel`, `gpu_memcpy`, `gpu_memset`) inside it; a device gap is named by
the outermost harness span and the innermost host operation running when
it opened.  Times in the trace are microseconds; everything returned is
in seconds.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

from .window import gaps, union_seconds

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def short(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].strip()
    return name[5:] if name.startswith("void ") else name


def _innermost(starts, events, t):
    """The host event with the latest start at or before t that still runs
    at t, or None; events sorted by start, starts their starts."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 2000), -1):
        e = events[j]
        if e["ts"] + e["dur"] >= t:
            return e
    return None


def reduce(path: str) -> dict:
    """{"window_s", "busy_s", "launches": {name: [seconds, ...]},
    "idle": [[host name, seconds], ...]} of the traced window."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} spans {WINDOW!r}")
    lo, hi = float(win[0]["ts"]), float(win[0]["ts"] + win[0]["dur"])
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and lo <= e["ts"] < hi]
    launches = defaultdict(list)
    for e in sorted(dev, key=lambda e: e["ts"]):
        launches[short(e["name"])].append(e["dur"] * 1e-6)
    spans = [(float(e["ts"]), float(e["ts"] + e["dur"])) for e in dev]
    host = sorted((e for e in events if e.get("cat") in HOST_CATS
                   and e.get("name") != WINDOW), key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    outer = sorted((e for e in host if e.get("cat") == "user_annotation"),
                   key=lambda e: e["ts"])
    outer_starts = [e["ts"] for e in outer]
    idle = defaultdict(float)
    for s, e in gaps(spans, lo, hi):
        inner = _innermost(starts, host, s)
        top = _innermost(outer_starts, outer, s)
        name = "/".join(dict.fromkeys(
            x["name"] for x in (top, inner) if x is not None)) or "host"
        idle[name] += (e - s) * 1e-6
    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": union_seconds(spans, lo, hi) * 1e-6,
            "launches": dict(launches),
            "idle": sorted(([k, v] for k, v in idle.items()),
                           key=lambda kv: -kv[1])[:TOP]}


def device_ops(launches: dict):
    """The TOP device operations by their total seconds: [[name, s], ...]."""
    totals = [[k, sum(v)] for k, v in launches.items()]
    return sorted(totals, key=lambda kv: -kv[1])[:TOP]
