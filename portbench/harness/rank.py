"""One rank of one run: the traffic generator of the restart mixes, the
measured window, its trace, and the check against the reference.

The mixes (traffic/<name>.json) are closed loops with one caller: a
user calls `qcqp_tpu_torch.parallel.restarts.solve_restarts(form, R,
generator, suggest, improve, mesh=...)` and waits for the best (x, f, v)
on the host, then calls again.  Solve i draws its starts from a generator
seeded with window.solve_seed(seed, i).  On a cell of several chips one
process runs on each card and every rank makes the same call over
`launch.global_mesh()`; rank 0 decides, over a gloo group of the
harness's own, whether another solve starts, so that every rank makes
the same number of calls.

After the window, with the program's state freed, the reference
(reference/suggest_<suggest>.py, reference/<improve>.py and
reference/problem.py) draws the starts of a sample of the window's
solves again (`compared_solves` of them, drawn from the seed), improves
them, and picks the best point (across ranks through the harness's gloo
group), with TF32 off; harness/compare.py holds the program's answers
against it.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import os
import sys
import tempfile
import time

import numpy as np

from . import compare, spec, trace, window

BANNED = ("jax", "jaxlib", "flax", "qcqp_tpu")


def banned_modules(modules=None):
    """The loaded modules whose top-level name is one of BANNED, compared
    whole (so qcqp_tpu_torch is not qcqp_tpu)."""
    modules = sys.modules if modules is None else modules
    return sorted(name for name in list(modules)
                  if name.split(".")[0] in BANNED)


def _sample(seed: int, count: int, k: int):
    """k distinct solve indices of [0, count), drawn from the seed."""
    rng = np.random.default_rng([int(seed), 7])
    return sorted(int(i) for i in rng.choice(count, size=min(k, count),
                                             replace=False))


class _Control:
    """Whether another solve starts: rank 0 decides, every rank follows."""

    def __init__(self, group):
        self.group = group

    def next(self, more: bool) -> bool:
        if self.group is None:
            return more
        import torch
        import torch.distributed as dist
        flag = torch.tensor([int(more)], dtype=torch.int32)
        dist.broadcast(flag, 0, group=self.group)
        return bool(flag.item())

    def gather(self, obj):
        if self.group is None:
            return [obj]
        import torch.distributed as dist
        out = [None] * dist.get_world_size(self.group)
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self):
        if self.group is not None:
            import torch.distributed as dist
            dist.barrier(group=self.group)


def run_rank(job: dict) -> dict:
    """One rank's run (job: workload, seed, seconds, trace, rank, world,
    device, coordinator, and t0: the perf_counter, CLOCK_MONOTONIC on
    Linux and so one clock for every process, when the run started).
    Returns what run.py combines: the window's times, the trace's
    reduction, the reference's work and the comparison's numbers."""
    marks = {"start": time.perf_counter() - job["t0"]}
    import torch
    for hook in job.get("hooks", ()):     # the harness's tests: sizes, faults
        module, _, fn = hook.partition(":")
        getattr(importlib.import_module(module), fn)()
    cell = spec.Cell(job["workload"])
    cell.suggest_reference(), cell.reference()    # none missing: stop now
    mix, seed = cell.mix, int(job["seed"])
    rank, world = int(job.get("rank", 0)), int(job.get("world", 1))
    cpu = job.get("device") == "cpu"
    if cpu:
        torch.set_num_threads(1)
    out = {"rank": rank}
    group = None
    if world > 1:
        import torch.distributed as dist
        from qcqp_tpu_torch.parallel import launch
        t = time.perf_counter()
        dev = launch.initialize(job["coordinator"], world, rank,
                                device="cpu" if cpu else None)
        out["ready_s"] = time.perf_counter() - t
        group = dist.new_group(backend="gloo")
        mesh = launch.global_mesh()
    else:
        dev = torch.device("cpu" if cpu else "cuda:0")
        mesh = None
    ctl = _Control(group)

    marks["joined"] = time.perf_counter() - job["t0"]
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.parallel.restarts import solve_restarts
    marks["imported"] = time.perf_counter() - job["t0"]
    arrays = cell.problem()
    arrays32 = [np.asarray(a, np.float32) for a in arrays[:3]] + [
        np.asarray(arrays[3], bool)]
    form = form_from_numpy(*arrays32, device=dev, dtype=torch.float32)
    R = int(mix["restarts"])
    args = dict(mix.get("improve_args", {}))

    def solve(i):
        gen = torch.Generator(device=dev).manual_seed(
            window.solve_seed(seed, i))
        with span("portbench.solve"):
            x, f, v = solve_restarts(form, R, gen, suggest=mix["suggest"],
                                     improve=mix["improve"], mesh=mesh,
                                     **args)
        with span("portbench.read"):
            return x.cpu().numpy(), float(f.item()), float(v.item())

    marks["problem"] = time.perf_counter() - job["t0"]
    span = _no_span
    for i in range(-int(mix.get("warmup_solves", 1)), 0):
        solve(i)                                      # warm-up: set-up
    if not cpu:
        torch.cuda.synchronize(dev)
    ctl.barrier()
    prof = None
    if job.get("trace"):
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([] if cpu else
                                         [ProfilerActivity.CUDA])
        prof = profile(activities=acts)
        prof.__enter__()
        span = record_function
    durs, answers = [], []
    seconds = float(job["seconds"])
    with span(trace.WINDOW):
        t_open = t_close = None
        while True:
            with span("portbench.next"):
                more = window.more(0.0 if t_open is None else
                                   time.perf_counter() - t_open,
                                   len(durs), seconds)
                if not ctl.next(more):
                    break
            t0 = time.perf_counter()
            if t_open is None:
                t_open = t0
                out["setup_s"] = t0 - job["t0"]
                out["setup_marks"] = marks
            answers.append(solve(len(answers)))
            t_close = time.perf_counter()
            durs.append(t_close - t0)
    if not cpu:
        torch.cuda.synchronize(dev)
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    out.update(window_s=t_close - t_open, solves=len(durs), solve_s=durs,
               restarts=R, n=form.n, m=form.m, E=int(arrays32[3].sum()))
    if prof is not None:
        prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            out["trace"] = trace.reduce(path)

    # the program's state goes before the reference runs
    del form, solve
    gc.collect()
    if not cpu:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    out.update(check(cell, seed, arrays32, answers, dev, (rank, world), ctl))
    out["check_s"] = time.perf_counter() - t
    if world > 1:
        import torch.distributed as dist
        from qcqp_tpu_torch.parallel import launch
        ctl.barrier()
        dist.destroy_process_group(group)
        launch.shutdown()
    out["banned"] = banned_modules()           # all that this rank loaded
    return out


@contextlib.contextmanager
def _no_span(name):
    yield


def reference_best(mix, form, solve_seed, rank_world, gather, tf32=False):
    """The reference's best point of one solve of `mix`: its starts drawn
    again from solve_seed by reference/suggest_<suggest>.py (the whole
    padded batch, this rank's block), improved by reference/<improve>.py,
    the best of the block, then the best across the ranks (gather: one
    candidate a rank, in rank order).  TF32 is off (tf32=True: the
    control).  Returns ((bucket, f, v, x), work of this rank's block)."""
    import torch
    from ..reference import problem as ref
    rank, world = rank_world
    R = int(mix["restarts"])
    padded = -(-R // world) * world
    q, rem = divmod(padded, world)
    lo = rank * q + min(rank, rem)
    hi = lo + q + (rank < rem)
    args = {k: v for k, v in mix.get("improve_args", {}).items()
            if k != "use_fused"}
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        xs = spec.suggest_reference(mix).draw(
            form, padded, solve_seed, form.P.dtype, form.device)[lo:hi]
        x, work = spec.improve_reference(mix).improve(form, xs, **args)
        cand = ref.candidate(form, x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
    work.update(restarts=hi - lo)
    return ref.pick(gather(cand)), work


def check(cell, seed, arrays32, answers, dev, rank_world, ctl) -> dict:
    """The comparison of this rank's answers with the reference: every
    answer's claim against its point, and a sample of solves, drawn from
    the seed, against the reference's best point."""
    import torch
    from ..reference import problem as ref
    failed = sum(not (np.isfinite(x).all() and np.isfinite([f, v]).all())
                 for x, f, v in answers)
    claims = [compare.claim_gap((f, v), ref.host_f_v(arrays32, x))
              for x, f, v in answers]
    idx = _sample(seed, len(answers), int(cell.mix.get("compared_solves",
                                                       1)))
    form = ref.make_form(arrays32, torch.float32, dev)
    gaps, work = [], []
    for i in idx:
        best, w = reference_best(cell.mix, form, window.solve_seed(seed, i),
                                 rank_world, ctl.gather)
        gaps.append(compare.answer_gaps(answers[i], best))
        work.append(dict(w, index=i))
    return {"failed": int(failed), "work": work,
            "numbers": compare.worst(claims, gaps)}
