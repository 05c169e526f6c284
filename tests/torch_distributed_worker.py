"""Worker process for qcqp_tpu_torch's multi-process tests, and the
launcher that starts the workers (the port's counterpart of
tests/distributed_worker.py).

Run as:  python torch_distributed_worker.py <coordinator> <nproc> <pid>
             <job.pkl> <outdir>

Each process joins a gloo process group on the CPU through the port's
launch.initialize (or a CUDA one, as the job says: a job device of
"cuda" gives rank r the card cuda:r, as NCCL needs one rank a card; any
other device is every rank's), runs the job's cases in order (every
rank runs every case: each mesh's groups are made by all ranks), and
writes what each case returned to <outdir>/<pid>.pkl.  A
case that raises makes the process exit non-zero, with the traceback on
stderr, unless the case expects that error.

This file runs standalone (no pytest, no conftest) and imports neither
JAX nor the JAX package: the workers check that jax stays out of
sys.modules.  The launcher gives each run a process-group timeout and a
wall-clock timeout, and kills every worker it started before it returns.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


# ---------------------------------------------------------------- launcher

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device, rank):
    """Rank `rank`'s device: "cuda" is cuda:<rank>, one card a rank; any
    other device is every rank's."""
    return f"cuda:{rank}" if device == "cuda" else device


def _write_job(job, path):
    with open(path, "wb") as f:
        pickle.dump(job, f)
    return path


def start_workers(nproc, job, tmpdir, torchrun=False):
    """Write the job (one a rank, its device resolved by rank_device; one
    for all under torchrun, which each rank resolves by its RANK) and
    start nproc workers (or one torchrun that starts them); returns the
    processes."""
    os.makedirs(tmpdir, exist_ok=True)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["OMP_NUM_THREADS"] = "1"
    port = free_port()
    me = os.path.abspath(__file__)
    if torchrun:
        job_path = _write_job(job, os.path.join(tmpdir, "job.pkl"))
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nnodes", "1", "--nproc-per-node", str(nproc),
               "--master-addr", "127.0.0.1", "--master-port", str(port),
               me, "-", "-", "-", job_path, tmpdir]
        return [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)]
    return [subprocess.Popen(
        [sys.executable, me, f"127.0.0.1:{port}", str(nproc), str(pid),
         _write_job(dict(job, device=rank_device(job["device"], pid)),
                    os.path.join(tmpdir, f"job{pid}.pkl")), tmpdir],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(nproc)]


def finish(procs, timeout):
    """Wait for every process (at most `timeout` seconds in all), kill
    those still running, and return [(returncode, stdout, stderr)]."""
    out = []
    try:
        for p in procs:
            try:
                o, e = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                o, e = p.communicate()
                e += f"\n[killed after {timeout} s]"
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def run_workers(nproc, cases, tmpdir, timeout=240.0, device="cpu",
                backend=None, pg_timeout=120.0, torchrun=False):
    """Run `cases` on nproc workers; every worker must exit 0.  device:
    every rank's, or "cuda" for cuda:<rank> (rank_device).  Returns one
    dict a rank: case name -> what the case returned, plus "_info"."""
    job = {"device": device, "backend": backend, "timeout": pg_timeout,
           "cases": cases}
    results = finish(start_workers(nproc, job, tmpdir, torchrun), timeout)
    for rc, o, e in results:
        assert rc == 0, f"worker failed ({rc}):\n{e[-4000:]}\n{o[-1000:]}"
    out = []
    for pid in range(nproc):
        with open(os.path.join(tmpdir, f"{pid}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ------------------------------------------------------------------ worker

def _default(device):
    """What a rank passes as device= to build on its own device: nothing on
    a card (core.default_device, the current card, which initialize set
    to the rank's), the CPU by name (the port has no CPU default)."""
    return None if device.type == "cuda" else device


def _form(case, device, dtype="float64"):
    """The case's form on `device`; with "default_device", built as
    _default says."""
    import torch
    from qcqp_tpu_torch.convert import form_from_numpy
    if case.get("default_device"):
        device = _default(device)
    return form_from_numpy(*case["arrays"], device=device,
                           dtype=getattr(torch, case.get("dtype", dtype)))


def _watch_payloads(mesh):
    """The devices of the tensors this mesh's collectives are handed."""
    seen, real = set(), mesh._count

    def count(kind, t):
        seen.add(str(t.device))
        real(kind, t)
    mesh._count = count
    return seen


def _mesh(case):
    from qcqp_tpu_torch.parallel import Mesh, make_mesh
    if "mesh" not in case:
        return make_mesh(axis=case.get("axis", "r"))
    return Mesh(case["mesh"])


def _np(t):
    return t.detach().cpu().numpy()


class _Spies:
    """The improve chain's output, and with `fused` (the kernels' route
    taken on CPU tensors, where the wrappers run their plain versions and
    count no launch) the counts of the K1, K3 and K4 wrappers' calls."""

    def __init__(self, fused):
        from qcqp_tpu_torch.kernels import admm_kernel, ccp_kernel
        from qcqp_tpu_torch.parallel import restarts, scenarios
        from qcqp_tpu_torch.solvers import coord_descent_fused as cdf
        self.calls = {"k1": 0, "k3": 0, "k4": 0}
        self.chain = []
        self.undo = []
        if fused:
            for mod in (restarts, scenarios):
                self._set(mod, "_fused_default", lambda form: True)
            for mod, name, key in ((cdf, "two_phase_sweeps", "k1"),
                                   (admm_kernel, "admm_phase", "k3"),
                                   (ccp_kernel, "ccp_improve", "k4")):
                self._wrap(mod, name, key)
        real_chain = restarts.improve_chain

        def chain(*a, **kw):
            out = real_chain(*a, **kw)
            self.chain.append(_np(out))
            return out
        self._set(restarts, "improve_chain", chain)

    def _set(self, mod, name, value):
        self.undo.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    def _wrap(self, mod, name, key):
        real = getattr(mod, name)

        def spy(*a, **kw):
            self.calls[key] += 1
            return real(*a, **kw)
        self._set(mod, name, spy)

    def close(self):
        for mod, name, value in reversed(self.undo):
            setattr(mod, name, value)


def _given_starts(starts):
    """Replace the draw of parallel/restarts.py by `starts` (the JAX
    package's numpy draw), as many rows as the solve asks for."""
    import torch
    from qcqp_tpu_torch.parallel import restarts
    real = restarts.suggest_batch

    def draw(form, num, *a, **kw):
        assert num == starts.shape[0], (num, starts.shape)
        return torch.from_numpy(starts).to(form.P)
    restarts.suggest_batch = draw
    return lambda: setattr(restarts, "suggest_batch", real)


def run_case(case, device):
    import torch
    from qcqp_tpu_torch.parallel import launch, mesh2d, scenarios
    from qcqp_tpu_torch.parallel import restarts
    kind, kw = case["kind"], case.get("kw", {})
    mesh = None if kind in ("distributed", "make_mesh_2d") else _mesh(case)
    if mesh is not None and mesh.coords is None:
        return {"in_mesh": False}
    out = {"in_mesh": True}
    if mesh is not None:
        out["coords"] = mesh.coords
        payloads = _watch_payloads(mesh)
    gen = torch.Generator(device=device).manual_seed(case.get("seed", 0))
    wrappers = _kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    if kind in ("restarts", "distributed"):
        form = _form(case, device)
        out["form_device"] = str(form.device)
        spies = _Spies(case.get("fused_cpu", False))
        undo = _given_starts(case["starts"]) if "starts" in case else None
        try:
            if kind == "restarts":
                x, f, v = restarts.solve_restarts(
                    form, case["R"], gen, mesh=mesh, **kw)
            else:
                x, f, v = launch.solve_restarts_distributed(
                    form, case["R"], gen, **kw)
                out["coordinator"] = launch.is_coordinator()
                out["world"] = launch.global_mesh().size
        finally:
            spies.close()
            if undo:
                undo()
        out.update(x=_np(x), f=_np(f), v=_np(v), calls=spies.calls,
                   shard=spies.chain[0] if spies.chain else None)
    elif kind == "admm_phase1":
        from qcqp_tpu_torch.parallel import admm_phase1_sharded
        form = _form(case, device)
        x0 = torch.from_numpy(case["x0"]).to(form.P)
        out["z"] = _np(admm_phase1_sharded(form, x0, mesh, axis="c", **kw))
    elif kind == "admm2d":
        form = _form(case, device)
        out["form_device"] = str(form.device)
        xs = torch.from_numpy(case["xs"]).to(form.P)
        out["xs"] = _np(mesh2d.improve_admm_2d(form, xs, mesh, **kw))
        out["calls"] = dict(mesh.calls)
    elif kind == "solve2d":
        form = _form(case, device)
        x, f, v = mesh2d.solve_restarts_2d(form, case["R"], gen, mesh, **kw)
        out.update(x=_np(x), f=_np(f), v=_np(v))
    elif kind in ("scenarios", "scenarios_sharded"):
        stacked = _form(case, device)
        S = stacked.P.shape[0]
        if kind == "scenarios":
            res = scenarios.solve_scenarios(stacked, case["R"], gen,
                                            mesh=mesh, **kw)
        elif "starts" in case:
            start, batch = scenarios.scenario_block(S, mesh)
            lo, hi = scenarios.block(case["starts"].shape[1],
                                     mesh.shape["r"], mesh.index("r"))
            local = scenarios.QCQPForm(*(a[start:start + batch]
                                         for a in stacked))
            xs = torch.from_numpy(case["starts"][start:start + batch,
                                                 lo:hi]).to(stacked.P)
            res = scenarios._sharded_from_starts(
                local, xs, mesh, "s", "r", case["starts"].shape[1], **kw)
        else:
            res = scenarios.solve_scenarios_sharded(stacked, case["R"], gen,
                                                    mesh, **kw)
        out.update(zip(("x", "f", "v"), (_np(t) for t in res)))
    elif kind == "scenarios_bank":
        # this rank's block of the bank, loaded onto the current card
        S = case["S"]
        start, batch = scenarios.scenario_block(S, mesh)
        local = scenarios.forms_from_bank(case["bank"], start, batch,
                                          dtype=torch.float32,
                                          device=_default(device))
        out["form_device"] = str(local.device)
        block, real = [], scenarios._improve_from_starts

        def improve(*a, **kw):
            block.append(real(*a, **kw))
            return block[-1]
        spies = _Spies(case.get("fused_cpu", False))
        scenarios._improve_from_starts = improve
        try:
            res = scenarios.solve_scenarios_sharded(
                local, case["R"], gen, mesh, num_scenarios=S, **kw)
        finally:
            scenarios._improve_from_starts = real
            spies.close()
        out.update(zip(("x", "f", "v"), (_np(t) for t in res)))
        out.update(scenarios=[start, start + batch], block=_np(block[0]),
                   calls=spies.calls)
    elif kind == "make_mesh_2d":
        mesh2d.make_mesh_2d(*case["shape"])
    else:
        raise ValueError(f"unknown case kind {kind}")
    out["launches"] = {k: w.launches for k, w in wrappers.items()}
    if mesh is not None:
        out.update(mesh_calls=dict(mesh.calls), mesh_bytes=dict(mesh.bytes),
                   payload_devices=sorted(payloads))
    return out


def _kernel_wrappers():
    """The wrappers of K1, K3 and K4, whose `launches` count the kernel's
    launches on CUDA tensors (none on the CPU)."""
    from qcqp_tpu_torch.kernels import admm_kernel, ccp_kernel
    from qcqp_tpu_torch.kernels import cd_sweep_kernel
    return {"k1": cd_sweep_kernel.two_phase_sweeps,
            "k3": admm_kernel.admm_phase, "k4": ccp_kernel.ccp_improve}


def main():
    coordinator, nproc, pid, job_path, outdir = sys.argv[1:6]
    import torch
    torch.set_num_threads(1)
    from qcqp_tpu_torch.parallel import launch
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    if coordinator == "-":              # started by torchrun
        device = launch.initialize(device=rank_device(
                                       job["device"],
                                       int(os.environ["RANK"])),
                                   backend=job["backend"],
                                   timeout=job["timeout"])
    else:
        device = launch.initialize(coordinator, int(nproc), int(pid),
                                   device=job["device"],
                                   backend=job["backend"],
                                   timeout=job["timeout"])
    pid = torch.distributed.get_rank()
    results = {"_info": {"pid": pid,
                         "world": torch.distributed.get_world_size(),
                         "coordinator": launch.is_coordinator(),
                         "device": str(device)}}
    try:
        for case in job["cases"]:
            if case.get("fail_on") == pid:
                raise RuntimeError(f"rank {pid} fails on purpose")
            expect = case.get("raises")
            try:
                t0 = time.perf_counter()
                results[case["name"]] = run_case(case, device)
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                # the case's host time, its first run (set-ups and the
                # groups' first collectives included)
                results[case["name"]]["seconds"] = time.perf_counter() - t0
            except Exception as e:          # noqa: BLE001
                if expect is None or expect not in type(e).__name__:
                    raise
                results[case["name"]] = {"raised": type(e).__name__,
                                         "message": str(e)}
        results["_info"]["jax_imported"] = "jax" in sys.modules
        with open(os.path.join(outdir, f"{pid}.pkl"), "wb") as f:
            pickle.dump(results, f)
    finally:
        launch.shutdown()
    print("RESULT " + json.dumps(results["_info"]), flush=True)


if __name__ == "__main__":
    main()
