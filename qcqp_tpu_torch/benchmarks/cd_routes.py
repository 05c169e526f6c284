"""The two CD routes side by side on one card: K1 (one launch) and the K2
route (mega=False: phase 1 through K2 once per coordinate, then the
unfused phase 2), on bench.py's form (dense random, half equalities,
seed 0) at each given (n, m), through solve_restarts from RANDOM starts.
No JAX counterpart: it measures the rule by which
solvers/coord_descent_fused.py picks K1 on the card.  Run on a machine
with a CUDA card:

    python -m qcqp_tpu_torch.benchmarks.cd_routes

at SHAPES, R restarts, K1 at K1_SWEEPS and the K2 route at K2_SWEEPS
sweeps.  Prints the card's name and power limit (nvidia-smi), then one
JSON line a shape: Pt's megabytes against the 50 MB L2, K1's launch
geometry, and for each route and sweep count the host ms of its solves
(K1: median of 3 after a warm-up; K2 route: one solve, after K1's
warm-up has built everything it shares), the best (f, v) and both
kernels' launches.
"""

import json
import subprocess
import time

import numpy as np

# (n, m): the n = 256 route of bench.py's large-n setting, P 5.5 MB inside
# the 50 MB L2, and n = 512, m = 50, P 53.5 MB past it
SHAPES = ((256, 20), (512, 50))
R = 10240
K1_SWEEPS = (2, 10)
K2_SWEEPS = (2,)               # a K2-route solve takes seconds a sweep


def bench_form(n, m, seed=0):
    """bench.py:39-46 at BENCH_N = n, BENCH_M = m, as numpy arrays."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    return P, q, r, rng.random(m) < 0.5


def measure(n, m, restarts, k1_sweeps, k2_sweeps, device=None):
    """The routes' times at one shape (module docstring), as a dict.  On
    the CPU (device="cpu", a check of the script) both routes run their
    plain versions and launch nothing."""
    import torch
    from ..convert import form_from_numpy
    from ..core import default_device
    from ..kernels import cd_sweep_kernel as k1
    from ..kernels import onevar_kernel as k2
    from ..parallel.restarts import solve_restarts
    device = default_device(device)
    form = form_from_numpy(*bench_form(n, m), device=device,
                           dtype=torch.float32)
    E = len(form.eq_idx())

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def solve(seed, sweeps, mega=None):
        gen = torch.Generator(device=device).manual_seed(seed)
        sync()
        t0 = time.perf_counter()
        _, f, v = solve_restarts(form, restarts, gen, num_iters=sweeps,
                                 use_fused=True, mega=mega)
        sync()
        return (time.perf_counter() - t0) * 1e3, float(f), float(v)

    def route(seeds, sweeps, mega):
        k1.two_phase_sweeps.launches = 0
        k2.phase1_coordinate_update.launches = 0
        runs = [solve(seed, sweeps, mega) for seed in seeds]
        return {"sweeps": sweeps, "ms": [r[0] for r in runs],
                "ms_median": float(np.median([r[0] for r in runs])),
                "best_f": runs[0][1], "best_viol": runs[0][2],
                "launches": {"k1": k1.two_phase_sweeps.launches,
                             "k2": k2.phase1_coordinate_update.launches}}
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device.type == "cuda" else None)
    out = {"n": n, "m": m, "E": E, "R": restarts,
           "Pt_mb": 4 * (m + 1) * n * n / 1e6,
           "k1_geometry": dict(zip(("warps_a_block", "floats_a_warp",
                                    "bytes_a_block"),
                                   k1.launch_geometry(n, m, E, restarts,
                                                      sms)))}
    solve(0, 1)                                        # warm-up
    out["k1"] = [route((1, 2, 3), s, None) for s in k1_sweeps]
    out["k2_route"] = [route((1,), s, False) for s in k2_sweeps]
    return out


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    for n, m in SHAPES:
        print(json.dumps(measure(n, m, R, K1_SWEEPS, K2_SWEEPS)), flush=True)


if __name__ == "__main__":
    main()
