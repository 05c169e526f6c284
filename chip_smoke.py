#!/usr/bin/env python3
"""GPU smoke run of the qcqp_tpu_torch main path (run: `python3 chip_smoke.py`
from the repository root, on a machine with one NVIDIA H100 and the CUDA
toolkit).

Phases, each printing one JSON line; any failed check raises, so the script
exits non-zero.  nvcc builds the kernels from qcqp_tpu_torch/csrc in a
thread at the start, while the three longest plain-version runs, which
launch no kernel, go first (`plain_runs`: the plain versions that phases
5, 10 and 11 hold K1 and K4 against, K4's wide case included):

  1. device    the card (nvidia-smi name and power limit), torch and CUDA
               versions, the build time and ptxas' report;
  2. k2        K2 (csrc/onevar_phase1.cu, one warp per restart) against
               its plain PyTorch version on the card, generic and split
               (with the bench form's equality rows), m = 50, R = 10,240,
               both timed, then on the recipes of
               tests/test_onevar_pallas.py and on K2_SHAPES (rows across
               32 and 64, E = 0 and m, R = 1, 33 and 300, and m = E =
               4,900, whose rows live in global memory); every lane must
               equal the plain version's bit for bit (-fmad=false on both
               sides); ptxas' registers, stack and spills of K2;
  3. k1        K1 (csrc/cd_sweep.cu, one warp per restart) against its
               plain version on the bench form (n = 100, m = 50, seed 0),
               R = 1,024 numpy starts, 1 sweep, and on boolean least
               squares (where phase 2 runs), 10 sweeps: identity at
               num_iters=0, every lane bit for bit equal to the plain
               version's, the statistical margins of
               tests/test_cd_sweep_pallas.py:104-110, and restart-permutation
               invariance of the kernel's per-lane output; then
               two_phase_sweeps (and phase1_sweeps where n <= 9) on
               K1_SHAPES (m + 1 and m + E on both sides of 32 and 64,
               n = 1 at m = 1,278, n = 128 at m = 78, n = 8 at m = 300,
               R = 1 and 300) and on two forms that force ties in phase
               2's select, every lane bit for bit; then above n = 128, on
               K1_WIDE_SHAPES (n = 129 and 256, m + 1 and m + E on both
               sides of 32, and (128, 79)) at R = 300 and R = 1, 1 sweep,
               against plain-version runs that a process of their own
               made on the card while the kernels were built
               (`--k1-wide`); ptxas' registers, stack and spills of K1,
               and its shared memory at the main path's shape;
  4. golden    boolean least squares through the modeling layer and
               QCQP(prob).solve(256 restarts, 50 sweeps), which defaults to
               CUDA float32: the
               brute-force optimum 35.551 within 2e-2 at violation < 1e-2,
               through K1;
  5. main_path solve_restarts on the bench form, R = 10,240, 10 sweeps,
               RANDOM starts from a seeded torch.Generator: K1's route
               (default; one launch a solve, 4 restarts a block) and K2's
               route (mega=False), times, restarts/s, best (f, v) and
               launch counts; then K1 alone (twice) and its plain version
               on the first solve's starts at the same shape: K1 must give
               that solve's best point and equal the plain version bit for
               bit (and within the margins above); the restart-sweeps and
               probes the plain version counts there size K1's bound;
  6. k2_route the CD route above n = 128: bench.py's form at BENCH_N=256,
               BENCH_M=20 (seed 0) through solve_restarts at R = 10,240,
               10 sweeps, with no mega= argument, so that the card's rule
               (K1 wherever its shared memory holds a restart) sends it
               to K1: a warm-up and 3 timed solves, restarts/s, best
               (f, v), one K1 launch and no K2 launch a solve; K1 alone on
               the first timed solve's starts, which must give that
               solve's best point (phase 3 holds K1 on their first 300 at
               1 sweep against its plain version, every lane bit for
               bit); K1's bound from its plain version's counts on
               128 of those starts at 10 sweeps (a CPU process started at
               the beginning, `--k1-route-sample`), scaled; then the K2
               route through mega=False: one timed solve of
               K2_ROUTE_SWEEPS sweeps (K2 n times a sweep, no K1), K2
               alone on one of its launches against its plain version and
               timed, and the route at R = 256, 1 sweep, every restart
               bit for bit against the same route with K2's plain
               version in K2's place (swapped in this script only); both
               routes' ms side by side;
  7. k3        K3 (csrc/admm_impl.cuh, one warp per restart) against its
               plain version on the card, phase by phase, every lane bit
               for bit: the bench form, R = 1,024 numpy starts, 50
               iterations (phase 1, phase 2 after phase 1's better-fold,
               phase 2 alone as with phase1=False); boolean least squares
               (semidefinite rows: the bracket doubling runs); the
               wide-root instance of tests/test_admm_pallas.py (violation
               < 1e-2 after the rescue jumps); identity at num_iters=0 and
               restart-permutation invariance; then K3_SHAPES (n across
               the lanes' 32-coordinate chunks, the whole-slab limit 160
               and 161, where Q_i is streamed in chunks, and 1,024; m = 1
               and 50; R = 1, 300 and a full block plus one; need_dbl on
               and off); ptxas' registers, stack and spills of K3 and its
               launch geometry on the ADMM path;
  8. admm_path solve_restarts(improve=ADMM, num_iters=50) on the bench form
               at R = 1,024 and 10,240 from a seeded torch.Generator: ms
               per solve (2 after a warm-up), restarts/s, best (f, v), K3's
               launch count and the host set-up time; then, at each R, K3
               alone and its plain version on the first timed solve's
               starts, both timed: K3 must give that solve's best point
               and equal the plain version bit for bit on every lane;
  9. admm_golden  boolean least squares through QCQP(prob): RANDOM, CD,
               then ADMM(phase1=False) through K3
               (examples/boolean_least_squares.py:45-47 with RANDOM in
               place of SDR), no worse than CD's point under `better` and
               bit for bit equal to the plain version on that restart;
               QCQP.solve(256 restarts, improve=ADMM) through K3 reaches
               violation < 1e-2; a rho below the minimum raises;
 10. k4        K4 (csrc/ccp_impl.cuh, built as ccp_narrow.cu and
               ccp_wide.cu) against its plain version on the card, every
               lane bit for bit, with equal trip counts: the bench form at
               R = 128 (bench.py:240) at the fused defaults, on the starts
               of the DCCP path's first timed solve at that R, and K4's ms
               per inner trip of the busiest tile; identity at
               max_iter=0; a ragged R = 100; lanes permuted inside a tile
               and whole tiles swapped; the boolean-LS instance of
               tests/test_ccp_pallas.py:44-74 (>= 6 of 8 restarts
               feasible); the wide instantiation at n = 150, m = 3,
               R = 130 (4 x 5 trips); ptxas' registers, spills and stack of
               both instantiations;
 11. ccp_path  solve_restarts(improve=DCCP) on the bench form at R = 128 and
               10,240 from a seeded torch.Generator: ms per solve (after
               a warm-up, 1 solve at each R),
               restarts/s, best (f, v), K4's launch count and the host
               set-up time; then K4 alone on the first timed solve's
               starts, which must give that solve's best point
               (phase 10 held every lane of the R = 128 starts; at 10,240
               tiles 0, 1 and the last are held against the plain version
               bit for bit), the bound from the trips K4 ran and K4's ms
               per inner trip of the busiest tile;
 12. ccp_golden  QCQP(prob).improve(DCCP) on sum_squares(x) s.t.
               square(x) == 1 through K4 (one launch, violation < 1e-2,
               equal to the plain version); QCQP.solve(256 restarts,
               improve=DCCP) on boolean least squares through K4 (one
               launch, violation < 1e-2, objective at most 39.92, the
               plain version's on the CPU; the brute-force optimum is
               35.551).
 13. k5        K5 (csrc/eigh_jacobi.cu: only the real n0 x n0 block,
               through a host-built schedule of real pairs) against its
               plain version on the card, eigenvalues and eigenvectors bit
               for bit: B = 16 at n0 = 24, B = 132 at n0 = 101, a ragged
               B = 5 at n0 = 16 and B = 2 at n0 = 200 (the global-memory
               code), at 8 and 2 sweeps, and round counts that are no
               multiple of n - 1; the storages' edges at one sweep (n0 =
               1, 25, 32, 33, 64, 65, 128, 129, 169, 170; B = 132, 301 and
               1,001 at n0 = 25, one warp a matrix, several a block, a
               ragged last block) and the S = 16 bank's B = 16, n0 = 25 at
               2; at 8 sweeps both wrappers against LAPACK (1e-4 of
               the scale, tests/test_eigh_pallas.py:31-37) and eigh_jacobi
               against its matmul plain version; ptxas' registers and
               spills of every instantiation; the times of K5, its plain
               version and torch.linalg.eigh at B = 1 and 132, n0 = 101,
               and B = 16, n0 = 25, 2 sweeps; the NaN that K5 and its
               plain version return for a matrix with one infinite entry
               (a stated deviation: fewer in K5's until both are NaN
               everywhere);
 14. sdr_path  the n = 100 boolean-least-squares SDR (bench.py:287-305):
               the default float32 route (Newton-Schulz) through
               solve_sdr(device="device"), which must pass the acceptance
               gate; the vec route's first 20 iterations bit for bit
               against the same loop with K5's plain version; then, with
               K5's count set to 0, solve_sdr_batch(psd_method="vec",
               fallback=False) on the S = 16, n = 24 bank of
               bench.py:337-355 (its first 20 iterations also bit for bit)
               and on S = 132 drifted n = 100 instances: ms, iterations/s,
               K5 launches, accept rate, worst residual.  No float64
               re-solve runs in this phase;
 15. sdr_golden  one solve_sdr_batch(psd_method="vec") with its float64
               fallback on the S = 16 bank, whose counter must rise once
               per instance the gate rejects (the SDR goldens moved to
               phase 16, where the examples solve the same relaxations);
 16. tooling   the JAX package's examples and diagnostics on the card
               (qcqp_tpu_torch/examples, diagnostics.py): (a) the five
               examples through main() on the default device (CUDA
               float32), their printed lines captured: the SDR goldens
               28.750, 57.207, 5.000 and 1.970 within 2e-2, each accepted
               on the first float32 attempt with no float64 re-solve (the
               splitting loop's iterations, residuals and masked tail
               reported), the sampler on the card; boolean least squares'
               best of 256 SDR restarts through K1 within 2e-2 of 35.550;
               the beamforming DCCP through K4 at violation
               < BEAMFORMING_DCCP_VIOL and f <= 2.5; every (f, v)
               finite; K1, K3 and K4 launched by each example whose chain
               reaches them; the serving example (S = 8, n = m = 12:
               bank write, forms_from_bank, solve_sdr_batch,
               solve_scenarios in one K1 launch; every violation < 1e-2
               and every objective at least its SDR bound - 1e-3) is
               phase 19's (a); (b) cd_trace (2 sweeps), admm_trace (200
               iterations) and ccp_trace (3 outers) on the bench form
               from one numpy start, cd_trace on boolean least squares,
               sdp_trace on phase 14's n = 100 SDR form (300
               iterations), in float32: ADMM's and the SDP's held
               against the CPU's float32 trace from the same start
               (TRACE_RTOL; made by a CPU process started at the
               beginning, `--cpu-traces`), CD's and CCP's to the
               properties of tests/test_aux.py; (c) torch_profile
               around one K1 solve
               (R = 10,240) and one K3 ADMM solve (R = 1,024, 50
               iterations): the trace JSON parses and lists as many
               kernel events as the wrappers counted launches; timed
               around one K1 solve reads at least its CUDA-event time;
 17. spectral  QCQP(prob).suggest(SPECTRAL) on boolean least squares
               (phase 4's problem) in float32 on the card: the route
               (first attempt, ns_steps=20 retry or float64 re-solve),
               each splitting loop's iterations and residuals, ms and
               bound, which must be finite, at most phase 16's SDR bound
               and within 2e-2 of the JAX package's float64 bound (a
               literal); then solve_restarts(256, suggest=SPECTRAL,
               improve=COORD_DESCENT) from the handler's point, one K1
               launch (its count set to 0 before, read after);
 18. nlp_path  improve_nlp (the IPOPT improve) on the bench form in
               float32, RANDOM starts, at R = 128 and 10,240: a short
               warm-up and 1 timed improve at each R, ms, restarts/s,
               best (f, v),
               the share of lanes at violation < 1e-3, the lanes whose
               violation overflowed, Newton trips and host reads a
               solve; in turns, the Armijo loop with a host read a trip
               in place of the masked one, equal bit for bit; 16 starts
               in float64 on the card against the CPU, lane by lane, at a
               short schedule where the CPU's lanes are determined; the
               handler's improve(IPOPT) on boolean least squares at
               violation < 1e-4.
 19. scenarios the scenario serving path (qcqp_tpu_torch/parallel/
               scenarios.py) in float32: (a) examples/scenario_serving.py
               at its own size, run in phase 16 through
               qcqp_tpu_torch.examples.scenario_serving.main (S = 8
               boolean least-squares instances, n = m = 12): bank write,
               forms_from_bank, solve_sdr_batch on its default route,
               solve_scenarios with 64 restarts through one K1 launch,
               every violation < 1e-2 and every objective at least its
               SDR bound - 1e-3; (b) the serving
               size: S = 132 bench forms (n = 100, m = 50, instance s
               from seed s, its own equality pattern) as a float64 bank
               (about 539 MB, in a temporary directory), loaded back in
               two forms_from_bank halves (MB/s of the write and of the
               load), R = 64 a scenario, 10 sweeps: a warm-up and 3 timed
               solve_scenarios (one K1 launch each), scenario-restarts/s,
               the best (f, v) summary and the share feasible; K1's
               stacked launch alone on the first timed solve's starts
               against the loop of 132 single-form launches, every lane
               bit for bit, both timed, and its bound from the
               restart-sweeps and probes K1's plain version counts on
               scenarios 0 and 1 (a CPU process started at the
               beginning, `--k1-sample`), scaled to the grid; (c)
               improve=ADMM and improve=DCCP (max_iter=6) on the first 4
               scenarios, each equal to solve_restarts on its form from
               the same starts, bit for bit, K3 launched twice a scenario
               (its two phases) and K4 once.
 20. distributed the distributed module (qcqp_tpu_torch/parallel/) on the
               one card, each rank a process of its own (`python3
               chip_smoke.py --dist-worker SPEC`, all three started
               together once the kernels are built, their output in files
               of the work directory): (a) an NCCL world of one on cuda:0,
               solve_restarts over global_mesh() on the main path's form,
               R = 10,240, 10 sweeps: a warm-up and 3 timed solves in turns
               with the same solve without a mesh, one K1 launch each, the
               first equal to phase 5's first solve bit for bit, and the
               cross-rank collective timed alone; (b) two gloo ranks, both
               on cuda:0: CD (3 timed solves, K1), ADMM at R = 1,024, 50
               iterations (K3) and DCCP at R = 128, max_iter=6 (K4, one
               64-lane tile a rank) sharded over make_mesh(), each rank's
               block equal to those rows of the one-process chain bit for
               bit and the best point to the one-process solve's (CD's
               also to (a)); solve_scenarios_sharded on an (s = 2, r = 1)
               mesh, each rank loading its 66 scenarios of phase 19's
               bank, one K1 launch over 66 x 64 lanes, all 132 results on
               both ranks equal to phase 19's first timed solve bit for
               bit; solve_restarts_2d on an (r = 1, c = 2) mesh, R = 1,024,
               50 iterations, one all_reduce an iteration, its best point
               the same on both ranks, in quality parity with
               improve_admm_batch on the same starts (tests/test_mesh2d.py:
               38-45 and 100-101); every rank's collectives (Mesh.calls
               and Mesh.bytes) equal to the analytic inventory: one
               all_gather of n + 3 float32 numbers a solve for the best
               point, and one all_reduce of (R / nr) x n float32 numbers
               an iteration for the 2-D ADMM.  Two ranks time-slicing one
               card give no scaling figure: their times are what they are.

Then the seconds each phase took, the card's line from nvidia-smi, the
kernels' JSON line (time, plain time, bound and launches of each kernel),
and the result line {"ok": true, "device": {...}}.  Without a CUDA device,
or outside a checkout of the repository, it fails before printing anything.

`python3 chip_smoke.py --profile` adds, before those last lines, a
torch.profiler breakdown of one solve per route (CD through K1 and through
K2 at R = 10,240, with K2's share of the device time; phase 6's n = 256
form through K1, and through K2 with its phase 1 alone beside the whole
improve; ADMM
through K3 at R = 1,024 and 10,240; DCCP through K4 at R = 128 and
10,240; the n = 100 SDR's Newton-Schulz and vec routes, 200 iterations
each; the NLP improve at R = 128 and 10,240): kernel time by kernel
name, against the unprofiled solve's wall time; then K1's time at
R = 256 ... 40,960 restarts.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

N, M, R_MAIN, SWEEPS = 100, 50, 10240, 10     # bench.py:24-27
R_K1_CHECK, K1_CHECK_SWEEPS = 1024, 1
R_K3_CHECK, ADMM_ITERS = 1024, 50             # bench.py:209-210
R_ADMM = (1024, 10240)                        # bench.py's ADMM shape; 10^4
ADMM_REPEATS = 2                              # timed solves per R
R_ADMM_GOLDEN = 256
R_CCP = (128, 10240)                          # bench.py:240; 10^4
CCP_REPEATS = {128: 1, 10240: 1}              # timed solves per R
R_CCP_GOLDEN, CCP_GOLDEN_F_MAX = 256, 39.92


def emit(obj):
    print(json.dumps(obj), flush=True)


def bench_form_arrays(seed=0, n=N, m=M):
    """The bench.py:39-46 problem (dense random, half equalities) at
    bench.py's BENCH_N = n, BENCH_M = m."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    is_eq = rng.random(m) < 0.5
    return P, q, r, is_eq


def boolean_ls_data(n=10, m=15):
    """The data of examples/boolean_least_squares.py (seed 1)."""
    rs = np.random.RandomState(1)
    return rs.randn(m, n), rs.randn(m, 1).ravel()


def bls_arrays(A, b):
    """min ||A x - b||^2 s.t. x_i^2 == 1 as (P, q, r, is_eq) arrays."""
    n = A.shape[1]
    P = np.zeros((n + 1, n, n))
    P[0] = A.T @ A
    i = np.arange(n)
    P[1 + i, i, i] = 1.0                      # x_i^2 == 1
    q = np.zeros((n + 1, n))
    q[0] = -2.0 * A.T @ b
    r = -np.ones(n + 1)
    r[0] = float(b @ b)
    return P, q, r, np.ones(n, bool)


def boolean_ls_arrays():
    """examples/boolean_least_squares.py as (P, q, r, is_eq) arrays."""
    return bls_arrays(*boolean_ls_data())


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, by CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn):
    """Wall time of one fn() that ends in a device synchronize."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def phase_device():
    import torch
    from qcqp_tpu_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.library()
    ptxas = [ln.strip() for ln in _build.BuildInfo.log.splitlines()
             if "registers" in ln or "spill" in ln]
    print("\n".join(ptxas), file=sys.stderr, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_name": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "build_seconds": _build.BuildInfo.seconds,
          "library": os.path.relpath(_build.BuildInfo.path, REPO)})
    return smi


def _viol_of(p, q, r, eq, act, x):
    val = p * x ** 2 + q * x + r
    vi = np.where(eq, np.abs(val), np.maximum(val, 0.0))
    return np.where(act, vi, 0.0).max(axis=0)


def _k2_rows(seed, m, R, eq_frac=0.5, row_eq=False, eq_row=None, e=None):
    """Random rows for K2; eq_row fixes the static equality pattern, e
    the number of equality rows (placed at random)."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((m, R)).astype(np.float32)
    q = rng.standard_normal((m, R)).astype(np.float32)
    r = rng.standard_normal((m, R)).astype(np.float32)
    if e is not None:
        eq_row = np.zeros(m, bool)
        eq_row[rng.permutation(m)[:e]] = True
    if row_eq:
        if eq_row is None:
            eq_row = rng.random(m) < eq_frac
        eq = np.ascontiguousarray(np.broadcast_to(eq_row[:, None], (m, R)))
        eq_idx = tuple(int(i) for i in np.nonzero(eq_row)[0])
    else:
        eq = rng.random((m, R)) < eq_frac
        eq_idx = None
    act = rng.random((m, R)) < 0.9
    xk = rng.standard_normal(R).astype(np.float32)
    viol = _viol_of(p, q, r, eq, act, xk).astype(np.float32)
    return (p, q, r, eq, act, xk, viol), eq_idx


# K2 beyond the main path's shapes (variant, m, E, R): rows (2m generic,
# m + E split) on both sides of 32 and 64 (lane l owns rows l mod 32),
# E = 0 and E = m, ragged R (1, 33, 300: no multiple of a block's 4
# warps), and one m whose warp slice exceeds a block's 227 KB of shared
# memory (m + E = 9,800 rows: the global-memory code), at a small R.
K2_SHAPES = [("generic", 15, None, 300), ("generic", 16, None, 33),
             ("generic", 17, None, 1), ("generic", 31, None, 300),
             ("generic", 32, None, 1), ("generic", 33, None, 33),
             ("split", 31, 0, 300), ("split", 16, 16, 33),
             ("split", 20, 13, 1), ("split", 63, 0, 33),
             ("split", 32, 32, 300), ("split", 40, 25, 300),
             ("split", 4900, 4900, 2)]


def k2_bound(probes, m, e, nbytes):
    """K2's bound by the formula of the kernels line: C_ROW operations per
    row (m + E) per probe, the inputs read once and v written once."""
    return bound(probes * (m + e) * C_ROW, nbytes)


def k2_check(args, kw, timed=False):
    """K2 against its plain version on the card, every lane bit for bit
    (-fmad=false on both sides, as tests/test_torch_gpu.py); with timed,
    both timed by CUDA events.  Returns the lanes, the probes the plain
    version made and the bytes K2 must move."""
    import torch
    from qcqp_tpu_torch.kernels.onevar_kernel import (
        bisect_accept, phase1_coordinate_update, phase1_coordinate_update_ref)
    v_k = phase1_coordinate_update(*args, **kw)
    bisect_accept.probes = 0
    v_p = phase1_coordinate_update_ref(*args, **kw)
    probes = int(bisect_accept.probes)
    torch.cuda.synchronize()
    v_k, v_p = v_k.cpu().numpy(), v_p.cpu().numpy()
    diff = np.abs(v_k - v_p)
    n_diff = int((v_k.view(np.int32) != v_p.view(np.int32)).sum())
    if n_diff:
        raise AssertionError(
            f"K2 disagrees with its plain version on {n_diff} of "
            f"{len(v_k)} lanes, max |dv| {float(diff.max())}")
    # the split variant reads the equality rows through its int32 list and
    # never reads is_eq
    eq_idx = kw.get("eq_idx")
    read = args if eq_idx is None else args[:3] + args[4:]
    nbytes = (sum(a.numel() * a.element_size() for a in read)
              + (0 if eq_idx is None else 4 * len(eq_idx)) + 4 * len(v_k))
    out = {"lanes_identical": len(v_k), "max_abs_dv": float(diff.max()),
           "moved": int((v_k != args[5].cpu().numpy()).sum()),
           "probes": probes, "bytes": nbytes}
    if timed:
        out["ms"] = cuda_ms(lambda: phase1_coordinate_update(*args, **kw), 5)
        out["plain_ms"] = cuda_ms(
            lambda: phase1_coordinate_update_ref(*args, **kw), 2)
    return out


def phase_k2(bench_is_eq):
    import torch
    from qcqp_tpu_torch.kernels.onevar_kernel import launch_geometry

    def run(arrays, eq_idx, timed=False):
        args = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                for a in arrays]
        return k2_check(args, {"eq_idx": eq_idx}, timed)

    gen_arrays, _ = _k2_rows(11, M, R_MAIN)
    generic = run(gen_arrays, None, timed=True)
    # the split variant with the bench form's equality rows, as the
    # mega=False route of the main path calls it
    split_arrays, split_idx = _k2_rows(12, M, R_MAIN, row_eq=True,
                                       eq_row=bench_is_eq)
    split = run(split_arrays, split_idx, timed=True)
    recipes = []
    for seed in range(6):                      # test_onevar_pallas.py:39-54
        recipes.append(run(*_k2_rows(seed, 7, 256)))
    for k, eq_frac in enumerate((0.0, 0.4, 1.0)):   # :76-97
        arrays, idx = _k2_rows(100 + k, 9, 128, eq_frac, row_eq=True)
        recipes.append(run(arrays, idx))
        recipes.append(run(arrays, None))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = []
    for k, (variant, m, e, R) in enumerate(K2_SHAPES):
        t0 = time.perf_counter()
        arrays, idx = _k2_rows(200 + k, m, R, row_eq=variant == "split",
                               e=e)
        res = run(arrays, idx)
        warps, warp_floats, _, gmem = launch_geometry(
            m, e or 0, variant == "split", R, sms)
        shapes.append({"variant": variant, "m": m, "E": e, "R": R,
                       "rows": m + e if variant == "split" else 2 * m,
                       "warps_a_block": warps,
                       "bytes_a_warp": 4 * warp_floats,
                       "global_rows": gmem,
                       **{k: res[k] for k in ("lanes_identical", "moved",
                                              "probes")},
                       "seconds": time.perf_counter() - t0})
    if not any(s["global_rows"] for s in shapes):
        raise AssertionError("no K2 shape ran the global-memory rows")
    worst = max(r["max_abs_dv"] for r in [generic, split] + recipes)
    E = len(split_idx)
    emit({"phase": "k2", "m": M, "R": R_MAIN, "generic": generic,
          "split": split,
          "recipes_lanes_identical": sum(r["lanes_identical"]
                                         for r in recipes),
          "shapes": shapes, "max_abs_dv": worst,
          "ptxas": _ptxas("phase1_kernel"),
          "geometry_at_split_shape": dict(zip(
              ("warps_a_block", "floats_a_warp", "shared_bytes_a_block",
               "global_rows"),
              launch_geometry(M, E, True, R_MAIN, sms)))})
    return {"max_abs_err": worst, "ms": split["ms"],
            "plain_ms": split["plain_ms"],
            "shape": f"m={M}, E={E}, R={R_MAIN} (split)",
            **k2_bound(split["probes"], M, E, split["bytes"])}


# The CD route above n = 128: bench.py's form at BENCH_N=256, BENCH_M=20,
# through K1 by the card's rule, and through K2 with mega=False.
N_K2, M_K2 = 256, 20
R_K2_CHECK, K2_CHECK_SWEEPS = 256, 1
K2_ROUTE_SWEEPS = 2             # the K2 route's timed solve's sweeps


def phase_k2_route(arrays, sample):
    """solve_restarts on the n = 256, m = 20 form at R = 10,240: with no
    mega= argument a warm-up and 3 timed solves of SWEEPS sweeps, one K1
    launch and no K2 launch each; K1 alone on the first timed solve's
    starts, which must give that solve's best point; K1's bound from the
    `--k1-route-sample` counts.  Then with mega=False one timed solve of
    K2_ROUTE_SWEEPS sweeps (no K1, K2 n times a sweep), K2 alone on the
    inputs of one of its launches (coordinate n/2 of the first sweep)
    against its plain version and timed, and the route at R = 256,
    K2_CHECK_SWEEPS sweeps, every restart bit for bit against the same
    route with K2's plain version in K2's place (swapped here only).  K1
    on these starts against its plain version is phase k1's last case."""
    import torch
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels import onevar_kernel as k2
    from qcqp_tpu_torch.kernels.cd_sweep_kernel import (holds,
                                                        two_phase_sweeps)
    from qcqp_tpu_torch.parallel.restarts import (best_point, solve_restarts,
                                                  suggest_batch)
    from qcqp_tpu_torch.solvers import coord_descent_fused as fused
    form = form_from_numpy(*arrays, device="cuda", dtype=torch.float32)
    eq_idx = form.eq_idx()
    E = len(eq_idx)
    if not holds(N_K2, M_K2, E):
        raise AssertionError("the n = 256 form would not take K1's route")

    def solve(seed, sweeps=SWEEPS, **kw):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return solve_restarts(form, R_MAIN, gen, num_iters=sweeps, **kw)

    def launches():
        return {"k1": two_phase_sweeps.launches,
                "k2": k2.phase1_coordinate_update.launches}

    def finite(results, name):
        for (x, f, v) in results:
            if not (torch.isfinite(x).all() and x.shape == (N_K2,)
                    and bool(torch.isfinite(f)) and bool(torch.isfinite(v))):
                raise AssertionError(f"the {name} returned a non-finite "
                                     "point")

    solve(0)                                            # warm-up
    two_phase_sweeps.launches = k2.phase1_coordinate_update.launches = 0
    times, results = [], []
    for seed in (1, 2, 3):
        ms, res = host_ms(lambda: solve(seed))
        times.append(ms)
        results.append(res)
    k1_counts = launches()
    finite(results, "K1 route")
    if k1_counts != {"k1": 3, "k2": 0}:
        raise AssertionError(f"n = 256 default route launch counts "
                             f"{k1_counts}")
    xs = route_starts(R_MAIN)
    if not torch.equal(xs, suggest_batch(form, R_MAIN, torch.Generator(
            device="cuda").manual_seed(1))):
        raise AssertionError("route_starts is not solve_restarts' draw")

    def k1_alone():
        return two_phase_sweeps(form.P, form.q, form.r, eq_idx, xs,
                                num_iters=SWEEPS)
    ms_k1_a, x_k1 = host_ms(k1_alone)
    ms_k1_b, _ = host_ms(k1_alone)
    if not all(torch.equal(a, b) for a, b in zip(best_point(form, x_k1),
                                                  results[0])):
        raise AssertionError("K1 on the first solve's starts does not give "
                             "that solve's best point")
    report = sample.communicate(timeout=600)[0]
    if sample.returncode != 0:
        raise AssertionError(f"the K1 route sample process exited "
                             f"{sample.returncode}")
    counts = json.loads(report.splitlines()[-1])
    scale = R_MAIN / counts["R"]
    ops = scale * (counts["lane_sweeps"] * (
        (M_K2 + 1) * (2 * N_K2 * N_K2 + 2 * N_K2) + N_K2 * 2 * (M_K2 + 1)
        * N_K2) + counts["probes"] * (M_K2 + E) * C_ROW)
    nbytes = 4 * ((M_K2 + 1) * N_K2 * N_K2 + (M_K2 + 1) * N_K2 + (M_K2 + 1)
                  + 2 * R_MAIN * N_K2)
    k1_bound = bound(ops, nbytes)

    # the K2 route (mega=False), K2 captured at one of its launches
    kernel, captured = fused.phase1_coordinate_update, []

    def capture(*args, **kw):
        if len(captured) == N_K2 // 2:
            captured.append(([t.clone() for t in args], kw))
        else:
            captured.append(None)
        return kernel(*args, **kw)
    fused.phase1_coordinate_update = capture
    two_phase_sweeps.launches = k2.phase1_coordinate_update.launches = 0
    try:
        ms_k2route, res_k2 = host_ms(lambda: solve(1, K2_ROUTE_SWEEPS,
                                                   mega=False))
    finally:
        fused.phase1_coordinate_update = kernel
    k2_counts = launches()
    finite([res_k2], "K2 route")
    if k2_counts["k1"] != 0 or k2_counts["k2"] < N_K2:
        raise AssertionError(f"mega=False route launch counts {k2_counts}")
    args, kw = captured[N_K2 // 2]
    alone = k2_check(args, kw, timed=True)

    xs = suggest_batch(form, R_K2_CHECK,
                       torch.Generator(device="cuda").manual_seed(4))
    before = k2.phase1_coordinate_update.launches
    x_k = fused.improve_coord_descent_fused(form, xs, mega=False,
                                            num_iters=K2_CHECK_SWEEPS)
    check_launches = k2.phase1_coordinate_update.launches - before
    fused.phase1_coordinate_update = k2.phase1_coordinate_update_ref
    try:
        x_p = fused.improve_coord_descent_fused(form, xs, mega=False,
                                                num_iters=K2_CHECK_SWEEPS)
    finally:
        fused.phase1_coordinate_update = kernel
    xk_, xp_ = x_k.cpu().numpy(), x_p.cpu().numpy()
    same = (xk_.view(np.int32) == xp_.view(np.int32)).all(axis=1)
    if not same.all() or check_launches < N_K2:
        raise AssertionError(
            f"the K2 route at R = {R_K2_CHECK} differs from its run with "
            f"K2's plain version on {int((~same).sum())} restarts "
            f"({check_launches} K2 launches)")

    ms_route = float(np.median(times))
    b = k2_bound(alone["probes"], M_K2, E, alone["bytes"])
    emit({"phase": "k2_route", "n": N_K2, "m": M_K2, "E": E, "R": R_MAIN,
          "k1_route": {"sweeps": SWEEPS, "ms_per_solve": times,
                       "restarts_per_s": R_MAIN / ms_route * 1e3,
                       "best_f": float(results[0][1]),
                       "best_viol": float(results[0][2]),
                       "launches": k1_counts,
                       "k1_alone_ms": [ms_k1_a, ms_k1_b],
                       "k1_sample": counts, **k1_bound},
          "k2_route_mega_false": {
              "sweeps": K2_ROUTE_SWEEPS, "ms_per_solve": ms_k2route,
              "restarts_per_s": R_MAIN / ms_k2route * 1e3,
              "best_f": float(res_k2[1]), "best_viol": float(res_k2[2]),
              "launches": k2_counts,
              "k2_alone": {"coordinate": N_K2 // 2, **alone, **b},
              "vs_plain": {"R": R_K2_CHECK, "sweeps": K2_CHECK_SWEEPS,
                           "restarts_identical": int(same.sum()),
                           "k2_launches": check_launches,
                           "moved": int((x_k != xs).any(dim=1).sum())}},
          "ms_per_solve_side_by_side": {
              f"k1, {SWEEPS} sweeps": ms_route,
              f"k2 (mega=False), {K2_ROUTE_SWEEPS} sweeps": ms_k2route}})
    return {"k1": {"launches": k1_counts["k1"], "ms": (ms_k1_a + ms_k1_b) / 2,
                   "ms_per_solve": ms_route, "bound_ms": k1_bound["bound_ms"],
                   "bound_by": k1_bound["bound_by"],
                   "bound_from": f"sampled: K1's plain version on the CPU, "
                                 f"{counts['R']} of {R_MAIN} starts, scaled",
                   "shape": f"n={N_K2}, m={M_K2}, E={E}, R={R_MAIN}, "
                            f"{SWEEPS} sweeps"},
            "launches": k2_counts["k2"],
            "ms": alone["ms"], "max_abs_err": alone["max_abs_dv"],
            "plain_ms": alone["plain_ms"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"], "ms_per_solve": ms_k2route,
            "shape": f"n={N_K2}, m={M_K2}, E={E}, R={R_MAIN} (split)"}


def _viols_objs(P, q, r, is_eq, xs):
    xs = xs.astype(np.float64)
    # one matrix product per row of the form: 30x faster on the host than
    # the single three-operand einsum at R = 10,240
    f = (np.stack([np.einsum("ri,ri->r", xs @ Pk, xs) for Pk in P], axis=1)
         + xs @ q.T + r)
    v = f[:, 1:]
    viol = np.where(is_eq, np.abs(v), np.maximum(v, 0.0))
    return (viol.max(axis=1) if viol.shape[1] else np.zeros(len(xs)),
            f[:, 0])


def _k1_agrees(name, xk, xp):
    """K1 against its plain version: every lane bit for bit (-fmad=false
    on both sides).  Returns the lane count and max |dx| for the log."""
    same = (xk == xp).all(axis=1)
    err = float(np.abs(xk - xp).max())
    if not same.all():
        raise AssertionError(
            f"{name}: K1 disagrees with its plain version on "
            f"{int((~same).sum())} of {len(same)} lanes, max |dx| {err}")
    return {"lanes_identical": int(same.sum()), "max_abs_dx": err}


def _margins(name, v_ref, o_ref, v_new, o_new):
    """tests/test_cd_sweep_pallas.py:104-110, the kernel as `new`; an extra
    check beside the bit-for-bit one, on the statistics the JAX tests
    hold their kernel to."""
    feas_ref, feas_new = v_ref < 1e-2, v_new < 1e-2
    ok = feas_new.mean() >= max(feas_ref.mean() * 0.2,
                                feas_ref.mean() - 0.08)
    ok &= np.median(v_new) <= np.median(v_ref) * 2.5 + 1e-2
    if feas_ref.any() and feas_new.any():
        scale = 1.0 + abs(float(o_ref[feas_ref].min()))
        ok &= o_new[feas_new].min() <= o_ref[feas_ref].min() + 1.0 * scale
    if not ok:
        raise AssertionError(f"{name}: K1 outside the statistical margins "
                             "against its plain version")


# K1 at the shapes that cross its lanes' boundaries (n, m, share of
# equality rows, R, sweeps): m + 1 and m + E on both sides of 32 and 64
# (a warp's lanes own rows i = lane mod 32), n = 1 and n = 128 at the
# largest m that the CD route sends to K1, n = 8 at m = 300; R = 1 and
# 300 (no multiple of a block's 4 warps), each lane bit for bit.
K1_SHAPES = [(9, 30, 0.0, 300, 3), (9, 30, 1.0, 1, 3), (9, 31, 0.0, 1, 3),
             (9, 31, 1.0, 300, 3), (9, 32, 0.0, 300, 3),
             (9, 32, 1.0, 300, 3), (9, 63, 0.0, 300, 3),
             (9, 63, 1.0, 1, 3), (9, 64, 0.0, 1, 3), (9, 64, 1.0, 300, 3),
             (1, 1278, 0.0, 100, 3), (1, 1278, 1.0, 30, 3),
             (128, 78, 0.0, 300, 1), (128, 78, 1.0, 300, 1),
             (8, 300, 0.0, 300, 3), (8, 300, 1.0, 300, 3)]


def k1_shape_arrays(n, m, eq_frac, seed):
    """tests/test_torch_gpu.py `_k1_form`: dense random rows with a
    region of feasible starts around 0."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    P[0] += 2.0 * np.eye(n)
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    r[1:] = np.abs(r[1:]) * -0.5
    return (P, q, r, rng.random(m) < eq_frac), rng


def k1_tie_arrays(n, eq):
    """tests/test_torch_gpu.py `_k1_tie_form`: a constant objective and
    rows x_i^2 <= c_i (c_i = 1 or 4, rows 0 and 1 repeated), so that from
    x_i = 0 phase 2's two bounds tie in value and in distance."""
    m = n + 2
    P = np.zeros((m + 1, n, n))
    r = np.zeros(m + 1)
    for i in range(m):
        P[1 + i, i % n, i % n] = 1.0
        r[1 + i] = -1.0 - 3.0 * ((i % n) % 2)
    return P, np.zeros((m + 1, n)), r, np.full(m, eq)


def _k1_shapes():
    """K1 and its plain version on K1_SHAPES and on the tie forms, every
    lane bit for bit: two_phase_sweeps everywhere, phase1_sweeps (the same
    kernel with phase 2 off) where n <= 9, to keep the plain runs short."""
    import torch
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels import cd_sweep_kernel as tk
    cases = []
    for n, m, eq_frac, R, sweeps in K1_SHAPES:
        arrays, rng = k1_shape_arrays(n, m, eq_frac, n + m + R)
        xs = (0.5 * rng.standard_normal((R, n))).astype(np.float32)
        cases.append((arrays, xs, sweeps))
    rng = np.random.default_rng(4)
    for eq in (False, True):
        cases.append((k1_tie_arrays(5, eq),
                      rng.integers(-1, 2, (300, 5)).astype(np.float32), 6))
    out = []
    for arrays, xs, sweeps in cases:
        form = form_from_numpy(*arrays, device="cuda", dtype=torch.float32)
        eq_idx = form.eq_idx()
        xs = torch.from_numpy(xs).cuda()
        res = {"n": form.n, "m": form.m, "E": len(eq_idx),
               "R": xs.shape[0], "sweeps": sweeps}
        t0 = time.perf_counter()
        fns = [("two_phase", tk.two_phase_sweeps, tk.two_phase_sweeps_ref)]
        if form.n <= 9:
            fns.append(("phase1", tk.phase1_sweeps, tk.phase1_sweeps_ref))
        for name, fn, ref in fns:
            xk = fn(form.P, form.q, form.r, eq_idx, xs, num_iters=sweeps)
            xp = ref(form.P, form.q, form.r, eq_idx, xs, num_iters=sweeps)
            agree = _k1_agrees(f"{name} at {res}", xk.cpu().numpy(),
                               xp.cpu().numpy())
            res[name] = {"lanes_identical": agree["lanes_identical"],
                         "moved": int((xk != xs).any(dim=1).sum())}
        res["seconds"] = time.perf_counter() - t0
        out.append(res)
    return out


# K1 above n = 128, where the CD route sends it by the card's rule (n, m,
# share of equality rows): at n = 129 m + 1 below 32 and m + E above it;
# at n = 256 m + 1 above 32 (the n = 256 route's form, whose m + 1 and
# m + E lie below 32, is the last case); (128, 79), the first shape the
# TPU's budget sent to K2.  One plain run a shape, R_WIDE starts, 1 sweep,
# made on the card by a process of its own while the kernels are built
# (`--k1-wide`); K1 runs at R_WIDE and on the first start alone (R = 1),
# which the plain run's lane 0 answers: it runs every lane on its own.
K1_WIDE_SHAPES = [(129, 30, 1.0), (256, 32, 0.0), (128, 79, 0.0)]
R_WIDE = 300


def route_starts(R, n=N_K2, seed=1):
    """The starts solve_restarts draws from a generator seeded `seed`."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((R, n), generator=gen, dtype=torch.float32,
                       device="cuda")


def k1_wide_cases():
    """(name, arrays, starts) of K1's cases above n = 128: K1_WIDE_SHAPES
    with numpy starts, then the n = 256 route's form with the first R_WIDE
    of its first timed solve's starts (drawn on the card)."""
    cases = []
    for n, m, eq_frac in K1_WIDE_SHAPES:
        arrays, rng = k1_shape_arrays(n, m, eq_frac, n + m + R_WIDE)
        cases.append((f"n={n},m={m},eq={eq_frac}", arrays,
                      (0.5 * rng.standard_normal((R_WIDE, n)))
                      .astype(np.float32)))
    cases.append((f"route n={N_K2},m={M_K2}",
                  bench_form_arrays(0, N_K2, M_K2),
                  route_starts(R_MAIN)[:R_WIDE].cpu().numpy()))
    return cases


def start_k1_wide(workdir):
    """Start the plain-version runs of K1's cases above n = 128 on the card
    in a process of their own (`--k1-wide`): they launch no kernel and are
    bound by the host's launches, so they run beside the build and
    `plain_runs`."""
    path = os.path.join(workdir, "k1_wide.npz")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--k1-wide", path])
    proc.path = path
    return proc


def k1_wide_plain(path):
    """(run as `--k1-wide PATH`) K1's plain version on the card on each of
    `k1_wide_cases`, 1 sweep: the starts, the outputs and the ms."""
    import torch
    sys.path.insert(0, REPO)
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels.cd_sweep_kernel import two_phase_sweeps_ref
    out = {}
    for i, (_, arrays, xs) in enumerate(k1_wide_cases()):
        form = form_from_numpy(*arrays, device="cuda", dtype=torch.float32)
        xs = torch.from_numpy(xs).cuda()
        ms, x = host_ms(lambda: two_phase_sweeps_ref(
            form.P, form.q, form.r, form.eq_idx(), xs, num_iters=1))
        out.update({f"xs{i}": xs.cpu().numpy(), f"x{i}": x.cpu().numpy(),
                    f"ms{i}": ms})
    np.savez(path, **out)


def _k1_wide(proc):
    """K1 on `k1_wide_cases` at R_WIDE and R = 1 against the `--k1-wide`
    process's plain runs, every lane bit for bit."""
    import torch
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels.cd_sweep_kernel import two_phase_sweeps
    if proc.wait(timeout=600) != 0:
        raise AssertionError(f"the --k1-wide process exited {proc.returncode}")
    plain = np.load(proc.path)
    out = []
    for i, (name, arrays, xs) in enumerate(k1_wide_cases()):
        if not np.array_equal(plain[f"xs{i}"], xs):
            raise AssertionError(f"{name}: the --k1-wide process ran other "
                                 "starts")
        form = form_from_numpy(*arrays, device="cuda", dtype=torch.float32)
        eq_idx = form.eq_idx()
        xs = torch.from_numpy(xs).cuda()
        res = {"case": name, "E": len(eq_idx), "plain_ms": float(plain[f"ms{i}"])}
        for R in (R_WIDE, 1):
            xk = two_phase_sweeps(form.P, form.q, form.r, eq_idx, xs[:R],
                                  num_iters=1).cpu().numpy()
            agree = _k1_agrees(f"{name} at R = {R}", xk, plain[f"x{i}"][:R])
            res[f"R={R}"] = {"lanes_identical": agree["lanes_identical"],
                             "moved": int((xk != xs[:R].cpu().numpy())
                                          .any(axis=1).sum())}
        out.append(res)
    return out


def phase_k1(arrays, wide):
    import torch
    from qcqp_tpu_torch.kernels.cd_sweep_kernel import (
        phase1_sweeps, phase1_sweeps_ref, two_phase_sweeps,
        two_phase_sweeps_ref)
    P, q, r, is_eq = arrays
    eq_idx = tuple(int(i) for i in np.nonzero(is_eq)[0])
    Pt, qt_, rt = (torch.tensor(a, dtype=torch.float32, device="cuda")
                   for a in (P, q, r))
    Pn = Pt.double().cpu().numpy()          # the float32 form, in float64
    qn, rn = qt_.double().cpu().numpy(), rt.double().cpu().numpy()
    rng = np.random.default_rng(7)
    xs_np = rng.standard_normal((R_K1_CHECK, N)).astype(np.float32)
    xs = torch.from_numpy(xs_np).cuda()

    out0 = two_phase_sweeps(Pt, qt_, rt, eq_idx, xs, num_iters=0)
    if not torch.equal(out0, xs):
        raise AssertionError("K1 with num_iters=0 is not the identity")

    kw = dict(num_iters=K1_CHECK_SWEEPS)
    res = {}
    for name, kern, plain in (("two_phase", two_phase_sweeps,
                               two_phase_sweeps_ref),
                              ("phase1", phase1_sweeps, phase1_sweeps_ref)):
        ms_k, xk = host_ms(lambda: kern(Pt, qt_, rt, eq_idx, xs, **kw))
        ms_p, xp = host_ms(lambda: plain(Pt, qt_, rt, eq_idx, xs, **kw))
        xk, xp = xk.cpu().numpy(), xp.cpu().numpy()
        if not (np.isfinite(xk).all()):
            raise AssertionError(f"{name}: K1 returned non-finite values")
        v_k, o_k = _viols_objs(Pn, qn, rn, is_eq, xk)
        v_p, o_p = _viols_objs(Pn, qn, rn, is_eq, xp)
        _margins(name, v_p, o_p, v_k, o_k)
        res[name] = {
            **_k1_agrees(name, xk, xp),
            "feasible_frac": [float((v_k < 1e-2).mean()),
                              float((v_p < 1e-2).mean())],
            "median_viol": [float(np.median(v_k)), float(np.median(v_p))],
            "ms": ms_k, "plain_ms": ms_p}
        if name == "two_phase":
            x_main = xk
    # No bench lane is viol_tol-feasible after 1 sweep, so phase 2 never
    # runs above; on boolean least squares most lanes reach it.
    Pb, qb, rb, eqb = boolean_ls_arrays()
    Pbt, qbt, rbt = (torch.tensor(a, dtype=torch.float32, device="cuda")
                     for a in (Pb, qb, rb))
    xb = torch.from_numpy(rng.standard_normal((R_K1_CHECK, 10))
                          .astype(np.float32)).cuda()
    bidx = tuple(range(10))
    xk = two_phase_sweeps(Pbt, qbt, rbt, bidx, xb, num_iters=10).cpu().numpy()
    xp = two_phase_sweeps_ref(Pbt, qbt, rbt, bidx, xb,
                              num_iters=10).cpu().numpy()
    cast = [t.double().cpu().numpy() for t in (Pbt, qbt, rbt)]
    v_k, o_k = _viols_objs(*cast, eqb, xk)
    v_p, o_p = _viols_objs(*cast, eqb, xp)
    _margins("boolean_ls", v_p, o_p, v_k, o_k)
    res["two_phase_boolean_ls"] = {
        "R": R_K1_CHECK, "sweeps": 10,
        **_k1_agrees("boolean_ls", xk, xp),
        "feasible_frac": [float((v_k < 1e-2).mean()),
                          float((v_p < 1e-2).mean())]}

    perm = np.random.default_rng(8).permutation(R_K1_CHECK)
    xperm = two_phase_sweeps(Pt, qt_, rt, eq_idx, xs[torch.from_numpy(perm)
                                                      .cuda()], **kw)
    if not np.array_equal(xperm.cpu().numpy(), x_main[perm]):
        raise AssertionError("K1's per-lane output depends on the restart "
                             "order")
    t0 = time.perf_counter()
    shapes = _k1_shapes()
    shapes_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    above_128 = _k1_wide(wide)
    from qcqp_tpu_torch.kernels.cd_sweep_kernel import launch_geometry
    warps, warp_floats, smem = launch_geometry(
        N, M, len(eq_idx), R_MAIN,
        torch.cuda.get_device_properties(0).multi_processor_count)
    emit({"phase": "k1", "n": N, "m": M, "R": R_K1_CHECK,
          "sweeps": K1_CHECK_SWEEPS, "identity_at_0": True,
          "permutation_invariant": True, **res, "shapes": shapes,
          "shapes_seconds": shapes_s, "above_128": above_128,
          "above_128_seconds": time.perf_counter() - t0,
          "ptxas": _ptxas("cd_sweep_kernel"),
          "geometry_at_main_path": {"warps_a_block": warps,
                                    "shared_bytes_a_warp": 4 * warp_floats,
                                    "shared_bytes_a_block": smem}})
    return max(v["max_abs_dx"] for v in res.values())


def phase_golden():
    import torch
    import qcqp_tpu_torch as qt
    from qcqp_tpu_torch.kernels.cd_sweep_kernel import two_phase_sweeps
    A, b = boolean_ls_data()
    n = A.shape[1]
    x = qt.Variable(n)
    prob = qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                      [qt.square(x) == 1])
    signs = np.array([[1.0 if bits >> i & 1 else -1.0 for i in range(n)]
                      for bits in range(1 << n)])
    brute = float(np.min(np.sum((signs @ A.T - b) ** 2, axis=1)))
    handler = qt.QCQP(prob)            # the default device: the card
    if (handler.device.type != "cuda"
            or handler.qcqp_form.dtype != torch.float32):
        raise AssertionError("the handler did not default to CUDA float32")
    before = two_phase_sweeps.launches
    f, v = handler.solve(num_restarts=256, improve=qt.COORD_DESCENT,
                         num_iters=50)
    launched = two_phase_sweeps.launches - before
    emit({"phase": "golden", "objective": f, "violation": v,
          "brute_force": brute, "k1_launches": launched})
    # a within-tolerance-infeasible f32 point can dip slightly below the
    # exact-feasible optimum (tests/tpu_smoke.py:138-140)
    if not (v < 1e-2 and brute - 0.1 <= f <= brute + 2e-2):
        raise AssertionError(f"boolean LS: ({f}, {v}) vs optimum {brute}")
    if launched < 1:
        raise AssertionError("QCQP.solve did not go through K1")


def phase_main(arrays, plain):
    import torch
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels.cd_sweep_kernel import two_phase_sweeps
    from qcqp_tpu_torch.kernels.onevar_kernel import phase1_coordinate_update
    from qcqp_tpu_torch.parallel.restarts import (best_point, solve_restarts,
                                                  suggest_batch)
    P, q, r, is_eq = arrays
    form = form_from_numpy(P, q, r, is_eq, device="cuda",
                           dtype=torch.float32)

    def solve(seed, R=R_MAIN, **kw):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return solve_restarts(form, R, gen, num_iters=SWEEPS, **kw)

    solve(0)                                           # warm-up
    two_phase_sweeps.launches = 0
    phase1_coordinate_update.launches = 0
    times, results = [], []
    for seed in (1, 2, 3):
        ms, res = host_ms(lambda: solve(seed))
        times.append(ms)
        results.append(res)
    k1_launches = two_phase_sweeps.launches
    ms_k2, res_k2 = host_ms(lambda: solve(1, mega=False))
    launches = {"k1": two_phase_sweeps.launches,
                "k2": phase1_coordinate_update.launches}
    for (x, f, v) in results + [res_k2]:
        if not (torch.isfinite(x).all() and x.shape == (N,)
                and bool(torch.isfinite(f)) and bool(torch.isfinite(v))):
            raise AssertionError("main path returned a non-finite point")
    if k1_launches != 3 or launches["k2"] < N:
        raise AssertionError(f"main path launch counts {launches}")

    # K1 alone on the starts of the first timed solve (seed 1), at the
    # main path's shape, twice; its plain version ran on the same starts
    # while the kernels were built (plain_runs)
    xs = suggest_batch(form, R_MAIN,
                       torch.Generator(device="cuda").manual_seed(1))
    eq_idx = form.eq_idx()

    def k1_alone():
        return two_phase_sweeps(form.P, form.q, form.r, eq_idx, xs,
                                num_iters=SWEEPS)
    ms_k1_a, x_k1 = host_ms(k1_alone)
    ms_k1_b, _ = host_ms(k1_alone)
    x_plain, ms_plain = plain["k1_main"]["x"], plain["k1_main"]["ms"]
    sweeps, probes = (plain["k1_main"][k] for k in ("lane_sweeps", "probes"))
    E = len(eq_idx)
    ops = (sweeps * ((M + 1) * (2 * N * N + 2 * N) + N * 2 * (M + 1) * N)
           + probes * (M + E) * C_ROW)
    nbytes = 4 * ((M + 1) * N * N + (M + 1) * N + (M + 1) + 2 * R_MAIN * N)
    xb, fb, vb = best_point(form, x_k1)
    if not (torch.equal(xb, results[0][0]) and torch.equal(fb, results[0][1])
            and torch.equal(vb, results[0][2])):
        raise AssertionError("K1 on the first solve's starts does not give "
                             "that solve's best point")
    _, fp, vp = best_point(form, x_plain)
    xk, xp = x_k1.cpu().numpy(), x_plain.cpu().numpy()
    if not np.isfinite(xk).all():
        raise AssertionError("main path: K1 returned non-finite values")
    cast = [t.double().cpu().numpy() for t in (form.P, form.q, form.r)]
    v_k, o_k = _viols_objs(*cast, is_eq, xk)
    v_p, o_p = _viols_objs(*cast, is_eq, xp)
    _margins("main_path", v_p, o_p, v_k, o_k)
    agree = _k1_agrees("main_path", xk, xp)
    k1_err = agree["max_abs_dx"]

    f_best, v_best = float(results[0][1]), float(results[0][2])
    ms_main = float(np.median(times))
    emit({"phase": "main_path", "n": N, "m": M, "R": R_MAIN,
          "sweeps": SWEEPS, "k1_route": {
              "ms_per_solve": times, "restarts_per_s": R_MAIN / ms_main * 1e3,
              "best_f": f_best, "best_viol": v_best},
          "k2_route": {"ms_per_solve": ms_k2,
                       "restarts_per_s": R_MAIN / ms_k2 * 1e3,
                       "best_f": float(res_k2[1]),
                       "best_viol": float(res_k2[2])},
          "k1_vs_plain": {"R": R_MAIN, "sweeps": SWEEPS,
                          "k1_ms": [ms_k1_a, ms_k1_b], "plain_ms": ms_plain,
                          **agree,
                          "plain_best_f": float(fp),
                          "plain_best_viol": float(vp),
                          "lane_sweeps": sweeps, "probes": probes},
          "launches": launches})
    return (launches, ms_main, (ms_k1_a + ms_k1_b) / 2, ms_plain, k1_err,
            bound(ops, nbytes), results[0])


def _k3_agrees(name, xk, xp):
    """K3 against its plain version: every lane bit for bit (-fmad=false
    on both sides; a NaN matches a NaN).  Returns the lane count and the
    max |dx| for the log."""
    xk, xp = xk.cpu().numpy(), xp.cpu().numpy()
    same = ((xk == xp) | (np.isnan(xk) & np.isnan(xp))).all(axis=1)
    err = float(np.nan_to_num(np.abs(xk - xp), nan=0.0).max())
    if not same.all():
        raise AssertionError(
            f"{name}: K3 disagrees with its plain version on "
            f"{int((~same).sum())} of {len(same)} lanes, max |dx| {err}")
    return {"lanes_identical": int(same.sum()), "max_abs_dx": err}


def wide_root_arrays():
    """tests/test_admm_pallas.py:103-122: a concave row whose secular root
    lies beyond K3's 2^10 doubling budget (the x1024 jumps reach it)."""
    n = 4
    P = np.stack([np.eye(n), -1e-4 * np.eye(n)])
    return P, np.zeros((2, n)), np.array([0.0, 0.25]), np.zeros(1, bool)


# K3 on shapes besides the bench form's, (n, m, R, need_dbl, iterations):
# n across the 32-coordinate chunks a lane owns (1, 31-33, 64, 65), the
# whole-slab limit (WHOLE_MAX_N = 160) and one past it (161, where Q_i is
# streamed in chunks), and 1,024; m = 1 and 50 (2 at n = 1,024, whose
# host eighs would take the phase's time); R = 1, 300 and "block": one full
# block of as many warps as fit (MAX_WARPS = 16 up to n = 153, fewer above,
# where the slabs fill the block) and one more restart, launched at that
# geometry; need_dbl on and off; 10, 6 and 2 iterations (the plain
# version's time grows with n).  Every lane bit for bit, both phases.
K3_SHAPES = [(1, 1, 1, True, 10), (31, 50, "block", False, 10),
             (32, 1, 300, True, 10), (33, 50, 1, True, 10),
             (64, 1, "block", True, 10), (65, 50, 300, False, 10),
             (159, 1, "block", False, 6), (160, 50, 1, True, 6),
             (160, 1, 300, False, 6), (161, 1, 300, True, 6),
             (161, 50, "block", False, 6), (1024, 1, "block", True, 2),
             (1024, 2, 1, False, 2)]


def k3_shape_arrays(n, m, dbl, seed):
    """tests/test_torch_gpu.py `_k3_shape_form`: a dense random form with
    equality rows; with dbl, constraint 1 is semidefinite (x' B B' x / n
    <= 1/2 + |r|), so K3's bracket doubling runs."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    is_eq = rng.random(m) < 0.5
    if dbl:
        B = rng.standard_normal((n, n))
        P[1] = B @ B.T / n
        r[1] = -abs(r[1]) - 0.5
        is_eq[0] = False
    return (P, q, r, is_eq), rng


def _k3_shapes():
    """K3 and its plain version on K3_SHAPES, every lane bit for bit."""
    import torch
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels import admm_kernel as tk
    out = []
    for n, m, R, dbl, iters in K3_SHAPES:
        arrays, rng = k3_shape_arrays(n, m, dbl, n + m)
        form = form_from_numpy(*arrays, device="cuda", dtype=torch.float32)
        d = tk.ADMMFusedData(form)
        if d.need_dbl != dbl:
            raise AssertionError(f"K3 shape n={n}, m={m}: need_dbl "
                                 f"{d.need_dbl}, expected {dbl}")
        geometry = None
        if R == "block":
            warps, rows, _ = tk.launch_geometry(n, m)
            R, geometry = warps + 1, (warps, rows, None)
        xs = torch.from_numpy((0.5 * rng.standard_normal((R, n)))
                              .astype(np.float32)).cuda()
        res = {"n": n, "m": m, "R": R, "need_dbl": dbl, "iters": iters,
               "geometry": list((geometry or tk.launch_geometry(
                   n, m, R, torch.cuda.get_device_properties(0)
                   .multi_processor_count))[:2])}
        t0 = time.perf_counter()
        for phase in (1, 2):
            xk = tk._launch(d, xs, phase, iters, 1e-2, 1e4, 1e-4,
                            tk.NW_TRIPS, geometry=geometry)
            xp = tk.admm_phase_ref(d, xs, phase, num_iters=iters)
            agree = _k3_agrees(f"K3 phase {phase} at {res}", xk, xp)
            res[f"phase{phase}"] = {
                "lanes_identical": agree["lanes_identical"],
                "moved": int((xk != xs).any(dim=1).sum())}
        res["seconds"] = time.perf_counter() - t0
        out.append(res)
    return out


def phase_k3(arrays):
    """K3 against its plain version on the card, phase by phase."""
    import torch
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.core import better_batch, max_violation_batch
    from qcqp_tpu_torch.kernels.admm_kernel import (
        ADMMFusedData, admm_phase, admm_phase_ref, improve_admm_fused)
    rng = np.random.default_rng(9)

    def case(arrs, R, iters, scale=1.0):
        form = form_from_numpy(*arrs, device="cuda", dtype=torch.float32)
        d = ADMMFusedData(form)
        xs = torch.from_numpy((scale * rng.standard_normal((R, form.n)))
                              .astype(np.float32)).cuda()
        return form, d, xs, dict(num_iters=iters)

    def both(name, d, x, phase, kw, timed=False):
        ms_k, xk = host_ms(lambda: admm_phase(d, x, phase, **kw))
        ms_p, xp = host_ms(lambda: admm_phase_ref(d, x, phase, **kw))
        out = _k3_agrees(name, xk, xp)
        if timed:
            out.update(ms=cuda_ms(lambda: admm_phase(d, x, phase, **kw), 2),
                       plain_ms=ms_p)
        return out, xk

    res = {}
    # the bench form: phase 1, phase 2 after phase 1's better-fold (as in
    # the improve), and phase 2 alone (phase1=False)
    form, d, xs, kw = case(arrays, R_K3_CHECK, ADMM_ITERS)
    for phase in (1, 2):
        if not torch.equal(admm_phase(d, xs, phase, num_iters=0), xs):
            raise AssertionError(f"K3 phase {phase} with num_iters=0 is "
                                 "not the identity")
    if not torch.equal(improve_admm_fused(form, xs, num_iters=0, data=d), xs):
        raise AssertionError("improve_admm_fused with num_iters=0 is not "
                             "the identity")
    res["bench_phase1"], x1 = both("bench phase 1", d, xs, 1, kw, timed=True)
    x1 = better_batch(d.form32, xs, x1)
    res["bench_phase2"], _ = both("bench phase 2", d, x1, 2, kw, timed=True)
    res["bench_phase2_alone"], x2 = both("bench phase 2 alone", d, xs, 2, kw)
    for x in (x1, x2):
        if not torch.isfinite(x).all():
            raise AssertionError("K3 returned non-finite values on the "
                                 "bench form")
    perm = torch.from_numpy(np.random.default_rng(8).permutation(
        R_K3_CHECK)).cuda()
    for phase in (1, 2):
        full = admm_phase(d, xs, phase, **kw)
        if not torch.equal(admm_phase(d, xs[perm], phase, **kw), full[perm]):
            raise AssertionError("K3's per-restart output depends on the "
                                 "restart order")
    # boolean least squares: semidefinite rows, so the bracket doubling runs
    _, d, xs, kw = case(boolean_ls_arrays(), R_K3_CHECK, ADMM_ITERS)
    if not d.need_dbl:
        raise AssertionError("boolean LS should take K3's doubling path")
    for phase in (1, 2):
        res[f"boolean_ls_phase{phase}"], _ = both(
            f"boolean LS phase {phase}", d, xs, phase, kw)
    # the wide-root rescue: the start 0.01 (1, 1, 1, 1) and scattered ones
    form, d, xs, kw = case(wide_root_arrays(), 64, 200, scale=0.01)
    xs[0] = 0.01
    for phase in (1, 2):
        res[f"wide_root_phase{phase}"], _ = both(
            f"wide root phase {phase}", d, xs, phase, kw)
    xw = improve_admm_fused(form, xs[:1], data=d, **kw)
    wide_viol = float(max_violation_batch(form, xw)[0])
    if not wide_viol < 1e-2:
        raise AssertionError(f"wide root: violation {wide_viol} >= 1e-2")
    t0 = time.perf_counter()
    shapes = _k3_shapes()
    from qcqp_tpu_torch.kernels.admm_kernel import launch_geometry
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    emit({"phase": "k3", "n": N, "m": M, "R": R_K3_CHECK,
          "iters": ADMM_ITERS, "identity_at_0": True,
          "permutation_invariant": True, "wide_root_viol": wide_viol, **res,
          "shapes": shapes, "shapes_seconds": time.perf_counter() - t0,
          "ptxas": _ptxas("admm_phase_kernel"),
          "geometry_at_admm_path": {
              R: dict(zip(("warps_a_block", "chunk_rows",
                           "shared_bytes_a_block"),
                          launch_geometry(N, M, R, sms)))
              for R in R_ADMM}})
    return max(v["max_abs_dx"] for v in res.values() if "max_abs_dx" in v)


def phase_admm_path(arrays):
    """solve_restarts(improve=ADMM) on the bench form, then K3 alone and
    its plain version on the first timed solve's starts."""
    import torch
    import qcqp_tpu_torch as qt
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels.admm_kernel import (
        ADMMFusedData, NW_TRIPS, admm_phase, admm_phase_ref,
        improve_admm_fused, improve_admm_fused_ref)
    from qcqp_tpu_torch.parallel.restarts import (best_point, solve_restarts,
                                                  suggest_batch)
    form = form_from_numpy(*arrays, device="cuda", dtype=torch.float32)

    def solve(seed, R):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return solve_restarts(form, R, gen, improve=qt.ADMM,
                              num_iters=ADMM_ITERS)

    def k3_bound(R, it1, it2):
        """Per lane: the start rotated into every eigenbasis in each
        phase; per live lane-iteration the consensus and projection
        products (2 m n^2 each) and the m projections (10 operations per
        coordinate plus 14 per Newton trip); phase 2 adds the W and P0
        products.  Bytes: Q, W and P0 once, the starts in and the result
        out of each phase."""
        proj = M * N * (10 + 14 * NW_TRIPS)
        ops = (2 * R * 2 * M * N * N + it1 * (4 * M * N * N + proj)
               + it2 * (4 * M * N * N + 4 * N * N + proj + 5 * N))
        nbytes = 4 * (M * N * N + 2 * N * N + 2 * M * N + 4 * R * N)
        return bound(ops, nbytes)

    for R in R_ADMM:
        solve(0, R)                                    # warm-up
    admm_phase.launches = 0
    runs = {}
    for R in R_ADMM:
        times, results = [], []
        for seed in range(1, 1 + ADMM_REPEATS):
            ms, res = host_ms(lambda: solve(seed, R))
            times.append(ms)
            results.append(res)
        runs[R] = (times, results)
    launches = admm_phase.launches
    if launches != 2 * ADMM_REPEATS * len(R_ADMM):
        raise AssertionError(f"ADMM path: {launches} K3 launches, expected "
                             f"{2 * ADMM_REPEATS * len(R_ADMM)}")
    for _, results in runs.values():
        for (x, f, v) in results:
            if not (torch.isfinite(x).all() and x.shape == (N,)
                    and bool(torch.isfinite(f)) and bool(torch.isfinite(v))):
                raise AssertionError("ADMM path returned a non-finite point")

    setup_ms, d = host_ms(lambda: ADMMFusedData(form))
    vs_plain = {}
    for R in R_ADMM:
        # K3 alone and its plain version on the first timed solve's starts,
        # at that solve's shape; kernel, plain, kernel
        xs = suggest_batch(form, R,
                           torch.Generator(device="cuda").manual_seed(1))

        def k3():
            return improve_admm_fused(form, xs, num_iters=ADMM_ITERS, data=d)
        ms_a, x_k = host_ms(k3)
        admm_phase_ref.lane_iters = {1: 0, 2: 0}
        ms_plain, x_p = host_ms(lambda: improve_admm_fused_ref(
            form, xs, num_iters=ADMM_ITERS, data=d))
        it1, it2 = (int(admm_phase_ref.lane_iters[p]) for p in (1, 2))
        ms_b, _ = host_ms(k3)
        xb, fb, vb = best_point(form, x_k)
        first = runs[R][1][0]
        if not (torch.equal(xb, first[0]) and torch.equal(fb, first[1])
                and torch.equal(vb, first[2])):
            raise AssertionError(f"K3 on the first R = {R} solve's starts "
                                 "does not give that solve's best point")
        vs_plain[R] = {"k3_ms": [ms_a, ms_b], "plain_ms": ms_plain,
                       "lane_iters": [it1, it2],
                       **_k3_agrees(f"ADMM path, R = {R}", x_k, x_p),
                       **k3_bound(R, it1, it2)}
    emit({"phase": "admm_path", "n": N, "m": M, "iters": ADMM_ITERS,
          **{f"R={R}": {"ms_per_solve": t,
                        "restarts_per_s": R / float(np.median(t)) * 1e3,
                        "best_f": float(res[0][1]),
                        "best_viol": float(res[0][2]),
                        "k3_vs_plain": vs_plain[R]}
             for R, (t, res) in runs.items()},
          "k3_launches": launches, "setup_ms": setup_ms})
    R = R_ADMM[0]
    return {"launches": launches,
            "max_abs_err": max(v["max_abs_dx"] for v in vs_plain.values()),
            "ms": float(np.mean(vs_plain[R]["k3_ms"])),
            "plain_ms": vs_plain[R]["plain_ms"],
            "ms_by_R": {R: float(np.mean(v["k3_ms"]))
                        for R, v in vs_plain.items()},
            "plain_ms_by_R": {R: v["plain_ms"] for R, v in vs_plain.items()},
            "ms_per_solve": {R: float(np.median(t))
                             for R, (t, _) in runs.items()},
            "bound": {k: vs_plain[R][k] for k in ("bound_ms", "bound_by")},
            "bound_ms_by_R": {R: v["bound_ms"] for R, v in vs_plain.items()}}


def phase_admm_golden():
    """examples/boolean_least_squares.py:45-47 through QCQP(prob), with
    RANDOM in place of SDR: CD, then ADMM(phase1=False) through K3, held
    against the plain version on that restart; then QCQP.solve with
    improve=ADMM through K3."""
    import torch
    import qcqp_tpu_torch as qt
    from qcqp_tpu_torch.kernels.admm_kernel import (
        ADMMFusedData, admm_phase, improve_admm_fused_ref)
    from qcqp_tpu_torch.solvers.admm import min_valid_rho
    A, b = boolean_ls_data()
    x = qt.Variable(A.shape[1])
    prob = qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                      [qt.square(x) == 1])
    handler = qt.QCQP(prob)            # the default device: the card
    if (handler.device.type != "cuda"
            or handler.qcqp_form.dtype != torch.float32):
        raise AssertionError("the handler did not default to CUDA float32")
    form = handler.qcqp_form

    def point():
        return torch.as_tensor(handler.layout.flatten(), dtype=torch.float32,
                               device="cuda")
    handler.suggest(qt.RANDOM)
    f_cd, v_cd = handler.improve(qt.COORD_DESCENT)
    x_cd = point()
    before = admm_phase.launches
    f_a, v_a = handler.improve(qt.ADMM, phase1=False)
    launched = admm_phase.launches - before
    # the same restart through the plain version (the handler's defaults)
    x_p = improve_admm_fused_ref(form, x_cd[None], phase1=False,
                                 data=ADMMFusedData(form))
    agree = _k3_agrees("ADMM golden", point()[None], x_p)
    # the batched entry point: best of R_ADMM_GOLDEN restarts, 1,000
    # iterations, phase 1 on; about a tenth of the restarts end within
    # the violation tolerance, so the best one must
    before = admm_phase.launches
    f_s, v_s = handler.solve(num_restarts=R_ADMM_GOLDEN, improve=qt.ADMM)
    solve_launches = admm_phase.launches - before
    min_rho = float(min_valid_rho(form))
    try:
        handler.improve(qt.ADMM, rho=min_rho - 1.0)
        raise AssertionError("rho below the minimum did not raise")
    except ValueError as e:
        if "rho parameter is too small" not in str(e):
            raise
    emit({"phase": "admm_golden", "cd": [f_cd, v_cd], "admm": [f_a, v_a],
          "k3_launches": launched, "vs_plain": agree,
          "solve": {"R": R_ADMM_GOLDEN, "best": [f_s, v_s],
                    "k3_launches": solve_launches},
          "min_valid_rho": min_rho})
    b_a, b_cd = np.floor(v_a / 1e-4), np.floor(v_cd / 1e-4)
    if not (b_a < b_cd or (b_a == b_cd and f_a <= f_cd + 1e-5 * abs(f_cd))):
        raise AssertionError(f"ADMM ({f_a}, {v_a}) is worse than CD's "
                             f"({f_cd}, {v_cd})")
    if launched != 1:
        raise AssertionError(f"improve(ADMM) launched K3 {launched} times")
    if solve_launches != 2:
        raise AssertionError(f"solve(improve=ADMM) launched K3 "
                             f"{solve_launches} times")
    if not v_s < 1e-2:
        raise AssertionError(f"solve(improve=ADMM): best violation {v_s} "
                             ">= 1e-2")


# -- K4 and the DCCP path ---------------------------------------------------

PEAK_F32, HBM_BYTES_S = 67e12, 3.35e12     # H100 SXM data sheet, 700 W
# K1's and K2's operations per constraint row per bisection probe: the
# row's canonicalization (about 25) and its violation (6).  The scan of
# the candidates against the rows stops at the first row a candidate
# fails, so its length depends on the data; it is left out, and the bound
# is a floor.
C_ROW = 31


def bound(ops, nbytes):
    """The least time the card could take: the larger of the operations
    over the float32 peak outside the tensor cores and the bytes over the
    memory rate."""
    t_ops, t_bytes = ops / PEAK_F32, nbytes / HBM_BYTES_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": float(ops), "bytes": float(nbytes)}


def k4_ops(d, trips):
    """Operations of K4's work on one run, from the per-tile trip counts
    (tiles, 2) the kernel reports: per lane and inner trip, the 2 (m + 1)
    rotations (2 n^2 each), each hinge block's set-up (15 operations per
    coordinate) and the consensus and dual updates (6 per coordinate and
    block); per outer step one linearization (m + 1 + E rotations), plus
    the first.  The hinges' Newton trips (19 operations per coordinate
    each) are left out: K4 runs them only for the lanes whose prox needs
    the multiplier, which the data decide, so the bound is a floor."""
    n, m, E = d.n, d.m, d.E
    B = 1 + m + E
    inner = (4 * (m + 1) * n * n + (m + E) * n * 15 + 6 * B * n + 8 * n)
    lin = 2 * (m + 1 + E) * n * n + 6 * (m + 1) * n
    t = trips.cpu().numpy().astype(np.float64)
    return 64.0 * float((t[:, 1] * inner + (t[:, 0] + 1) * lin).sum())


def k4_bytes(d, R):
    """V once, the starts in and the result out."""
    return 4.0 * ((d.m + 1) * d.n * d.n + 2 * R * d.n)


def _k4_agrees(name, xk, xp):
    """K4 against its plain version: every lane bit for bit (-fmad=false
    on both sides; a NaN matches a NaN)."""
    xk, xp = xk.cpu().numpy(), xp.cpu().numpy()
    same = ((xk == xp) | (np.isnan(xk) & np.isnan(xp))).all(axis=1)
    err = float(np.nan_to_num(np.abs(xk - xp), nan=0.0).max())
    if not same.all():
        raise AssertionError(
            f"{name}: K4 disagrees with its plain version on "
            f"{int((~same).sum())} of {len(same)} lanes, max |dx| {err}")
    return {"lanes_identical": int(same.sum()), "max_abs_dx": err}


def boolean_ls6_arrays():
    """tests/test_ccp_pallas.py:44-62: boolean least squares, n = 6,
    m = 9 data rows (np.random.seed(1))."""
    return bls_arrays(*boolean_ls_data(n=6, m=9))


def k4_wide_case():
    """tests/test_torch_gpu.py `_k4_form("wide")`: a dense random form at
    n = 150, m = 3 (K4's n <= 256 instantiation), and 130 starts."""
    rng = np.random.default_rng(6)
    n, m = 150, 3
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    arrays = (P, q, r, rng.random(m) < 0.5)
    return arrays, rng.standard_normal((130, n)).astype(np.float32)


K4_WIDE_KW = dict(max_iter=4, inner_iters=5)


def _ptxas(kernel_tag):
    """Registers, spills and stack of the named kernel's instantiations
    from the build's -Xptxas -v report."""
    from qcqp_tpu_torch.kernels import _build
    lines = _build.BuildInfo.log.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Function properties for" in ln and kernel_tag in ln:
            out.append(" ".join(x.strip() for x in lines[i:i + 3]))
    return out


def phase_k4(arrays, plain):
    """K4 against its plain version on the card, every lane bit for bit:
    the bench form at R = 128 (fused defaults) on the starts of the DCCP
    path's first timed solve at that R, boolean least squares, identity at
    max_iter=0, a ragged R, and invariance under permutations inside a
    tile and of whole tiles."""
    import torch
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.core import max_violation_batch
    from qcqp_tpu_torch.kernels.ccp_kernel import (
        CCPFusedData, ccp_improve, ccp_improve_ref, improve_ccp_fused,
        shared_bytes)
    from qcqp_tpu_torch.parallel.restarts import suggest_batch
    rng = np.random.default_rng(10)
    form = form_from_numpy(*arrays, device="cuda", dtype=torch.float32)
    d = CCPFusedData(form)
    xs = suggest_batch(form, R_CCP[0],
                       torch.Generator(device="cuda").manual_seed(1))
    res = {}
    if not (torch.equal(ccp_improve(d, xs, max_iter=0), xs) and torch.equal(
            improve_ccp_fused(form, xs, max_iter=0, data=d), xs)):
        raise AssertionError("K4 with max_iter=0 is not the identity")
    ms_k, xk = host_ms(lambda: ccp_improve(d, xs))
    trips = ccp_improve.trips.clone()
    # the plain version ran on the same starts while the kernels were built
    xp, ms_p = plain["k4_bench"]["x"], plain["k4_bench"]["ms"]
    if not torch.equal(trips, plain["k4_bench"]["trips"]):
        raise AssertionError("K4's trip counts differ from the plain "
                             "version's")
    res["bench"] = {"R": R_CCP[0], **_k4_agrees("bench", xk, xp),
                    "ms": ms_k, "plain_ms": ms_p,
                    "ms_per_inner_trip": ms_k / int(trips[:, 1].max()),
                    "trips": trips.tolist()}
    if not torch.isfinite(xk).all():
        raise AssertionError("K4 returned non-finite values on the bench "
                             "form")
    # lanes permuted inside each tile, then the two tiles swapped (10
    # outer steps)
    inside = torch.cat([torch.randperm(64, generator=torch.Generator()
                                       .manual_seed(t)) + 64 * t
                        for t in range(2)]).cuda()
    swap = torch.cat([torch.arange(64, 128), torch.arange(64)]).cuda()
    x10 = ccp_improve(d, xs, max_iter=10)
    for perm in (inside, swap):
        if not torch.equal(ccp_improve(d, xs[perm], max_iter=10), x10[perm]):
            raise AssertionError("K4's lane output depends on the lane "
                                 "order")
    # a ragged batch: 100 restarts, the second tile padded with zero lanes
    kw = dict(max_iter=10)
    res["ragged"] = {"R": 100, "max_iter": 10, **_k4_agrees(
        "ragged", ccp_improve(d, xs[:100], **kw),
        ccp_improve_ref(d, xs[:100], **kw))}
    # boolean least squares at the fused defaults (max_iter 45, as
    # tests/test_ccp_pallas.py:64), 8 restarts: most land feasible
    fb = form_from_numpy(*boolean_ls6_arrays(), device="cuda",
                         dtype=torch.float32)
    db = CCPFusedData(fb)
    xb = torch.from_numpy(rng.standard_normal((8, 6))
                          .astype(np.float32)).cuda()
    res["boolean_ls"] = _k4_agrees(
        "boolean LS", ccp_improve(db, xb, max_iter=45),
        ccp_improve_ref(db, xb, max_iter=45))
    vb = max_violation_batch(fb, improve_ccp_fused(fb, xb, max_iter=45,
                                                   data=db))
    res["boolean_ls"]["feasible"] = int((vb < 1e-2).sum())
    if res["boolean_ls"]["feasible"] < 6:
        raise AssertionError(f"boolean LS: {res['boolean_ls']['feasible']}"
                             " of 8 restarts feasible, expected >= 6")
    # the n <= 256 instantiation (n = 150); its plain version ran while the
    # kernels were built
    wide, xw = plain["k4_wide"]["d"], plain["k4_wide"]["xs"]
    res["wide"] = {"n": wide.n, "m": wide.m, "R": xw.shape[0], **K4_WIDE_KW,
                   **_k4_agrees("wide", ccp_improve(wide, xw, **K4_WIDE_KW),
                                plain["k4_wide"]["x"])}
    if not torch.equal(ccp_improve.trips, plain["k4_wide"]["trips"]):
        raise AssertionError("K4's trip counts differ from the plain "
                             "version's on the wide case")
    b = bound(k4_ops(d, trips), k4_bytes(d, R_CCP[0]))
    res["bench"].update(b)
    emit({"phase": "k4", "n": N, "m": M, "E": d.E, "identity_at_0": True,
          "permutation_invariant": True, "ptxas": _ptxas("ccp_kernel"),
          "shared_bytes": shared_bytes(N), **res})
    return {"max_abs_err": max(v["max_abs_dx"] for v in res.values()),
            "ms": ms_k, "plain_ms": ms_p, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"],
            "ms_per_inner_trip": res["bench"]["ms_per_inner_trip"]}


def phase_ccp_path(arrays, plain):
    """solve_restarts(improve=DCCP) on the bench form at R = 128 and
    10,240; then K4 alone on the first timed solve's starts, whole tiles of
    it held against the plain version."""
    import torch
    import qcqp_tpu_torch as qt
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.core import better_batch
    from qcqp_tpu_torch.kernels.ccp_kernel import CCPFusedData, ccp_improve
    from qcqp_tpu_torch.parallel.restarts import (best_point, solve_restarts,
                                                  suggest_batch)
    form = form_from_numpy(*arrays, device="cuda", dtype=torch.float32)

    def solve(seed, R, **kw):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return solve_restarts(form, R, gen, improve=qt.DCCP, **kw)

    for R in R_CCP:
        solve(0, R, max_iter=1)                        # warm-up
    ccp_improve.launches = 0
    runs = {}
    for R in R_CCP:
        times, results = [], []
        for seed in range(1, 1 + CCP_REPEATS[R]):
            ms, res = host_ms(lambda: solve(seed, R))
            times.append(ms)
            results.append(res)
        runs[R] = (times, results)
    launches = ccp_improve.launches
    if launches != sum(CCP_REPEATS.values()):
        raise AssertionError(f"DCCP path: {launches} K4 launches, expected "
                             f"{sum(CCP_REPEATS.values())}")
    for _, results in runs.values():
        for (x, f, v) in results:
            if not (torch.isfinite(x).all() and x.shape == (N,)
                    and bool(torch.isfinite(f)) and bool(torch.isfinite(v))):
                raise AssertionError("DCCP path returned a non-finite point")

    setup_ms, d = host_ms(lambda: CCPFusedData(form))
    alone = {}
    for R in R_CCP:
        # K4 alone on the first timed solve's starts, with the improve's
        # better-fold, must give that solve's best point
        xs = suggest_batch(form, R,
                           torch.Generator(device="cuda").manual_seed(1))
        ms, x_raw = host_ms(lambda: ccp_improve(d, xs))
        trips = ccp_improve.trips.clone()
        xb, fb, vb = best_point(form, better_batch(d.form32, xs, x_raw))
        first = runs[R][1][0]
        if not (torch.equal(xb, first[0]) and torch.equal(fb, first[1])
                and torch.equal(vb, first[2])):
            raise AssertionError(f"K4 on the first R = {R} solve's starts "
                                 "does not give that solve's best point")
        alone[R] = {"k4_ms": ms,
                    "ms_per_inner_trip": ms / int(trips[:, 1].max()),
                    "trips_outer_inner": [int(trips[:, 0].sum()),
                                          int(trips[:, 1].sum())],
                    **bound(k4_ops(d, trips), k4_bytes(d, R))}
        if R == R_CCP[0]:
            # phase k4 held every lane of these starts
            alone[R]["tiles_checked"] = "all, in phase k4"
            continue
        # the plain version ran on these tiles of the same starts while
        # the kernels were built
        t = plain["k4_tiles"]
        alone[R].update(tiles_checked=t["tiles"], plain_ms_tiles=t["ms"],
                        **_k4_agrees(f"DCCP path, R = {R}", x_raw[t["rows"]],
                                     t["x"]))
    emit({"phase": "ccp_path", "n": N, "m": M, "E": d.E,
          **{f"R={R}": {"ms_per_solve": t,
                        "restarts_per_s": R / float(np.median(t)) * 1e3,
                        "best_f": float(res[0][1]),
                        "best_viol": float(res[0][2]),
                        "k4_alone": alone[R]}
             for R, (t, res) in runs.items()},
          "k4_launches": launches, "setup_ms": setup_ms})
    return {"launches": launches, "alone": alone,
            "ms_per_solve": {R: float(np.median(t))
                             for R, (t, _) in runs.items()}}


def phase_ccp_golden():
    """Two DCCP goldens through QCQP(prob) on its default device: improve
    on sum_squares(x) s.t. square(x) == 1 (tests/test_ccp_pallas.py:
    115-125), held against the plain version on that restart; and
    QCQP.solve(256, improve=DCCP) on boolean least squares."""
    import torch
    import qcqp_tpu_torch as qt
    from qcqp_tpu_torch.kernels.ccp_kernel import (
        ccp_improve, improve_ccp_fused_ref)
    x = qt.Variable(3)
    prob = qt.Problem(qt.Minimize(qt.sum_squares(x)), [qt.square(x) == 1])
    h = qt.QCQP(prob)                  # the default device: the card
    if h.device.type != "cuda" or h.qcqp_form.dtype != torch.float32:
        raise AssertionError("the handler did not default to CUDA float32")
    h.suggest(qt.RANDOM)
    x0 = torch.as_tensor(h.layout.flatten(), dtype=torch.float32,
                         device="cuda")
    before = ccp_improve.launches
    f1, v1 = h.improve(qt.DCCP)
    launched = ccp_improve.launches - before
    x_p = improve_ccp_fused_ref(h.qcqp_form, x0[None], inner_iters=40)
    agree = _k4_agrees("DCCP improve golden",
                       torch.as_tensor(h.layout.flatten(),
                                       dtype=torch.float32,
                                       device="cuda")[None], x_p)
    if launched != 1 or not v1 < 1e-2:
        raise AssertionError(f"improve(DCCP): {launched} K4 launches, "
                             f"violation {v1}")

    A, b = boolean_ls_data()
    xb = qt.Variable(A.shape[1])
    prob = qt.Problem(qt.Minimize(qt.sum_squares(A @ xb - b)),
                      [qt.square(xb) == 1])
    signs = np.array([[1.0 if bits >> i & 1 else -1.0
                       for i in range(A.shape[1])]
                      for bits in range(1 << A.shape[1])])
    brute = float(np.min(np.sum((signs @ A.T - b) ** 2, axis=1)))
    hb = qt.QCQP(prob)
    before = ccp_improve.launches
    f2, v2 = hb.solve(num_restarts=R_CCP_GOLDEN, improve=qt.DCCP)
    solve_launches = ccp_improve.launches - before
    emit({"phase": "ccp_golden", "improve": [f1, v1], "k4_launches": launched,
          "vs_plain": agree,
          "solve": {"R": R_CCP_GOLDEN, "best": [f2, v2],
                    "k4_launches": solve_launches, "brute_force": brute}})
    if solve_launches != 1:
        raise AssertionError(f"solve(improve=DCCP) launched K4 "
                             f"{solve_launches} times")
    # the plain version on the CPU reached 39.902 at violation < 1e-5 from
    # four generator seeds; the card's draws differ, so the bound is that
    # objective, not the brute-force optimum
    if not (v2 < 1e-2 and brute - 0.1 <= f2 <= CCP_GOLDEN_F_MAX):
        raise AssertionError(f"solve(improve=DCCP): ({f2}, {v2})")



# -- K5 and the SDR path ----------------------------------------------------

# (B, n0, sweeps, rounds): the banks' shapes at the wrapper's default 8
# sweeps and the vec route's 2, a ragged batch, the global-memory code
# (n0 = 200 pads to 256), and round counts that are no multiple of n - 1;
# then the storages' edges (eigh_kernel.launch_geometry): one warp a matrix
# up to n0 = 32 (n0 = 1 has no real pair; B = 132 at n0 = 25 one an SM,
# 301 and 1,001 several a block with a ragged last block), one block a
# matrix from 33 (2 to 6 column chunks a lane: 32/33, 64/65, 128/129),
# shared memory up to 169 and a global scratch from 170
K5_CASES = [(16, 24, 8, None), (16, 24, 2, None), (132, 101, 8, None),
            (132, 101, 2, None), (5, 16, 8, None), (2, 200, 8, None),
            (2, 200, 2, None), (3, 24, 2, 57), (2, 200, 1, 300),
            (4, 1, 1, None), (16, 25, 2, None), (132, 25, 1, None),
            (301, 25, 1, None), (1001, 25, 1, None), (7, 32, 1, None),
            (7, 33, 1, None), (3, 64, 1, None), (3, 65, 1, None),
            (3, 128, 1, None), (3, 129, 1, None), (2, 169, 1, None),
            (2, 170, 1, 100)]
# (B, n0) timed at 2 sweeps: the S = 132 bank's (and one matrix of it), and
# the S = 16 bank's (n = ns + 1 = 25)
K5_TIMED = ((1, 101), (132, 101), (16, 25))
SDR_N = 100                        # bench.py:287-305
SDR_BANK_ITERS = 2000              # the vec banks' fixed budget
LOCKSTEP_ITERS = 20


def k5_bound(B, n0, rounds):
    """Operations: only the pairs of two real rows need work.  A pair with
    a padded slot has c == 0, so its rotation is the identity, and the
    padded rows and columns of A and V stay zero.  A real pair costs its
    parameters (15 operations) and three two-sided updates (A's rows, A's
    columns, V's columns) of 2 x n0 elements at 3 operations each: 18 n0.
    The pairs are counted by replaying the tournament at the padded n.
    Bytes: A in, lam and V out."""
    from qcqp_tpu_torch.kernels.eigh_kernel import (_padded,
                                                    tournament_permutation)
    n = _padded(n0)
    sig, slot, pairs = tournament_permutation(n), np.arange(n), 0
    for _ in range(rounds):
        real = slot < n0
        pairs += int((real[0::2] & real[1::2]).sum())
        slot = slot[sig]
    out = bound(B * pairs * (18 * n0 + 15), 4 * B * (2 * n0 * n0 + n0))
    out["real_pairs_per_matrix"] = pairs
    return out


def _sym_batch(rng, B, n0):
    import torch
    A = rng.standard_normal((B, n0, n0))
    return torch.from_numpy((0.5 * (A + np.swapaxes(A, -1, -2)))
                            .astype(np.float32)).cuda()


def phase_k5():
    """K5 against its plain version on the card, lam and V bit for bit;
    LAPACK-level accuracy; the K5b wrapper against its matmul plain
    version; times against torch.linalg.eigh."""
    import torch
    from qcqp_tpu_torch.kernels import eigh_kernel
    from qcqp_tpu_torch.kernels.eigh_kernel import (
        eigh_jacobi, eigh_jacobi_ref, eigh_jacobi_vec, eigh_jacobi_vec_ref)
    rng = np.random.default_rng(12)
    res, worst = {}, 0.0
    for B, n0, sweeps, rounds in K5_CASES:
        A = _sym_batch(rng, B, n0)
        lam, V = eigh_jacobi_vec(A, sweeps=sweeps, _rounds=rounds)
        lam_p, V_p = eigh_jacobi_vec_ref(A, sweeps=sweeps, _rounds=rounds)
        torch.cuda.synchronize()
        err = max(float((lam - lam_p).abs().max()),
                  float((V - V_p).abs().max()))
        key = f"B={B},n0={n0},sweeps={sweeps},rounds={rounds}"
        if not (torch.equal(lam, lam_p) and torch.equal(V, V_p)):
            raise AssertionError(f"K5 disagrees with its plain version at "
                                 f"{key}: max |d| {err}")
        worst = max(worst, err)
        out = {"identical": True}
        if sweeps == 8 and rounds is None:
            # converged: tests/test_eigh_pallas.py:31-37's 1e-4 of scale
            # against LAPACK, for K5 through both wrappers; eigh_jacobi's
            # plain version (jacobi_sweeps) rounds its J^T A J products
            # differently from K5's elementwise rotations, so the two agree
            # to that tolerance, not bit for bit.  The matmul version's own
            # float32 error grows with n and passes 1e-4 at n = 256
            # (recorded there, checked up to n = 128).
            lam_l, _ = torch.linalg.eigh(A)
            scale = float(lam_l.abs().max())
            eye = torch.eye(n0, device="cuda")
            l_b, V_b = eigh_jacobi(A, sweeps=8)
            l_m, V_m = eigh_jacobi_ref(A, 8)
            if not (torch.equal(l_b, lam) and torch.equal(V_b, V)):
                raise AssertionError(f"eigh_jacobi at {key} is not the "
                                     "kernel eigh_jacobi_vec launches")
            for name, (l_, V_) in (("k5", (lam, V)),
                                   ("k5b_plain", (l_m, V_m))):
                rec = V_ @ torch.diag_embed(l_) @ V_.transpose(-1, -2)
                errs = [float((l_ - lam_l).abs().max()) / scale,
                        float((rec - A).abs().max()) / scale,
                        float((V_.transpose(-1, -2) @ V_ - eye).abs().max())]
                out[f"{name}_vs_lapack"] = errs
                if max(errs) >= 1e-4 and (name == "k5" or n0 <= 128):
                    raise AssertionError(f"{name} at {key}: errors {errs} "
                                         "against LAPACK")
            out["k5b_vs_plain_lam"] = float((l_b - l_m).abs().max() / scale)
            if out["k5b_vs_plain_lam"] >= 1e-4 and n0 <= 128:
                raise AssertionError(f"eigh_jacobi at {key} is off its "
                                     "plain version")
        res[key] = out
    times = k5_times(eigh_kernel, rng)
    nonfinite = k5_nonfinite(eigh_jacobi_vec, eigh_jacobi_vec_ref)
    x = 1.0 + 3.0 * torch.rand(1 << 20, device="cuda")
    emit({"phase": "k5", "cases": res, "times_2sweeps": times,
          "nonfinite": nonfinite, "ptxas": _ptxas("eigh_kernel"),
          # why the kernel and its plain version take 1 / sqrt for the
          # JAX code's lax.rsqrt: torch.rsqrt rounds differently
          "rsqrt_ne_one_over_sqrt_of_2e20": int(
              (torch.rsqrt(x) != 1.0 / torch.sqrt(x)).sum())})
    return {"max_abs_err": worst, "times": times}


def k5_times(eigh_kernel, rng):
    """K5's time at K5_TIMED, 2 sweeps, by CUDA events around 20 calls
    queued behind a sleep kernel, so that the host's enqueue leaves the
    card no gap, after a warm-up one (which also makes the device
    schedule): `ms` one launch (`_launch`, without the wrapper's sort),
    `wrapper_ms` one eigh_jacobi_vec call (the launch and the sort, the
    scope of `plain_ms` and `library_ms`); with its bound, and the plain
    version's and torch.linalg.eigh's time."""
    import torch
    times = {}
    for B, n0 in K5_TIMED:
        A = _sym_batch(rng, B, n0)
        rounds = 2 * (eigh_kernel._padded(n0) - 1)

        def launch():
            return eigh_kernel._launch("eigh_jacobi_vec", A, n0, rounds)
        launch()
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)          # about 25 ms at 1.98 GHz
        out = {"ms": cuda_ms(launch, 20)}
        torch.cuda._sleep(50_000_000)
        out["wrapper_ms"] = cuda_ms(
            lambda: eigh_kernel.eigh_jacobi_vec(A, sweeps=2), 20)
        out["plain_ms"] = cuda_ms(
            lambda: eigh_kernel.eigh_jacobi_vec_ref(A, sweeps=2), 1)
        out["library_ms"] = cuda_ms(lambda: torch.linalg.eigh(A),
                                    20 if B == 1 else 3)
        out.update(k5_bound(B, n0, rounds))
        times[f"B={B},n0={n0}"] = out
    return times


def k5_nonfinite(eigh_vec, eigh_vec_ref):
    """The stated deviation on a non-finite input: one infinite entry (and
    its mirror).  The plain version's identity rotations on padded rows
    make 0 * inf = NaN there, which flows back into the real entries; the
    kernel leaves the padded rows out, so its NaN are fewer until both are
    NaN everywhere (by 2 sweeps at these shapes).  Records the NaN counts
    of both; fails if the kernel shows no NaN where the plain version
    does."""
    import torch
    rng = np.random.default_rng(3)
    out = {}
    for n0, rounds in ((25, 200), (25, 254), (101, 200), (101, 254)):
        A = _sym_batch(rng, 1, n0)
        A[0, 3, 5] = A[0, 5, 3] = float("inf")
        got = [int(t.isnan().sum()) for t in eigh_vec(A, _rounds=rounds)]
        want = [int(t.isnan().sum()) for t in eigh_vec_ref(A, _rounds=rounds)]
        if any(w and not g for g, w in zip(got, want)):
            raise AssertionError(f"K5 on a non-finite input at n0 = {n0}: "
                                 f"NaN {got}, its plain version's {want}")
        out[f"n0={n0},rounds={rounds}"] = {"kernel_nan_lam_V": got,
                                           "plain_nan_lam_V": want}
    return out


def bls_sdr_arrays(n=SDR_N, seed=2):
    """The n = 100 boolean-least-squares SDR of bench.py:287-305."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n + 20, n))
    return bls_arrays(A, rng.standard_normal(n + 20))


def drifted_bank(S, ns, seed=5):
    """bench.py:337-355's bank of S drifted boolean-LS instances at n = ns
    (the same draws in the same order), built on the card in float32."""
    import torch
    from qcqp_tpu_torch.core import QCQPForm
    rng = np.random.default_rng(seed)
    base_A = rng.standard_normal((ns + 8, ns))
    P = torch.zeros((S, ns + 1, ns, ns), dtype=torch.float32, device="cuda")
    q = torch.zeros((S, ns + 1, ns), dtype=torch.float32, device="cuda")
    r = -torch.ones((S, ns + 1), dtype=torch.float32, device="cuda")
    idx = torch.arange(ns, device="cuda")
    P[:, 1 + idx, idx, idx] = 1.0
    for si in range(S):
        A_s = base_A + 0.05 * rng.standard_normal((ns + 8, ns))
        b_s = rng.standard_normal(ns + 8)
        P[si, 0] = torch.from_numpy(A_s.T @ A_s)
        q[si, 0] = torch.from_numpy(-2.0 * A_s.T @ b_s)
        r[si, 0] = float(b_s @ b_s)
    return QCQPForm(P, q, r, torch.ones((S, ns), dtype=torch.bool,
                                        device="cuda"))


def _lockstep(name, run):
    """run() through K5, then with K5's plain version in its place: the
    outputs (X, primal and dual residuals) bit for bit."""
    import torch
    from qcqp_tpu_torch.kernels import eigh_kernel
    ms, kern = host_ms(run)
    kernel_fn = eigh_kernel.eigh_jacobi_vec
    eigh_kernel.eigh_jacobi_vec = eigh_kernel.eigh_jacobi_vec_ref
    try:
        plain = run()
    finally:
        eigh_kernel.eigh_jacobi_vec = kernel_fn
    for a, b in zip(kern, plain):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: the first {LOCKSTEP_ITERS} "
                                 "iterations differ between K5 and its "
                                 "plain version")
    return {"iterations": LOCKSTEP_ITERS, "identical": True, "ms": ms,
            "max_res": float(torch.maximum(kern[1], kern[2]).max())}


def _bank_run(stacked):
    """solve_sdr_batch(psd_method="vec", fallback=False) at the fixed
    budget: nothing re-solved, the accept rate as the gate found it."""
    import torch
    from qcqp_tpu_torch.kernels.eigh_kernel import eigh_jacobi_vec
    from qcqp_tpu_torch.solvers import sdp
    S = stacked.P.shape[0]
    before = eigh_jacobi_vec.launches
    ms, (X, obj, rp, rd, acc) = host_ms(lambda: sdp.solve_sdr_batch(
        stacked, max_iters=SDR_BANK_ITERS, psd_method="vec", fallback=False,
        return_accept=True))
    launches = eigh_jacobi_vec.launches - before
    if not (bool(torch.isfinite(X).all())
            and X.shape == (S, stacked.n + 1, stacked.n + 1)):
        raise AssertionError("solve_sdr_batch returned non-finite values")
    return {"S": S, "n": stacked.n, "max_iters": SDR_BANK_ITERS, "ms": ms,
            "iterations_per_s": launches / ms * 1e3,
            "k5_launches": launches, "accepted": int(acc.sum()),
            "accept_rate": float(acc.mean()),
            "max_res": float(torch.maximum(rp, rd).max()),
            "bounds_first": [float(v) for v in obj[:3]]}, acc


def phase_sdr_path():
    """The n = 100 boolean-LS SDR on the default (Newton-Schulz) route and
    the vec route's first iterations against K5's plain version; then the
    K5 path: solve_sdr_batch(psd_method="vec", fallback=False) on the
    S = 16 and S = 132 banks, with the launch counts set to 0 before and
    read after."""
    import torch
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels import eigh_kernel
    from qcqp_tpu_torch.solvers import sdp
    form = form_from_numpy(*bls_sdr_arrays(), device="cuda",
                           dtype=torch.float32)
    out = {"n": SDR_N, "m": SDR_N}
    sdp.solve_sdr(form, device="device", full=True, check=False,
                  max_iters=50)                          # warm-up
    tail = sdp.solve_sdp.masked_tail
    ms, sol = host_ms(lambda: sdp.solve_sdr(form, device="device", full=True,
                                            check=False))
    its = int(sol.iterations)
    tail = sdp.solve_sdp.masked_tail - tail
    # device="auto" takes this result, with no retry and no float64
    # re-solve, when the acceptance gate passes it
    accepted = sdp._accepted(form, sol, sdp._unscaled_rel_viol)
    out["default_route"] = {"ms": ms, "iterations": its,
                            "ms_per_iteration": ms / (its + tail),
                            # loop passes after the solve had finished
                            "masked_tail_iterations": tail,
                            "masked_tail_ms": ms * tail / (its + tail),
                            "rp": float(sol.primal_res),
                            "rd": float(sol.dual_res),
                            "bound": float(sol.objective),
                            "accepted_without_resolve": accepted}
    if not (accepted and bool(torch.isfinite(sol.X).all())):
        raise AssertionError(f"default SDR route: {out['default_route']}")

    data = sdp._sdr_data(form)
    vec_kw = dict(psd_method="vec", warm_sweeps=2, accel_mem=0, alpha=1.6,
                  detect_certificates=False)

    def vec_single():
        s = sdp.solve_sdp(data, max_iters=LOCKSTEP_ITERS, tol=0.0, **vec_kw)
        return s.X, s.primal_res, s.dual_res
    out["vec_single_lockstep"] = _lockstep("the n = 100 vec solve",
                                           vec_single)
    out["vec_single_lockstep"]["ms_per_iteration"] = \
        out["vec_single_lockstep"]["ms"] / LOCKSTEP_ITERS

    bank16, bank132 = drifted_bank(16, 24), drifted_bank(132, SDR_N)

    def bank16_first():
        X, _, rp, rd = sdp.solve_sdr_batch(
            bank16, max_iters=LOCKSTEP_ITERS, psd_method="vec", gate=None)
        return X, rp, rd
    out["vec_S16_lockstep"] = _lockstep("the S = 16 vec bank", bank16_first)

    # the K5 path
    eigh_kernel.eigh_jacobi_vec.launches = 0
    out["vec_S16"], acc16 = _bank_run(bank16)
    out["vec_S132"], _ = _bank_run(bank132)
    launches = eigh_kernel.eigh_jacobi_vec.launches
    if launches == 0:
        raise AssertionError("the vec banks launched K5 no time")
    emit({"phase": "sdr_path", **out, "k5_launches": launches})
    return {"launches": launches, "acc16": acc16, "bank16": bank16}


def phase_sdr_golden(bank16, acc16):
    """The batch fallback's count on the S = 16 vec bank: one
    solve_sdr_batch(psd_method="vec") with its float64 fallback, whose
    counter must rise once per instance the gate rejects.  (The SDR
    goldens on the card and the handler's SDR suggest and solve run in
    phase tooling, through the examples.)"""
    import logging
    import torch
    from qcqp_tpu_torch.solvers import sdp

    # the batch fallback: one call with fallback on, at the budget of the
    # sdr_path phase's fallback-free run of the same bank; each instance
    # the gate rejects is logged and counted once
    class Count(logging.Handler):
        n = 0

        def emit(self, record):
            if "re-solving in float64" in record.getMessage():
                Count.n += 1
    log = logging.getLogger("qcqp_tpu_torch")
    handler, level = Count(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    before = sdp.solve_sdr_batch.fallbacks
    try:
        ms, (_, _, rp, rd, acc) = host_ms(lambda: sdp.solve_sdr_batch(
            bank16, max_iters=SDR_BANK_ITERS, psd_method="vec",
            return_accept=True))
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    counted = sdp.solve_sdr_batch.fallbacks - before
    out = {"batch_fallback": {
        "S": int(bank16.P.shape[0]), "max_iters": SDR_BANK_ITERS,
        "fallbacks": counted,
        "logged": Count.n, "rejected_in_sdr_path": int((~acc16).sum()),
        "accept_rate_after": float(acc.mean()),
        "max_res_after": float(torch.maximum(rp, rd).max()),
        "ms_with_fallbacks": ms}}
    emit({"phase": "sdr_golden", **out})
    if counted != Count.n or counted != int((~acc16).sum()):
        raise AssertionError(f"batch fallback: {out['batch_fallback']}")


# phase tooling: the JAX package's examples on the card through
# qcqp_tpu_torch.examples, with the SDR goldens of tests/test_api_examples.py
# and BASELINE.md (the maximize problems report the un-negated bound)
EXAMPLE_SDR_GOLDENS = {"boolean_least_squares": 28.750, "maxcut": 57.207,
                       "circle_packing": 5.000,
                       "secondary_user_beamforming": 1.970}
GOLDEN_TOL = 2e-2
BLS_BEST = 35.550                       # brute force, 256 SDR restarts
# the K1, K3 and K4 launches each example's chain must make: CD through
# QCQP.solve and solve_scenarios (single-restart CD is the plain loop, as
# in the JAX handler), ADMM and DCCP through the handler's kernel routes
EXAMPLE_KERNELS = {"boolean_least_squares": ("k1", "k3", "k4"),
                   "maxcut": ("k3", "k4"), "circle_packing": ("k3", "k4"),
                   "secondary_user_beamforming": ("k3", "k4"),
                   "scenario_serving": ("k1",)}
# the beamforming DCCP on the card: K4 in float32 at the JAX handler's
# accelerator defaults (5 Newton trips, inner_tol 1e-5, 40 inner trips)
# ends at violation 7.1e-4; the JAX package's own Pallas kernel in float32
# from one start ends at 6.9e-4 (interpret mode on the CPU), the port's
# plain version at 6.9e-4; the golden's 1e-4 is the float64 route's
# (tests/test_api_examples.py), held in tests/test_torch_example_*.py
BEAMFORMING_DCCP_VIOL = 1e-3
# the traces on the card: the bench form (n = 100, m = 50, seed 0) from
# one numpy start; sdp_trace on sdr_path's n = 100 boolean-LS SDR form
TRACE_CD_SWEEPS, TRACE_ADMM_ITERS, TRACE_CCP_OUTERS = 2, 200, 3
TRACE_SDP_ITERS = 300
# card against CPU, both float32, same start: the largest gap of a
# history, relative to 1 + |CPU value|, for the traces that are determined
# (in float64 the card meets the CPU to 2e-12 on both).  In float32 the
# card's eighs (cuSOLVER) carry 4e-5 of error in the eigenvalues where
# LAPACK's carry 1.4e-6 (ADMM's rho and projection bases, the SDP's cone
# projection), and the histories part by up to 5.2e-3 (ADMM, 200
# iterations) and 6.0e-3 (SDP, 300 iterations), where the CPU's float32
# parts from its float64 by 5e-5.  CD's phase 1 and CCP's inner
# splitting part at round-off, so those hold test_aux.py's properties.
TRACE_RTOL = {"admm": 1e-2, "sdp": 1e-2}
PROFILE_R_K3 = 1024


def _kernel_counters():
    from qcqp_tpu_torch.kernels.admm_kernel import admm_phase
    from qcqp_tpu_torch.kernels.ccp_kernel import ccp_improve
    from qcqp_tpu_torch.kernels.cd_sweep_kernel import two_phase_sweeps
    return {"k1": two_phase_sweeps, "k3": admm_phase, "k4": ccp_improve}


def _sdp_spy(solves):
    """Wrap solvers/sdp.solve_sdp so that each splitting loop appends its
    (dtype, iterations, residuals) to `solves`; returns the undo.
    solve_sdp counts its masked tail on its module name: the spy carries
    the count and the undo hands it back."""
    from qcqp_tpu_torch.solvers import sdp
    solve_sdp = sdp.solve_sdp

    def spy(*a, **kw):
        sol = solve_sdp(*a, **kw)
        solves.append({"dtype": str(sol.X.dtype).replace("torch.", ""),
                       "iterations": sol.iterations.tolist(),
                       "rp": sol.primal_res.tolist(),
                       "rd": sol.dual_res.tolist()})
        return sol
    spy.masked_tail = solve_sdp.masked_tail
    sdp.solve_sdp = spy

    def undo():
        sdp.solve_sdp = solve_sdp
        solve_sdp.masked_tail = spy.masked_tail
    return undo


def _run_example(name, **kw):
    """One example's main() on its default device (the card), its printed
    lines captured: the kernels' launches, the SDR solves and route, the
    float64 re-solves and the wall time."""
    import contextlib
    import importlib
    import io
    from qcqp_tpu_torch.solvers import sdp
    mod = importlib.import_module(f"qcqp_tpu_torch.examples.{name}")
    counters = _kernel_counters()
    for c in counters.values():
        c.launches = 0
    solves = []
    undo = _sdp_spy(solves)
    tail, resolves = sdp.solve_sdp.masked_tail, sdp.solve_sdr.resolves
    fallbacks = sdp.solve_sdr_batch.fallbacks
    sdp._solve_single.route = None
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            ms, out = host_ms(lambda: mod.main(**kw))
    finally:
        undo()
    out.update(ms=ms, printed=printed.getvalue().splitlines(),
               launches={k: c.launches for k, c in counters.items()},
               sdr_solves=solves, sdr_route=sdp._solve_single.route,
               masked_tail_iterations=sdp.solve_sdp.masked_tail - tail,
               f64_resolves=sdp.solve_sdr.resolves - resolves,
               f64_batch_fallbacks=sdp.solve_sdr_batch.fallbacks
               - fallbacks)
    return out


def _serving_example(workdir):
    """(a) of phase scenarios: examples/scenario_serving.py at its own size
    on the card (S = 8 boolean least-squares instances, n = m = 12),
    through qcqp_tpu_torch.examples.scenario_serving.main: bank write
    (float64), forms_from_bank (float32 on the card), solve_sdr_batch on
    its default float32 route and solve_scenarios (64 restarts, CD through
    one K1 launch), the last two timed apart."""
    from qcqp_tpu_torch.examples import scenario_serving as ex
    ms, real = {}, (ex.solve_sdr_batch, ex.solve_scenarios)

    def timed_as(key, fn):
        def call(*a, **kw):
            ms[key], out = host_ms(lambda: fn(*a, **kw))
            return out
        return call
    ex.solve_sdr_batch = timed_as("sdr_ms", real[0])
    ex.solve_scenarios = timed_as("cd_ms", real[1])
    try:
        out = _run_example("scenario_serving", workdir=workdir)
    finally:
        ex.solve_sdr_batch, ex.solve_scenarios = real
    out.update(ms)
    return out


def _check_example(name, out):
    """The example's goldens and routes; returns the report (no handler,
    no arrays) and the list of failed checks."""
    pairs = {k: v for k, v in out.items()
             if isinstance(v, tuple) and len(v) == 2 and k != "x_shape"}
    rep = {k: out[k] for k in ("device", "dtype", "ms", "launches",
                               "sdr_solves", "sdr_route",
                               "masked_tail_iterations", "f64_resolves",
                               "f64_batch_fallbacks", "printed")}
    rep.update({k: list(v) for k, v in pairs.items()})
    bad = []
    if not (out["device"].startswith("cuda")
            and out["dtype"] == "torch.float32"):
        bad.append("not on the card in float32")
    if not all(np.isfinite(v) for p in pairs.values() for v in p):
        bad.append("a non-finite (f, v)")
    missing = [k for k in EXAMPLE_KERNELS[name] if out["launches"][k] < 1]
    if missing:
        bad.append(f"no launch of {missing}")
    if out["f64_resolves"]:
        bad.append("a float64 re-solve")
    if name in EXAMPLE_SDR_GOLDENS:
        h = out["qcqp"]
        rep.update(sdr_bound=h.sdr_bound,
                   sdr_golden=EXAMPLE_SDR_GOLDENS[name])
        if abs(h.sdr_bound - EXAMPLE_SDR_GOLDENS[name]) > GOLDEN_TOL:
            bad.append("SDR golden")
        # accepted by the gate on the first float32 attempt on the card,
        # and the sampler's factors on the card
        if out["sdr_route"] != "device" or len(out["sdr_solves"]) != 1:
            bad.append("SDR route")
        if not (h.mu.is_cuda and h._sigma_chol.is_cuda):
            bad.append("SDR sampler not on the card")
    if name == "boolean_least_squares":
        A, b = boolean_ls_data()
        n = A.shape[1]
        signs = np.array([[1.0 if bits >> i & 1 else -1.0 for i in range(n)]
                          for bits in range(1 << n)])
        rep["brute_force"] = float(np.min(np.sum((signs @ A.T - b) ** 2,
                                                 axis=1)))
        f, v = out["best_of_256"]
        if not (v < 1e-2 and abs(f - BLS_BEST) <= GOLDEN_TOL):
            bad.append("best of 256")
    if name == "secondary_user_beamforming":
        f, v = out["dccp"]
        if not (v < BEAMFORMING_DCCP_VIOL and f <= 2.5):
            bad.append("beamforming DCCP")
    if name == "scenario_serving":
        rep.update({k: np.asarray(out[k]).tolist()
                    for k in ("sdr_bounds", "best_f", "best_viol")})
        rep.update(S=out["S"], n=out["n"], m=out["m"],
                   sdr_ms=out["sdr_ms"], cd_ms=out["cd_ms"],
                   sdr_max_residual=out["sdr_max_residual"],
                   x_shape=list(out["x_shape"]))
        if out["launches"]["k1"] != 1 or out["x_shape"] != (out["S"],
                                                           out["n"]):
            bad.append("serving: one K1 launch, (S, n) points")
        if not ((out["best_viol"] < 1e-2).all()
                and (out["best_f"] >= out["sdr_bounds"] - 1e-3).all()):
            bad.append("serving: feasible and above the SDR bounds")
    return rep, bad


def _trace_gap(a, b):
    """Largest |a - b| / (1 + |b|) over a history."""
    a, b = a.double().cpu(), b.double().cpu()
    return float(((a - b).abs() / (1.0 + b.abs())).max())


def _trace_runs():
    """The traces of phase tooling, each a function of the device: the
    bench form (n = 100, m = 50, seed 0) from one numpy start, boolean
    least squares for CD, sdr_path's n = 100 SDR form, float32."""
    import torch
    from qcqp_tpu_torch import diagnostics as dg
    from qcqp_tpu_torch.convert import form_from_numpy

    def on(dev, arrays):
        return form_from_numpy(*arrays, device=dev, dtype=torch.float32)
    bench = bench_form_arrays(0)
    x0 = np.random.default_rng(0).standard_normal(N)
    bls = boolean_ls_arrays()
    x0_bls = np.random.default_rng(0).standard_normal(bls[1].shape[1])
    return {"cd": lambda d: dg.cd_trace(on(d, bench), x0,
                                        sweeps=TRACE_CD_SWEEPS),
            "cd_boolean_ls": lambda d: dg.cd_trace(on(d, bls), x0_bls,
                                                   sweeps=10),
            "admm": lambda d: dg.admm_trace(on(d, bench), x0,
                                            iters=TRACE_ADMM_ITERS),
            "ccp": lambda d: dg.ccp_trace(on(d, bench), x0,
                                          outers=TRACE_CCP_OUTERS),
            "sdp": lambda d: dg.sdp_trace(on(d, bls_sdr_arrays()),
                                          iters=TRACE_SDP_ITERS)}


def start_cpu_traces(workdir):
    """Start the CPU replays that phase tooling holds the card's ADMM and
    SDP traces against: they need no card, so a CPU process
    (`--cpu-traces`) makes them while the phases before tooling run."""
    path = os.path.join(workdir, "cpu_traces.npz")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-traces", path])
    proc.path = path
    return proc


def cpu_traces(path):
    """(run as `--cpu-traces PATH`) the TRACE_RTOL traces on the CPU in
    float32, their histories and ms, saved to PATH."""
    import torch
    torch.set_num_threads(2)
    sys.path.insert(0, REPO)
    runs, out = _trace_runs(), {}
    for name in TRACE_RTOL:
        t0 = time.perf_counter()
        for k, v in runs[name]("cpu").items():
            out[f"{name}/{k}"] = v.numpy()
        out[f"{name}/ms"] = (time.perf_counter() - t0) * 1e3
    np.savez(path, **out)


def _traces(cpu_proc):
    """The four traces on the card in float32: ADMM's and the SDP's held
    against the same traces on the CPU in float32 from the same start
    (made by the `--cpu-traces` process), CD's and CCP's to the
    properties of tests/test_aux.py (violation non-increasing to within
    one `better` bucket, CD's final violation under viol_tol on boolean
    least squares, the tau schedule exact)."""
    import torch
    runs = _trace_runs()
    taus = [0.005]                              # ccp_trace's defaults
    for _ in range(TRACE_CCP_OUTERS - 1):
        taus.append(min(taus[-1] * 1.4, 1e8))
    out, bad = {}, []
    for name, run in runs.items():
        ms, card = host_ms(lambda: run("cuda"))
        hist = {k: v for k, v in card.items() if k not in ("x", "z", "X")}
        rep = {"ms_card": ms,
               "first_last": {k: [v[0].item(), v[-1].item()]
                              for k, v in hist.items()}}
        if not (all(v.is_cuda for v in card.values())
                and all(bool(torch.isfinite(v).all()) for v in hist.values())):
            bad.append(f"{name}: on the card, finite")
        if name in TRACE_RTOL:
            if cpu_proc.wait(timeout=300) != 0:
                raise AssertionError("the --cpu-traces process failed")
            with np.load(cpu_proc.path) as z:
                cpu = {k: torch.from_numpy(z[f"{name}/{k}"]) for k in hist}
                rep["ms_cpu"] = float(z[f"{name}/ms"])
            rep.update(rtol=TRACE_RTOL[name],
                       gap={k: _trace_gap(v, cpu[k]) for k, v in hist.items()})
            if max(rep["gap"].values()) > TRACE_RTOL[name]:
                bad.append(f"{name}: card against CPU")
        else:
            steps = np.diff(hist["violation"].cpu().numpy())
            rep["max_violation_rise"] = float(steps.max(initial=0.0))
            if (steps > 1e-4 + 1e-6).any():
                bad.append(f"{name}: violation rose")
        if name == "cd_boolean_ls" and not hist["violation"][-1] < 1e-2:
            bad.append("cd_boolean_ls: final violation")
        if name == "ccp" and not torch.equal(
                card["tau"].cpu(), torch.tensor(taus, dtype=torch.float32)):
            bad.append("ccp: tau schedule")
        out[name] = rep
    return out, bad


def _profiled(workdir):
    """torch_profile around one K1 solve (R = 10,240) and one K3 ADMM
    solve (R = 1,024, 50 iterations): the trace files parse and list the
    kernels' launches; and `timed` around one K1 solve against its CUDA
    events."""
    import torch
    import qcqp_tpu_torch as qt
    from qcqp_tpu_torch import diagnostics as dg
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.parallel.restarts import solve_restarts
    form = form_from_numpy(*bench_form_arrays(0), device="cuda",
                           dtype=torch.float32)
    counters = _kernel_counters()

    def gen():
        return torch.Generator(device="cuda").manual_seed(1)
    out, bad = {}, []
    for name, kernel, solve in (
            ("k1", "cd_sweep_kernel",
             lambda: solve_restarts(form, R_MAIN, gen(), num_iters=SWEEPS)),
            ("k3", "admm_phase_kernel",
             lambda: solve_restarts(form, PROFILE_R_K3, gen(),
                                    improve=qt.ADMM, num_iters=ADMM_ITERS))):
        counters[name].launches = 0
        logdir = os.path.join(workdir, f"profile_{name}")
        t0 = time.perf_counter()
        with dg.torch_profile(logdir) as prof:
            solve()
        seconds = time.perf_counter() - t0
        launches = counters[name].launches
        with open(prof.trace_path) as f:
            trace = json.load(f)
        events = [e for e in trace.get("traceEvents", [])
                  if e.get("cat") == "kernel" and kernel in e.get("name", "")]
        listed = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and kernel in e.name]
        out[name] = {"seconds_profiled": seconds,
                     "trace_bytes": os.path.getsize(prof.trace_path),
                     "trace_kernel_events": len(events),
                     "key_averages_events": len(listed),
                     "launches": launches,
                     "kernel_names": sorted({e["name"][:80]
                                             for e in events}),
                     "device_ms": sum(e.get("dur", 0) for e in events) / 1e3}
        if not events or len(events) != launches:
            bad.append(f"profile {name}: {len(events)} events, "
                       f"{launches} launches")
    res = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with dg.timed("k1_solve", res):
        start.record()
        solve_restarts(form, R_MAIN, gen(), num_iters=SWEEPS)
        end.record()
    out["timed"] = {"timed_ms": res["k1_solve"] * 1e3,
                    "event_ms": start.elapsed_time(end)}
    if not out["timed"]["timed_ms"] >= out["timed"]["event_ms"]:
        bad.append("timed read less than the CUDA events")
    return out, bad


def phase_tooling(workdir, cpu_proc):
    """The tooling on the card (qcqp_tpu_torch/examples, diagnostics.py):
    the five examples through main() on the default device, held to the
    goldens, their K1/K3/K4 launches counted; the four traces on the card
    against the CPU; torch_profile around a K1 and a K3 solve; timed
    around a K1 solve."""
    examples, bad = {}, []
    for name in EXAMPLE_KERNELS:
        out = (_serving_example(workdir) if name == "scenario_serving"
               else _run_example(name))
        rep, fails = _check_example(name, out)
        examples[name] = rep
        bad += [f"{name}: {f}" for f in fails]
    traces, fails = _traces(cpu_proc)
    bad += fails
    profiled, fails = _profiled(workdir)
    bad += fails
    emit({"phase": "tooling", "examples": examples, "traces": traces,
          "profile": profiled})
    if bad:
        raise AssertionError(f"tooling: {bad}")
    return {"sdr_bound": examples["boolean_least_squares"]["sdr_bound"],
            "launches": {name: rep["launches"]
                         for name, rep in examples.items()},
            "ms": {name: rep["ms"] for name, rep in examples.items()},
            "serving": examples["scenario_serving"],
            "k3_profile": profiled["k3"]}


# the JAX package's float64 spectral bound of the boolean-LS problem
# (examples/boolean_least_squares.py): qcqp_tpu.QCQP(prob).suggest(SPECTRAL)
# on the CPU; the float32 bound on the card is held to it at the SDR
# goldens' tolerance
SPECTRAL_BLS_BOUND, SPECTRAL_TOL = 13.736533233436749, 2e-2
R_SPECTRAL = 256


def phase_spectral(sdr_bound):
    """QCQP(prob).suggest(SPECTRAL) on the boolean-LS problem, on the card
    in float32: the route, iterations, time and bound, the bound against
    the SDR bound and the JAX package's float64 bound; then SPECTRAL
    starts through solve_restarts and K1, with K1's count set to 0 before
    and read after."""
    import torch
    import qcqp_tpu_torch as qt
    from qcqp_tpu_torch.kernels.cd_sweep_kernel import two_phase_sweeps
    from qcqp_tpu_torch.solvers import sdp
    A, b = boolean_ls_data()
    x = qt.Variable(A.shape[1])
    h = qt.QCQP(qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                           [qt.square(x) == 1]))
    if h.device.type != "cuda" or h.qcqp_form.dtype != torch.float32:
        raise AssertionError("the handler did not default to CUDA float32")
    # each splitting loop the suggest runs (first attempt, retry, float64)
    solves = []
    sdp._solve_single.route = None
    undo = _sdp_spy(solves)
    try:
        ms, (f, v) = host_ms(lambda: h.suggest(qt.SPECTRAL))
    finally:
        undo()
    bound = h.spectral_bound
    out = {"route": sdp._solve_single.route, "solves": solves, "ms": ms,
           "bound": bound, "sdr_bound": sdr_bound,
           "jax_f64_bound": SPECTRAL_BLS_BOUND,
           "bound_minus_jax": bound - SPECTRAL_BLS_BOUND, "tol": SPECTRAL_TOL,
           "point_objective": f, "point_violation": v}
    xs = h.spectral_sol
    if not (bool(torch.isfinite(xs).all()) and xs.is_cuda
            and np.isfinite(bound) and bound <= sdr_bound
            and abs(bound - SPECTRAL_BLS_BOUND) <= SPECTRAL_TOL):
        raise AssertionError(f"SPECTRAL suggest: {out}")

    # the SPECTRAL -> CD path: the handler's point in every restart
    two_phase_sweeps.launches = 0
    ms, (xb, fb, vb) = host_ms(lambda: qt.solve_restarts(
        h.qcqp_form, R_SPECTRAL, suggest=qt.SPECTRAL,
        improve=qt.COORD_DESCENT, handler=h, num_iters=50))
    launches = two_phase_sweeps.launches
    out["solve_restarts_cd"] = {"R": R_SPECTRAL, "ms": ms,
                                "best_f": float(fb), "best_viol": float(vb),
                                "k1_launches": launches}
    emit({"phase": "spectral", **out})
    if launches != 1 or not (torch.isfinite(xb).all() and float(vb) < 1e-2):
        raise AssertionError(f"SPECTRAL -> CD: {out['solve_restarts_cd']}")
    return {"k1_launches": launches}


R_NLP = (128, 10240)                  # bench.py:242 (BENCH_CCP_R); 10^4
NLP_REPEATS = {128: 1, 10240: 1}      # timed solves per R
# the schedule of the card-against-CPU lane check: the default schedule's
# trajectories on the bench form amplify a few-ulp change of the start
# into an order-1 change of (f, v) on every lane, so the lanes are held
# where they are still determined: one BB sweep of 20 steps and one outer
# trip of 3 Newton trips
NLP_LANE_KW = dict(bb_outer_n=1, bb_inner=20, num_outer=1, num_inner=3)


def _armijo_alt(form, Pt, xi, p, val, gp, lmb, mu, act):
    """solvers/nlp._armijo with a host read a trip, stopping once no lane
    backtracks: the alternative timed beside it in phase nlp_path."""
    import torch
    from qcqp_tpu_torch.solvers.nlp import _al_value_grad
    alpha = torch.ones_like(val)
    v_new, _ = _al_value_grad(form, xi - p, lmb, mu, Pt, grad=False)
    trips = torch.zeros_like(val, dtype=torch.long)
    for _ in range(16):
        bt = act & ~(v_new <= val - 1e-4 * alpha * gp)
        if not bool(bt.any()):
            break
        alpha_n = alpha * 0.5
        vn, _ = _al_value_grad(form, xi - alpha_n[:, None] * p, lmb, mu, Pt,
                               grad=False)
        alpha = torch.where(bt, alpha_n, alpha)
        v_new = torch.where(bt, vn, v_new)
        trips = trips + bt.long()
    return alpha, v_new, trips


def phase_nlp_path(arrays):
    """improve=IPOPT on the bench form in float32 on the card, RANDOM
    starts: one warm-up and NLP_REPEATS timed improves at each R (the
    improve alone, as bench.py:266-271 times it: 3 at R = 128, 1 at
    10,240), in turns with the Armijo loop that reads the host once a trip
    on the first two timed solves' starts at R = 128 and the one at 10,240
    (equal bit for bit); 16 starts in float64 on the card against the CPU;
    the handler's improve(IPOPT) on boolean least squares."""
    import torch
    import qcqp_tpu_torch as qt
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.core import eval_objective_batch, max_violation_batch
    from qcqp_tpu_torch.parallel.restarts import best_point, suggest_batch
    from qcqp_tpu_torch.solvers import nlp
    improve_nlp = nlp.improve_nlp
    form = form_from_numpy(*arrays, device="cuda", dtype=torch.float32)

    def starts(seed, R):
        return suggest_batch(form, R,
                             torch.Generator(device="cuda").manual_seed(seed))
    out = {}
    for R in R_NLP:
        improve_nlp(form, starts(0, R), **NLP_LANE_KW)  # warm-up
        times, reads, trips, alt_ms = [], [], [], []
        repeats = NLP_REPEATS[R]
        for seed in range(1, 1 + repeats):
            xs = starts(seed, R)
            r0, t0 = improve_nlp.host_reads, improve_nlp.newton_trips
            ms, x = host_ms(lambda: improve_nlp(form, xs))
            times.append(ms)
            reads.append(improve_nlp.host_reads - r0)
            trips.append(improve_nlp.newton_trips - t0)
            if seed == 1:
                x_first = x
            if seed == repeats > 1:
                break
            # the Armijo loop with host reads on the same starts, in turns
            # with the masked one: the same lanes bit for bit
            armijo, nlp._armijo = nlp._armijo, _armijo_alt
            try:
                ms, x_alt = host_ms(lambda: improve_nlp(form, xs))
            finally:
                nlp._armijo = armijo
            alt_ms.append(ms)
            if not torch.equal(x_alt, x):
                raise AssertionError(f"NLP path, R = {R}: the two Armijo "
                                     "loops do not give the same lanes")
        if not (torch.isfinite(x_first).all() and x_first.shape == (R, N)):
            raise AssertionError(f"NLP path, R = {R}: a non-finite lane")
        v = max_violation_batch(form, x_first)
        _, fb, vb = best_point(form, x_first)
        ms = float(np.median(times))
        out[f"R={R}"] = {
            "ms_per_solve": times, "restarts_per_s": R / ms * 1e3,
            "best_f": float(fb), "best_viol": float(vb),
            "share_viol_below_1e-3": float((v < 1e-3).float().mean()),
            # a float32 lane that ran off to |x| ~ 1e19 overflows x'Px
            "lanes_viol_nonfinite": int((~torch.isfinite(v)).sum()),
            "median_viol_finite": float(v[torch.isfinite(v)].median()),
            "newton_trips_per_solve": trips, "host_reads_per_solve": reads,
            "armijo_alt_ms": alt_ms}

    # 16 starts in float64: the card against the CPU, lane by lane, on
    # the lanes the CPU determines (its (f, v) moves by less than 1e-9
    # when the starts move by a few ulps; three draws in one batch)
    cpu = form_from_numpy(*arrays, device="cpu", dtype=torch.float64)
    card = form_from_numpy(*arrays, device="cuda", dtype=torch.float64)
    X0 = starts(7, 16).double().cpu()
    Xs = torch.cat([X0] + [X0 * (1.0 + 4e-16 * torch.randn(
        X0.shape, generator=torch.Generator().manual_seed(50 + s),
        dtype=torch.float64)) for s in range(3)])
    t0 = time.perf_counter()
    xc = improve_nlp(cpu, Xs, **NLP_LANE_KW)
    cpu_s = time.perf_counter() - t0
    fc = eval_objective_batch(cpu, xc).numpy().reshape(4, 16)
    vc = max_violation_batch(cpu, xc).numpy().reshape(4, 16)

    def rel(a, b):
        return np.abs(a - b) / (1.0 + np.abs(b))
    spread = np.maximum(rel(fc[1:], fc[0]), rel(vc[1:], vc[0])).max(axis=0)
    determined = spread < 1e-9
    xg = improve_nlp(card, X0.cuda(), **NLP_LANE_KW)
    fg = eval_objective_batch(card, xg).cpu().numpy()
    vg = max_violation_batch(card, xg).cpu().numpy()
    parted = np.maximum(rel(fg, fc[0]), rel(vg, vc[0]))
    out["card_f64_vs_cpu_f64"] = {
        "lanes": 16, "schedule": NLP_LANE_KW,
        "determined": int(determined.sum()),
        "max_rel_on_determined": float(parted[determined].max()),
        "max_rel_all": float(parted.max()), "cpu_s_64_lanes": cpu_s}
    if determined.sum() < 12 or not (parted[determined] < 1e-6).all():
        raise AssertionError(f"NLP card f64 vs CPU f64: "
                             f"{out['card_f64_vs_cpu_f64']}")

    # the handler: RANDOM, then improve(IPOPT), as
    # tests/test_api_examples.py:101-106
    A, b = boolean_ls_data()
    x = qt.Variable(A.shape[1])
    h = qt.QCQP(qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                           [qt.square(x) == 1]))
    h.suggest(qt.RANDOM)
    x0 = x.value.copy()
    ms, (f, v) = host_ms(lambda: h.improve(qt.IPOPT))
    # one restart: the Armijo loop with host reads from the same start
    x.value = x0
    armijo, nlp._armijo = nlp._armijo, _armijo_alt
    try:
        alt_ms, (f_alt, v_alt) = host_ms(lambda: h.improve(qt.IPOPT))
    finally:
        nlp._armijo = armijo
    out["handler_ipopt"] = {"objective": f, "violation": v, "ms": ms,
                            "armijo_alt_ms": alt_ms}
    if (f_alt, v_alt) != (f, v):
        raise AssertionError("QCQP.improve(IPOPT): the two Armijo loops "
                             "differ")
    emit({"phase": "nlp_path", "n": N, "m": M, **out})
    if not (np.isfinite(f) and v < 1e-4):
        raise AssertionError(f"QCQP.improve(IPOPT): {out['handler_ipopt']}")
    return {f"ms_R{R}": float(np.median(out[f"R={R}"]["ms_per_solve"]))
            for R in R_NLP}


S_SERVE, R_SERVE = 132, 64       # one scenario an SM; scenario_serving.py:55
SERVE_REPEATS = 3
K1_SAMPLE = (0, 1)                 # scenarios whose lanes size K1's bound
S_ROUTES, CCP_ROUTE_KW = 4, dict(max_iter=6)  # phase (c); 1/10 of the trips


def serving_bank_arrays():
    """S_SERVE instances of bench.py's form (n = 100, m = 50), instance s
    from seed s, each with its own equality pattern, stacked in float64."""
    out = [np.empty((S_SERVE, M + 1, N, N)), np.empty((S_SERVE, M + 1, N)),
           np.empty((S_SERVE, M + 1)), np.empty((S_SERVE, M), bool)]
    for s in range(S_SERVE):
        for a, b in zip(out, bench_form_arrays(s)):
            a[s] = b
    return out


def scenario_starts(S, R, n, seed, device="cuda"):
    """The starts solve_scenarios draws from a generator seeded `seed`:
    one (R, n) float32 draw a scenario, in scenario order."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.stack([torch.randn((R, n), generator=gen,
                                    dtype=torch.float32, device=device)
                        for _ in range(S)])


def start_k1_sample(workdir):
    """Start the count of K1's work on a sample of the serving grid: the
    first timed solve's starts of the K1_SAMPLE scenarios, drawn here on
    the card, go to a file, and a CPU process (`--k1-sample`) runs K1's
    plain version on them while the phases before `scenarios` run."""
    xs = scenario_starts(max(K1_SAMPLE) + 1, R_SERVE, N, 1)
    path = os.path.join(workdir, "k1_sample.npz")
    np.savez(path, xs=xs[list(K1_SAMPLE)].cpu().numpy())
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--k1-sample", path],
        stdout=subprocess.PIPE, text=True)


def _plain_counts(arrays, xs):
    """K1's plain version in float32 on the CPU on starts xs at SWEEPS
    sweeps: its restart-sweeps and probes, and the CPU seconds."""
    import torch
    from qcqp_tpu_torch.kernels import cd_sweep_kernel as k1
    from qcqp_tpu_torch.kernels.onevar_kernel import bisect_accept
    P, q, r, is_eq = arrays
    k1._phase1_loop.lane_sweeps = k1._phase2_loop.lane_sweeps = 0
    bisect_accept.probes = 0
    t0 = time.perf_counter()
    k1.two_phase_sweeps_ref(
        *(torch.tensor(a, dtype=torch.float32) for a in (P, q, r)),
        tuple(int(i) for i in np.nonzero(is_eq)[0]), torch.from_numpy(xs),
        num_iters=SWEEPS)
    return {"E": int(is_eq.sum()), "R": len(xs),
            "lane_sweeps": k1._phase1_loop.lane_sweeps
            + k1._phase2_loop.lane_sweeps,
            "probes": int(bisect_accept.probes),
            "cpu_seconds": time.perf_counter() - t0}


def k1_sample_counts(path):
    """(run as `--k1-sample PATH`) `_plain_counts` on each sampled
    scenario's R_SERVE starts at the serving shape, one JSON line."""
    import torch
    torch.set_num_threads(2)
    sys.path.insert(0, REPO)
    xs = np.load(path)["xs"]
    print(json.dumps([{"scenario": s, **_plain_counts(bench_form_arrays(s),
                                                      xs[j])}
                      for j, s in enumerate(K1_SAMPLE)]), flush=True)


R_ROUTE_SAMPLE = 128               # n = 256 route starts that size K1's bound


def start_k1_route_sample(workdir):
    """Start the count of K1's work on the n = 256 route: the first
    R_ROUTE_SAMPLE of its first timed solve's starts, drawn here on the
    card, go to a file, and a CPU process (`--k1-route-sample`) runs K1's
    plain version on them while the phases before `k2_route` run."""
    path = os.path.join(workdir, "k1_route_sample.npy")
    np.save(path, route_starts(R_MAIN)[:R_ROUTE_SAMPLE].cpu().numpy())
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--k1-route-sample",
         path], stdout=subprocess.PIPE, text=True)


def k1_route_sample_counts(path):
    """(run as `--k1-route-sample PATH`) `_plain_counts` on the sampled
    starts of the n = 256 route, one JSON line."""
    import torch
    torch.set_num_threads(2)
    sys.path.insert(0, REPO)
    print(json.dumps(_plain_counts(bench_form_arrays(0, N_K2, M_K2),
                                   np.load(path))), flush=True)


def _per_scenario_routes(stacked):
    """(c) improve=ADMM and improve=DCCP on the first S_ROUTES scenarios at
    R_SERVE: each scenario equals solve_restarts on its form from the
    generator after the draws of the scenarios before it, bit for bit;
    K3 launches twice a scenario (its two phases), K4 once."""
    import torch
    import qcqp_tpu_torch as qt
    from qcqp_tpu_torch.core import QCQPForm
    from qcqp_tpu_torch.kernels.admm_kernel import admm_phase
    from qcqp_tpu_torch.kernels.ccp_kernel import ccp_improve
    from qcqp_tpu_torch.parallel.restarts import solve_restarts
    from qcqp_tpu_torch.parallel.scenarios import scenario, solve_scenarios
    sub = QCQPForm(*(a[:S_ROUTES] for a in stacked))
    out = {}
    for improve, kw, kernel, per in (
            (qt.ADMM, dict(num_iters=ADMM_ITERS), admm_phase, 2),
            (qt.DCCP, CCP_ROUTE_KW, ccp_improve, 1)):
        def gen():
            return torch.Generator(device="cuda").manual_seed(9)
        kernel.launches = 0
        ms, (xs, fs, vs) = host_ms(lambda: solve_scenarios(
            sub, R_SERVE, gen(), improve=improve, **kw))
        launches = kernel.launches
        g, same = gen(), 0
        for s in range(S_ROUTES):
            x, f, v = solve_restarts(scenario(sub, s), R_SERVE, g,
                                     improve=improve, **kw)
            same += int(torch.equal(x, xs[s]) and torch.equal(f, fs[s])
                        and torch.equal(v, vs[s]))
        if same != S_ROUTES or launches != per * S_ROUTES:
            raise AssertionError(
                f"{improve} by scenario: {same} of {S_ROUTES} scenarios "
                f"equal solve_restarts, {launches} launches")
        out[improve] = {"S": S_ROUTES, "R": R_SERVE, **kw, "ms": ms,
                        "launches": launches, "scenarios_identical": same,
                        "best_f": fs.tolist(), "best_viol": vs.tolist()}
    return out


def phase_scenarios(sample, workdir, example):
    """Scenario serving on the card (qcqp_tpu_torch/parallel/scenarios.py):
    (a) the serving example at its own size; (b) S_SERVE bench forms as a
    float64 bank, loaded back in two halves, 3 timed solve_scenarios (one
    K1 launch each) after a warm-up, then K1's stacked launch alone on the
    first timed solve's starts against the loop of S_SERVE single-form
    launches, every lane bit for bit, with both times and the bound from
    the sampled counts; (c) ADMM and DCCP by scenario against
    solve_restarts."""
    import torch
    from qcqp_tpu_torch import native
    from qcqp_tpu_torch.core import QCQPForm
    from qcqp_tpu_torch.kernels.cd_sweep_kernel import two_phase_sweeps
    from qcqp_tpu_torch.parallel.restarts import best_point
    from qcqp_tpu_torch.parallel.scenarios import (forms_from_bank,
                                                   scenario, solve_scenarios)

    arrays = serving_bank_arrays()
    path = os.path.join(workdir, "serving.qcqp")
    t0 = time.perf_counter()
    native.bank_write(path, *arrays)
    write_s = time.perf_counter() - t0
    mb = os.path.getsize(path) / 1e6
    half = S_SERVE // 2
    load_s, halves = host_ms(lambda: [forms_from_bank(path, 0, half),
                                      forms_from_bank(path, half)])
    load_s /= 1e3                   # the bank stays for phase distributed
    stacked = QCQPForm(*(torch.cat(pair) for pair in zip(*halves)))
    del arrays, halves
    if stacked.P.shape != (S_SERVE, M + 1, N, N):
        raise AssertionError(f"bank loaded as {tuple(stacked.P.shape)}")

    def solve(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return solve_scenarios(stacked, R_SERVE, gen, num_iters=SWEEPS)
    solve(0)                                            # warm-up
    two_phase_sweeps.launches = 0
    times, results = [], []
    for seed in range(1, 1 + SERVE_REPEATS):
        ms, res = host_ms(lambda: solve(seed))
        times.append(ms)
        results.append(res)
    launches = two_phase_sweeps.launches
    for xs, fs, vs in results:
        if not (xs.shape == (S_SERVE, N) and torch.isfinite(xs).all()
                and torch.isfinite(fs).all() and torch.isfinite(vs).all()):
            raise AssertionError("solve_scenarios returned non-finite "
                                 "points")
    if launches != SERVE_REPEATS:
        raise AssertionError(f"{launches} K1 launches in {SERVE_REPEATS} "
                             "scenario solves")

    # K1 alone on the first timed solve's starts: the stacked launch
    # against one launch a scenario
    xs = scenario_starts(S_SERVE, R_SERVE, N, 1)
    eqs = [tuple(int(i) for i in np.nonzero(row)[0])
           for row in stacked.is_eq.cpu().numpy()]
    P, q, r = stacked.P, stacked.q, stacked.r

    def stacked_launch():
        return two_phase_sweeps(P, q, r, eqs, xs, num_iters=SWEEPS)

    def loop():
        return torch.stack([two_phase_sweeps(P[s], q[s], r[s], eqs[s], xs[s],
                                             num_iters=SWEEPS)
                            for s in range(S_SERVE)])
    ms_stack_a, x_stack = host_ms(stacked_launch)
    ms_loop, x_loop = host_ms(loop)
    ms_stack_b, _ = host_ms(stacked_launch)
    a, b = x_stack.cpu().numpy(), x_loop.cpu().numpy()
    lanes_same = int((a.view(np.int32) == b.view(np.int32)).all(axis=2)
                     .sum())
    if lanes_same != S_SERVE * R_SERVE or not np.isfinite(a).all():
        raise AssertionError(
            f"K1's stacked launch equals the single-form launches on "
            f"{lanes_same} of {S_SERVE * R_SERVE} lanes")
    best = [best_point(scenario(stacked, s), x_stack[s])
            for s in range(S_SERVE)]
    if not all(torch.equal(torch.stack(col), w)
               for col, w in zip(zip(*best), results[0])):
        raise AssertionError("K1's stacked launch on the first solve's "
                             "starts does not give that solve's best points")

    report = sample.communicate(timeout=600)[0]
    if sample.returncode != 0:
        raise AssertionError(f"the K1 sample process exited "
                             f"{sample.returncode}")
    counts = json.loads(report.splitlines()[-1])
    ops = sum(c["lane_sweeps"] * ((M + 1) * (2 * N * N + 2 * N)
                                  + N * 2 * (M + 1) * N)
              + c["probes"] * (M + c["E"]) * C_ROW for c in counts)
    ops *= S_SERVE / len(counts)
    e_max = max(len(e) for e in eqs)
    nbytes = 4 * (S_SERVE * ((M + 1) * N * N + (M + 1) * N + (M + 1) + M
                             + e_max + 1) + 2 * S_SERVE * R_SERVE * N)
    b = bound(ops, nbytes)

    fs = torch.stack([res[1] for res in results]).double().cpu().numpy()
    vs = torch.stack([res[2] for res in results]).double().cpu().numpy()
    routes = _per_scenario_routes(stacked)
    ms_solve = float(np.median(times))
    emit({"phase": "scenarios", "example": example,
          "serving": {
              "S": S_SERVE, "n": N, "m": M, "R": R_SERVE, "sweeps": SWEEPS,
              "E_by_scenario": [len(e) for e in eqs],
              "bank_mb": mb, "write_s": write_s, "write_mb_s": mb / write_s,
              "load_s": load_s, "load_mb_s": mb / load_s,
              "ms_per_solve": times,
              "scenario_restarts_per_s": S_SERVE * R_SERVE / ms_solve * 1e3,
              "k1_launches": launches,
              "best_f": {"min": float(fs[0].min()),
                         "median": float(np.median(fs[0])),
                         "max": float(fs[0].max())},
              "best_viol": {"min": float(vs[0].min()),
                            "median": float(np.median(vs[0])),
                            "max": float(vs[0].max())},
              "share_feasible": float((vs[0] < 1e-2).mean()),
              "k1_stacked_ms": [ms_stack_a, ms_stack_b],
              "k1_loop_ms": ms_loop, "lanes_identical": lanes_same,
              "k1_sample": counts,
              "bound_from": f"K1's plain version in float32 on the CPU, "
                            f"scenarios {list(K1_SAMPLE)} of the first "
                            f"timed solve's starts ({R_SERVE} lanes each), "
                            f"scaled by {S_SERVE} / {len(counts)}",
              **b},
          "per_scenario_routes": routes})
    return {"launches": launches, "ms": (ms_stack_a + ms_stack_b) / 2,
            "bank": path, "first_solve": results[0],
            "ms_loop": ms_loop, "ms_per_solve": ms_solve,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "bound_from": "sampled: K1's plain version on the CPU, "
                          f"{len(counts)} of {S_SERVE} scenarios, scaled",
            "shape": f"S={S_SERVE}, n={N}, m={M}, R={R_SERVE} a scenario "
                     f"({S_SERVE * R_SERVE} lanes), {SWEEPS} sweeps, "
                     "E per scenario"}


R_DIST_ADMM, R_DIST_CCP = 1024, 128      # the ADMM and DCCP paths' first R
R_DIST_2D = 1024
DIST_REPEATS = 3


def _capture_chain():
    """Record every output of parallel/restarts.improve_chain (a rank's
    improved block under a mesh); returns the list and the undo."""
    from qcqp_tpu_torch.parallel import restarts
    real, seen = restarts.improve_chain, []

    def chain(*a, **kw):
        out = real(*a, **kw)
        seen.append(out)
        return out
    restarts.improve_chain = chain
    return seen, lambda: setattr(restarts, "improve_chain", real)


def _collective_ms(mesh, device):
    """Host time of the cross-rank best point's collective alone: one
    all_gather of n + 3 float32 numbers over the restart axis, median of
    5 after a warm-up."""
    import torch
    cand = torch.zeros(N + 3, dtype=torch.float32, device=device)
    mesh.all_gather(cand, "r")
    return float(np.median([host_ms(lambda: mesh.all_gather(cand, "r"))[0]
                            for _ in range(5)]))


def _inventory(mesh, before=None, solves=1):
    """A mesh's collectives (calls and payload bytes by kind) since
    `before` (an earlier _inventory), per solve."""
    out = {}
    for key in ("calls", "bytes"):
        now, then = getattr(mesh, key), (before or {}).get(key, {})
        out[key] = {k: (now[k] - then.get(k, 0)) / solves for k in now
                    if now[k] != then.get(k, 0)}
    return out


def dist_worker(spec_path):
    """(run as `--dist-worker SPEC`) one rank of phase distributed: set-up
    (a), an NCCL world of one, or (b), a gloo world of two, both on
    cuda:0.  Writes its results to the work directory and prints one JSON
    line."""
    import torch
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    from qcqp_tpu_torch.kernels import _build
    from qcqp_tpu_torch.parallel import launch
    with open(spec_path) as f:
        spec = json.load(f)
    t0 = time.perf_counter()
    _build.library()                      # built by the parent: a load
    device = launch.initialize(spec["coordinator"], spec["world"],
                               spec["rank"], device="cuda:0",
                               backend=spec["backend"], timeout=300.0)
    torch.zeros(1, device=device)
    ready_s = time.perf_counter() - t0
    sys.stdin.readline()      # the parent's go: (a) first, then (b)
    try:
        out = (_dist_a if spec["setup"] == "a" else _dist_b)(spec, device)
    finally:
        launch.shutdown()
    out.update(rank=spec["rank"], ready_s=ready_s,
               jax_imported="jax" in sys.modules)
    print(json.dumps(out), flush=True)


def _dist_a(spec, device):
    """(a) solve_restarts over global_mesh() in an NCCL world of one, on
    the main path's form and seeds, beside the same solve without a mesh
    in this process."""
    import torch
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels.cd_sweep_kernel import two_phase_sweeps
    from qcqp_tpu_torch.parallel import launch
    from qcqp_tpu_torch.parallel.restarts import solve_restarts
    form = form_from_numpy(*bench_form_arrays(0), device=device,
                           dtype=torch.float32)
    mesh = launch.global_mesh()

    def solve(seed, **kw):
        gen = torch.Generator(device=device).manual_seed(seed)
        return solve_restarts(form, R_MAIN, gen, num_iters=SWEEPS, **kw)
    solve(0, mesh=mesh)                                  # warm-up
    inventory = _inventory(mesh)                         # of one solve
    times, single, launches = [], [], 0
    for seed in range(1, 1 + DIST_REPEATS):
        two_phase_sweeps.launches = 0
        ms, res = host_ms(lambda: launch.solve_restarts_distributed(
            form, R_MAIN, torch.Generator(device=device).manual_seed(seed),
            num_iters=SWEEPS))
        launches += two_phase_sweeps.launches
        times.append(ms)
        if seed == 1:
            torch.save([t.cpu() for t in res],
                       os.path.join(spec["workdir"], "dist_a.pt"))
        single.append(host_ms(lambda: solve(seed))[0])   # in turns
    return {"backend": torch.distributed.get_backend(), "world": 1,
            "R": R_MAIN, "sweeps": SWEEPS,
            "ms_per_solve": times, "ms_per_solve_no_mesh": single,
            "collective_ms": _collective_ms(mesh, device),
            "k1_launches": launches, "inventory": inventory}


def _dist_b(spec, device):
    """(b) one of two gloo ranks on cuda:0: CD (K1), ADMM (K3) and DCCP
    (K4) sharded over make_mesh(), solve_scenarios_sharded on an (s = 2,
    r = 1) mesh from this rank's half of the bank, and solve_restarts_2d
    on an (r = 1, c = 2) mesh."""
    import torch
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels.admm_kernel import admm_phase
    from qcqp_tpu_torch.kernels.ccp_kernel import ccp_improve
    from qcqp_tpu_torch.kernels.cd_sweep_kernel import two_phase_sweeps
    from qcqp_tpu_torch.parallel import Mesh, make_mesh, make_mesh_2d, mesh2d
    from qcqp_tpu_torch.parallel.restarts import solve_restarts
    from qcqp_tpu_torch.parallel.scenarios import (
        forms_from_bank, scenario_block, solve_scenarios_sharded)
    form = form_from_numpy(*bench_form_arrays(0), device=device,
                           dtype=torch.float32)
    mesh = make_mesh()
    out = {"backend": torch.distributed.get_backend(),
           "world": torch.distributed.get_world_size(),
           "coords": mesh.coords}
    dump = {}

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)
    kernels = {"cd": (two_phase_sweeps, DIST_REPEATS),
               "admm": (admm_phase, 1), "dccp": (ccp_improve, 1)}
    for name, improve, R, kw in DIST_CHAINS:
        kernel, repeats = kernels[name]
        if name == "cd":
            solve_restarts(form, R, gen(0), improve=improve, mesh=mesh, **kw)
        seen, undo = _capture_chain()
        kernel.launches = 0
        before = _inventory(mesh)
        try:
            times, results = [], []
            for seed in range(1, 1 + repeats):
                ms, res = host_ms(lambda: solve_restarts(
                    form, R, gen(seed), improve=improve, mesh=mesh, **kw))
                times.append(ms)
                results.append(res)
        finally:
            undo()
        out[name] = {"R": R, **kw, "ms_per_solve": times,
                     "launches": kernel.launches,
                     "block": list(seen[0].shape),
                     "inventory_per_solve": _inventory(mesh, before,
                                                       repeats)}
        dump[name] = {"block": seen[0].cpu(),
                      "best": [t.cpu() for t in results[0]]}
    out["collective_ms"] = _collective_ms(mesh, device)

    grid = Mesh([("s", 2), ("r", 1)])
    start, batch = scenario_block(S_SERVE, grid)
    t0 = time.perf_counter()
    local = forms_from_bank(spec["bank"], start, batch)
    load_s = time.perf_counter() - t0
    two_phase_sweeps.launches = 0
    ms, res = host_ms(lambda: solve_scenarios_sharded(
        local, R_SERVE, gen(1), grid, num_scenarios=S_SERVE,
        num_iters=SWEEPS))
    out["scenarios_sharded"] = {
        "mesh": dict(grid.shape), "scenarios": [start, start + batch],
        "lanes": batch * R_SERVE, "load_s": load_s, "ms": ms,
        "k1_launches": two_phase_sweeps.launches}
    dump["scenarios"] = [t.cpu() for t in res]

    grid2 = make_mesh_2d(1, 2)
    real, blocks = mesh2d._admm_2d_local, []

    def local_admm(*a, **kw):
        blocks.append(real(*a, **kw))
        return blocks[-1]
    mesh2d._admm_2d_local = local_admm
    try:
        ms, res = host_ms(lambda: mesh2d.solve_restarts_2d(
            form, R_DIST_2D, gen(1), grid2, num_iters=ADMM_ITERS))
    finally:
        mesh2d._admm_2d_local = real
    out["restarts_2d"] = {"mesh": dict(grid2.shape), "R": R_DIST_2D,
                          "iters": ADMM_ITERS, "ms": ms,
                          "all_reduces": grid2.calls["all_reduce"],
                          "all_gathers": grid2.calls["all_gather"],
                          "inventory": _inventory(grid2)}
    dump["2d"] = {"block": blocks[0].cpu(), "best": [t.cpu() for t in res]}
    torch.save(dump, os.path.join(spec["workdir"],
                                  f"dist_b{spec['rank']}.pt"))
    return out


def _start_dist_workers(workdir, bank):
    """Start the three ranks of phase distributed: (a) alone in an NCCL
    world, and (b)'s two gloo ranks, which join their group and then wait
    for the parent's go."""
    import socket
    procs = []
    for setup, world, backend in (("a", 1, "nccl"), ("b", 2, "gloo")):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        for rank in range(world):
            spec = os.path.join(workdir, f"dist_{setup}{rank}.json")
            with open(spec, "w") as f:
                json.dump({"setup": setup, "world": world, "rank": rank,
                           "backend": backend, "workdir": workdir,
                           "bank": bank,
                           "coordinator": f"127.0.0.1:{port}"}, f)
            log = os.path.join(workdir, f"dist_{setup}{rank}")
            with open(log + ".out", "w") as out, \
                    open(log + ".err", "w") as err:
                proc = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__),
                     "--dist-worker", spec], stdin=subprocess.PIPE,
                    stdout=out, stderr=err, text=True)
            proc.log = log
            procs.append(proc)
    return procs


def _dist_result(proc, name, timeout=300):
    """The worker's JSON line, once it has exited 0 (its output goes to
    files, so that no pipe fills while another rank waits)."""
    proc.wait(timeout=timeout)
    with open(proc.log + ".out") as out, open(proc.log + ".err") as err:
        out, err = out.read(), err.read()
    if proc.returncode != 0:
        raise AssertionError(f"distributed worker {name} exited "
                             f"{proc.returncode}:\n{err[-3000:]}")
    return json.loads(out.splitlines()[-1])


def _rows_equal(a, b):
    """Lanes of a equal to those of b bit for bit, and the count."""
    a, b = a.contiguous().numpy(), b.contiguous().numpy()
    return int((a.view(np.int32) == b.view(np.int32)).all(axis=1).sum())


# The best objective of a sharded solve may differ from the one-process
# solve's in its last bits: eval_objective_batch is an (R, n) x (n, n)
# cuBLAS product whose kernel, and so its rows' rounding, depends on R
# (on the bench form at R = 128 against 64, DCCP's points, up to 2.9e-6
# relative; none at R = 1,024 and 10,240).  The cross-rank pick is exact
# over the ranks' own values; against the one-process best it holds to:
BEST_F_RTOL = 1e-5


def _same_best(a, b):
    return all(_equal(p, q) for p, q in zip(a, b))


def _equal(p, q):
    """Equal bit for bit (NaN included), on whichever devices."""
    p, q = p.cpu(), q.cpu()
    return p.shape == q.shape and bool(
        (p.view(-1).numpy().view(np.int32)
         == q.view(-1).numpy().view(np.int32)).all())


class _Gathered:
    """The ranks' candidates, stacked in one process: what pick_across's
    all_gather returns on the ranks."""

    def __init__(self, parts):
        self.parts = parts

    def all_gather(self, t, axis):
        return self.parts


def _best_vs_one_process(form, full, got):
    """A rank's best point (x, f, v) against (1) the pick of the two
    blocks' candidates computed here on the same blocks, which must be
    equal bit for bit, and (2) the one-process best_point of the whole
    batch, to BEST_F_RTOL in f with the same bucket; and how many rows'
    objectives differ between the block-sized and the whole products."""
    import torch
    from qcqp_tpu_torch.core import eval_objective_batch, violation_bucket
    from qcqp_tpu_torch.parallel.restarts import (best_point, candidate,
                                                  pick_across)
    halves = full.chunk(2)
    cands = torch.stack([candidate(form, h) for h in halves])
    pick = pick_across(cands[0], _Gathered(cands), "r", full.shape[0])
    x1, f1, v1 = best_point(form, full)
    f_rows = torch.cat([eval_objective_batch(form, h) for h in halves])
    f_gap = abs(float(got[1]) - float(f1)) / max(abs(float(f1)), 1e-30)
    same_bucket = bool(violation_bucket(got[2])
                       == violation_bucket(v1.cpu()))
    return {"best_is_pick_of_blocks": _same_best(got, pick),
            "equal_to_one_process": _same_best(got, (x1, f1, v1)),
            "x_equal_to_one_process": _equal(got[0], x1),
            "f_rel_gap_to_one_process": f_gap,
            "objective_rows_differing_by_block_size": int(
                (f_rows != eval_objective_batch(form, full)).sum()),
            "within_tolerance": same_bucket and f_gap <= BEST_F_RTOL}


# (name, improve method, R, kwargs) of (b)'s sharded solve_restarts; the
# methods are qcqp_tpu_torch.settings' COORD_DESCENT, ADMM and DCCP
DIST_CHAINS = (("cd", "coord-descent", R_MAIN, dict(num_iters=SWEEPS)),
               ("admm", "admm", R_DIST_ADMM, dict(num_iters=ADMM_ITERS)),
               ("dccp", "dccp", R_DIST_CCP, CCP_ROUTE_KW))


def _dist_references(form):
    """What the ranks of (b) are held against, computed while they start:
    the one-process chain of each improve on the seed-1 starts, and the
    one-process batched ADMM on the 2-D solve's starts."""
    import torch
    from qcqp_tpu_torch.parallel.restarts import (fused_setups,
                                                  improve_chain,
                                                  suggest_batch)
    from qcqp_tpu_torch.solvers.admm import improve_admm_batch

    def starts(R):
        return suggest_batch(form, R, torch.Generator(device="cuda")
                             .manual_seed(1))
    refs = {name: improve_chain(form, starts(R), improve, **fused_setups(
        form, improve, dict(kw, use_fused=True)))
        for name, improve, R, kw in DIST_CHAINS}
    xs = starts(R_DIST_2D)
    refs["admm_1d_ms"], refs["admm_1d"] = host_ms(
        lambda: improve_admm_batch(form, xs, num_iters=ADMM_ITERS))
    return refs


def _go(proc):
    proc.stdin.write("go\n")
    proc.stdin.close()


def phase_distributed(arrays, main_best, scen, workdir):
    """The distributed module on one card (qcqp_tpu_torch/parallel/): (a)
    an NCCL world of one and (b) two gloo ranks on cuda:0, each rank a
    process of its own (`--dist-worker`), held against the one-process
    solves, which run here while the workers start."""
    import torch
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.core import eval_objective_batch, max_violation_batch
    t0 = time.perf_counter()
    timeline = {}
    form = form_from_numpy(*arrays, device="cuda", dtype=torch.float32)
    procs = _start_dist_workers(workdir, scen["bank"])
    try:
        refs = _dist_references(form)
        timeline["references_done"] = time.perf_counter() - t0
        _go(procs[0])
        a = _dist_result(procs[0], "(a)")
        timeline["a_done"] = time.perf_counter() - t0
        for p in procs[1:]:
            _go(p)
        b = [_dist_result(p, f"(b) rank {i}")
             for i, p in enumerate(procs[1:])]
        timeline["b_done"] = time.perf_counter() - t0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    os.unlink(scen["bank"])
    da = torch.load(os.path.join(workdir, "dist_a.pt"))
    db = [torch.load(os.path.join(workdir, f"dist_b{i}.pt"))
          for i in range(2)]
    checks = {"a_equals_main_path": _same_best(da, main_best)}

    # (b): each rank's block against the one-process chain, lane for lane
    for name, _, R, _ in DIST_CHAINS:
        full = refs[name]
        same = sum(_rows_equal(d[name]["block"],
                               full[i * R // 2:(i + 1) * R // 2].cpu())
                   for i, d in enumerate(db))
        got = [d[name]["best"] for d in db]
        checks[name] = {"lanes_identical": f"{same} of {R}",
                        "best_same_on_both_ranks": _same_best(*got),
                        **_best_vs_one_process(form, full, got[0])}
        if (same != R or not checks[name]["best_same_on_both_ranks"]
                or not checks[name]["best_is_pick_of_blocks"]
                or not checks[name]["within_tolerance"]):
            raise AssertionError(f"distributed {name}: {checks}")
    checks["cd_best_equals_a"] = _same_best(db[0]["cd"]["best"], da)
    first = scen["first_solve"]
    same = [sum(int(all(_equal(d["scenarios"][k][s], first[k][s])
                        for k in range(3)))
                for s in range(S_SERVE)) for d in db]
    checks["scenarios_identical_per_rank"] = same

    # the 2-D ADMM: one best point on both ranks, and quality parity with
    # the one-process batched ADMM on the same starts
    checks["2d_best_same_on_both_ranks"] = _same_best(db[0]["2d"]["best"],
                                                      db[1]["2d"]["best"])
    out1d, out2d = refs["admm_1d"], db[0]["2d"]["block"].cuda()
    v2d, v1d = (max_violation_batch(form, o).cpu().numpy()
                for o in (out2d, out1d))
    f2d, f1d = (eval_objective_batch(form, o).cpu().numpy()
                for o in (out2d, out1d))
    # tests/test_mesh2d.py:38-45: a feasible share no lower, f within 5%
    # (rtol 0.05, atol 0.05) where both are feasible; and :100-101, each
    # restart's violation within the consensus scale (rtol 0.1, atol 5e-2)
    feas = (v2d < 1e-2) & (v1d < 1e-2)
    gap = np.abs(f2d - f1d) - (0.05 + 0.05 * np.abs(f1d))
    parity = {"feasible_share_2d": float((v2d < 1e-2).mean()),
              "feasible_share_1d": float((v1d < 1e-2).mean()),
              "both_feasible": int(feas.sum()),
              "f_within_5pct": bool((gap[feas] <= 0).all()),
              "viol_within_consensus_scale": bool(np.allclose(
                  v2d, v1d, rtol=0.1, atol=5e-2)),
              "max_abs_viol_gap": float(np.abs(v2d - v1d).max()),
              "median_viol_2d": float(np.median(v2d)),
              "median_viol_1d": float(np.median(v1d)),
              "ms_one_process_unfused": refs["admm_1d_ms"]}
    checks["2d_parity"] = parity

    # the collective inventory against the analytic count: the best point
    # is one all_gather of n + 3 float32 numbers a rank, and the 2-D ADMM
    # one all_reduce of the rank's (R / nr, n) float32 consensus sums an
    # iteration over "c" (nr = 1), then the best point's all_gather
    best = {"calls": {"all_gather": 1}, "bytes": {"all_gather": (N + 3) * 4}}
    inventory = {"a": a["inventory"]}
    for i, w in enumerate(b):
        for name, _, _, _ in DIST_CHAINS:
            inventory[f"b{i}_{name}"] = w[name]["inventory_per_solve"]
    checks["inventory_best_point"] = {
        "expected": best,
        "ranks_differing": [k for k, v in inventory.items() if v != best]}
    iters = [w["restarts_2d"]["inventory"]["calls"].get("all_reduce", 0)
             for w in b]
    want2d = [{"calls": {"all_reduce": t, "all_gather": 1},
               "bytes": {"all_reduce": t * R_DIST_2D * N * 4,
                         "all_gather": (N + 3) * 4}} for t in iters]
    checks["inventory_2d"] = {
        "all_reduce_bytes_each": R_DIST_2D * N * 4,
        "equal_to_analytic": [w["restarts_2d"]["inventory"] == want
                              for w, want in zip(b, want2d)]}
    emit({"phase": "distributed", "a": a, "b": b, "checks": checks,
          "timeline_s": timeline})
    failed = [k for k in ("a_equals_main_path", "cd_best_equals_a",
                          "2d_best_same_on_both_ranks") if not checks[k]]
    if (checks["inventory_best_point"]["ranks_differing"]
            or not all(checks["inventory_2d"]["equal_to_analytic"])):
        failed.append("inventory")
    if (failed or same != [S_SERVE, S_SERVE]
            or parity["feasible_share_2d"] < parity["feasible_share_1d"]
            or not parity["f_within_5pct"]
            or not parity["viol_within_consensus_scale"]):
        raise AssertionError(f"distributed: {failed} {checks}")
    bad = [w for w in [a] + b if w["jax_imported"]]
    launches = {"k1_a": a["k1_launches"],
                "k1_b": [w["cd"]["launches"] for w in b],
                "k1_scenarios_sharded": [w["scenarios_sharded"]["k1_launches"]
                                         for w in b],
                "k3_b": [w["admm"]["launches"] for w in b],
                "k4_b": [w["dccp"]["launches"] for w in b]}
    if bad or launches != {"k1_a": DIST_REPEATS,
                           "k1_b": [DIST_REPEATS] * 2,
                           "k1_scenarios_sharded": [1, 1],
                           "k3_b": [2, 2], "k4_b": [1, 1]}:
        raise AssertionError(f"distributed launches {launches}")
    return launches


def _device_ms_by_kernel(prof):
    """Device time (ms) and count per kernel name, from the profiler's
    device-side events only."""
    import torch
    out = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, count = out.get(evt.name, (0.0, 0))
        out[evt.name] = (ms + evt.time_range.elapsed_us() / 1e3, count + 1)
    return sorted(out.items(), key=lambda kv: -kv[1][0])


def _profile_solve(solve, kernel=None, top=6, host=True, **label):
    """One profiled solve after a warm-up and an unprofiled one: kernel
    time by name and the card's idle share of the unprofiled wall time;
    with `kernel` (a substring of a kernel's name), that kernel's device
    time, launches and share of the device time, and the launches of
    everything else (the route's torch operations).  host=False records
    the device only, which keeps the trace of a solve of many launches
    short."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    solve()                                            # warm-up
    wall_ms, _ = host_ms(solve)
    with profile(activities=[ProfilerActivity.CPU] * host
                 + [ProfilerActivity.CUDA]) as prof:
        solve()
        torch.cuda.synchronize()
    kernels = _device_ms_by_kernel(prof)
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    device_ms = sum(ms for _, (ms, _) in kernels)
    out = {"phase": "profile", **label, "wall_ms_unprofiled": wall_ms,
           "device_ms": device_ms, "idle_share": 1.0 - device_ms / wall_ms,
           "device_launches": sum(c for _, (_, c) in kernels),
           "top": [[name[:60], ms, count]
                   for name, (ms, count) in kernels[:top]]}
    if kernel is not None:
        ms, count = (sum(v[i] for name, v in kernels if kernel in name)
                     for i in (0, 1))
        out[kernel] = {"device_ms": ms, "launches": count,
                       "share_of_device": ms / device_ms,
                       "other_launches": out["device_launches"] - count,
                       "other_device_ms": device_ms - ms}
    emit(out)


def phase_profile(arrays):
    """One profiled solve per route (CD through K1 and K2 at R = 10,240,
    the n = 256 form through K1 and through K2 with its phases' split,
    ADMM through K3
    at R = 1,024 and 10,240, DCCP through K4, the SDR's Newton-Schulz and
    vec routes, the NLP improve at R = 128 and 10,240), and K1's time
    over R."""
    import torch
    import qcqp_tpu_torch as qt
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels.cd_sweep_kernel import two_phase_sweeps
    from qcqp_tpu_torch.parallel.restarts import solve_restarts, suggest_batch
    form = form_from_numpy(*arrays, device="cuda", dtype=torch.float32)

    def gen():
        return torch.Generator(device="cuda").manual_seed(1)

    for route, mega in (("k1", None), ("k2", False)):
        _profile_solve(lambda: solve_restarts(form, R_MAIN, gen(),
                                              num_iters=SWEEPS, mega=mega),
                       kernel="phase1_kernel" if mega is False else None,
                       route=route, R=R_MAIN, sweeps=SWEEPS)
    for R in R_ADMM:
        _profile_solve(lambda: solve_restarts(form, R, gen(), improve=qt.ADMM,
                                              num_iters=ADMM_ITERS),
                       kernel="admm_phase_kernel", route="admm", R=R,
                       iters=ADMM_ITERS)
    for R in R_CCP:
        _profile_solve(lambda: solve_restarts(form, R, gen(), improve=qt.DCCP),
                       kernel="ccp_kernel", route="dccp", R=R)
    # the SDR routes on the n = 100 boolean-LS SDR, 200 iterations each
    from qcqp_tpu_torch.solvers import sdp
    data = sdp._sdr_data(form_from_numpy(*bls_sdr_arrays(), device="cuda",
                                         dtype=torch.float32))
    for psd, kw in (("ns", dict(alpha=1.0)),
                    ("vec", dict(alpha=1.6, warm_sweeps=2))):
        _profile_solve(lambda: sdp.solve_sdp(
            data, max_iters=200, tol=0.0, psd_method=psd, accel_mem=0,
            detect_certificates=False, **kw), route=f"sdr_{psd}", n=SDR_N,
            iters=200)
    # the NLP improve alone (phase nlp_path), device only: about 10^5
    # launches a solve
    from qcqp_tpu_torch.solvers.nlp import improve_nlp
    for R in R_NLP:
        xs = suggest_batch(form, R, gen())
        _profile_solve(lambda: improve_nlp(form, xs), host=False, top=10,
                       route="nlp", R=R)
    # the n = 256 form of phase k2_route: the default route through K1,
    # then the K2 route (mega=False) last: its profile records about
    # 720,000 device events at 10 sweeps, and every profile taken after
    # one that large loses kernel records (K3's phase-1 launch, K4's
    # launch at R = 128); then its phase 1 alone on the same starts: the
    # rest of the solve is the phase-2 gate, the unfused phase 2 and the
    # best point
    from qcqp_tpu_torch.solvers import coord_descent_fused as fused
    form2 = form_from_numpy(*bench_form_arrays(0, N_K2, M_K2), device="cuda",
                            dtype=torch.float32)
    _profile_solve(lambda: solve_restarts(form2, R_MAIN, gen(),
                                          num_iters=SWEEPS),
                   kernel="cd_sweep_kernel", route="k1_n256", n=N_K2,
                   m=M_K2, R=R_MAIN, sweeps=SWEEPS)
    _profile_solve(lambda: solve_restarts(form2, R_MAIN, gen(),
                                          num_iters=SWEEPS, mega=False),
                   kernel="phase1_kernel", top=10, host=False,
                   route="k2_mega_false_n256",
                   n=N_K2, m=M_K2, R=R_MAIN, sweeps=SWEEPS)
    xs2 = suggest_batch(form2, R_MAIN, gen())
    ms_p1, x1 = host_ms(lambda: fused.coord_descent_phase1_fused(
        form2, xs2, SWEEPS, eq_idx=form2.eq_idx()))
    ms_all, _ = host_ms(lambda: fused.improve_coord_descent_fused(
        form2, xs2, num_iters=SWEEPS, mega=False))
    from qcqp_tpu_torch.core import max_violation_batch
    emit({"phase": "profile", "route": "k2_mega_false_split", "n": N_K2,
          "R": R_MAIN, "phase1_ms": ms_p1, "improve_ms": ms_all,
          "phase2_and_gate_ms": ms_all - ms_p1,
          "feasible_after_phase1": int((max_violation_batch(form2, x1)
                                        < 1e-2).sum())})
    eq_idx = form.eq_idx()
    scaling = []
    for R in (256, 1024, 4096, 10240, 20480, 40960):
        xs = suggest_batch(form, R, torch.Generator(device="cuda")
                           .manual_seed(R))
        two_phase_sweeps(form.P, form.q, form.r, eq_idx, xs,
                         num_iters=SWEEPS)                 # warm-up
        ms, _ = host_ms(lambda: two_phase_sweeps(
            form.P, form.q, form.r, eq_idx, xs, num_iters=SWEEPS))
        scaling.append({"R": R, "ms": ms, "restarts_per_s": R / ms * 1e3})
    emit({"phase": "profile", "k1_over_R": scaling})


def plain_runs(arrays):
    """The longest plain-version runs, made while nvcc builds the kernels
    (they launch none): K1's on the starts of the main path's first timed
    solve at its full shape (phase 5), K4's on the DCCP path's R = 128
    starts (phase 10), on tiles 0, 1 and the last of its R = 10,240 starts
    (phase 11) and on K4's wide case (phase 10).  Their times are taken
    while the build's last nvcc process runs on another core."""
    import torch
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels import cd_sweep_kernel as k1
    from qcqp_tpu_torch.kernels.ccp_kernel import CCPFusedData, ccp_improve_ref
    from qcqp_tpu_torch.kernels.onevar_kernel import bisect_accept
    from qcqp_tpu_torch.parallel.restarts import suggest_batch
    form = form_from_numpy(*arrays, device="cuda", dtype=torch.float32)

    def starts(R):
        return suggest_batch(form, R,
                             torch.Generator(device="cuda").manual_seed(1))
    out = {}
    xs, eq_idx = starts(R_MAIN), form.eq_idx()
    k1._phase1_loop.lane_sweeps = k1._phase2_loop.lane_sweeps = 0
    bisect_accept.probes = 0
    ms, x = host_ms(lambda: k1.two_phase_sweeps_ref(
        form.P, form.q, form.r, eq_idx, xs, num_iters=SWEEPS))
    out["k1_main"] = {"x": x, "ms": ms, "probes": int(bisect_accept.probes),
                      "lane_sweeps": k1._phase1_loop.lane_sweeps
                      + k1._phase2_loop.lane_sweeps}
    d = CCPFusedData(form)
    xs = starts(R_CCP[0])
    ms, x = host_ms(lambda: ccp_improve_ref(d, xs))
    out["k4_bench"] = {"x": x, "ms": ms,
                       "trips": ccp_improve_ref.trips.clone()}
    R = R_CCP[1]
    tiles = sorted({0, 1, R // 64 - 1})
    rows = torch.cat([torch.arange(64 * t, 64 * t + 64)
                      for t in tiles]).cuda()
    xs = starts(R)[rows]
    ms, x = host_ms(lambda: ccp_improve_ref(d, xs))
    out["k4_tiles"] = {"tiles": tiles, "rows": rows, "x": x, "ms": ms}
    arrays, xw = k4_wide_case()
    dw = CCPFusedData(form_from_numpy(*arrays, device="cuda",
                                      dtype=torch.float32))
    xw = torch.from_numpy(xw).cuda()
    out["k4_wide"] = {"d": dw, "xs": xw,
                      "x": ccp_improve_ref(dw, xw, **K4_WIDE_KW),
                      "trips": ccp_improve_ref.trips.clone()}
    return out


def main():
    import argparse
    import tempfile
    import torch
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--profile", action="store_true",
                      help="add the profiler breakdown per route and K1's "
                           "time over R")
    args.add_argument("--k1-sample", metavar="PATH",
                      help="(internal) count K1's plain version on the "
                           "sampled starts in PATH, on the CPU")
    args.add_argument("--k1-route-sample", metavar="PATH",
                      help="(internal) count K1's plain version on the "
                           "sampled n = 256 route starts in PATH, on the "
                           "CPU")
    args.add_argument("--k1-wide", metavar="PATH",
                      help="(internal) K1's plain version on the card on "
                           "the cases above n = 128, saved to PATH")
    args.add_argument("--cpu-traces", metavar="PATH",
                      help="(internal) phase tooling's CPU trace replays, "
                           "saved to PATH")
    args.add_argument("--dist-worker", metavar="SPEC",
                      help="(internal) one rank of phase distributed")
    args = args.parse_args()
    if args.k1_sample:
        return k1_sample_counts(args.k1_sample)
    if args.k1_route_sample:
        return k1_route_sample_counts(args.k1_route_sample)
    if args.cpu_traces:
        return cpu_traces(args.cpu_traces)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: no CUDA device")
    if args.dist_worker:
        return dist_worker(args.dist_worker)
    if args.k1_wide:
        return k1_wide_plain(args.k1_wide)
    sys.path.insert(0, REPO)
    import qcqp_tpu_torch  # noqa: F401  (fails outside a checkout)
    with tempfile.TemporaryDirectory() as workdir:
        procs = [start_k1_wide(workdir), start_k1_sample(workdir),
                 start_k1_route_sample(workdir), start_cpu_traces(workdir)]
        try:
            run_phases(args, *procs, workdir)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                proc.wait()


def run_phases(args, wide, sample, route_sample, cpu_proc, workdir):
    import threading
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        return out

    from qcqp_tpu_torch.kernels import _build
    arrays = bench_form_arrays(0)
    # nvcc builds the kernels (phase 1 reports it) while the plain versions
    # that need no kernel run; a failed build raises again in phase 1
    build = threading.Thread(target=_build.library)
    build.start()
    plain = timed("plain_during_build", plain_runs, arrays)
    build.join()
    smi = timed("device", phase_device)
    k2 = timed("k2", phase_k2, arrays[3])
    k1_err = timed("k1", phase_k1, arrays, wide)
    timed("golden", phase_golden)
    launches, ms_main, ms_k1, ms_plain, k1_main_err, k1_bound, main_best = \
        timed("main_path", phase_main, arrays, plain)
    k2_route = timed("k2_route", phase_k2_route,
                     bench_form_arrays(0, N_K2, M_K2), route_sample)
    k3_err = timed("k3", phase_k3, arrays)
    admm = timed("admm_path", phase_admm_path, arrays)
    timed("admm_golden", phase_admm_golden)
    k4 = timed("k4", phase_k4, arrays, plain)
    ccp = timed("ccp_path", phase_ccp_path, arrays, plain)
    timed("ccp_golden", phase_ccp_golden)
    k5 = timed("k5", phase_k5)
    sdr = timed("sdr_path", phase_sdr_path)
    timed("sdr_golden", phase_sdr_golden, sdr["bank16"], sdr["acc16"])
    tooling = timed("tooling", phase_tooling, workdir, cpu_proc)
    spectral = timed("spectral", phase_spectral, tooling["sdr_bound"])
    timed("nlp_path", phase_nlp_path, arrays)
    scen = timed("scenarios", phase_scenarios, sample, workdir,
                 tooling["serving"])
    dist = timed("distributed", phase_distributed, arrays, main_best, scen,
                 workdir)
    if args.profile:
        timed("profile", phase_profile, arrays)
    if "jax" in sys.modules:
        raise AssertionError("JAX was imported")

    emit({"phase": "seconds", **seconds})
    print(smi, flush=True)
    emit({"kernels": [
        {"name": "K1 two_phase_sweeps", "route": "cuda",
         "source": "qcqp_tpu_torch/csrc/cd_sweep.cu",
         "replaces": "qcqp_tpu/kernels/cd_sweep_pallas.py:382",
         "design": "redesigned: one warp per restart, rows and candidates "
                   "over lanes, state in shared memory",
         "launches": launches["k1"],
         "max_abs_err": max(k1_err, k1_main_err),
         "ms": ms_k1, "plain_ms": ms_plain,
         "bound_ms": k1_bound["bound_ms"], "bound_by": k1_bound["bound_by"],
         "library_ms": None,
         "shape": f"n={N}, m={M}, R={R_MAIN}, {SWEEPS} sweeps",
         "ms_main_path": ms_main,
         "at_n256_route": {**k2_route["k1"],
                           "ms_k2_route_mega_false": k2_route["ms_per_solve"],
                           "k2_route_sweeps": K2_ROUTE_SWEEPS},
         "launches_spectral_cd": spectral["k1_launches"],
         "launches_examples": {name: n["k1"] for name, n
                               in tooling["launches"].items()},
         "launches_scenarios": scen["launches"],
         "ms_scenarios": scen["ms"], "ms_scenarios_loop": scen["ms_loop"],
         "shape_scenarios": scen["shape"],
         "bound_ms_scenarios": scen["bound_ms"],
         "bound_by_scenarios": scen["bound_by"],
         "bound_scenarios_from": scen["bound_from"],
         "ms_per_scenario_solve": scen["ms_per_solve"],
         "launches_distributed": {
             "a: NCCL world 1, solve_restarts over global_mesh()":
                 dist["k1_a"],
             "b: gloo world 2 on one card, per rank": dist["k1_b"],
             "b: solve_scenarios_sharded (s = 2), per rank":
                 dist["k1_scenarios_sharded"]}},
        {"name": "K2 phase1_coordinate_update", "route": "cuda",
         "source": "qcqp_tpu_torch/csrc/onevar_phase1.cu",
         "replaces": "qcqp_tpu/kernels/onevar_pallas.py:502",
         "design": "redesigned: one warp per restart, rows and candidates "
                   "over lanes, inputs staged once into shared memory",
         "launches": launches["k2"],
         "max_abs_err": max(k2["max_abs_err"], k2_route["max_abs_err"]),
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": None, "shape": k2["shape"],
         "launches_by_route": {
             f"n={N}, m={M}, mega=False, one solve": launches["k2"],
             f"n={N_K2}, m={M_K2}, mega=False, one solve of "
             f"{K2_ROUTE_SWEEPS} sweeps": k2_route["launches"]},
         "at_k2_route": {**{k: k2_route[k]
                            for k in ("shape", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "ms_per_solve")},
                         "sweeps_per_solve": K2_ROUTE_SWEEPS}},
        {"name": "K3 admm_phase", "route": "cuda",
         "source": "qcqp_tpu_torch/csrc/admm_impl.cuh",
         "replaces": "qcqp_tpu/kernels/admm_pallas.py:407",
         "design": "redesigned: one warp per restart, each Q_i staged once "
                   "per block in shared memory, the consensus fused into "
                   "the projection loop",
         "launches": admm["launches"],
         "max_abs_err": max(k3_err, admm["max_abs_err"]),
         "ms": admm["ms"], "plain_ms": admm["plain_ms"],
         **admm["bound"], "library_ms": None,
         "shape": f"n={N}, m={M}, R={R_ADMM[0]}, {ADMM_ITERS} iterations, "
                  "both phases",
         "ms_by_R": admm["ms_by_R"], "plain_ms_by_R": admm["plain_ms_by_R"],
         "bound_ms_by_R": admm["bound_ms_by_R"],
         "ms_admm_path": admm["ms_per_solve"],
         "launches_examples": {name: n["k3"] for name, n
                               in tooling["launches"].items()},
         "profiler_events_of_one_admm_solve": {
             k: tooling["k3_profile"][k]
             for k in ("trace_kernel_events", "key_averages_events",
                       "launches")},
         "launches_distributed": {
             f"b: gloo world 2 on one card, R = {R_DIST_ADMM}, per rank":
                 dist["k3_b"]}},
        {"name": "K4 ccp_improve", "route": "cuda",
         "source": "qcqp_tpu_torch/csrc/ccp_impl.cuh",
         "replaces": "qcqp_tpu/kernels/ccp_pallas.py:488",
         "launches": ccp["launches"],
         "max_abs_err": max([k4["max_abs_err"]]
                            + [v["max_abs_dx"]
                               for v in ccp["alone"].values()
                               if "max_abs_dx" in v]),
         "ms": k4["ms"], "plain_ms": k4["plain_ms"],
         "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
         "library_ms": None,
         "shape": f"n={N}, m={M}, R={R_CCP[0]}, fused defaults (60 x 10)",
         "ms_by_R": {R: v["k4_ms"] for R, v in ccp["alone"].items()},
         "bound_ms_by_R": {R: v["bound_ms"]
                           for R, v in ccp["alone"].items()},
         "ms_per_inner_trip_by_R": {
             R: v["ms_per_inner_trip"] for R, v in ccp["alone"].items()},
         "ms_ccp_path": ccp["ms_per_solve"],
         "launches_examples": {name: n["k4"] for name, n
                               in tooling["launches"].items()},
         "launches_distributed": {
             f"b: gloo world 2 on one card, R = {R_DIST_CCP}, per rank":
                 dist["k4_b"]}},
        {"name": "K5 eigh_jacobi_vec / eigh_jacobi", "route": "cuda",
         "source": "qcqp_tpu_torch/csrc/eigh_jacobi.cu",
         "replaces": "qcqp_tpu/kernels/eigh_pallas.py:272 and :377",
         "design": "redesigned: only the real n0 x n0 block, through a "
                   "host-built schedule of real pairs; warps own pairs, "
                   "lanes own columns, 2 syncs a round; one warp a matrix "
                   "at n0 <= 32",
         "launches": sdr["launches"], "max_abs_err": k5["max_abs_err"],
         **{k: k5["times"]["B=132,n0=101"][k]
            for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                      "library_ms")},
         "shape": "B=132, N=101 (padded to 128), 2 sweeps: the S = 132 "
                  "vec bank's",
         **{key: {k: k5["times"][key][k]
                  for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
            for key in ("B=1,n0=101", "B=16,n0=25")}},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
