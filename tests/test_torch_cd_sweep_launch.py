"""What surrounds K1's launch (qcqp_tpu_torch/kernels/cd_sweep_kernel.py),
checked on the CPU: the launch geometry (warps a block, shared memory a
warp) for every shape the CD route sends to K1, the lane layout of P and q,
the C entry points' argument types against their sources, and the route
choice of improve_coord_descent_fused: K1 wherever its shared memory holds
a restart (`cd_sweep_kernel.holds`), where the JAX package's TPU budget
(`_mega_fits`) stops at n = 128."""

import glob
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qcqp_tpu.core import QCQPForm as JForm
from qcqp_tpu.solvers import coord_descent_fused as jfused

from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.kernels import _build
from qcqp_tpu_torch.kernels import cd_sweep_kernel as tk
from qcqp_tpu_torch.solvers import coord_descent_fused as tfused


def _largest_m(n, all_eq=False):
    """The largest m that the CD route sends to K1 at n, with E = 0 or
    E = m (None: no m), by bisection on `cd_sweep_kernel.holds`."""
    def fits(m):
        return tk.holds(n, m, m if all_eq else 0)
    if not fits(1):
        return None
    lo, hi = 1, 1 << 16                 # fits(lo) and not fits(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def test_largest_m_is_the_shared_memory_limit():
    """The routing rule's edges: 3n + 4(m+1) + 5(m+E) floats, rounded up
    to 16 bytes, within 232,448 bytes (58,112 floats)."""
    assert _largest_m(1) == 6456 and _largest_m(8) == 6453
    assert _largest_m(128) == _largest_m(129) == 6413
    assert _largest_m(8, all_eq=True) == 4148
    assert _largest_m(19366) == 1 and _largest_m(19367) is None
    assert _largest_m(19364, all_eq=True) == 1
    assert _largest_m(19365, all_eq=True) is None


@pytest.mark.parametrize("eq", ["none", "all"])
def test_geometry_fits_every_k1_shape(eq):
    """At n = 1..256 and at every 97th n up to 19,364, at the largest m K1
    takes with E = 0 or E = m: at least one warp, the state within the
    block's 227 KB, a warp's floats covering 3n + 4(m+1) + 5(m+E) and
    16-byte aligned; one more row and the geometry raises."""
    for n in list(range(1, 257)) + list(range(257, 19365, 97)):
        m = _largest_m(n, all_eq=eq == "all")
        e = m if eq == "all" else 0
        warps, warp_floats, nbytes = tk.launch_geometry(n, m, e)
        assert 1 <= warps <= tk.MAX_WARPS
        assert warp_floats >= 3 * n + 4 * (m + 1) + 5 * (m + e)
        assert warp_floats % 4 == 0 and warp_floats - 4 < \
            3 * n + 4 * (m + 1) + 5 * (m + e)
        assert nbytes == 4 * warps * warp_floats <= tk.SMEM_BLOCK_MAX
        assert 4 * (warps + 1) * warp_floats > tk.SMEM_BLOCK_MAX or \
            warps == tk.MAX_WARPS
        with pytest.raises(ValueError, match="shared memory"):
            tk.launch_geometry(n, m + 1, e + (eq == "all"))


def test_geometry_at_the_bench_shape():
    """n = 100, m = 50, E = 22: 3.3 KB a warp, 4 warps a block at
    R = 10,240 on 132 SMs; one warp a block at R = 256, so that the
    restarts spread over the SMs."""
    warps, warp_floats, nbytes = tk.launch_geometry(100, 50, 22)
    assert (warps, warp_floats) == (4, 3 * 100 + 4 * 51 + 5 * 72)
    assert 4 * warp_floats == 3456 and nbytes == 4 * 3456
    assert tk.launch_geometry(100, 50, 22, 10240, 132)[0] == 4
    assert tk.launch_geometry(100, 50, 22, 256, 132)[0] == 1
    assert tk.launch_geometry(100, 50, 22, 1, 132)[0] == 1
    assert tk.launch_geometry(100, 50, 22, 400, 132)[0] == 3


def test_geometry_raises_above_a_block():
    """A warp's state above 232,448 bytes raises; just below it, one warp
    a block."""
    with pytest.raises(ValueError, match="shared memory"):
        tk.launch_geometry(8, 7000, 7000)
    # 24 + 4 (m+1) + 5 m, rounded up to 4, <= 58,112 floats: m <= 6,453
    assert tk.launch_geometry(8, 6453, 0)[0] == 1
    with pytest.raises(ValueError):
        tk.launch_geometry(8, 6454, 0)


def test_lane_layout():
    """Pt[k, j, i] == P[i, k, j] and qt[a, i] == q[i, a], contiguous."""
    rng = np.random.default_rng(0)
    P = torch.from_numpy(rng.standard_normal((6, 5, 5)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    Pt, qt = tk.lane_layout(P, q)
    assert Pt.shape == (5, 5, 6) and qt.shape == (5, 6)
    assert Pt.is_contiguous() and qt.is_contiguous()
    for i in range(6):
        for k in range(5):
            assert torch.equal(Pt[k, :, i], P[i, k, :])
            assert qt[k, i] == q[i, k]
    flat = Pt.reshape(-1)
    assert flat[(2 * 5 + 3) * 6 + 4] == P[4, 2, 3]


def _c_argtypes(name):
    """The ctypes types of entry point `name`, read from its source."""
    for path in glob.glob(os.path.join(_build.CSRC, "*.cu")):
        src = open(path).read()
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        if m:
            break
    else:
        raise AssertionError(f"{name} is in no source")
    out = []
    for arg in m.group(1).split(","):
        arg = " ".join(arg.split())
        if "*" in arg:
            out.append(_build._P)
        elif arg.startswith("int "):
            out.append(_build._I)
        elif arg.startswith("float "):
            out.append(_build._F)
        else:
            raise AssertionError(f"{name}: unknown argument {arg!r}")
    return out


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signatures_match_the_sources(name):
    """ctypes passes each argument as its declared type (a pointer cut to
    an int, or an int read as a pointer, would fail only on the card)."""
    assert _build._SIGNATURES[name] == _c_argtypes(name)


def test_cpu_tensors_run_the_plain_version():
    """On CPU tensors the wrappers are the plain versions and launch
    nothing."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((4, 6, 6))
    P = torch.from_numpy((0.5 * (A + np.swapaxes(A, 1, 2)))
                         .astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    r = torch.from_numpy(-np.abs(rng.standard_normal(4)).astype(np.float32))
    xs = torch.from_numpy(rng.standard_normal((9, 6)).astype(np.float32))
    before = (tk.two_phase_sweeps.launches, tk.phase1_sweeps.launches)
    for fn, ref in ((tk.two_phase_sweeps, tk.two_phase_sweeps_ref),
                    (tk.phase1_sweeps, tk.phase1_sweeps_ref)):
        assert torch.equal(fn(P, q, r, (1,), xs, num_iters=3),
                           ref(P, q, r, (1,), xs, num_iters=3))
    assert (tk.two_phase_sweeps.launches, tk.phase1_sweeps.launches) == \
        before


@pytest.mark.parametrize("n,m,k1,jax_k1", [
    (128, 78, True, True), (128, 79, True, False), (129, 1, True, False),
    (8, 1279, True, False), (8, 5050, True, False), (8, 5051, False, False)])
def test_k1_route_choice(monkeypatch, n, m, k1, jax_k1):
    """improve_coord_descent_fused sends a form to K1 exactly where K1
    holds a restart (E = ceil(m / 2) here), and otherwise to phase 1
    through K2 and the unfused phase 2; mega=False forces the second
    route.  The JAX package's rule, for the record of the deviation,
    takes K1 only at (128, 78)."""
    calls = []

    def record(route):
        def fn(*args, **kw):
            calls.append(route)
            xs = args[4] if route == "k1" else args[1]
            return xs.clone()
        return fn
    monkeypatch.setattr(tfused, "two_phase_sweeps", record("k1"))
    monkeypatch.setattr(tfused, "coord_descent_phase1_fused", record("k2"))
    monkeypatch.setattr(tfused, "coord_descent_phase2", record("phase2"))
    P = np.zeros((m + 1, n, n))
    P[:, np.arange(n), np.arange(n)] = 1.0
    q, r = np.zeros((m + 1, n)), -np.ones(m + 1)
    is_eq = np.arange(m) % 2 == 0
    form = form_from_numpy(P, q, r, is_eq, device="cpu",
                           dtype=torch.float32)
    assert tk.holds(n, m, int(is_eq.sum())) == k1
    xs = torch.zeros((2, n))
    xs[:, 0] = 1.0                  # feasible: the phase-2 gate lets it in
    tfused.improve_coord_descent_fused(form, xs, num_iters=1)
    assert calls == (["k1"] if k1 else ["k2", "phase2"])
    jform = JForm(*map(jnp.asarray, (P, q, r, is_eq)))
    assert jfused._mega_fits(jform) == jax_k1
    calls.clear()
    tfused.improve_coord_descent_fused(form, xs, num_iters=1, mega=False)
    assert calls == ["k2", "phase2"]
