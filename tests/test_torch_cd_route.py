"""The CD route above n = 128 on the port: K1 wherever its shared memory
holds a restart (kernels/cd_sweep_kernel.holds, read by
solvers/coord_descent_fused.py), a stated deviation from the JAX package,
whose TPU budget (`_mega_fits`) sends every n > 128 to its K2 route.

K1's plain version at n = 130 is held, pooled over seeds, to the margins of
tests/test_cd_sweep_pallas.py:104-110 against both functions the JAX package
computes there: its default route (phase 1 through its Pallas K2 in
interpret=True, then the unfused phase 2) and its Pallas K1 forced at
n = 130 (interpret=True); no restart ends worse than its start.  The rule
itself is pinned on the CPU with the routes monkeypatched, for one form and
for a stack of them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qcqp_tpu.core import QCQPForm as JForm
from qcqp_tpu.kernels import cd_sweep_pallas as jk
from qcqp_tpu.solvers import coord_descent_fused as jfused

from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.kernels import cd_sweep_kernel as tk
from qcqp_tpu_torch.parallel.scenarios import stack_forms
from qcqp_tpu_torch.solvers import coord_descent_fused as tfused
from .test_torch_cd_sweep import (F32, SEEDS, _arrays, _best, _margins,
                                  _quality)

torch.set_num_threads(1)
N_WIDE, M_WIDE, R_WIDE, SWEEPS_WIDE = 130, 4, 128, 2


@pytest.fixture(scope="module")
def port_k1():
    """Per seed: the arrays, equality rows, starts and the port's default
    route at n = 130, 2 sweeps: K1's plain version (the route rule's
    tests below pin that it is K1's)."""
    out = []
    for seed in SEEDS:
        arrays, eq_idx, rng = _arrays(N_WIDE, M_WIDE, seed, 0.5)
        xs = rng.standard_normal((R_WIDE, N_WIDE)).astype(F32)
        form = form_from_numpy(*arrays, device="cpu", dtype=torch.float32)
        assert tk.holds(N_WIDE, M_WIDE, len(eq_idx))
        x = tfused.improve_coord_descent_fused(
            form, torch.from_numpy(xs), num_iters=SWEEPS_WIDE).numpy()
        out.append((arrays, eq_idx, xs, x))
    return out


def _pooled_against(port_k1, jax_fn):
    v_ref, v_new, best_pairs = [], [], []
    for arrays, eq_idx, xs, xt in port_k1:
        vj, oj = _quality(arrays, np.asarray(jax_fn(arrays, eq_idx, xs)))
        vt, ot = _quality(arrays, xt)
        assert (vt <= _quality(arrays, xs)[0] + 1e-3).all()
        v_ref.append(vj)
        v_new.append(vt)
        bj, bt = _best(vj, oj), _best(vt, ot)
        if bj is not None and bt is not None:
            best_pairs.append((bj, bt))
    _margins(np.concatenate(v_ref), np.concatenate(v_new), best_pairs)


def test_k1_above_128_matches_jax_default_route_pooled(port_k1):
    """K1's plain version against the JAX package's route at n = 130."""
    def jax_fn(arrays, eq_idx, xs):
        form = JForm(*map(jnp.asarray, arrays))
        assert not jfused._mega_fits(form)
        return jfused.improve_coord_descent_fused(
            form, jnp.asarray(xs), num_iters=SWEEPS_WIDE, interpret=True)
    _pooled_against(port_k1, jax_fn)


def test_k1_above_128_matches_jax_pallas_k1_pooled(port_k1):
    """K1's plain version against the JAX package's whole-sweep Pallas
    kernel, which computes the same function at n = 130 though its route
    does not take it there."""
    def jax_fn(arrays, eq_idx, xs):
        P, q, r, _ = arrays
        return jk.two_phase_sweeps(jnp.asarray(P), jnp.asarray(q),
                                   jnp.asarray(r), eq_idx, jnp.asarray(xs),
                                   num_iters=SWEEPS_WIDE, interpret=True)
    _pooled_against(port_k1, jax_fn)


def _largest_m_e0(n):
    """The largest m at which K1 holds a restart at n with E = 0."""
    m = 0
    while tk.holds(n, m + 1, 0):
        m += 1
    return m


# (n, m, K1 takes it): the three shapes named by the rule's change, and
# the first m past the shared-memory limit at n = 8, E = 0.
ROUTE_CASES = [(129, 1, True), (256, 20, True), (128, 79, True),
               (8, _largest_m_e0(8) + 1, False)]


def _recording(monkeypatch):
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
    return calls


def _route_form(n, m, eq=False):
    """A form whose starts are feasible (the phase-2 gate lets them in),
    its m rows all equalities or all inequalities."""
    P = np.zeros((m + 1, n, n), np.float32)
    P[:, np.arange(n), np.arange(n)] = 1.0
    return form_from_numpy(P, np.zeros((m + 1, n)), -np.ones(m + 1),
                           np.full(m, eq), device="cpu",
                           dtype=torch.float32)


@pytest.mark.parametrize("n,m,k1", ROUTE_CASES)
def test_route_rule_single_form(monkeypatch, n, m, k1):
    calls = _recording(monkeypatch)
    form = _route_form(n, m)
    xs = torch.zeros((2, n))
    xs[:, 0] = 1.0
    assert tk.holds(n, m, 0) == k1
    tfused.improve_coord_descent_fused(form, xs, num_iters=1)
    assert calls == (["k1"] if k1 else ["k2", "phase2"])
    calls.clear()
    tfused.improve_coord_descent_fused(form, xs, num_iters=1, mega=False)
    assert calls == ["k2", "phase2"]
    if not k1:
        with pytest.raises(ValueError, match="does not hold a restart"):
            tfused.improve_coord_descent_fused(form, xs, num_iters=1,
                                               mega=True)


@pytest.mark.parametrize("n,m,k1", ROUTE_CASES)
def test_route_rule_stack(monkeypatch, n, m, k1):
    """improve_coord_descent_fused_stack takes the same rule: one K1 launch
    for the stack, or the K2 route one scenario at a time."""
    calls = _recording(monkeypatch)
    form = _route_form(n, m)
    stack = stack_forms([form, form])
    xs = torch.zeros((2, 3, n))
    xs[:, :, 0] = 1.0
    tfused.improve_coord_descent_fused_stack(stack, xs, num_iters=1)
    assert calls == (["k1"] if k1 else ["k2", "phase2"] * 2)
    calls.clear()
    tfused.improve_coord_descent_fused_stack(stack, xs, num_iters=1,
                                             mega=False)
    assert calls == ["k2", "phase2"] * 2
    if not k1:
        with pytest.raises(ValueError, match="does not hold a restart"):
            tfused.improve_coord_descent_fused_stack(stack, xs, num_iters=1,
                                                     mega=True)


def test_stack_rule_reads_the_largest_e(monkeypatch):
    """At the edge K1 holds a restart of a scenario with E = 0 and not of
    one with E = m: their stack takes the K2 route, one scenario at a
    time, and each alone takes its own route."""
    n = 8
    m = _largest_m_e0(n)
    calls = _recording(monkeypatch)
    forms = [_route_form(n, m), _route_form(n, m, eq=True)]
    xs = torch.zeros((2, 3, n))
    xs[:, :, 0] = 1.0
    tfused.improve_coord_descent_fused_stack(stack_forms(forms), xs,
                                             num_iters=1)
    assert calls == ["k2", "phase2"] * 2
    calls.clear()
    for form, x in zip(forms, xs):
        tfused.improve_coord_descent_fused(form, x, num_iters=1)
    assert calls == ["k1", "k2", "phase2"]


def test_routes_benchmark_on_the_cpu():
    """benchmarks/cd_routes.measure at a small shape on the CPU, where both
    routes run their plain versions: the keys it prints, K1's geometry,
    no launch, finite results; and no card means it raises."""
    from qcqp_tpu_torch.benchmarks import cd_routes
    out = cd_routes.measure(12, 5, 16, [1, 2], [1], device="cpu")
    assert (out["n"], out["m"], out["R"]) == (12, 5, 16)
    assert out["Pt_mb"] == 4 * 6 * 144 / 1e6
    assert tuple(out["k1_geometry"].values()) == tk.launch_geometry(
        12, 5, out["E"], 16)
    assert [r["sweeps"] for r in out["k1"]] == [1, 2]
    assert len(out["k1"][0]["ms"]) == 3 and len(out["k2_route"][0]["ms"]) == 1
    for r in out["k1"] + out["k2_route"]:
        assert r["launches"] == {"k1": 0, "k2": 0}
        assert np.isfinite(r["best_f"]) and np.isfinite(r["best_viol"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cd_routes.measure(12, 5, 16, [1], [1])
