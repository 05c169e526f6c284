"""The scenarios slice on the CPU: qcqp_tpu_torch's problem-bank IO
(native.bank_write / bank_info / bank_load, natively and through .npz),
stack_forms, forms_from_bank and solve_scenarios against qcqp_tpu's from the
same banks and the same starts, the stacked plain version of K1, the
serving pipeline of examples/scenario_serving.py at its own size, the
errors, and the port's isolation from the JAX package's files."""

import ast
import glob
import os
import re

import numpy as np
import pytest
import torch

import jax
import qcqp_tpu as jqt
from qcqp_tpu import core as jcore
from qcqp_tpu import native as jnative
from qcqp_tpu.parallel import restarts as jrestarts
from qcqp_tpu.parallel import scenarios as jscen
from qcqp_tpu.solvers import sdp as jsdp

import qcqp_tpu_torch as tqt
from qcqp_tpu_torch import native as tnative
from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.kernels import cd_sweep_kernel as k1
from qcqp_tpu_torch.parallel import restarts as trestarts
from qcqp_tpu_torch.parallel import scenarios as tscen
from qcqp_tpu_torch.solvers import sdp as tsdp

from .test_cd import boolean_ls_form

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

needs_native = pytest.mark.skipif(
    not (tnative.available() and jnative.available()),
    reason="native library unavailable (no g++?)")


def _bank_arrays(seed=2, count=7, n=6, m=4):
    """tests/test_native.py:43-60's bank."""
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((count, m + 1, n, n))
    q = rng.standard_normal((count, m + 1, n))
    r = rng.standard_normal((count, m + 1))
    eq = rng.random((count, m)) < 0.5
    return P, q, r, eq


def _equal_slices(loaded, arrays, lo, hi):
    for a, b in zip(loaded, arrays):
        np.testing.assert_array_equal(a, b[lo:hi])
    assert loaded[3].dtype == bool


@needs_native
def test_bank_roundtrip(tmp_path):
    arrays = _bank_arrays()
    path = str(tmp_path / "bank.qcqp")
    tnative.bank_write(path, *arrays)
    assert tnative.bank_info(path) == (7, 6, 4)
    _equal_slices(tnative.bank_load(path, 2, 4), arrays, 2, 6)
    _equal_slices(tnative.bank_load(path, 0, 7), arrays, 0, 7)
    with pytest.raises(IOError):
        tnative.bank_load(path, 5, 4)             # past the last instance
    with pytest.raises(IOError):
        tnative.bank_info(str(tmp_path / "missing.qcqp"))


def _no_native(monkeypatch, which):
    """Force a package's library absent: the .npz path runs."""
    if which == "port":
        monkeypatch.setattr(tnative._Lib, "tried", True)
        monkeypatch.setattr(tnative._Lib, "lib", None)
        assert not tnative.available()
    else:
        monkeypatch.setattr(jnative, "_lib", None)
        monkeypatch.setattr(jnative, "_load", lambda: None)


@pytest.mark.parametrize("npz", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bank_crosses_between_packages(tmp_path, monkeypatch, writer, npz):
    """A bank written by either package loads in the other, equal arrays:
    the native file (byte for byte the same format, canon.cc on both
    sides), and the .npz file both write where their library is absent."""
    if not npz and not (tnative.available() and jnative.available()):
        pytest.skip("native library unavailable (no g++?)")
    if npz:
        _no_native(monkeypatch, "port")
        _no_native(monkeypatch, "jax")
    arrays = _bank_arrays(seed=3, count=5, n=4, m=3)
    path = str(tmp_path / "bank.qcqp")
    write, read = ((jnative, tnative) if writer == "jax"
                   else (tnative, jnative))
    write.bank_write(path, *arrays)
    assert os.path.exists(path + ".npz" if npz else path)
    assert read.bank_info(path) == (5, 4, 3)
    _equal_slices(read.bank_load(path, 1, 3), arrays, 1, 4)


def _jax_forms(n=5, m=7, seeds=range(4)):
    return [boolean_ls_form(n=n, m=m, seed=s)[0] for s in seeds]


def _port_form(jform):
    return form_from_numpy(*(np.asarray(a) for a in jform), device="cpu")


def _assert_forms_equal(tform, jform):
    for a, b in zip(tform, jform):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_stack_forms_and_form_from_numpy_match_jax():
    """stack_forms on tests/test_aux.py:16-43's forms equals the JAX
    package's stack, and a JAX stack crosses as numpy through
    form_from_numpy, leading scenario axis and all."""
    jforms = _jax_forms()
    jstack = jscen.stack_forms(jforms)
    tstack = tscen.stack_forms([_port_form(f) for f in jforms])
    assert tstack.P.shape == (4, 6, 5, 5) and tstack.is_eq.dtype == torch.bool
    _assert_forms_equal(tstack, jstack)
    _assert_forms_equal(
        form_from_numpy(*(np.asarray(a) for a in jstack), device="cpu"),
        jstack)
    form = tscen.scenario(tstack, 2)
    _assert_forms_equal(form, jforms[2])


@needs_native
def test_forms_from_bank_matches_jax(tmp_path):
    jstack = jscen.stack_forms(_jax_forms())
    path = str(tmp_path / "bank.qcqp")
    tnative.bank_write(path, *(np.asarray(a) for a in jstack))
    tform = tscen.forms_from_bank(path, start=1, batch=2, device="cpu")
    jform = jscen.forms_from_bank(path, start=1, batch=2)
    assert tform.dtype == torch.float64 and tform.P.shape[0] == 2
    _assert_forms_equal(tform, jform)
    _assert_forms_equal(tform, jscen.stack_forms(_jax_forms()[1:3]))
    f32 = tscen.forms_from_bank(path, device="cpu", dtype=torch.float32)
    assert f32.dtype == torch.float32 and f32.P.shape[0] == 4


def _chain_forms(kind):
    """boolean_ls_form(n=6, m=8, seed=s), s = 0..2, or three random_form
    instances with three equality patterns (none, mixed, all).  A random
    form's objective is indefinite, so unbounded below: both packages run
    off towards -1e16 on it, where float64 round-off parts them.  Its
    objective is shifted to (1 - lambda_min) I + P_0, positive definite,
    as dc_split shifts a row (qcqp/utilities.py:82-89)."""
    if kind == "boolean_ls":
        return [boolean_ls_form(n=6, m=8, seed=s)[0] for s in range(3)]
    forms = []
    for i, frac in enumerate((0.0, 0.5, 1.0)):
        f = jcore.random_form(np.random.default_rng(20 + i), 6, 8,
                              eq_frac=frac)
        P = np.array(f.P)
        P[0] += (1.0 - np.linalg.eigvalsh(P[0]).min()) * np.eye(6)
        forms.append(f._replace(P=jax.numpy.asarray(P)))
    return forms


def _jax_after_draw(jstack, xs, improve, **kw):
    """The JAX solve_scenarios after its draw (qcqp_tpu/parallel/
    scenarios.py:63-74) from the starts xs."""
    fn = jax.jit(jax.vmap(lambda f, x: jrestarts.best_point(
        f, jrestarts.improve_chain(f, x, improve, **kw))))
    return [np.asarray(a) for a in fn(jstack, jax.numpy.asarray(xs))]


@pytest.mark.parametrize("improve", [tqt.COORD_DESCENT, tqt.ADMM])
@pytest.mark.parametrize("kind", ["boolean_ls", "random"])
def test_solve_scenarios_matches_jax(kind, improve):
    """The port's solve_scenarios after the draw against the JAX package's
    solve_scenarios, in float64 on the CPU, from the JAX starts (drawn as
    qcqp_tpu/parallel/scenarios.py:63-73 draws them), 100 iterations.  The
    tolerance is that of tests/test_torch_admm_slice.py::
    test_improve_chain_and_best_point_match_jax for the same chain on one
    form: each best objective to 1e-8 relative, each best violation to
    1e-8 absolute.

    ADMM on the random forms is chaotic at round-off in either package: at
    100 iterations the JAX package's own best (f, v) of every scenario
    moves by 1e-6 relative when its starts move by a few ulps.  There it
    runs 20 iterations, and the port is held on the scenarios the JAX
    package determines (its (f, v) moves by less than 1e-9), as
    tests/test_torch_nlp.py holds the NLP's lanes."""
    jforms = _chain_forms(kind)
    if kind == "random":
        assert len({tuple(np.asarray(f.is_eq)) for f in jforms}) == 3
    chaotic = kind == "random" and improve == tqt.ADMM
    jstack = jscen.stack_forms(jforms)
    R, kw = 16, dict(num_iters=20 if chaotic else 100)
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, len(jforms))
    xs = np.stack([np.asarray(jrestarts.suggest_batch(f, R, k, jqt.RANDOM))
                   for f, k in zip(jforms, keys)])
    xj, fj, vj = (np.asarray(a) for a in
                  jscen.solve_scenarios(jstack, R, key, improve=improve, **kw))
    tstack = tscen.stack_forms([_port_form(f) for f in jforms])
    xt, ft, vt = (a.numpy() for a in tscen._solve_from_starts(
        tstack, torch.from_numpy(xs), improve, **kw))
    assert xt.shape == (3, 6) and ft.shape == vt.shape == (3,)
    held = np.ones(3, bool)
    if chaotic:
        spread = np.zeros(3)
        for s in range(3):
            xp = xs * (1.0 + 4e-16 * np.random.default_rng(50 + s)
                       .standard_normal(xs.shape))
            _, fp, vp = _jax_after_draw(jstack, xp, improve, **kw)
            spread = np.maximum(spread, np.maximum(
                np.abs(fp - fj) / np.abs(fj),
                np.abs(vp - vj) / np.maximum(np.abs(vj), 1e-300)))
        held = spread < 1e-9
        assert held.any()
    np.testing.assert_allclose(ft[held], fj[held], rtol=1e-8)
    np.testing.assert_allclose(vt[held], vj[held], rtol=0, atol=1e-8)
    for i, f in enumerate(jforms):    # each best point is its (f, v)
        np.testing.assert_allclose(
            float(jcore.eval_objective(f, jax.numpy.asarray(xt[i]))),
            ft[i], rtol=1e-9)


def _eq_patterns(m):
    """Per-scenario equality patterns with different E: none, all, mixed."""
    rng = np.random.default_rng(7)
    return [(), tuple(range(m)),
            tuple(int(i) for i in np.nonzero(rng.random(m) < 0.5)[0])]


@pytest.mark.parametrize("phase1", [True, False])
def test_stacked_plain_version_equals_a_loop(phase1):
    """K1's plain version on a stack, and the wrapper on CPU tensors, equal
    the plain version scenario by scenario (torch.equal), with E = 0, E = m
    and a mixed E; phase1_sweeps_ref likewise."""
    n, m, R = 6, 5, 9
    rng = np.random.default_rng(11)
    A = rng.standard_normal((3, m + 1, n, n))
    P = torch.from_numpy(0.5 * (A + np.swapaxes(A, -1, -2))).float()
    q = torch.from_numpy(rng.standard_normal((3, m + 1, n))).float()
    r = torch.from_numpy(rng.standard_normal((3, m + 1))).float()
    r[:, 1:] = -r[:, 1:].abs()
    xs = torch.from_numpy(0.1 * rng.standard_normal((3, R, n))).float()
    eqs = _eq_patterns(m)
    assert sorted(len(e) for e in eqs)[0] == 0 and len(eqs[1]) == m
    kw = dict(num_iters=4, phase1=phase1)
    loop = torch.stack([k1.two_phase_sweeps_ref(P[s], q[s], r[s], eqs[s],
                                                xs[s], **kw)
                        for s in range(3)])
    assert torch.equal(k1.two_phase_sweeps_ref(P, q, r, eqs, xs, **kw), loop)
    assert torch.equal(k1.two_phase_sweeps(P, q, r, eqs, xs, **kw), loop)
    assert (loop[0] != xs[0]).any()       # E = 0: phase 2 runs from xs
    if phase1:
        loop1 = torch.stack([k1.phase1_sweeps_ref(P[s], q[s], r[s], eqs[s],
                                                  xs[s], num_iters=4)
                             for s in range(3)])
        assert torch.equal(k1.phase1_sweeps_ref(P, q, r, eqs, xs,
                                                num_iters=4), loop1)
    mask, idx, counts = k1.eq_arrays(eqs, m)
    assert mask.shape == (3, m) and idx.shape == (3, m)
    assert counts.tolist() == [len(e) for e in eqs]
    assert mask.sum(axis=1).tolist() == counts.tolist()
    with pytest.raises(ValueError):
        k1.two_phase_sweeps_ref(P, q, r, eqs[:2], xs, **kw)
    with pytest.raises(ValueError):
        k1.eq_arrays([(m,)], m)
    Pt, qt = k1.lane_layout(P, q)
    assert Pt.shape == (3, n, n, m + 1) and qt.shape == (3, n, m + 1)
    assert torch.equal(Pt[1, 2, 3], P[1, :, 2, 3])
    assert torch.equal(qt[2, 4], q[2, :, 4])


def test_solve_scenarios_draws_in_scenario_order(monkeypatch):
    """With the kernels' route taken (as on a CUDA float32 stack, patched
    on here), CD is one stacked K1 call per solve, each scenario with its
    own equality pattern, and scenario s equals solve_restarts on its form
    from the generator after the draws of scenarios 0..s-1, bit for bit;
    an explicit use_fused=False runs the unfused chain."""
    calls = []
    real = k1.two_phase_sweeps

    def spy(P, *a, **kw):
        calls.append(tuple(P.shape))
        return real(P, *a, **kw)
    from qcqp_tpu_torch.solvers import coord_descent_fused as fused
    monkeypatch.setattr(fused, "two_phase_sweeps", spy)
    monkeypatch.setattr(trestarts, "_fused_default", lambda form: True)
    monkeypatch.setattr(tscen, "_fused_default", lambda form: True)
    rng = np.random.default_rng(5)
    forms = [tqt.core.random_form(rng, 5, 4, eq_frac=f, device="cpu",
                                  dtype=torch.float32)
             for f in (0.0, 0.5, 1.0)]
    stack = tscen.stack_forms(forms)
    gen = lambda: torch.Generator().manual_seed(3)      # noqa: E731
    xs, fs, vs = tscen.solve_scenarios(stack, 8, gen(), num_iters=5)
    assert calls == [(3, 5, 5, 5)]
    g = gen()
    for s, form in enumerate(forms):
        x, f, v = trestarts.solve_restarts(form, 8, g, num_iters=5)
        assert torch.equal(x, xs[s]) and torch.equal(f, fs[s])
        assert torch.equal(v, vs[s])
    assert len(calls) == 4          # solve_restarts: one call a form
    calls.clear()
    tscen.solve_scenarios(stack, 8, gen(), num_iters=5, use_fused=False)
    assert calls == []


def test_stack_k2_route_runs_one_scenario_at_a_time():
    """Where K1 does not run (mega=False, or shapes K1 cannot hold),
    the stacked improve is the K2 route one scenario at a time: equal to
    improve_coord_descent_fused on each form (torch.equal)."""
    from qcqp_tpu_torch.solvers import coord_descent_fused as fused
    rng = np.random.default_rng(6)
    forms = [tqt.core.random_form(rng, 5, 4, eq_frac=f, device="cpu",
                                  dtype=torch.float32) for f in (0.0, 1.0)]
    stack = tscen.stack_forms(forms)
    xs = torch.from_numpy(0.3 * rng.standard_normal((2, 6, 5))).float()
    out = fused.improve_coord_descent_fused_stack(stack, xs, num_iters=3,
                                                  mega=False)
    for s, form in enumerate(forms):
        assert torch.equal(out[s], fused.improve_coord_descent_fused(
            form, xs[s], num_iters=3, mega=False))
    assert (out != xs).any()


def _serving_forms(qt, S=8, n=12, m=12, **kw):
    """examples/scenario_serving.py:27-40: S boolean least-squares
    instances from default_rng(0)."""
    rng = np.random.default_rng(0)
    forms = []
    for _ in range(S):
        A = rng.standard_normal((m, n))
        b = rng.standard_normal(m)
        x = qt.Variable(n)
        prob = qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                          [qt.square(x) == 1])
        forms.append(qt.canonicalize(prob, **kw)[0])
    return forms


def test_serving_example_at_its_own_size(tmp_path):
    """examples/scenario_serving.py in the port, float64 on the CPU: bank
    write, forms_from_bank, solve_sdr_batch (max_iters=4000, tol=1e-7, as
    the example), then solve_scenarios (64 restarts, CD at its default
    1,000 iterations).  Every scenario feasible (violation < 1e-2) with an
    objective at least its SDR bound - 1e-3, and the bounds within 1e-6
    relative of the JAX package's (the tolerance of tests/test_torch_sdr.py
    ::test_sdr_batch_gate_and_fallback_match_jax)."""
    stacked = tscen.stack_forms(_serving_forms(tqt, device="cpu"))
    path = str(tmp_path / "instances.qcqp")
    tnative.bank_write(path, *(a.numpy() for a in stacked))
    loaded = tscen.forms_from_bank(path, device="cpu")
    _assert_forms_equal(loaded, stacked)
    X, bounds, rp, rd = tsdp.solve_sdr_batch(loaded, max_iters=4000,
                                             tol=1e-7)
    xs, fs, vs = tscen.solve_scenarios(
        loaded, 64, torch.Generator().manual_seed(0),
        improve=tqt.COORD_DESCENT)
    assert xs.shape == (8, 12)
    assert (vs < 1e-2).all()
    assert (fs >= bounds - 1e-3).all()
    jstack = jscen.stack_forms(_serving_forms(jqt))
    _assert_forms_equal(stacked, jstack)
    _, jbounds, _, _ = jsdp.solve_sdr_batch(jstack, max_iters=4000, tol=1e-7)
    jb = np.asarray(jbounds)
    assert np.abs(bounds.numpy() - jb).max() / np.abs(jb).max() < 1e-6


def test_errors(monkeypatch):
    """SDR and SPECTRAL suggests raise ValueError (no relaxation reaches the
    batch suggest, as in the JAX package), a mesh larger than the process
    world and a stack that is not this rank's block of the scenarios raise
    ValueError, and forms_from_bank without a card and without
    device="cpu" raises RuntimeError."""
    stack = tscen.stack_forms([_port_form(f) for f in _jax_forms(seeds=[0])])
    for suggest in (tqt.SDR, tqt.SPECTRAL, "nope"):
        with pytest.raises(ValueError):
            tscen.solve_scenarios(stack, 4, suggest=suggest)
    with pytest.raises(ValueError):
        tscen.solve_scenarios(stack, 4, improve="nope")
    with pytest.raises(ValueError, match="need 2 processes"):
        tscen.solve_scenarios(stack, 4, mesh=tscen.Mesh([("r", 2)]))
    with pytest.raises(ValueError, match="block holds 3 of the 3"):
        tscen.solve_scenarios_sharded(
            stack, 4, None, tscen.Mesh([("s", 1), ("r", 1)]),
            num_scenarios=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tscen.forms_from_bank("no-such-bank.qcqp")


def test_parallel_exports_match_jax_where_ported():
    """qcqp_tpu_torch.parallel exports every public name of
    qcqp_tpu.parallel, and launch every entry point of its launch."""
    import qcqp_tpu.parallel as jparallel
    from qcqp_tpu.parallel import launch as jlaunch
    from qcqp_tpu_torch import parallel
    from qcqp_tpu_torch.parallel import launch
    names = {n for n in dir(jparallel) if not n.startswith("_")} - {
        "launch", "mesh", "mesh2d", "restarts", "scenarios"}
    assert {"make_mesh", "admm_phase1_sharded", "make_mesh_2d",
            "improve_admm_2d", "solve_restarts_2d", "solve_scenarios_sharded",
            "best_point", "stack_forms"} <= names
    assert [n for n in sorted(names) if not hasattr(parallel, n)] == []
    for n in ("initialize", "is_initialized", "is_coordinator",
              "global_mesh", "solve_restarts_distributed", "shutdown"):
        assert callable(getattr(jlaunch, n)) and callable(getattr(launch, n))


_CITATION = re.compile(r"qcqp_tpu/[\w/.]+\.\w+:\d+")


def _non_docstring_strings(path):
    tree = ast.parse(open(path).read())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [(node.lineno, node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


def test_port_reads_no_file_of_the_jax_package():
    """The native source the port builds is its own copy, and no .py file
    of the port (nor chip_smoke.py, nor the port's test worker) builds a
    path into qcqp_tpu/: outside
    docstrings, "qcqp_tpu" appears only as qcqp_tpu_torch or in a
    file:line citation."""
    pkg = os.path.join(REPO, "qcqp_tpu_torch")
    src = os.path.realpath(tnative._SRC)
    assert src.startswith(os.path.realpath(pkg) + os.sep)
    assert os.path.exists(src)
    files = sorted(glob.glob(os.path.join(pkg, "**", "*.py"),
                             recursive=True))
    files += [os.path.join(REPO, "chip_smoke.py"),
              os.path.join(REPO, "tests", "torch_distributed_worker.py")]
    bad = [(os.path.relpath(f, REPO), line, text)
           for f in files for line, text in _non_docstring_strings(f)
           if re.search(r"qcqp_tpu(?!_torch)", _CITATION.sub("", text))]
    assert bad == []
    assert re.search(r"qcqp_tpu(?!_torch)",
                     _CITATION.sub("", "os.path.join(root, 'qcqp_tpu')"))
