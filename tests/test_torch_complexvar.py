"""qcqp_tpu_torch's complex-variable sugar against qcqp_tpu's: the tests of
tests/test_complexvar.py on the port, and for each model the port's
canonical (P, q, r, is_eq) equal to the JAX package's to 1e-12 (both are
numpy up to the form; the port builds it on the CPU in float64).  The
handler's complex least squares runs end to end as in the JAX test."""

import numpy as np
import pytest
import torch

import qcqp_tpu as jqt
from qcqp_tpu.expressions import canonicalize as jax_canonicalize

import qcqp_tpu_torch as tqt
from qcqp_tpu_torch import core
from qcqp_tpu_torch.expressions import canonicalize

torch.set_num_threads(1)


def _canon(prob):
    return canonicalize(prob, np.float64, "cpu")


def _same_form(build):
    """The two packages' canonical forms of build(package) agree to
    1e-12; returns the port's problem and (form, layout)."""
    tprob = build(tqt)
    jf = jax_canonicalize(build(jqt), np.float64)[0]
    tf, layout, _ = _canon(tprob)
    for name in ("P", "q", "r"):
        np.testing.assert_allclose(getattr(tf, name).numpy(),
                                   np.asarray(getattr(jf, name)),
                                   rtol=0, atol=1e-12)
    np.testing.assert_array_equal(tf.is_eq.numpy(), np.asarray(jf.is_eq))
    return tprob, tf, layout


def _vals(form, xflat):
    return core.eval_all(form, torch.from_numpy(xflat)).numpy()


def test_abs2_of_hermitian_inner_product():
    rng = np.random.default_rng(0)
    n = 6
    h = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    zv = rng.standard_normal(n) + 1j * rng.standard_normal(n)

    def build(qt):
        return qt.Problem(qt.Minimize(qt.abs2(np.conj(h) @
                                              qt.ComplexVariable(n))))
    _, form, _ = _same_form(build)
    vals = _vals(form, np.concatenate([zv.real, zv.imag]))
    np.testing.assert_allclose(vals[0], abs(np.vdot(h, zv)) ** 2,
                               rtol=1e-10)


def test_sum_abs2_matches_norm():
    rng = np.random.default_rng(1)
    n, m = 5, 3
    A = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    zv = rng.standard_normal(n) + 1j * rng.standard_normal(n)

    def build(qt):
        return qt.Problem(qt.Minimize(qt.sum_abs2(
            A @ qt.ComplexVariable(n) - b)))
    _, form, _ = _same_form(build)
    vals = _vals(form, np.concatenate([zv.real, zv.imag]))
    np.testing.assert_allclose(vals[0], np.linalg.norm(A @ zv - b) ** 2,
                               rtol=1e-10)


def test_cquad_form_hermitian():
    rng = np.random.default_rng(2)
    n = 4
    M = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = M + M.conj().T   # Hermitian
    zv = rng.standard_normal(n) + 1j * rng.standard_normal(n)

    def build(qt):
        return qt.Problem(qt.Minimize(qt.cquad_form(qt.ComplexVariable(n),
                                                    H)))
    _, form, _ = _same_form(build)
    vals = _vals(form, np.concatenate([zv.real, zv.imag]))
    np.testing.assert_allclose(vals[0], np.real(zv.conj() @ H @ zv),
                               rtol=1e-9)
    with pytest.raises(ValueError):
        tqt.cquad_form(tqt.ComplexVariable(n), M)  # non-Hermitian


def test_complex_equality_splits_and_value_roundtrip():
    rng = np.random.default_rng(3)
    n = 3
    c = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    zs = {}

    def build(qt):
        z = zs[qt] = qt.ComplexVariable(n)
        return qt.Problem(qt.Minimize(qt.sum_abs2(z)), [z == c])
    _, form, layout = _same_form(build)
    assert form.m == 2 * n     # re and im rows
    xflat = np.concatenate([c.real, c.imag])
    np.testing.assert_allclose(_vals(form, xflat)[1:], 0.0, atol=1e-12)
    z = zs[tqt]
    layout.assign(xflat)
    np.testing.assert_allclose(z.value, c, rtol=1e-12)
    z.value = 2 * c
    np.testing.assert_allclose(z.re_var.value, 2 * c.real)


def test_complex_times_complex_elementwise():
    rng = np.random.default_rng(4)
    n = 3
    zv = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    wv = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    zw = {}

    def build(qt):
        z, w = qt.ComplexVariable(n), qt.ComplexVariable(n)
        zw[qt] = (z, w)
        # real part of z * conj(w), summed: a real quadratic
        return qt.Problem(qt.Minimize(qt.sum_entries((z * w.conj()).re)))
    _, form, layout = _same_form(build)
    z, w = zw[tqt]
    xflat = np.zeros(layout.n)
    for var, val in [(z.re_var, zv.real), (z.im_var, zv.imag),
                     (w.re_var, wv.real), (w.im_var, wv.imag)]:
        off = layout.offset[var]
        xflat[off:off + var.size] = val
    np.testing.assert_allclose(_vals(form, xflat)[0],
                               np.sum((zv * wv.conj()).real), rtol=1e-10)


def test_beamforming_sugar_matches_manual_realification():
    """tests/test_complexvar.py:120-156 on the port: the sugar and the
    hand realification give the same form, and both equal the JAX
    package's."""
    rng = np.random.default_rng(5)
    n, m, l = 4, 3, 2
    tau, eta = 20.0, 2.0
    H = (rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))) \
        / np.sqrt(2)
    G = (rng.standard_normal((l, n)) + 1j * rng.standard_normal((l, n))) \
        / np.sqrt(2)

    def sugar(qt):
        z = qt.ComplexVariable(n)
        cons = [qt.abs2(np.conj(H[i]) @ z) >= tau for i in range(m)]
        cons += [qt.abs2(np.conj(G[i]) @ z) <= eta for i in range(l)]
        return qt.Problem(qt.Minimize(qt.sum_abs2(z)), cons)

    def manual(qt):
        x = qt.Variable(2 * n)

        def rows(h):
            return (np.concatenate([h.real, h.imag]),
                    np.concatenate([-h.imag, h.real]))
        cons = []
        for i in range(m):
            hr, hi = rows(H[i])
            cons.append(qt.square(hr @ x) + qt.square(hi @ x) >= tau)
        for i in range(l):
            gr, gi = rows(G[i])
            cons.append(qt.square(gr @ x) + qt.square(gi @ x) <= eta)
        return qt.Problem(qt.Minimize(qt.sum_squares(x)), cons)

    _, fs, _ = _same_form(sugar)
    _, fm, _ = _same_form(manual)
    for name in ("P", "q", "r"):
        np.testing.assert_allclose(getattr(fs, name).numpy(),
                                   getattr(fm, name).numpy(), atol=1e-12)
    assert torch.equal(fs.is_eq, fm.is_eq)


def test_complex_solve_end_to_end():
    """Unconstrained complex LS solved by the port's handler lands on the
    LS optimum."""
    rng = np.random.default_rng(6)
    n, m = 3, 5
    A = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    b = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    zs = {}

    def build(qt):
        z = zs[qt] = qt.ComplexVariable(n)
        return qt.Problem(qt.Minimize(qt.sum_abs2(A @ z - b)))
    prob, _, _ = _same_form(build)
    qc = tqt.QCQP(prob, seed=0, device="cpu", check_dcp=False)
    qc.suggest(tqt.RANDOM)
    f, v = qc.improve(tqt.COORD_DESCENT)
    zls, *_ = np.linalg.lstsq(A, b, rcond=None)
    f_opt = np.linalg.norm(A @ zls - b) ** 2
    assert v < 1e-8
    assert f <= f_opt + 1e-4
    np.testing.assert_allclose(zs[tqt].value, zls, atol=2e-3)
