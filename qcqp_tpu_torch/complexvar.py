"""Complex-variable sugar: auto-realification for beamforming-style models
(JAX counterpart: qcqp_tpu/complexvar.py, numpy only, so the same code on
the port's own expressions.py).

The reference has no complex support; its beamforming example realifies by
hand (reference: examples/secondary_user_beamforming.py:18-42 builds
x in R^{2n} and encodes |h^H x|^2 as two stacked real rows).  This module
makes that pattern first-class: a :class:`ComplexVariable` is a pair of real
variables (re, im), complex affine arithmetic tracks both parts, and the
quadratic atoms (`abs2`, `sum_abs2`, `cquad_form`) emit the exact real
quadratic expressions of the manual encoding — so everything downstream
(canonicalization, solvers, parallel restarts) is unchanged.

Supported surface:
  * ComplexVariable(shape) -> ComplexAffine with .value = re + 1j*im
  * + - neg, scaling / matmul by complex constants, conj, T, H, indexing
  * real(z), imag(z) -> real Affine
  * elementwise complex product of two affines (returns ComplexQuad)
  * abs2(z) elementwise |z|^2, sum_abs2(z) = ||z||_F^2  -> real QuadExpr
  * cquad_form(z, H) = z^H H z for Hermitian constant H -> real QuadExpr
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .expressions import (Affine, QuadExpr, Variable, _as_affine,
                          _mul_affine, square, sum_squares, quad_form)

__all__ = [
    "ComplexVariable", "ComplexAffine", "ComplexQuad",
    "real", "imag", "conj", "abs2", "sum_abs2", "cquad_form",
]


def _split_const(c) -> Tuple[np.ndarray, np.ndarray]:
    arr = np.asarray(c)
    return (np.real(arr).astype(np.float64),
            np.imag(arr).astype(np.float64))


def _as_complex(x) -> "ComplexAffine":
    if isinstance(x, ComplexAffine):
        return x
    if isinstance(x, Variable):
        a = x._affine()
        return ComplexAffine(a, _zero_like(a))
    if isinstance(x, Affine):
        return ComplexAffine(x, _zero_like(x))
    re, im = _split_const(x)
    return ComplexAffine(_as_affine(re), _as_affine(im))


def _zero_like(a: Affine) -> Affine:
    return Affine(a.shape, {}, np.zeros(a.size))


def _vcat(a: Affine, b: Affine) -> Affine:
    """Stack two same-shape affines into one flat vector [a_F; b_F]."""
    s = a.size
    coeffs = {}
    n_cols = {v: J.shape[1] for v, J in list(a.coeffs.items()) + list(b.coeffs.items())}
    for v, cols in n_cols.items():
        Ja = a.coeffs.get(v, np.zeros((s, cols)))
        Jb = b.coeffs.get(v, np.zeros((s, cols)))
        coeffs[v] = np.vstack([Ja, Jb])
    return Affine((2 * s,), coeffs, np.concatenate([a.const, b.const]))


class ComplexAffine:
    """Complex affine expression as a (real, imaginary) pair of Affines."""

    __array_ufunc__ = None
    __array_priority__ = 200

    def __init__(self, re: Affine, im: Affine):
        if re.shape != im.shape:
            raise ValueError("re/im shape mismatch")
        self.re = re
        self.im = im
        self.shape = re.shape
        self.size = re.size

    # -- arithmetic ----------------------------------------------------------
    def __add__(self, other):
        o = _as_complex(other)
        return ComplexAffine(self.re + o.re, self.im + o.im)

    __radd__ = __add__

    def __sub__(self, other):
        o = _as_complex(other)
        return ComplexAffine(self.re - o.re, self.im - o.im)

    def __rsub__(self, other):
        return (-self) + other

    def __neg__(self):
        return ComplexAffine(-self.re, -self.im)

    def _is_const(self, other) -> bool:
        return not isinstance(other, (ComplexAffine, Affine, Variable, QuadExpr))

    def __mul__(self, other):
        if self._is_const(other):
            cr, ci = _split_const(other)
            # (re + i im)(cr + i ci), elementwise constants (always
            # elementwise — _scale, never the CVXPY-0.4 2-D '*'-as-matmul)
            return ComplexAffine(self.re._scale(cr) - self.im._scale(ci),
                                 self.re._scale(ci) + self.im._scale(cr))
        o = _as_complex(other)
        # (a + ib)(c + id) = (ac - bd) + i(ad + bc), elementwise quadratics
        return ComplexQuad(
            _mul_affine(self.re, o.re) - _mul_affine(self.im, o.im),
            _mul_affine(self.re, o.im) + _mul_affine(self.im, o.re))

    __rmul__ = __mul__

    def __truediv__(self, other):
        arr = np.asarray(other)
        return self.__mul__(np.conj(arr) / np.abs(arr) ** 2)

    def __matmul__(self, other):
        """self @ B for constant complex B."""
        if not self._is_const(other):
            raise ValueError("complex @ non-constant is not affine")
        Br, Bi = _split_const(other)
        return ComplexAffine(self.re @ Br - self.im @ Bi,
                             self.re @ Bi + self.im @ Br)

    def __rmatmul__(self, other):
        Ar, Ai = _split_const(other)
        return ComplexAffine(
            Ar @ self.re - Ai @ self.im,
            Ai @ self.re + Ar @ self.im)

    # -- structure -----------------------------------------------------------
    def __getitem__(self, key):
        return ComplexAffine(self.re[key], self.im[key])

    @property
    def T(self) -> "ComplexAffine":
        return ComplexAffine(self.re.T, self.im.T)

    @property
    def H(self) -> "ComplexAffine":
        return ComplexAffine(self.re.T, -self.im.T)

    def conj(self) -> "ComplexAffine":
        return ComplexAffine(self.re, -self.im)

    def __eq__(self, other):
        """Complex equality splits into the two real equalities."""
        o = _as_complex(other)
        return [self.re == o.re, self.im == o.im]

    def __hash__(self):
        return id(self)


class ComplexQuad:
    """Complex quadratic expression (re, im) — products of complex affines."""

    __array_ufunc__ = None
    __array_priority__ = 200

    def __init__(self, re: QuadExpr, im: QuadExpr):
        self.re = re
        self.im = im
        self.shape = re.shape

    def __add__(self, other):
        if isinstance(other, ComplexQuad):
            return ComplexQuad(self.re + other.re, self.im + other.im)
        o = _as_complex(other)
        return ComplexQuad(self.re + o.re, self.im + o.im)

    __radd__ = __add__

    def __sub__(self, other):
        return self + (-other if isinstance(other, (ComplexQuad, ComplexAffine))
                       else -np.asarray(other))

    def __neg__(self):
        return ComplexQuad(-self.re, -self.im)

    def __hash__(self):
        return id(self)


class ComplexVariable(ComplexAffine):
    """A complex variable: two real Variables stacked as (re, im).

    `.value` mirrors the real Variable round-trip: after `suggest`/`improve`
    write back the real parts, `.value` reassembles the complex array.
    """

    def __init__(self, *shape, name: Optional[str] = None):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        name = name or f"cvar{Variable._counter[0] + 1}"
        self.re_var = Variable(*shape, name=f"{name}.re")
        self.im_var = Variable(*shape, name=f"{name}.im")
        self.name = name
        super().__init__(self.re_var._affine(), self.im_var._affine())

    @property
    def value(self) -> Optional[np.ndarray]:
        if self.re_var.value is None or self.im_var.value is None:
            return None
        return np.asarray(self.re_var.value) + 1j * np.asarray(self.im_var.value)

    @value.setter
    def value(self, v):
        if v is None:
            self.re_var.value = None
            self.im_var.value = None
        else:
            arr = np.asarray(v)
            self.re_var.value = np.real(arr).astype(np.float64)
            self.im_var.value = np.imag(arr).astype(np.float64)


# ---------------------------------------------------------------------------
# Atoms
# ---------------------------------------------------------------------------

def real(z) -> Affine:
    return _as_complex(z).re


def imag(z) -> Affine:
    return _as_complex(z).im


def conj(z) -> ComplexAffine:
    return _as_complex(z).conj()


def abs2(z) -> QuadExpr:
    """Elementwise squared modulus |z|^2 = re^2 + im^2 (real quadratic)."""
    z = _as_complex(z)
    return square(z.re) + square(z.im)


def sum_abs2(z) -> QuadExpr:
    """||z||_F^2 — the complex sum_squares."""
    z = _as_complex(z)
    return sum_squares(z.re) + sum_squares(z.im)


def cquad_form(z, H) -> QuadExpr:
    """z^H H z for constant Hermitian H (real-valued quadratic).

    Realification: with z = u + iv and H = A + iB (A symmetric, B
    antisymmetric), z^H H z = [u; v]^T [[A, -B], [B, A]] [u; v].
    """
    z = _as_complex(z)
    A, B = _split_const(H)
    if not np.allclose(A, A.T) or not np.allclose(B, -B.T):
        raise ValueError("cquad_form requires Hermitian H")
    W = np.block([[A, -B], [B, A]])
    return quad_form(_vcat(z.re, z.im), W)
