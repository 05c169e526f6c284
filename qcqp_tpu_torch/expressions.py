"""Lightweight quadratic modeling language + canonicalizer
(JAX counterpart: qcqp_tpu/expressions.py; the modeling layer is numpy
throughout, so it is the same code apart from `canonicalize`, which builds
the port's torch QCQPForm on a chosen device and dtype).

Replaces the reference's dependency on CVXPY 0.4's AST and the CVXcanon C++
``QuadCoeffExtractor`` (reference: qcqp/utilities.py:29,318-347) with a small
self-contained expression system that supports exactly the quadratic atom set
the reference documents (reference: README.md "Quadratic expressions" list):

    affine ops, (affine)*(affine), power(affine, 2), square(affine),
    sum_squares(affine), quad_over_lin(affine, const),
    matrix_frac(affine, const), quad_form(affine, const),
    plus affine transformations of quadratics and sum_entries/mul_elemwise.

Canonicalization emits the stacked dense tensors of :class:`qcqp_tpu_torch.core.QCQPForm`
ready for device residence — there is no sparse-matrix or CVXPY layer anywhere.

Conventions matching the reference:
  * variables are flattened column-major ('F'), in order of first appearance
    (reference: qcqp/utilities.py:290-316).
  * vector/matrix constraints are split elementwise into scalar quadratic
    constraints, column-major (reference: qcqp/utilities.py:341-345).
  * maximize objectives are negated into minimize form at canonicalization
    (reference: qcqp/utilities.py:335-336).

Canonicalization is host-side numpy (float64) — it runs once per problem; all
iterative work happens on device via the solvers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .core import default_device, default_dtype, make_form

__all__ = [
    "Variable", "Problem", "Minimize", "Maximize", "Constraint",
    "square", "sum_squares", "quad_form", "power", "quad_over_lin",
    "matrix_frac", "sum_entries", "mul_elemwise", "reshape", "VarLayout",
]


def _size(shape: Tuple[int, ...]) -> int:
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def _fidx(shape: Tuple[int, ...]) -> np.ndarray:
    """Element-index array of `shape` in column-major element order."""
    return np.arange(_size(shape)).reshape(shape, order="F")


def _broadcast_rows(shape_from, shape_to) -> np.ndarray:
    """Row mapping that broadcasts a flattened ('F') expr into a larger shape."""
    idx = np.broadcast_to(_fidx(shape_from), shape_to)
    return np.asarray(idx).ravel(order="F")


class Variable:
    """Optimization variable of arbitrary (<=2-D) shape.

    The `.value` attribute mirrors the reference's CVXPY variable value
    round-trip (reference: qcqp/utilities.py:298-316).
    """

    _counter = [0]
    # Make numpy defer binary ops to our reflected methods (A @ x, A * x).
    __array_ufunc__ = None
    __array_priority__ = 100

    def __init__(self, *shape, name: Optional[str] = None):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        self.shape = tuple(int(s) for s in shape)
        self.size = _size(self.shape)
        Variable._counter[0] += 1
        self.id = Variable._counter[0]
        self.name = name or f"var{self.id}"
        self.value: Optional[np.ndarray] = None

    # Expression protocol: a Variable promotes to an identity Affine.
    def _affine(self) -> "Affine":
        return Affine(self.shape, {self: np.eye(self.size)}, np.zeros(self.size))

    def __repr__(self):
        return f"Variable({self.shape}, name={self.name!r})"

    # Arithmetic just defers to the Affine form.
    def __add__(self, o): return self._affine() + o
    def __radd__(self, o): return self._affine().__radd__(o)
    def __sub__(self, o): return self._affine() - o
    def __rsub__(self, o): return self._affine().__rsub__(o)
    def __neg__(self): return -self._affine()
    def __mul__(self, o): return self._affine() * o
    def __rmul__(self, o): return self._affine().__rmul__(o)
    def __truediv__(self, o): return self._affine() / o
    def __matmul__(self, o): return self._affine() @ o
    def __rmatmul__(self, o): return self._affine().__rmatmul__(o)
    def __getitem__(self, key): return self._affine()[key]
    def __le__(self, o): return self._affine() <= o
    def __ge__(self, o): return self._affine() >= o
    def __eq__(self, o): return self._affine() == o
    def __hash__(self):  # needed since __eq__ builds constraints
        return id(self)

    @property
    def T(self): return self._affine().T


def _as_affine(x) -> "Affine":
    if isinstance(x, Affine):
        return x
    if isinstance(x, Variable):
        return x._affine()
    arr = np.asarray(x, dtype=np.float64)
    return Affine(arr.shape, {}, arr.ravel(order="F"))


def _is_constant(x) -> bool:
    return not isinstance(x, (Affine, Variable, QuadExpr))


class Affine:
    """Affine expression: per-variable Jacobians + constant, rows in 'F' order."""

    __array_ufunc__ = None
    __array_priority__ = 100

    def __init__(self, shape, coeffs: Dict[Variable, np.ndarray], const: np.ndarray):
        self.shape = tuple(shape)
        self.size = _size(self.shape)
        self.coeffs = coeffs  # var -> (size, var.size)
        self.const = np.asarray(const, dtype=np.float64).reshape(self.size)

    # -- structural ops -----------------------------------------------------
    def _map_rows(self, rows: np.ndarray, new_shape) -> "Affine":
        coeffs = {v: J[rows] for v, J in self.coeffs.items()}
        return Affine(new_shape, coeffs, self.const[rows])

    def broadcast_to(self, shape) -> "Affine":
        if tuple(shape) == self.shape:
            return self
        return self._map_rows(_broadcast_rows(self.shape, shape), shape)

    def __getitem__(self, key) -> "Affine":
        rows = _fidx(self.shape)[key]
        new_shape = np.shape(rows)
        return self._map_rows(np.asarray(rows).ravel(order="F"), new_shape)

    @property
    def T(self) -> "Affine":
        if len(self.shape) < 2:
            return self
        rows = _fidx(self.shape).T
        return self._map_rows(rows.ravel(order="F"), rows.shape)

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, QuadExpr):
            return other + self
        other = _as_affine(other)
        shape = np.broadcast_shapes(self.shape, other.shape)
        a, b = self.broadcast_to(shape), other.broadcast_to(shape)
        coeffs = dict(a.coeffs)
        for v, J in b.coeffs.items():
            coeffs[v] = coeffs.get(v, 0) + J
        return Affine(shape, coeffs, a.const + b.const)

    __radd__ = __add__

    def __sub__(self, other): return self + (-_as_quad_or_affine(other))
    def __rsub__(self, other): return (-self) + other
    def __neg__(self):
        return Affine(self.shape, {v: -J for v, J in self.coeffs.items()}, -self.const)

    def _scale(self, c) -> "Affine":
        """Elementwise multiply by a constant scalar/array (with broadcasting)."""
        c = np.asarray(c, dtype=np.float64)
        shape = np.broadcast_shapes(self.shape, c.shape)
        a = self.broadcast_to(shape)
        w = np.broadcast_to(c, shape).ravel(order="F")
        coeffs = {v: J * w[:, None] for v, J in a.coeffs.items()}
        return Affine(shape, coeffs, a.const * w)

    def __mul__(self, other):
        if _is_constant(other):
            other_arr = np.asarray(other, dtype=np.float64)
            # CVXPY-0.4-style '*': matrix multiply for 2-D constants,
            # scalar/elementwise multiply otherwise.
            if other_arr.ndim == 2 and len(self.shape) >= 1 and self.size > 1:
                return self.__matmul__(other_arr)
            return self._scale(other_arr)
        # (affine) * (affine) -> quadratic
        return _mul_affine(self, _as_affine(other))

    def __rmul__(self, other):
        if _is_constant(other):
            other_arr = np.asarray(other, dtype=np.float64)
            if other_arr.ndim == 2 and len(self.shape) >= 1 and self.size > 1:
                return self.__rmatmul__(other_arr)
            return self._scale(other_arr)
        return _mul_affine(_as_affine(other), self)

    def __truediv__(self, other):
        return self._scale(1.0 / np.asarray(other, dtype=np.float64))

    def __matmul__(self, other):
        """self @ B with B constant."""
        if not _is_constant(other):
            return _mul_affine(self, _as_affine(other))
        B = np.asarray(other, dtype=np.float64)
        return _matmul_const(self, B, left=False)

    def __rmatmul__(self, other):
        A = np.asarray(other, dtype=np.float64)
        return _matmul_const(self, A, left=True)

    # -- constraints ---------------------------------------------------------
    def __le__(self, other): return Constraint(self - other, "<=")
    def __ge__(self, other): return Constraint(_as_quad_or_affine(other) - self, "<=")
    def __eq__(self, other): return Constraint(self - other, "==")
    def __hash__(self): return id(self)

    def is_quadratic(self) -> bool:
        return True

    # -- canonical coefficients ----------------------------------------------
    def dense_C(self, layout: "VarLayout") -> np.ndarray:
        C = np.zeros((self.size, layout.n))
        for v, J in self.coeffs.items():
            off = layout.offset[v]
            C[:, off:off + v.size] += J
        return C


def _matmul_const(a: Affine, B: np.ndarray, left: bool) -> Affine:
    """Constant matrix multiply of an affine expression (a @ B or B @ a).

    Builds the linear operator L with out_flatF = L @ a_flatF by pushing a
    one-hot basis through the contraction, so arbitrary dims/orders work.
    """
    sel = np.eye(a.size)[_fidx(a.shape)]  # a.shape + (a.size,): one-hot rows
    if left:
        # B @ a: contract B's last axis with a's first axis.
        out = np.tensordot(B, sel, axes=(B.ndim - 1, 0))
        # out shape: B.shape[:-1] + a.shape[1:] + (a.size,)
    else:
        # a @ B: contract a's last shape axis with B's first axis.
        out = np.tensordot(sel, B, axes=(len(a.shape) - 1, 0))
        # out shape: a.shape[:-1] + (a.size,) + B.shape[1:]; move size to end
        out = np.moveaxis(out, len(a.shape) - 1, -1)
    new_shape = out.shape[:-1]
    # Rows of out (C-ordered over new_shape) -> Fortran element order.
    flatC = out.reshape(-1, a.size)
    Lf = np.empty_like(flatC)
    Lf[_fidx(new_shape).ravel(order="C")] = flatC
    coeffs = {v: Lf @ J for v, J in a.coeffs.items()}
    return Affine(new_shape, coeffs, Lf @ a.const)


def _as_quad_or_affine(x):
    if isinstance(x, QuadExpr):
        return x
    return _as_affine(x)


# ---------------------------------------------------------------------------
# Quadratic atoms and expressions
# ---------------------------------------------------------------------------

class QuadAtom:
    """A pure quadratic atom with its own shape; emits per-element (P, q, r)."""
    shape: Tuple[int, ...]

    @property
    def size(self):
        return _size(self.shape)

    def coeffs(self, layout: "VarLayout"):
        raise NotImplementedError

    def variables(self) -> List[Variable]:
        raise NotImplementedError


class SquareAtom(QuadAtom):
    """square(affine): elementwise (reference atom: square/power(.,2))."""

    def __init__(self, arg: Affine):
        self.arg = arg
        self.shape = arg.shape

    def variables(self):
        return list(self.arg.coeffs.keys())

    def coeffs(self, layout):
        from . import native
        C = self.arg.dense_C(layout)   # (s, n)
        d = self.arg.const             # (s,)
        s, n = C.shape
        P = np.zeros((s, n, n))
        q = np.zeros((s, n))
        r = np.zeros(s)
        native.square_accumulate(C, d, 1.0, P, q, r)
        return P, q, r


class GramAtom(QuadAtom):
    """(Cx+d)^T W (Cx+d) for constant symmetric W: covers sum_squares (W=I),
    quad_form, matrix_frac (W = S^{-1}), quad_over_lin (W = I/c).  Scalar shape.
    """

    def __init__(self, arg: Affine, W: Optional[np.ndarray] = None):
        self.arg = arg
        if W is not None:
            W = np.asarray(W, dtype=np.float64)
            W = 0.5 * (W + W.T)
        self.W = W
        self.shape = ()

    def variables(self):
        return list(self.arg.coeffs.keys())

    def coeffs(self, layout):
        C = self.arg.dense_C(layout)
        d = self.arg.const
        if self.W is None:
            WC, Wd = C, d
        else:
            WC, Wd = self.W @ C, self.W @ d
        P = C.T @ WC
        P = 0.5 * (P + P.T)
        q = 2.0 * (C.T @ Wd)
        r = float(d @ Wd)
        return P[None], q[None], np.array([r])


class MulAtom(QuadAtom):
    """(affine) * (affine), elementwise with broadcasting."""

    def __init__(self, a: Affine, b: Affine):
        shape = np.broadcast_shapes(a.shape, b.shape)
        self.a = a.broadcast_to(shape)
        self.b = b.broadcast_to(shape)
        self.shape = shape

    def variables(self):
        return list(self.a.coeffs.keys()) + list(self.b.coeffs.keys())

    def coeffs(self, layout):
        from . import native
        Ca, da = self.a.dense_C(layout), self.a.const
        Cb, db = self.b.dense_C(layout), self.b.const
        s, n = Ca.shape
        P = np.zeros((s, n, n))
        q = np.zeros((s, n))
        r = np.zeros(s)
        native.mul_accumulate(Ca, da, Cb, db, 1.0, P, q, r)
        return P, q, r


def _mul_affine(a: Affine, b: Affine) -> "QuadExpr":
    atom = MulAtom(a, b)
    s = atom.size
    return QuadExpr(atom.shape, [(np.eye(s), atom)], _zero_affine(atom.shape))


def _zero_affine(shape) -> Affine:
    return Affine(shape, {}, np.zeros(_size(shape)))


class QuadExpr:
    """Quadratic expression: sum of linearly-mapped atoms + an affine part.

    Each term is (Wmat, atom): out_elements += Wmat @ atom_elements, which
    uniformly encodes elementwise scaling (diagonal Wmat), scalar-atom
    broadcast (column Wmat) and sum_entries (row-sum composition).
    """

    __array_ufunc__ = None
    __array_priority__ = 100

    def __init__(self, shape, terms: List[Tuple[np.ndarray, QuadAtom]], affine: Affine):
        self.shape = tuple(shape)
        self.size = _size(self.shape)
        self.terms = terms
        self.affine = affine

    def is_quadratic(self):
        return True

    def broadcast_to(self, shape) -> "QuadExpr":
        if tuple(shape) == self.shape:
            return self
        rows = _broadcast_rows(self.shape, shape)
        terms = [(W[rows], atom) for W, atom in self.terms]
        return QuadExpr(shape, terms, self.affine.broadcast_to(shape))

    def __getitem__(self, key) -> "QuadExpr":
        rows_arr = _fidx(self.shape)[key]
        new_shape = np.shape(rows_arr)
        rows = np.asarray(rows_arr).ravel(order="F")
        terms = [(W[rows], atom) for W, atom in self.terms]
        return QuadExpr(new_shape, terms, self.affine._map_rows(rows, new_shape))

    def __add__(self, other):
        other = _as_quad_or_affine(other)
        if isinstance(other, Affine):
            other = QuadExpr(other.shape, [], other)
        shape = np.broadcast_shapes(self.shape, other.shape)
        a, b = self.broadcast_to(shape), other.broadcast_to(shape)
        return QuadExpr(shape, a.terms + b.terms, a.affine + b.affine)

    __radd__ = __add__

    def __sub__(self, other): return self + (-_as_quad_or_affine(other))
    def __rsub__(self, other): return (-self) + other

    def __neg__(self):
        return QuadExpr(self.shape, [(-W, a) for W, a in self.terms], -self.affine)

    def _scale(self, c) -> "QuadExpr":
        c = np.asarray(c, dtype=np.float64)
        shape = np.broadcast_shapes(self.shape, c.shape)
        a = self.broadcast_to(shape)
        w = np.broadcast_to(c, shape).ravel(order="F")
        terms = [(w[:, None] * W, atom) for W, atom in a.terms]
        return QuadExpr(shape, terms, a.affine._scale(c))

    def __mul__(self, other):
        if _is_constant(other):
            return self._scale(other)
        raise ValueError("product of quadratic and non-constant is not quadratic")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._scale(1.0 / np.asarray(other, dtype=np.float64))

    def __le__(self, other): return Constraint(self - other, "<=")
    def __ge__(self, other): return Constraint(_as_quad_or_affine(other) - self, "<=")
    def __eq__(self, other): return Constraint(self - other, "==")
    def __hash__(self): return id(self)

    def variables(self) -> List[Variable]:
        vs = list(self.affine.coeffs.keys())
        for _, atom in self.terms:
            vs += atom.variables()
        return vs

    def coeffs(self, layout: "VarLayout"):
        """Per-element (P (s,n,n), q (s,n), r (s,)) canonical tensors."""
        n = layout.n
        P = np.zeros((self.size, n, n))
        q = np.zeros((self.size, n))
        r = np.zeros(self.size)
        for W, atom in self.terms:
            Pa, qa, ra = atom.coeffs(layout)
            P += np.einsum("os,sij->oij", W, Pa)
            q += W @ qa
            r += W @ ra
        q += self.affine.dense_C(layout)
        r += self.affine.const
        return P, q, r


# ---------------------------------------------------------------------------
# Public atom constructors (the reference's documented quadratic atom set)
# ---------------------------------------------------------------------------

def _atom_expr(atom: QuadAtom) -> QuadExpr:
    s = atom.size
    return QuadExpr(atom.shape, [(np.eye(s), atom)], _zero_affine(atom.shape))


def square(x) -> QuadExpr:
    return _atom_expr(SquareAtom(_as_affine(x)))


def power(x, p) -> QuadExpr:
    if p != 2:
        raise ValueError("only power(affine, 2) is quadratic")
    return square(x)


def sum_squares(x) -> QuadExpr:
    return _atom_expr(GramAtom(_as_affine(x)))


def quad_form(x, W) -> QuadExpr:
    return _atom_expr(GramAtom(_as_affine(x), np.asarray(W)))


def quad_over_lin(x, c) -> QuadExpr:
    c = float(c)
    return _atom_expr(GramAtom(_as_affine(x))) * (1.0 / c)


def matrix_frac(x, S) -> QuadExpr:
    Sinv = np.linalg.inv(np.asarray(S, dtype=np.float64))
    return _atom_expr(GramAtom(_as_affine(x), Sinv))


def sum_entries(x) -> Union[QuadExpr, Affine]:
    x = _as_quad_or_affine(x)
    if isinstance(x, Affine):
        ones = np.ones((1, x.size))
        coeffs = {v: ones @ J for v, J in x.coeffs.items()}
        return Affine((), coeffs, ones @ x.const)
    ones = np.ones((1, x.size))
    terms = [(ones @ W, atom) for W, atom in x.terms]
    return QuadExpr((), terms, sum_entries(x.affine))


def mul_elemwise(c, x):
    x = _as_quad_or_affine(x)
    return x._scale(np.asarray(c, dtype=np.float64))


def reshape(x, shape):
    x = _as_quad_or_affine(x)
    shape = tuple(int(s) for s in shape)
    if _size(shape) != x.size:
        raise ValueError("reshape size mismatch")
    if isinstance(x, Affine):
        return Affine(shape, x.coeffs, x.const)
    return QuadExpr(shape, x.terms, Affine(shape, x.affine.coeffs, x.affine.const))


# ---------------------------------------------------------------------------
# Constraints, objectives, problems
# ---------------------------------------------------------------------------

class Constraint:
    """Scalar-splittable quadratic constraint `expr <= 0` or `expr == 0`."""

    def __init__(self, expr, op: str):
        assert op in ("<=", "==")
        self.expr = _as_quad_or_affine(expr)
        self.op = op

    def variables(self):
        e = self.expr
        return e.variables() if isinstance(e, QuadExpr) else list(e.coeffs.keys())

    def __repr__(self):
        return f"Constraint({self.expr.shape} {self.op} 0)"


class Minimize:
    NAME = "minimize"

    def __init__(self, expr):
        self.expr = _as_quad_or_affine(expr)
        if _size(self.expr.shape) != 1:
            raise ValueError("objective must be scalar")


class Maximize(Minimize):
    NAME = "maximize"


class VarLayout:
    """Flat offsets for each variable, column-major within a variable.

    (reference: get_id_map/assign_vars/flatten_vars, qcqp/utilities.py:290-316)
    """

    def __init__(self, variables: Sequence[Variable]):
        self.variables = list(variables)
        self.offset: Dict[Variable, int] = {}
        n = 0
        for v in self.variables:
            self.offset[v] = n
            n += v.size
        self.n = n

    def assign(self, x: Optional[np.ndarray]):
        for v in self.variables:
            off = self.offset[v]
            if x is None:
                v.value = np.full(v.shape, np.nan)
            else:
                vals = np.asarray(x)[off:off + v.size]
                v.value = np.reshape(vals, v.shape, order="F") if v.shape else float(vals[0])

    def flatten(self) -> np.ndarray:
        out = np.empty(self.n)
        for v in self.variables:
            off = self.offset[v]
            if v.value is None:
                raise ValueError(f"variable {v.name} has no value")
            out[off:off + v.size] = np.ravel(v.value, order="F")
        return out


class Problem:
    """A quadratic problem: objective + list of quadratic constraints."""

    def __init__(self, objective: Minimize, constraints: Sequence = ()):
        if not isinstance(objective, Minimize):
            raise ValueError("objective must be Minimize(...) or Maximize(...)")
        self.objective = objective
        # Flatten nested lists: complex equalities (complexvar.ComplexAffine
        # __eq__) expand to [re ==, im ==] pairs.
        self.constraints: List[Constraint] = []
        stack = list(constraints)[::-1]
        while stack:
            c = stack.pop()
            if isinstance(c, (list, tuple)):
                stack.extend(list(c)[::-1])
            elif isinstance(c, Constraint):
                self.constraints.append(c)
            else:
                raise ValueError(f"not a constraint: {c!r}")

    def variables(self) -> List[Variable]:
        seen, out = set(), []
        sources = [self.objective.expr] + [c.expr for c in self.constraints]
        for e in sources:
            vs = e.variables() if isinstance(e, QuadExpr) else list(e.coeffs.keys())
            for v in vs:
                if v.id not in seen:
                    seen.add(v.id)
                    out.append(v)
        return out

    def is_dcp(self) -> bool:
        """Cheap convexity check used only to emit the reference's
        already-convex warning (reference: qcqp/utilities.py:326-327).
        Runs entirely host-side — no device arrays, no transfers."""
        try:
            P, q, r, eqs, _, _ = _canonicalize_arrays(self, np.float64)
        except ValueError:
            return False
        is_eq = eqs
        def psd(M):
            return np.all(np.linalg.eigvalsh(M) > -1e-9)
        if not psd(P[0]):
            return False
        for i in range(1, P.shape[0]):
            if is_eq[i - 1]:
                if np.abs(P[i]).max() > 1e-12:
                    return False
            elif not psd(P[i]):
                return False
        return True


def canonicalize(prob: Problem, dtype=None, device=None):
    """Problem -> (QCQPForm, VarLayout, maximize_flag).

    The analog of get_qcqp_form (reference: qcqp/utilities.py:318-347):
    instead of a list of sparse QuadraticFunctions it emits one stacked dense
    tensor batch on `device` (default: core.default_device(), the current
    CUDA device).  `dtype` is a numpy dtype (the host arrays are cast to it
    before symmetrization, as in the JAX package) or a torch dtype of the
    same precision; by default float64 on the CPU and float32 on CUDA
    (core.default_dtype).
    """
    device = default_device(device)
    np_dtype = _np_dtype(default_dtype(device) if dtype is None else dtype)
    P, q, r, eqs, layout, maximize = _canonicalize_arrays(prob, np_dtype)
    form = make_form(P, q, r, eqs, device=device,
                     dtype=torch.float64 if np_dtype == np.float64
                     else torch.float32)
    return form, layout, maximize


def _np_dtype(dtype):
    if dtype in (torch.float64, np.float64):
        return np.float64
    if dtype in (torch.float32, np.float32):
        return np.float32
    raise ValueError(f"unsupported dtype {dtype}")


def _canonicalize_arrays(prob: Problem, dtype):
    """Host-side canonicalization to stacked numpy tensors."""
    layout = VarLayout(prob.variables())
    n = layout.n

    obj = prob.objective.expr
    if isinstance(obj, Affine):
        obj = QuadExpr(obj.shape, [], obj)
    P0, q0, r0 = obj.coeffs(layout)
    P0, q0, r0 = P0[0], q0[0], r0[0]
    maximize = prob.objective.NAME == "maximize"
    if maximize:
        P0, q0, r0 = -P0, -q0, -r0

    Ps, qs, rs, eqs = [P0], [q0], [r0], []
    for con in prob.constraints:
        e = con.expr
        if isinstance(e, Affine):
            e = QuadExpr(e.shape, [], e)
        Pc, qc, rc = e.coeffs(layout)
        for i in range(e.size):
            Ps.append(Pc[i]); qs.append(qc[i]); rs.append(rc[i])
            eqs.append(con.op == "==")

    P = np.stack(Ps).astype(dtype)
    P = 0.5 * (P + np.swapaxes(P, -1, -2))
    q = np.stack(qs).astype(dtype)
    r = np.asarray(rs, dtype=dtype)
    return P, q, r, np.asarray(eqs, dtype=bool), layout, maximize
