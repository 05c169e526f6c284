"""qcqp_tpu_torch.expressions against qcqp_tpu.expressions: the same problem,
built through each package's modeling layer, must canonicalize to identical
(P, q, r, is_eq) (float64, array_equal), the same layout and the same
maximize flag."""

import numpy as np
import pytest
import torch

import qcqp_tpu as jqt
from qcqp_tpu.expressions import canonicalize as jax_canonicalize

import qcqp_tpu_torch as tqt
from qcqp_tpu_torch.expressions import canonicalize as torch_canonicalize

torch.set_num_threads(1)


def boolean_ls(qt):
    n, m = 10, 15                      # examples/boolean_least_squares.py
    rs = np.random.RandomState(1)
    A = rs.randn(m, n)
    b = rs.randn(m, 1).ravel()
    x = qt.Variable(n)
    return qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                      [qt.square(x) == 1])


def maxcut(qt):
    n, p = 25, 0.2                     # examples/maxcut.py
    rs = np.random.RandomState(1)
    W = rs.uniform(low=0.0, high=1.0, size=(n, n))
    for i in range(n):
        W[i, i] = 1
        for j in range(i + 1, n):
            W[j, i] = W[i, j]
    W = (W < p).astype(float)
    x = qt.Variable(n)
    obj = 0.25 * (qt.sum_entries(W) - qt.quad_form(x, W))
    return qt.Problem(qt.Maximize(obj), [qt.square(x) == 1])


def circle_packing(qt):
    n, B = 5, 10.0                     # examples/circle_packing.py
    X = qt.Variable(2, n)
    r = qt.Variable()
    cons = [X >= r, X <= B - r, r >= 0]
    for i in range(n):
        for j in range(i + 1, n):
            cons.append(qt.square(2 * r)
                        <= qt.sum_squares(X[:, i] - X[:, j]))
    return qt.Problem(qt.Maximize(r), cons)


def large_square(qt):
    # s * n * n >= 2**16: the native square_accumulate path of both packages
    x = qt.Variable(48)
    A = np.random.default_rng(3).standard_normal((20, 48))
    return qt.Problem(qt.Minimize(qt.sum_squares(A @ x)),
                      [qt.square(x) == 1])


def large_mul(qt):
    # the native mul_accumulate path
    x = qt.Variable(48)
    y = qt.Variable(48)
    return qt.Problem(qt.Minimize(qt.sum_squares(x + y)),
                      [qt.mul_elemwise(np.ones(48), x) * (y - 1) <= 2])


# tests/test_expressions.py cases
def affine_simple(qt):
    rng = np.random.default_rng(0)
    A, b = rng.standard_normal((3, 4)), rng.standard_normal(3)
    x = qt.Variable(4)
    return qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)))


def square_split(qt):
    x = qt.Variable(3)
    return qt.Problem(qt.Minimize(qt.sum_squares(x)), [qt.square(x) == 1])


def maximize_quad_form(qt):
    x = qt.Variable(2)
    W = np.array([[2.0, 0.5], [0.5, 1.0]])
    return qt.Problem(qt.Maximize(qt.quad_form(x, W)), [qt.square(x) <= 1])


def affine_times_affine(qt):
    x = qt.Variable(2)
    return qt.Problem(qt.Minimize((x[0] + 1) * (x[1] - 2)))


def matrix_indexing(qt):
    X = qt.Variable(2, 3)
    return qt.Problem(qt.Minimize(qt.sum_squares(X[:, 0] - X[:, 2])),
                      [X >= 0])


def sum_entries_mul(qt):
    W = np.random.default_rng(1).standard_normal((3, 3))
    x = qt.Variable(3)
    expr = 0.25 * (qt.sum_entries(np.asarray(W)) - qt.quad_form(x, W + W.T))
    return qt.Problem(qt.Maximize(expr), [qt.square(x) == 1])


def quad_over_lin(qt):
    return qt.Problem(qt.Minimize(qt.quad_over_lin(qt.Variable(3), 4.0)))


def matrix_frac(qt):
    return qt.Problem(qt.Minimize(qt.matrix_frac(qt.Variable(3),
                                                 np.eye(3) * 2.0)))


def power_sum(qt):
    return qt.Problem(qt.Minimize(qt.sum_entries(qt.power(qt.Variable(3),
                                                          2))))


def broadcast_constraints(qt):
    X = qt.Variable(2, 4)
    r = qt.Variable()
    return qt.Problem(qt.Maximize(r), [X >= r, X <= 10.0 - r, r >= 0])


def nonconvex_ge(qt):
    X = qt.Variable(2, 2)
    rr = qt.Variable()
    return qt.Problem(qt.Maximize(rr), [qt.square(2 * rr)
                                        <= qt.sum_squares(X[:, 0] - X[:, 1])])


CASES = [boolean_ls, maxcut, circle_packing, large_square, large_mul,
         affine_simple, square_split, maximize_quad_form, affine_times_affine,
         matrix_indexing, sum_entries_mul, quad_over_lin, matrix_frac,
         power_sum, broadcast_constraints, nonconvex_ge]


@pytest.mark.parametrize("build", CASES, ids=lambda f: f.__name__)
def test_canonical_form_identical(build):
    jform, jlayout, jmax = jax_canonicalize(build(jqt), np.float64)
    tform, tlayout, tmax = torch_canonicalize(build(tqt), np.float64, "cpu")
    assert tform.P.dtype == torch.float64 and tform.P.device.type == "cpu"
    for name in ("P", "q", "r", "is_eq"):
        np.testing.assert_array_equal(getattr(tform, name).numpy(),
                                      np.asarray(getattr(jform, name)),
                                      err_msg=name)
    assert tmax == jmax
    assert tlayout.n == jlayout.n
    assert [v.shape for v in tlayout.variables] == \
        [v.shape for v in jlayout.variables]


@pytest.mark.parametrize("build", [boolean_ls, circle_packing],
                         ids=lambda f: f.__name__)
def test_canonical_form_float32(build):
    """A float32 form is the float64 host arrays cast and then symmetrized
    in float32, in both packages."""
    jform = jax_canonicalize(build(jqt), np.float32)[0]
    tform = torch_canonicalize(build(tqt), torch.float32, "cpu")[0]
    assert tform.P.dtype == torch.float32
    np.testing.assert_array_equal(tform.P.numpy(), np.asarray(jform.P))
    np.testing.assert_array_equal(tform.q.numpy(), np.asarray(jform.q))


def test_layout_round_trip_and_dcp():
    X = tqt.Variable(2, 3)
    prob = tqt.Problem(tqt.Minimize(tqt.sum_squares(X[:, 0] - X[:, 2])),
                       [X >= 0])
    _, layout, _ = torch_canonicalize(prob, device="cpu")
    xflat = np.arange(6.0)
    layout.assign(xflat)
    np.testing.assert_array_equal(X.value, xflat.reshape(2, 3, order="F"))
    np.testing.assert_array_equal(layout.flatten(), xflat)
    assert prob.is_dcp() == matrix_indexing(jqt).is_dcp()
    assert boolean_ls(tqt).is_dcp() == boolean_ls(jqt).is_dcp() is False


def test_complexvar_not_ported():
    """complexvar is ported now (tests/test_torch_complexvar.py holds it
    against the JAX package): ComplexVariable is the port's own class, and
    its re and im parts canonicalize into the same form as the JAX
    package's."""
    from qcqp_tpu_torch import complexvar
    assert tqt.ComplexVariable is complexvar.ComplexVariable

    def build(qt):
        z = qt.ComplexVariable(3)
        return qt.Problem(qt.Minimize(qt.sum_abs2(z - (1 + 2j))),
                          [qt.real(z) <= 1])
    jform = jax_canonicalize(build(jqt), np.float64)[0]
    tform = torch_canonicalize(build(tqt), np.float64, "cpu")[0]
    for name in ("P", "q", "r", "is_eq"):
        np.testing.assert_array_equal(getattr(tform, name).numpy(),
                                      np.asarray(getattr(jform, name)))
