"""The roofline's counts: the reference's work on a fixed tiny problem
gives the same figures every time, and the formulas count what their
docstrings say."""

import numpy as np
import pytest
import torch

from portbench.reference import coord_descent, dccp
from portbench.reference.problem import make_form
from portbench.reference.suggest_random import draw
from portbench.roofline import k1, k4, peaks


def _tiny_problem(n=6, m=3):
    rng = np.random.default_rng(11)
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n)) / np.sqrt(n)
    r = rng.standard_normal(m + 1)
    is_eq = np.array([True, False, True])
    return [np.asarray(a, np.float32) for a in (P, q, r)] + [is_eq]


def test_k1_counts_repeat_on_a_fixed_problem():
    arrays = _tiny_problem()
    form = make_form(arrays, torch.float32, "cpu")
    xs = draw(form, 40, 5, torch.float32, "cpu")
    (x1, w1), (x2, w2) = (coord_descent.improve(form, xs, num_iters=3)
                          for _ in range(2))
    assert torch.equal(x1, x2) and w1 == w2
    assert w1["lane_sweeps"] > 0 and w1["probes"] > 0
    n, m, e = 6, 3, 2
    assert k1.ops(n, m, e, w1["lane_sweeps"], w1["probes"]) == (
        w1["lane_sweeps"] * ((m + 1) * (2 * n * n + 2 * n)
                             + n * 2 * (m + 1) * n)
        + w1["probes"] * (m + e) * k1.C_ROW)
    assert k1.nbytes(n, m, 40) == 4.0 * ((m + 1) * n * n + (m + 1) * n
                                         + (m + 1) + 2 * 40 * n)


def test_k4_counts_repeat_on_a_fixed_problem():
    arrays = _tiny_problem()
    form = make_form(arrays, torch.float32, "cpu")
    xs = draw(form, 70, 6, torch.float32, "cpu")
    (x1, w1), (x2, w2) = (dccp.improve(form, xs, max_iter=3, inner_iters=2)
                          for _ in range(2))
    assert torch.equal(x1, x2) and w1 == w2
    assert len(w1["trips"]) == 2 and w1["E"] == 2          # 70 -> 2 tiles
    n, m, e = 6, 3, 2
    B = 1 + m + e
    inner = 4 * (m + 1) * n * n + (m + e) * n * 15 + 6 * B * n + 8 * n
    lin = 2 * (m + 1 + e) * n * n + 6 * (m + 1) * n
    want = 64 * sum(t[1] * inner + (t[0] + 1) * lin for t in w1["trips"])
    assert k4.ops(n, m, e, w1["trips"]) == want
    assert k4.nbytes(n, m, 70) == 4.0 * ((m + 1) * n * n + 2 * 70 * n)


def test_bound_is_the_larger_side():
    assert peaks.bound_s(67e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(67e12, 6.7e12) == pytest.approx(2.0)
