"""qcqp_tpu_torch.core and the best-point reduction against qcqp_tpu, in
float64 on the CPU.  Inputs are drawn once with numpy and handed to both
packages; the evaluators agree to rtol 1e-12 (summation order differs
between the two matmul paths, so not bit for bit)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import qcqp_tpu  # noqa: F401  (turns on x64)
from qcqp_tpu import core as jcore
from qcqp_tpu.parallel.restarts import best_point as jax_best_point

from qcqp_tpu_torch import core as tcore
from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.parallel.restarts import best_point as torch_best_point

torch.set_num_threads(1)
RTOL = 1e-12


def _forms(n, m, seed, eq_frac=0.5):
    jform = jcore.random_form(np.random.default_rng(seed), n, m, eq_frac)
    tform = tcore.random_form(np.random.default_rng(seed), n, m, eq_frac,
                              device="cpu")
    return jform, tform


@pytest.mark.parametrize("n,m,seed", [(6, 4, 0), (11, 8, 1), (5, 0, 2)])
def test_random_form_and_make_form_identical(n, m, seed):
    jform, tform = _forms(n, m, seed)
    for name in ("P", "q", "r", "is_eq"):
        np.testing.assert_array_equal(getattr(tform, name).numpy(),
                                      np.asarray(getattr(jform, name)))
    assert (tform.n, tform.m) == (jform.n, jform.m)
    assert tform.dtype == torch.float64


@pytest.mark.parametrize("n,m,seed", [(6, 4, 0), (11, 8, 1), (5, 0, 2)])
def test_single_point_evaluators(n, m, seed):
    jform, tform = _forms(n, m, seed)
    rng = np.random.default_rng(100 + seed)
    for _ in range(4):
        x = rng.standard_normal(n)
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
        np.testing.assert_allclose(tcore.eval_all(tform, xt).numpy(),
                                   np.asarray(jcore.eval_all(jform, xj)),
                                   rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(
            float(tcore.eval_objective(tform, xt)),
            float(jcore.eval_objective(jform, xj)), rtol=RTOL)
        np.testing.assert_allclose(tcore.violations(tform, xt).numpy(),
                                   np.asarray(jcore.violations(jform, xj)),
                                   rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(
            float(tcore.max_violation(tform, xt)),
            float(jcore.max_violation(jform, xj)), rtol=RTOL, atol=1e-12)
        kt = tcore.better_key(tform, xt, 1e-4)
        kj = jcore.better_key(jform, xj, 1e-4)
        assert float(kt[0]) == float(kj[0])
        np.testing.assert_allclose(float(kt[1]), float(kj[1]), rtol=RTOL)


def test_better_prefers_second_on_ties():
    jform, tform = _forms(5, 3, 4)
    rng = np.random.default_rng(9)
    x1, x2 = rng.standard_normal(5), rng.standard_normal(5)
    for a, b in ((x1, x2), (x2, x1), (x1, x1.copy())):
        got = tcore.better(tform, torch.from_numpy(a), torch.from_numpy(b))
        want = jcore.better(jform, jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,m,seed", [(7, 5, 0), (4, 0, 1)])
def test_batched_evaluators_match_vmap(n, m, seed):
    jform, tform = _forms(n, m, seed)
    xs = np.random.default_rng(seed).standard_normal((33, n))
    xt = torch.from_numpy(xs)
    F = np.asarray(jax.vmap(lambda x: jcore.eval_all(jform, x))(
        jnp.asarray(xs)))
    np.testing.assert_allclose(tcore.eval_all_batch(tform, xt).numpy(), F,
                               rtol=RTOL, atol=1e-12)
    obj = np.asarray(jax.vmap(lambda x: jcore.eval_objective(jform, x))(
        jnp.asarray(xs)))
    np.testing.assert_allclose(tcore.eval_objective_batch(tform, xt).numpy(),
                               obj, rtol=RTOL)
    mv = np.asarray(jax.vmap(lambda x: jcore.max_violation(jform, x))(
        jnp.asarray(xs)))
    np.testing.assert_allclose(tcore.max_violation_batch(tform, xt).numpy(),
                               mv, rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("seed", range(3))
def test_best_point_matches(seed):
    jform, tform = _forms(8, 5, seed)
    rng = np.random.default_rng(50 + seed)
    xs = rng.standard_normal((64, 8))
    # a few exact duplicates exercise the lowest-index tie-break
    xs[40] = xs[3]
    xs[41] = xs[3]
    xj, fj, vj = jax_best_point(jform, jnp.asarray(xs))
    xt, ft, vt = torch_best_point(tform, torch.from_numpy(xs))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=RTOL)
    np.testing.assert_allclose(float(ft), float(fj), rtol=RTOL)
    np.testing.assert_allclose(float(vt), float(vj), rtol=RTOL, atol=1e-12)


def test_form_from_numpy_is_bit_identical():
    jform, _ = _forms(6, 4, 7)
    arrays = [np.asarray(a) for a in jform]
    tform = form_from_numpy(*arrays, device="cpu")
    for got, want in zip(tform, arrays):
        np.testing.assert_array_equal(got.numpy(), want)
    f32 = form_from_numpy(*arrays, device="cpu", dtype=torch.float32)
    assert f32.P.dtype == torch.float32 and f32.is_eq.dtype == torch.bool
    assert f32.eq_idx() == tuple(int(i) for i in np.nonzero(arrays[3])[0])


def test_default_dtype_follows_device():
    assert tcore.default_dtype("cpu") == torch.float64
    assert tcore.default_dtype("cuda") == torch.float32
    form = tcore.make_form(np.eye(2)[None].repeat(2, 0), np.zeros((2, 2)),
                           np.zeros(2), [True], device="cpu")
    assert form.dtype == torch.float64
    with pytest.raises(ValueError):
        tcore.make_form(np.zeros((2, 2, 2)), np.zeros((2, 2)), np.zeros(2),
                        [True, False], device="cpu")


def test_overflowed_lane_ranks_last():
    """A float32 lane far enough out (|x| ~ 1e20) overflows x'P x: the
    port's summed products give +inf + -inf = NaN where the JAX package's
    dot gives +-inf.  `better`, better_batch and best_point rank such a
    lane last, so both packages pick the same point."""
    P = np.stack([np.eye(2), np.diag([1.0, -1.0])]).astype(np.float32)
    q, r = np.zeros((2, 2), np.float32), np.array([0.0, -1.0], np.float32)
    is_eq = np.array([True])
    xs = np.array([[3.0, 0.0], [1.0, 0.0], [1e20, 1e20]], np.float32)
    jform = jcore.make_form(P, q, r, is_eq)
    tform = form_from_numpy(P, q, r, is_eq, device="cpu",
                            dtype=torch.float32)
    txs = torch.from_numpy(xs)
    assert torch.isnan(tcore.max_violation_batch(tform, txs)[2])
    xj, fj, vj = jax_best_point(jform, jnp.asarray(xs))
    xt, ft, vt = torch_best_point(tform, txs)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    assert float(ft) == float(fj) and float(vt) == float(vj)
    for i in (0, 1):
        want = np.asarray(jcore.better(jform, jnp.asarray(xs[i]),
                                       jnp.asarray(xs[2])))
        np.testing.assert_array_equal(
            tcore.better(tform, txs[i], txs[2]).numpy(), want)
        np.testing.assert_array_equal(
            tcore.better_batch(tform, txs[i:i + 1], txs[2:]).numpy()[0],
            want)
