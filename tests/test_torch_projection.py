"""qcqp_tpu_torch/kernels/projection.py against qcqp_tpu/kernels/projection.py
(float64, CPU), and the recipes of tests/test_projection.py on the port.

Both packages run the same float64 algorithm (eigh, 100-trip bisection to
1e-6); they differ only in the order of a few float64 sums, so the outputs
agree to roundoff.  A bisection step that landed within rounding of the root
could move nu by up to the bisection tolerance; 1e-8 leaves room for
roundoff and would catch such a step, and none happens on these inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import qcqp_tpu  # noqa: F401  (float64 on)
from qcqp_tpu.core import QCQPForm as JForm
from qcqp_tpu.kernels import projection as jp

from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.kernels import projection as tp
from . import oracle

torch.set_num_threads(1)
ATOL = 1e-8


def run_port(z, P, q, r, is_eq):
    """tests/test_projection.py:run_kernel on the port."""
    P = 0.5 * (P + P.T)
    lam, Q = np.linalg.eigh(P)
    qhat = Q.T @ q
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    return tp.project_onecons(t(z), t(lam), t(Q), t(qhat), float(r),
                              bool(is_eq)).numpy()


def run_jax(z, P, q, r, is_eq):
    P = 0.5 * (P + P.T)
    lam, Q = np.linalg.eigh(P)
    return np.asarray(jp.project_onecons(
        jnp.asarray(z), jnp.asarray(lam), jnp.asarray(Q),
        jnp.asarray(Q.T @ q), jnp.asarray(r), jnp.asarray(is_eq)))


def test_fast_path_feasible_inequality():
    z = np.random.default_rng(0).standard_normal(5) * 0.1
    x = run_port(z, np.eye(5), np.zeros(5), -1.0, False)
    np.testing.assert_allclose(x, z, atol=1e-12)


def test_projection_onto_sphere():
    z = np.random.default_rng(1).standard_normal(6) * 3.0
    x = run_port(z, np.eye(6), np.zeros(6), -1.0, True)
    np.testing.assert_allclose(x, z / np.linalg.norm(z), atol=1e-6)


def test_projection_onto_boolean_coordinate():
    for z0, want in ((0.3, 1.0), (-0.3, -1.0)):
        x = run_port(np.array([z0]), np.array([[1.0]]), np.array([0.0]),
                     -1.0, True)
        np.testing.assert_allclose(x, [want], atol=1e-6)


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("is_eq", [False, True])
def test_random_against_slsqp_oracle_and_jax(seed, is_eq):
    """tests/test_projection.py:46-72 on the port, plus the JAX value."""
    rng = np.random.default_rng(100 + seed)
    n = 5
    A = rng.standard_normal((n, n))
    P = 0.5 * (A + A.T)
    q = rng.standard_normal(n)
    r = rng.standard_normal()
    z = rng.standard_normal(n)

    x = run_port(z, P, q, r, is_eq)
    np.testing.assert_allclose(x, run_jax(z, P, q, r, is_eq), atol=ATOL,
                               rtol=0)
    fz = z @ P @ z + q @ z + r
    if (not is_eq) and fz <= 0:
        np.testing.assert_allclose(x, z, atol=1e-12)
        return
    fx = x @ P @ x + q @ x + r
    assert abs(fx) < 1e-4, fx
    ox = oracle.project_onecons_oracle(z, P, q, r, is_eq)
    if ox is None:
        return  # oracle failed to converge; feasibility already checked
    assert np.sum((x - z) ** 2) <= np.sum((ox - z) ** 2) + 1e-5


@pytest.mark.parametrize("seed", range(3))
def test_project_all_matches_jax(seed):
    """Batched over restarts and constraints, against the JAX function
    vmapped the way solvers/admm.py calls it."""
    rng = np.random.default_rng(seed)
    n, m, R = 6, 5, 4
    A = rng.standard_normal((m + 1, n, n))
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    q = rng.standard_normal((m + 1, n))
    r = rng.standard_normal(m + 1)
    is_eq = rng.random(m) < 0.5
    if seed == 2:
        P[1:] = np.abs(P[1:])                 # semidefinite-ish rows
        P[1] = -np.eye(n) * 1e-2              # one-side unbounded bracket
    z = rng.standard_normal((R, m, n))
    jf = JForm(jnp.asarray(P), jnp.asarray(q), jnp.asarray(r),
               jnp.asarray(is_eq))
    je = jp.precompute_eigh(jf)
    xj = np.asarray(jax.vmap(lambda zz: jp.project_all(
        zz, je, jf.r[1:], jf.is_eq))(jnp.asarray(z)))
    tf = form_from_numpy(P, q, r, is_eq, device="cpu")
    te = tp.precompute_eigh(tf)
    xt = tp.project_all(torch.from_numpy(z), te, tf.r[1:], tf.is_eq)
    np.testing.assert_allclose(xt.numpy(), xj, atol=ATOL, rtol=0)
    # each (restart, constraint) pair alone gives the same point
    single = tp.project_onecons(torch.from_numpy(z[1, 2]), te.lam[2],
                                te.Q[2], te.qhat[2], tf.r[3], tf.is_eq[2])
    np.testing.assert_allclose(single.numpy(), xt[1, 2].numpy(), atol=1e-12,
                               rtol=0)
