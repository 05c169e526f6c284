"""K5's plain versions (qcqp_tpu_torch/kernels/eigh_kernel.py) against the
JAX package's Jacobi eigh kernels in interpret mode, on the CPU.

The same numpy matrices go to both packages.  Tolerances are in units of
the matrix's spectral scale, float32: 1e-5 for eigenvalues, products and
the short (unconverged) trajectories, where XLA's possible contraction
and torch's CPU sqrt round differently from one op to the next.  A
converged eigenvector moves by (rounding / eigen-gap), and the smallest
gap of a random 100 x 100 matrix is about 1e-3 of the scale, so converged
eigenvectors are compared by their overlap |<v_torch, v_jax>| >= 1 - 1e-5
(an angle below 4.5e-3).  The LAPACK checks are those of
tests/test_eigh_pallas.py (1e-4)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qcqp_tpu.kernels import eigh_pallas as je

from qcqp_tpu_torch.kernels import eigh_kernel as te

torch.set_num_threads(1)


def _sym(B, n0, seed=0, dtype=np.float32):
    A = np.random.default_rng(seed).standard_normal((B, n0, n0))
    return (0.5 * (A + np.swapaxes(A, -1, -2))).astype(dtype)


def _rec(lam, V):
    return np.einsum("bij,bj,bkj->bik", V, lam, V)


@functools.lru_cache(maxsize=None)
def _plain(fn, shape, sweeps):
    """A plain version's (lam, V) on _sym(*shape), computed once for the
    JAX comparison and the LAPACK check of the same matrices."""
    eig = te.eigh_jacobi_vec_ref if fn == "vec" else te.eigh_jacobi_ref
    return eig(torch.from_numpy(_sym(*shape)), sweeps=sweeps)


@pytest.mark.parametrize("n", [4, 8, 64, 128, 256])
def test_tournament_permutation_matches_jax(n):
    sigma = te.tournament_permutation(n)
    np.testing.assert_array_equal(sigma, je.tournament_permutation(n))
    elems, seen = np.arange(n), set()
    for _ in range(n - 1):
        for i in range(n // 2):
            seen.add(tuple(sorted((elems[2 * i], elems[2 * i + 1]))))
        elems = elems[sigma]
    assert len(seen) == n * (n - 1) // 2


def test_constant_masks_match_jax():
    for mine, theirs in zip(te._constants(128), je._constants(128)):
        np.testing.assert_array_equal(mine, theirs)


def _check_against_jax(A, lt, Vt, lj, Vj, converged):
    scale = np.abs(np.linalg.eigvalsh(A.astype(np.float64))).max()
    lt, Vt, lj, Vj = (np.asarray(a, np.float64) for a in (lt, Vt, lj, Vj))
    assert np.abs(lt - lj).max() <= 1e-5 * scale
    assert np.abs(_rec(lt, Vt) - _rec(lj, Vj)).max() <= 1e-5 * scale
    if converged:
        overlap = np.abs(np.einsum("bij,bij->bj", Vt, Vj))
        assert overlap.min() >= 1 - 1e-5
    else:
        assert np.abs(Vt - Vj).max() <= 1e-5


@pytest.mark.parametrize("shape,sweeps,rounds", [
    ((3, 12), 10, None), ((2, 100), 10, None), ((1, 128), 10, None),
    # schedule checks before convergence hides them: round counts that
    # are not a multiple of n - 1 = 127
    ((2, 30), 2, 57), ((3, 24), 2, 200)])
def test_vec_plain_matches_jax_interpret(shape, sweeps, rounds):
    A = _sym(*shape)
    lj, Vj = je.eigh_jacobi_vec(jnp.asarray(A), sweeps=sweeps,
                                interpret=True, _rounds=rounds)
    lt, Vt = (_plain("vec", shape, sweeps) if rounds is None else
              te.eigh_jacobi_vec_ref(torch.from_numpy(A), sweeps=sweeps,
                                     _rounds=rounds))
    assert lt.dtype == Vt.dtype == torch.float32
    assert lt.shape == shape and Vt.shape == (shape[0], shape[1], shape[1])
    _check_against_jax(A, lt, Vt, lj, Vj, converged=rounds is None)


@pytest.mark.parametrize("shape", [(3, 12), (2, 100), (1, 128)])
def test_matmul_plain_matches_jax_interpret(shape):
    A = _sym(*shape)
    lj, Vj = je.eigh_jacobi(jnp.asarray(A), sweeps=10, interpret=True)
    lt, Vt = _plain("matmul", shape, 10)
    _check_against_jax(A, lt, Vt, lj, Vj, converged=True)


@pytest.mark.parametrize("fn", ["vec", "matmul"])
@pytest.mark.parametrize("shape", [(3, 12), (2, 100), (1, 128), (5, 32)])
def test_plain_versions_match_lapack(fn, shape):
    A = _sym(*shape)
    lam, V = (t.numpy() for t in _plain(fn, shape, 10))
    lam_ref = np.linalg.eigvalsh(A)
    scale = np.abs(lam_ref).max()
    assert np.abs(lam - lam_ref).max() / scale < 1e-4
    assert np.abs(_rec(lam, V) - A).max() / scale < 1e-4
    VtV = np.einsum("bji,bjk->bik", V, V)
    assert np.abs(VtV - np.eye(shape[1])).max() < 1e-4


def test_batch_padding_and_block():
    """A batch that is no multiple of `block` (the JAX wrapper's matrices
    per grid cell) gives each matrix its own result."""
    A = _sym(5, 16, seed=2)
    lam, V = te.eigh_jacobi_vec(torch.from_numpy(A), sweeps=10, block=4)
    lam_ref = np.linalg.eigvalsh(A)
    assert np.abs(lam.numpy() - lam_ref).max() < \
        1e-4 * np.abs(lam_ref).max()
    lam, V = te.eigh_jacobi_vec(torch.from_numpy(A), sweeps=1, block=4)
    for i in range(5):
        li, Vi = te.eigh_jacobi_vec(torch.from_numpy(A[i]), sweeps=1)
        assert torch.equal(li, lam[i]) and torch.equal(Vi, V[i])


def test_batch_axes_and_cast():
    """Leading batch axes carry through; float64 input is cast to float32,
    as the JAX wrappers cast it."""
    A = _sym(6, 9, seed=3, dtype=np.float64).reshape(2, 3, 9, 9)
    lam, V = te.eigh_jacobi_vec(torch.from_numpy(A), sweeps=2)
    assert lam.shape == (2, 3, 9) and V.shape == (2, 3, 9, 9)
    assert lam.dtype == torch.float32
    flat, _ = te.eigh_jacobi_vec(torch.from_numpy(A.reshape(6, 9, 9)),
                                 sweeps=2)
    assert torch.equal(lam.reshape(6, 9), flat)


def test_psd_projection_use():
    """The intended consumer: clamp-and-reconstruct PSD projection, against
    numpy's eigh-based one (tests/test_eigh_pallas.py:68-81)."""
    A = _sym(1, 24, seed=1)
    for eig in (te.eigh_jacobi, te.eigh_jacobi_vec):
        lam, V = (t.numpy() for t in eig(torch.from_numpy(A), sweeps=10))
        proj = _rec(np.maximum(lam, 0.0), V)[0]
        w, Q = np.linalg.eigh(A[0])
        assert np.abs(proj - (Q * np.maximum(w, 0)) @ Q.T).max() < 1e-3


@pytest.mark.parametrize("n0", [7, 12])
def test_jacobi_sweeps_matches_jax_in_float64(n0):
    """jacobi_sweeps (K5b's plain version and the warm projection's body)
    in float64, odd sizes padded: equal to the JAX function to 1e-12, and
    converged to numpy's eigh (tests/test_sdp.py:128-139)."""
    from qcqp_tpu.kernels.eigh_pallas import jacobi_sweeps
    A = _sym(1, n0, seed=5, dtype=np.float64)[0]
    rng = np.random.default_rng(6)
    V0 = np.linalg.qr(rng.standard_normal((n0, n0)))[0]
    for v0 in (None, V0):
        lj, Vj = jacobi_sweeps(jnp.asarray(A), None if v0 is None
                               else jnp.asarray(v0), sweeps=3)
        lt, Vt = te.jacobi_sweeps(torch.from_numpy(A), None if v0 is None
                                  else torch.from_numpy(v0), sweeps=3)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-12)
        np.testing.assert_allclose(Vt.numpy(), np.asarray(Vj), atol=1e-12)
    lam, V = te.jacobi_sweeps(torch.from_numpy(A), sweeps=10)
    np.testing.assert_allclose(V.numpy() @ np.diag(lam.numpy()) @ V.numpy().T,
                               A, atol=1e-8)
    np.testing.assert_allclose(np.sort(lam.numpy()), np.linalg.eigvalsh(A),
                               atol=1e-8)


def test_cpu_tensors_run_the_plain_versions():
    """On a CPU tensor each wrapper is its plain version and launches
    nothing."""
    A = torch.from_numpy(_sym(2, 20, seed=4))
    before = (te.eigh_jacobi_vec.launches, te.eigh_jacobi.launches)
    for wrap, ref in ((te.eigh_jacobi_vec, te.eigh_jacobi_vec_ref),
                      (te.eigh_jacobi, te.eigh_jacobi_ref)):
        lw, Vw = wrap(A, sweeps=3)
        lr, Vr = ref(A, sweeps=3)
        assert torch.equal(lw, lr) and torch.equal(Vw, Vr)
    assert (te.eigh_jacobi_vec.launches, te.eigh_jacobi.launches) == before


def test_wrappers_refuse_what_they_do_not_take():
    with pytest.raises(ValueError):
        te.eigh_jacobi_vec(torch.zeros((3, 4, 5)))
    with pytest.raises(ValueError):
        te.eigh_jacobi(torch.zeros(4))
    with pytest.raises(TypeError):
        te.eigh_jacobi_vec(torch.zeros((4, 4), dtype=torch.int32))
