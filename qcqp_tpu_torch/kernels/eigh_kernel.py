"""K5: batched symmetric eigh by round-robin tournament Jacobi
(JAX counterpart: qcqp_tpu/kernels/eigh_pallas.py).

Two wrappers keep the JAX signatures and serve one CUDA kernel,
`csrc/eigh_jacobi.cu`:

  eigh_jacobi_vec   the vectorised Jacobi (JAX: the pallas_call at
                    eigh_pallas.py:272), which the psd_method="vec" cone
                    projection of solvers/sdp.py calls once per splitting
                    iteration;
  eigh_jacobi       the same eigh written with the rotations as J^T A J
                    matmuls (JAX: the pallas_call at eigh_pallas.py:377).

Both pad n0 to n = a multiple of 128, as the JAX wrappers do (the round
schedule depends on n, so another padding is another trajectory), run
sweeps * (n - 1) rounds and return (lam ascending, V) with A = V diag(lam)
V^T, cut to the first n0 slots before a stable sort.  On a CPU tensor a
wrapper runs its plain version; on a CUDA tensor it launches the kernel
(counted in `<wrapper>.launches`) and never falls back.  Input is cast to
float32, as the JAX wrappers cast it.

A round: the per-pair inner rotation (Golub-Van Loan 8.4.1) of the pairs
(2i, 2i+1) from the pre-update A, applied to the rows of A, then its
columns, then the columns of V (one parameter set serves both sides:
eigh_pallas.py:198-204), then the tournament reseat A <- Pi^T A Pi,
V <- V Pi (`tournament_permutation`).  The two JAX kernels compute the
same function and differ in rounding only, so one CUDA kernel serves both:

  eigh_jacobi_vec_ref  K5a's plain version: the elementwise round of
                       `vec_round_ctx` (eigh_pallas.py:135-218) in torch,
                       swaps and reseats as index gathers.  The kernel
                       does the same operations in the same order (one
                       correctly rounded op per torch op, -fmad=false), so
                       it equals this version bit for bit on the card.
  eigh_jacobi_ref      K5b's plain version: `jacobi_sweeps`, the matmul
                       formulation (also the psd_method="warm" projection's
                       body).  Its matmuls round differently from the
                       kernel's elementwise rotations, so the kernel agrees
                       with it to LAPACK-level tolerance, not bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .onevar_kernel import _check_cuda

LANE = 128


def tournament_permutation(n: int) -> np.ndarray:
    """Index permutation sigma with: pairing (2i, 2i+1) applied to
    sigma^k-reseated elements enumerates all unordered pairs over
    k = 0..n-2.  Circle method (seat 0 fixed, the others rotate by one),
    conjugated by the interleave arrangement so every pair is adjacent.
    Round k+1's element at slot j is round k's element at slot sigma[j]."""
    assert n % 2 == 0
    arr = np.empty(n, dtype=np.int64)           # slot -> seat
    arr[0::2] = np.arange(n // 2)
    arr[1::2] = n - 1 - np.arange(n // 2)
    inv_arr = np.argsort(arr)
    rot = np.empty(n, dtype=np.int64)
    rot[0] = 0
    rot[1:] = np.concatenate([[n - 1], np.arange(1, n - 1)])
    return inv_arr[rot[arr]]


@functools.lru_cache(maxsize=8)
def _constants(n: int):
    """The matmul formulation's constant masks as numpy arrays: identity,
    pair-offdiagonal selectors, pair-spread matrices and the reseat
    permutation matrix Pi (X_new = Pi^T X Pi)."""
    eye = np.eye(n)
    E1 = np.zeros((n, n))        # (2i, 2i+1)
    E2 = np.zeros((n, n))        # (2i+1, 2i)
    Sp_a = np.zeros((n, n))      # diag[2i] to rows 2i, 2i+1
    Sp_b = np.zeros((n, n))      # diag[2i+1] to both rows
    Sp_c = np.zeros((n, n))      # offdiag[2i] to both rows
    for i in range(n // 2):
        a, b = 2 * i, 2 * i + 1
        E1[a, b] = 1.0
        E2[b, a] = 1.0
        Sp_a[a, a] = Sp_a[b, a] = 1.0
        Sp_b[a, b] = Sp_b[b, b] = 1.0
        Sp_c[a, a] = Sp_c[b, a] = 1.0
    Pi = np.zeros((n, n))
    Pi[tournament_permutation(n), np.arange(n)] = 1.0
    return eye, E1, E2, Sp_a, Sp_b, Sp_c, Pi


def jacobi_sweeps(A, V0=None, sweeps: int = 2):
    """Round-robin Jacobi sweeps in the matmul formulation, any dtype, any
    leading batch axes, odd sizes padded by one.  Returns (lam unsorted, V)
    with A ~= V diag(lam) V^T after `sweeps` full sweeps.  V0, when given,
    starts the eigenvector accumulation (the warm projection passes
    A' = V_prev^T A V_prev instead and composes)."""
    n0 = A.shape[-1]
    n = n0 + (n0 % 2)
    if n != n0:
        A = torch.nn.functional.pad(A, (0, 1, 0, 1))
    eye, E1, E2, Sp_a, Sp_b, Sp_c, Pi = (
        torch.as_tensor(c, dtype=A.dtype, device=A.device)
        for c in _constants(n))
    if V0 is None:
        V = eye.expand(A.shape)
    elif n != n0:
        V = torch.nn.functional.pad(V0, (0, 1, 0, 1))
        V[..., n0, n0] = 1.0
    else:
        V = V0
    for _ in range(sweeps * (n - 1)):
        d = (A * eye).sum(-1)
        o = (A * E1).sum(-1)
        a = d @ Sp_a.T
        b = d @ Sp_b.T
        c = o @ Sp_c.T
        tau = (b - a) / torch.where(c == 0.0, 1.0, 2.0 * c)
        t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
        t = torch.where(tau == 0.0, 1.0, t)
        t = torch.where(c == 0.0, 0.0, t)
        cs = 1.0 / torch.sqrt(1.0 + t * t)       # lax.rsqrt, see _vec_rounds
        sn = t * cs
        J = eye * cs[..., :, None] + E1 * sn[..., :, None] \
            - E2 * sn[..., :, None]
        JP = J @ Pi
        A = JP.transpose(-1, -2) @ (A @ JP)
        V = V @ JP
    lam = (A * eye).sum(-1)
    if n != n0:
        lam = lam[..., :n0]
        V = V[..., :n0, :n0]
    return lam, V


def _padded(n0: int) -> int:
    return max(LANE, -(-n0 // LANE) * LANE)


def _flatten(name, A):
    """(batch_shape, B, n0, A as (B, n0, n0) float32 contiguous)."""
    if A.ndim < 2 or A.shape[-1] != A.shape[-2] or A.shape[-1] == 0:
        raise ValueError(f"{name}: expected (..., n, n) with n > 0, got "
                         f"{tuple(A.shape)}")
    if not A.is_floating_point():
        raise TypeError(f"{name}: expected a floating tensor, got {A.dtype}")
    batch_shape = tuple(A.shape[:-2])
    n0 = A.shape[-1]
    B = int(np.prod(batch_shape)) if batch_shape else 1
    return batch_shape, B, n0, A.reshape(B, n0, n0).float().contiguous()


def _sorted(batch_shape, lam, V):
    """Ascending eigenvalues (stable, as jnp.argsort) and V's columns in
    that order."""
    lam, order = torch.sort(lam, dim=-1, stable=True)
    V = V.gather(-1, order[:, None, :].expand(V.shape))
    n0 = lam.shape[-1]
    return lam.reshape(*batch_shape, n0), V.reshape(*batch_shape, n0, n0)


def _vec_rounds(A, V, rounds: int):
    """`rounds` vectorised Jacobi rounds on (B, n, n) float32 stacks, one
    torch op per operation of vec_round_ctx's round body, in its order.
    lax.rsqrt becomes 1 / sqrt here and in the kernel: on the card both
    are correctly rounded, as the kernel's sqrtf and division are, while
    torch.rsqrt is not even one function on the CPU (its vectorised body
    and its scalar tail differ by an ulp on about 0.5% of inputs).  On the
    CPU torch's float32 sqrt is not correctly rounded either, so this
    version agrees with the kernel bit for bit on the card only."""
    n = A.shape[-1]
    dev = A.device
    swap = torch.arange(n, device=dev) ^ 1
    sig = torch.as_tensor(tournament_permutation(n), device=dev)
    sgn = torch.where(torch.arange(n, device=dev) % 2 == 0, -1.0, 1.0)
    for _ in range(rounds):
        d = A.diagonal(dim1=-2, dim2=-1)
        a, b = d[:, 0::2], d[:, 1::2]
        c = A[:, 0::2, 1::2].diagonal(dim1=-2, dim2=-1)    # A[2i, 2i+1]
        tau = (b - a) / torch.where(c == 0.0, 1.0, 2.0 * c)
        t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
        t = torch.where(tau == 0.0, 1.0, t)
        t = torch.where(c == 0.0, 0.0, t)
        cs = 1.0 / torch.sqrt(1.0 + t * t)              # lax.rsqrt
        sn = t * cs
        cs = cs.repeat_interleave(2, dim=-1)                # both slots
        nsn = sgn * sn.repeat_interleave(2, dim=-1)         # -sn, +sn
        A = cs[:, :, None] * A + nsn[:, :, None] * A[:, swap, :]   # J^T A
        A = cs[:, None, :] * A + nsn[:, None, :] * A[:, :, swap]   # ... J
        V = cs[:, None, :] * V + nsn[:, None, :] * V[:, :, swap]   # V J
        A = A[:, sig][:, :, sig]                                   # reseat
        V = V[:, :, sig]
    return A, V


def eigh_jacobi_vec_ref(A, sweeps: int = 8, block: int = 16,
                        _rounds: int = None):
    """K5a's plain version (see the module docstring); `block` is the JAX
    wrapper's matrices per grid cell and changes nothing here."""
    batch_shape, B, n0, Af = _flatten("eigh_jacobi_vec", A)
    n = _padded(n0)
    Ap = torch.nn.functional.pad(Af, (0, n - n0, 0, n - n0))
    V0 = torch.eye(n, dtype=torch.float32, device=A.device).expand(B, n, n)
    rounds = sweeps * (n - 1) if _rounds is None else _rounds
    Ap, V = _vec_rounds(Ap, V0, rounds)
    lam = Ap.diagonal(dim1=-2, dim2=-1)[:, :n0]
    return _sorted(batch_shape, lam, V[:, :n0, :n0])


def eigh_jacobi_ref(A, sweeps: int = 8):
    """K5b's plain version: `jacobi_sweeps` at the padded n, float32."""
    batch_shape, B, n0, Af = _flatten("eigh_jacobi", A)
    n = _padded(n0)
    lam, V = jacobi_sweeps(
        torch.nn.functional.pad(Af, (0, n - n0, 0, n - n0)), sweeps=sweeps)
    return _sorted(batch_shape, lam[:, :n0], V[:, :n0, :n0])


def _launch(name, Af, n0, rounds):
    """One launch of csrc/eigh_jacobi.cu on (B, n0, n0): unsorted lam
    (B, n0) by slot and V (B, n0, n0).  n = 128 keeps A and V in shared
    memory; a wider padding runs the same code on a global scratch."""
    B = Af.shape[0]
    _check_cuda(name, [Af], [(B, n0, n0)])
    n = _padded(n0)
    if rounds < 0:
        raise ValueError(f"{name}: rounds must be >= 0, got {rounds}")
    lam = torch.empty((B, n0), dtype=torch.float32, device=Af.device)
    V = torch.empty((B, n0, n0), dtype=torch.float32, device=Af.device)
    scratch = (None if n == LANE else
               torch.empty((B, 2, n, n + 1), dtype=torch.float32,
                           device=Af.device))
    lib = _build.library()
    stream = torch.cuda.current_stream(Af.device).cuda_stream
    rc = lib.qk_eigh_jacobi(Af.data_ptr(), lam.data_ptr(), V.data_ptr(),
                            None if scratch is None else scratch.data_ptr(),
                            B, n0, n, int(rounds), stream)
    _build.check(rc, "qk_eigh_jacobi")
    return lam, V


def eigh_jacobi_vec(A, sweeps: int = 8, block: int = 16,
                    _rounds: int = None):
    """Batched symmetric eigh via the vectorised Jacobi (K5a).

    A: (..., n0, n0) symmetric.  Returns (lam ascending, V), float32.  CPU
    tensors run `eigh_jacobi_vec_ref`; CUDA tensors launch K5 once for the
    whole batch (one block per matrix; `block` changes nothing).  _rounds
    overrides sweeps * (n - 1), as in the JAX wrapper."""
    if not A.is_cuda:
        return eigh_jacobi_vec_ref(A, sweeps, block, _rounds)
    batch_shape, _, n0, Af = _flatten("eigh_jacobi_vec", A)
    rounds = sweeps * (_padded(n0) - 1) if _rounds is None else _rounds
    lam, V = _launch("eigh_jacobi_vec", Af, n0, rounds)
    eigh_jacobi_vec.launches += 1
    return _sorted(batch_shape, lam, V)


def eigh_jacobi(A, sweeps: int = 8):
    """Batched symmetric eigh, K5b's entry point.

    A: (..., n0, n0) symmetric.  Returns (lam ascending, V), float32.  CPU
    tensors run `eigh_jacobi_ref` (the matmul formulation); CUDA tensors
    launch K5, the kernel eigh_jacobi_vec launches."""
    if not A.is_cuda:
        return eigh_jacobi_ref(A, sweeps)
    batch_shape, _, n0, Af = _flatten("eigh_jacobi", A)
    lam, V = _launch("eigh_jacobi", Af, n0, sweeps * (_padded(n0) - 1))
    eigh_jacobi.launches += 1
    return _sorted(batch_shape, lam, V)


eigh_jacobi_vec.launches = 0
eigh_jacobi.launches = 0
