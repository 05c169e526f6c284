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

The kernel works only on the real n0 x n0 block: a pair with a padded slot
is an identity rotation, so it runs the tournament's real pairs from
`real_pair_schedule` (built once on the host per (n0, rounds) and cached
on the device) and reads the final slot -> physical map at the write-out.
That gives the plain version's values for finite inputs; a non-finite
input spreads NaN through the padded rows in the plain version (0 * inf)
and into fewer entries in the kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build
from .onevar_kernel import _check_cuda, _sm_count

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


# K5's storages; csrc/eigh_jacobi.cu takes the one launch_geometry picks
WARP_MAX_N0 = 32          # one warp owns a matrix, several a block
SHARED_MAX_N0 = 169       # one block a matrix, A and V in shared memory
MAX_N0 = 8192             # above SHARED_MAX_N0: a global scratch
MAX_WARPS = 32
SMEM_BLOCK_MAX = 232448   # 227 KB, the H100's largest block


def _ld(n0: int) -> int:
    """K5's row stride: n0 rounded up to odd, so that a warp's strided
    column accesses fall on 32 banks."""
    return n0 | 1


@functools.lru_cache(maxsize=32)
def real_pair_schedule(n0: int, rounds: int):
    """The rounds of the n-slot tournament (n = _padded(n0)) as K5 runs
    them, built on the host: (sched, perm, maxp).

    Round r pairs slots (2k, 2k+1), which hold the physical rows and
    columns p_r[2k], p_r[2k+1] of the data-moving version's A (p_0 the
    identity, p_{r+1}[j] = p_r[sigma[j]]).  A pair with a physical index
    >= n0 is an identity rotation and is left out; so is a round with no
    real pair.  sched is (rounds with a real pair, maxp) int32, a round's
    real pairs in slot order packed as P | Q << 16 (P the even slot's),
    -1 past them; maxp the most real pairs of a round; perm (n0,) int32
    the physical index of slots 0..n0-1 after all `rounds` rounds (>= n0
    for a padded one)."""
    if n0 < 1 or rounds < 0:
        raise ValueError(f"eigh: n0 = {n0} and rounds = {rounds}")
    n = _padded(n0)
    sigma = tournament_permutation(n)
    p = np.arange(n)
    rows = []
    for _ in range(rounds):
        P, Q = p[0::2], p[1::2]
        real = (P < n0) & (Q < n0)
        if real.any():
            rows.append(P[real] | (Q[real] << 16))
        p = p[sigma]
    maxp = max((len(r) for r in rows), default=0)
    sched = np.full((len(rows), maxp), -1, dtype=np.int32)
    for i, r in enumerate(rows):
        sched[i, :len(r)] = r
    return sched, p[:n0].astype(np.int32), maxp


@functools.lru_cache(maxsize=32)
def _device_schedule(n0: int, rounds: int, device):
    """real_pair_schedule on the device, made once per (n0, rounds,
    device): the vec SDP loop launches K5 at one shape every iteration."""
    sched, perm, maxp = real_pair_schedule(n0, rounds)
    return (torch.from_numpy(sched).to(device),
            torch.from_numpy(perm).to(device), maxp)


def launch_geometry(n0: int, B: int, sms: int = None):
    """(blocks, matrices a block, warps a matrix, shared bytes a block)
    for K5 on B matrices of n0 x n0 (csrc/eigh_jacobi.cu).

    n0 <= WARP_MAX_N0: one warp a matrix; a block holds as many as its
    227 KB (2 n0 _ld(n0) floats each) and MAX_WARPS allow and, given the
    card's SM count, no more than B / sms rounded up, so that a small
    batch spreads over the SMs.  Above: one block a matrix, with as few
    warps as hold the largest round's pairs (n0 // 2, round 0's) at the
    fewest pairs a warp (at most 32 a warp: a lane holds one pair's
    parameters); A and V in shared memory up to SHARED_MAX_N0, above in a
    global scratch (0 shared bytes)."""
    if not 0 < n0 <= MAX_N0 or B < 0:
        raise ValueError(f"K5 takes 0 < n0 <= {MAX_N0} and B >= 0, got "
                         f"n0 = {n0}, B = {B}")
    mat = 4 * 2 * n0 * _ld(n0)
    if n0 <= WARP_MAX_N0:
        mats = min(MAX_WARPS, SMEM_BLOCK_MAX // mat)
        if sms:
            mats = max(1, min(mats, -(-B // sms)))
        return -(-B // mats), mats, 1, mats * mat
    maxp = n0 // 2
    per_warp = -(-maxp // MAX_WARPS)
    warps = -(-maxp // per_warp)
    return B, 1, warps, mat if n0 <= SHARED_MAX_N0 else 0


def _launch(name, Af, n0, rounds):
    """One launch of csrc/eigh_jacobi.cu on (B, n0, n0): unsorted lam
    (B, n0) by slot and V (B, n0, n0).  The schedule comes from the
    device cache; above SHARED_MAX_N0 A and V live in a global scratch."""
    B = Af.shape[0]
    _check_cuda(name, [Af], [(B, n0, n0)])
    if rounds < 0:
        raise ValueError(f"{name}: rounds must be >= 0, got {rounds}")
    _, mats, warps, smem = launch_geometry(n0, B, _sm_count(Af.device))
    sched, perm, maxp = _device_schedule(n0, int(rounds), Af.device)
    lam = torch.empty((B, n0), dtype=torch.float32, device=Af.device)
    V = torch.empty((B, n0, n0), dtype=torch.float32, device=Af.device)
    scratch = (None if n0 <= SHARED_MAX_N0 else
               torch.empty((B, 2, n0, _ld(n0)), dtype=torch.float32,
                           device=Af.device))
    lib = _build.library()
    with torch.cuda.device(Af.device):
        stream = torch.cuda.current_stream(Af.device).cuda_stream
        rc = lib.qk_eigh_jacobi(
            Af.data_ptr(), lam.data_ptr(), V.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            sched.data_ptr(), perm.data_ptr(), B, n0, sched.shape[0], maxp,
            mats, warps, smem, stream)
    _build.check(rc, "qk_eigh_jacobi")
    return lam, V


def eigh_jacobi_vec(A, sweeps: int = 8, block: int = 16,
                    _rounds: int = None):
    """Batched symmetric eigh via the vectorised Jacobi (K5a).

    A: (..., n0, n0) symmetric.  Returns (lam ascending, V), float32.  CPU
    tensors run `eigh_jacobi_vec_ref`; CUDA tensors launch K5 once for the
    whole batch (`launch_geometry`; `block` changes nothing).  _rounds
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
