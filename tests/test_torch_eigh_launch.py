"""What surrounds K5's launch (qcqp_tpu_torch/kernels/eigh_kernel.py),
checked on the CPU: the real-pair schedule against a replay of the
tournament, an emulation of the kernel's order of operations on n0 x n0
storage against the plain version, and the launch geometry.  K5 itself is
held against the plain version on the card by tests/test_torch_gpu.py and
chip_smoke.py.  This file imports no JAX.

The C entry point's argument types are held against its source by
tests/test_torch_cd_sweep_launch.py::test_signatures_match_the_sources.
"""

import numpy as np
import pytest
import torch

from qcqp_tpu_torch.kernels import eigh_kernel as tk

torch.set_num_threads(1)


def _sym(B, n0, seed):
    A = np.random.default_rng(seed).standard_normal((B, n0, n0))
    return torch.from_numpy((0.5 * (A + np.swapaxes(A, 1, 2)))
                            .astype(np.float32))


def _replay(n, rounds):
    """The data-moving version's rounds: slot j holds the label of the row
    (and column) it started at; the reseat is X <- Pi^T X Pi with the
    matmul formulation's Pi.  Returns the slots' labels before each round
    and after the last (rounds + 1 arrays)."""
    Pi = tk._constants(n)[-1]
    labels = np.diag(np.arange(n, dtype=np.float64))
    history = []
    for _ in range(rounds + 1):
        history.append(np.diag(labels).astype(np.int64))
        labels = Pi.T @ labels @ Pi
    return history


@pytest.mark.parametrize("n", [128, 256])
def test_schedule_replays_the_tournament(n):
    """For every n0 that pads to n: the schedule's rounds are the replay's
    non-empty rounds, in order, packed P | Q << 16 with -1 past them; the
    final map is the replay's labels; a sweep meets every real pair once;
    the largest round holds n0 // 2 pairs (round 0's), which
    launch_geometry sizes the warps for."""
    history = _replay(n, 300)
    for n0 in range(n - 127, n + 1):
        assert tk._padded(n0) == n
        packed = []                 # each round's real pairs, P | Q << 16
        for d in history[:300]:
            P, Q = d[0::2], d[1::2]
            real = (P < n0) & (Q < n0)
            packed.append(P[real] | (Q[real] << 16))
        for rounds in (n - 1, 57, 300):
            sched, perm, maxp = tk.real_pair_schedule(n0, rounds)
            want = [r for r in packed[:rounds] if len(r)]
            assert sched.dtype == np.int32 and perm.dtype == np.int32
            assert sched.shape == (len(want), maxp)
            assert maxp == n0 // 2
            for row, r in zip(sched, want):
                np.testing.assert_array_equal(row[:len(r)], r)
                assert (row[len(r):] == -1).all()
            np.testing.assert_array_equal(perm, history[rounds][:n0])
            if rounds == n - 1:
                both = np.concatenate(want + [np.zeros(0, np.int64)])
                lo = np.minimum(both & 0xffff, both >> 16)
                hi = np.maximum(both & 0xffff, both >> 16)
                assert len(np.unique(lo * n + hi)) == len(both) \
                    == n0 * (n0 - 1) // 2


def test_schedule_without_rounds():
    sched, perm, maxp = tk.real_pair_schedule(40, 0)
    assert sched.shape == (0, 0) and maxp == 0
    np.testing.assert_array_equal(perm, np.arange(40))
    with pytest.raises(ValueError):
        tk.real_pair_schedule(0, 5)


def test_device_schedule_is_made_once():
    dev = torch.device("cpu")
    first = tk._device_schedule(25, 254, dev)
    assert tk._device_schedule(25, 254, dev) is first
    sched, perm, maxp = tk.real_pair_schedule(25, 254)
    assert sched.shape == (94, 12) and maxp == 12   # 160 empty rounds left out
    assert torch.equal(first[0], torch.from_numpy(sched))
    assert torch.equal(first[1], torch.from_numpy(perm))


def _emulate(A, rounds):
    """The kernel's operations in torch, in its order, on (B, n0, n0)
    storage through the real-pair schedule: per round the parameters of its
    pairs from the pre-update A, the rows of A, the columns of A, the
    columns of V (each rotation as c * x + (-s) * y and c * y + s * x); the
    write-out through the final map, 0 at a padded physical index."""
    B, n0, _ = A.shape
    sched, perm, _ = tk.real_pair_schedule(n0, rounds)
    A = A.clone()
    V = torch.eye(n0).expand(B, n0, n0).clone()
    for row in sched:
        pq = torch.from_numpy(row[row >= 0].astype(np.int64))
        P, Q = pq & 0xffff, pq >> 16
        a, b, c = A[:, P, P], A[:, Q, Q], A[:, P, Q]
        tau = (b - a) / torch.where(c == 0.0, 1.0, 2.0 * c)
        t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
        t = torch.where(tau == 0.0, 1.0, t)
        t = torch.where(c == 0.0, 0.0, t)
        cs = 1.0 / torch.sqrt(1.0 + t * t)
        sn = t * cs
        c_, s_ = cs[:, :, None], sn[:, :, None]
        x, y = A[:, P, :], A[:, Q, :]
        A[:, P, :] = c_ * x + (-s_) * y
        A[:, Q, :] = c_ * y + s_ * x
        c_, s_ = cs[:, None, :], sn[:, None, :]
        for X in (A, V):
            x, y = X[:, :, P], X[:, :, Q]
            X[:, :, P] = c_ * x + (-s_) * y
            X[:, :, Q] = c_ * y + s_ * x
    ph = torch.from_numpy(perm.astype(np.int64))
    real = ph < n0
    phc = torch.where(real, ph, 0)
    lam = torch.where(real, A[:, phc, phc], 0.0)
    return tk._sorted((B,), lam, torch.where(real, V[:, :, phc], 0.0))


@pytest.mark.parametrize("n0", [1, 2, 24, 25, 32, 33, 64, 101, 127, 128,
                                129, 200])
def test_n0_only_emulation_equals_plain(n0):
    """Working only on the real block gives the plain version's lam and V
    under torch.equal (+-0 compare equal), at sweeps 1, 2, 8 and at round
    counts that are no multiple of n - 1."""
    A = _sym(2 if n0 <= 128 else 1, n0, seed=n0)
    n = tk._padded(n0)
    for sweeps, rounds in ((1, None), (2, None), (8, None), (2, 57),
                           (2, 300)):
        lam, V = tk.eigh_jacobi_vec_ref(A, sweeps=sweeps, _rounds=rounds)
        lam_e, V_e = _emulate(A, sweeps * (n - 1) if rounds is None
                              else rounds)
        assert torch.equal(lam, lam_e) and torch.equal(V, V_e), \
            (sweeps, rounds)


@pytest.mark.parametrize("n0", [25, 101])
def test_nonfinite_input_spreads_less_without_padding(n0):
    """The stated deviation: with one infinite entry the plain version's
    identity rotations on padded rows make 0 * inf = NaN there, which
    flows back into every real entry by round 200; the real block alone
    (the kernel's work) has NaN then too, in fewer entries.  By 2 sweeps
    (254 rounds, the vec route's count) both are NaN everywhere."""
    A = _sym(1, n0, seed=3)
    A[0, 3, 5] = A[0, 5, 3] = float("inf")
    lam, V = tk.eigh_jacobi_vec_ref(A, _rounds=200)
    lam_e, V_e = _emulate(A, 200)
    assert bool(lam.isnan().all()) and bool(V.isnan().all())
    assert bool(lam_e.isnan().any())
    assert int(V_e.isnan().sum()) < V.numel()
    for out in tk.eigh_jacobi_vec_ref(A, sweeps=2) + _emulate(A, 254):
        assert bool(out.isnan().all())


@pytest.mark.parametrize("B", [1, 16, 132, 10000])
def test_geometry_fits_every_n0(B):
    """Every n0 = 1 ... 256 on 132 SMs and with no SM count: shared bytes
    within 227 KB, at least one warp, at most 1,024 threads a block, every
    matrix covered once by (block, warp) as the kernel maps them, and
    enough warps for the largest round's pairs."""
    for sms in (132, None):
        for n0 in range(1, 257):
            blocks, mats, warps, nbytes = tk.launch_geometry(n0, B, sms)
            assert 0 <= nbytes <= tk.SMEM_BLOCK_MAX
            assert warps >= 1 and mats >= 1 and 32 * mats * warps <= 1024
            mat = 4 * 2 * n0 * tk._ld(n0)
            if n0 <= tk.WARP_MAX_N0:
                assert warps == 1 and nbytes == mats * mat
                covered = [blk * mats + w for blk in range(blocks)
                           for w in range(mats) if blk * mats + w < B]
                if sms:
                    assert mats <= -(-B // sms)
            else:
                assert mats == 1
                assert nbytes == (mat if n0 <= tk.SHARED_MAX_N0 else 0)
                assert -(-(n0 // 2) // warps) <= 32
                covered = list(range(blocks))
            assert sorted(covered) == list(range(B))


@pytest.mark.parametrize("n0,B,want", [
    (25, 16, (16, 1, 1, 5000)),           # the S = 16 bank: a warp an SM
    (25, 132, (132, 1, 1, 5000)),
    (25, 1001, (126, 8, 1, 40000)),       # 8 matrices a block, the last 1
    (1, 4, (4, 1, 1, 8)),
    (32, 10000, (371, 27, 1, 228096)),    # 227 KB holds 27 of 8,448 bytes
    (33, 7, (7, 1, 16, 8712)),
    (101, 132, (132, 1, 25, 81608)),      # 50 pairs: 25 warps of 2
    (128, 1, (1, 1, 32, 132096)),
    (169, 2, (2, 1, 28, 228488)),         # the largest in shared memory
    (170, 2, (2, 1, 29, 0)),              # a global scratch
    (200, 2, (2, 1, 25, 0))])
def test_geometry_at_the_edges(n0, B, want):
    assert tk.launch_geometry(n0, B, 132) == want


@pytest.mark.parametrize("n0,B", [(0, 1), (tk.MAX_N0 + 1, 1), (5, -1)])
def test_geometry_refuses_what_k5_does_not_take(n0, B):
    with pytest.raises(ValueError):
        tk.launch_geometry(n0, B, 132)


def test_constants_match_the_source():
    """SHARED_MAX_N0 is the largest n0 whose A and V fit a block's 227 KB,
    and no larger n0 than the kernel's shared storage takes (six columns a
    lane, n0 <= 192) gets shared memory."""
    fits = [n0 for n0 in range(1, 400)
            if 8 * n0 * tk._ld(n0) <= tk.SMEM_BLOCK_MAX]
    assert max(fits) == tk.SHARED_MAX_N0 <= 6 * 32
    assert all(tk.launch_geometry(n0, 1, 132)[3] == 0
               for n0 in range(tk.SHARED_MAX_N0 + 1, 400))
