"""What surrounds K3's launch (qcqp_tpu_torch/kernels/admm_kernel.py),
checked on the CPU: the launch geometry (warps a block, the switch from the
whole-Q_i slab to chunks, shared memory a block) for every n K3 takes, and
the plain version's consensus, which reads Q_i by columns as the kernel
does.  K3 itself is held against the plain version on the card by
tests/test_torch_gpu.py and chip_smoke.py; the plain version against the
JAX kernel by tests/test_torch_admm_kernel.py.

The C entry point's argument types are held against its source by
tests/test_torch_cd_sweep_launch.py::test_signatures_match_the_sources.
"""

import numpy as np
import pytest
import torch

from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.kernels import admm_kernel as tk

torch.set_num_threads(1)


@pytest.mark.parametrize("m", [1, 50])
@pytest.mark.parametrize("R", [1, 1024, 10240, None])
def test_geometry_fits_every_n(m, R):
    """Every n = 1 ... 1,024 on 132 SMs: one to MAX_WARPS warps, as many
    as a block's 227 KB holds (and, given R, no more than R / 132 rounded
    up), the whole Q_i a slab exactly up to WHOLE_MAX_N, never a raise."""
    sms = None if R is None else 132
    for n in range(1, tk.MAX_N + 1):
        warps, rows, nbytes = tk.launch_geometry(n, m, R, sms)
        whole = n <= tk.WHOLE_MAX_N
        assert rows == (0 if whole else tk.CHUNK_ROWS)
        assert 1 <= warps <= tk.MAX_WARPS
        assert nbytes <= tk.SMEM_BLOCK_MAX
        S = -(-n // 4) * 4
        S += 0 if S // 4 % 2 else 4          # 4 mod 8: conflict-free float4
        assert S >= n and S % 8 == 4
        slab = (n if whole else rows) * S
        warp = (4 if whole else 5) * 32 * -(-n // 32)
        assert nbytes == 4 * (2 * slab + 32 + warps * warp)
        if R is None:
            assert warps == tk.MAX_WARPS or \
                nbytes + 4 * warp > tk.SMEM_BLOCK_MAX
        else:
            assert warps <= -(-R // sms)
        if R == 1:
            assert warps == 1


def test_geometry_at_the_bench_shape():
    """n = 100, m = 50 (bench.py's ADMM form): the whole Q_i a slab of
    100 x 100 floats, two of them (80,000 bytes), 128 bytes past them and
    2,048 bytes a warp (z, the operand, the total and z_last, 128 floats
    each); 16 warps a block at R = 10,240 (640 blocks), 8 at R = 1,024
    (128 blocks, one an SM)."""
    assert tk.launch_geometry(100, 50) == (16, 0, 80128 + 16 * 2048)
    assert tk.launch_geometry(100, 50, 10240, 132) == (16, 0, 112896)
    assert tk.launch_geometry(100, 50, 1024, 132) == (8, 0, 96512)
    assert tk.launch_geometry(100, 50, 132 * 3 + 1, 132)[0] == 4


@pytest.mark.parametrize("n,want", [
    (160, (8, 0, 210048 + 8 * 2560)),       # the largest whole slab (S 164)
    (161, (16, 16, 21120 + 16 * 3840)),     # chunks of 16 rows (S 164)
    (1024, (4, 16, 131712 + 4 * 20480))])   # 4 warps of 5 x 4 KB vectors
def test_geometry_at_the_storage_switch(n, want):
    assert tk.launch_geometry(n, 7) == want
    assert tk.launch_geometry(n, 7, 1, 132)[:2] == (1, want[1])


@pytest.mark.parametrize("n,m", [(0, 1), (1025, 1), (10, 0)])
def test_geometry_refuses_what_k3_does_not_take(n, m):
    with pytest.raises(ValueError):
        tk.launch_geometry(n, m)


@pytest.mark.parametrize("n", [5, 40, 70])
def test_consensus_reads_q_by_columns(n):
    """The plain version's consensus through Q_i^T as a view of Q equals,
    bit for bit, the product with a contiguous copy of Q_i^T: the same
    values, k in the same order, as the kernel reads Q_i by columns."""
    rng = np.random.default_rng(n)
    m = 3
    A = rng.standard_normal((m + 1, n, n)) / np.sqrt(n)
    P = 0.5 * (A + np.swapaxes(A, -1, -2))
    form = form_from_numpy(P, rng.standard_normal((m + 1, n)),
                           rng.standard_normal(m + 1), np.zeros(m, bool),
                           device="cpu", dtype=torch.float32)
    d = tk.ADMMFusedData(form)
    assert not hasattr(d, "QT")
    xh, uh = (torch.from_numpy(rng.standard_normal((6, m, n))
                               .astype(np.float32)) for _ in range(2))
    QT = d.Q.transpose(1, 2).contiguous()
    part = tk._rowvec(xh - uh, QT)
    want = ((torch.zeros_like(part[:, 0]) + part[:, 0]) + part[:, 1]) + \
        part[:, 2]
    assert torch.equal(tk._consensus(d, xh, uh), want)
