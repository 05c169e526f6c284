"""What surrounds K2's launch (qcqp_tpu_torch/kernels/onevar_kernel.py),
checked on the CPU: the launch geometry (warps a block, shared memory a
warp, the switch to global-memory rows) for every shape the CD route sends
to K2, the equality-row list the kernel reads, and the CPU wrapper's plain
version.  The default CD route above n = 128, which runs K2 once per
coordinate, is held against the JAX package's route in
tests/test_torch_cd_sweep.py.

The C entry point's argument types are held against its source by
tests/test_torch_cd_sweep_launch.py::test_signatures_match_the_sources.
"""

import pytest
import torch

from qcqp_tpu_torch.kernels import onevar_kernel as tk
from .test_torch_gpu import _k2_inputs

torch.set_num_threads(1)


@pytest.mark.parametrize("split", [True, False])
def test_geometry_fits_every_route_shape(split):
    """The route has no size gate: every m = 0..600, E = 0, m/2 and m
    (split; the generic variant has no E), at R = 10,240 and R = 1 on 132
    SMs and with no R: one to MAX_WARPS warps, as many as a block's 227 KB
    holds, one at R = 1, never a raise."""
    for m in range(0, 601):
        for e in ((0, m // 2, m) if split else (0,)):
            for R, sms in ((None, None), (10240, 132), (1, 132)):
                warps, floats, nbytes, gmem = tk.launch_geometry(
                    m, e, split, R, sms)
                assert not gmem and 1 <= warps <= tk.MAX_WARPS
                assert nbytes == 4 * warps * floats <= tk.SMEM_BLOCK_MAX
                if R is None:
                    assert warps == tk.MAX_WARPS or \
                        nbytes + 4 * floats > tk.SMEM_BLOCK_MAX
                if R == 1:
                    assert warps == 1
    # a warp holds p, q, r, act (and eq) m floats each and four fields of
    # each of its m + E (split) or 2m (generic) rows
    big = {(True, 600): (4, 7200, 115200, False),
           (False, 600): (4, 7800, 124800, False),
           (True, 2000): (2, 24000, 192000, False),
           (False, 2000): (2, 26000, 208000, False),
           (True, 0): (4, 0, 0, False), (False, 0): (4, 0, 0, False)}
    for m in (0, 600, 2000):
        assert tk.launch_geometry(m, m if split else 0, split) == \
            big[split, m]


@pytest.mark.parametrize("split,e_of_m,fits,spills", [
    (True, lambda m: m, (4842, 58104, 232416), (4843, 58116)),
    (True, lambda m: 0, (7264, 58112, 232448), (7265, 58120)),
    (False, lambda m: 0, (4470, 58110, 232440), (4471, 58123))])
def test_global_rows_above_a_block(split, e_of_m, fits, spills):
    """The largest m whose warp slice fits a block's shared memory runs
    one warp a block in shared memory; one row more puts the slices in a
    global scratch, MAX_WARPS warps a block, no shared memory."""
    m, floats, nbytes = fits
    assert tk.launch_geometry(m, e_of_m(m), split) == (1, floats, nbytes,
                                                       False)
    m, floats = spills
    assert tk.launch_geometry(m, e_of_m(m), split) == (tk.MAX_WARPS,
                                                       floats, 0, True)
    for m in (spills[0], 2 * fits[0], 20000):
        assert tk.launch_geometry(m, e_of_m(m), split, 3, 132)[::3] == \
            (1, True)


def test_geometry_at_the_route_shapes():
    """The split shape of the main path (m = 50, E = 22): 1,952 bytes a
    warp, 4 warps a block at R = 10,240, one at R = 256 on 132 SMs; the
    n = 256 route's form (m = 20): 4 (20 + 20 + E) floats a warp."""
    assert tk.launch_geometry(50, 22, True) == (4, 488, 4 * 1952, False)
    assert tk.launch_geometry(50, 22, True, 10240, 132)[0] == 4
    assert tk.launch_geometry(50, 22, True, 256, 132)[0] == 1
    assert tk.launch_geometry(50, 22, True, 400, 132)[0] == 3
    assert tk.launch_geometry(50, 0, False) == (4, 650, 4 * 2600, False)
    for e in range(21):
        assert tk.launch_geometry(20, e, True, 10240, 132) == \
            (4, 4 * (40 + e), 4 * 4 * 4 * (40 + e), False)


def test_equality_rows_list():
    """The int32 list of the equality rows the split kernel reads, made
    once per pattern; a row outside [0, m) raises before any launch."""
    dev = torch.device("cpu")
    idx = tk._eq_index((0, 3, 4), 5, dev)
    assert idx.dtype == torch.int32 and idx.tolist() == [0, 3, 4]
    assert tk._eq_index((0, 3, 4), 5, dev) is idx
    with pytest.raises(ValueError, match="outside"):
        tk._eq_index((0, 5), 5, dev)
    with pytest.raises(ValueError, match="outside"):
        tk._eq_index((-1,), 5, dev)


@pytest.mark.parametrize("row_eq", [False, True])
def test_cpu_tensors_run_the_plain_version(row_eq):
    """On CPU tensors the wrapper is the plain version and launches
    nothing."""
    arrays, eq_idx = _k2_inputs(3, 33, 70, row_eq)
    args = [torch.from_numpy(a) for a in arrays]
    before = tk.phase1_coordinate_update.launches
    v = tk.phase1_coordinate_update(*args, eq_idx=eq_idx)
    assert torch.equal(v, tk.phase1_coordinate_update_ref(*args,
                                                          eq_idx=eq_idx))
    assert (v != args[5]).any()
    assert tk.phase1_coordinate_update.launches == before
