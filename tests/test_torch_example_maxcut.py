"""qcqp_tpu_torch.examples.maxcut on the CPU in float64: the SDR golden
57.207 (within 2e-2) and the checks of tests/test_api_examples.py::
TestMaxcut::test_bound_and_cd on the CD after the first SDR sample, which
is main()'s chain (tests/test_torch_examples.py has the canonical form)."""

import numpy as np
import torch

from qcqp_tpu_torch.examples import maxcut

torch.set_num_threads(1)


def test_maxcut_main(capsys):
    out = maxcut.main(device="cpu")
    assert len(capsys.readouterr().out.splitlines()) == 4
    assert abs(out["sdr_bound"] - 57.207) <= 2e-2
    f_cd, v_cd = out["cd"]
    assert v_cd < 1e-2
    # a cut value is at most the bound (maximize sign convention)
    assert 45.0 <= f_cd <= out["sdr_bound"] + 1e-6
    for key in ("cd", "dccp", "admm"):
        assert np.isfinite(out[key]).all()
