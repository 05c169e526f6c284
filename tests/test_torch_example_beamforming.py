"""qcqp_tpu_torch.examples.secondary_user_beamforming on the CPU in
float64: the SDR golden 1.970 (within 2e-2) and DCCP after the first
sample at violation < 1e-4 and f <= 2.5 (the chain of tests/
test_api_examples.py::TestBeamforming::test_pipeline, whose bound and
DCCP tests/test_torch_sdr_slice.py also holds against the JAX handler);
that test's last step, ADMM(rho = sqrt(m + l), phase1=False), from the
handler main() returns, finite."""

import numpy as np
import torch

import qcqp_tpu_torch as tqt
from qcqp_tpu_torch.examples import secondary_user_beamforming as bf

torch.set_num_threads(1)


def test_beamforming_main(capsys):
    out = bf.main(device="cpu")
    assert len(capsys.readouterr().out.splitlines()) == 5
    assert abs(out["sdr_bound"] - 1.970) <= 2e-2
    f, v = out["dccp"]
    assert v < 1e-4 and f <= 2.5
    for key in ("dccp", "cd", "cd_admm", "cd_admm_cd"):
        assert np.isfinite(out[key]).all()
    f2, v2 = out["qcqp"].improve(tqt.ADMM, rho=np.sqrt(bf.m + bf.l),
                                 phase1=False)
    assert np.isfinite(f2) and np.isfinite(v2)
