"""qcqp_tpu_torch.examples.circle_packing on the CPU in float64: the SDR
golden 5.000 (within 2e-2; the radius can never exceed B / 2, and the
SDR bound is exactly that here), the checks of tests/test_api_examples.py
::TestCirclePacking on main()'s DCCP (violation < 1e-4, 0.5 <= r <= 5;
in main() it follows a second SDR sample, in that test the first), and
the rendering written only to the path main() is given."""

import numpy as np
import torch

from qcqp_tpu_torch.examples import circle_packing

torch.set_num_threads(1)


def test_circle_packing_main(tmp_path, capsys):
    png = tmp_path / "packing.png"
    out = circle_packing.main(png=str(png), device="cpu")
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("Upper bound from the Shor relaxation")
    try:
        import matplotlib  # noqa: F401
        assert png.exists() and lines[-1] == f"wrote {png}"
    except ImportError:
        assert lines[-1] == "matplotlib unavailable; skipping plot"
    assert abs(out["sdr_bound"] - 5.000) <= 2e-2
    f, v = out["dccp"]
    assert v < 1e-4 and 0.5 <= f <= 5.0
    for key in ("cd", "dccp", "admm"):
        assert np.isfinite(out[key]).all()
