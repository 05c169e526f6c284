"""No module a run imports, in the process that prints the result or in
a rank, has the top-level name jax, jaxlib, flax or qcqp_tpu; the check
compares the part before the first dot as a whole name."""

import json
import os
import subprocess
import sys

from portbench.harness import spec
from portbench.harness.rank import BANNED, banned_modules

SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import run
import portbench.reference.coord_descent, portbench.reference.dccp
import portbench.reference.suggest_random
from portbench.tests import hooks
r = run.measure({cell!r}, 5, 0.5, False, device="cpu",
                hooks=["portbench.tests.hooks:tiny"])
print(json.dumps(sorted(k for k in sys.modules
                        if k.split(".")[0] in {banned!r})))
print(json.dumps(r["correct"]))
"""


def test_the_scan_compares_whole_top_level_names():
    mods = {"qcqp_tpu_torch": 1, "qcqp_tpu_torch.core": 1, "jaxtyping": 1,
            "flaxen": 1, "portbench.jax": 1}
    assert banned_modules(mods) == []
    mods.update({"jax": 1, "jax.numpy": 1, "qcqp_tpu.core": 1,
                 "jaxlib.xla": 1, "flax": 1})
    assert banned_modules(mods) == ["flax", "jax", "jax.numpy",
                                    "jaxlib.xla", "qcqp_tpu.core"]


def _run(cell):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=spec.ROOT, cell=cell,
                                             banned=BANNED)],
        capture_output=True, text=True, env=env, cwd=spec.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(x) for x in out.stdout.splitlines()[-2:]]


def test_a_run_and_the_reference_load_no_jax():
    found, correct = _run("dense100.cd-r10240")
    assert found == [] and correct is True


def test_the_ranks_load_no_jax():
    # the four ranks report their own scan; measure raises on any
    found, correct = _run("dense100.cd-r40960-x4")
    assert found == [] and correct is True


def test_a_rank_that_loads_jax_in_its_check_gives_no_result():
    """Each rank scans what it loaded as its last step, after the
    reference's check: a banned name there stops the run."""
    import pytest
    from portbench import run
    with pytest.raises(run.NoResult, match="jax"):
        run.measure("dense100.cd-r40960-x4", 5, 0.0, False, device="cpu",
                    hooks=["portbench.tests.hooks:tiny",
                           "portbench.tests.hooks:jax_in_check"])
