"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip is skipped (device="cpu", the program's plain
versions, every cell at a tiny size) and one fault is planted in the
program by a hook.  Sound runs of every cell come out correct, and so
does the control where TF32 does not exist."""

import math

import numpy as np
import pytest
import torch

from portbench import run
from portbench.harness import rank, spec, window
from portbench.reference import problem as ref

TINY = "portbench.tests.hooks:tiny"
CELLS = ["dense100.cd-r10240", "dense100.dccp-r10240"]


def _measure(cell, seed, *faults):
    """Five solves, whatever the CPU's timing, so that the mix's compared
    solves are drawn from the same window each time."""
    hooks = [TINY, "portbench.tests.hooks:five_solves"]
    return run.measure(cell, seed, 0.0, False, device="cpu",
                       hooks=hooks + [f"portbench.tests.hooks:{f}"
                                      for f in faults])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    r = _measure(cell, 2**32 + 3)
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_a_fault_is_caught(cell, fault):
    r = _measure(cell, 2**32 + 3, fault)
    assert r["correct"] is False, r["checks"]


def _changed_by_half(cell, seed, solves=5):
    """Whether leaving out the second half of the batch changes one of the
    run's compared solves: the reference's best restart of one lies in
    that half (at the size the run's `tiny` hook left in place)."""
    c = spec.Cell(cell)
    arrays = c.problem()
    form = ref.make_form([np.asarray(a, np.float32) for a in arrays[:3]]
                         + [np.asarray(arrays[3], bool)], torch.float32,
                         "cpu")
    R = int(c.mix["restarts"])
    args = {k: v for k, v in c.mix["improve_args"].items()
            if k != "use_fused"}
    for i in rank._sample(seed, solves, int(c.mix["compared_solves"])):
        xs = c.suggest_reference().draw(form, R, window.solve_seed(seed, i),
                                        torch.float32, "cpu")
        x, _ = c.reference().improve(form, xs, **args)
        b = ref.violation_bucket(ref.max_violation_batch(form, x))
        f = ref.eval_objective_batch(form, x)
        if int(torch.argmin(torch.where(b == b.min(), f, math.inf))) \
                >= R // 2:
            return True
    return False


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", range(100, 104))
def test_half_the_batch_left_out_is_caught(cell, seed):
    """Leaving half of the restarts out changes a solve's answer only where
    its best restart lies in the half left out, one solve in two.  The
    comparison catches every run where it changed a compared solve; with
    five compared solves (the CD mixes) that is every seed tried here, and
    all but one run in 32 at large, with three (the DCCP mix) all but one
    in 8."""
    r = _measure(cell, seed, "half")
    changed = _changed_by_half(cell, seed)
    assert r["correct"] is (not changed), r["checks"]
    if spec.Cell(cell).mix["compared_solves"] >= 5:
        assert changed


def test_the_exchange_between_cards_left_out_is_caught():
    r = _measure("dense100.cd-r40960-x4", 2**32 + 3, "no_exchange")
    assert r["correct"] is False, r["checks"]


def test_four_ranks_sound_run_is_correct():
    r = _measure("dense100.cd-r40960-x4", 2**32 + 3)
    assert r["correct"] is True


@pytest.mark.parametrize("cell", ["dense100.cd-r10240",
                                  "dense100.cd-r40960-x4"])
def test_the_control_is_the_reference_without_tf32(cell):
    """On the CPU, which has no TF32, the control (hooks.control) computes
    what the reference does: its answers read every gap 0.  On the card
    it is not correct (test_run.test_the_control_is_not_correct)."""
    r = run.measure(cell, 7, 0.0, False, device="cpu",
                    hooks=[TINY, "portbench.tests.hooks:control"])
    assert r["correct"] is True, r["checks"]
    assert r["readings"]["f_gap"] == r["readings"]["v_gap"] == 0.0
    assert r["readings"]["x_gap"] == 0.0
