"""The four-card distributed path's cases (tests/torch_cards.py) as four
gloo ranks on the CPU at small sizes: restart-sharded CD, ADMM, DCCP (the
kernels' route, their plain versions on CPU tensors) and an SDR suggest
broadcast from the first rank; a float64 bank's scenarios on (s = 4,
r = 1) and (s = 2, r = 2) meshes, each rank loading its own block; the
2-D ADMM on a (2, 2) mesh.  The same checks as tests/test_torch_gpu_cards.py
runs on four cards, so the control flow is rehearsed without a card."""

import pytest
import torch

from . import torch_cards as cards

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return cards.run(cards.SMALL, str(tmp_path_factory.mktemp("cards")), CPU,
                     "gloo", timeout=240.0)


@pytest.fixture(scope="module")
def scenarios_one_process(run):
    return cards.one_process_scenarios(cards.SMALL, run[1], CPU)


def test_four_ranks_join_and_import_no_jax(run):
    cards.check_workers(run[0], CPU)


@pytest.mark.parametrize("name", ["cd", "admm", "dccp", "sdr"])
def test_restart_sharded_blocks_and_best_point(run, name):
    cards.check_restarts(run[0], name, cards.SMALL, CPU)


@pytest.mark.parametrize("name", ["scen_41", "scen_22"])
def test_scenario_sharded_lanes_and_best_points(run, scenarios_one_process,
                                                name):
    cards.check_scenarios(run[0], name, cards.SMALL, *scenarios_one_process,
                          CPU)


def test_admm_2d_on_a_2x2_mesh(run):
    cards.check_2d(run[0], "bench", cards.SMALL, CPU)


def test_admm_2d_ineq_on_a_2x2_mesh(run):
    cards.check_2d(run[0], "ineq", cards.SMALL, CPU)
