"""The distributed path on four cards, one NCCL rank a card, against the
one-card solves (tests/torch_cards.py at its FULL sizes: the bench form's
CD at R = 40,960 through K1, ADMM at 4,096 through K3, DCCP at 512 through
K4, an SDR suggest broadcast from the first rank; the S = 132 serving bank
on (s = 4, r = 1) and (s = 2, r = 2) meshes; the 2-D ADMM on (2, 2), on
the bench form and on an inequality form whose lanes become feasible); and
one process driving cards 1-3: K1-K5 on each against their plain
versions, and the handler on cuda:2 while the current device is cuda:0.

Marked `gpu`; every test skips unless the machine has four CUDA devices
(the fixture decides, so that every pytest worker collects the same
tests).  This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -q tests/test_torch_gpu_cards.py
"""

import numpy as np
import pytest
import torch

from . import torch_cards as cards

pytestmark = pytest.mark.gpu

CARDS = [1, 2, 3]


@pytest.fixture(scope="module")
def four():
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < cards.WORLD:
        pytest.skip(f"needs {cards.WORLD} CUDA devices (one NCCL rank a "
                    f"card), this machine has {count}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def run(four, tmp_path_factory):
    from qcqp_tpu_torch.kernels import _build
    _build.library()                 # built once here, loaded by the ranks
    return cards.run(cards.FULL, str(tmp_path_factory.mktemp("cards")), four,
                     "nccl", timeout=900.0)


@pytest.fixture(scope="module")
def scenarios_one_card(four, run):
    return cards.one_process_scenarios(cards.FULL, run[1], four)


def test_four_nccl_ranks_one_a_card(run, four):
    cards.check_workers(run[0], four)
    print("cards-seconds", {name: [round(r[name]["seconds"], 4)
                                   for r in run[0]]
                            for name in run[0][0] if name != "_info"})


@pytest.mark.parametrize("name", ["cd", "admm", "dccp", "sdr"])
def test_restart_sharded_blocks_and_best_point(run, four, name):
    """Each rank's block bit for bit against card 0's one-process chain,
    the exact pick, f to 1e-5 with the same bucket; each rank's form,
    built without device=, and its collectives on its own card."""
    cards.check_restarts(run[0], name, cards.FULL, four)


@pytest.mark.parametrize("name", ["scen_41", "scen_22"])
def test_scenario_sharded_lanes_and_best_points(run, scenarios_one_card,
                                                four, name):
    """Each rank's 33 or 66 scenarios of the float64 bank, loaded alone:
    every lane bit for bit against card 0's solve_scenarios of the whole
    bank, each scenario's best the exact pick."""
    cards.check_scenarios(run[0], name, cards.FULL, *scenarios_one_card,
                          four)


def test_admm_2d_on_a_2x2_nccl_mesh(run, four):
    print("cards-2d bench", cards.check_2d(run[0], "bench", cards.FULL,
                                           four))


def test_admm_2d_ineq_on_a_2x2_nccl_mesh(run, four):
    print("cards-2d ineq", cards.check_2d(run[0], "ineq", cards.FULL, four))


# -- one process, four cards: each wrapper launches on its tensor's card --

def _k1(dev):
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels import cd_sweep_kernel as tk
    from .test_torch_gpu import _k1_form
    arrays, rng = _k1_form(9, 5, 314, 0.5)
    form = form_from_numpy(*arrays, device=dev, dtype=torch.float32)
    xs = torch.from_numpy((0.5 * rng.standard_normal((300, 9)))
                          .astype(np.float32)).to(dev)
    args = (form.P, form.q, form.r, form.eq_idx(), xs)
    return (tk.two_phase_sweeps, lambda: tk.two_phase_sweeps(*args, 8),
            lambda: tk.two_phase_sweeps_ref(*args, 8))


def _k2(dev):
    from qcqp_tpu_torch.kernels import onevar_kernel as tk
    from .test_torch_gpu import _k2_inputs
    arrays, eq_idx = _k2_inputs(1050, 50, 1000, True)
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    return (tk.phase1_coordinate_update,
            lambda: tk.phase1_coordinate_update(*args, eq_idx=eq_idx),
            lambda: tk.phase1_coordinate_update_ref(*args, eq_idx=eq_idx))


def _k3(dev):
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels import admm_kernel as tk
    from .test_torch_gpu import _k3_form
    arrays, rng = _k3_form("dense")
    form = form_from_numpy(*arrays, device=dev, dtype=torch.float32)
    d = tk.ADMMFusedData(form)
    xs = torch.from_numpy(rng.standard_normal((37, form.n))
                          .astype(np.float32)).to(dev)
    return (tk.admm_phase, lambda: tk.admm_phase(d, xs, 2, num_iters=30),
            lambda: tk.admm_phase_ref(d, xs, 2, num_iters=30))


def _k4(dev):
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels import ccp_kernel as tk
    from .test_torch_gpu import _k4_form
    arrays, rng = _k4_form("dense")
    form = form_from_numpy(*arrays, device=dev, dtype=torch.float32)
    d = tk.CCPFusedData(form)
    xs = torch.from_numpy(rng.standard_normal((130, form.n))
                          .astype(np.float32)).to(dev)
    kw = dict(max_iter=4, inner_iters=5)
    return (tk.ccp_improve, lambda: tk.ccp_improve(d, xs, **kw),
            lambda: tk.ccp_improve_ref(d, xs, **kw))


def _k5(dev):
    from qcqp_tpu_torch.kernels import eigh_kernel as tk
    A = np.random.default_rng(41).standard_normal((16, 25, 25))
    A = torch.from_numpy((0.5 * (A + np.swapaxes(A, -1, -2)))
                         .astype(np.float32)).to(dev)
    return (tk.eigh_jacobi_vec, lambda: tk.eigh_jacobi_vec(A, sweeps=2),
            lambda: tk.eigh_jacobi_vec_ref(A, sweeps=2))


KERNELS = {"k1": _k1, "k2": _k2, "k3": _k3, "k4": _k4, "k5": _k5}


@pytest.mark.parametrize("card", CARDS)
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_kernel_on_another_card_equals_plain(four, kernel, card):
    """With cuda:0 current, the wrapper handed cuda:<card> tensors
    launches there once (the stream, the attribute and the launch under
    that card) and equals its plain version on that card bit for bit."""
    dev = torch.device("cuda", card)
    wrapper, launch, plain = KERNELS[kernel](dev)
    assert torch.cuda.current_device() == 0
    before = wrapper.launches
    out = launch()
    assert wrapper.launches == before + 1
    want = plain()
    torch.cuda.synchronize(dev)
    for a, b in zip(*((out, want) if isinstance(out, tuple)
                      else ((out,), (want,)))):
        assert a.device == dev and torch.equal(a, b)
    assert torch.cuda.current_device() == 0


def test_wrapper_refuses_two_cards(four):
    """A wrapper handed tensors on two cards raises, copying nothing."""
    from qcqp_tpu_torch.convert import form_from_numpy
    from qcqp_tpu_torch.kernels import cd_sweep_kernel as tk
    from .test_torch_gpu import _k1_form
    arrays, _ = _k1_form(9, 5, 314, 0.5)
    form = form_from_numpy(*arrays, device="cuda:1", dtype=torch.float32)
    xs = torch.zeros((8, 9), device="cuda:2")
    before = tk.two_phase_sweeps.launches
    with pytest.raises(ValueError, match="one card"):
        tk.two_phase_sweeps(form.P, form.q, form.r, form.eq_idx(), xs, 2)
    assert tk.two_phase_sweeps.launches == before


def test_handler_on_card_2_reaches_the_golden(four):
    """QCQP(prob, device="cuda:2") while cuda:0 is current: its form lies
    on cuda:2 and its solve reaches the boolean-LS golden through one K1
    launch (best of 256 within 2e-2 of 35.551, violation < 1e-2)."""
    import qcqp_tpu_torch as qt
    from qcqp_tpu_torch.kernels.cd_sweep_kernel import two_phase_sweeps
    rs = np.random.RandomState(1)
    A, b = rs.randn(15, 10), rs.randn(15, 1).ravel()
    x = qt.Variable(10)
    prob = qt.Problem(qt.Minimize(qt.sum_squares(A @ x - b)),
                      [qt.square(x) == 1])
    h = qt.QCQP(prob, device="cuda:2")
    assert h.qcqp_form.P.device == torch.device("cuda", 2)
    assert torch.cuda.current_device() == 0
    before = two_phase_sweeps.launches
    f, v = h.solve(num_restarts=256, num_iters=50)
    assert two_phase_sweeps.launches == before + 1
    assert v < 1e-2 and 35.551 - 0.1 <= f <= 35.551 + 2e-2
