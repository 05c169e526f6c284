"""The harness's tests: `python -m pytest portbench/tests` from the root
of the repository.  Tests marked `gpu` need a CUDA card and skip here."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skipped "
                            "without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(autouse=True)
def _undo_hooks():
    """A hook (hooks.py) run in this process patches the cell's sizes or
    the program; each test starts and ends without them."""
    from qcqp_tpu_torch import convert
    from qcqp_tpu_torch.parallel import restarts
    from portbench.harness import spec, window
    patched = [(restarts, k) for k in ("improve_chain", "best_point",
                                       "pick_across", "solve_restarts")]
    patched += [(convert, "form_from_numpy"), (window, "more"),
                (spec.Cell, "__init__")]
    saved = [getattr(obj, k) for obj, k in patched]
    yield
    for (obj, k), v in zip(patched, saved):
        setattr(obj, k, v)
