"""tests/test_f32.py on the port: the four unfused single-point improves
(CD, ADMM, CCP, NLP) in float32 on the CPU.  The boolean least-squares
form of that file (n = 8, m = 12, seed 3) goes to both packages as the
same float32 numpy arrays, each improve runs from the same numpy start in
both, and both results are held to the JAX test's assertions at its
tolerances.  The fifth test there, the SDR bound in float32, is
tests/test_torch_sdp.py::test_warm_route_float32_bound_close_to_float64.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qcqp_tpu import core as jcore
from qcqp_tpu.solvers.admm import improve_admm as j_admm
from qcqp_tpu.solvers.ccp import improve_ccp as j_ccp
from qcqp_tpu.solvers.coord_descent import improve_coord_descent as j_cd
from qcqp_tpu.solvers.nlp import improve_nlp as j_nlp

from qcqp_tpu_torch import core as tcore
from qcqp_tpu_torch.convert import form_from_numpy
from qcqp_tpu_torch.solvers.admm import improve_admm as t_admm
from qcqp_tpu_torch.solvers.ccp import improve_ccp as t_ccp
from qcqp_tpu_torch.solvers.coord_descent import improve_coord_descent as t_cd
from qcqp_tpu_torch.solvers.nlp import improve_nlp as t_nlp
from .test_cd import boolean_ls_form

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def forms32():
    """tests/test_f32.py's form32: (the JAX form, the port's form), both
    float32, from the same arrays."""
    form, _, _ = boolean_ls_form(n=8, m=12, seed=3)
    arrays = [np.asarray(a) for a in form.astype(jnp.float32)]
    return (jcore.QCQPForm(*map(jnp.asarray, arrays)),
            form_from_numpy(*arrays, device="cpu", dtype=torch.float32))


def _start(seed, sign=False):
    x0 = np.random.default_rng(seed).standard_normal(8)
    return (np.sign(x0) if sign else x0).astype(np.float32)


def _both(forms32, j_fn, t_fn, x0, **kw):
    """(x, max violation) of each package, x as numpy; both float32."""
    jform, tform = forms32
    xj = j_fn(jform, jnp.asarray(x0), **kw)
    xt = t_fn(tform, torch.from_numpy(x0), **kw)
    assert xj.dtype == jnp.float32 and xt.dtype == torch.float32
    return ((np.asarray(xj), float(jcore.max_violation(jform, xj))),
            (xt.numpy(), float(tcore.max_violation(tform, xt))))


def test_cd_f32(forms32):
    for x, v in _both(forms32, j_cd, t_cd, _start(0)):
        assert v < 1e-2
        np.testing.assert_allclose(np.abs(x), 1.0, atol=2e-2)


def test_admm_f32(forms32):
    for x, _ in _both(forms32, j_admm, t_admm, _start(1, sign=True),
                      num_iters=200):
        assert np.isfinite(x).all()


def test_ccp_f32(forms32):
    for _, v in _both(forms32, j_ccp, t_ccp, _start(2), max_iter=40,
                      inner_iters=100):
        assert v < 5e-2


def test_nlp_f32(forms32):
    jform, tform = forms32
    x0 = _start(3)
    xj = j_nlp(jform, jnp.asarray(x0))
    # the port's improve_nlp takes a batch: a batch of one
    xt = t_nlp(tform, torch.from_numpy(x0)[None])[0]
    assert xj.dtype == jnp.float32 and xt.dtype == torch.float32
    assert float(jcore.max_violation(jform, xj)) < 1e-2
    assert float(tcore.max_violation(tform, xt)) < 1e-2
