"""Carry problem data and handler state across from the JAX package.

Nothing here imports JAX: the JAX package's objects cross as numpy arrays
(`np.asarray(form.P)`, ...) or as the .npz file that
`qcqp_tpu.api.QCQP.save_state` writes (qcqp_tpu/api.py:249-270).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .core import QCQPForm, default_device, default_dtype

logger = logging.getLogger("qcqp_tpu_torch")


def form_from_numpy(P, q, r, is_eq, device=None, dtype=None) -> QCQPForm:
    """A QCQPForm from the JAX package's form as numpy arrays, without
    re-symmetrizing (the JAX form already is), so both packages compute on
    bit-identical data.  device: core.default_device() (the current CUDA
    device; without a card the caller must name the CPU)."""
    device = default_device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    return QCQPForm(
        torch.tensor(np.asarray(P), dtype=dtype, device=device),
        torch.tensor(np.asarray(q), dtype=dtype, device=device),
        torch.tensor(np.asarray(r), dtype=dtype, device=device),
        torch.tensor(np.asarray(is_eq, dtype=bool), device=device))


def load_jax_state(npz_path: str, handler) -> None:
    """Load a JAX handler's saved state into a qcqp_tpu_torch handler: the
    variable values `x`, the SDR cache (sdr_sol, sdr_bound, mu, sigma_chol)
    and the spectral cache (spectral_sol, spectral_bound), so the handler
    suggests from the same relaxations without re-solving them.  The JAX
    PRNG key, whose stream torch.Generator cannot reproduce, is skipped
    with a logged note."""
    if not npz_path.endswith(".npz"):
        npz_path = npz_path + ".npz"
    with np.load(npz_path) as z:
        if "key" in z.files:
            logger.info("load_jax_state: skipping key")
        handler._load_relaxations(z)
        if "x" in z.files:
            handler.layout.assign(z["x"])
