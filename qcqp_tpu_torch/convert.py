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

# save_state fields that belong to slices not ported yet (SDR / spectral
# suggest, ROADMAP.md Queue 1 item 6) and the JAX PRNG key, whose stream
# torch.Generator cannot reproduce.
_SKIPPED = ("key", "sdr_sol", "sdr_bound", "mu", "sigma_chol",
            "spectral_sol", "spectral_bound")


def form_from_numpy(P, q, r, is_eq, device=None, dtype=None) -> QCQPForm:
    """A QCQPForm from the JAX package's form as numpy arrays, without
    re-symmetrizing (the JAX form already is), so both packages compute on
    bit-identical data.  device: core.default_device()."""
    device = default_device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    return QCQPForm(
        torch.tensor(np.asarray(P), dtype=dtype, device=device),
        torch.tensor(np.asarray(q), dtype=dtype, device=device),
        torch.tensor(np.asarray(r), dtype=dtype, device=device),
        torch.tensor(np.asarray(is_eq, dtype=bool), device=device))


def load_jax_state(npz_path: str, handler) -> None:
    """Load the variable values `x` of a JAX handler's saved state into a
    qcqp_tpu_torch handler.  The PRNG key and the SDR/spectral caches are
    skipped with a logged note: they belong to later slices."""
    if not npz_path.endswith(".npz"):
        npz_path = npz_path + ".npz"
    with np.load(npz_path) as z:
        skipped = [k for k in _SKIPPED if k in z.files]
        if skipped:
            logger.info("load_jax_state: skipping %s (JAX PRNG key and "
                        "SDR/spectral caches belong to later slices of the "
                        "port)", ", ".join(skipped))
        if "x" in z.files:
            handler.layout.assign(z["x"])
