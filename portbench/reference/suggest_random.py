"""The reference of the RANDOM suggest: standard normal starts
(qcqp/qcqp.py:381-382), drawn on the device from a torch.Generator
seeded with the solve's seed."""

import torch


def draw(form, num: int, seed: int, dtype, device) -> torch.Tensor:
    """num starts (num, n)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((num, form.n), generator=gen, dtype=dtype,
                       device=device)
