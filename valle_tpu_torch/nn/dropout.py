"""Elementwise dropout with an explicit random source: the twin of flax's
``nn.Dropout`` as the JAX package uses it (``jnp.where(keep, x / keep_prob, 0)``).

Each call draws a seed from the caller's CPU generator (so drawing does not
sync the card) and seeds a new generator on the tensor's device with it; the
same generator state gives the same mask.  The bits differ from JAX's.  Dropout is
active only in a module's ``train()`` mode, as ``deterministic=False`` is in
JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from valle_tpu_torch.ops.philox import draw_seed


def dropout(x: torch.Tensor, rate: float, rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the rest by
    1 / (1 - rate); ``rng`` is a CPU generator (torch's default when None)."""
    if rate <= 0.0:
        return x
    gen = torch.Generator(device=x.device).manual_seed(draw_seed(rng))
    keep = torch.empty(x.shape, dtype=torch.bool, device=x.device).bernoulli_(1.0 - rate,
                                                                            generator=gen)
    return torch.where(keep, x / (1.0 - rate), 0.0)


class Dropout(nn.Module):
    """``dropout`` as a module of a ``nn.Sequential`` (the prenets), active in
    train mode only."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(x, self.rate, rng) if self.training else x
