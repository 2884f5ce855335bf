"""Plain Adam and AdamW as the JAX training CLI builds them
(``valle_tpu/bin/train.py::make_optimizer``): optax's ``adam`` / ``adamw``
behind a wrapper that drops the scheduler's learning rate, so they run at a
constant ``lr`` (``--base-lr``) while the logged ``lr`` follows the
scheduler.  ``torch.optim.Adam`` / ``AdamW`` compute the same update
(AdamW's decay ``lr * weight_decay * p``, on every parameter, as optax's
without a mask); ``step(lr=...)`` takes the train step's rate and ignores
it.  The reference schedules these optimizers; the JAX package, the oracle
of the port, does not.
"""

from __future__ import annotations

from typing import Optional

import torch


class ConstantLrAdam(torch.optim.Adam):
    def step(self, closure=None, lr: Optional[float] = None):
        return super().step(closure)


class ConstantLrAdamW(torch.optim.AdamW):
    def step(self, closure=None, lr: Optional[float] = None):
        return super().step(closure)
