"""Learning-rate schedules: Eden, Noam, Cosine — the twin of
``valle_tpu/optim/schedulers.py``.

Eden:  lr = base_lr * ((batch^2 + B^2) / B^2)^-0.25
                    * ((epoch^2 + E^2) / E^2)^-0.25 * warmup,
with warmup rising linearly 0.5 -> 1 over ``warmup_batches``.  The values
are Python floats: the step counter and the epoch live on the host.
"""

from __future__ import annotations

import math


def eden_lr(base_lr, batch, epoch, lr_batches: float = 5000.0, lr_epochs: float = 4.0,
            warmup_batches: float = 500.0) -> float:
    batch, epoch = float(batch), float(epoch)
    factor = ((batch**2 + lr_batches**2) / lr_batches**2) ** -0.25 * (
        (epoch**2 + lr_epochs**2) / lr_epochs**2
    ) ** -0.25
    warmup = 1.0 if batch >= warmup_batches else 0.5 + 0.5 * (batch / warmup_batches)
    return base_lr * factor * warmup


def noam_lr(base_lr, step, dim_embed: int, warmup_steps: float) -> float:
    step = max(float(step), 1.0)
    return base_lr * dim_embed**-0.5 * min(step**-0.5, step * warmup_steps**-1.5)


def cosine_lr(base_lr, step, total_steps, eta_min: float = 0.0) -> float:
    t = min(max(float(step) / total_steps, 0.0), 1.0)
    return eta_min + (base_lr - eta_min) * 0.5 * (1 + math.cos(math.pi * t))


def get_lr_fn(scheduler_name: str, base_lr: float, *, decoder_dim: int = 1024,
              warmup_steps: float = 200.0, total_steps: float = 1e6):
    """Returns lr(batch, epoch)."""
    name = scheduler_name.lower()
    if name == "eden":
        return lambda batch, epoch: eden_lr(base_lr, batch, epoch, 5000.0, 4.0, warmup_steps)
    if name == "noam":
        return lambda batch, epoch: noam_lr(base_lr, batch, decoder_dim, warmup_steps)
    if name == "cosine":
        return lambda batch, epoch: cosine_lr(base_lr, batch, total_steps)
    raise NotImplementedError(scheduler_name)
