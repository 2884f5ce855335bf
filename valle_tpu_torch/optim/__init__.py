"""Optimizers and learning-rate schedules of the port: the twin of
``valle_tpu/optim`` (Eve and plain Adam/AdamW are not ported yet)."""

from valle_tpu_torch.optim.scaled_adam import ScaledAdam
from valle_tpu_torch.optim.schedulers import cosine_lr, eden_lr, get_lr_fn, noam_lr

__all__ = ["ScaledAdam", "eden_lr", "noam_lr", "cosine_lr", "get_lr_fn"]
