"""Optimizers and learning-rate schedules of the port: the twin of
``valle_tpu/optim`` (ScaledAdam, Eve; Eden, Noam, Cosine), and the plain
Adam / AdamW of the training CLI at a constant rate (``adam.py``)."""

from valle_tpu_torch.optim.adam import ConstantLrAdam, ConstantLrAdamW
from valle_tpu_torch.optim.eve import Eve
from valle_tpu_torch.optim.scaled_adam import ScaledAdam
from valle_tpu_torch.optim.schedulers import cosine_lr, eden_lr, get_lr_fn, noam_lr

__all__ = ["ConstantLrAdam", "ConstantLrAdamW", "Eve", "ScaledAdam", "eden_lr", "noam_lr",
           "cosine_lr", "get_lr_fn"]
