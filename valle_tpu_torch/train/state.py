"""Training state: the model, its optimizer, the averaged model and the step
counter — the twin of ``valle_tpu/train/state.py``.

The JAX state holds an immutable parameter tree; here the state holds the
``nn.Module`` itself, whose parameters the optimizer updates in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int  # global batch index (batch_idx_train)
    model: nn.Module
    optimizer: torch.optim.Optimizer
    model_avg: Optional[Dict[str, torch.Tensor]] = None  # running f32 average


def stage_prefix(train_stage: int) -> Optional[str]:
    """Parameter-name prefix trained at this stage (None = every parameter)."""
    return {0: None, 1: "ar_", 2: "nar_"}[train_stage]


def _learnable(model: nn.Module, name: str) -> bool:
    """False for the fixed alpha (1.0) of the NAR positional embeddings, which
    the JAX model does not hold as a parameter at all."""
    owner, _, leaf = name.rpartition(".")
    return not (leaf == "alpha" and not getattr(model.get_submodule(owner), "learnable_alpha",
                                                True))


def partition_params(model: nn.Module, train_stage: int
                     ) -> Tuple[Dict[str, nn.Parameter], Dict[str, nn.Parameter]]:
    """(trainable, frozen) parameters by top-level name at this stage; a tied
    parameter appears once, under its first name."""
    prefix = stage_prefix(train_stage)
    train, frozen = {}, {}
    for name, p in model.named_parameters(remove_duplicate=True):
        ok = _learnable(model, name) and (prefix is None or name.startswith(prefix))
        (train if ok else frozen)[name] = p
    return train, frozen


def update_model_avg(model_avg: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
                     step: int, average_period: int) -> Dict[str, torch.Tensor]:
    """Running model average, icefall-style, in place:
        avg <- avg * (1 - w) + params * w,  w = average_period / step (at most 1)."""
    w = min(float(average_period) / max(float(step), 1.0), 1.0)
    with torch.no_grad():
        for name, avg in model_avg.items():
            avg.copy_(avg * (1.0 - w) + params[name].to(avg.dtype) * w)
    return model_avg
