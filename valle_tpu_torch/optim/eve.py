"""Eve as a ``torch.optim.Optimizer``: the twin of ``valle_tpu/optim/eve.py``
(the reference's Eve): AdamW whose weight decay multiplier
``(1 - weight_decay)`` applies only while the parameter's norm exceeds
``target_rms * sqrt(numel)``, and never to a parameter of one element.

JAX evaluates the gate per slice of a stacked layer leaf
(``batched_axis_fn``); the port holds each layer's tensors apart, so it
gates per tensor, and per row block of a tensor that packs several JAX
leaves (``row_blocks``, as ScaledAdam reads it): the cross-attention's
``q_proj`` and ``kv_proj``.  The step counter is global, as JAX's is, and
``step(lr=...)`` takes the step's learning rate from the scheduler.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import torch

from valle_tpu_torch.optim.scaled_adam import _row_blocks


class Eve(torch.optim.Optimizer):
    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float = 1e-3,
                 betas=(0.9, 0.98), eps: float = 1e-8, weight_decay: float = 1e-3,
                 target_rms: float = 0.1):
        unique = list({id(p): p for p in params}.values())
        super().__init__(unique, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      target_rms=target_rms))
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                st["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                if p.numel() > 1:
                    st["blocks"] = _row_blocks(p)
        self.state["global"] = {"step": 0}

    def _decay(self, p32: torch.Tensor, blocks, group) -> torch.Tensor:
        """``p32 * (1 - weight_decay * [norm > target_rms * sqrt(numel)])``,
        the gate per row block."""
        wd, target = group["weight_decay"], group["target_rms"]
        if len(blocks) == 1:
            above = (p32.norm() > target * math.sqrt(p32.numel())).float()
            return p32 * (1 - wd * above)
        out = torch.empty_like(p32)
        for a, b in blocks:
            blk = p32[a:b]
            above = (blk.norm() > target * math.sqrt(blk.numel())).float()
            out[a:b] = blk * (1 - wd * above)
        return out

    @torch.no_grad()
    def step(self, closure=None, lr: Optional[float] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        glob = self.state["global"]
        glob["step"] += 1  # the reference counts before use
        step = glob["step"]
        for group in self.param_groups:
            beta1, beta2 = group["betas"]
            step_size = (group["lr"] if lr is None else lr) / (1 - beta1**step)
            bc2 = 1 - beta2**step
            for p in group["params"]:
                st = self.state[p]
                p32 = p.detach().float()
                g = p.grad.float()  # train/step.py gives every parameter one
                m = st["exp_avg"].mul_(beta1).add_((1 - beta1) * g)
                v = st["exp_avg_sq"].mul_(beta2).add_((1 - beta2) * g * g)
                denom = v.sqrt() * bc2**-0.5 + group["eps"]
                new_p = p32 if p.numel() == 1 else self._decay(p32, st["blocks"], group)
                new_p = new_p - step_size * m / denom
                # JAX returns the update new_p - p and optax adds it to p:
                # the same two roundings here (p.copy_(new_p) may differ by an ulp)
                p.add_((new_p - p32).to(p.dtype))
        return loss
