"""ScaledAdam as a ``torch.optim.Optimizer``: the twin of
``valle_tpu/optim/scaled_adam.py`` (icefall's ScaledAdam):

  - per-tensor updates scaled by the parameter's RMS, with a learned
    log-scale ("size") updated every ``size_update_period`` steps;
  - median-based clipping over a window of ``clipping_update_period``
    whole-model gradient norms;
  - parameters of one element take plain Adam with ``scalar_lr_scale`` and
    clamping.

The port holds every layer and every NAR table as a tensor of its own, as
the reference model does, so per-tensor statistics are what the JAX package
computes per slice of its stacked leaves (``valle_batched_axis``).  A
parameter that packs several JAX leaves along dim 0 says so with a
``row_blocks`` attribute (the block sizes), and each block keeps its own RMS,
size statistics and clipping-norm term: the cross-attention
``in_proj_weight`` / ``in_proj_bias`` hold JAX's ``q_proj`` and ``kv_proj``
(``nn/attention.py``).  The attribute is read when the optimizer is built
(``copy.deepcopy`` of a parameter drops it).  Tied parameters (the NAR
prediction layers and embedding tables) are one tensor and are updated once:
the parameter list is de-duplicated.  The dominant-parameter log of the JAX
optimizer is not ported.

The step counter lives on the host, so the size update and the clipping
window are host decisions; the clipping factor stays on the device (no
sync).  ``step(lr=...)`` takes the learning rate of the step, as the JAX
``update(..., lr=...)`` does, for Eden's epoch dependence.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

import torch


def _row_blocks(p: torch.Tensor):
    """(start, end) rows of ``p`` that keep statistics of their own: the whole
    tensor, or the blocks of its ``row_blocks`` sizes."""
    sizes = getattr(p, "row_blocks", None) or (p.shape[0],)
    if sum(sizes) != p.shape[0]:
        raise ValueError(f"row_blocks {sizes} do not cover the {p.shape[0]} rows")
    starts = [sum(sizes[:i]) for i in range(len(sizes))]
    return [(a, a + n) for a, n in zip(starts, sizes)]


def _per_block(x: torch.Tensor, blocks, fn) -> torch.Tensor:
    """(n_blocks,) of ``fn`` over each row block of ``x``; a view of the one
    result for a single block, so an unblocked tensor launches no copy."""
    if len(blocks) == 1:
        return fn(x).reshape(1)
    return torch.stack([fn(x[a:b]) for a, b in blocks])


def _rms(x: torch.Tensor) -> torch.Tensor:
    return x.pow(2).mean().sqrt()


def _to_rows(stat: torch.Tensor, blocks, ndim: int) -> torch.Tensor:
    """A per-block statistic (n_blocks,), broadcastable against the parameter."""
    if len(blocks) == 1:
        return stat
    rows = torch.cat([stat[i:i + 1].expand(b - a) for i, (a, b) in enumerate(blocks)])
    return rows.view(-1, *([1] * (ndim - 1)))


class ScaledAdam(torch.optim.Optimizer):
    def __init__(
        self,
        params: Iterable[torch.nn.Parameter],
        lr: float = 0.05,
        clipping_scale: Optional[float] = 2.0,
        betas=(0.9, 0.95),
        scalar_lr_scale: float = 0.1,
        eps: float = 1e-8,
        param_min_rms: float = 1e-5,
        param_max_rms: float = 3.0,
        scalar_max: float = 10.0,
        size_update_period: int = 4,
        clipping_update_period: int = 100,
    ):
        unique, seen = [], set()
        for p in params:
            if id(p) not in seen:
                seen.add(id(p))
                unique.append(p)
        defaults = dict(lr=lr, betas=betas, scalar_lr_scale=scalar_lr_scale, eps=eps,
                        param_min_rms=param_min_rms, param_max_rms=param_max_rms,
                        scalar_max=scalar_max, size_update_period=size_update_period,
                        clipping_scale=clipping_scale,
                        clipping_update_period=clipping_update_period)
        super().__init__(unique, defaults)
        for group in self.param_groups:
            for p in group["params"]:
                self._init_param(p, group["size_update_period"])
        self.state["global"] = {
            "step": 0,
            "model_norms": torch.zeros(clipping_update_period, device=unique[0].device),
            "norm_threshold": torch.full((), math.inf, device=unique[0].device),
        }

    def _init_param(self, p: torch.Tensor, sup: int) -> None:
        st = self.state[p]
        st["delta"] = torch.zeros_like(p, dtype=torch.float32)
        st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
        if p.numel() > 1:
            blocks = st["blocks"] = _row_blocks(p)
            st["param_rms"] = _per_block(p.detach().float(), blocks, _rms)
            st["scale_exp_avg_sq"] = torch.zeros(len(blocks), device=p.device)
            st["scale_grads"] = torch.zeros(sup, len(blocks), device=p.device)

    def _clipping(self, params, step: int) -> Optional[torch.Tensor]:
        """The whole-model clipping factor (None = 1): the norm of the
        RMS-scaled gradients against 2x the median of the window."""
        clipping_scale = self.defaults["clipping_scale"]
        if clipping_scale is None:
            return None
        glob = self.state["global"]
        grads, rms = [], []
        one = torch.ones(1, device=params[0].device)
        for p in params:
            g = p.grad.float()
            if p.numel() == 1:
                grads.append(g)
                rms.append(one)
            else:
                st = self.state[p]
                grads += [g[a:b] for a, b in st["blocks"]]
                rms.append(st["param_rms"])
        norms = torch.stack(torch._foreach_norm(grads))
        tot_norm = (norms * torch.cat(rms)).pow(2).sum().sqrt()
        cup = self.defaults["clipping_update_period"]
        if step > 0:
            glob["model_norms"][step % cup] = tot_norm
        if step > 0 and step % cup == 0:
            median = torch.sort(glob["model_norms"]).values[(cup // 4) * 2]
            glob["norm_threshold"] = clipping_scale * median
        if step < cup:
            return None
        return (glob["norm_threshold"] / (tot_norm + 1e-20)).clamp(max=1.0)

    @torch.no_grad()
    def step(self, closure=None, lr: Optional[float] = None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        glob = self.state["global"]
        step = glob["step"]
        params = [p for g in self.param_groups for p in g["params"] if p.grad is not None]
        clip = self._clipping(params, step) if params else None
        for group in self.param_groups:
            group_lr = group["lr"] if lr is None else lr
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, group, group_lr, step, clip)
        glob["step"] = step + 1
        return loss

    def _update(self, p, group, lr: float, step: int, clip) -> None:
        beta1, beta2 = group["betas"]
        eps, min_rms = group["eps"], group["param_min_rms"]
        st = self.state[p]
        p32 = p.detach().float()
        g = p.grad.float()
        if clip is not None:
            g = g * clip
        delta = st["delta"] * beta1
        eas = beta2 * st["exp_avg_sq"] + (1 - beta2) * g * g
        st["exp_avg_sq"] = eas
        bc2 = 1 - beta2 ** (step + 1)

        if p.numel() == 1:  # plain Adam, clamped before the add
            denom = (eas / bc2).sqrt() + eps
            delta = delta + (-lr * group["scalar_lr_scale"] * (1 - beta1)) * (g / denom)
            st["delta"] = delta
            new_p = p32.clamp(-group["scalar_max"], group["scalar_max"]) + delta
            p.copy_(p32 + (new_p - p32))
            return

        sup = group["size_update_period"]
        blocks = st["blocks"]
        st["scale_grads"][step % sup] = _per_block(p32 * g, blocks, torch.sum)
        prms = st["param_rms"]
        if step % sup == sup - 1:
            prms = st["param_rms"] = _per_block(p32, blocks, _rms)
            if step > 0:  # the size (log-scale) update
                sgr = st["scale_grads"]
                beta2c = beta2**sup
                seas = beta2c * st["scale_exp_avg_sq"] + (1 - beta2c) * sgr.pow(2).mean(0)
                st["scale_exp_avg_sq"] = seas
                bc2s = 1 - beta2c ** ((step + 1) // sup)
                size_lr = lr * group["scalar_lr_scale"]
                scale_step = -size_lr * math.sqrt(bc2s) * sgr.sum(0) / (seas.sqrt() + eps)
                scale_step = torch.where(prms < min_rms, 0.0, scale_step)
                scale_step = torch.where(prms > group["param_max_rms"], -size_lr * sup, scale_step)
                delta = delta + (1 - beta1) * _to_rows(scale_step, blocks, p.dim()) * p32
        denom = (eas / bc2 if bc2 < 0.99 else eas).sqrt() + eps
        alpha = -lr * (1 - beta1) * prms.clamp(min=min_rms)
        delta = delta + (g / denom) * _to_rows(alpha, blocks, p.dim())
        st["delta"] = delta
        p.add_(delta.to(p.dtype))
