"""Attention contraction routing: the twin of ``valle_tpu/ops/attention_impl.py``.

The JAX package's table is kept, with kernel 2 (ops/fused_attention.py) in
place of both Pallas callees (its own fused kernel and the library flash
kernel).  Head layout everywhere is (B, T, H, Dh).

| impl       | AttnMaskSpec, Tq > 1 | key padding (B,1,1,Tk) or none, Tq > 1 | other dense bias |
|------------|----------------------|----------------------------------------|------------------|
| "xla"      | plain math           | plain math                             | plain math       |
| "fused"    | kernel 2             | plain math                             | plain math       |
| "flash"    | kernel 2             | kernel 2 (dense mode)                  | raises on CUDA   |
| "flash_kp" | plain math           | kernel 2 (dense mode)                  | plain math       |

Decode steps (Tq = 1) take the plain math here; with ``kv_lengths`` they go
to kernel 1 before reaching this module (nn/attention.py).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from valle_tpu_torch.ops.fused_attention import fused_prefix_attention
from valle_tpu_torch.ops.masks import AttnMaskSpec


def _xla_attention(q, k, v, bias):
    """Einsum + f32 softmax, the twin of the JAX ``_xla_attention`` at
    dropout 0 (the JAX name is kept so a reader finds the counterpart)."""
    dh = q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _is_key_padding(bias: Optional[torch.Tensor]) -> bool:
    return bias is None or (bias.dim() == 4 and bias.shape[1] == 1 and bias.shape[2] == 1)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    bias: Union[None, torch.Tensor, AttnMaskSpec] = None,
    impl: str = "xla",
) -> torch.Tensor:
    """(B,Tq,H,Dh),(B,Tk,H,Dh),(B,Tk,H,Dh) -> (B,Tq,H,Dh).

    ``bias`` is a dense additive tensor broadcastable to (B, H, Tq, Tk) or an
    :class:`AttnMaskSpec` (key-validity row + static prefix split).
    """
    tq = q.shape[1]
    if isinstance(bias, AttnMaskSpec):
        if impl in ("fused", "flash") and tq > 1:
            return fused_prefix_attention(q, k, v, bias.kv_bias, prefix_s=bias.prefix_s)
        bias = bias.dense(tq)
    if impl in ("flash", "flash_kp") and tq > 1:
        if _is_key_padding(bias):
            kv_bias = None if bias is None else bias.reshape(bias.shape[0], bias.shape[-1])
            if kv_bias is not None:
                kv_bias = kv_bias.expand(q.shape[0], k.shape[1]).float().contiguous()
            return fused_prefix_attention(q, k, v, kv_bias)
        if impl == "flash" and q.is_cuda:
            raise NotImplementedError(
                "attn_impl='flash' with a dense per-query bias needs a bias input "
                "to the prefix-attention kernel (not ported yet)"
            )
    return _xla_attention(q, k, v, bias)
