"""Attention contraction routing: the twin of ``valle_tpu/ops/attention_impl.py``.

The JAX package's table is kept, with kernel 2 (ops/fused_attention.py) in
place of its own fused kernel and of the library flash kernel's key-padding
branch, and kernel 4 (ops/flash_attention.py) in place of the library flash
kernel's dense-bias branch.  Head layout everywhere is (B, T, H, Dh).

| impl       | AttnMaskSpec, Tq > 1 | key padding (B,1,1,Tk) or none, Tq > 1 | other dense bias, Tq > 1 |
|------------|----------------------|----------------------------------------|--------------------------|
| "xla"      | plain math           | plain math                             | plain math               |
| "fused"    | kernels 2/3          | plain math                             | plain math               |
| "flash"    | kernels 2/3          | kernels 2/3 (dense mode)               | kernel 4                 |
| "flash_kp" | plain math           | kernels 2/3 (dense mode)               | plain math               |

Kernel 4 computes ``softmax((q kᵀ + bias) * scale) v`` (the library's order)
where the plain math computes ``softmax(q * scale kᵀ + bias) v`` (JAX's
``_xla_attention``); the two agree to rounding for {0, -1e9} masks.  Every
kernel runs its plain PyTorch version on a CPU tensor.

With dropout active, "fused" keeps its kernels (kernel 2 draws the dropout
bits itself) and "flash" / "flash_kp" take the plain math with dropout, as
the JAX package sends the library flash kernel, which has no dropout, to XLA.
Every route draws its keep bits from Philox with a seed taken from the
caller's CPU generator (ops/philox.py), so the plain math and the kernels drop
the same probabilities for the same seed.

Decode steps (Tq = 1) take the plain math here; with ``kv_lengths`` they go
to kernel 1 before reaching this module (nn/attention.py).
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

from valle_tpu_torch.ops.flash_attention import flash_attention_biased
from valle_tpu_torch.ops.fused_attention import fused_prefix_attention
from valle_tpu_torch.ops.masks import AttnMaskSpec
from valle_tpu_torch.ops.philox import draw_seed, dropout_keep_mask


def _xla_attention(q, k, v, bias, dropout_rate: float = 0.0, dropout_seed: Optional[int] = None):
    """Einsum + f32 softmax (+ dropout on the probabilities), the twin of the
    JAX ``_xla_attention`` (the JAX name is kept so a reader finds the
    counterpart); its ``jax.random.bernoulli`` mask is the Philox mask of
    ``dropout_seed`` here."""
    dh = q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k)
    if bias is not None:
        logits = logits + bias.to(logits.dtype)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if dropout_rate > 0.0 and dropout_seed is not None:
        b, h, tq, tk = probs.shape
        keep = dropout_keep_mask(dropout_seed, b, h, tq, tk, dropout_rate, device=q.device)
        probs = probs * keep.to(probs.dtype) / (1.0 - dropout_rate)
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
    dropout_rate: float = 0.0,
    rng: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """(B,Tq,H,Dh),(B,Tk,H,Dh),(B,Tk,H,Dh) -> (B,Tq,H,Dh).

    ``bias`` is a dense additive tensor broadcastable to (B, H, Tq, Tk) or an
    :class:`AttnMaskSpec` (key-validity row + static prefix split).
    A ``dropout_rate`` above 0 drops attention probabilities (the caller
    passes 0 outside training); the seed of the keep bits is drawn from
    ``rng`` (a CPU generator; torch's default one when None).
    """
    tq = q.shape[1]
    dropping = dropout_rate > 0.0
    seed = draw_seed(rng) if dropping else None
    if isinstance(bias, AttnMaskSpec):
        if tq > 1 and (impl == "fused" or (impl == "flash" and not dropping)):
            return fused_prefix_attention(q, k, v, bias.kv_bias, prefix_s=bias.prefix_s,
                                          dropout_rate=dropout_rate, dropout_seed=seed)
        bias = bias.dense(tq)
    if impl in ("flash", "flash_kp") and tq > 1 and not dropping:
        if _is_key_padding(bias):
            kv_bias = None if bias is None else bias.reshape(bias.shape[0], bias.shape[-1])
            if kv_bias is not None:
                kv_bias = kv_bias.expand(q.shape[0], k.shape[1]).float().contiguous()
            return fused_prefix_attention(q, k, v, kv_bias)
        if impl == "flash" and bias.dim() == 4:
            return flash_attention_biased(q, k, v, bias)
    return _xla_attention(q, k, v, bias, dropout_rate, seed)
