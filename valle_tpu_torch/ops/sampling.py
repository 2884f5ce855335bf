"""Top-k / top-p filtering and categorical sampling: the twin of
``valle_tpu/ops/sampling.py``, with a ``torch.Generator`` in place of the JAX
key.  The filtered logits equal the JAX ones exactly; the random stream
differs, so only ``top_k=1`` (greedy) sampling is comparable token by token.
"""

from __future__ import annotations

from typing import Optional

import torch

FILTER_VALUE = -1e9  # finite stand-in for -inf (keeps softmax NaN-free)


def top_k_top_p_filtering(
    logits: torch.Tensor,
    top_k: int = 0,
    top_p: float = 1.0,
    filter_value: float = FILTER_VALUE,
    min_tokens_to_keep: int = 1,
) -> torch.Tensor:
    """Filter (..., V) logits; top_k/top_p are Python values."""
    v = logits.shape[-1]
    if top_k > 0:
        k = min(max(top_k, min_tokens_to_keep), v)
        kth = torch.topk(logits, k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, filter_value)
    if top_p < 1.0:
        sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True, stable=True)
        cum_probs = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        remove = cum_probs > top_p
        if min_tokens_to_keep > 1:
            remove[..., :min_tokens_to_keep] = False
        # shift right: always keep the first token above the threshold
        remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]], dim=-1)
        remove_orig = torch.zeros_like(remove).scatter(-1, sort_idx, remove)
        logits = logits.masked_fill(remove_orig, filter_value)
    return logits


def topk_sampling(
    logits: torch.Tensor,
    top_k: int = 10,
    top_p: float = 1.0,
    temperature: float = 1.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sample one token per row of (..., V) logits by the Gumbel-max trick
    (as ``jax.random.categorical`` does).  Returns (...,) int64."""
    if temperature != 1.0:
        logits = logits / temperature
    logits = top_k_top_p_filtering(logits, top_k=top_k, top_p=top_p).float()
    u = torch.rand(
        logits.shape, generator=generator, device=logits.device, dtype=torch.float32
    )
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1)
