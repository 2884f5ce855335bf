"""Mask construction for padded batches: the twin of ``valle_tpu/ops/masks.py``.

Convention (as in the JAX package): ``True`` means MASKED (disallowed).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NEG = -1e9  # finite mask value: fully-masked rows give uniform probs, not NaN


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) bool, True at padding positions."""
    pos = torch.arange(max_len, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] >= lengths[:, None]


def causal_mask(t: int, device=None) -> torch.Tensor:
    """(t, t) bool, True strictly above the diagonal (future positions)."""
    idx = torch.arange(t, device=device)
    return idx[None, :] > idx[:, None]


def prefix_lm_attn_mask(s: int, t: int, device=None) -> torch.Tensor:
    """(s+t, s+t) bool structural mask of the [text ; audio] prefix-LM decoder.

    Text rows attend only to text columns; audio rows attend to all text
    columns plus causally to audio columns.
    """
    idx = torch.arange(s + t, device=device)
    row, col = idx[:, None], idx[None, :]
    text_row, text_col = row < s, col < s
    masked_text_rows = text_row & ~text_col
    masked_audio_rows = ~text_row & ~text_col & (col > row)
    return masked_text_rows | masked_audio_rows


def merge_padding(attn_mask: torch.Tensor, key_padding: torch.Tensor) -> torch.Tensor:
    """OR a (T, T) structural mask with a (B, T) key-padding mask -> (B, 1, T, T)."""
    return attn_mask[None, None, :, :] | key_padding[:, None, None, :]


def mask_to_bias(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """bool mask (True=masked) -> additive bias: -1e9 where masked, else 0."""
    return torch.where(
        mask,
        torch.tensor(NEG, dtype=dtype, device=mask.device),
        torch.tensor(0.0, dtype=dtype, device=mask.device),
    )


@dataclasses.dataclass(frozen=True)
class AttnMaskSpec:
    """Structured attention mask: a per-sequence key-validity bias row plus a
    static prefix-LM split, instead of a materialized (B, H, Tq, Tk) bias.

    kv_bias: (B, Tk) f32, 0 = visible column, -1e9 = masked column.
    prefix_s: None = key padding only (NAR / cross-attention); an int s >= 0
      adds the [text ; audio] prefix-LM structural mask (s=0 is causal).

    The prefix-attention kernel (ops/fused_attention.py) reads the two parts
    directly; every other path densifies through :meth:`dense`.
    """

    kv_bias: torch.Tensor
    prefix_s: Optional[int] = None

    def dense(self, tq: int) -> torch.Tensor:
        """Materialize the (B, 1, Tq, Tk) additive bias (structural and key
        masks add, so a column masked by both holds -2e9)."""
        b, tk = self.kv_bias.shape
        bias = self.kv_bias[:, None, None, :].expand(b, 1, tq, tk)
        if self.prefix_s is not None:
            struct = prefix_lm_attn_mask(
                self.prefix_s, tk - self.prefix_s, device=self.kv_bias.device
            )[:tq]
            bias = bias + mask_to_bias(struct, bias.dtype)[None, None, :, :]
        return bias
