"""Token and sinusoidal positional embeddings: the twin of
``valle_tpu/nn/embedding.py``.  Parameter names follow the reference PyTorch
model (``word_embeddings.weight``, ``alpha``).  Each applies its dropout
in train mode only, from the caller's generator (nn/dropout.py).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from valle_tpu_torch.nn.dropout import dropout


def sinusoidal_table(length: int, dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Interleaved sin/cos table, shape (length, dim): sin at even, cos at odd."""
    position = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, dim, 2, dtype=torch.float32, device=device)
        * -(math.log(10000.0) / dim)
    )
    angles = position * div_term  # (length, dim//2)
    pe = torch.stack([torch.sin(angles), torch.cos(angles)], dim=-1).reshape(length, dim)
    return pe.to(dtype)


class TokenEmbedding(nn.Module):
    """Embedding table with dropout; its weight is exposed for output-layer
    tying."""

    def __init__(self, dim_model: int, vocab_size: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.word_embeddings = nn.Embedding(vocab_size, dim_model)
        nn.init.normal_(self.word_embeddings.weight, std=1.0)

    @property
    def weight(self) -> torch.Tensor:
        return self.word_embeddings.weight

    def forward(self, x: torch.Tensor, rng: Optional[torch.Generator] = None) -> torch.Tensor:
        out = self.word_embeddings(x)
        return dropout(out, self.dropout, rng) if self.training else out


class SinePositionalEmbedding(nn.Module):
    """x * x_scale + alpha * PE[positions], then dropout.

    ``alpha`` is a parameter in every instance, as in the reference model; it
    is trainable only when ``alpha=True`` (the AR decoder), and stays 1.0
    otherwise.  ``scale`` multiplies x by sqrt(dim) when True.
    """

    def __init__(self, dim_model: int, dropout: float = 0.0, scale: bool = False,
                 alpha: bool = False, max_len: int = 4096):
        super().__init__()
        self.dropout = dropout
        self.learnable_alpha = alpha
        self.x_scale = math.sqrt(dim_model) if scale else 1.0
        self.alpha = nn.Parameter(torch.ones(1), requires_grad=alpha)
        self.register_buffer("pe", sinusoidal_table(max_len, dim_model), persistent=False)

    def forward(
        self,
        x: torch.Tensor,
        offset: int = 0,
        positions: Optional[torch.Tensor] = None,
        rng: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """x: (B, T, D); offset: scalar start position; positions: optional
        explicit (B, T) int positions overriding ``offset + arange(T)``;
        rng: the CPU generator of the dropout draws."""
        if positions is not None:
            pe = self.pe[positions]  # (B, T, D)
        else:
            pe = self.pe[offset: offset + x.shape[1]][None]
        out = x * self.x_scale + self.alpha.to(x.dtype) * pe.to(x.dtype)
        return dropout(out, self.dropout, rng) if self.training else out
