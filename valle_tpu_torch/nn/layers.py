"""Transformer layers: the twin of ``valle_tpu/nn/layers.py``.

Prefix-LM / decoder layer (pre- or post-norm, optional VALL-F
cross-attention), adaptive layer norm for NAR stage conditioning, and the
layer stack.  The JAX stack is one ``nn.scan`` over stacked parameters; here
it is an ``nn.ModuleList`` walked in Python, and a decode cache stacked over
layers is indexed by layer.

Parameter names follow the reference PyTorch model: ``norm1``, ``norm2``
(``norm2`` gates cross-attention and ``norm3`` the feed-forward block in a
VALL-F layer), ``self_attn``, ``multihead_attn``, ``linear1``, ``linear2``,
and ``layers.{i}`` / ``norm`` in the stack.

``dtype`` is the compute dtype of the JAX modules (flax's ``dtype``, with
f32 ``param_dtype``): the norms compute in f32 and return that dtype, and
the projections cast their inputs to it, so that in bf16 the residual
stream stays f32 as JAX's does (the embeddings are f32 there).  None keeps
every tensor in its own dtype.

Dropout sits where the JAX layer puts it: on the attention probabilities,
after each attention block (``sa_drop``, ``ca_drop``), after the feed-forward
activation (``ff_drop``) and after its output (``ff_out_drop``), all at the
layer's rate, in train mode only, drawn from the ``rng`` of ``forward``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from valle_tpu_torch.nn.attention import MultiheadAttention
from valle_tpu_torch.nn.dropout import dropout as _dropout
from valle_tpu_torch.nn.qdense import Dense


class StageLayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that takes (and ignores) the stage embedding, so every
    norm of a layer is called the same way.  With ``dtype`` it normalises in
    f32 and returns ``dtype``, as flax's ``LayerNorm(dtype=...)`` does."""

    def __init__(self, d_model: int, eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__(d_model, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, stage_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.compute_dtype is None or x.dtype == self.weight.dtype == self.compute_dtype:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(self.compute_dtype)


class AdaptiveLayerNorm(nn.Module):
    """weight * LayerNorm(x) + bias, with (weight, bias) projected from the
    stage embedding."""

    def __init__(self, d_model: int, eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.d_model = d_model
        self.project_layer = Dense(d_model, 2 * d_model, dtype=dtype)
        self.norm = StageLayerNorm(d_model, eps=eps, dtype=dtype)

    def forward(self, x: torch.Tensor, stage_emb: torch.Tensor) -> torch.Tensor:
        weight, bias = self.project_layer(stage_emb).split(self.d_model, dim=-1)
        return weight * self.norm(x) + bias


def conditioned_norm(d_model: int, adaptive: bool = False, eps: float = 1e-5,
                     norm_type: str = "layer", dtype: Optional[torch.dtype] = None) -> nn.Module:
    """The norm that the JAX ``ConditionedNorm`` computes: a layer norm, or
    an adaptive one for NAR stage conditioning.  A factory rather than a
    wrapper module, so the parameter names stay the reference's
    (``norm1.weight``, ``norm1.project_layer.weight``).  The ``identity`` and
    ``balanced_basic`` norms of the scaling_xformers layout need
    ``nn/scaling.py``, which is not ported yet."""
    if norm_type != "layer":
        raise NotImplementedError(f"norm_type {norm_type!r} needs nn/scaling.py, not ported yet")
    if adaptive:
        return AdaptiveLayerNorm(d_model, eps, dtype)
    return StageLayerNorm(d_model, eps=eps, dtype=dtype)


class TransformerLayer(nn.Module):
    """One decoder block with a ReLU feed-forward block.  ``cross_attention``
    adds an encoder-memory attention sub-block between self-attention and the
    FFN (VALL-F).  The other activations and norms of the JAX layer serve the
    scaling_xformers layout, which is not ported yet."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 norm_first: bool = True, adaptive_norm: bool = False,
                 cross_attention: bool = False, attn_impl: str = "xla",
                 act_quant: bool = False, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.norm_first = norm_first
        self.cross_attention = cross_attention
        self.dropout = dropout
        attn = dict(attn_impl=attn_impl, act_quant=act_quant, dropout=dropout, dtype=dtype)
        self.self_attn = MultiheadAttention(d_model, nhead, **attn)
        self.linear1 = Dense(d_model, dim_feedforward, act_quant=act_quant, dtype=dtype)
        self.linear2 = Dense(dim_feedforward, d_model, act_quant=act_quant, dtype=dtype)
        self.norm1 = conditioned_norm(d_model, adaptive_norm, dtype=dtype)
        self.norm2 = conditioned_norm(d_model, adaptive_norm, dtype=dtype)
        if cross_attention:
            self.multihead_attn = MultiheadAttention(d_model, nhead, cross_attention=True,
                                                     **attn)
            self.norm3 = conditioned_norm(d_model, adaptive_norm, dtype=dtype)

    def forward(self, x, *, stage_emb=None, attn_bias=None, memory=None,
                memory_bias=None, kv_cache=None, cache_index=None,
                kv_lengths=None, return_kv=False, rng=None):
        """Returns (x, new_cache_or_None, kv_or_None)."""
        norm_ff = self.norm3 if self.cross_attention else self.norm2
        rate = self.dropout if self.training else 0.0

        def drop(h):
            return _dropout(h, rate, rng)

        def ff_block(h):
            return drop(self.linear2(drop(F.relu(self.linear1(h)))))

        def sa_block(h):
            out, new_cache, kv = self.self_attn(
                h, attn_bias=attn_bias, kv_cache=kv_cache, cache_index=cache_index,
                kv_lengths=kv_lengths, return_kv=return_kv, rng=rng)
            return drop(out), new_cache, kv

        def ca_block(h):
            return drop(self.multihead_attn(h, memory, attn_bias=memory_bias, rng=rng)[0])

        if self.norm_first:
            h, new_cache, kv = sa_block(self.norm1(x, stage_emb))
            x = x + h
            if self.cross_attention:
                x = x + ca_block(self.norm2(x, stage_emb))
            x = x + ff_block(norm_ff(x, stage_emb))
        else:
            h, new_cache, kv = sa_block(x)
            x = self.norm1(x + h, stage_emb)
            if self.cross_attention:
                x = self.norm2(x + ca_block(x), stage_emb)
            x = norm_ff(x + ff_block(x), stage_emb)
        return x, new_cache, kv


class TransformerStack(nn.Module):
    """N TransformerLayers plus the optional final (adaptive) norm."""

    def __init__(self, num_layers: int, d_model: int, nhead: int, dim_feedforward: int,
                 norm_first: bool = True, adaptive_norm: bool = False,
                 cross_attention: bool = False, final_norm: bool = True,
                 attn_impl: str = "xla", act_quant: bool = False, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerLayer(d_model, nhead, dim_feedforward, norm_first=norm_first,
                             adaptive_norm=adaptive_norm, cross_attention=cross_attention,
                             attn_impl=attn_impl, act_quant=act_quant, dropout=dropout,
                             dtype=dtype)
            for _ in range(num_layers)
        )
        self.norm = (conditioned_norm(d_model, adaptive_norm, dtype=dtype)
                     if final_norm and norm_first else None)

    def forward(self, x, kv_cache=None, *, stage_emb=None, attn_bias=None, memory=None,
                memory_bias=None, cache_index=None, kv_lengths=None, return_kv=False,
                rng=None):
        """kv_cache: a stacked decode cache, (kc, vc) or (kc, vc, ks, vs) with
        a leading layer axis, updated in place.

        Returns (x, new_cache_or_None, kv) where kv is the stacked
        (k, v) of shape (L, B, T, H, Dh) when ``return_kv``, else None."""
        ks, vs = [], []
        for i, layer in enumerate(self.layers):
            x, _, kv = layer(
                x, stage_emb=stage_emb, attn_bias=attn_bias, memory=memory,
                memory_bias=memory_bias,
                kv_cache=None if kv_cache is None else (*kv_cache, i),
                cache_index=cache_index, kv_lengths=kv_lengths, return_kv=return_kv, rng=rng,
            )
            if return_kv:
                ks.append(kv[0])
                vs.append(kv[1])
        if self.norm is not None:
            x = self.norm(x, stage_emb)
        kv = (torch.stack(ks), torch.stack(vs)) if return_kv else None
        return x, kv_cache, kv
