"""Multi-head attention with a packed in-projection and a stacked KV cache:
the twin of ``valle_tpu/nn/attention.py``.

Parameter names follow the reference PyTorch model: one packed
``in_proj_weight`` (3D, D) and ``in_proj_bias`` (also for cross-attention,
which slices q from the first D rows and k, v from the rest) and an
``out_proj`` linear.  The JAX cross-attention keeps those rows as two leaves,
``q_proj`` and ``kv_proj``; a cross-attention module marks its packed
parameters with ``row_blocks = (D, 2D)`` so that ScaledAdam keeps statistics
per block, as JAX does per leaf (``optim/scaled_adam.py``).

Decode caches are stacked over layers, as in the JAX package:
``(kc, vc, ks, vs, layer)`` for the int8 cache with per-(token, head) f32
scales, ``(kc, vc, layer)`` for a cache in the model dtype, with kc/vc of
shape (L, B, C, H, Dh).  Unlike JAX, the port writes the new column into the
cache in place (no copy of the cache per step) and returns the same tensors.
``cache_index`` is one column for every slot (an int), or a (B,) tensor of
per-slot columns (continuous batching, ``sample/continuous.py``): slot b
writes its K/V, and its scales, at its own column ``cache_index[b]``.

The projections go through ``nn/qdense.py``: ``dtype`` is the compute dtype
that their inputs are cast to, and ``in_proj_weight`` may be int8 with f32
row scales ``in_proj_weight_scale`` (W8, or W8A8 under ``act_quant``).

Attention-probability dropout (``dropout``) is active in train mode only;
its seeds are drawn from the ``rng`` generator of ``forward``.

Under tensor parallelism (``shard_heads_``, from ``parallel/mesh.py``) a
module keeps the heads of its model shard: the q, k and v rows of those
heads of the packed in-projection (so rank t of T does not take JAX's
literal split of the packed kernel's last axis, which under GSPMD is
placement only), their bias and int8 row scales, and the matching input
columns of ``out_proj``, whose partial outputs are summed over the model
group.  Its caches and kernel launches then hold the local heads only.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from valle_tpu_torch.nn.qdense import Dense, Int8Weights, linear, select_, shard_range
from valle_tpu_torch.ops.attention_impl import dot_product_attention
from valle_tpu_torch.ops.ragged_decode import ragged_decode_attention


def quantize_kv(x: torch.Tensor):
    """(..., Dh) -> (int8 values, f32 scale over the trailing Dh axis).

    Symmetric per-(token, head) quantization; ``torch.round`` rounds half to
    even like ``jnp.round``, so the values equal the JAX ones exactly.
    """
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / scale.clamp(min=1e-8)[..., None])
    return q.clamp(-127, 127).to(torch.int8), scale


def _ragged_decode(q, k, v, kv_lengths, attn_bias, ks=None, vs=None):
    """Route a Tq=1 decode read through kernel 1; slot b reads KV columns
    [0, kv_lengths[b]) only (ops/ragged_decode.py)."""
    bias_row = None
    if attn_bias is not None:
        # decode biases are per-column: (B, 1, 1, C) -> (B, C)
        b, c = q.shape[0], k.shape[1]
        bias_row = attn_bias.expand(b, 1, 1, c)[:, 0, 0, :].float().contiguous()
    return ragged_decode_attention(q, k, v, kv_lengths, bias_row, ks, vs)


def _decode_attention_quantized(q, k8, v8, ks, vs, attn_bias):
    """Single-query attention over an int8 cache (plain math).

    q: (B, 1, H, Dh); k8/v8: (B, C, H, Dh) int8; ks/vs: (B, C, H) f32;
    attn_bias additive, broadcastable to (B, H, 1, C).
    """
    dh = q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q * scale, k8.to(q.dtype))
    logits = logits.float() * ks.transpose(1, 2)[:, :, None, :]
    if attn_bias is not None:
        logits = logits + attn_bias.float()
    probs = torch.softmax(logits, dim=-1)
    probs = probs * vs.transpose(1, 2)[:, :, None, :]
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v8.to(q.dtype))


def _write_columns(buf: torch.Tensor, li: int, columns, val: torch.Tensor) -> None:
    """Write ``val`` (B, Tq, ...) into layer ``li`` of the stacked cache
    ``buf`` (L, B, C, ...), in place: at columns [i, i + Tq) of every slot
    for an int ``columns``, at column c_b of slot b for a pair of (B,)
    index tensors (arange(B), c) (Tq = 1)."""
    if isinstance(columns, tuple):
        buf[li].index_put_(columns, val[:, 0].to(buf.dtype))
    else:
        buf[li, :, columns: columns + val.shape[1]] = val.to(buf.dtype)


class MultiheadAttention(Int8Weights, nn.Module):
    quantizable = ("in_proj_weight",)

    def __init__(self, embed_dim: int, num_heads: int, bias: bool = True,
                 attn_impl: str = "xla", act_quant: bool = False, dropout: float = 0.0,
                 cross_attention: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.head_dim = embed_dim // num_heads
        self.local_heads = num_heads  # this rank's heads (shard_heads_)
        self.attn_impl = attn_impl
        self.dropout = dropout
        self.act_quant = act_quant
        self.cross_attention = cross_attention
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim)) if bias else None
        nn.init.xavier_uniform_(self.in_proj_weight)
        if cross_attention:
            for p in (self.in_proj_weight, self.in_proj_bias):
                if p is not None:
                    p.row_blocks = (embed_dim, 2 * embed_dim)  # JAX's q_proj, kv_proj
        self.register_buffer("in_proj_weight_scale", None)
        self.out_proj = Dense(embed_dim, embed_dim, use_bias=bias, act_quant=act_quant,
                              dtype=dtype)

    def shard_heads_(self, index: int, size: int, group) -> None:
        """Keep heads ``index`` of ``size`` equal parts: their q, k and v rows
        of the packed in-projection (with bias and scales) and their input
        columns of ``out_proj`` (module docstring)."""
        d = self.embed_dim
        cols = shard_range(self.local_heads, index, size)
        cols = (cols[:, None] * self.head_dim + torch.arange(self.head_dim)).reshape(-1)
        rows = torch.cat([cols + blk * d for blk in range(3)])
        for name in ("in_proj_weight", "in_proj_bias", "in_proj_weight_scale"):
            select_(self, name, 0, rows)
        self.local_heads //= size
        if self.cross_attention:
            dl = len(cols)
            for p in (self.in_proj_weight, self.in_proj_bias):
                if isinstance(p, nn.Parameter):
                    p.row_blocks = (dl, 2 * dl)
        self.out_proj.shard_inputs_(index, size, group)

    def forward(
        self,
        x_q: torch.Tensor,
        x_kv: Optional[torch.Tensor] = None,
        *,
        attn_bias=None,
        kv_cache=None,
        cache_index=None,
        kv_lengths: Optional[torch.Tensor] = None,
        return_kv: bool = False,
        rng: Optional[torch.Generator] = None,
    ):
        """Args:
          x_q: (B, Tq, D) queries (pre-projection).
          x_kv: (B, Tk, D) keys/values source; defaults to ``x_q`` (self-attn).
          attn_bias: additive bias broadcastable to (B, H, Tq, Tk), or an
            ``AttnMaskSpec``.
          kv_cache: a stacked cache tuple (see the module docstring); the
            projected K/V (length Tq) are written at column ``cache_index``
            of layer ``layer`` and attention runs over that layer's cache.
          kv_lengths: optional (B,) int32 live cache lengths: routes the
            decode read through kernel 1 so slot b reads only columns
            [0, kv_lengths[b]); None keeps the dense read.
          return_kv: also return the projected (k, v) for cache prefill.
          rng: CPU generator of the dropout seeds (train mode only).

        Returns (out, new_cache_or_None, kv_or_None).
        """
        h, dh = self.local_heads, self.head_dim
        d = h * dh  # this rank's width of q, k and v
        w, bias, scale = self.in_proj_weight, self.in_proj_bias, self.in_proj_weight_scale
        quant, dt = self.act_quant, self.compute_dtype
        if x_kv is None:
            q, k, v = linear(x_q, w, bias, scale, quant, dt).split(d, dim=-1)
        else:
            rows = lambda t, r: None if t is None else t[r]  # noqa: E731
            q = linear(x_q, w[:d], rows(bias, slice(None, d)), rows(scale, slice(None, d)),
                       quant, dt)
            k, v = linear(x_kv, w[d:], rows(bias, slice(d, None)), rows(scale, slice(d, None)),
                          quant, dt).split(d, dim=-1)
        b, tq, tk = q.shape[0], q.shape[1], k.shape[1]
        q = q.view(b, tq, h, dh)
        k = k.view(b, tk, h, dh)
        v = v.view(b, tk, h, dh)

        new_cache = None
        if kv_cache is not None:
            if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
                if tq != 1:
                    raise ValueError(
                        f"per-slot cache_index writes one column per slot, got Tq={tq}")
                columns = (torch.arange(b, device=q.device), cache_index.long())
            else:
                columns = 0 if cache_index is None else int(cache_index)
            if len(kv_cache) == 5:
                kc, vc, ks, vs, li = kv_cache
                k8, k_sc = quantize_kv(k)
                v8, v_sc = quantize_kv(v)
                for buf, val in ((kc, k8), (vc, v8), (ks, k_sc), (vs, v_sc)):
                    _write_columns(buf, li, columns, val)
                new_cache = (kc, vc, ks, vs)
                if kv_lengths is not None:
                    out = _ragged_decode(q, kc[li], vc[li], kv_lengths, attn_bias, ks[li], vs[li])
                    out = out.to(q.dtype)
                else:
                    out = _decode_attention_quantized(q, kc[li], vc[li], ks[li], vs[li], attn_bias)
                return self.out_proj(out.reshape(b, tq, d)), new_cache, None
            if len(kv_cache) != 3:
                raise ValueError(f"unknown kv_cache layout of {len(kv_cache)} entries")
            kc, vc, li = kv_cache
            _write_columns(kc, li, columns, k)
            _write_columns(vc, li, columns, v)
            new_cache = (kc, vc)
            if kv_lengths is not None:
                out = _ragged_decode(q, kc[li], vc[li], kv_lengths, attn_bias).to(q.dtype)
                return self.out_proj(out.reshape(b, tq, d)), new_cache, None
            k_att, v_att = kc[li], vc[li]
        else:
            k_att, v_att = k, v

        out = dot_product_attention(q, k_att, v_att, bias=attn_bias, impl=self.attn_impl,
                                    dropout_rate=self.dropout if self.training else 0.0, rng=rng)
        out = self.out_proj(out.reshape(b, tq, d))
        kv = (k, v) if return_kv else None
        return out, new_cache, kv
