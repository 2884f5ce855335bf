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

The scaling_xformers layout (``norm_type="identity"``, the JAX layer's)
puts an identity norm before each attention block and a balanced basic
norm before the feed-forward block and as the stack's final norm.  The
balanced basic norm is the reference's ``BalancedBasicNorm``: an
activation balancer (train mode only) and a ``BasicNorm`` submodule
``norm`` whose parameter ``eps`` holds the log of its epsilon (JAX's
``eps_log``), so its key is ``norm2.norm.eps`` (``norm3.norm.eps`` in a
cross-attention layer) and ``norm.norm.eps`` for the final norm.  The
identity norm has no parameters.  The feed-forward activation is ``relu``,
``gelu`` (tanh approximation, flax's default) or ``balanced_double_swish``
(``nn/scaling.py``), and ``out_init_scale`` scales the initial weights of
the self-attention output projection and ``linear2`` (ScaledLinear's
initial scale; the cross-attention's output projection keeps its init, as
in JAX).

``dtype`` is the compute dtype of the JAX modules (flax's ``dtype``, with
f32 ``param_dtype``): the norms compute in f32 and return that dtype, and
the projections cast their inputs to it, so that in bf16 the residual
stream stays f32 as JAX's does (the embeddings are f32 there).  None keeps
every tensor in its own dtype.

Dropout sits where the JAX layer puts it: on the attention probabilities,
after each attention block (``sa_drop``, ``ca_drop``), after the feed-forward
activation (``ff_drop``) and after its output (``ff_out_drop``), all at the
layer's rate, in train mode only, drawn from the ``rng`` of ``forward``.

Layer remat (``remat``, the JAX stack's ``nn.remat`` of each layer) runs each
layer through ``torch.utils.checkpoint`` in train mode while autograd
records: "full" keeps only the layer's inputs and recomputes the layer in
the backward pass; "dots_nobatch" also keeps the outputs of the products
without a batch dimension (the Dense projections, ``aten.mm`` /
``aten.addmm`` after ``F.linear``'s reshape) and recomputes the rest,
attention included, as ``dots_with_no_batch_dims_saveable`` does.  The
recompute replays the layer's dropout draws: the layer runs on a private
generator set from the step generator's state before it, and the step
generator is then moved to where the layer left the private one, so remat
changes neither the bits nor the draws that follow.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from valle_tpu_torch.nn.attention import MultiheadAttention
from valle_tpu_torch.nn.dropout import dropout as _dropout
from valle_tpu_torch.nn.qdense import Dense
from valle_tpu_torch.nn.scaling import activation_balancer, balanced_double_swish, basic_norm


class StageLayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` that takes (and ignores) the stage embedding, so every
    norm of a layer is called the same way.  With ``dtype`` it normalises in
    f32 and returns ``dtype``, as flax's ``LayerNorm(dtype=...)`` does."""

    def __init__(self, d_model: int, eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__(d_model, eps=eps)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor, stage_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.compute_dtype is None:
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


class IdentityNorm(nn.Module):
    """The scaling_xformers layout's norm before attention: returns x."""

    def forward(self, x: torch.Tensor, stage_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        return x


class BasicNorm(nn.Module):
    """``basic_norm`` with a learnable log-epsilon ``eps``, initialised to
    log 0.25 (JAX's ``eps_log``)."""

    def __init__(self):
        super().__init__()
        self.eps = nn.Parameter(torch.tensor(0.25).log())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return basic_norm(x, self.eps)


class BalancedBasicNorm(nn.Module):
    """An activation balancer (sign share 0.45-0.55, |x| at most 6; train
    mode only) and then ``BasicNorm``.  Returns f32 whatever x's dtype, as
    JAX's promotion with the f32 ``eps_log`` does; the next ``Dense``
    casts."""

    def __init__(self):
        super().__init__()
        self.norm = BasicNorm()

    def forward(self, x: torch.Tensor, stage_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = activation_balancer(x, channel_dim=-1, min_positive=0.45, max_positive=0.55,
                                max_abs=6.0, apply=self.training)
        return self.norm(x)


def conditioned_norm(d_model: int, adaptive: bool = False, eps: float = 1e-5,
                     norm_type: str = "layer", dtype: Optional[torch.dtype] = None) -> nn.Module:
    """The norm that the JAX ``ConditionedNorm`` computes: a layer norm, an
    adaptive one for NAR stage conditioning, or the scaling_xformers
    layout's ``identity`` / ``balanced_basic`` norm (which ignore
    ``adaptive``, as JAX's do).  A factory rather than a wrapper module, so
    the parameter names stay the reference's (``norm1.weight``,
    ``norm1.project_layer.weight``, ``norm2.norm.eps``)."""
    if norm_type == "identity":
        return IdentityNorm()
    if norm_type == "balanced_basic":
        return BalancedBasicNorm()
    if norm_type != "layer":
        raise ValueError(f"unknown norm_type {norm_type!r}")
    if adaptive:
        return AdaptiveLayerNorm(d_model, eps, dtype)
    return StageLayerNorm(d_model, eps=eps, dtype=dtype)


ACTIVATIONS = ("relu", "gelu", "balanced_double_swish")


def ffn_norm_type(norm_type: str) -> str:
    """The norm before the feed-forward block and the stack's final norm:
    the scaling_xformers layout (``identity``) puts a balanced basic norm
    there."""
    return "balanced_basic" if norm_type == "identity" else norm_type


class TransformerLayer(nn.Module):
    """One decoder block.  ``cross_attention`` adds an encoder-memory
    attention sub-block between self-attention and the FFN (VALL-F);
    ``activation``, ``norm_type`` and ``out_init_scale`` select the
    scaling_xformers layout (module docstring)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 norm_first: bool = True, adaptive_norm: bool = False,
                 cross_attention: bool = False, attn_impl: str = "xla",
                 act_quant: bool = False, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, activation: str = "relu",
                 norm_type: str = "layer", out_init_scale: float = 1.0):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation must be one of {ACTIVATIONS}, got {activation!r}")
        self.norm_first = norm_first
        self.cross_attention = cross_attention
        self.dropout = dropout
        self.activation = activation
        attn = dict(attn_impl=attn_impl, act_quant=act_quant, dropout=dropout, dtype=dtype)
        self.self_attn = MultiheadAttention(d_model, nhead, **attn)
        self.linear1 = Dense(d_model, dim_feedforward, act_quant=act_quant, dtype=dtype)
        self.linear2 = Dense(dim_feedforward, d_model, act_quant=act_quant, dtype=dtype)
        if out_init_scale != 1.0:
            with torch.no_grad():
                self.self_attn.out_proj.weight.mul_(out_init_scale)
                self.linear2.weight.mul_(out_init_scale)
        norm = functools.partial(conditioned_norm, d_model, adaptive_norm, dtype=dtype)
        # the feed-forward norm is norm3 in a cross-attention layer, else norm2
        self.norm1 = norm(norm_type=norm_type)
        self.norm2 = norm(norm_type=norm_type if cross_attention else ffn_norm_type(norm_type))
        if cross_attention:
            self.multihead_attn = MultiheadAttention(d_model, nhead, cross_attention=True,
                                                     **attn)
            self.norm3 = norm(norm_type=ffn_norm_type(norm_type))

    def _act(self, h: torch.Tensor) -> torch.Tensor:
        if self.activation == "relu":
            return F.relu(h)
        if self.activation == "gelu":
            return F.gelu(h, approximate="tanh")
        return balanced_double_swish(h, apply=self.training)

    def forward(self, x, *, stage_emb=None, attn_bias=None, memory=None,
                memory_bias=None, kv_cache=None, cache_index=None,
                kv_lengths=None, return_kv=False, rng=None):
        """Returns (x, new_cache_or_None, kv_or_None)."""
        norm_ff = self.norm3 if self.cross_attention else self.norm2
        rate = self.dropout if self.training else 0.0

        def drop(h):
            return _dropout(h, rate, rng)

        def ff_block(h):
            return drop(self.linear2(drop(self._act(self.linear1(h)))))

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


# the products without a batch dimension: F.linear's, after its reshape of a
# (B, T, D) input to (B*T, D), with and without a bias
_PROJECTIONS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_nobatch_policy(ctx, op, *args, **kwargs):
    """The "dots_nobatch" remat policy: save the outputs of the Dense
    projections, recompute everything else (JAX's
    ``dots_with_no_batch_dims_saveable``)."""
    return CheckpointPolicy.MUST_SAVE if op in _PROJECTIONS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_nobatch_contexts():
    # the policy is looked up at the call, so that it can be observed
    return create_selective_checkpoint_contexts(dots_nobatch_policy)


def remat_call(layer: nn.Module, x: torch.Tensor, remat: str,
               rng: Optional[torch.Generator], **kw):
    """``layer(x, rng=rng, **kw)`` through ``torch.utils.checkpoint`` under
    the policy ``remat`` ("full" or "dots_nobatch").  With a generator, the
    layer draws from a private copy of ``rng``'s state, in the forward and
    again in the recompute, and ``rng`` is then moved to the copy's end
    state: the recompute makes the forward's draws, and ``rng`` ends where a
    call without remat leaves it (torch's checkpoint restores its global
    generators, not one passed as an argument)."""
    context_fn = _dots_nobatch_contexts if remat == "dots_nobatch" else None
    extra = {} if context_fn is None else {"context_fn": context_fn}
    if rng is None:
        return checkpoint(functools.partial(layer, rng=None, **kw), x, use_reentrant=False,
                          **extra)
    start = rng.get_state()
    end = {}

    def run(h):
        gen = torch.Generator().set_state(start)
        out = layer(h, rng=gen, **kw)
        end["state"] = gen.get_state()
        return out

    out = checkpoint(run, x, use_reentrant=False, **extra)
    rng.set_state(end["state"])
    return out


class TransformerStack(nn.Module):
    """N TransformerLayers plus the optional final (adaptive or balanced
    basic) norm; ``remat`` is the layer remat policy of training (module
    docstring)."""

    def __init__(self, num_layers: int, d_model: int, nhead: int, dim_feedforward: int,
                 norm_first: bool = True, adaptive_norm: bool = False,
                 cross_attention: bool = False, final_norm: bool = True,
                 attn_impl: str = "xla", act_quant: bool = False, dropout: float = 0.0,
                 dtype: Optional[torch.dtype] = None, remat: str = "none",
                 activation: str = "relu", norm_type: str = "layer",
                 out_init_scale: float = 1.0):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            TransformerLayer(d_model, nhead, dim_feedforward, norm_first=norm_first,
                             adaptive_norm=adaptive_norm, cross_attention=cross_attention,
                             attn_impl=attn_impl, act_quant=act_quant, dropout=dropout,
                             dtype=dtype, activation=activation, norm_type=norm_type,
                             out_init_scale=out_init_scale)
            for _ in range(num_layers)
        )
        self.norm = (conditioned_norm(d_model, adaptive_norm, dtype=dtype,
                                      norm_type=ffn_norm_type(norm_type))
                     if final_norm and norm_first else None)

    def forward(self, x, kv_cache=None, *, stage_emb=None, attn_bias=None, memory=None,
                memory_bias=None, cache_index=None, kv_lengths=None, return_kv=False,
                rng=None):
        """kv_cache: a stacked decode cache, (kc, vc) or (kc, vc, ks, vs) with
        a leading layer axis, updated in place.

        Returns (x, new_cache_or_None, kv) where kv is the stacked
        (k, v) of shape (L, B, T, H, Dh) when ``return_kv``, else None.
        Layer remat applies in train mode while autograd records, without
        a cache."""
        remat = (self.remat != "none" and self.training and torch.is_grad_enabled()
                 and kv_cache is None and not return_kv)
        ks, vs = [], []
        for i, layer in enumerate(self.layers):
            kw = dict(stage_emb=stage_emb, attn_bias=attn_bias, memory=memory,
                      memory_bias=memory_bias, cache_index=cache_index, kv_lengths=kv_lengths)
            if remat:
                x = remat_call(layer, x, self.remat, rng, **kw)[0]
                continue
            x, _, kv = layer(x, kv_cache=None if kv_cache is None else (*kv_cache, i),
                             return_kv=return_kv, rng=rng, **kw)
            if return_kv:
                ks.append(kv[0])
                vs.append(kv[1])
        if self.norm is not None:
            x = self.norm(x, stage_emb)
        kv = (torch.stack(ks), torch.stack(vs)) if return_kv else None
        return x, kv_cache, kv
