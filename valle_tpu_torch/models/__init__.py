"""Model factory: the twin of ``valle_tpu/models/__init__.py``.

``get_model`` builds VALL-E, VALL-F or the Transformer TTS baseline from a
:class:`ModelConfig` on the card (or on ``device``) in eval mode, with weights
from PyTorch's default initialisers under the caller's ``torch.manual_seed``,
or from a ``state_dict``, optionally int8-quantized (``nn/qdense.py``).

Every module computes in the config's compute dtype and casts its weights
to it at the call, as flax's modules do over f32 parameters.  For inference
``get_model`` makes that cast once (the embeddings, positional embeddings
and norms stay f32, as they compute in f32); with ``training=True`` it
keeps every parameter f32, the training build: bf16 mixed precision with
f32 master weights, gradients and optimizer state, which
``valle_tpu_torch.train.step.init_train_state`` takes.  ``cfg.remat`` sets
the layer remat of training (``nn/layers.py``).  ``cfg.scaling_xformers``
builds the Transformer TTS baseline's scaling variant; VALL-E and VALL-F
ignore it, as the JAX models do.
"""

from __future__ import annotations

import argparse

import torch

from valle_tpu_torch.models.config import ModelConfig
from valle_tpu_torch.models.transformer_tts import TransformerTTS
from valle_tpu_torch.models.valle import VALLE, VALLF
from valle_tpu_torch.nn.embedding import SinePositionalEmbedding, TokenEmbedding
from valle_tpu_torch.nn.layers import BasicNorm
from valle_tpu_torch.nn.qdense import SCALE_SUFFIX, quantize_variables
from valle_tpu_torch.utils import resolve_device

# modules whose parameters stay f32 under a bf16 compute dtype: flax's nn.Embed
# without a dtype returns its f32 table, LayerNorm and BatchNorm compute in f32,
# and BasicNorm's epsilon is an f32 parameter that the norm promotes to
_F32_MODULES = (TokenEmbedding, SinePositionalEmbedding, torch.nn.LayerNorm,
                torch.nn.BatchNorm1d, BasicNorm)


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")


def _remat_policy(v: str) -> str:
    """--remat accepts booleans or a policy name."""
    if v.lower() in ("none", "full", "dots_nobatch"):
        return v.lower()
    return "full" if str2bool(v) else "none"


def add_model_arguments(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--model-name", type=str, default="VALL-E")
    parser.add_argument("--decoder-dim", type=int, default=1024)
    parser.add_argument("--nhead", type=int, default=16)
    parser.add_argument("--num-decoder-layers", type=int, default=12)
    parser.add_argument("--scale-factor", type=float, default=1.0)
    parser.add_argument("--norm-first", type=str2bool, default=True)
    parser.add_argument("--add-prenet", type=str2bool, default=False)
    parser.add_argument("--prefix-mode", type=int, default=0)
    parser.add_argument("--share-embedding", type=str2bool, default=True)
    parser.add_argument("--prepend-bos", type=str2bool, default=False)
    parser.add_argument("--num-quantizers", type=int, default=8)
    parser.add_argument("--scaling-xformers", type=str2bool, default=False)
    parser.add_argument("--dropout", type=float, default=0.1,
                        help="attention/FFN dropout (0 for overfit runs)")
    parser.add_argument("--dtype", type=str, default="float32")
    parser.add_argument("--attn-impl", type=str, default="xla",
                        help="xla | fused | flash | flash_kp; 'flash' routes the "
                        "prefill and the NAR passes through the prefix-attention kernel")
    parser.add_argument("--kv-cache-dtype", type=str, default="model",
                        help="model | int8 (int8 halves decode KV reads)")
    parser.add_argument("--remat", type=_remat_policy, default="none",
                        help="layer remat in training: none | full | dots_nobatch (keep the "
                        "Dense projections' outputs, recompute attention); true = full")


def config_from_args(args) -> ModelConfig:
    return ModelConfig(
        model_name=args.model_name,
        decoder_dim=args.decoder_dim,
        nhead=args.nhead,
        num_layers=args.num_decoder_layers,
        norm_first=args.norm_first,
        add_prenet=args.add_prenet,
        prefix_mode=args.prefix_mode,
        share_embedding=args.share_embedding,
        nar_scale_factor=args.scale_factor,
        prepend_bos=args.prepend_bos,
        num_quantizers=args.num_quantizers,
        scaling_xformers=args.scaling_xformers,
        dropout=getattr(args, "dropout", 0.1),
        dtype=getattr(args, "dtype", "float32"),
        attn_impl=getattr(args, "attn_impl", "xla"),
        kv_cache_dtype=getattr(args, "kv_cache_dtype", "model"),
        remat=getattr(args, "remat", "none"),
    )


def _cast_for_compute(model: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """Cast the float parameters and buffers of a model to ``dtype``, in
    place, except those of the embeddings and norms (and weights tied to an
    embedding) and int8 weights' scales: flax's f32 ``param_dtype`` under a
    compute ``dtype``, where the cast that flax makes at every call is made
    once."""
    keep = {id(t) for m in model.modules() if isinstance(m, _F32_MODULES)
            for t in (*m.parameters(), *m.buffers())}
    for m in model.modules():
        for name, t in (*m.named_parameters(recurse=False), *m.named_buffers(recurse=False)):
            if t.is_floating_point() and id(t) not in keep and not name.endswith(SCALE_SUFFIX):
                t.data = t.data.to(dtype)
    return model


def get_model(cfg: ModelConfig, device=None, state_dict=None, quantize: bool = False,
              training: bool = False):
    """VALLE / VALLF / TransformerTTS for ``cfg`` on ``device`` (default: the
    card; raises without CUDA), in eval mode.

    state_dict: weights to load (f32, or int8 with scales as
      ``utils/bridge.py`` gives a quantized JAX tree).
    quantize: quantize the ``DEFAULT_TARGETS`` weights to int8
      (``nn/qdense.py``) on the host, from the f32 weights, before the cast
      and the move to ``device``; ``cfg.act_quant`` then selects W8A8.
    training: the training build: every parameter stays f32 and each module
      casts to ``cfg.compute_dtype`` at its call (the default casts the
      weights once, for inference)."""
    name = cfg.model_name.lower()
    if name in ("vall-e", "valle"):
        cls = VALLE
    elif name in ("vall-f", "vallf"):
        cls = VALLF
    elif name == "transformer":
        cls = TransformerTTS
    else:
        raise ValueError(f"unknown model {cfg.model_name}")
    dev = resolve_device(device)
    model = cls(cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    if quantize:
        quantize_variables(model)
    if not training:
        _cast_for_compute(model, cfg.compute_dtype)
    return model.to(device=dev).eval()


__all__ = [
    "ModelConfig",
    "TransformerTTS",
    "VALLE",
    "VALLF",
    "get_model",
    "add_model_arguments",
    "config_from_args",
    "str2bool",
]
