"""Weight bridge: the JAX package's parameters -> the port's ``state_dict``.

The port names its parameters after the reference PyTorch model, which are
the keys that ``valle_tpu/utils/convert_reference.py::convert_state_dict``
maps *from*.  This module is the inverse of that function, with its own copy
of the key mapping: it unstacks the scanned layer axis of the JAX decoder
stacks, splits the stacked NAR embedding tables, re-packs the cross-attention
q / kv projections into one ``in_proj_weight``, writes the tied NAR
prediction weights (``nar_predict_layers.{j}`` = table j+2 for j <= Q-3, as
the reference ties them) and maps the optional prenets (flax Conv / BatchNorm
/ Dense to the reference's ``nn.Sequential`` indices).  The Transformer TTS
baseline (``variant="transformer"``) maps its encoder and decoder
stacks the same way, its mel prenet ``decoder_prenet_fc1..3`` to
``decoder_prenet.0 / .3 / .6`` and its other leaves by name.  Its
``scaling_xformers`` variant maps the ``eps_log`` of each balanced basic
norm (the layers' ``norm2``, which is the port's ``norm3`` in a
cross-attention layer, and the final norms) to ``<norm>.norm.eps`` and its
one-layer prenet ``decoder_prenet_fc`` by name; its identity norms have no
parameters.  ``sr_state_dict_from_jax`` carries an ``SRLinear`` /
``SRConv1d`` variable tree (params and ``spectral.u``) into the port's
module.

Input is the JAX variables dict as ``model.init`` returns it, with numpy
leaves (``jax.tree.map(np.asarray, variables)``); a bare params tree works
too.  No JAX import: the leaves are numpy arrays.  A tree quantized by JAX's
``quantize_variables`` (int8 ``kernel`` leaves and the ``qscale``
collection) maps to the port's quantized state: the int8 weight
transposed, and its scales as ``<weight>_scale`` (the cross-attention's
q_proj and kv_proj scales concatenated, as their weights are).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from valle_tpu_torch.models.config import ModelConfig
from valle_tpu_torch.utils import resolve_device


def _scale(qtree: Mapping, dst: str, out: Dict[str, np.ndarray], *names, i=None) -> None:
    """``out[dst]`` = the concatenated qscale kernels of ``names`` (layer i),
    when they were quantized."""
    found = [qtree[n]["kernel"] if i is None else qtree[n]["kernel"][i]
             for n in names if n in qtree]
    if len(found) not in (0, len(names)):
        raise ValueError(f"{dst}: {names} are one packed weight in the port; "
                         "quantize both or neither")
    if found:
        out[dst] = np.concatenate(found, axis=0)


def _decoder(out: Dict[str, np.ndarray], tree: Mapping, prefix: str, n_layers: int,
             adaptive: bool, cross: bool, norm_first: bool,
             qtree: Optional[Mapping] = None, norm_type: str = "layer") -> None:
    layers = tree["layers"]
    qlayers = (qtree or {}).get("layers", {})

    def norm(dst: str, name: str, i, ffn: bool = False) -> None:
        ntype = "balanced_basic" if ffn and norm_type == "identity" else norm_type
        if ntype == "identity":
            return
        sub = tree["final_norm"] if name == "final_norm" else layers[name]
        if ntype == "balanced_basic":
            out[f"{dst}.norm.eps"] = sub["eps_log"][i]
        elif adaptive:
            ada = sub["ada"]
            out[f"{dst}.project_layer.weight"] = ada["project_layer"]["kernel"][i].T
            out[f"{dst}.project_layer.bias"] = ada["project_layer"]["bias"][i]
            out[f"{dst}.norm.weight"] = ada["norm"]["scale"][i]
            out[f"{dst}.norm.bias"] = ada["norm"]["bias"][i]
        else:
            out[f"{dst}.weight"] = sub["ln"]["scale"][i]
            out[f"{dst}.bias"] = sub["ln"]["bias"][i]

    def linear(dst: str, sub: Mapping, i, qsub: Mapping) -> None:
        out[f"{dst}.weight"] = sub["kernel"][i].T
        out[f"{dst}.bias"] = sub["bias"][i]
        if "kernel" in qsub:
            out[f"{dst}.weight_scale"] = qsub["kernel"][i]

    for i in range(n_layers):
        p = f"{prefix}.layers.{i}"
        sa, qsa = layers["self_attn"], qlayers.get("self_attn", {})
        out[f"{p}.self_attn.in_proj_weight"] = sa["in_proj"]["kernel"][i].T
        out[f"{p}.self_attn.in_proj_bias"] = sa["in_proj"]["bias"][i]
        _scale(qsa, f"{p}.self_attn.in_proj_weight_scale", out, "in_proj", i=i)
        linear(f"{p}.self_attn.out_proj", sa["out_proj"], i, qsa.get("out_proj", {}))
        linear(f"{p}.linear1", layers["linear1"], i, qlayers.get("linear1", {}))
        linear(f"{p}.linear2", layers["linear2"], i, qlayers.get("linear2", {}))
        norm(f"{p}.norm1", "norm1", i)
        if cross:
            ca, qca = layers["cross_attn"], qlayers.get("cross_attn", {})
            out[f"{p}.multihead_attn.in_proj_weight"] = np.concatenate(
                [ca["q_proj"]["kernel"][i].T, ca["kv_proj"]["kernel"][i].T], axis=0)
            out[f"{p}.multihead_attn.in_proj_bias"] = np.concatenate(
                [ca["q_proj"]["bias"][i], ca["kv_proj"]["bias"][i]], axis=0)
            _scale(qca, f"{p}.multihead_attn.in_proj_weight_scale", out, "q_proj", "kv_proj",
                   i=i)
            linear(f"{p}.multihead_attn.out_proj", ca["out_proj"], i, qca.get("out_proj", {}))
            # reference: norm2 gates cross-attention, norm3 the FFN
            norm(f"{p}.norm2", "norm_ca", i)
            norm(f"{p}.norm3", "norm2", i, ffn=True)
        else:
            norm(f"{p}.norm2", "norm2", i, ffn=True)
    if norm_first:
        norm(f"{prefix}.norm", "final_norm", ..., ffn=True)


def _prenets(out: Dict[str, np.ndarray], params: Mapping, stats: Mapping, side: str) -> None:
    conv = params.get(f"{side}_text_prenet")
    if conv is not None:
        p = f"{side}_text_prenet"
        bn_stats = stats.get(p, {})
        for j in range(3):
            c, bn = 1 + 4 * j, 2 + 4 * j
            # flax Conv kernel (width, in, out) -> torch Conv1d (out, in, width)
            out[f"{p}.{c}.weight"] = np.transpose(conv[f"conv{j}"]["kernel"], (2, 1, 0))
            out[f"{p}.{c}.bias"] = conv[f"conv{j}"]["bias"]
            out[f"{p}.{bn}.weight"] = conv[f"bn{j}"]["scale"]
            out[f"{p}.{bn}.bias"] = conv[f"bn{j}"]["bias"]
            out[f"{p}.{bn}.running_mean"] = bn_stats[f"bn{j}"]["mean"]
            out[f"{p}.{bn}.running_var"] = bn_stats[f"bn{j}"]["var"]
            out[f"{p}.{bn}.num_batches_tracked"] = np.asarray(0, np.int64)
        out[f"{p}.14.weight"] = conv["proj"]["kernel"].T
        out[f"{p}.14.bias"] = conv["proj"]["bias"]
    mlp = params.get(f"{side}_audio_prenet")
    if mlp is not None:
        for name, idx in (("fc1", 0), ("fc2", 3), ("fc3", 6)):
            out[f"{side}_audio_prenet.{idx}.weight"] = mlp[name]["kernel"].T
            out[f"{side}_audio_prenet.{idx}.bias"] = mlp[name]["bias"]


def _transformer_tts(params: Mapping, cfg: ModelConfig) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {
        "text_embedding.word_embeddings.weight": params["text_embedding"]["word_embeddings"][
            "embedding"],
        "text_position.alpha": params["text_position"]["alpha"],
        "decoder_position.alpha": params["decoder_position"]["alpha"],
    }
    norm_type = "identity" if cfg.scaling_xformers else "layer"
    for name, cross in (("encoder", False), ("decoder", True)):
        _decoder(out, params[name], name, cfg.num_layers, False, cross, cfg.norm_first,
                 norm_type=norm_type)
    if cfg.scaling_xformers:
        dense = {"decoder_prenet_fc": params["decoder_prenet_fc"]}
    else:
        dense = {f"decoder_prenet.{i}": params[f"decoder_prenet_fc{j}"]
                 for i, j in ((0, 1), (3, 2), (6, 3))}
    dense.update(predict_layer=params["predict_layer"], stop_layer=params["stop_layer"])
    for name, leaf in dense.items():
        out[f"{name}.weight"] = leaf["kernel"].T
        out[f"{name}.bias"] = leaf["bias"]
    return out


def numpy_state_dict_from_jax(variables: Mapping, cfg: ModelConfig,
                              variant: str = "valle") -> Dict[str, np.ndarray]:
    """JAX variables (or params) of the model that ``variant`` names
    ("valle", "vallf" or "transformer", the TTS baseline) -> the port's numpy
    state dict."""
    if variant not in ("valle", "vallf", "transformer"):
        raise ValueError(f"unknown variant {variant!r}")
    params = variables["params"] if "params" in variables else variables
    stats = variables.get("batch_stats", {}) if "params" in variables else {}
    qscale = variables.get("qscale", {}) if "params" in variables else {}
    if variant == "transformer":
        return {k: np.array(v) for k, v in _transformer_tts(params, cfg).items()}
    cross = variant == "vallf"
    q = cfg.num_quantizers
    emb = lambda name: params[name]["word_embeddings"]["embedding"]  # noqa: E731
    out: Dict[str, np.ndarray] = {
        "ar_text_embedding.word_embeddings.weight": emb("ar_text_embedding"),
        "ar_audio_embedding.word_embeddings.weight": emb("ar_audio_embedding"),
        "ar_text_position.alpha": params["ar_text_position"]["alpha"],
        "ar_audio_position.alpha": params["ar_audio_position"]["alpha"],
        "ar_predict_layer.weight": params["ar_predict_layer"]["kernel"].T,
    }
    _decoder(out, params["ar_decoder"], "ar_decoder", cfg.num_layers, False, cross,
             cfg.norm_first, qscale.get("ar_decoder", {}))
    _scale(qscale, "ar_predict_layer.weight_scale", out, "ar_predict_layer")
    _prenets(out, params, stats, "ar")
    if q > 1:
        rest = params["nar_audio_embeddings_rest"]  # (Q-1, V, nd)
        out["nar_text_embedding.word_embeddings.weight"] = emb("nar_text_embedding")
        out["nar_audio_embeddings.0.word_embeddings.weight"] = emb("nar_audio_embedding_0")
        for j in range(1, q):
            out[f"nar_audio_embeddings.{j}.word_embeddings.weight"] = rest[j - 1]
        # the NAR positions have a fixed alpha of 1 in both packages
        out["nar_text_position.alpha"] = np.ones((1,), np.float32)
        out["nar_audio_position.alpha"] = np.ones((1,), np.float32)
        _decoder(out, params["nar_decoder"], "nar_decoder", cfg.nar_num_layers, True,
                 cross, cfg.norm_first, qscale.get("nar_decoder", {}))
        _prenets(out, params, stats, "nar")
        stage = params["nar_stage_embeddings"]  # (Q-1, nd)
        for j in range(q - 1):
            out[f"nar_stage_embeddings.{j}.word_embeddings.weight"] = stage[j][None, :]
        for j in range(q - 1):
            if cfg.share_embedding:
                w = rest[j + 1] if j < q - 2 else params["nar_predict_last"].T
            else:
                w = params["nar_predict_layers"][j].T
            out[f"nar_predict_layers.{j}.weight"] = w
    return {k: np.array(v) for k, v in out.items()}  # copies: jax leaves are read-only


def sr_state_dict_from_jax(variables: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """The variables of JAX's ``SRLinear`` / ``SRConv1d`` (``params``:
    ``weight`` in the torch layout, ``sigma``, ``bias``; ``spectral``:
    ``u``) -> the ``state_dict`` of the port's module on ``device``
    (default: the card; raises without CUDA)."""
    dev = resolve_device(device)
    sd = dict(variables["params"], u=variables["spectral"]["u"])
    return {k: torch.from_numpy(np.array(v)).to(dev) for k, v in sd.items()}


def state_dict_from_jax(variables: Mapping, cfg: ModelConfig, variant: str = "valle",
                        device=None) -> Dict[str, torch.Tensor]:
    """JAX variables -> the port's ``state_dict`` on ``device`` (default: the
    card; raises without CUDA).  Load it with ``model.load_state_dict``."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in numpy_state_dict_from_jax(variables, cfg, variant).items()}
