"""EnCodec weights in the transformers / facebook layout -> the codec params
tree that ``load_codec`` / ``codec_params_to_torch`` read: the port's copy
of ``valle_tpu/codec/convert.py``.

It takes a ``{name: numpy array}`` state dict, with plain ``.weight``
tensors or the weight-norm pair ``parametrizations.weight.original0`` /
``original1``, which it folds into plain weights (``g * v / |v|``, the norm
over the input and kernel axes): the functional equivalent of removing
EnCodec's weight norm before tokenizing.  Convolutions come out as
``(k, in, out)``, the layout of the converter's ``.npz``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

from valle_tpu_torch.codec.encodec_model import EncodecConfig


def _conv_weight(sd: Mapping[str, np.ndarray], prefix: str) -> Dict:
    """Fold the weight norm where there is one; torch (out, in, k) -> (k, in, out)."""
    if f"{prefix}.weight" in sd:
        w = np.asarray(sd[f"{prefix}.weight"])
    else:
        g = np.asarray(sd[f"{prefix}.parametrizations.weight.original0"])
        v = np.asarray(sd[f"{prefix}.parametrizations.weight.original1"])
        norm = np.sqrt(np.sum(v**2, axis=(1, 2), keepdims=True))
        w = g * v / np.maximum(norm, 1e-12)
    b = np.asarray(sd[f"{prefix}.bias"])
    return {"w": w.transpose(2, 1, 0), "b": b}


def _lstm(sd: Mapping[str, np.ndarray], prefix: str, layers: int):
    return [{"wi": np.asarray(sd[f"{prefix}.weight_ih_l{n}"]),
             "wh": np.asarray(sd[f"{prefix}.weight_hh_l{n}"]),
             "bi": np.asarray(sd[f"{prefix}.bias_ih_l{n}"]),
             "bh": np.asarray(sd[f"{prefix}.bias_hh_l{n}"])} for n in range(layers)]


def _resblock(sd, prefix: str) -> Dict:
    return {
        "block_1": _conv_weight(sd, f"{prefix}.block.1.conv"),
        "block_3": _conv_weight(sd, f"{prefix}.block.3.conv"),
        "shortcut": _conv_weight(sd, f"{prefix}.shortcut.conv"),
    }


def convert_encodec_state_dict(sd: Mapping[str, np.ndarray],
                               cfg: Optional[EncodecConfig] = None) -> Dict:
    """The params tree (``encoder``, ``decoder``, ``quantizer``) of an
    EnCodec state dict; layer indices follow transformers'
    ``EncodecEncoder`` / ``EncodecDecoder`` construction."""
    cfg = cfg or EncodecConfig()
    enc: Dict = {"layers_0": _conv_weight(sd, "encoder.layers.0.conv")}
    idx = 1
    for _ in reversed(cfg.upsampling_ratios):
        for _ in range(cfg.num_residual_layers):
            enc[f"layers_{idx}"] = _resblock(sd, f"encoder.layers.{idx}")
            idx += 1
        idx += 1  # ELU
        enc[f"layers_{idx}"] = _conv_weight(sd, f"encoder.layers.{idx}.conv")
        idx += 1
    enc[f"layers_{idx}"] = _lstm(sd, f"encoder.layers.{idx}.lstm", cfg.num_lstm_layers)
    idx += 2
    enc[f"layers_{idx}"] = _conv_weight(sd, f"encoder.layers.{idx}.conv")

    dec: Dict = {"layers_0": _conv_weight(sd, "decoder.layers.0.conv"),
                 "layers_1": _lstm(sd, "decoder.layers.1.lstm", cfg.num_lstm_layers)}
    idx = 2
    for _ in cfg.upsampling_ratios:
        idx += 1  # ELU
        dec[f"layers_{idx}"] = _conv_weight(sd, f"decoder.layers.{idx}.conv")
        idx += 1
        for _ in range(cfg.num_residual_layers):
            dec[f"layers_{idx}"] = _resblock(sd, f"decoder.layers.{idx}")
            idx += 1
    dec[f"layers_{idx + 1}"] = _conv_weight(sd, f"decoder.layers.{idx + 1}.conv")

    codebooks = np.stack([np.asarray(sd[f"quantizer.layers.{q}.codebook.embed"])
                          for q in range(cfg.num_quantizers)], axis=0)
    return {"encoder": enc, "decoder": dec, "quantizer": codebooks}
