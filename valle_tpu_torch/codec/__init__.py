"""The EnCodec codec of the port and its weight files.

Codec weights travel as the ``.npz`` that ``python -m
valle_tpu_torch.bin.convert_codec`` (or the JAX package's converter) writes
from the public EnCodec weights (``codec/convert.py``): the params tree
flattened to ``a/b/c`` keys, with the LSTM layer lists saved under digit
keys.  ``load_codec`` reads it without JAX; ``save_codec_npz``
writes a tree in the same layout.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from valle_tpu_torch.codec.encodec_model import (
    Encodec, EncodecConfig, codec_params_to_torch, random_codec_params)
from valle_tpu_torch.utils import flatten_tree, unflatten_tree


def _lists_from_digit_keys(tree):
    if isinstance(tree, dict):
        if tree and all(k.isdigit() for k in tree):
            return [_lists_from_digit_keys(tree[str(i)]) for i in range(len(tree))]
        return {k: _lists_from_digit_keys(v) for k, v in tree.items()}
    return tree


def save_codec_npz(path, params: Mapping) -> None:
    """Write a JAX-layout codec params tree as the converter's ``.npz``."""
    np.savez(path, **flatten_tree(params))


def read_codec_npz(path) -> Dict:
    """The converter's ``.npz`` -> the JAX-layout params tree (numpy)."""
    with np.load(path, allow_pickle=False) as f:
        flat = {k: f[k] for k in f.files}
    return _lists_from_digit_keys(unflatten_tree(flat))


def load_codec(path, decode_dtype: str = "float32", device=None) -> Encodec:
    """The codec of a converter ``.npz`` on the card (or on ``device``;
    raises without CUDA unless ``device="cpu"``)."""
    return Encodec(read_codec_npz(path), decode_dtype=decode_dtype, device=device)


__all__ = ["Encodec", "EncodecConfig", "codec_params_to_torch", "load_codec",
           "random_codec_params", "read_codec_npz", "save_codec_npz"]
