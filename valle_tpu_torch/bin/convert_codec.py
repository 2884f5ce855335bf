"""Convert public EnCodec 24 kHz weights to the codec ``.npz`` that the
port's CLIs read (``--codec-checkpoint``): the twin of
``valle_tpu/bin/convert_codec.py``, writing the same keys, dtypes and arrays.

The input is a torch state dict (``.pt`` / ``.bin``, read with
``torch.load``, under ``"state_dict"`` or at the top) or a ``.safetensors``
file (read with ``safetensors.numpy``, imported only for such a file) in
the transformers / facebook EnCodec layout.  It runs on the host.

Run: python -m valle_tpu_torch.bin.convert_codec --input encodec_24khz.bin \
        --output codec.npz
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from valle_tpu_torch.codec.convert import convert_encodec_state_dict
from valle_tpu_torch.utils import flatten_tree


def read_state_dict(path: str) -> dict:
    """``{name: numpy array}`` of a ``.safetensors``, ``.pt`` or ``.bin`` file."""
    if path.endswith(".safetensors"):
        from safetensors.numpy import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)
    flat = flatten_tree(convert_encodec_state_dict(read_state_dict(args.input)))
    np.savez(args.output, **flat)
    print(f"wrote {args.output} ({len(flat)} arrays)")


if __name__ == "__main__":
    main()
