"""Helpers shared by the port's entry points."""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point puts its tensors on.

    ``None`` means the card: it raises when CUDA is missing instead of
    quietly running on the CPU.  Pass ``device="cpu"`` to run the plain
    PyTorch versions of the kernels on the CPU.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts and lists -> ``{"a/b/0/c": array}``, the key layout of the
    JAX package's ``.npz`` files (lists under digit keys)."""
    out = {}
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> Dict:
    """``{"a/b/c": array}`` -> nested dicts."""
    out: Dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out
