"""Key selection for reference-layout ``.pt`` state dicts: the port's own
copy of what ``valle_tpu/utils/convert_reference.py::convert_state_dict``
reads from a reference VALL-E / VALL-F checkpoint.

The port's parameter names are the reference model's, so a reference state
dict needs no renaming, only selection.  From it the port keeps:

  - every key that the port's model for ``cfg`` takes, and nothing else (a
    reference checkpoint may carry keys that the JAX conversion skips);
  - with ``share_embedding``, only the last NAR head of the file: heads
    0..Q-3 are tied to audio tables 2..Q-1 and are taken from those tables,
    as the JAX conversion keeps only ``nar_predict_layers.{Q-2}``;
  - the NAR positional ``alpha``s at 1, the value the JAX conversion fixes
    them to (the reference holds them untrainable at 1).

The Transformer TTS baseline has no tied heads and no fixed ``alpha``s: its
selection is the first rule alone.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from valle_tpu_torch.models.config import ModelConfig

FIXED_ONE = ("nar_text_position.alpha", "nar_audio_position.alpha")


def model_keys(cfg: ModelConfig, variant: str):
    """The ``state_dict`` keys of the port's model for ``cfg`` and
    ``variant`` ("valle", "vallf" or "transformer"), from a model built on
    the meta device (no memory, no random draws)."""
    from valle_tpu_torch.models import TransformerTTS, VALLE, VALLF

    cls = {"valle": VALLE, "vallf": VALLF, "transformer": TransformerTTS}[variant]
    with torch.device("meta"):
        return list(cls(cfg).state_dict())


def select_state_dict(sd: Mapping[str, torch.Tensor], cfg: ModelConfig,
                      variant: str = "valle") -> Dict[str, torch.Tensor]:
    """The port's state dict out of a reference-layout ``sd`` (module
    docstring); raises KeyError naming the keys that ``sd`` lacks."""
    tied = {}
    q = cfg.num_quantizers
    if variant != "transformer" and q > 1 and cfg.share_embedding:
        tied = {f"nar_predict_layers.{j}.weight":
                f"nar_audio_embeddings.{j + 2}.word_embeddings.weight" for j in range(q - 2)}
    out, missing = {}, []
    for key in model_keys(cfg, variant):
        src = tied.get(key, key)
        if variant != "transformer" and key in FIXED_ONE:
            out[key] = torch.ones(1)
        elif src in sd:
            out[key] = sd[src]
        else:
            missing.append(src)
    if missing:
        raise KeyError(f"the checkpoint lacks {len(missing)} keys of the {variant} model: "
                       f"{missing[:8]}")
    return out
