"""Analytic FLOPs and MFU of a training step: the twin of
``valle_tpu/utils/flops.py``, with the peaks of NVIDIA cards.

``train_step_flops`` counts the matmul and attention products of one
optimizer step (forward + backward ~ 3x forward), the same count as the
JAX package's.  ``chip_peak_flops`` reads the card's name from
``torch.cuda.get_device_name()`` and gives its dense peak for the training
dtype; it raises for a card it does not know rather than guess.
"""

from __future__ import annotations

from typing import Optional

# dense peak FLOP/s by card name and dtype: f32 on the CUDA cores (no TF32)
# and bf16 on the tensor cores
PEAK_FLOPS = {
    "H100 80GB HBM3": {"float32": 67e12, "bfloat16": 989e12},  # H100 SXM
}


def chip_peak_flops(dtype: str = "float32", device_name: Optional[str] = None) -> float:
    """The card's dense peak FLOP/s for ``dtype`` ("float32" or "bfloat16")."""
    if device_name is None:
        import torch

        device_name = torch.cuda.get_device_name()
    for name, peaks in PEAK_FLOPS.items():
        if name in device_name:
            return peaks[dtype]
    raise ValueError(f"no peak FLOP/s known for {device_name!r}; add it to "
                     "valle_tpu_torch/utils/flops.py::PEAK_FLOPS")


def train_step_flops(cfg, accum: int, batch: int, s: int, t: int, train_stage: int = 1,
                     p: int = 0) -> float:
    """Matmul + attention FLOPs of one optimizer step (forward + backward
    ~ 3x forward).  The VALL-E stacks run over [text ; audio] with a V+1
    logits head; the Transformer baseline is an encoder over s and a
    cross-attention decoder over t with a mel + stop head."""
    d = cfg.decoder_dim
    layers = cfg.num_layers
    per_tok = 12 * d * d  # qkv (3d^2) + out (d^2) + ffn (8d^2) per layer

    if cfg.model_name.lower() == "transformer":
        n_enc = accum * batch * s
        n_dec = accum * batch * t
        enc = 2 * n_enc * layers * per_tok + accum * batch * layers * 4 * s * s * d
        # the decoder adds a cross-attention block (4d^2 per token + 4*t*s*d scores)
        dec = 2 * n_dec * layers * (per_tok + 4 * d * d) + \
            accum * batch * layers * (4 * t * t * d + 4 * t * s * d)
        head = 2 * n_dec * d * (cfg.num_mel_bins + 1)
        return 3.0 * (enc + dec + head)

    if train_stage == 2:
        # NAR only, over [text ; prompt (p) ; audio], logits over V on the audio
        dn = cfg.nar_decoder_dim
        ln = cfg.nar_num_layers
        t_seq = s + p + t
        n_tok = accum * batch * t_seq
        attn = accum * batch * ln * 4 * t_seq * t_seq * dn
        logits = accum * batch * t * dn * cfg.num_audio_tokens
        return 3.0 * (2 * n_tok * ln * 12 * dn * dn + 2 * attn + 2 * logits)

    v = cfg.num_audio_tokens + 1
    t_xy = s + t + 1  # text + audio + the EOS position
    n_tok = accum * batch * t_xy
    attn = accum * batch * layers * 4 * t_xy * t_xy * d  # QK^T + AV
    logits = accum * batch * (t + 1) * d * v
    total = 3.0 * (2 * n_tok * layers * per_tok + 2 * attn + 2 * logits)
    if train_stage == 0:
        total *= 2  # the NAR decoder (same dims) runs too
    return total
