"""Eval-time visualization, one PNG per utterance: the twin of
``valle_tpu/models/visualizer.py``.

For each of the first ``limit`` utterances of a batch it saves a figure of
the text-embedding output, the target codes and the decoder output, as
``<output_dir>/<utt_id>.png``; the train CLI calls it under ``--visualize``
at validation.  matplotlib is imported at the call, with the Agg backend.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple, Union

import numpy as np


def visualize(predicts: Tuple[np.ndarray, np.ndarray], batch: Dict[str, Union[List, np.ndarray]],
              output_dir: str, limit: int = 4) -> None:
    """predicts: (text-encoder output (B, S, D), decoder output (B, T, D))
    as numpy arrays (or anything ``np.asarray`` takes); batch: the
    ``text_tokens`` / ``audio_features`` arrays and their lengths, with
    ``utt_id`` and ``text`` lists."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    text_tokens_lens = np.asarray(batch["text_tokens_lens"])
    audio_features = np.asarray(batch["audio_features"])
    audio_features_lens = np.asarray(batch["audio_features_lens"])
    utt_ids, texts = batch["utt_id"], batch["text"]

    encoder_outputs = np.asarray(predicts[0], dtype=np.float32)
    decoder_outputs = np.asarray(predicts[1])
    if decoder_outputs.ndim == 3 and decoder_outputs.dtype not in (np.float32, np.float64):
        decoder_outputs = decoder_outputs.astype(np.float32)

    os.makedirs(output_dir, exist_ok=True)
    for b, (utt_id, text) in enumerate(zip(utt_ids[:limit], texts[:limit])):
        fig, axes = plt.subplots(3, 1, figsize=(14, 8))
        s = int(text_tokens_lens[b])
        t = int(audio_features_lens[b])
        if encoder_outputs.ndim == 3:
            axes[0].imshow(encoder_outputs[b, :s].T, aspect="auto", origin="lower")
            axes[0].set_title("Encoder Output")

        tgt = audio_features[b, :t]
        axes[1].imshow(tgt.T if tgt.ndim == 2 else tgt[..., 0].T[None], aspect="auto",
                       origin="lower", interpolation="nearest")
        axes[1].set_title("Target codes")

        if decoder_outputs.ndim >= 2:
            d = decoder_outputs[b]
            axes[2].imshow(d[:t].T if d.ndim == 2 else d[:t][None], aspect="auto",
                           origin="lower", interpolation="nearest")
            axes[2].set_title("Decoder Output")

        fig.suptitle(f"{utt_id}: {text[:80]}")
        fig.tight_layout()
        fig.savefig(os.path.join(output_dir, f"{utt_id}.png"), dpi=100)
        plt.close(fig)
