"""Prompt selection for prefix mode 4: the twin of
``valle_tpu/data/input_strategies.py``.

``PromptedFeatures`` pairs (prompts, features).  ``NeighborPromptStrategy``
maps each utterance to same-speaker neighbours (LibriTTS ids
``speaker_book_x_y``; LJSpeech ``LJxxx-yyyy`` chapter prefix), as the
reference's strategy does; the loader picks one neighbour per utterance and
cuts it to at most 3 s at a random offset, with one prompt length per
accumulation group.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np

from valle_tpu_torch import macros


class PromptedFeatures:
    def __init__(self, prompts, features):
        self.prompts = prompts
        self.features = features

    @property
    def data(self):
        return (self.prompts, self.features)

    @property
    def ndim(self):
        return self.features.ndim

    def sum(self):
        return self.features.sum()


def _speaker_of(utt_id: str, dataset: str) -> str:
    if dataset.lower() == "libritts":
        return utt_id.split("_")[0]
    if dataset.lower() == "ljspeech":
        return utt_id[:5]  # LJxxx chapter prefix
    raise ValueError(dataset)


class NeighborPromptStrategy:
    """utt -> same-speaker adjacent utterances (previous and next in sorted order)."""

    def __init__(self, dataset: str, utt_ids: Sequence[str]):
        self.dataset = dataset
        self.utt2neighbors: Dict[str, List[str]] = defaultdict(list)
        if dataset.lower() == "libritts":
            speaker2utts: Dict[str, List[str]] = defaultdict(list)
            for u in utt_ids:
                speaker2utts[_speaker_of(u, dataset)].append(u)
            for utts in speaker2utts.values():
                uttids = sorted(utts)
                if len(uttids) == 1:
                    self.utt2neighbors[uttids[0]].append(uttids[0])
                    continue
                utt2prev = dict(zip(uttids, [uttids[1]] + uttids[:-1]))
                utt2post = dict(zip(uttids[:-1], uttids[1:]))
                for u, p in utt2prev.items():
                    self.utt2neighbors[u].append(p)
                for u, p in utt2post.items():
                    self.utt2neighbors[u].append(p)
        elif dataset.lower() == "ljspeech":
            uttids = list(utt_ids)
            if len(uttids) == 1:
                self.utt2neighbors[uttids[0]].append(uttids[0])
            else:
                utt2prev = dict(zip(uttids, [uttids[1]] + uttids[:-1]))
                utt2post = dict(zip(uttids[:-1], uttids[1:]))
                for u, p in utt2post.items():
                    if u[:5] == p[:5]:
                        self.utt2neighbors[u].append(p)
                for u, p in utt2prev.items():
                    if u[:5] == p[:5] or not self.utt2neighbors[u]:
                        self.utt2neighbors[u].append(p)
        else:
            raise ValueError(dataset)

    def pick_prompts(self, batch_utt_ids: Sequence[str], codes_of: Dict[str, np.ndarray],
                     rng: random.Random, max_prompt_frames: int = 3 * macros.AUDIO_FRAME_RATE,
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(prompts (B, P, Q) int64, prompt_lens (B,)) with one shared
        P = min(shortest neighbour, 3 s) and a random offset per utterance."""
        chosen = [rng.choice(self.utt2neighbors[u]) for u in batch_utt_ids]
        p = min(min(codes_of[c].shape[0] for c in chosen), max_prompt_frames)
        prompts = []
        for c in chosen:
            codes = codes_of[c]
            t = codes.shape[0]
            start = rng.randint(0, t - p) if t > p else 0
            prompts.append(codes[start:start + p])
        return (np.stack(prompts, axis=0).astype(np.int64),
                np.full((len(chosen),), p, np.int64))
