"""SpecAugment for the log-mel (Transformer TTS baseline) path: the twin of
``valle_tpu/data/transforms.py``.

lhotse's ``SpecAugment`` as the reference's datamodule configures it (time
warp factor 80, 10 time masks of up to 100 frames, 2 frequency masks of up
to 27 bins), run on the host in numpy on the batch that the loader built.
It is seeded numpy, drawn in the JAX package's order, so for the same seed
and features its output equals the JAX package's exactly.  Its generator's
state goes into the loader's saved state (``state_dict``), so a resumed run
draws the masks the uninterrupted run draws; the JAX package saves none and
starts again from the seed.
"""

from __future__ import annotations

import numpy as np


class SpecAugment:
    """Time warp, frequency masks and time masks over (T, F) log-mels.

    Masked regions take the mean of the utterance's valid part, lhotse's
    default mask value."""

    def __init__(self, time_warp_factor: int = 80, num_feature_masks: int = 2,
                 features_mask_size: int = 27, num_frame_masks: int = 10,
                 frames_mask_size: int = 100, max_frames_mask_fraction: float = 0.15,
                 p: float = 0.9, seed: int = 0):
        self.time_warp_factor = time_warp_factor
        self.num_feature_masks = num_feature_masks
        self.features_mask_size = features_mask_size
        self.num_frame_masks = num_frame_masks
        self.frames_mask_size = frames_mask_size
        self.max_frames_mask_fraction = max_frames_mask_fraction
        # masks apply to an utterance with probability p; the warp always
        self.p = p
        self.rng = np.random.RandomState(seed)

    def _time_warp(self, feats: np.ndarray) -> np.ndarray:
        """Pick a pivot in the middle region and a shift in [-W, W]; resample
        the two segments linearly."""
        w = self.time_warp_factor
        t = feats.shape[0]
        if w is None or w <= 0 or t <= 2 * w + 2:
            return feats
        center = self.rng.randint(w + 1, t - w)
        shift = self.rng.randint(-w, w + 1)
        if shift == 0:
            return feats
        pivot = center + shift

        def resample(seg: np.ndarray, new_len: int) -> np.ndarray:
            if seg.shape[0] == new_len:
                return seg
            src = np.linspace(0.0, seg.shape[0] - 1.0, new_len)
            lo = np.floor(src).astype(np.int64)
            hi = np.minimum(lo + 1, seg.shape[0] - 1)
            frac = (src - lo)[:, None].astype(seg.dtype)
            return seg[lo] * (1 - frac) + seg[hi] * frac

        return np.concatenate([resample(feats[:center], pivot),
                               resample(feats[center:], t - pivot)], axis=0)

    def _one(self, feats: np.ndarray, t_valid: int) -> np.ndarray:
        out = feats.copy()
        region = out[:t_valid]
        if t_valid > 0:
            region = self._time_warp(region)
            if self.rng.rand() < self.p:
                mean = float(region.mean())
                f = region.shape[1]
                for _ in range(self.num_feature_masks):
                    width = self.rng.randint(0, self.features_mask_size + 1)
                    if width and width < f:
                        start = self.rng.randint(0, f - width + 1)
                        region[:, start:start + width] = mean
                # each mask's width is capped at the budget over the mask count
                max_total = int(self.max_frames_mask_fraction * t_valid)
                per_mask = min(self.frames_mask_size,
                               max(max_total // max(self.num_frame_masks, 1), 1))
                for _ in range(self.num_frame_masks):
                    width = min(self.rng.randint(0, per_mask + 1), t_valid)
                    if width:
                        start = self.rng.randint(0, t_valid - width + 1)
                        region[start:start + width] = mean
            out[:t_valid] = region
        return out

    def state_dict(self) -> dict:
        """The generator's state, as JSON can hold it."""
        name, keys, pos, has_gauss, cached = self.rng.get_state()
        return {"rng": [name, keys.tolist(), int(pos), int(has_gauss), float(cached)]}

    def load_state_dict(self, state: dict) -> None:
        name, keys, pos, has_gauss, cached = state["rng"]
        self.rng.set_state((name, np.asarray(keys, np.uint32), pos, has_gauss, cached))

    def __call__(self, feats: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """feats (B, T, F) float; lens (B,) valid frames per row."""
        return np.stack([self._one(feats[i], int(lens[i])) for i in range(feats.shape[0])])
