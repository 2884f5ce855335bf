"""Duration-bucketed batching: the twin of ``valle_tpu/data/bucketing.py``.

Reproduces lhotse's ``DynamicBucketingSampler(max_duration, num_buckets)``
as the reference's datamodule configures it: batches of similar-duration
utterances whose summed duration stays under ``max_duration`` seconds, each
padded to its bucket's (text_len, audio_len) ceiling.  For the same
durations, seed, epoch, rank and world size the order is the JAX package's,
draw for draw: it is a pure function of ``np.random.RandomState(seed +
epoch)``.  Eager PyTorch needs no static shapes, but the port keeps the
ceilings and ``batch_quant`` so that both packages see the same batches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class BucketSpec:
    max_text_len: int
    max_audio_len: int  # frames


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class DynamicBucketingSampler:
    """Yields (BucketSpec, example indices) bucketed by duration.

    Args:
      durations: seconds per utterance.
      text_lens / audio_lens: token and frame counts of the bucket ceilings.
      max_duration: summed seconds per batch (``--max-duration``).
      num_buckets: duration-quantile buckets (``--num-buckets``).
      shuffle, seed: seeded order, reshuffled per epoch by ``set_epoch``.
      rank / world_size: this rank's share of the batches.
      pad_multiple: bucket ceilings rounded up to this.
      batch_quant: round each batch's example count up to a multiple of
        this with -1 placeholders (rows masked out of the loss); 1 disables.
    """

    def __init__(self, durations: Sequence[float], text_lens: Sequence[int],
                 audio_lens: Sequence[int], *, max_duration: float = 40.0,
                 num_buckets: int = 10, shuffle: bool = True, drop_last: bool = False,
                 seed: int = 0, rank: int = 0, world_size: int = 1, pad_multiple: int = 16,
                 batch_quant: int = 1):
        self.batch_quant = max(int(batch_quant), 1)
        self.durations = np.asarray(durations, np.float64)
        self.text_lens = np.asarray(text_lens, np.int64)
        self.audio_lens = np.asarray(audio_lens, np.int64)
        self.max_duration = max_duration
        self.num_buckets = num_buckets
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.pad_multiple = pad_multiple

        qs = np.quantile(self.durations, np.linspace(0, 1, num_buckets + 1))
        qs[0], qs[-1] = -np.inf, np.inf
        self.bucket_of = np.clip(np.searchsorted(qs, self.durations, side="right") - 1, 0,
                                 num_buckets - 1)
        self.bucket_specs: List[BucketSpec] = []
        for b in range(num_buckets):
            idx = np.nonzero(self.bucket_of == b)[0]
            if len(idx) == 0:
                self.bucket_specs.append(BucketSpec(8, 8))
                continue
            self.bucket_specs.append(BucketSpec(
                _round_up(int(self.text_lens[idx].max()), self.pad_multiple),
                _round_up(int(self.audio_lens[idx].max()), self.pad_multiple)))
        self.epoch = 0
        self._resume_skip = 0
        self._consumed = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def state_dict(self) -> Dict:
        return {"epoch": self.epoch, "batches_consumed": self._consumed}

    def load_state_dict(self, state: Dict) -> None:
        self.epoch = state["epoch"]
        self._resume_skip = state["batches_consumed"]

    def _batches(self) -> List[Tuple[int, List[int]]]:
        rng = np.random.RandomState(self.seed + self.epoch)
        order = np.arange(len(self.durations))
        if self.shuffle:
            rng.shuffle(order)
        per_bucket: Dict[int, List[int]] = {b: [] for b in range(self.num_buckets)}
        batches: List[Tuple[int, List[int]]] = []
        dur_acc: Dict[int, float] = {b: 0.0 for b in range(self.num_buckets)}
        for i in order:
            b = int(self.bucket_of[i])
            d = float(self.durations[i])
            if per_bucket[b] and dur_acc[b] + d > self.max_duration:
                batches.append((b, per_bucket[b]))
                per_bucket[b], dur_acc[b] = [], 0.0
            per_bucket[b].append(int(i))
            dur_acc[b] += d
        if not self.drop_last:
            for b, items in per_bucket.items():
                if items:
                    batches.append((b, items))
        if self.batch_quant > 1:
            for b, items in batches:
                items.extend([-1] * (-len(items) % self.batch_quant))
        if self.shuffle:
            rng.shuffle(batches)
        # every rank takes batches rank::world_size of a list truncated to a
        # multiple of the world size, so that all ranks take as many steps
        if self.world_size > 1:
            batches = batches[:len(batches) - len(batches) % self.world_size]
        return batches[self.rank::self.world_size]

    def batches_for_rank(self, rank: int) -> List[Tuple[int, List[int]]]:
        """Any rank's batch list: the global list is a pure function of
        (seed, epoch), so every rank can derive every other's."""
        saved = self.rank
        try:
            self.rank = rank
            return self._batches()
        finally:
            self.rank = saved

    def __iter__(self) -> Iterator[Tuple[BucketSpec, List[int]]]:
        self._consumed = 0
        batches = self._batches()
        skip, self._resume_skip = self._resume_skip, 0
        for n, (b, items) in enumerate(batches):
            if n < skip:
                continue
            self._consumed = n + 1
            yield self.bucket_specs[b], items

    def __len__(self) -> int:
        return len(self._batches())


class SingleCutSampler:
    """Fixed-size batches of up to ``max_cuts`` utterances under one shape."""

    def __init__(self, n_examples: int, text_lens: Sequence[int], audio_lens: Sequence[int], *,
                 max_cuts: int = 8, shuffle: bool = True, seed: int = 0, rank: int = 0,
                 world_size: int = 1, pad_multiple: int = 16):
        self.n = n_examples
        self.max_cuts = max_cuts
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.spec = BucketSpec(_round_up(int(np.max(text_lens)), pad_multiple),
                               _round_up(int(np.max(audio_lens)), pad_multiple))
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.RandomState(self.seed + self.epoch)
        order = np.arange(self.n)
        if self.shuffle:
            rng.shuffle(order)
        batches = [order[i:i + self.max_cuts].tolist() for i in range(0, self.n, self.max_cuts)]
        for batch in batches[self.rank::self.world_size]:
            yield self.spec, batch
