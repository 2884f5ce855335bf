"""Batch assembly, manifest + sampler -> numpy batch dicts: the twin of
``valle_tpu/data/dataset.py``.

``SpeechSynthesisDataset`` gives the reference dataset's batch dict
(utt_id, text, codes (B, T, Q) with lengths, text tokens with lengths);
``TtsDataLoader`` adds the bucketed sampler, the prefix-mode-4 prompts and
the accumulation groups; ``Prefetcher`` builds batches in a thread.
Batches stay numpy on the host: the training CLI moves each one to the card
in its main thread (pinned memory, then a ``non_blocking`` copy), and the
prefetch thread never touches CUDA.
"""

from __future__ import annotations

import random
from typing import Dict, Iterator, List, Optional

import numpy as np

from valle_tpu_torch import macros
from valle_tpu_torch.data.bucketing import BucketSpec, DynamicBucketingSampler
from valle_tpu_torch.data.collation import TextTokenCollater
from valle_tpu_torch.data.input_strategies import NeighborPromptStrategy
from valle_tpu_torch.data.shards import Manifest


class SpeechSynthesisDataset:
    """Index-based batches, as the reference dataset gives them.

    When the manifest's shards are VSH1 and the C++ loader builds
    (``native_loader.py``), the codes are gathered and padded in C++;
    otherwise in a numpy loop (and always for log-mel VSF1 shards).
    """

    def __init__(self, manifest: Manifest, collater: TextTokenCollater):
        self.manifest = manifest
        self.collater = collater
        self.float_features = manifest.uses_float_features()
        self._native = None
        if manifest.uses_vshards():
            from valle_tpu_torch.data import native_loader

            if native_loader.available():
                names = manifest.shard_names()
                self._shard_index = {n: i for i, n in enumerate(names)}
                self._native = native_loader.NativeShardSet([manifest.root / n for n in names])

    def __len__(self) -> int:
        return len(self.manifest)

    @property
    def loader_path(self) -> str:
        """"native" (C++ gather) or "numpy"."""
        return "native" if self._native is not None else "numpy"

    def _gather_codes(self, indices: List[int], t: int, num_q: int):
        if self._native is not None:
            recs = [self.manifest[i] for i in indices]
            si = [self._shard_index[r["shard"]] for r in recs]
            ri = [int(r["key"]) for r in recs]
            return self._native.gather_pad(si, ri, t, num_q)
        codes = np.zeros((len(indices), t, num_q), np.float32 if self.float_features else np.int32)
        code_lens = np.zeros((len(indices),), np.int32)
        for k, i in enumerate(indices):
            c = self.manifest.codes(i)
            n = min(c.shape[0], t)
            codes[k, :n] = c[:n]
            code_lens[k] = n
        return codes, code_lens

    def batch(self, spec: BucketSpec, indices: List[int]) -> Dict:
        """Index -1 marks a shape-padding row: [bos, eos] text, no codes, and
        ``example_mask`` False, so the model leaves it out of the loss."""
        recs = [self.manifest[i] if i >= 0 else None for i in indices]
        real0 = next(r for r in recs if r is not None)
        token_ids, token_lens = self.collater.index(
            [r["tokens"] if r is not None else [] for r in recs])
        b = len(indices)
        s, t = spec.max_text_len, spec.max_audio_len
        text = np.zeros((b, s), np.int32)
        text[:, :token_ids.shape[1]] = token_ids[:, :s]
        num_q = int(real0.get("feature_dim") or real0.get("num_quantizers") or 8)
        codes, code_lens = self._gather_codes([i for i in indices if i >= 0], t, num_q)
        mask = np.array([i >= 0 for i in indices], bool)
        if not mask.all():
            full = np.zeros((b, t, num_q), codes.dtype)
            full_lens = np.zeros((b,), np.int32)
            full[mask], full_lens[mask] = codes, code_lens
            codes, code_lens = full, full_lens
        return {
            "utt_id": [r["id"] if r is not None else real0["id"] for r in recs],
            "text": [r["text"] if r is not None else "" for r in recs],
            "text_tokens": text,
            "text_tokens_lens": np.minimum(token_lens, s).astype(np.int32),
            "audio_features": codes,
            "audio_features_lens": code_lens,
            "example_mask": mask,
        }


class TtsDataLoader:
    """Bucketed loader of train-step batches.

    Yields dicts with a leading micro-batch axis of ``accum_steps``
    micro-batches from one bucket (so their shapes agree), for the
    accumulation loop of ``train/step.py``.
    """

    def __init__(
        self,
        manifest: Manifest,
        collater: TextTokenCollater,
        *,
        max_duration: float = 40.0,
        num_buckets: int = 10,
        accum_steps: int = 1,
        shuffle: bool = True,
        seed: int = 42,
        rank: int = 0,
        world_size: int = 1,
        dataset_name: Optional[str] = None,  # enables prefix-mode-4 prompts
        min_duration: float = 0.0,
        max_utt_duration: float = float("inf"),
        batch_quant: int = 8,
        frame_rate: Optional[float] = None,  # EnCodec 75 Hz; log-mels 24000 / 256
        feature_transforms: Optional[List] = None,  # e.g. [SpecAugment()], log-mels only
    ):
        self.feature_transforms = list(feature_transforms or [])
        self.dataset = SpeechSynthesisDataset(manifest, collater)
        if frame_rate is None:
            frame_rate = (macros.SAMPLE_RATE / macros.FBANK_HOP if self.dataset.float_features
                          else macros.AUDIO_FRAME_RATE)
        self.frame_rate = frame_rate
        self.manifest = manifest
        self.accum = accum_steps
        keep = [i for i, r in enumerate(manifest.records)
                if min_duration <= r["duration"] <= max_utt_duration]
        self.keep = keep
        durations = [manifest.records[i]["duration"] for i in keep]
        text_lens = [len(manifest.records[i]["tokens"]) + 2 for i in keep]
        audio_lens = [int(round(manifest.records[i]["duration"] * self.frame_rate))
                      for i in keep]
        self.sampler = DynamicBucketingSampler(
            durations, text_lens, audio_lens, max_duration=max_duration,
            num_buckets=num_buckets, shuffle=shuffle, seed=seed, rank=rank,
            world_size=world_size, batch_quant=batch_quant)
        self.prompts = None
        if dataset_name:
            self.prompts = NeighborPromptStrategy(dataset_name,
                                                  [manifest.records[i]["id"] for i in keep])
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.epoch = 0
        self._groups_done = 0
        self._resume_epoch = None
        self._resume_groups = 0
        # the transforms' states after each group built lately, by groups
        # done in the epoch: the prefetch thread builds ahead of the loop
        # that saves the state of the groups it has consumed
        self._transform_states: Dict[int, List[Dict]] = {}

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)
        self.epoch = epoch

    def _transforms(self) -> List:
        """The feature transforms that apply (log-mel manifests only)."""
        return self.feature_transforms if self.dataset.float_features else []

    def state_dict(self, groups_consumed: Optional[int] = None):
        """Mid-epoch resume state, counted in accumulation groups: every rank
        yields groups in lockstep, so one rank's count holds for all; each
        rank re-derives its batch position on resume by replaying the
        deterministic stream without loading the skipped groups.
        ``groups_consumed`` (default: the groups built) is the count the
        caller has trained on; with feature transforms the state holds their
        generators as they were after that group, so that a resumed run
        draws what the uninterrupted run draws next."""
        n = self._groups_done if groups_consumed is None else groups_consumed
        state = {"epoch": self.epoch, "groups_consumed": n}
        if self._transforms():
            # before the first iteration the generators are where group 0 starts
            state["transforms"] = (self._transform_states[n] if self._transform_states
                                   else [tf.state_dict() for tf in self._transforms()])
        return state

    def load_state_dict(self, state):
        for tf, tf_state in zip(self._transforms(), state.get("transforms", [])):
            tf.load_state_dict(tf_state)
        if "groups_consumed" in state:
            self.epoch = int(state["epoch"])
            self.sampler.set_epoch(self.epoch)
            self._resume_groups = int(state["groups_consumed"])
            self._resume_epoch = self.epoch
        else:  # a batch-count state of the sampler
            self.sampler.load_state_dict(state)
            self.epoch = int(state.get("epoch", 0))

    def pending_skip(self) -> int:
        """The groups that this epoch's next iteration skips: those a
        mid-epoch resume already trained on."""
        return self._resume_groups if self._resume_epoch == self.epoch else 0

    def _one(self, spec: BucketSpec, rel_indices: List[int]) -> Dict:
        indices = [self.keep[i] if i >= 0 else -1 for i in rel_indices]
        batch = self.dataset.batch(spec, indices)
        if self.feature_transforms and self.dataset.float_features:
            for tf in self.feature_transforms:
                batch["audio_features"] = tf(batch["audio_features"],
                                             batch["audio_features_lens"])
        return batch

    def _add_prompts(self, micros: List[Dict], rng) -> None:
        """Prefix-mode-4 prompts with one length across the accumulation
        group (the model takes the prefix length from the prompts' shape)."""
        codes_of: Dict[str, np.ndarray] = {}
        for m in micros:
            for u in m["utt_id"]:
                for n in self.prompts.utt2neighbors[u]:
                    if n not in codes_of:
                        codes_of[n] = self.manifest.codes(self._id_index(n))
        chosen_per_micro = [[rng.choice(self.prompts.utt2neighbors[u]) for u in m["utt_id"]]
                            for m in micros]
        all_chosen = [c for row in chosen_per_micro for c in row]
        p = min(min(codes_of[c].shape[0] for c in all_chosen), 3 * macros.AUDIO_FRAME_RATE)
        for m, chosen in zip(micros, chosen_per_micro):
            prompts = []
            for c in chosen:
                codes = codes_of[c]
                t = codes.shape[0]
                start = rng.randint(0, t - p) if t > p else 0
                prompts.append(codes[start:start + p])
            m["prompt_codes"] = np.stack(prompts, axis=0).astype(np.int32)
            m["prompt_codes_lens"] = np.full((len(chosen),), p, np.int32)

    def _id_index(self, utt_id: str) -> int:
        if not hasattr(self, "_id2idx"):
            self._id2idx = {r["id"]: i for i, r in enumerate(self.manifest.records)}
        return self._id2idx[utt_id]

    def _count_groups(self, pairs) -> int:
        """Accumulation groups that a (bucket, indices) stream
        (``sampler.batches_for_rank``) yields: ``__iter__``'s per-bucket
        buffering, on the specs only."""
        tally: Dict = {}
        n = 0
        for b, _rel in pairs:
            spec = self.sampler.bucket_specs[b]
            key = (spec.max_text_len, spec.max_audio_len)
            tally[key] = tally.get(key, 0) + 1
            if tally[key] == self.accum:
                n += 1
                tally[key] = 0
        return n

    def __iter__(self) -> Iterator[Dict]:
        ep = self.epoch
        # mid-epoch resume replays the whole deterministic stream and skips
        # the first groups without loading them, so group boundaries, the
        # per-bucket buffers and the group count equal the uninterrupted run's
        skip = 0
        if self._resume_epoch == ep:
            skip = self._resume_groups
            self._resume_epoch = None
        # every rank yields as many groups as the rank with the fewest
        limit = None
        if self.world_size > 1:
            limit = min(self._count_groups(self.sampler.batches_for_rank(r))
                        for r in range(self.world_size))
        self._groups_done = 0
        transforms = self._transforms()
        self._transform_states = {skip: [tf.state_dict() for tf in transforms]} if transforms \
            else {}
        # a group forms when one bucket shape has ``accum`` batches pending;
        # indices are buffered, not data, and ragged tails are dropped
        pending: Dict = {}
        for spec, rel in self.sampler:
            if limit is not None and self._groups_done >= limit:
                break
            key = (spec.max_text_len, spec.max_audio_len)
            pending.setdefault(key, []).append((spec, rel))
            if len(pending[key]) == self.accum:
                grp = pending.pop(key)
                g = self._groups_done
                self._groups_done += 1
                if g < skip:
                    continue
                micro = [self._one(s, r) for s, r in grp]
                if transforms:
                    self._transform_states[g + 1] = [tf.state_dict() for tf in transforms]
                    # the loop trails the prefetch thread by a few groups only
                    self._transform_states.pop(g + 1 - 64, None)
                if self.prompts is not None:
                    # prompt draws are a pure function of (seed, epoch, group)
                    rng = random.Random(self.seed * 1_000_003 + ep * 8191 + g)
                    self._add_prompts(micro, rng)
                yield self._stack(micro)

    @staticmethod
    def _stack(micros: List[Dict]) -> Dict:
        """Stack one bucket's micro-batches along a leading axis, padding
        ragged example counts with masked rows (text a copy of row 0, so
        attention has keys; audio length 0 and ``example_mask`` False keep
        them out of the loss)."""
        out: Dict = {}
        b = max(m["text_tokens"].shape[0] for m in micros)
        for m in micros:
            pad = b - m["text_tokens"].shape[0]
            if pad == 0:
                continue
            m["utt_id"] = list(m["utt_id"]) + [m["utt_id"][0]] * pad
            m["text"] = list(m["text"]) + [""] * pad
            for k, v in list(m.items()):
                if k in ("utt_id", "text"):
                    continue
                if k == "example_mask":
                    m[k] = np.concatenate([v, np.zeros((pad,), bool)])
                elif k in ("text_tokens", "text_tokens_lens", "prompt_codes",
                           "prompt_codes_lens"):
                    m[k] = np.concatenate([v, np.repeat(v[:1], pad, axis=0)])
                else:  # audio_features / audio_features_lens -> zeros
                    m[k] = np.concatenate([v, np.zeros((pad,) + v.shape[1:], v.dtype)])
        for k in micros[0]:
            if k in ("utt_id", "text"):
                out[k] = [m[k] for m in micros]
            else:
                out[k] = np.stack([m[k] for m in micros], axis=0)
        return out


class Prefetcher:
    """Runs an iterator in a thread behind a bounded queue, so that building
    the next batch (C++ gather, text collation) overlaps the step on the
    card.  The thread handles numpy only.  A producer's exception is raised
    in the consumer."""

    def __init__(self, iterable, depth: int = 2):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err: List[BaseException] = []

        def work():
            try:
                for item in iterable:
                    self._q.put(item)
            except BaseException as e:  # noqa: BLE001 - raised again in the consumer
                self._err.append(e)
            finally:
                self._q.put(self._sentinel)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._sentinel:
                if self._err:
                    raise self._err[0]
                return
            yield item
