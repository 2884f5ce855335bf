"""Synthetic corpora for the port's data and training tests: random codes
(or random log-mels) in shards, a manifest per split and a ``chars``
symbol table, written by either package's writers.  Utterance ids are
LibriTTS-like (``speaker_book_utt_seg``) so that prefix-mode-4 prompts find
same-speaker neighbours."""

from pathlib import Path

import numpy as np

SYMBOLS = list("abcdefghijklmnopqrstuvwxyz") + ["_"]


def write_corpus(root: Path, *, writer_cls, manifest_cls, table_cls, splits=(("train", 24),),
                 dur=(0.6, 1.4), seed: int = 0, fmt: str = "vsh", frame_rate: float = 75.0,
                 dim: int = 8, speakers: int = 3) -> Path:
    """Write ``manifest_<split>.jsonl.gz`` and its shards under ``root`` for
    each (split, count); ``fmt`` "vsh" writes int16 codes in [0, 1024) of
    ``dim`` codebooks, "vsf" float16 log-mels of ``dim`` bins."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    for split, n in splits:
        records = []
        with writer_cls(root, prefix=f"{split}_codes", fmt=fmt, num_quantizers=dim) as w:
            for i in range(n):
                d = float(rng.uniform(*dur))
                t = int(round(d * frame_rate))
                spk = i % speakers
                utt = f"{spk}_{100 + spk}_{i:06d}_{0:06d}"
                if fmt == "vsf":
                    feats = rng.randn(t, dim).astype(np.float32)
                else:
                    feats = rng.randint(0, 1024, (t, dim))
                shard, key = w.write(utt, feats)
                tokens = [SYMBOLS[j] for j in rng.randint(0, len(SYMBOLS) - 1, rng.randint(4, 12))]
                rec = {"id": utt, "text": "".join(tokens), "tokens": tokens, "duration": d,
                       "shard": shard, "key": key}
                if fmt == "vsf":
                    rec["feature_dim"] = dim
                records.append(rec)
        manifest_cls.save(iter(records), root / f"manifest_{split}.jsonl.gz")
    table = table_cls()
    for s in SYMBOLS:
        table.add(s)
    table.to_file(root / "unique_text_tokens.k2symbols")
    return root
