"""Tokenized-dataset storage, jsonl.gz manifests and code shards: the twin
of ``valle_tpu/data/shards.py``.  A dataset directory holds:

  manifest_<split>.jsonl.gz   one JSON object per utterance:
      {"id", "text", "tokens": [phoneme symbols], "duration": seconds,
       "shard": "codes_000.vsh", "key": <record index> | "<id>"}
  codes_<nnn>.vsh             packed int16 (T, Q) shards (``vshard.py``), the default
  codes_<nnn>.vsf             packed float16 (T, F) log-mel shards (TTS baseline)
  codes_<nnn>.h5              HDF5 shards (key = utterance id)
  unique_text_tokens.k2symbols   the symbol table

``h5py`` is imported only for an ``.h5`` shard, as in the JAX package.
"""

from __future__ import annotations

import gzip
import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

from valle_tpu_torch.data.vshard import VShardReader, VShardWriter


class CodeShardWriter:
    """Writes code arrays into rolling shards: ``fmt`` "vsh" (int16 codes,
    the default), "vsf" (float16 features) or "h5"."""

    def __init__(self, out_dir: str | Path, prefix: str = "codes", max_per_shard: int = 50000,
                 fmt: str = "vsh", num_quantizers: int = 8):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.prefix = prefix
        self.max_per_shard = max_per_shard
        self.fmt = fmt
        self.num_q = num_quantizers
        self._shard_idx = -1
        self._count = 0
        self._h5 = None
        self._vsh: Optional[VShardWriter] = None
        self._open_next()

    def _open_next(self):
        self._close_current()
        self._shard_idx += 1
        self._count = 0
        ext = self.fmt if self.fmt in ("vsh", "vsf") else "h5"
        self._path = self.out_dir / f"{self.prefix}_{self._shard_idx:03d}.{ext}"
        if self.fmt == "vsh":
            self._vsh = VShardWriter(self._path, self.num_q)
        elif self.fmt == "vsf":
            self._vsh = VShardWriter(self._path, self.num_q, dtype=np.float16)
        else:
            import h5py

            self._h5 = h5py.File(self._path, "w")

    def write(self, key: str, codes: np.ndarray):
        """codes (T, Q) -> (shard file name, key) locating this utterance: the
        integer record index in a vsh / vsf shard, the utterance id in h5."""
        if self._count >= self.max_per_shard:
            self._open_next()
        self._count += 1
        if self.fmt in ("vsh", "vsf"):
            return self._path.name, self._vsh.add(codes)
        self._h5.create_dataset(key, data=codes.astype(np.int16))
        return self._path.name, key

    def _close_current(self):
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None
        if self._vsh is not None:
            self._vsh.close()
            self._vsh = None

    def close(self):
        self._close_current()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class Manifest:
    """A list of utterance records whose codes load lazily."""

    def __init__(self, records: List[Dict], root: Path):
        self.records = records
        self.root = Path(root)
        self._open: Dict[str, object] = {}

    @staticmethod
    def load(path: str | Path) -> "Manifest":
        path = Path(path)
        records = []
        with gzip.open(path, "rt", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
        return Manifest(records, path.parent)

    @staticmethod
    def save(records: Iterator[Dict], path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with gzip.open(path, "wt", encoding="utf-8") as f:
            for r in records:
                f.write(json.dumps(r, ensure_ascii=False) + "\n")

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, i: int) -> Dict:
        return self.records[i]

    def shard_names(self) -> List[str]:
        """Distinct shard files, in first-appearance order."""
        return list(dict.fromkeys(r["shard"] for r in self.records))

    def uses_vshards(self) -> bool:
        return all(n.endswith(".vsh") for n in self.shard_names())

    def uses_float_features(self) -> bool:
        """True for log-mel (VSF1 float16) shards: the TTS baseline's features."""
        return all(n.endswith(".vsf") for n in self.shard_names())

    def _reader(self, shard: str):
        if shard not in self._open:
            if shard.endswith((".vsh", ".vsf")):
                self._open[shard] = VShardReader(self.root / shard)
            else:
                import h5py

                self._open[shard] = h5py.File(self.root / shard, "r")
        return self._open[shard]

    def codes(self, i: int) -> np.ndarray:
        r = self.records[i]
        reader = self._reader(r["shard"])
        if r["shard"].endswith((".vsh", ".vsf")):
            return reader[int(r["key"])]
        return np.asarray(reader[r["key"]], dtype=np.int64)

    def durations(self) -> np.ndarray:
        return np.array([r["duration"] for r in self.records], np.float64)

    def describe(self) -> str:
        """Corpus statistics, as the reference's display_manifest_statistics."""
        durs = self.durations()
        lines = [
            f"Cuts count: {len(self)}",
            f"Total duration (hh:mm:ss): {_fmt_secs(durs.sum())}",
            "Speech duration statistics:",
            f"  mean\t{durs.mean():.1f}",
            f"  std\t{durs.std():.1f}",
            f"  min\t{durs.min():.1f}",
            f"  25%\t{np.percentile(durs, 25):.1f}",
            f"  50%\t{np.percentile(durs, 50):.1f}",
            f"  75%\t{np.percentile(durs, 75):.1f}",
            f"  99%\t{np.percentile(durs, 99):.1f}",
            f"  max\t{durs.max():.1f}",
        ]
        return "\n".join(lines)


def _fmt_secs(s: float) -> str:
    h = int(s // 3600)
    m = int((s % 3600) // 60)
    return f"{h:02d}:{m:02d}:{s % 60:04.1f}"
