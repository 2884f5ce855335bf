"""Packed binary code / feature shards ("VSH1" / "VSF1"): the twin of
``valle_tpu/data/vshard.py``, with the same byte layout, so that a shard
written by either package reads back bit for bit in the other.  The C++
loader (``native/loader/valle_loader.cc``) reads the same files zero-copy:

  [0:4)   magic b"VSH1" (int16 payload) | b"VSF1" (float16 payload)
  [4:8)   u32 num_records
  [8:12)  u32 num_quantizers Q (= feature dim for float shards)
  [12:..) index: per record u64 payload_offset, u32 num_frames
  payload: int16 codes / float16 features, row-major (T, Q)

VSH1 carries EnCodec codes, VSF1 log-mel features for the Transformer TTS
baseline.  Both payloads are 2 bytes per element.  Keys live in the manifest
(``"shard"`` file + integer ``"key"`` index), so a shard is numbers only.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import List

import numpy as np

MAGIC = b"VSH1"
MAGIC_F = b"VSF1"
_IDX = struct.Struct("<QI")


class VShardWriter:
    """Accumulates (T, Q) arrays and writes one packed shard on close."""

    def __init__(self, path: str | Path, num_quantizers: int, dtype=np.int16):
        self.path = Path(path)
        self.num_q = int(num_quantizers)
        self.dtype = np.dtype(dtype)
        if self.dtype not in (np.int16, np.float16):
            raise ValueError(f"shard payloads are int16 or float16, not {self.dtype}")
        self._arrays: List[np.ndarray] = []

    def add(self, codes: np.ndarray) -> int:
        """The record index of the added utterance."""
        codes = np.ascontiguousarray(codes, dtype=self.dtype)
        if codes.ndim != 2 or codes.shape[1] != self.num_q:
            raise ValueError(f"expected (T, {self.num_q}), got {codes.shape}")
        self._arrays.append(codes)
        return len(self._arrays) - 1

    def close(self) -> None:
        n = len(self._arrays)
        magic = MAGIC_F if self.dtype == np.float16 else MAGIC
        header = magic + struct.pack("<II", n, self.num_q)
        offset = len(header) + n * _IDX.size
        index = bytearray()
        for a in self._arrays:
            index += _IDX.pack(offset, a.shape[0])
            offset += a.nbytes
        with open(self.path, "wb") as f:
            f.write(header)
            f.write(bytes(index))
            for a in self._arrays:
                f.write(a.tobytes())
        self._arrays = []

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class VShardReader:
    """Numpy mmap reader: the path taken without the native loader."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        magic = bytes(self._mm[:4])
        if magic == MAGIC:
            self.dtype = np.dtype(np.int16)
        elif magic == MAGIC_F:
            self.dtype = np.dtype(np.float16)
        else:
            raise ValueError(f"{path}: not a VSH1/VSF1 shard")
        self.num_records, self.num_q = struct.unpack("<II", bytes(self._mm[4:12]))
        raw = bytes(self._mm[12:12 + self.num_records * _IDX.size])
        self.offsets = np.empty(self.num_records, np.uint64)
        self.frames = np.empty(self.num_records, np.uint32)
        for i in range(self.num_records):
            self.offsets[i], self.frames[i] = _IDX.unpack_from(raw, i * _IDX.size)

    def __len__(self) -> int:
        return self.num_records

    def __getitem__(self, i: int) -> np.ndarray:
        """Record i as (T, Q): int64 codes, or float32 features."""
        off, t = int(self.offsets[i]), int(self.frames[i])
        raw = np.frombuffer(self._mm[off:off + t * self.num_q * 2],
                            dtype=self.dtype).reshape(t, self.num_q)
        return raw.astype(np.float32 if self.dtype == np.float16 else np.int64)


def write_shard(path: str | Path, arrays: List[np.ndarray], num_q: int, dtype=np.int16) -> None:
    with VShardWriter(path, num_q, dtype=dtype) as w:
        for a in arrays:
            w.add(a)
