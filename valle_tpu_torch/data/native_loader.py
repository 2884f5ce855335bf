"""ctypes binding of the C++ loader (``native/loader/valle_loader.cc``): the
port's own twin of ``valle_tpu/data/native_loader.py``.

The loader gathers, widens (int16 -> int32) and pads utterance codes from
VSH1 shards into a batch buffer, in C++ threads with the GIL released.  It
is built with ``g++`` at first use into ``valle_tpu_torch/data/_native/``
(never into ``native/lib/``, which the JAX package's binding owns: the two
packages must not race over one library).  The build writes a temporary
file and renames it, so processes that build at once never load a
half-written library.  Without a compiler, or without the source, the
dataset takes the numpy path (``vshard.VShardReader``); which path a
process took is logged once.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "loader" / "valle_loader.cc"
_LIB_PATH = Path(__file__).resolve().parent / "_native" / "libvalle_data.so"
_lib = None
_lib_failed = False


def _build() -> None:
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
                        "-pthread", str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
    finally:
        tmp.unlink(missing_ok=True)


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    if not _SRC.exists():
        logging.info(f"native loader source {_SRC} not found; data loader takes the numpy path")
        _lib_failed = True
        return None
    if not _LIB_PATH.exists() or _SRC.stat().st_mtime > _LIB_PATH.stat().st_mtime:
        try:
            _build()
        except Exception as e:  # no compiler, or a build error
            logging.info(f"native loader unavailable ({e}); data loader takes the numpy path")
            _lib_failed = True
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as e:
        logging.info(f"native loader dlopen failed ({e}); data loader takes the numpy path")
        _lib_failed = True
        return None
    lib.vl_open.restype = ctypes.c_void_p
    lib.vl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32]
    lib.vl_close.argtypes = [ctypes.c_void_p]
    lib.vl_num_records.restype = ctypes.c_int64
    lib.vl_num_records.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.vl_record_frames.restype = ctypes.c_int32
    lib.vl_record_frames.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64]
    lib.vl_num_quantizers.restype = ctypes.c_int32
    lib.vl_num_quantizers.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.vl_gather_pad.argtypes = [ctypes.c_void_p, i32p, i64p, ctypes.c_int32, ctypes.c_int32,
                                  ctypes.c_int32, i32p, i32p]
    lib.vl_pool_create.restype = ctypes.c_void_p
    lib.vl_pool_create.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.vl_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.vl_pool_submit.restype = ctypes.c_int64
    lib.vl_pool_submit.argtypes = [ctypes.c_void_p, i32p, i64p, ctypes.c_int32, ctypes.c_int32,
                                   ctypes.c_int32]
    lib.vl_pool_wait.restype = ctypes.c_int32
    lib.vl_pool_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64, i32p, i32p]
    logging.info(f"native loader: {_LIB_PATH}")
    _lib = lib
    return lib


def available() -> bool:
    return _load_lib() is not None


class NativeShardSet:
    """A set of VSH1 shards opened by the C++ loader.

    ``gather_pad`` gives the padded int32 (N, max_t, Q) codes and the
    per-utterance lengths; ``submit`` / ``wait`` run the same on the
    loader's worker pool."""

    def __init__(self, paths: Sequence[str | Path], n_threads: int = 4):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native loader not available")
        self._lib = lib
        self.paths = [str(p) for p in paths]
        arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
        self._h = lib.vl_open(arr, len(self.paths))
        if not self._h:
            raise OSError(f"vl_open failed for {self.paths}")
        self._pool = lib.vl_pool_create(self._h, n_threads)
        self._pending = {}

    def num_records(self, shard: int) -> int:
        return int(self._lib.vl_num_records(self._h, shard))

    def record_frames(self, shard: int, rec: int) -> int:
        return int(self._lib.vl_record_frames(self._h, shard, rec))

    def num_quantizers(self, shard: int = 0) -> int:
        return int(self._lib.vl_num_quantizers(self._h, shard))

    def gather_pad(self, shard_idx: Sequence[int], rec_idx: Sequence[int], max_t: int,
                   num_q: int):
        n = len(shard_idx)
        si = np.ascontiguousarray(shard_idx, np.int32)
        ri = np.ascontiguousarray(rec_idx, np.int64)
        codes = np.empty((n, max_t, num_q), np.int32)
        lens = np.empty((n,), np.int32)
        self._lib.vl_gather_pad(self._h, si, ri, n, max_t, num_q, codes, lens)
        return codes, lens

    def submit(self, shard_idx: Sequence[int], rec_idx: Sequence[int], max_t: int,
               num_q: int) -> int:
        n = len(shard_idx)
        si = np.ascontiguousarray(shard_idx, np.int32)
        ri = np.ascontiguousarray(rec_idx, np.int64)
        jid = self._lib.vl_pool_submit(self._pool, si, ri, n, max_t, num_q)
        self._pending[jid] = (n, max_t, num_q)
        return jid

    def wait(self, job_id: int):
        n, max_t, num_q = self._pending.pop(job_id)
        codes = np.empty((n, max_t, num_q), np.int32)
        lens = np.empty((n,), np.int32)
        if self._lib.vl_pool_wait(self._pool, job_id, codes, lens) != 0:
            raise RuntimeError(f"unknown native job {job_id}")
        return codes, lens

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.vl_pool_destroy(self._pool)
            self._lib.vl_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
