"""Ragged decode attention: kernel 1 of the port.

``ragged_decode_attention`` is the twin of the JAX function of the same name
(``valle_tpu/ops/ragged_decode.py``): per batch slot ``b``, single-query
attention over KV columns ``[0, lengths[b])`` only; a slot of length 0 (a
finished request) reads nothing and yields zeros.  For a CUDA tensor it
launches the hand-written kernel ``csrc/ragged_decode.cu`` (a split-K kernel
over column runs of the cache, then a kernel that combines the runs); for a
CPU tensor it runs :func:`ragged_decode_attention_reference`, the plain
PyTorch version.

The JAX kernel rounds q and K to bf16 for the TPU's matrix unit; the CUDA
kernel computes in f32 from the stored type, like the reference.

Head dims: the kernel's lane layouts take any head up to Dh 1024
(``MAX_HEAD_DIM``) and any number of heads (a row of more head groups than
a block has warps is cut into head slices); a head above 1024 elements takes
the strided layout, one block per (split, slot, head), at any Dh (past 16384
elements in int8 and bf16, 8192 in f32, the scores come first from a kernel
of their own, and V is summed in slices of the head, a block each).  No head
is padded in device memory: the kernel stages each head into a slot of whole 16-byte chunks
in shared memory (:func:`padded_head_dim`) whose pad bytes are zero, so a
call copies nothing of the cache.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from valle_tpu_torch.ops import cuda_build

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 11
    + [ctypes.c_float, ctypes.c_void_p]
)
MAX_HEAD_GROUPS = 16  # warps of a block, one per 512-byte head group (kMaxWarps)
WIDE_HEAD_GROUPS = 8  # the same for a layout of 32 accumulator floats per lane (kWideWarps)
MAX_HEAD_DIM = 1024  # the lane layouts': 32 lanes x 8 chunks of 16 bytes in f32 (kMaxG)
STRIDED_WARPS = 8  # warps of a strided-layout block (kWideWarps)
STRIDED_MAX_COLS = 32  # columns of a strided-layout tile, at most: a lane each (kStridedMaxCols)
STRIDED_STAGE_BYTES = 72 * 1024  # its ring's stage, about: three fit a block (kStridedStages)
MAX_GRID_Z = 65535  # the grid's z dimension (head slices), at most
BLOCKS_PER_SM = 2  # the split-K grid's target size over the card's SMs at B > 1 (1 at B = 1)
MIN_SPLIT_COLS = 4
COLS_PER_WARP = 8  # columns a warp takes from each stage (kMaxColsPerWarp), at most
STAGES = 2  # the ring's depth (kStages)
SMEM_BYTES = 232448  # shared memory a block may use


class SplitPlan(NamedTuple):
    """How the kernel cuts one call (``csrc/ragged_decode.cu``):
    ``split_cols`` columns per block (the last split of a slot may be
    shorter), ``n_splits`` splits per slot, ``stage_cols`` columns per stage
    of the shared-memory ring, of which each warp takes ``cols_per_warp``,
    ``n_groups`` head groups per block and ``warps_per_group`` warps on
    each head group (``stage_cols = cols_per_warp * warps_per_group``), and
    ``n_slices`` head slices of a row, each a block of its own."""

    split_cols: int
    n_splits: int
    stage_cols: int
    cols_per_warp: int
    n_groups: int
    warps_per_group: int
    n_slices: int


def padded_head_dim(dh: int, kv_bytes: int) -> int:
    """The width of a head of ``dh`` elements of ``kv_bytes`` bytes in
    kernel 1's shared memory: the next whole number of 16-byte chunks.  The
    kernel stages each head into a slot of that width and zeroes the slot's
    pad bytes; the cache and the output keep ``dh``."""
    per_chunk = 16 // kv_bytes
    return -(-dh // per_chunk) * per_chunk


def split_plan(b: int, cap: int, h: int, dh: int, kv_bytes: int, sms: int) -> SplitPlan:
    """The kernel's plan for a (B, C, H, Dh) cache of ``kv_bytes``-byte
    elements on a card with ``sms`` SMs, at the true Dh (the layout is that
    of the head's slot in shared memory, :func:`padded_head_dim`).  It
    depends on the shapes only, never on the lengths, so a launch needs no
    host read.

    Above ``MAX_HEAD_DIM`` the plan is the strided layout's: a block of
    ``STRIDED_WARPS`` warps per (split, slot, head), so ``n_slices = h`` and
    one head group; the splits are cut as below with the heads in place of
    slices.  A tile holds ``stage_cols`` columns (at least one, at most
    ``STRIDED_MAX_COLS``, about ``STRIDED_STAGE_BYTES`` of K and V), which
    every warp takes (``cols_per_warp = stage_cols``), evened out over the
    split's tiles; the ring holds up to three of them.

    A head of Dh elements takes G = ceil(Dh * kv_bytes / 16) chunks of 16
    bytes; it takes LPH lanes (G rounded up to a power of two, at most 32),
    each CPH chunks (1, or G / 32 rounded up to a power of two), so a 512-byte head
    group holds 32 / LPH heads.  A block takes at most ``MAX_HEAD_GROUPS``
    head groups (``WIDE_HEAD_GROUPS`` where a lane holds 32 accumulator
    floats); a row of more is cut into ``n_slices`` slices of equal groups.
    The grid is about ``BLOCKS_PER_SM`` blocks per SM at B > 1 and one at B
    = 1: a split is floor(C / n) columns, at least ``MIN_SPLIT_COLS``, for n
    = ceil(blocks per SM * SMs / (B * slices)).  (At B = 1, two blocks per
    SM were slower in probes: splits of 2-3 columns at C = 768, whose
    partials cost the combine more than the grid gains.)  A warp takes up
    to ``COLS_PER_WARP`` columns of each stage: a whole split in one stage
    where that fits, else as many as let the ``STAGES`` stages of every
    block of the grid fit the SMs' shared memory at once."""
    if dh < 1:
        raise ValueError(f"head dim {dh}: kernel 1 needs at least one element")
    per_sm = 1 if b == 1 else BLOCKS_PER_SM
    slot = padded_head_dim(dh, kv_bytes) * kv_bytes  # a head's bytes in shared memory
    if dh > MAX_HEAD_DIM:  # the strided layout
        if h > MAX_GRID_Z:  # d above 67 M: no card holds such a model
            raise ValueError(f"{h} heads of Dh {dh}: kernel 1 takes at most {MAX_GRID_Z}")
        split_cols = max(MIN_SPLIT_COLS, cap // -(-per_sm * sms // (b * h)))
        widest = max(1, min(STRIDED_MAX_COLS, split_cols,
                            STRIDED_STAGE_BYTES // (2 * slot + 12)))
        stage_cols = -(-split_cols // -(-split_cols // widest))  # even tiles
        return SplitPlan(split_cols, -(-cap // split_cols), stage_cols, stage_cols, 1,
                         STRIDED_WARPS, h)
    g = slot // 16
    lanes_per_head = min(32, 1 << (g - 1).bit_length())
    per_lane = 1 << (-(-g // lanes_per_head) - 1).bit_length()
    max_groups = WIDE_HEAD_GROUPS if per_lane * 16 // kv_bytes > 16 else MAX_HEAD_GROUPS
    heads_per_group = 32 // lanes_per_head
    groups = -(-h // heads_per_group)
    n_slices = -(-groups // max_groups)
    n_groups = -(-groups // n_slices)
    slice_heads = h if n_slices == 1 else n_groups * heads_per_group
    warps_per_group = max(1, 8 // n_groups)
    # K and V of the slice's heads, the scales of all H heads, the bias
    col_bytes = 2 * slice_heads * slot + (8 * h if kv_bytes == 1 else 0) + 4
    split_cols = max(MIN_SPLIT_COLS, cap // -(-per_sm * sms // (b * n_slices)))
    n_splits = -(-cap // split_cols)
    # the rings of the whole grid in one wave of the SMs' shared memory; 64 and
    # 96 bytes of slack cover the 16-byte alignment of each stage's arrays.  A
    # split that fits one stage is read in one tile (and the kernel allocates
    # one stage); longer ones stream through STAGES stages.
    budget = SMEM_BYTES // -(-b * n_splits * n_slices // sms) - 64
    one_tile = -(-split_cols // warps_per_group)
    if one_tile <= COLS_PER_WARP and one_tile * warps_per_group * col_bytes + 96 <= budget:
        cols_per_warp = one_tile
    else:
        cols_per_warp = max(1, min(COLS_PER_WARP,
                                   budget // (STAGES * warps_per_group * col_bytes + 96)))
    return SplitPlan(split_cols, n_splits, cols_per_warp * warps_per_group, cols_per_warp,
                     n_groups, warps_per_group, n_slices)


@functools.lru_cache(maxsize=None)
def _cached_plan(b, cap, h, dh, kv_bytes, device_index) -> SplitPlan:
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return split_plan(b, cap, h, dh, kv_bytes, sms)


@functools.lru_cache(maxsize=None)
def _f32_scale(dh: int) -> float:
    """1 / sqrt(dh) in f32 arithmetic: the logits' scale, as the plain
    version's division by sqrt(dh) gives it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = cuda_build.load("ragged_decode").ragged_decode_attention_launch
    fn.restype, fn.argtypes = ctypes.c_int, _ARGTYPES
    return fn


def ragged_decode_attention_reference(
    q, k, v, lengths, bias=None, k_scale=None, v_scale=None, scale=None
) -> torch.Tensor:
    """Plain PyTorch version (the twin of the JAX
    ``ragged_decode_attention_reference``): dense f32 math plus the hard
    length clip; ``scale`` defaults to 1 / sqrt(Dh).  Returns (B, 1, H, Dh)
    f32."""
    if q.dim() == 4:
        q = q[:, 0]
    cap = k.shape[1]
    logits = torch.einsum("bhd,bchd->bhc", q.float(), k.float())
    logits = logits / math.sqrt(q.shape[-1]) if scale is None else logits * scale
    if k_scale is not None:
        logits = logits * k_scale.transpose(1, 2)
    if bias is not None:
        logits = logits + bias[:, None, :]
    live = torch.arange(cap, device=q.device)[None, None, :] < lengths[:, None, None]
    logits = logits.masked_fill(~live, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(live, probs, torch.zeros((), device=q.device))  # length 0 -> zeros
    if v_scale is not None:
        probs = probs * v_scale.transpose(1, 2)
    return torch.einsum("bhc,bchd->bhd", probs, v.float())[:, None]


def ragged_decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    lengths: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-query attention over a per-slot length-clipped KV cache.

    Args:
      q: (B, H, Dh) or (B, 1, H, Dh) queries, f32 or bf16.
      k, v: (B, C, H, Dh) cache: int8 (with scales), f32 or bf16.
      lengths: (B,) int32; slot b attends over columns [0, min(lengths[b], C)).
      bias: optional (B, C) additive f32 bias (prompt-padding holes).
      k_scale, v_scale: (B, C, H) f32 per-(token, head) scales, required iff
        k and v are int8.

    Returns (B, 1, H, Dh) f32.
    """
    if q.dim() == 4 and q.shape[1] != 1:
        raise ValueError("decode kernel: Tq must be 1")
    b, h, dh = q.shape[0], q.shape[-2], q.shape[-1]
    cap = k.shape[1]
    if k.shape != (b, cap, h, dh) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    quantized = k.dtype == torch.int8
    if quantized != (k_scale is not None) or quantized != (v_scale is not None):
        raise ValueError("k_scale and v_scale are required iff the cache is int8")
    if not q.is_cuda:
        return ragged_decode_attention_reference(q, k, v, lengths, bias, k_scale, v_scale)

    # The checks below are written for a short host path: generate calls this
    # once per layer and step.
    q_code, kv_code = _Q_DTYPES.get(q.dtype), _KV_DTYPES.get(k.dtype)
    if q_code is None:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if kv_code is None or v.dtype != k.dtype:
        raise ValueError(f"k, v must share int8, float32 or bfloat16, got {k.dtype} {v.dtype}")
    device = q.device
    plan = _cached_plan(b, cap, h, dh, k.element_size(), device.index)
    if q.stride(-1) != 1 or q.stride(-2) != dh:
        raise ValueError(f"q: the (H, Dh) axes must be contiguous, got strides {q.stride()}")
    k_ptr, v_ptr = k.data_ptr(), v.data_ptr()
    if not (k.is_contiguous() and v.is_contiguous()) or (k_ptr | v_ptr) % 16:
        raise ValueError("k and v must be contiguous and 16-byte aligned")
    if lengths.shape != (b,) or lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous (B,) int32 tensor")
    for name, x, shape in (("bias", bias, (b, cap)), ("k_scale", k_scale, (b, cap, h)),
                           ("v_scale", v_scale, (b, cap, h))):
        if x is not None and (x.shape != shape or x.dtype != torch.float32
                              or not x.is_contiguous() or x.device != device):
            raise ValueError(f"{name} must be a contiguous float32 tensor of shape {shape} "
                             f"on {device}")
    if k.device != device or v.device != device or lengths.device != device:
        raise ValueError(f"all inputs must be on {device}")

    out = torch.empty((b, 1, h, dh), dtype=torch.float32, device=device)
    # (acc, m, l) per split, and past MAX_HEAD_DIM room for the widest heads' scores
    scratch = b * plan.n_splits * h * (dh + 2) + (b * h * cap if dh > MAX_HEAD_DIM else 0)
    partials = torch.empty(scratch, dtype=torch.float32, device=device)
    err = _launcher()(
        q.data_ptr(), q.stride(0), q_code, k_ptr, v_ptr, kv_code,
        None if k_scale is None else k_scale.data_ptr(),
        None if v_scale is None else v_scale.data_ptr(),
        None if bias is None else bias.data_ptr(), lengths.data_ptr(), partials.data_ptr(),
        out.data_ptr(), b, cap, h, dh, *plan, _f32_scale(dh),
        torch._C._cuda_getCurrentRawStream(device.index),
    )
    if err != 0:
        raise RuntimeError(f"ragged_decode kernel launch failed: cudaError {err}")
    ragged_decode_attention.launches += 1
    return out


ragged_decode_attention.launches = 0
