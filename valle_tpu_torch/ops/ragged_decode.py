"""Ragged decode attention: kernel 1 of the port.

``ragged_decode_attention`` is the twin of the JAX function of the same name
(``valle_tpu/ops/ragged_decode.py``): per batch slot ``b``, single-query
attention over KV columns ``[0, lengths[b])`` only; a slot of length 0 (a
finished request) reads nothing and yields zeros.  For a CUDA tensor it
launches the hand-written kernel ``csrc/ragged_decode.cu``; for a CPU tensor
it runs :func:`ragged_decode_attention_reference`, the plain PyTorch version.

The JAX kernel rounds q and K to bf16 for the TPU's matrix unit; the CUDA
kernel computes in f32 from the stored type, like the reference.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from valle_tpu_torch.ops import cuda_build

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_COLUMNS = 32768  # the kernel keeps one f32 logit per live column in shared memory
_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
    + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 5
    + [ctypes.c_int] * 4
    + [ctypes.c_void_p]
)


def ragged_decode_attention_reference(
    q, k, v, lengths, bias=None, k_scale=None, v_scale=None
) -> torch.Tensor:
    """Plain PyTorch version (the twin of the JAX
    ``ragged_decode_attention_reference``): dense f32 math plus the hard
    length clip.  Returns (B, 1, H, Dh) f32."""
    if q.dim() == 4:
        q = q[:, 0]
    dh = q.shape[-1]
    cap = k.shape[1]
    logits = torch.einsum("bhd,bchd->bhc", q.float(), k.float()) / math.sqrt(dh)
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
    q3 = q[:, 0] if q.dim() == 4 else q
    if q.dim() == 4 and q.shape[1] != 1:
        raise ValueError("decode kernel: Tq must be 1")
    b, h, dh = q3.shape
    cap = k.shape[1]
    if k.shape != (b, cap, h, dh) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    quantized = k.dtype == torch.int8
    if quantized != (k_scale is not None) or quantized != (v_scale is not None):
        raise ValueError("k_scale and v_scale are required iff the cache is int8")
    if not q.is_cuda:
        return ragged_decode_attention_reference(q3, k, v, lengths, bias, k_scale, v_scale)

    if q3.dtype not in _Q_DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q3.dtype}")
    if k.dtype not in _KV_DTYPES or v.dtype != k.dtype:
        raise ValueError(f"k, v must share int8, float32 or bfloat16, got {k.dtype} {v.dtype}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {_HEAD_DIMS}")
    if cap > _MAX_COLUMNS:
        raise ValueError(f"cache width {cap} exceeds {_MAX_COLUMNS}")
    if q3.stride(2) != 1 or q3.stride(1) != dh:
        raise ValueError(f"q: the (H, Dh) axes must be contiguous, got strides {q3.stride()}")
    for name, x in (("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if lengths.shape != (b,) or lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous (B,) int32 tensor")
    f32_args = {"bias": (bias, (b, cap)), "k_scale": (k_scale, (b, cap, h)),
                "v_scale": (v_scale, (b, cap, h))}
    for name, (x, shape) in f32_args.items():
        if x is not None and (x.shape != shape or x.dtype != torch.float32
                              or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor of shape {shape}")
    for x in (k, v, lengths, bias, k_scale, v_scale):
        if x is not None and x.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}")

    out = torch.empty((b, 1, h, dh), dtype=torch.float32, device=q.device)
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    fn = cuda_build.load("ragged_decode").ragged_decode_attention_launch
    fn.restype, fn.argtypes = ctypes.c_int, _ARGTYPES
    err = fn(
        q3.data_ptr(), q3.stride(0), _Q_DTYPES[q3.dtype],
        k.data_ptr(), v.data_ptr(), _KV_DTYPES[k.dtype],
        ptr(k_scale), ptr(v_scale), ptr(bias), lengths.data_ptr(), out.data_ptr(),
        b, cap, h, dh,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ragged_decode kernel launch failed: cudaError {err}")
    ragged_decode_attention.launches += 1
    return out


ragged_decode_attention.launches = 0
