"""Prefix-LM / dense attention forward: kernel 2 of the port.

``fused_prefix_attention`` is the twin of the JAX wrapper of the same name
(``valle_tpu/ops/fused_attention.py``) at dropout 0.  For a CUDA tensor it
launches the hand-written kernel ``csrc/prefix_attention.cu``; for a CPU
tensor it runs :func:`fused_prefix_attention_reference`, the plain PyTorch
version of the same function.  Dropout and the backward belong to the
training slice of the port.

Masking: a structurally masked column is excluded, and the (B, Tk) key bias
is added.  On every row that sees at least one visible column this equals the
JAX kernel, which adds -1e9 for the structural mask instead; the two differ
only on rows whose columns are all masked, which no caller reads.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from valle_tpu_torch.ops import cuda_build
from valle_tpu_torch.ops.masks import prefix_lm_attn_mask

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)


def fused_prefix_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_bias: Optional[torch.Tensor],
    prefix_s: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version: (B,Tq,H,Dh) x (B,Tk,H,Dh) -> like ``q``, with
    the f32 softmax of the kernel."""
    dh = q.shape[-1]
    tq, tk = q.shape[1], k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(dh))
    if kv_bias is not None:
        logits = logits + kv_bias.float()[:, None, None, :]
    if prefix_s is not None:
        struct = prefix_lm_attn_mask(prefix_s, tk - prefix_s, device=q.device)[:tq]
        logits = logits.masked_fill(struct, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 3
    + [ctypes.c_void_p, ctypes.c_void_p]
    + [ctypes.c_int] * 7
    + [ctypes.c_void_p]
)


def _check_heads_contiguous(name: str, x: torch.Tensor) -> None:
    """The kernel takes any batch and row strides (so q, k, v may be views
    of one packed projection) but needs each row's (H, Dh) contiguous."""
    if x.stride(3) != 1 or x.stride(2) != x.shape[3]:
        raise ValueError(f"{name}: the (H, Dh) axes must be contiguous, got strides {x.stride()}")


def fused_prefix_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_bias: Optional[torch.Tensor],
    *,
    prefix_s: Optional[int] = None,
    dropout_rate: float = 0.0,
) -> torch.Tensor:
    """(B,Tq,H,Dh) x (B,Tk,H,Dh) x (B,Tk,H,Dh) -> (B,Tq,H,Dh), like ``q``.

    kv_bias: (B, Tk) f32 additive key-validity row (0 visible, -1e9 masked),
      or None.
    prefix_s: None = dense (key padding only; Tq may differ from Tk);
      0 = causal; s > 0 = [text ; audio] prefix-LM.  Not None needs Tq == Tk.
    """
    if dropout_rate > 0.0:
        raise NotImplementedError("attention dropout comes with the training slice of the port")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, T, H, Dh)")
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if k.shape != (b, tk, h, dh) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if prefix_s is not None and (tq != tk or not 0 <= prefix_s <= tk):
        raise ValueError("prefix mode needs Tq == Tk and 0 <= prefix_s <= Tk "
                         f"(got {tq}, {tk}, {prefix_s})")
    if kv_bias is not None and kv_bias.shape != (b, tk):
        raise ValueError(f"kv_bias must be (B, Tk) = {(b, tk)}, got {tuple(kv_bias.shape)}")
    if not q.is_cuda:
        return fused_prefix_attention_reference(q, k, v, kv_bias, prefix_s)

    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must share float32 or bfloat16, "
                         f"got {q.dtype} {k.dtype} {v.dtype}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {_HEAD_DIMS}")
    if tq == 0 or tk == 0:
        raise ValueError("empty sequence")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        _check_heads_contiguous(name, x)
    if kv_bias is not None:
        if (kv_bias.dtype != torch.float32 or not kv_bias.is_contiguous()
                or kv_bias.device != q.device):
            raise ValueError("kv_bias must be a contiguous float32 tensor on q's device")
    out = torch.empty((b, tq, h, dh), dtype=q.dtype, device=q.device)
    lib = cuda_build.load("prefix_attention")
    fn = lib.prefix_attention_launch
    fn.restype, fn.argtypes = ctypes.c_int, _ARGTYPES
    err = fn(
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(1),
        kv_bias.data_ptr() if kv_bias is not None else None,
        out.data_ptr(), _DTYPES[q.dtype], b, tq, tk, h, dh,
        -1 if prefix_s is None else prefix_s,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"prefix_attention kernel launch failed: cudaError {err}")
    fused_prefix_attention.launches += 1
    return out


fused_prefix_attention.launches = 0
