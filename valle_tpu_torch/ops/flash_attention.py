"""Attention with a dense additive bias: kernel 4 of the port.

``flash_attention_biased`` is the twin of the JAX function of the same name
(``valle_tpu/ops/flash_attention.py``) on its dense ``ab`` branch, where JAX
calls its library Pallas flash kernel: ``softmax((q kᵀ + bias) * scale) v``
with ``scale = 1 / sqrt(Dh)``, bias before scale as the library orders them.
It is differentiable in q, k, v and the bias, like the library's
``custom_vjp``.  For a CUDA tensor the forward launches the hand-written
kernel ``flash_attention_launch`` of ``csrc/prefix_attention.cu`` and the
backward ``flash_attention_bwd_launch`` of ``csrc/prefix_attention_bwd.cu``
(the dense-bias instantiations of kernels 2 and 3's tile bodies); for a CPU
tensor both run their plain PyTorch versions, :func:`flash_attention_forward_reference` and
:func:`flash_attention_backward_reference`.

The bias is f32 and broadcastable to (B, H, Tq, Tk); the kernels read it
through its strides, so a (B, 1, Tq, Tk) mask is not copied per head, and
nothing is padded to 128 as the JAX wrapper pads.  Its key-padding branch
(a (B, 1, 1, Tk) bias) runs on kernels 2 and 3 (``ops/fused_attention.py``).

A row whose every column is masked (-1e9) averages v over its Tk columns;
the JAX wrapper also averages the zero columns it pads to 128, so such rows
differ from JAX's.  They occur only in rows that the callers' losses skip.

A head dim outside the instantiated ones runs zero-padded, as in kernels 2
and 3 (``ops/fused_attention.py::run_padded``); d(bias) does not depend on
Dh.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from valle_tpu_torch.ops import cuda_build
from valle_tpu_torch.ops.fused_attention import (
    _DTYPES, _check_heads_contiguous, _compute_dtype, _scale, kernel_head_dim, run_padded)


def _logits(q, k, bias, cdt, scale=None):
    """(B, H, Tq, Tk) ``(q kᵀ + bias) * scale`` in the compute dtype;
    ``scale`` defaults to 1 / sqrt(Dh)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(cdt), k.to(cdt))
    return (s + bias.to(cdt)) * _scale(q, scale)


def flash_attention_forward_reference(q, k, v, bias, scale=None
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 4's forward: (out like ``q``, row
    log-sum-exp (B, H, Tq) in f32, or f64 for f64 inputs).

    The normalised P is rounded to the input dtype before P.V, as the
    library's kernel does when the keys fit one block (Tk <= 1024 after its
    padding to 128, every shape of the port's callers); over several key
    blocks the library rounds P before it normalises.  ``scale`` defaults to
    1 / sqrt(Dh)."""
    cdt = _compute_dtype(q)
    s = _logits(q, k, bias, cdt, scale)
    probs = torch.softmax(s, dim=-1).to(q.dtype).to(cdt)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(cdt)).to(q.dtype)
    return out, torch.logsumexp(s, dim=-1)


def flash_attention_backward_reference(q, k, v, bias, out, dout, lse, bias_grad: bool = False,
                                       scale=None):
    """Plain PyTorch version of kernel 4's backward, in the library's order:
    (dq, dk, dv, d(bias) as (B, H, Tq, Tk) in f32 or None).

    P is recomputed from the saved log-sum-exp; P and dS are rounded to the
    input dtype before their products, as the library casts them."""
    cdt = _compute_dtype(q)
    lo = q.dtype
    scale = _scale(q, scale)
    p = torch.exp(_logits(q, k, bias, cdt, scale) - lse.to(cdt)[..., None])
    dout_c = dout.to(cdt)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout_c, v.to(cdt))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(lo).to(cdt), dout_c)
    delta = (dout_c * out.to(cdt)).sum(-1).transpose(1, 2)  # (B, H, Tq)
    ds = (dp - delta[..., None]) * p * scale
    ds_lo = ds.to(lo).to(cdt)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_lo, k.to(cdt))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_lo, q.to(cdt))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), ds if bias_grad else None


_FWD_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 3
    + [ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 2
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
)
_BWD_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 3
    + [ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
)


def _check_shapes(q, k, v, bias) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, T, H, Dh)")
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    if k.shape != (b, tk, h, dh) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    full = (b, h, tq, tk)
    if bias.dim() != 4 or any(n not in (1, m) for n, m in zip(bias.shape, full)):
        raise ValueError(f"bias {tuple(bias.shape)} does not broadcast to (B, H, Tq, Tk) = {full}")


def _check_cuda(q, k, v, bias) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must share float32 or bfloat16, "
                         f"got {q.dtype} {k.dtype} {v.dtype}")
    kernel_head_dim(q.shape[-1])  # raises above 128
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    for name, x in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_heads_contiguous(name, x)
    if bias.dtype != torch.float32:
        raise ValueError(f"bias must be float32, got {bias.dtype}")


def _bias_args(q, k, bias):
    """The bias pointer and its (b, h, row, col) element strides, 0 on a
    broadcast dimension."""
    b, tq, h, _ = q.shape
    full = bias.expand(b, h, tq, k.shape[1])
    return (full.data_ptr(), *full.stride())


def _forward(q, k, v, bias, with_lse):
    """(out, lse or None): kernel 4 on CUDA, the plain version on the CPU."""
    if not q.is_cuda:
        out, lse = flash_attention_forward_reference(q, k, v, bias)
        return out, lse if with_lse else None
    _check_cuda(q, k, v, bias)
    return run_padded(_launch_forward, (q, k, v), bias, with_lse, n_sliced=1)


def _launch_forward(q, k, v, bias, with_lse, *, scale):
    """Kernel 4's forward at an instantiated head dim: (out, lse or None)."""
    b, tq, h, dh = q.shape
    out = torch.empty((b, tq, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device) if with_lse else None
    fn = cuda_build.load("prefix_attention").flash_attention_launch
    fn.restype, fn.argtypes = ctypes.c_int, _FWD_ARGTYPES
    err = fn(
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(1),
        *_bias_args(q, k, bias), out.data_ptr(), lse.data_ptr() if lse is not None else None,
        _DTYPES[q.dtype], b, tq, k.shape[1], h, dh, scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention_biased.launches += 1
    return out, lse


def flash_attention_biased_backward(q, k, v, bias, out, dout, lse, *, bias_grad: bool = False):
    """(dq, dk, dv, d(bias) or None) of :func:`flash_attention_biased`:
    kernel 4's backward on CUDA, the plain version on the CPU.  ``out`` and
    ``lse`` are the forward's; d(bias) is (B, H, Tq, Tk) f32, not summed over
    the bias's broadcast dimensions."""
    _check_shapes(q, k, v, bias)
    b, tq, h, dh = q.shape
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (b, h, tq):
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must be like q "
                         f"{tuple(q.shape)}, lse {tuple(lse.shape)} must be {(b, h, tq)}")
    if not q.is_cuda:
        return flash_attention_backward_reference(q, k, v, bias, out, dout, lse, bias_grad)
    _check_cuda(q, k, v, bias)
    dout = dout.to(q.dtype).contiguous()
    out = out.to(q.dtype).contiguous()
    for name, x in (("out", out), ("dout", dout), ("lse", lse)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous float32 tensor")
    return run_padded(_launch_backward, (q, k, v, out, dout), bias, lse, bias_grad, n_sliced=3)


def _launch_backward(q, k, v, out, dout, bias, lse, bias_grad, *, scale):
    """Kernel 4's backward at an instantiated head dim: (dq, dk, dv, d(bias)
    or None)."""
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, tq, h, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, h, dh), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, tk, h, dh), dtype=q.dtype, device=q.device)
    dbias = (torch.empty((b, h, tq, tk), dtype=torch.float32, device=q.device)
             if bias_grad else None)
    fn = cuda_build.load("prefix_attention_bwd").flash_attention_bwd_launch
    fn.restype, fn.argtypes = ctypes.c_int, _BWD_ARGTYPES
    err = fn(
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(1),
        *_bias_args(q, k, bias),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        dbias.data_ptr() if dbias is not None else None,
        _DTYPES[q.dtype], b, tq, tk, h, dh, scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: cudaError {err}")
    flash_attention_biased_backward.launches += 1
    return dq, dk, dv, dbias


class _FlashAttentionBiased(torch.autograd.Function):
    """The twin of the library kernel's ``custom_vjp``: the forward saves its
    output and row log-sum-exp; d(bias) is computed only when the bias needs
    a gradient, and summed over its broadcast dimensions."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        out, lse = _forward(q, k, v, bias, with_lse=True)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = flash_attention_biased_backward(
            q, k, v, bias, out, dout, lse, bias_grad=ctx.needs_input_grad[3])
        if dbias is not None:
            dbias = dbias.sum_to_size(bias.shape)
        return dq, dk, dv, dbias


def flash_attention_biased(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
) -> torch.Tensor:
    """(B,Tq,H,Dh) x (B,Tk,H,Dh) x (B,Tk,H,Dh) -> (B,Tq,H,Dh), like ``q``;
    differentiable in q, k, v and ``bias``.

    bias: additive, 4-D and broadcastable to (B, H, Tq, Tk); taken in f32.
    """
    _check_shapes(q, k, v, bias)
    bias = bias.float()
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v, bias)):
        return _FlashAttentionBiased.apply(q, k, v, bias)
    return _forward(q, k, v, bias, with_lse=False)[0]


flash_attention_biased.launches = 0
flash_attention_biased_backward.launches = 0
