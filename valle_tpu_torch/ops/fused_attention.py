"""Prefix-LM / dense attention with dropout: kernels 2 and 3 of the port.

``fused_prefix_attention`` is the twin of the JAX wrapper of the same name
(``valle_tpu/ops/fused_attention.py``), differentiable like its
``custom_vjp``.  For a CUDA tensor the forward launches the hand-written
kernel ``csrc/prefix_attention.cu`` (kernel 2) and the backward launches
``csrc/prefix_attention_bwd.cu`` (kernel 3, the port of ``_bwd_kernel``); for
a CPU tensor both run their plain PyTorch versions,
:func:`attention_forward_reference` and :func:`attention_backward_reference`.

Dropout follows the TPU kernel: the probabilities are normalised by the row
sum taken before dropout, and the kept ones are scaled by 1 / (1 - rate).
The keep bits are per-element Philox4x32-10 from a 64-bit seed
(``ops/philox.py``), so the forward, the backward and the plain versions
draw the same mask; the stream differs from the TPU's hardware bits.

Masking: a structurally masked column is excluded, and the (B, Tk) key bias
is added.  On every row that sees at least one visible column this equals the
JAX kernel, which adds -1e9 for the structural mask instead; the two differ
only on rows whose columns are all masked, which no caller reads.

Head dims: the kernels are instantiated for Dh in ``KERNEL_HEAD_DIMS``; any
other Dh up to 128 runs zero-padded to the next of them, with the scale of
the true Dh (:func:`run_padded`, shared with kernel 4).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
from torch.nn import functional as F

from valle_tpu_torch.ops import cuda_build
from valle_tpu_torch.ops.masks import prefix_lm_attn_mask
from valle_tpu_torch.ops.philox import dropout_keep_mask, keep_threshold

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_HEAD_DIMS = (16, 32, 64, 128)  # the head dims kernels 2-4 are instantiated for


def kernel_head_dim(dh: int) -> int:
    """The instantiated head dim that kernels 2-4 run a head dim of ``dh``
    at: the next of ``KERNEL_HEAD_DIMS``."""
    for n in KERNEL_HEAD_DIMS:
        if dh <= n:
            return n
    raise ValueError(f"head dim {dh}: kernels 2-4 take head dims up to {KERNEL_HEAD_DIMS[-1]}")


def run_padded(launch, padded, *args, n_sliced: int):
    """``launch(*padded, *args, scale=1 / sqrt(Dh))`` with each tensor of
    ``padded`` zero-padded on its last axis from Dh (``padded[0]``'s) to
    ``kernel_head_dim(Dh)``, and the first ``n_sliced`` results sliced back
    to Dh.  Zero columns of q and k leave q kᵀ unchanged, and zero columns of
    v, out and dout make the padded columns of out, dq, dk and dv exactly
    zero, so the kernel computes the function at the true Dh."""
    dh = padded[0].shape[-1]
    n = kernel_head_dim(dh)
    if n != dh:
        padded = [F.pad(x, (0, n - dh)) for x in padded]
    res = launch(*padded, *args, scale=1.0 / math.sqrt(dh))
    if n == dh:
        return res
    return tuple(r[..., :dh].contiguous() if i < n_sliced else r for i, r in enumerate(res))


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def _logits(q, k, kv_bias, prefix_s, cdt, scale=None):
    """(B, H, Tq, Tk) scaled logits plus key bias, -inf where structurally
    masked, in the compute dtype ``cdt``; ``scale`` defaults to
    1 / sqrt(Dh)."""
    tq, tk = q.shape[1], k.shape[1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(cdt), k.to(cdt)) * _scale(q, scale)
    if kv_bias is not None:
        logits = logits + kv_bias.to(cdt)[:, None, None, :]
    if prefix_s is not None:
        struct = prefix_lm_attn_mask(prefix_s, tk - prefix_s, device=q.device)[:tq]
        logits = logits.masked_fill(struct, float("-inf"))
    return logits


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _keep(q, k, rate, seed):
    b, tq, h, _ = q.shape
    return dropout_keep_mask(seed, b, h, tq, k.shape[1], rate, device=q.device)


def attention_forward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_bias: Optional[torch.Tensor],
    prefix_s: Optional[int] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel 2: (out like ``q``, row log-sum-exp
    (B, H, Tq) in f32, or f64 for f64 inputs).

    In ``_fwd_kernel``'s order: p = exp(logits - row max), dropout, p rounded
    to the input dtype, P.V summed in the compute dtype, then divided by the
    row sum of p taken before dropout.  ``scale`` (default 1 / sqrt(Dh)) is
    the logits' scale."""
    cdt = _compute_dtype(q)
    logits = _logits(q, k, kv_bias, prefix_s, cdt, scale)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1)
    lse = m[..., 0] + torch.log(l)
    if dropout_rate > 0.0:
        keep = _keep(q, k, dropout_rate, dropout_seed)
        p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).to(cdt), v.to(cdt))
    return (acc / l.transpose(1, 2)[..., None]).to(q.dtype), lse


def fused_prefix_attention_reference(q, k, v, kv_bias, prefix_s=None):
    """Plain PyTorch version at dropout 0: (B,Tq,H,Dh) x (B,Tk,H,Dh) -> like
    ``q``, with the f32 softmax and the bf16 rounding of P of the kernel."""
    return attention_forward_reference(q, k, v, kv_bias, prefix_s)[0]


def attention_backward_reference(
    q, k, v, kv_bias, out, dout, lse, prefix_s=None, dropout_rate=0.0, dropout_seed=None,
    scale=None,
):
    """Plain PyTorch version of kernel 3: (dq, dk, dv) in the input dtypes.

    P is recomputed from the saved log-sum-exp; Pd and dS are rounded to the
    input dtype before their products, as ``_bwd_kernel`` casts them."""
    cdt = _compute_dtype(q)
    lo = q.dtype
    scale = _scale(q, scale)
    p = torch.exp(_logits(q, k, kv_bias, prefix_s, cdt, scale) - lse.to(cdt)[..., None])
    dout_c = dout.to(cdt)
    dpd = torch.einsum("bqhd,bkhd->bhqk", dout_c, v.to(cdt))
    if dropout_rate > 0.0:
        keep = _keep(q, k, dropout_rate, dropout_seed)
        inv = 1.0 / (1.0 - dropout_rate)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dpd * inv, 0.0)
    else:
        pd, dp = p, dpd
    dv = torch.einsum("bhqk,bqhd->bkhd", pd.to(lo).to(cdt), dout_c)
    delta = (dout_c * out.to(cdt)).sum(-1).transpose(1, 2)  # (B, H, Tq)
    ds = (p * (dp - delta[..., None])).to(lo).to(cdt)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(cdt)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(cdt)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_FWD_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 3
    + [ctypes.c_void_p] * 3
    + [ctypes.c_int] * 7
    + [ctypes.c_uint, ctypes.c_float, ctypes.c_ulonglong, ctypes.c_float, ctypes.c_void_p]
)
_BWD_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 3
    + [ctypes.c_void_p] * 8
    + [ctypes.c_int] * 7
    + [ctypes.c_uint, ctypes.c_float, ctypes.c_ulonglong, ctypes.c_float, ctypes.c_void_p]
)


def _check_heads_contiguous(name: str, x: torch.Tensor) -> None:
    """The kernels take any batch and row strides (so q, k, v may be views
    of one packed projection) but need each row's (H, Dh) contiguous."""
    if x.stride(3) != 1 or x.stride(2) != x.shape[3]:
        raise ValueError(f"{name}: the (H, Dh) axes must be contiguous, got strides {x.stride()}")


def _check_shapes(q, k, v, kv_bias, prefix_s) -> None:
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


def _check_cuda(q, k, v, kv_bias) -> None:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k, v must share float32 or bfloat16, "
                         f"got {q.dtype} {k.dtype} {v.dtype}")
    kernel_head_dim(q.shape[-1])  # raises above 128
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        _check_heads_contiguous(name, x)
    if kv_bias is not None:
        if (kv_bias.dtype != torch.float32 or not kv_bias.is_contiguous()
                or kv_bias.device != q.device):
            raise ValueError("kv_bias must be a contiguous float32 tensor on q's device")


def _launch_args(rate, seed):
    """(threshold, inv_keep, 64-bit seed) of the kernels' dropout arguments."""
    if rate == 0.0:
        return 0, 1.0, 0
    return keep_threshold(rate), 1.0 / (1.0 - rate), seed % 2**64


def _forward(q, k, v, kv_bias, prefix_s, rate, seed, with_lse):
    """(out, lse or None): kernel 2 on CUDA, the plain version on the CPU."""
    if not q.is_cuda:
        out, lse = attention_forward_reference(q, k, v, kv_bias, prefix_s, rate, seed)
        return out, lse if with_lse else None
    _check_cuda(q, k, v, kv_bias)
    return run_padded(_launch_forward, (q, k, v), kv_bias, prefix_s, rate, seed, with_lse,
                      n_sliced=1)


def _launch_forward(q, k, v, kv_bias, prefix_s, rate, seed, with_lse, *, scale):
    """Kernel 2 at an instantiated head dim: (out, lse or None)."""
    b, tq, h, dh = q.shape
    out = torch.empty((b, tq, h, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device) if with_lse else None
    lib = cuda_build.load("prefix_attention")
    fn = lib.prefix_attention_launch
    fn.restype, fn.argtypes = ctypes.c_int, _FWD_ARGTYPES
    err = fn(
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(1),
        kv_bias.data_ptr() if kv_bias is not None else None,
        out.data_ptr(), lse.data_ptr() if lse is not None else None,
        _DTYPES[q.dtype], b, tq, k.shape[1], h, dh, -1 if prefix_s is None else prefix_s,
        *_launch_args(rate, seed), scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"prefix_attention kernel launch failed: cudaError {err}")
    fused_prefix_attention.launches += 1
    return out, lse


def fused_prefix_attention_backward(
    q, k, v, kv_bias, out, dout, lse, *, prefix_s=None, dropout_rate=0.0, dropout_seed=None,
):
    """(dq, dk, dv) of :func:`fused_prefix_attention`: kernel 3 on CUDA, the
    plain version on the CPU.  ``out`` and ``lse`` are the forward's."""
    _check_shapes(q, k, v, kv_bias, prefix_s)
    b, tq, h, dh = q.shape
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (b, h, tq):
        raise ValueError(f"out {tuple(out.shape)} and dout {tuple(dout.shape)} must be like q "
                         f"{tuple(q.shape)}, lse {tuple(lse.shape)} must be {(b, h, tq)}")
    if not q.is_cuda:
        return attention_backward_reference(q, k, v, kv_bias, out, dout, lse, prefix_s,
                                            dropout_rate, dropout_seed)
    _check_cuda(q, k, v, kv_bias)
    dout = dout.to(q.dtype).contiguous()
    out = out.to(q.dtype).contiguous()
    for name, x in (("out", out), ("dout", dout), ("lse", lse)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("lse must be a contiguous float32 tensor")
    return run_padded(_launch_backward, (q, k, v, out, dout), kv_bias, lse, prefix_s,
                      dropout_rate, dropout_seed, n_sliced=3)


def _launch_backward(q, k, v, out, dout, kv_bias, lse, prefix_s, dropout_rate, dropout_seed, *,
                     scale):
    """Kernel 3 at an instantiated head dim: (dq, dk, dv)."""
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, tq, h, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, h, dh), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, tk, h, dh), dtype=q.dtype, device=q.device)
    lib = cuda_build.load("prefix_attention_bwd")
    fn = lib.prefix_attention_bwd_launch
    fn.restype, fn.argtypes = ctypes.c_int, _BWD_ARGTYPES
    err = fn(
        q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1),
        v.data_ptr(), v.stride(0), v.stride(1),
        kv_bias.data_ptr() if kv_bias is not None else None,
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _DTYPES[q.dtype], b, tq, tk, h, dh, -1 if prefix_s is None else prefix_s,
        *_launch_args(dropout_rate, dropout_seed), scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"prefix_attention_bwd kernel launch failed: cudaError {err}")
    fused_prefix_attention_backward.launches += 1
    return dq, dk, dv


class _FusedPrefixAttention(torch.autograd.Function):
    """The twin of the JAX ``custom_vjp`` (``fused_attention.py:400-430``):
    the forward saves its output and row log-sum-exp; no gradient flows to
    the key bias."""

    @staticmethod
    def forward(ctx, q, k, v, kv_bias, prefix_s, rate, seed):
        out, lse = _forward(q, k, v, kv_bias, prefix_s, rate, seed, with_lse=True)
        ctx.save_for_backward(q, k, v, kv_bias, out, lse)
        ctx.prefix_s, ctx.rate, ctx.seed = prefix_s, rate, seed
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_bias, out, lse = ctx.saved_tensors
        dq, dk, dv = fused_prefix_attention_backward(
            q, k, v, kv_bias, out, dout, lse, prefix_s=ctx.prefix_s,
            dropout_rate=ctx.rate, dropout_seed=ctx.seed)
        return dq, dk, dv, None, None, None, None


def fused_prefix_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_bias: Optional[torch.Tensor],
    *,
    prefix_s: Optional[int] = None,
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,
) -> torch.Tensor:
    """(B,Tq,H,Dh) x (B,Tk,H,Dh) x (B,Tk,H,Dh) -> (B,Tq,H,Dh), like ``q``;
    differentiable in q, k and v.

    kv_bias: (B, Tk) f32 additive key-validity row (0 visible, -1e9 masked),
      or None.
    prefix_s: None = dense (key padding only; Tq may differ from Tk);
      0 = causal; s > 0 = [text ; audio] prefix-LM.  Not None needs Tq == Tk.
    dropout_rate, dropout_seed: attention-probability dropout with the
      Philox keep bits of ``dropout_seed`` (a non-negative int); the seed is
      required when the rate is above 0.
    """
    _check_shapes(q, k, v, kv_bias, prefix_s)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate > 0.0 and (dropout_seed is None or dropout_seed < 0):
        raise ValueError("dropout needs a non-negative dropout_seed")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FusedPrefixAttention.apply(q, k, v, kv_bias, prefix_s, dropout_rate, dropout_seed)
    return _forward(q, k, v, kv_bias, prefix_s, dropout_rate, dropout_seed, with_lse=False)[0]


fused_prefix_attention.launches = 0
fused_prefix_attention_backward.launches = 0
