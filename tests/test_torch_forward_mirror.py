"""The arithmetic of the attention forward kernel (kernels 2 and 4,
``valle_tpu_torch/csrc/prefix_attention.cu``), mirrored in numpy.

The kernel walks key tiles of ``kFwdKN`` columns with an online softmax:
per tile, S = q k^T, the scaled and masked scores, the running row max m,
alpha = exp(m_old - m_new) applied to the accumulator and the row sum,
p = exp(S - m_new), dropout on p, p rounded like the input type (relative to
the running max, before normalising), and O += P V; at the end out = O / l
and lse = m + log l.  In f32 both products run as 3xTF32 (each operand split
into big = tf32_rna(x) and small = tf32_rna(x - big)): S in one chain over
Dh, P V one k step of 8 at a time into a zeroed part that is added in f32.
The CUDA kernel runs only on the card; this mirror is held against the
port's plain versions on the CPU, within 1e-5 in f32 and within the card's
bf16 tolerance in bf16, in prefix mode with dropout and with a dense
causal + padding bias.
"""

import ast
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_tf32x3 import product_3xtf32, split
from valle_tpu_torch.ops.flash_attention import flash_attention_forward_reference
from valle_tpu_torch.ops.fused_attention import attention_forward_reference
from valle_tpu_torch.ops.philox import dropout_keep_mask

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-5
B, T, H, DH, PREFIX_S, RATE = 2, 100, 2, 32, 24, 0.1


def _kernel_tile_width() -> int:
    """``kFwdKN`` of the forward source: the columns of a streamed key tile at
    the head dim of these tests."""
    src = (ROOT / "valle_tpu_torch" / "csrc" / "prefix_attention.cu").read_text()
    return int(re.search(r"^constexpr int kFwdKN = (\d+);", src, re.M).group(1))


def _tol_bfloat16() -> float:
    """``TOL["bfloat16"]`` of chip_smoke.py, the limit of the kernel checks."""
    line = re.search(r"^TOL = (\{.*\})$", (ROOT / "chip_smoke.py").read_text(), re.M).group(1)
    return float(ast.literal_eval(line)["bfloat16"])


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (to nearest even), as f32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16).float().numpy()


def product_3xtf32_chain(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as the score product sums it in f32: per k, the three TF32
    products (small*big, big*small, big*big) into one running sum."""
    (ab, a_s), (bb, bs) = split(a), split(b)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(a.shape[1]):
        for x, y in ((a_s, bb), (ab, bs), (ab, bb)):
            acc = (acc + np.outer(x[:, k], y[k])).astype(np.float32)
    return acc


def forward_mirror(q, k, v, additive, keep, inv_keep, bias_before_scale, bf16, kn):
    """One (batch row, head) of the kernel: q (Tq, Dh), k / v (Tk, Dh) f32
    (bf16 values when ``bf16``); additive (Tq, Tk): kernel 2's key bias (-inf
    where structurally masked) or kernel 4's bias; keep (Tq, Tk) bool or
    None.  Returns (out (Tq, Dh) f32 before the final rounding, lse (Tq,))."""
    tq, dh = q.shape
    scale = np.float32(1.0 / math.sqrt(dh))
    m = np.full((tq, 1), -np.inf, np.float32)
    l = np.zeros((tq, 1), np.float32)
    acc = np.zeros((tq, dh), np.float32)
    for c0 in range(0, k.shape[0], kn):
        kt, vt, add = k[c0:c0 + kn], v[c0:c0 + kn], additive[:, c0:c0 + kn]
        s = (q @ kt.T).astype(np.float32) if bf16 else product_3xtf32_chain(q, kt.T)
        x = ((s + add) * scale if bias_before_scale else s * scale + add).astype(np.float32)
        m_new = np.maximum(m, x.max(1, keepdims=True))
        with np.errstate(invalid="ignore"):
            alpha = np.where(m_new == -np.inf, 1.0, np.exp(m - m_new)).astype(np.float32)
            p = np.where(x == -np.inf, 0.0, np.exp(x - m_new)).astype(np.float32)
        m = m_new
        l = (l * alpha + p.sum(1, keepdims=True)).astype(np.float32)
        acc = (acc * alpha).astype(np.float32)
        if keep is not None:
            p = np.where(keep[:, c0:c0 + kn], p * np.float32(inv_keep), 0.0).astype(np.float32)
        if bf16:
            acc = (acc + _bf16(p) @ vt).astype(np.float32)
        else:
            for j in range(0, p.shape[1], 8):
                acc = (acc + product_3xtf32(p[:, j:j + 8], vt[j:j + 8])).astype(np.float32)
    return (acc / l).astype(np.float32), (m + np.log(l))[:, 0]


def _inputs(seed, bf16):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, T, H, DH).astype(np.float32) for _ in range(3))
    if bf16:
        q, k, v = _bf16(q), _bf16(k), _bf16(v)
    lens = np.array([T, rng.randint(T // 2, T)])
    return q, k, v, lens


def _check(got, want, got_lse, want_lse, bf16):
    if bf16:
        # the kernel writes out in bf16; the mirror rounds relative to its
        # running max, the plain version relative to the row max
        err = float(np.abs(_bf16(got) - want).max())
        assert err <= _tol_bfloat16(), err
    else:
        err = float(np.abs(got - want).max())
        assert err <= F32_TOL, err
    lse_err = float(np.abs(got_lse - want_lse).max())
    assert lse_err <= F32_TOL, lse_err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mirror_matches_plain_prefix_mode_with_dropout(dtype):
    bf16 = dtype == "bfloat16"
    q, k, v, lens = _inputs(11, bf16)
    kv_bias = np.where(np.arange(T)[None, :] >= lens[:, None], -1e9, 0.0).astype(np.float32)
    seed = 1234
    keep = dropout_keep_mask(seed, B, H, T, T, RATE).numpy()  # (B, H, Tq, Tk)
    rows, cols = np.arange(T)[:, None], np.arange(T)[None, :]
    visible = (cols < PREFIX_S) | ((rows >= PREFIX_S) & (cols <= rows))
    tdt = torch.bfloat16 if bf16 else torch.float32
    want, want_lse = attention_forward_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), torch.from_numpy(kv_bias),
        PREFIX_S, RATE, seed)
    want, want_lse = want.float().numpy(), want_lse.numpy()
    kn = _kernel_tile_width()
    for b in range(B):
        additive = np.where(visible, kv_bias[b][None, :], -np.inf).astype(np.float32)
        for h in range(H):
            out, lse = forward_mirror(q[b, :, h], k[b, :, h], v[b, :, h], additive, keep[b, h],
                                      1.0 / (1.0 - RATE), False, bf16, kn)
            _check(out, want[b, :, h], lse, want_lse[b, h], bf16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mirror_matches_plain_dense_bias(dtype):
    bf16 = dtype == "bfloat16"
    q, k, v, lens = _inputs(12, bf16)
    col = np.arange(T)
    masked = (col[None, :] > col[:, None])[None] | (col[None, None, :] >= lens[:, None, None])
    bias = np.where(masked, -1e9, 0.0).astype(np.float32)[:, None]  # (B, 1, T, T)
    tdt = torch.bfloat16 if bf16 else torch.float32
    want, want_lse = flash_attention_forward_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), torch.from_numpy(bias))
    want, want_lse = want.float().numpy(), want_lse.numpy()
    kn = _kernel_tile_width()
    for b in range(B):
        for h in range(H):
            out, lse = forward_mirror(q[b, :, h], k[b, :, h], v[b, :, h], bias[b, 0], None, 1.0,
                                      True, bf16, kn)
            _check(out, want[b, :, h], lse, want_lse[b, h], bf16)

