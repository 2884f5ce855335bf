"""Kernels 2 and 4's forward above Dh 256, on the CPU: the launch plan of
``ops/fused_attention.py::forward_plan`` and a torch mirror of the cluster
kernels' arithmetic (``csrc/prefix_attention.cu``, header point 9), which
the CUDA kernels run only on the card.

On the cluster route the padded head is ``plan.cluster`` slices of
``plan.slice_dh`` columns, one block each.  For each key tile of
``plan.key_tile`` keys every block computes its slice's partial of S = q kᵀ;
the partials are summed slice 0 + slice 1 + ... in f32, so every block
holds the same S; every block runs the same online softmax on it (kernel
2's key bias and structural mask, or kernel 4's dense bias, applied after
the sum; the running row max, the rescale, the Philox keep bits, P rounded
like the input against the running max), and each adds P V over its own
slice of the output.  The mirror follows that order and is held against:

  - the plain versions, ``attention_forward_reference`` (prefix mode at
    rate 0.1, dense at rate 0) and ``flash_attention_forward_reference``
    (a causal + padding bias), at Dh 384, 512 and 1024 in f32, out and LSE
    within 2e-5 of the largest |out| (the sums' order differs), and at Dh
    512 in bf16 within 2e-2 of it (P rounded to bf16 against the running
    max instead of the row max: the kernels' own bar, ``chip_smoke.TOL``);
  - JAX's ``_pallas_fwd`` (through ``fused_prefix_attention``) in interpret
    mode at Dh 384, prefix mode and dense cross-attention, dropout 0: out
    within 1e-5, and the LSE, which JAX's forward does not return, within
    1e-5 of a log-sum-exp of the same logits computed in the same
    ``jax.jit``.

The JAX call runs under one ``jax.jit``, and the file has a time limit
(``tests/test_torch_stall_guard.py``).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from valle_tpu.ops.fused_attention import fused_prefix_attention as jax_fused
from valle_tpu_torch.ops.flash_attention import flash_attention_forward_reference
from valle_tpu_torch.ops.fused_attention import (
    CLUSTER_MAX_HEAD_DIM, attention_forward_reference, backward_plan, forward_plan,
    kernel_head_dim)
from valle_tpu_torch.ops.masks import prefix_lm_attn_mask
from valle_tpu_torch.ops.philox import dropout_keep_mask
from tests.test_torch_stall_guard import stall_guard

_stall_guard = stall_guard(120)
CSRC = Path(__file__).resolve().parents[1] / "valle_tpu_torch" / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dh,route,padded,cluster,key_tile", [
    (64, "tile", 64, 1, (32, 32)), (96, "tile", 128, 1, (16, 32)),
    (192, "wide", 256, 1, (16, 16)), (256, "wide", 256, 1, (16, 16)),
    (384, "cluster", 384, 3, (16, 64)), (512, "cluster", 512, 4, (16, 64)),
    (1024, "cluster", 1024, 8, (16, 64)), (1152, "split", 1152, 1, (16, 32)),
])
def test_forward_plan(dh, route, padded, cluster, key_tile):
    """The route of each head dim, its slices and cluster (``cluster``
    blocks, the same in f32 and bf16) and its key tile (``key_tile``: f32,
    bf16): the clusters reach Dh 1024 in slices of 128 (8 blocks, the
    portable cluster size), past it the split kernels, whose blocks also
    write 128 columns each.  The forward pads Dh as the backward does, and
    takes the cluster route where the backward's dQ pass does, with the
    same clusters."""
    for dtype, kn in zip((torch.float32, torch.bfloat16), key_tile):
        plan = forward_plan(dh, dtype)
        assert plan.route == route and plan.padded_dh == padded == kernel_head_dim(dh)
        assert plan.cluster == cluster and plan.key_tile == kn
        bwd = backward_plan(dh, dtype)
        assert (bwd.route, bwd.cluster) == (route, cluster)
        if route in ("tile", "wide"):
            assert plan.slice_dh == padded
        else:
            assert plan.slice_dh == 128
        if route == "cluster":
            assert plan.slice_dh * plan.cluster == padded <= CLUSTER_MAX_HEAD_DIM
            assert plan.cluster <= 8


def test_forward_plan_follows_the_source():
    """The cluster route's slices and key tiles are ``kSplitDh`` and
    ``fwd_cluster_kn()`` of the sources, and its reach is ``kClusterMaxDh``
    of ``csrc/cluster_tile.cuh``."""
    src = (CSRC / "prefix_attention.cu").read_text()
    body = re.search(r"constexpr int fwd_cluster_kn\(\) \{\s*return kF32<T> \? (\d+) : (\d+);", src)
    assert "attention_fwd_tile<T, kSplitDh, kDrop, false, false, true>(" in src
    split = re.search(r"constexpr int kSplitDh = (\d+);",
                      (CSRC / "attention_common.cuh").read_text())
    cluster = (CSRC / "cluster_tile.cuh").read_text()
    portable = re.search(r"constexpr int kClusterPortable = (\d+);", cluster)
    assert "constexpr int kClusterMaxDh = kClusterPortable * kSplitDh;" in cluster
    assert CLUSTER_MAX_HEAD_DIM == int(portable.group(1)) * int(split.group(1))
    for dtype, kn in zip((torch.float32, torch.bfloat16), body.groups()):
        plan = forward_plan(CLUSTER_MAX_HEAD_DIM, dtype)
        assert (plan.route, plan.slice_dh, plan.key_tile) == ("cluster", int(split.group(1)),
                                                              int(kn))


def cluster_forward_mirror(q, k, v, *, kv_bias=None, prefix_s=None, rate=0.0, seed=None,
                           bias=None):
    """(out, lse) of kernel 2 (``bias`` None) or kernel 4 as the cluster
    kernels compute them: per key tile, S summed slice by slice over the
    zero-padded head's slices in f32, then the online softmax over the
    tile (running max, rescale, keep bits, P rounded like the input against
    the running max), then each slice's P V.  Computed in f32."""
    lo = q.dtype
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    plan = forward_plan(dh, lo)
    assert plan.route == "cluster"
    pad = (0, plan.padded_dh - dh)
    qf, kf, vf = (F.pad(x.float(), pad) for x in (q, k, v))
    sls = [slice(j * plan.slice_dh, (j + 1) * plan.slice_dh) for j in range(plan.cluster)]
    scale = 1.0 / np.sqrt(dh)
    keep = dropout_keep_mask(seed, b, h, tq, tk, rate) if rate > 0.0 else None
    struct = (prefix_lm_attn_mask(prefix_s, tk - prefix_s)[:tq] if prefix_s is not None
              else None)
    m = torch.full((b, h, tq, 1), float("-inf"))
    l = torch.zeros((b, h, tq, 1))
    acc = [torch.zeros((b, h, tq, plan.slice_dh)) for _ in sls]
    for k0 in range(0, tk, plan.key_tile):
        cols = slice(k0, min(k0 + plan.key_tile, tk))
        s = None
        for sl in sls:  # the exchange: slice 0 + slice 1 + ...
            s_j = torch.einsum("bqhd,bkhd->bhqk", qf[..., sl], kf[:, cols, :, sl])
            s = s_j if s is None else s + s_j
        if bias is None:
            x = s * scale
            if kv_bias is not None:
                x = x + kv_bias[:, None, None, cols]
            if struct is not None:
                x = x.masked_fill(struct[:, cols], float("-inf"))
        else:
            x = (s + bias[..., cols]) * scale
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.where(m_new == float("-inf"), 1.0, torch.exp(m - m_new))
        p = torch.where(x == float("-inf"), 0.0, torch.exp(x - m_new))
        l = l * alpha + p.sum(-1, keepdim=True)
        m = m_new
        if keep is not None:
            p = torch.where(keep[..., cols], p / (1.0 - rate), 0.0)
        p = p.to(lo).float()
        for j, sl in enumerate(sls):  # each block's slice of O
            acc[j] = acc[j] * alpha + torch.einsum("bhqk,bkhd->bhqd", p, vf[:, cols, :, sl])
    out = torch.cat(acc, -1) / l
    return out.transpose(1, 2)[..., :dh].to(lo), (m + torch.log(l))[..., 0]


def _case(dh, dtype, tq=24, tk=24, b=2, h=2, seed=0):
    """q, k, v (tiny, seeded) and a (B, Tk) key bias with padding in batch
    row 1."""
    rng = np.random.RandomState(dh + seed)
    q = (rng.randn(b, tq, h, dh) * 0.5).astype(np.float32)
    k, v = ((rng.randn(b, tk, h, dh) * 0.5).astype(np.float32) for _ in range(2))
    kb = np.where(np.arange(tk)[None, :] >= np.array([tk, tk - 5])[:, None], -1e9, 0.0)
    return [torch.from_numpy(x).to(dtype) for x in (q, k, v)] + [
        torch.from_numpy(kb.astype(np.float32))]


def _decoder_bias(b, h, t, rng):
    bias = -np.abs(rng.randn(b, h, t, t)).astype(np.float32)
    bias += np.where(np.arange(t)[None, :] > np.arange(t)[:, None], -1e9, 0.0)  # causal
    bias[1, :, :, t - 4:] = -1e9  # key padding
    bias[1, :, t - 4:, :] = np.where(np.arange(t)[None, :] > np.arange(t - 4, t)[:, None],
                                     -1e9, bias[1, :, t - 4:, :])
    return torch.from_numpy(bias)


@pytest.mark.parametrize("dh,dtype,mode", [
    (dh, "float32", mode) for dh in (384, 512, 1024)
    for mode in ("prefix-dropout", "dense", "kernel4")
] + [(512, "bfloat16", mode) for mode in ("prefix-dropout", "dense", "kernel4")])
def test_cluster_mirror_matches_the_plain_forward(dh, dtype, mode):
    dt = getattr(torch, dtype)
    q, k, v, kb = _case(dh, dt)
    tol = 2e-5 if dtype == "float32" else 2e-2
    if mode == "kernel4":
        bias = _decoder_bias(q.shape[0], q.shape[2], q.shape[1], np.random.RandomState(dh))
        want = flash_attention_forward_reference(q, k, v, bias)
        got = cluster_forward_mirror(q, k, v, bias=bias)
    else:
        ps, rate, seed = (7, 0.1, 123456789) if mode == "prefix-dropout" else (None, 0.0, None)
        want = attention_forward_reference(q, k, v, kb, ps, rate, seed)
        got = cluster_forward_mirror(q, k, v, kv_bias=kb, prefix_s=ps, rate=rate, seed=seed)
    top = float(want[0].float().abs().max())
    for name, g, w in zip(("out", "lse"), got, want):
        err = float((g.float() - w.float()).abs().max()) / top
        assert err <= tol, f"dh {dh} {dtype} {mode} {name}: {err} > {tol}"


@pytest.mark.parametrize("mode", ["prefix", "dense-cross-tq9"])
def test_cluster_mirror_matches_jax_at_head_dim_384(mode):
    """JAX's Pallas forward (``_pallas_fwd`` through
    ``fused_prefix_attention``, interpret mode) at Dh 384 = 3 slices; the
    LSE from the same logits in the same ``jax.jit``."""
    dh = 384
    tq = 24 if mode == "prefix" else 9
    q, k, v, kb = _case(dh, torch.float32, tq=tq, seed=1)
    ps = 7 if mode == "prefix" else None
    masked = (prefix_lm_attn_mask(ps, k.shape[1] - ps)[:tq].numpy() if ps is not None
              else np.zeros((tq, k.shape[1]), bool))

    def f(a, b_, c, kb_):
        out = jax_fused(a, b_, c, kb_, prefix_s=ps, interpret=True)
        logits = jnp.einsum("bqhd,bkhd->bhqk", a, b_) / np.sqrt(dh) + kb_[:, None, None, :]
        logits = jnp.where(masked, -jnp.inf, logits)
        return out, jax.nn.logsumexp(logits, axis=-1)

    want = jax.jit(f)(*(jnp.asarray(x.numpy()) for x in (q, k, v, kb)))
    got = cluster_forward_mirror(q, k, v, kv_bias=kb, prefix_s=ps)
    for name, g, w in zip(("out", "lse"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0, err_msg=name)
