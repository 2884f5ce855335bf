"""Kernels 3 and 4's backward above Dh 256, on the CPU: the launch plan of
``ops/fused_attention.py::backward_plan`` and a torch mirror of the
cluster passes' arithmetic (``csrc/prefix_attention_bwd.cu``, header point
7), which the CUDA kernels run only on the card.

On the cluster route the padded head is ``plan.cluster`` slices of
``plan.slice_dh`` columns in the dQ pass and ``plan.dkv_cluster`` slices of
``plan.dkv_slice_dh`` in the dK/dV pass, one block each.  Each block
computes its slice's partials of S = q kᵀ and dP = dO vᵀ; the partials are
summed slice 0 + slice 1 + ... in f32, so every block holds the same S and
dP; each block then runs the element pass and forms its own slice of dQ =
dS K, or of dK = dSᵀ q and dV = Pdᵀ dO.  The mirror follows that order
(slice by slice in each pass, the dK/dV side in chunks of
``plan.dkv_rows`` q rows) and is held against:

  - the plain versions, ``attention_backward_reference`` (prefix mode at
    rate 0.1, dense at rate 0) and ``flash_attention_backward_reference``
    (a causal + padding bias, d(bias) too), at Dh 384, 512 and 1024 in f32
    within 2e-5 of the largest |gradient| (the sums' order differs), and at
    Dh 512 in bf16 within 2e-2 of it (P and dS rounded to bf16 after S and
    dP summed in another order: the kernels' own bar, ``chip_smoke.TOL``);
  - JAX's ``_pallas_bwd`` in interpret mode at Dh 384, prefix mode and dense
    cross-attention, dropout 0: gradients within 1e-5 (f32 summation order,
    as ``tests/test_torch_head_dims.py``).

The JAX call runs under one ``jax.jit``, and the file has a time limit
(``tests/test_torch_stall_guard.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from valle_tpu.ops.fused_attention import fused_prefix_attention as jax_fused
from valle_tpu_torch.ops.flash_attention import (
    flash_attention_backward_reference, flash_attention_forward_reference)
from valle_tpu_torch.ops.fused_attention import (
    CLUSTER_MAX_HEAD_DIM, attention_backward_reference, attention_forward_reference,
    backward_plan, kernel_head_dim)
from valle_tpu_torch.ops.masks import prefix_lm_attn_mask
from valle_tpu_torch.ops.philox import dropout_keep_mask
from tests.test_torch_stall_guard import stall_guard

_stall_guard = stall_guard(120)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dh,route,padded,cluster,dkv_f32", [
    (64, "tile", 64, 1, (64, 1)), (96, "tile", 128, 1, (128, 1)),
    (192, "wide", 256, 1, (256, 1)), (256, "wide", 256, 1, (256, 1)),
    (300, "cluster", 384, 3, (64, 6)), (384, "cluster", 384, 3, (64, 6)),
    (512, "cluster", 512, 4, (64, 8)), (1000, "cluster", 1024, 8, (64, 16)),
    (1024, "cluster", 1024, 8, (64, 16)), (1025, "split", 1152, 1, (64, 1)),
    (1152, "split", 1152, 1, (64, 1)),
])
def test_backward_plan(dh, route, padded, cluster, dkv_f32):
    """The route of each head dim, and the dQ pass's slices and cluster
    (``cluster`` blocks; the same in f32 and bf16): the clusters reach Dh
    1024, the dQ pass in slices of 128 (8 blocks, the portable cluster
    size), the dK/dV pass in slices of 64 in f32 (``dkv_f32``: slice,
    blocks) and of 128 in bf16; past Dh 1024 the split passes.  The
    backward pads Dh as the forward does."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = backward_plan(dh, dtype)
        assert plan.route == route and plan.padded_dh == padded == kernel_head_dim(dh)
        assert plan.cluster == cluster
        if route in ("tile", "wide"):
            assert plan.slice_dh == plan.dkv_slice_dh == padded and plan.dkv_cluster == 1
            continue
        assert plan.slice_dh == 128
        dkv = dkv_f32 if dtype == torch.float32 else (128, cluster)
        assert (plan.dkv_slice_dh, plan.dkv_cluster) == dkv
        if route == "cluster":
            assert plan.slice_dh * plan.cluster == plan.dkv_slice_dh * plan.dkv_cluster == padded
            assert plan.dkv_cluster <= 16 and padded <= CLUSTER_MAX_HEAD_DIM
    assert backward_plan(128, torch.float32).dkv_rows == 8
    assert backward_plan(512, torch.float32).dkv_rows == 16


def cluster_backward_mirror(q, k, v, out, dout, lse, *, kv_bias=None, prefix_s=None, rate=0.0,
                            seed=None, bias=None):
    """(dq, dk, dv, d(bias) or None) of kernel 3 (``bias`` None) or kernel 4
    as the cluster passes compute them: each pass sums S and dP slice by
    slice over its own slices of the zero-padded head (the plan's), runs
    the element pass on the sums (P and dS rounded like the input), then
    forms each slice's dQ, or dK and dV over the plan's chunks of q rows.
    d(bias) is the dQ pass's.  Computed in f32."""
    lo = q.dtype
    b, tq, h, dh = q.shape
    tk = k.shape[1]
    plan = backward_plan(dh, lo)
    assert plan.route == "cluster"
    pad = (0, plan.padded_dh - dh)
    qf, kf, vf, dof = (F.pad(x.float(), pad) for x in (q, k, v, dout))

    def slices(width, n):
        return [slice(j * width, (j + 1) * width) for j in range(n)]

    def summed(sls):  # S and dP, slice 0 + slice 1 + ... in f32
        s = dp = None
        for sl in sls:
            s_j = torch.einsum("bqhd,bkhd->bhqk", qf[..., sl], kf[..., sl])
            dp_j = torch.einsum("bqhd,bkhd->bhqk", dof[..., sl], vf[..., sl])
            s, dp = (s_j, dp_j) if s is None else (s + s_j, dp + dp_j)
        return s, dp

    scale = 1.0 / np.sqrt(dh)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)[..., None]  # (B, H, Tq, 1)

    def element_pass(s, dp):
        """(Pd, dS, d(bias) or None) of the summed S and dP."""
        if bias is None:
            x = s * scale
            if kv_bias is not None:
                x = x + kv_bias[:, None, None, :]
            if prefix_s is not None:
                x = x.masked_fill(prefix_lm_attn_mask(prefix_s, tk - prefix_s)[:tq],
                                  float("-inf"))
            p = torch.exp(x - lse[..., None])
            pd, dpd = p, dp
            if rate > 0.0:
                keep = dropout_keep_mask(seed, b, h, tq, tk, rate)
                pd = torch.where(keep, p / (1.0 - rate), 0.0)
                dpd = torch.where(keep, dp / (1.0 - rate), 0.0)
            return pd.to(lo).float(), (p * (dpd - delta)).to(lo).float(), None
        p = torch.exp((s + bias) * scale - lse[..., None])
        dbias = (dp - delta) * p * scale
        return p.to(lo).float(), dbias.to(lo).float(), dbias

    post = scale if bias is None else 1.0  # kernel 4's dS carries the scale
    dq_slices = slices(plan.slice_dh, plan.cluster)
    _, ds, dbias = element_pass(*summed(dq_slices))
    dq = torch.cat([torch.einsum("bhqk,bkhd->bqhd", ds, kf[..., sl]) for sl in dq_slices],
                   -1) * post
    dkv_slices = slices(plan.dkv_slice_dh, plan.dkv_cluster)
    pd, ds, _ = element_pass(*summed(dkv_slices))  # the dK/dV pass sums its own S and dP
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for r0 in range(0, tq, plan.dkv_rows):  # the dK/dV pass's streamed q rows
        rows = slice(r0, r0 + plan.dkv_rows)
        for sl in dkv_slices:
            dk[..., sl] += torch.einsum("bhqk,bqhd->bkhd", ds[:, :, rows], qf[:, rows, :, sl])
            dv[..., sl] += torch.einsum("bhqk,bqhd->bkhd", pd[:, :, rows], dof[:, rows, :, sl])
    dk = dk * post
    return (dq[..., :dh].to(lo), dk[..., :dh].to(lo), dv[..., :dh].to(lo), dbias)


def _case(dh, dtype, tq=24, tk=24, b=2, h=2, seed=0):
    """q, k, v, dout (tiny, seeded) and a (B, Tk) key bias with padding in
    batch row 1."""
    rng = np.random.RandomState(dh + seed)
    q = (rng.randn(b, tq, h, dh) * 0.5).astype(np.float32)
    k, v = ((rng.randn(b, tk, h, dh) * 0.5).astype(np.float32) for _ in range(2))
    dout = rng.randn(b, tq, h, dh).astype(np.float32)
    kb = np.where(np.arange(tk)[None, :] >= np.array([tk, tk - 5])[:, None], -1e9, 0.0)
    return [torch.from_numpy(x).to(dtype) for x in (q, k, v, dout)] + [
        torch.from_numpy(kb.astype(np.float32))]


def _decoder_bias(b, h, t, rng):
    bias = -np.abs(rng.randn(b, h, t, t)).astype(np.float32)
    bias += np.where(np.arange(t)[None, :] > np.arange(t)[:, None], -1e9, 0.0)  # causal
    bias[1, :, :, t - 4:] = -1e9  # key padding
    bias[1, :, t - 4:, :] = np.where(np.arange(t)[None, :] > np.arange(t - 4, t)[:, None],
                                     -1e9, bias[1, :, t - 4:, :])
    return torch.from_numpy(bias)


def _close(got, want, tol, what):
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            continue
        err = float((g.float() - w.float()).abs().max() / w.float().abs().max())
        assert err <= tol, f"{what} {name}: {err} > {tol}"


@pytest.mark.parametrize("dh,dtype,mode", [
    (dh, "float32", mode) for dh in (384, 512, 1024)
    for mode in ("prefix-dropout", "dense", "kernel4")
] + [(512, "bfloat16", mode) for mode in ("prefix-dropout", "dense", "kernel4")])
def test_cluster_mirror_matches_the_plain_backward(dh, dtype, mode):
    dt = getattr(torch, dtype)
    q, k, v, dout, kb = _case(dh, dt)
    tol = 2e-5 if dtype == "float32" else 2e-2
    if mode == "kernel4":
        bias = _decoder_bias(q.shape[0], q.shape[2], q.shape[1], np.random.RandomState(dh))
        out, lse = flash_attention_forward_reference(q, k, v, bias)
        want = flash_attention_backward_reference(q, k, v, bias, out, dout, lse, True)
        got = cluster_backward_mirror(q, k, v, out, dout, lse, bias=bias)
    else:
        ps, rate, seed = (7, 0.1, 123456789) if mode == "prefix-dropout" else (None, 0.0, None)
        out, lse = attention_forward_reference(q, k, v, kb, ps, rate, seed)
        want = attention_backward_reference(q, k, v, kb, out, dout, lse, ps, rate, seed)
        got = cluster_backward_mirror(q, k, v, out, dout, lse, kv_bias=kb, prefix_s=ps,
                                      rate=rate, seed=seed)
    _close(got, want, tol, f"dh {dh} {dtype} {mode}")


@pytest.mark.parametrize("mode", ["prefix", "dense-cross-tq9"])
def test_cluster_mirror_matches_jax_at_head_dim_384(mode):
    """JAX's Pallas backward (``_pallas_bwd`` through the custom_vjp of
    ``fused_prefix_attention``, interpret mode) at Dh 384 = 3 slices."""
    dh = 384
    q, k, v, dout, kb = _case(dh, torch.float32, tq=24 if mode == "prefix" else 9, seed=1)
    ps = 7 if mode == "prefix" else None
    np_in = [x.numpy() for x in (q, k, v, dout)]

    def f(a, b_, c, d):
        out, vjp = jax.vjp(lambda a, b_, c: jax_fused(a, b_, c, jnp.asarray(kb.numpy()),
                                                      prefix_s=ps, interpret=True), a, b_, c)
        return vjp(d)

    want = jax.jit(f)(*(jnp.asarray(x) for x in np_in))
    out, lse = attention_forward_reference(q, k, v, kb, ps)
    got = cluster_backward_mirror(q, k, v, out, dout, lse, kv_bias=kb, prefix_s=ps)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0,
                                   err_msg=f"d{name}")
