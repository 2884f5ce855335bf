"""Kernel 1's split-K design and the head dims of kernels 1-4, on the CPU.

- A torch mirror of the arithmetic of ``csrc/ragged_decode.cu``: the same
  plan (``split_plan``: split and stage widths, warps per head group), per
  warp an online softmax over column pairs, the warps merged in order, then
  the splits combined in a fixed order.  Held to
  ``ragged_decode_attention_reference`` within 1e-5 (f32, summation order
  only) and to the JAX reference on the same numpy inputs, at Dh 48 and 96,
  with int8, f32 and bf16 caches, on lengths 0, 1, on a split edge and past
  C, a split made only of -1e9 holes and a slot made only of holes.
- A mirror of the strided layout (Dh above 1024): chunk ownership by 256
  threads, tiles, the warps' partial scores summed in the kernel's order,
  the online softmax per tile, the combine skipping dead splits; at Dh 1040
  and 2080, and past the chunks a thread holds (the scores kernel and V
  slices), within 1e-5.
- A mirror of the staging of heads that are not whole 16-byte chunks (int8
  Dh 8, 40, 72, f32 Dh 30, bf16 Dh 100): the row's bytes in pieces of the
  copy unit into slots of ``padded_head_dim`` with zero pad bytes, then the
  split-K mirror on the slots, within 2e-6 of the plain version and JAX.
- The pad-and-slice path of kernels 2-4 (``run_padded``) driven through the
  plain versions at Dh 48 and 96: forward, LSE and backward (and kernel 4's
  d(bias)) equal to the plain version at the true Dh within 1e-6, the padded
  columns exactly 0, and against JAX's ``fused_prefix_attention`` /
  ``flash_attention_biased`` in Pallas interpret mode within the tolerances
  of tests/test_torch_attention_grad.py and tests/test_torch_flash_bias.py.
- One tiny greedy ``generate`` at Dh 48 (d = 96, 2 heads, int8 cache, kernel
  1's route) with codes equal to JAX's.

The CUDA kernels themselves are held to the plain versions on the card by
chip_smoke.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu.nn.attention import quantize_kv as jax_quantize_kv
from valle_tpu.ops.flash_attention import flash_attention_biased as jax_flash
from valle_tpu.ops.fused_attention import fused_prefix_attention as jax_fused
from valle_tpu.ops.ragged_decode import ragged_decode_attention_reference as jax_reference
from valle_tpu.sample import generate as jax_generate
from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.ops.flash_attention import (
    flash_attention_backward_reference, flash_attention_forward_reference)
from valle_tpu_torch.ops.fused_attention import (
    attention_backward_reference, attention_forward_reference, kernel_head_dim, run_padded)
from valle_tpu_torch.ops.ragged_decode import (
    padded_head_dim, ragged_decode_attention, ragged_decode_attention_reference, split_plan)
from valle_tpu_torch.sample import generate
from valle_tpu_torch.utils.bridge import state_dict_from_jax
from tests.test_torch_stall_guard import stall_guard

INIT_MAX = -2e9
KV_BYTES = {"int8": 1, "bfloat16": 2, "float32": 4}

_stall_guard = stall_guard(150)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- kernel 1 mirror


def split_k_mirror(q, k, v, lengths, bias, k_scale, v_scale, plan, scale=None):
    """(B, 1, H, Dh) f32 by the split kernel's and the combine kernel's
    arithmetic: q pre-scaled by ``scale`` (the f32 1 / sqrt(Dh) by
    default); per split, per warp ``wc`` of a head group, its
    ``cols_per_warp`` columns of every stage of ``stage_cols`` columns in
    one online-softmax step; the warps merged in order of wc; the live
    splits combined in order."""
    b, cap, h, dh = k.shape
    kf, vf = k.float(), v.float()
    scale = np.float32(1.0) / np.sqrt(np.float32(dh)) if scale is None else np.float32(scale)
    qs = q.reshape(b, h, dh).float() * torch.tensor(scale)
    out = torch.zeros(b, 1, h, dh)
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), cap)
        parts = []
        for s in range(plan.n_splits):
            c_begin = s * plan.split_cols
            if c_begin >= n:
                continue  # an empty partial, which the combine skips
            n_cols = min(plan.split_cols, n - c_begin)
            warps = [(torch.full((h,), INIT_MAX), torch.zeros(h), torch.zeros(h, dh))
                     for _ in range(plan.warps_per_group)]
            for t0 in range(0, n_cols, plan.stage_cols):
                nc = min(plan.stage_cols, n_cols - t0)
                cpw = plan.cols_per_warp
                for wc in range(plan.warps_per_group):
                    cols = [c_begin + t0 + cpw * wc + j for j in range(cpw) if cpw * wc + j < nc]
                    if not cols:
                        continue
                    m, l, acc = warps[wc]
                    scores = []
                    for c in cols:
                        sc = (qs[bi] * kf[bi, c]).sum(-1)
                        if k_scale is not None:
                            sc = sc * k_scale[bi, c]
                        if bias is not None:
                            sc = sc + bias[bi, c]
                        scores.append(sc)
                    m_new = torch.stack([m] + scores).amax(0)
                    alpha = torch.exp(m - m_new)
                    ps = [torch.exp(sc - m_new) for sc in scores]
                    l = l * alpha
                    acc = acc * alpha[:, None]
                    for c, p in zip(cols, ps):
                        l = l + p
                        w = p * v_scale[bi, c] if v_scale is not None else p
                        acc = acc + w[:, None] * vf[bi, c]
                    warps[wc] = (m_new, l, acc)
            m, l, acc = warps[0]
            for mo, lo, acco in warps[1:]:
                mn = torch.maximum(m, mo)
                a0, a1 = torch.exp(m - mn), torch.exp(mo - mn)
                m, l, acc = mn, l * a0 + lo * a1, acc * a0[:, None] + acco * a1[:, None]
            parts.append((m, l, acc))
        if not parts:
            continue  # length 0: exact zeros
        big = torch.stack([m for m, _, _ in parts]).amax(0)
        num, den = torch.zeros(h, dh), torch.zeros(h)
        for m, l, acc in parts:
            w = torch.exp(m - big)
            num = num + w[:, None] * acc
            den = den + w * l
        out[bi, 0] = num / den[:, None]
    return out


def _tree(x, dim):
    """Sum ``x`` over ``dim`` (a power of two long) as an xor-shuffle
    reduction leaves it in lane 0: element i plus element i + n / 2, then
    again over the first half, and so on."""
    while x.shape[dim] > 1:
        lo, hi = x.chunk(2, dim)
        x = lo + hi
    return x.squeeze(dim)


def _chunks(x, dh, ept):
    """(..., Dh) -> (..., G, EPT): a head cut into its 16-byte chunks, zero
    past Dh (a slot's pad bytes, q's lanes past Dh)."""
    g = -(-dh // ept)
    return torch.nn.functional.pad(x, (0, g * ept - dh)).reshape(*x.shape[:-1], g, ept)


STRIDED_THREADS = 256
# 16-byte chunks a thread of the strided kernel holds, at most, times its
# 256 threads (ragged_decode.cu's strided_max_cpt): a wider head is scored
# by the scores kernel first and its V summed in slices of this many chunks
STRIDED_SLICE_CHUNKS = {1: 1024, 2: 2048, 4: 2048}


def strided_mirror(q, k, v, lengths, bias, k_scale, v_scale, plan):
    """(B, 1, H, Dh) f32 by the strided layout's arithmetic (Dh above
    1024): per split and head, tiles of ``stage_cols`` columns; thread t of
    256 owns the 16-byte chunks t, t + 256, ... of the head, with q
    pre-scaled by the f32 1 / sqrt(Dh); a column's score is each thread's
    four partial sums, added in pairs, summed over the warp as the
    xor-shuffle does and over the 8 warps in pairs, then times the k scale
    plus the bias; per tile m_new = max(m, the tile's max), l = l * alpha +
    the shuffle-sum of p, acc = acc * alpha (when m moved) then + w_j v_j
    column by column; the combine's weights e^(m_s - M) over the live
    splits, the denominator and each element's numerator in order of s.
    A head of more than ``STRIDED_SLICE_CHUNKS`` chunks runs the same
    arithmetic: the scores kernel sums its chunks per thread in the same
    order, and each element's acc is its own chain whichever block holds
    it."""
    b, cap, h, dh = k.shape
    ept = 16 // k.element_size()
    scale = torch.tensor(np.float32(1.0) / np.sqrt(np.float32(dh)))
    qc = _chunks(q.reshape(b, h, dh).float() * scale, dh, ept)  # (B, H, G, EPT)
    g = qc.shape[-2]
    cpt = -(-g // STRIDED_THREADS)
    own = cpt * STRIDED_THREADS
    # chunk ci = t + 256 i -> [i, t]; (B, H, CPT, 256, EPT / 4, 4)
    qt = torch.nn.functional.pad(qc, (0, 0, 0, own - g)).reshape(
        b, h, cpt, STRIDED_THREADS, ept // 4, 4)
    kf, vf = k.float(), v.float()
    out = torch.zeros(b, 1, h, dh)
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), cap)
        parts = []
        for s in range(plan.n_splits):
            c_begin = s * plan.split_cols
            if c_begin >= n:
                continue  # a dead split: weight 0, skipped
            n_cols = min(plan.split_cols, n - c_begin)
            m, l, acc = torch.full((h,), INIT_MAX), torch.zeros(h), torch.zeros(h, dh)
            for t0 in range(c_begin, c_begin + n_cols, plan.stage_cols):
                cols = slice(t0, min(t0 + plan.stage_cols, c_begin + n_cols))
                kc = torch.nn.functional.pad(_chunks(kf[bi, cols], dh, ept),
                                             (0, 0, 0, own - g))  # (nc, H, own, EPT)
                prod = qt[bi][None] * kc.reshape(-1, h, cpt, STRIDED_THREADS, ept // 4, 4)
                part = prod.sum(dim=(2, 4))  # (nc, H, 256, 4): each thread's four sums
                thread = (part[..., 0] + part[..., 1]) + (part[..., 2] + part[..., 3])
                warps = _tree(thread.reshape(-1, h, 8, 32), -1)  # (nc, H, 8)
                pairs = warps.reshape(-1, h, 4, 2).sum(-1)
                sc = (pairs[..., 0] + pairs[..., 1]) + (pairs[..., 2] + pairs[..., 3])  # (nc, H)
                if k_scale is not None:
                    sc = sc * k_scale[bi, cols]
                if bias is not None:
                    sc = sc + bias[bi, cols, None]
                m_new = torch.maximum(m, sc.amax(0))
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new)
                lanes = torch.nn.functional.pad(p, (0, 0, 0, 32 - p.shape[0]))  # lanes past nc: 0
                l = l * alpha + _tree(lanes, 0)
                w = p * v_scale[bi, cols] if v_scale is not None else p
                acc = torch.where((m_new != m)[:, None], acc * alpha[:, None], acc)
                # + w_j v_j column by column: f32 sums in order of j
                terms = torch.cat([acc[None], w[..., None] * vf[bi, cols]]).numpy()
                acc = torch.from_numpy(np.add.accumulate(terms, axis=0)[-1])
                m = m_new
            parts.append((m, l, acc))
        if not parts:
            continue  # length 0: exact zeros
        big = torch.stack([m for m, _, _ in parts]).amax(0)
        num, den = torch.zeros(h, dh), torch.zeros(h)
        for m, l, acc in parts:
            w = torch.exp(m - big)
            den = den + w * l
            num = num + w[:, None] * acc
        out[bi, 0] = num / den[:, None]
    return out


@pytest.mark.parametrize("cache,h,dh,sms", [
    (cache, h, dh, sms) for cache in ("int8", "float32", "bfloat16")
    for h, dh, sms in ((1, 1040, 7), (2, 1040, 21), (1, 2080, 7))
] + [("float32", 1, 8200, 7)])
def test_strided_mirror_matches_plain_and_jax(cache, h, dh, sms):
    """The strided layout at Dh 1040 (d = 1040 at one head, or 2080 at two)
    and at Dh 2080 (past 2048: two chunks a thread in bf16, three in f32),
    and past the chunks a thread holds (f32 Dh 8200: 2,050 chunks), where
    the scores kernel scores and two V slices sum,
    on the split-edge lengths of ``_mirror_case``: several splits, at the
    plan's tiles and at three tiles a split, against the plain version and
    JAX's plain reference within 1e-5."""
    plan, args = _mirror_case(cache, h, dh, sms)
    assert plan.n_slices == h and plan.n_splits >= 2
    if dh > 4096:
        g, sliced = -(-dh * KV_BYTES[cache] // 16), STRIDED_SLICE_CHUNKS[KV_BYTES[cache]]
        assert sliced < g <= 2 * sliced
    targs = _torch_args(args, cache)
    plain = ragged_decode_attention_reference(*targs)
    want = np.asarray(jax_reference(*(None if a is None else jnp.asarray(a) for a in args)))
    vf = targs[2].float() * (targs[6][..., None] if targs[6] is not None else 1.0)
    # the plan's tiles, and tiles of a third of a split (several a split,
    # whichever tile the plan picks for this cache type)
    third = -(-plan.split_cols // 3)
    for tiles in (plan, plan._replace(stage_cols=third, cols_per_warp=third)):
        got = strided_mirror(*targs, tiles)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
        assert np.all(got.numpy()[0] == 0.0)  # length 0
        np.testing.assert_allclose(got[6, 0].numpy(), vf[6, :20].mean(0).numpy(), atol=1e-5)


def copy_unit(head_bytes):
    """The kernel's copy unit for a head of ``head_bytes`` bytes
    (``set_head_copy``): the largest of 16, 8, 4, 2 and 1 bytes that divides
    it, so that every head of every row starts on a multiple of it."""
    u = 16
    while head_bytes % u:
        u //= 2
    return u


def stage_slots(x):
    """The shared-memory image of (B, C, H, Dh) cache rows as kernel 1's
    lane layouts stage a head that is not whole 16-byte chunks: the row's
    bytes in pieces of ``copy_unit`` bytes, piece i of the row to head hd =
    (i * ceil(2^32 / pieces)) >> 32 (the kernel's division-free i / pieces)
    at byte hd * SB + (i - hd * pieces) * u, into slots of SB =
    ``padded_head_dim`` bytes whose pad bytes were zeroed first.  Starts
    from 0xFF bytes (a NaN in f32 and bf16) and checks that every byte is
    written once.  Returns (B, C, H, padded Dh) in x's dtype."""
    b, cap, h, dh = x.shape
    size = x.element_size()
    hb, sb = dh * size, padded_head_dim(dh, size) * size
    rows = x.contiguous().view(torch.uint8).numpy().reshape(b * cap, h * hb)
    u = copy_unit(hb)
    pieces = hb // u
    inv = ((1 << 32) + pieces - 1) // pieces
    i = np.arange(h * pieces, dtype=np.uint64)
    hd = (i * np.uint64(inv)) >> np.uint64(32)
    assert np.array_equal(hd, i // np.uint64(pieces))  # exact at these sizes
    dst = (hd * np.uint64(sb) + (i - hd * np.uint64(pieces)) * np.uint64(u)).astype(np.int64)
    src = (i * np.uint64(u)).astype(np.int64)
    image = np.full((b * cap, h * sb), 0xFF, np.uint8)
    written = np.zeros(h * sb, np.int64)
    pad = (np.arange(h * sb) % sb) >= hb  # the pad bytes, zeroed once per block
    image[:, pad] = 0
    written[pad] += 1
    for o in range(u):
        image[:, dst + o] = rows[:, src + o]
        written[dst + o] += 1
    assert np.all(written == 1)
    return torch.from_numpy(image).view(x.dtype).reshape(b, cap, h, sb // size)


@pytest.mark.parametrize("cache,h,dh", [("int8", 16, 8), ("int8", 5, 40), ("int8", 3, 72),
                                        ("float32", 4, 30), ("bfloat16", 2, 100)])
def test_unpadded_staging_mirror_matches_plain_and_jax(cache, h, dh):
    """Heads that are not whole 16-byte chunks, read where they lie in the
    cache: each head's bytes land in its slot unchanged, the pad bytes are
    zero, and the split-K mirror on the staged slots (q zero past Dh, the
    true Dh's scale, the plan of the true Dh) gives the plain version's
    and JAX's output within 2e-6."""
    plan, args = _mirror_case(cache, h, dh, 21, seed=dh)
    targs = _torch_args(args, cache)
    q, k, v = targs[:3]
    dhp = padded_head_dim(dh, k.element_size())
    sk, sv = stage_slots(k), stage_slots(v)
    for staged, orig in ((sk, k), (sv, v)):
        assert torch.equal(staged[..., :dh], orig)
        assert torch.all(staged[..., dh:].float() == 0)
    qp = torch.nn.functional.pad(q, (0, dhp - dh))
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    got = split_k_mirror(qp, sk, sv, *targs[3:], plan, scale=scale)[..., :dh]
    plain = ragged_decode_attention_reference(*targs)
    want = np.asarray(jax_reference(*(None if a is None else jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=2e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)
    assert np.all(got.numpy()[0] == 0.0)  # length 0
    assert plan == split_plan(7, 70, h, dhp, k.element_size(), 21)


def _mirror_case(cache, h, dh, sms, seed=0):
    """Numpy inputs, with lengths that land on the plan's split edges."""
    rng = np.random.RandomState(seed)
    b, cap = 7, 70
    plan = split_plan(b, cap, h, dh, KV_BYTES[cache], sms)
    edge = plan.split_cols
    # zero, one, on a split edge, two splits of which the second is only
    # holes, past C, the whole cache, and a slot made only of holes
    lengths = np.array([0, 1, edge, 2 * edge, cap + 5, cap, 20], np.int32)
    q = rng.randn(b, 1, h, dh).astype(np.float32)
    k = rng.randn(b, cap, h, dh).astype(np.float32)
    v = rng.randn(b, cap, h, dh).astype(np.float32)
    bias = np.where(rng.rand(b, cap) < 0.1, -1e9, 0.0).astype(np.float32)
    bias[3, edge:2 * edge] = -1e9
    bias[3, 0] = 0.0
    bias[6] = -1e9
    ks = vs = None
    if cache == "int8":
        k, ks = (np.array(a) for a in jax_quantize_kv(jnp.asarray(k)))
        v, vs = (np.array(a) for a in jax_quantize_kv(jnp.asarray(v)))
    elif cache == "bfloat16":  # the values a bf16 cache holds, kept as f32 for JAX
        k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (k, v))
    return plan, (q, k, v, lengths, bias, ks, vs)


def _torch_args(args, cache):
    q, k, v, lengths, bias, ks, vs = (None if a is None else torch.from_numpy(a) for a in args)
    if cache == "bfloat16":
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    return q, k, v, lengths, bias, ks, vs


@pytest.mark.parametrize("sms", [7, 21])
@pytest.mark.parametrize("h,dh", [(4, 48), (2, 96)])
@pytest.mark.parametrize("cache", ["int8", "float32", "bfloat16"])
def test_split_k_mirror_matches_plain_and_jax(cache, h, dh, sms):
    plan, args = _mirror_case(cache, h, dh, sms)
    targs = _torch_args(args, cache)
    got = split_k_mirror(*targs, plan)
    plain = ragged_decode_attention_reference(*targs)
    want = np.asarray(jax_reference(*(None if a is None else jnp.asarray(a) for a in args)))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert np.all(got.numpy()[0] == 0.0)  # length 0
    # the slot made only of holes averages v over its 20 live columns
    vf = targs[2].float() * (targs[6][..., None] if targs[6] is not None else 1.0)
    np.testing.assert_allclose(got[6, 0].numpy(), vf[6, :20].mean(0).numpy(), atol=1e-5)
    assert plan.n_splits >= 2 and plan.split_cols * plan.n_splits >= 70


def test_split_plan_fills_the_card_at_the_generate_shapes():
    """On an H100 (132 SMs): about two blocks per SM at B = 8 and one at
    B = 1, on the generate cache (C = 768) and on a long cache, without a
    cap on C; each warp takes 1-8 columns of a stage, and the rings of the
    whole grid fit the SMs' shared memory in one wave."""
    for b, cap, per_sm in ((8, 768, 2), (8, 1024, 2), (1, 768, 1), (1, 40000, 1)):
        plan = split_plan(b, cap, 16, 64, 1, 132)
        assert plan.n_splits * b >= per_sm * 132
        assert plan.split_cols * plan.n_splits >= cap > plan.split_cols * (plan.n_splits - 1)
        assert plan.split_cols >= 4
    for dh, kv_bytes in ((64, 1), (64, 2), (64, 4), (256, 4), (48, 2), (96, 1)):
        b, cap, h = 8, 1024, 16
        plan = split_plan(b, cap, h, dh, kv_bytes, 132)
        assert plan.stage_cols == plan.cols_per_warp * plan.warps_per_group
        assert 1 <= plan.cols_per_warp <= 8 and plan.n_groups * plan.warps_per_group <= 16
        col = 2 * h * dh * kv_bytes + (8 * h if kv_bytes == 1 else 0) + 4
        per_sm = -(-b * plan.n_splits // 132)
        stages = min(2, -(-plan.split_cols // plan.stage_cols))
        block = stages * (plan.stage_cols * col + 48)
        assert block <= 232448 and (plan.cols_per_warp == 1 or per_sm * block <= 232448)
    for dh in (16, 48, 80, 96, 112, 256):
        split_plan(8, 768, 4, dh, 4, 132)
    # int8 heads of Dh 8, 40 and 264 are not whole 16-byte chunks: the plan
    # takes the true Dh and lays the row out in slots of the padded width,
    # as the kernel stages it
    for dh, want in ((8, 16), (40, 48), (264, 272)):
        assert padded_head_dim(dh, 1) == want
        assert split_plan(8, 768, 4, dh, 1, 132) == split_plan(8, 768, 4, want, 1, 132)
        _assert_plan_covers(split_plan(8, 768, 4, dh, 1, 132), 8, 768, 4, dh, 1, 132)
    # 64 heads of Dh 64 in f32 are 32 head groups: two slices of 16
    plan = split_plan(8, 768, 64, 64, 4, 132)
    assert (plan.n_slices, plan.n_groups) == (2, 16)
    _assert_plan_covers(plan, 8, 768, 64, 64, 4, 132)


def _assert_plan_covers(plan, b, cap, h, dh, kv_bytes, sms):
    """Every head of the row in some slice's head group, at most 16 warps
    a block (8 where a lane holds 32 accumulator floats), and each block's
    ring and merge buffer in the shared memory a block may use, with each
    head in a slot of ``padded_head_dim`` elements."""
    slot = padded_head_dim(dh, kv_bytes) * kv_bytes
    g = slot // 16
    lanes = min(32, 1 << (g - 1).bit_length())
    per_lane = 1 << (-(-g // lanes) - 1).bit_length()
    ns = per_lane * 16 // kv_bytes
    assert lanes * per_lane >= g
    assert plan.n_slices * plan.n_groups * (32 // lanes) >= h  # every head covered
    assert (plan.n_slices - 1) * plan.n_groups * (32 // lanes) < h  # no empty slice
    assert plan.n_groups * plan.warps_per_group <= (8 if ns > 16 else 16)
    slice_heads = h if plan.n_slices == 1 else plan.n_groups * (32 // lanes)
    col = 2 * slice_heads * slot + (8 * h if kv_bytes == 1 else 0) + 4
    stages = min(2, -(-plan.split_cols // plan.stage_cols))
    ring = stages * (plan.stage_cols * col + 48)
    merge = 32 * plan.n_groups * plan.warps_per_group * (ns + 2) * 4
    assert max(ring, merge) <= 232448
    assert plan.split_cols * plan.n_splits >= cap > plan.split_cols * (plan.n_splits - 1)


@pytest.mark.parametrize("dh,kv_bytes", [(8, 1), (40, 1), (72, 1), (30, 4), (100, 2),
                                         (50, 1), (33, 2)])
def test_split_plan_takes_unpadded_head_dims(dh, kv_bytes):
    """Heads that are not whole 16-byte chunks (int8 Dh 8, 40, 72 and 50,
    f32 Dh 30, bf16 Dh 100 and 33): the plan at the true Dh is the plan of
    the padded width, covering every head at the generate shapes, at B = 1
    and on a long cache, at the head counts of rows of about 1,024
    elements; the copy unit is the largest of 16, 8, 4, 2, 1 bytes that
    divides the head's bytes."""
    dhp = padded_head_dim(dh, kv_bytes)
    assert dhp * kv_bytes % 16 == 0 and dh < dhp < dh + 16 // kv_bytes
    h = max(1, 1024 // dh)
    for b, cap in ((8, 768), (1, 768), (8, 40000)):
        plan = split_plan(b, cap, h, dh, kv_bytes, 132)
        assert plan == split_plan(b, cap, h, dhp, kv_bytes, 132)
        _assert_plan_covers(plan, b, cap, h, dh, kv_bytes, 132)
    unit = copy_unit(dh * kv_bytes)
    assert dh * kv_bytes % unit == 0 and (unit == 16 or dh * kv_bytes % (2 * unit))


@pytest.mark.parametrize("h,dh,kv_bytes", [(4, 512, 4), (4, 512, 2), (4, 512, 1),
                                           (2, 1024, 4), (128, 16, 1), (16, 320, 4),
                                           (8, 144, 2), (16, 192, 1)])
def test_split_plan_covers_wide_heads_and_many_heads(h, dh, kv_bytes):
    """The plans of head dims past 256 (up to 1024) and of rows of more
    head groups than a block's 16 warps: every head covered, the warps and
    shared memory within a block's, at the generate shapes and at B = 1;
    past Dh 1024 the strided layout's plan (a block per split, slot and
    head) at the same head count."""
    for b, cap in ((8, 768), (1, 768), (8, 40000)):
        _assert_plan_covers(split_plan(b, cap, h, dh, kv_bytes, 132), b, cap, h, dh, kv_bytes,
                            132)
        _assert_strided_plan(split_plan(b, cap, h, 1040, kv_bytes, 132), b, cap, h, 132, 1040,
                             kv_bytes)


def _assert_strided_plan(plan, b, cap, h, sms, dh=1040, kv_bytes=4):
    """The strided layout's plan: one head per block (grid z = H), one head
    group of 8 warps, each taking every column of a tile of at most 32
    columns and about 72 KB of K and V (at least one column), tiles even
    over the split; three stages of the ring, the warps' partial scores and
    the stages' mbarriers in a block's shared memory; splits that cover the
    cache and fill the card (about one block per SM at B = 1, two at B > 1)
    unless the splits reach their 4-column floor."""
    assert plan.n_slices == h and (plan.n_groups, plan.warps_per_group) == (1, 8)
    assert 1 <= plan.stage_cols == plan.cols_per_warp <= min(32, plan.split_cols)
    slot = padded_head_dim(dh, kv_bytes) * kv_bytes
    stage = 2 * plan.stage_cols * slot + -(-12 * plan.stage_cols // 16) * 16
    assert plan.stage_cols == 1 or stage <= 72 * 1024 + 64
    if slot > 16 * STRIDED_SLICE_CHUNKS[kv_bytes]:  # the kernel stages a slice of V alone
        stage = plan.stage_cols * 16 * STRIDED_SLICE_CHUNKS[kv_bytes] + -(-12 * plan.stage_cols
                                                                          // 16) * 16
    tiles = -(-plan.split_cols // plan.stage_cols)
    assert -(-plan.split_cols // tiles) == plan.stage_cols  # even tiles
    assert min(tiles, 3) * stage + 8 * 32 * 4 + 3 * 8 <= 232448
    assert plan.split_cols * plan.n_splits >= cap > plan.split_cols * (plan.n_splits - 1)
    per_sm = 1 if b == 1 else 2
    assert plan.split_cols == 4 or b * h * plan.n_splits >= per_sm * sms
    assert (2 * plan.n_splits + 8) * 4 <= 232448  # the combine's weights in shared memory


@pytest.mark.parametrize("dh,kv_bytes", [(1028, 1), (1100, 2), (2048, 4), (4096, 1)])
def test_kernel_1_strided_layout_takes_heads_past_1024(dh, kv_bytes):
    """A head past Dh 1024 runs unpadded in device memory (the kernel
    stages it into a slot of whole 16-byte chunks), at one head (d = Dh,
    nhead 1) and at 16, on the generate shapes, at B = 1 and on a long
    cache; and so does any wider head: at the widest a thread's registers
    hold, one element past it (the scores kernel and V slices) and far
    past it."""
    assert padded_head_dim(dh, kv_bytes) * kv_bytes == -(-dh * kv_bytes // 16) * 16
    for b, cap, h in ((8, 768, 1), (8, 768, 16), (1, 768, 1), (1, 40000, 2)):
        _assert_strided_plan(split_plan(b, cap, h, dh, kv_bytes, 132), b, cap, h, 132, dh,
                             kv_bytes)
    widest = STRIDED_SLICE_CHUNKS[kv_bytes] * 16 // kv_bytes
    for wide in (widest, widest + 1, 50 * widest + 3):
        _assert_strided_plan(split_plan(8, 768, 2, wide, kv_bytes, 132), 8, 768, 2, 132, wide,
                             kv_bytes)


@pytest.mark.parametrize("dh", [8, 40, 72])
def test_kernel_1_padded_head_dim(dh):
    """The int8 head's width in the kernel's shared-memory slot (at Dh 8,
    40, 72), zero past Dh: through the plain version with the true Dh's
    scale, the first Dh outputs equal the unpadded call's within f32
    rounding and the padded outputs are exactly 0."""
    _, args = _mirror_case("float32", 4, dh, 21, seed=dh)
    q, k, v, lengths, bias, _, _ = _torch_args(args, "float32")
    k8, ks = (torch.from_numpy(np.array(a)) for a in jax_quantize_kv(jnp.asarray(args[1])))
    v8, vs = (torch.from_numpy(np.array(a)) for a in jax_quantize_kv(jnp.asarray(args[2])))
    dhp = padded_head_dim(dh, 1)
    assert dhp % 16 == 0 and dhp - 16 < dh <= dhp
    pad = lambda x: torch.nn.functional.pad(x, (0, dhp - dh))  # noqa: E731
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    got = ragged_decode_attention_reference(pad(q), pad(k8), pad(v8), lengths, bias, ks, vs,
                                            scale=scale)
    want = ragged_decode_attention_reference(q, k8, v8, lengths, bias, ks, vs)
    assert got.shape[-1] == dhp and torch.all(got[..., dh:] == 0)
    np.testing.assert_allclose(got[..., :dh].numpy(), want.numpy(), atol=2e-6, rtol=0)


def test_wrapper_on_cpu_takes_dh_48_and_a_wide_cache():
    """The CPU route runs the plain version at any head dim and cache width
    (the old kernel capped C at 32768 and Dh at {16, 32, 64, 128})."""
    _, args = _mirror_case("int8", 4, 48, 21, seed=3)
    targs = _torch_args(args, "int8")
    got = ragged_decode_attention(*targs)
    np.testing.assert_array_equal(got.numpy(), ragged_decode_attention_reference(*targs).numpy())
    q = torch.randn(1, 1, 2, 16)
    k = torch.randn(1, 33000, 2, 16)
    got = ragged_decode_attention(q, k, k, torch.tensor([33000], dtype=torch.int32))
    assert got.shape == (1, 1, 2, 16) and torch.isfinite(got).all()


# ------------------------------------------------------ kernels 2-4 padding


def _capture_padded(fn, n_sliced):
    """``fn`` as a launch for ``run_padded`` that checks the padded head
    dims of its first ``n_sliced`` results are exactly zero."""
    def launch(*args, scale):
        res = fn(*args, scale=scale)
        for r in res[:n_sliced]:
            dh = kernel_head_dim(r.shape[-1])
            assert r.shape[-1] == dh  # the call ran at the instantiated size
        launch.results = res
        return res
    return launch


def _assert_padding_zero(res, true_dh, n_sliced):
    for r in res[:n_sliced]:
        assert torch.all(r[..., true_dh:] == 0), "padded head-dim columns must be exactly 0"


def _prefix_case(dh, seed=0):
    rng = np.random.RandomState(seed)
    b, t, h, s = 2, 40, 2, 11
    q, k, v = ((rng.randn(b, t, h, dh) * 0.5).astype(np.float32) for _ in range(3))
    dout = rng.randn(b, t, h, dh).astype(np.float32)
    pad = np.arange(t)[None, :] >= np.array([t, t - 9])[:, None]
    pad[1, 7:s] = True  # text padding
    return q, k, v, dout, np.where(pad, -1e9, 0.0).astype(np.float32), s


@pytest.mark.parametrize("dh", [48, 96])
def test_kernels_2_3_padded_head_dim(dh):
    q, k, v, dout, bias, s = _prefix_case(dh)
    tq_, tk_, tv_, td_, tb_ = (torch.from_numpy(a) for a in (q, k, v, dout, bias))
    assert kernel_head_dim(dh) == {48: 64, 96: 128}[dh]
    for rate, seed in ((0.0, None), (0.1, 12345)):
        fwd = _capture_padded(lambda q, k, v, *a, scale: attention_forward_reference(
            q, k, v, *a, scale=scale), n_sliced=1)
        out, lse = run_padded(fwd, (tq_, tk_, tv_), tb_, s, rate, seed, n_sliced=1)
        _assert_padding_zero(fwd.results, dh, 1)
        want_out, want_lse = attention_forward_reference(tq_, tk_, tv_, tb_, s, rate, seed)
        np.testing.assert_allclose(out.numpy(), want_out.numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-6, rtol=0)
        bwd = _capture_padded(lambda q, k, v, out, dout, *a, scale: attention_backward_reference(
            q, k, v, a[0], out, dout, *a[1:], scale=scale), n_sliced=3)
        got = run_padded(bwd, (tq_, tk_, tv_, out, td_), tb_, lse, s, rate, seed, n_sliced=3)
        _assert_padding_zero(bwd.results, dh, 3)
        want = attention_backward_reference(tq_, tk_, tv_, tb_, want_out, td_, want_lse, s,
                                            rate, seed)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.is_contiguous()
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=0)
        if rate == 0.0:  # against the JAX kernel's forward and backward
            jout, vjp = jax.vjp(
                lambda a, b_, c: jax_fused(a, b_, c, jnp.asarray(bias), prefix_s=s,
                                           interpret=True),
                *(jnp.asarray(x) for x in (q, k, v)))
            np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5, rtol=0)
            for name, g, w in zip("qkv", got, vjp(jnp.asarray(dout))):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0,
                                           err_msg=f"d{name}")


@pytest.mark.parametrize("dh", [48, 96])
def test_kernel_4_padded_head_dim(dh):
    rng = np.random.RandomState(dh)
    b, t, h = 2, 37, 2
    q, k, v, dout = (rng.randn(b, t, h, dh).astype(np.float32) for _ in range(4))
    bias = -np.abs(rng.randn(b, h, t, t)).astype(np.float32) * 2  # soft, per head
    bias += np.where(np.arange(t)[None, :] > np.arange(t)[:, None], -1e9, 0.0)  # causal
    tq_, tk_, tv_, td_, tb_ = (torch.from_numpy(a) for a in (q, k, v, dout, bias))
    fwd = _capture_padded(lambda q, k, v, bias, scale: flash_attention_forward_reference(
        q, k, v, bias, scale=scale), n_sliced=1)
    out, lse = run_padded(fwd, (tq_, tk_, tv_), tb_, n_sliced=1)
    _assert_padding_zero(fwd.results, dh, 1)
    want_out, want_lse = flash_attention_forward_reference(tq_, tk_, tv_, tb_)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-6, rtol=0)
    bwd = _capture_padded(lambda q, k, v, out, dout, bias, lse, scale:
                          flash_attention_backward_reference(q, k, v, bias, out, dout, lse,
                                                             bias_grad=True, scale=scale),
                          n_sliced=3)
    got = run_padded(bwd, (tq_, tk_, tv_, out, td_), tb_, lse, n_sliced=3)
    _assert_padding_zero(bwd.results, dh, 3)
    want = flash_attention_backward_reference(tq_, tk_, tv_, tb_, want_out, td_, want_lse,
                                              bias_grad=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=0)

    def f(q, k, v, bias):
        return jnp.sum(jax_flash(q, k, v, bias) * jnp.asarray(dout))

    jargs = tuple(jnp.asarray(a) for a in (q, k, v, bias))
    with pltpu.force_tpu_interpret_mode():  # one jitted call: see _stall_guard
        jout, jgrads = jax.jit(lambda *a: (jax_flash(*a), jax.grad(f, argnums=(0, 1, 2, 3))(*a)))(
            *jargs)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    for name, g, w in zip(("q", "k", "v", "bias"), got, jgrads):
        w = np.asarray(w)
        atol = 1e-5 * max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g.numpy(), w, atol=atol, rtol=0, err_msg=f"d{name}")


def test_run_padded_leaves_instantiated_dims_alone():
    calls = []

    def launch(x, *, scale):
        calls.append((x.shape[-1], scale))
        return (x,)

    x = torch.randn(2, 3, 64)
    assert run_padded(launch, (x,), n_sliced=1)[0] is x
    assert calls == [(64, 1.0 / math.sqrt(64))]
    # past 128 a head dim pads to a multiple of 128 (the split instantiations)
    for dh, n in ((144, 256), (256, 256), (320, 384), (1024, 1024)):
        assert kernel_head_dim(dh) == n
        y = torch.randn(2, 3, dh)
        got = run_padded(launch, (y,), n_sliced=1)[0]
        assert calls[-1] == (n, 1.0 / math.sqrt(dh))
        assert torch.equal(got, y)


# ---------------------------------------------------------- generate at Dh 48


def test_greedy_generate_at_head_dim_48_matches_jax():
    b, s, p, nq, max_new = 3, 6, 5, 2, 8
    rng = np.random.RandomState(4)
    x = rng.randint(1, 512, (b, s)).astype(np.int32)
    x_lens = np.array([6, 3, 5], np.int32)
    prompts = rng.randint(0, 1024, (b, p, nq)).astype(np.int32)
    prompt_lens = np.array([5, 2, 4], np.int32)
    stop_lens = np.array([8, 3, 6], np.int32)
    kw = dict(decoder_dim=96, nhead=2, num_layers=2, num_quantizers=nq, kv_cache_dtype="int8")
    jmodel = JaxVALLE(JaxConfig(**kw))
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda kk: jmodel.init(
        {"params": kk, "stage": kk}, jnp.asarray(x), jnp.asarray(x_lens), jnp.asarray(prompts),
        jnp.full((b,), p, jnp.int32), train_stage=0, deterministic=True,
        nar_stage=jnp.asarray(1)))(key)
    want = jax_generate(jmodel, variables, jax.random.PRNGKey(1), jnp.asarray(x),
                        jnp.asarray(x_lens), jnp.asarray(prompts), jnp.asarray(prompt_lens),
                        top_k=1, max_new_tokens=max_new, forbid_eos=True,
                        stop_lens=jnp.asarray(stop_lens))

    cfg = ModelConfig(attn_impl="flash", **kw)
    assert cfg.decoder_dim // cfg.nhead == 48
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, variables), cfg, "valle",
                                              device="cpu"))
    got = generate(model, *(torch.from_numpy(a).long() for a in (x, x_lens, prompts, prompt_lens)),
                   top_k=1, max_new_tokens=max_new, forbid_eos=True,
                   stop_lens=torch.from_numpy(stop_lens).long(), ragged_decode=True,
                   generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
