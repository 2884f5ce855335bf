"""Kernel 1's split-K design and the head dims of kernels 1-4, on the CPU.

- A torch mirror of the arithmetic of ``csrc/ragged_decode.cu``: the same
  plan (``split_plan``: split and stage widths, warps per head group), per
  warp an online softmax over column pairs, the warps merged in order, then
  the splits combined in a fixed order.  Held to
  ``ragged_decode_attention_reference`` within 1e-5 (f32, summation order
  only) and to the JAX reference on the same numpy inputs, at Dh 48 and 96,
  with int8, f32 and bf16 caches, on lengths 0, 1, on a split edge and past
  C, a split made only of -1e9 holes and a slot made only of holes.
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
    ragged_decode_attention, ragged_decode_attention_reference, split_plan)
from valle_tpu_torch.sample import generate
from valle_tpu_torch.utils.bridge import state_dict_from_jax

INIT_MAX = -2e9
KV_BYTES = {"int8": 1, "bfloat16": 2, "float32": 4}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- kernel 1 mirror


def split_k_mirror(q, k, v, lengths, bias, k_scale, v_scale, plan):
    """(B, 1, H, Dh) f32 by the split kernel's and the combine kernel's
    arithmetic: q pre-scaled by the f32 1 / sqrt(Dh); per split, per warp
    ``wc`` of a head group, its ``cols_per_warp`` columns of every stage of
    ``stage_cols`` columns in one online-softmax step; the warps merged in
    order of wc; the live splits combined in order."""
    b, cap, h, dh = k.shape
    kf, vf = k.float(), v.float()
    scale = np.float32(1.0) / np.sqrt(np.float32(dh))
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
    for dh in (8, 40, 264):
        with pytest.raises(ValueError, match="multiples of 16"):
            split_plan(8, 768, 4, dh, 1, 132)
    with pytest.raises(ValueError, match="head groups"):
        split_plan(8, 768, 64, 64, 4, 132)


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
    with pltpu.force_tpu_interpret_mode():
        jout = jax_flash(*jargs)
        jgrads = jax.grad(f, argnums=(0, 1, 2, 3))(*jargs)
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
    with pytest.raises(ValueError, match="up to 128"):
        run_padded(launch, (torch.randn(2, 3, 144),), n_sliced=1)


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
