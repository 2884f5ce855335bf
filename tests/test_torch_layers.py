"""Attention and transformer layers of the port against the JAX package's, on
the same numpy inputs and the same weights (the JAX init mapped to the
reference key names).  Tolerance 1e-5 in f32 (summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.nn.attention import MultiheadAttention as JaxMHA
from valle_tpu.nn.attention import _decode_attention_quantized as jax_decode_q
from valle_tpu.nn.attention import quantize_kv as jax_quantize_kv
from valle_tpu.nn.layers import TransformerStack as JaxStack
from valle_tpu.ops import masks as jm
from valle_tpu_torch.nn.attention import (
    MultiheadAttention,
    _decode_attention_quantized,
    quantize_kv,
)
from valle_tpu_torch.nn.layers import (BalancedBasicNorm, IdentityNorm, TransformerStack,
                                       conditioned_norm)
from valle_tpu_torch.ops import masks as tm
from valle_tpu_torch.utils import bridge

D, H, DH = 32, 4, 8


def _np(tree):
    return jax.tree.map(np.array, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_quantize_kv_equal_exactly():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 9, 4, 16) * 5).astype(np.float32)
    # exact halves after scaling (scale = 1): round half to even in both
    x[0, 0, 0, :4] = [127.0, 2.5, -3.5, 0.5]
    x[0, 0, 1] = 0.0  # all-zero row: the 1e-8 scale floor
    q8j, sj = jax_quantize_kv(jnp.asarray(x))
    q8t, st = quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(q8j), q8t.numpy())
    np.testing.assert_array_equal(np.asarray(sj), st.numpy())
    assert list(q8t[0, 0, 0, :4]) == [127, 2, -4, 0]


def test_decode_attention_quantized_matches():
    rng = np.random.RandomState(1)
    q = rng.randn(2, 1, H, DH).astype(np.float32)
    k8, ks = (np.array(a) for a in jax_quantize_kv(jnp.asarray(rng.randn(2, 11, H, DH))))
    v8, vs = (np.array(a) for a in jax_quantize_kv(jnp.asarray(rng.randn(2, 11, H, DH))))
    bias = np.where(rng.rand(2, 1, 1, 11) < 0.3, -1e9, 0.0).astype(np.float32)
    want = jax_decode_q(*(jnp.asarray(a) for a in (q, k8, v8, ks, vs, bias)))
    got = _decode_attention_quantized(*(_t(a) for a in (q, k8, v8, ks, vs, bias)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _mha_port(params, cross, impl="xla"):
    m = MultiheadAttention(D, H, attn_impl=impl)
    if cross:
        w = np.concatenate([params["q_proj"]["kernel"].T, params["kv_proj"]["kernel"].T], 0)
        b = np.concatenate([params["q_proj"]["bias"], params["kv_proj"]["bias"]], 0)
    else:
        w, b = params["in_proj"]["kernel"].T, params["in_proj"]["bias"]
    m.load_state_dict({"in_proj_weight": _t(w), "in_proj_bias": _t(b),
                       "out_proj.weight": _t(params["out_proj"]["kernel"].T),
                       "out_proj.bias": _t(params["out_proj"]["bias"])})
    return m


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_self_attention_with_prefix_mask_and_return_kv(impl):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 10, D).astype(np.float32)
    key_pad = np.zeros((2, 10), bool)
    key_pad[1, 2:4] = True  # text padding inside the prefix of row 1
    bias = np.where(key_pad, -1e9, 0.0).astype(np.float32)
    mha = JaxMHA(D, H)
    jspec = jm.AttnMaskSpec(jnp.asarray(bias), prefix_s=4)
    params = _np(mha.init(jax.random.PRNGKey(0), jnp.asarray(x), attn_bias=jspec)["params"])
    out, _, kv = mha.apply({"params": params}, jnp.asarray(x), attn_bias=jspec, return_kv=True)
    port = _mha_port(params, cross=False, impl=impl)
    got, _, got_kv = port(_t(x), attn_bias=tm.AttnMaskSpec(_t(bias), prefix_s=4), return_kv=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=1e-5)
    for a, b in zip(got_kv, kv):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-5)


def test_cross_attention_with_key_padding():
    rng = np.random.RandomState(3)
    xq = rng.randn(2, 9, D).astype(np.float32)
    mem = rng.randn(2, 6, D).astype(np.float32)
    mem_bias = np.where(np.arange(6)[None] >= np.array([6, 3])[:, None], -1e9, 0.0)
    mem_bias = mem_bias.astype(np.float32)[:, None, None, :]
    mha = JaxMHA(D, H)
    params = _np(mha.init(jax.random.PRNGKey(1), jnp.asarray(xq), jnp.asarray(mem),
                          attn_bias=jnp.asarray(mem_bias))["params"])
    want, _, _ = mha.apply({"params": params}, jnp.asarray(xq), jnp.asarray(mem),
                           attn_bias=jnp.asarray(mem_bias))
    for impl in ("xla", "flash"):
        port = _mha_port(params, cross=True, impl=impl)
        got, _, _ = port(_t(xq), _t(mem), attn_bias=_t(mem_bias))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("int8", [True, False])
def test_stacked_cache_decode_step(int8):
    """One decode step through layer 1 of a stacked 2-layer cache at column
    5: the written column, the dense read and the kernel-1 read."""
    rng = np.random.RandomState(4)
    n_layers, b, c, idx = 2, 3, 9, 5
    x = rng.randn(b, 1, D).astype(np.float32)
    kf, vf = (rng.randn(n_layers, b, c, H, DH).astype(np.float32) for _ in range(2))
    if int8:
        (k8, ks), (v8, vs) = (tuple(np.array(a) for a in jax_quantize_kv(jnp.asarray(t)))
                              for t in (kf, vf))
        cache = (k8, v8, ks, vs)
    else:
        cache = (kf, vf)
    valid = np.arange(c)[None, :] <= idx
    valid = valid & ~(np.arange(c)[None, :] == np.array([[1], [3], [0]]))  # prompt holes
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    mha = JaxMHA(D, H)
    params = _np(mha.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    jcache = tuple(jnp.asarray(a) for a in cache) + (1,)
    want, want_cache, _ = mha.apply({"params": params}, jnp.asarray(x), attn_bias=jnp.asarray(bias),
                                    kv_cache=jcache, cache_index=idx)
    lengths = np.full((b,), idx + 1, np.int32)
    lengths[2] = 0  # a finished slot: kernel 1 gives zeros there
    want_ragged, _, _ = mha.apply({"params": params}, jnp.asarray(x), attn_bias=jnp.asarray(bias),
                                  kv_cache=jcache, cache_index=idx, kv_lengths=jnp.asarray(lengths))

    port = _mha_port(params, cross=False)
    with torch.inference_mode():
        tcache = tuple(_t(a) for a in cache)
        got, got_cache, _ = port(_t(x), attn_bias=_t(bias), kv_cache=tcache + (1,), cache_index=idx)
        for a, w in zip(got_cache, want_cache):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w)) if int8 else \
                np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-6)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        got_r, _, _ = port(_t(x), attn_bias=_t(bias), kv_cache=tcache + (1,), cache_index=idx,
                           kv_lengths=torch.from_numpy(lengths))
    # live slots: the kernel-1 read equals the JAX dense read; the finished
    # slot reads nothing in both packages, leaving the out_proj bias
    np.testing.assert_allclose(got_r.numpy()[:2], np.asarray(want)[:2], atol=1e-5)
    np.testing.assert_allclose(got_r.numpy()[2], np.asarray(want_ragged)[2], atol=1e-6)
    np.testing.assert_allclose(got_r.numpy()[2, 0], params["out_proj"]["bias"], atol=1e-6)


@pytest.mark.parametrize("norm_first,adaptive,cross", [
    (True, False, False),   # AR pre-norm (VALL-E)
    (False, False, False),  # post-norm
    (True, True, False),    # NAR: adaptive layer norm on the stage embedding
    (True, False, True),    # VALL-F AR: cross-attention
    (False, True, True),    # VALL-F NAR post-norm
])
def test_transformer_stack_matches(norm_first, adaptive, cross):
    rng = np.random.RandomState(5)
    x = rng.randn(2, 8, D).astype(np.float32)
    stage = rng.randn(1, D).astype(np.float32) if adaptive else None
    mem = rng.randn(2, 5, D).astype(np.float32) if cross else None
    bias = np.where(np.arange(8)[None] >= np.array([8, 6])[:, None], -1e9, 0.0).astype(np.float32)
    mem_bias = np.where(np.arange(5)[None] >= np.array([5, 2])[:, None], -1e9, 0.0)
    mem_bias = mem_bias.astype(np.float32)[:, None, None, :] if cross else None
    jstack = JaxStack(num_layers=2, d_model=D, nhead=H, dim_feedforward=4 * D, dropout=0.0,
                      norm_first=norm_first, adaptive_norm=adaptive, cross_attention=cross,
                      final_norm=norm_first)
    jkw = dict(stage_emb=None if stage is None else jnp.asarray(stage),
               attn_bias=jm.AttnMaskSpec(jnp.asarray(bias), prefix_s=0),
               memory=None if mem is None else jnp.asarray(mem),
               memory_bias=None if mem_bias is None else jnp.asarray(mem_bias),
               deterministic=True)
    params = _np(jstack.init(jax.random.PRNGKey(3), jnp.asarray(x), **jkw)["params"])
    want, _, _ = jstack.apply({"params": params}, jnp.asarray(x), **jkw)

    sd = {}
    bridge._decoder(sd, params, "stack", 2, adaptive, cross, norm_first)
    port = TransformerStack(2, D, H, 4 * D, norm_first=norm_first, adaptive_norm=adaptive,
                            cross_attention=cross, final_norm=norm_first, attn_impl="flash")
    port.load_state_dict({k[len("stack."):]: _t(v) for k, v in sd.items()})
    got, _, _ = port(_t(x), stage_emb=None if stage is None else _t(stage),
                     attn_bias=tm.AttnMaskSpec(_t(bias), prefix_s=0),
                     memory=None if mem is None else _t(mem),
                     memory_bias=None if mem_bias is None else _t(mem_bias))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


def test_unported_norms_raise():
    # the scaling_xformers norms are ported; an unknown norm type raises
    assert isinstance(conditioned_norm(D, norm_type="identity"), IdentityNorm)
    norm = conditioned_norm(D, adaptive=True, norm_type="balanced_basic")
    assert isinstance(norm, BalancedBasicNorm)  # ignores adaptive, as JAX's does
    assert list(norm.state_dict()) == ["norm.eps"]
    with pytest.raises(ValueError, match="norm_type"):
        conditioned_norm(D, norm_type="rms")
    with pytest.raises(ValueError, match="activation"):
        TransformerStack(1, D, H, 4 * D, activation="swish")


@pytest.mark.parametrize("cross", [False, True])
def test_scaling_stack_train_mode_matches(cross):
    """The scaling_xformers stack (identity / balanced basic norms,
    balanced DoubleSwish, out-projections at 0.01) in train mode at dropout
    0 against JAX's with ``deterministic=False``: the balancers' backward
    runs on both sides.  Output and every gradient within 1e-5 x the
    tensor's largest |value| (f32, summation order)."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 8, D).astype(np.float32)
    x[..., :4] *= 8.0  # channels past the norm balancer's max_abs of 6
    mem = rng.randn(2, 5, D).astype(np.float32) if cross else None
    cot = rng.randn(2, 8, D).astype(np.float32)
    bias = np.where(np.arange(8)[None] >= np.array([8, 6])[:, None], -1e9, 0.0)
    bias = np.broadcast_to(bias.astype(np.float32)[:, None, None, :], (2, 1, 8, 8))
    bias = bias + np.triu(np.full((8, 8), -1e9, np.float32), 1)  # causal + padding, dense
    mem_bias = np.where(np.arange(5)[None] >= np.array([5, 3])[:, None], -1e9, 0.0)
    mem_bias = mem_bias.astype(np.float32)[:, None, None, :] if cross else None
    layout = dict(activation="balanced_double_swish", norm_type="identity", out_init_scale=0.01)
    jstack = JaxStack(num_layers=2, d_model=D, nhead=H, dim_feedforward=4 * D, dropout=0.0,
                      cross_attention=cross, **layout)
    jkw = dict(attn_bias=jnp.asarray(bias), memory=None if mem is None else jnp.asarray(mem),
               memory_bias=None if mem_bias is None else jnp.asarray(mem_bias))
    params = _np(jstack.init(jax.random.PRNGKey(4), jnp.asarray(x), **jkw)["params"])

    def loss(p, xx):
        out = jstack.apply({"params": p}, xx, deterministic=False, **jkw)[0]
        return jnp.sum(out * cot), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))

    def port_sd(tree):
        sd = {}
        bridge._decoder(sd, _np(tree), "stack", 2, False, cross, True, norm_type="identity")
        return {k[len("stack."):]: _t(v) for k, v in sd.items()}

    port = TransformerStack(2, D, H, 4 * D, cross_attention=cross, attn_impl="flash",
                            **layout).train()
    port.load_state_dict(port_sd(params))
    xt = _t(x).requires_grad_(True)
    got = port(xt, attn_bias=_t(bias), memory=None if mem is None else _t(mem),
               memory_bias=None if mem_bias is None else _t(mem_bias))[0]
    (got * _t(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    grads = dict(port_sd(gp), x=_t(gx))
    named = dict(port.named_parameters(), x=xt)
    assert set(grads) == set(named)
    for name, g in grads.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(), rtol=0,
                                   atol=1e-5 * max(float(g.abs().max()), 1e-30), err_msg=name)
    # the balancers moved the gradients: eval mode (no balancers) differs
    port.eval()
    port.zero_grad()
    xe = _t(x).requires_grad_(True)
    (port(xe, attn_bias=_t(bias), memory=None if mem is None else _t(mem),
          memory_bias=None if mem_bias is None else _t(mem_bias))[0] * _t(cot)).sum().backward()
    assert not torch.equal(xe.grad, xt.grad)
