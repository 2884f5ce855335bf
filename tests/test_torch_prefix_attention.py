"""Kernel 2 of the port (prefix-LM / dense attention forward): its plain
PyTorch version against the JAX Pallas kernel ``fused_prefix_attention`` in
interpret mode, and the port's attention routing against the JAX one.  The
CUDA kernel is held to the plain version on the card by chip_smoke.py.

Tolerance 2e-5 in f32, as tests/test_fused_attention.py holds the Pallas
kernel to XLA.  Rows that see no visible column at all are left out of the
comparison: the JAX kernel adds -1e9 for the structural mask where the port
excludes the column, so such rows differ, and no caller reads them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.ops import masks as jm
from valle_tpu.ops.attention_impl import _xla_attention as jax_xla_attention
from valle_tpu.ops.attention_impl import dot_product_attention as jax_dpa
from valle_tpu.ops.fused_attention import fused_prefix_attention as jax_fused
from valle_tpu_torch.ops import masks as tm
from valle_tpu_torch.ops.attention_impl import _xla_attention, dot_product_attention
from valle_tpu_torch.ops.fused_attention import (
    fused_prefix_attention,
    fused_prefix_attention_reference,
)


def _rand(rng, *shape):
    return (rng.randn(*shape) * 0.5).astype(np.float32)


def _prefix_case(seed=0, b=3, s=37, t=150, h=2, dh=16):
    """[text ; right-aligned prompt] with text padding and prompt filler."""
    rng = np.random.RandomState(seed)
    q, k, v = (_rand(rng, b, t, h, dh) for _ in range(3))
    x_lens = np.array([37, 20, 1])[:b]
    p_lens = np.array([t - s, 40, 90])[:b]
    text_pad = np.arange(s)[None, :] >= x_lens[:, None]
    audio_pad = np.arange(t - s)[None, :] < (t - s) - p_lens[:, None]
    key_pad = np.concatenate([text_pad, audio_pad], 1)
    return q, k, v, np.where(key_pad, -1e9, 0.0).astype(np.float32), key_pad


def _visible_rows(key_pad, prefix_s, tq):
    """(B, Tq) bool: rows that see at least one unmasked column."""
    tk = key_pad.shape[1]
    if prefix_s is None:
        allowed = np.ones((tq, tk), bool)
    else:
        allowed = ~np.asarray(jm.prefix_lm_attn_mask(prefix_s, tk - prefix_s))[:tq]
    return (allowed[None] & ~key_pad[:, None, :]).any(-1)


@pytest.mark.parametrize("mode", ["prefix", "causal"])
def test_plain_version_matches_jax_kernel_structured(mode):
    q, k, v, kv_bias, key_pad = _prefix_case()
    prefix_s = 37
    if mode == "causal":  # the VALL-F prefill: audio only, prompt filler first
        q, k, v, kv_bias, key_pad = (np.ascontiguousarray(a[:, 37:])
                                     for a in (q, k, v, kv_bias, key_pad))
        prefix_s = 0
    want = np.asarray(jax_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(kv_bias), prefix_s=prefix_s, interpret=True))
    got = fused_prefix_attention(*(torch.from_numpy(a) for a in (q, k, v, kv_bias)),
                                 prefix_s=prefix_s).numpy()
    rows = _visible_rows(key_pad, prefix_s, q.shape[1])
    if mode == "causal":
        assert not rows.all()  # the prompt filler rows see nothing: excluded
    np.testing.assert_allclose(got[rows], want[rows], atol=2e-5, rtol=0)


@pytest.mark.parametrize("tq,tk", [(150, 77), (45, 130), (99, 99)])
def test_plain_version_matches_jax_kernel_dense(tq, tk):
    rng = np.random.RandomState(tq)
    q = _rand(rng, 2, tq, 2, 32)
    k, v = _rand(rng, 2, tk, 2, 32), _rand(rng, 2, tk, 2, 32)
    pad = np.arange(tk)[None, :] >= np.array([tk, tk // 2])[:, None]
    kv_bias = np.where(pad, -1e9, 0.0).astype(np.float32)
    want = np.asarray(jax_fused(*(jnp.asarray(a) for a in (q, k, v, kv_bias)), interpret=True))
    got = fused_prefix_attention(*(torch.from_numpy(a) for a in (q, k, v, kv_bias))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_xla_twin_matches_jax():
    q, k, v, kv_bias, key_pad = _prefix_case(seed=1)
    dense = np.asarray(jm.AttnMaskSpec(jnp.asarray(kv_bias), 37).dense(q.shape[1]))
    want = np.asarray(jax_xla_attention(*(jnp.asarray(a) for a in (q, k, v, dense)),
                                        0.0, None, True))
    got = _xla_attention(*(torch.tensor(a) for a in (q, k, v, dense))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", ["xla", "fused", "flash", "flash_kp"])
def test_routing_matches_jax_on_every_mask_kind(impl):
    """Each impl gives the JAX package's result on a structured spec, a
    key-padding bias and a dense per-query bias (Tq > 1)."""
    q, k, v, kv_bias, key_pad = _prefix_case(seed=2)
    tq = q.shape[1]
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq_, tk_, tv_ = (torch.from_numpy(a) for a in (q, k, v))
    rows = _visible_rows(key_pad, 37, tq)

    want = np.asarray(jax_dpa(jq, jk, jv, bias=jm.AttnMaskSpec(jnp.asarray(kv_bias), 37),
                              impl="xla"))
    got = dot_product_attention(tq_, tk_, tv_, bias=tm.AttnMaskSpec(torch.from_numpy(kv_bias), 37),
                                impl=impl).numpy()
    np.testing.assert_allclose(got[rows], want[rows], atol=2e-5, rtol=0)

    kp = kv_bias[:, None, None, :]
    want = np.asarray(jax_dpa(jq, jk, jv, bias=jnp.asarray(kp), impl="xla"))
    got = dot_product_attention(tq_, tk_, tv_, bias=torch.from_numpy(kp), impl=impl).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)

    dense = np.array(jm.AttnMaskSpec(jnp.asarray(kv_bias), 37).dense(tq))
    want = np.asarray(jax_dpa(jq, jk, jv, bias=jnp.asarray(dense), impl="xla"))
    got = dot_product_attention(tq_, tk_, tv_, bias=torch.from_numpy(dense), impl=impl).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_fully_masked_rows_are_uniform_over_structural_columns():
    """The port's semantics on a row whose visible columns are all padded:
    uniform weights over the structurally visible columns (finite, not NaN)."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(_rand(rng, 1, 6, 1, 16)) for _ in range(3))
    kv_bias = torch.tensor([[-1e9, -1e9, 0.0, 0.0, 0.0, 0.0]])
    out = fused_prefix_attention_reference(q, k, v, kv_bias, prefix_s=0)
    torch.testing.assert_close(out[0, 1], v[0, :2].mean(0), atol=1e-6, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="dropout_seed"):
        fused_prefix_attention(q, q, q, None, dropout_rate=0.1)
    with pytest.raises(ValueError, match="dropout_rate"):
        fused_prefix_attention(q, q, q, None, dropout_rate=1.0, dropout_seed=0)
    with pytest.raises(ValueError, match="Tq == Tk"):
        fused_prefix_attention(q, q[:, :3], q[:, :3], None, prefix_s=1)
    with pytest.raises(ValueError, match="kv_bias"):
        fused_prefix_attention(q, q, q, torch.zeros(1, 5))
