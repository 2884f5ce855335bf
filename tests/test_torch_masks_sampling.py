"""Masks and sampling: the port's functions against ``valle_tpu.ops.masks``
and ``valle_tpu.ops.sampling`` on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.ops import masks as jm
from valle_tpu.ops import sampling as js
from valle_tpu_torch.ops import masks as tm
from valle_tpu_torch.ops import sampling as ts


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_pad_causal_prefix_and_merge_masks_equal():
    lens = np.array([0, 3, 7, 5], np.int32)
    _eq(jm.make_pad_mask(jnp.asarray(lens), 7), tm.make_pad_mask(torch.from_numpy(lens), 7))
    _eq(jm.causal_mask(6), tm.causal_mask(6))
    for s, t in [(0, 5), (3, 4), (5, 1), (4, 0)]:
        _eq(jm.prefix_lm_attn_mask(s, t), tm.prefix_lm_attn_mask(s, t))
    struct = np.array(jm.prefix_lm_attn_mask(3, 4))
    pad = np.random.RandomState(0).rand(2, 7) < 0.3
    _eq(jm.merge_padding(jnp.asarray(struct), jnp.asarray(pad)),
        tm.merge_padding(torch.from_numpy(struct), torch.from_numpy(pad)))


def test_mask_to_bias_equal():
    m = np.random.RandomState(1).rand(3, 1, 1, 9) < 0.5
    _eq(jm.mask_to_bias(jnp.asarray(m)), tm.mask_to_bias(torch.from_numpy(m)))


@pytest.mark.parametrize("prefix_s", [None, 0, 4])
def test_attn_mask_spec_dense_equal(prefix_s):
    pad = np.random.RandomState(2).rand(2, 11) < 0.3
    kv_bias = np.where(pad, -1e9, 0.0).astype(np.float32)
    for tq in (11, 1) if prefix_s is None else (11,):
        want = jm.AttnMaskSpec(jnp.asarray(kv_bias), prefix_s).dense(tq)
        got = tm.AttnMaskSpec(torch.from_numpy(kv_bias), prefix_s).dense(tq)
        _eq(want, got)


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (1, 1.0), (0, 0.9), (7, 0.5),
                                         (0, 0.3)])
def test_filtered_logits_equal_exactly(top_k, top_p):
    logits = (np.random.RandomState(3).randn(4, 37) * 3).astype(np.float32)
    want = js.top_k_top_p_filtering(jnp.asarray(logits), top_k=top_k, top_p=top_p)
    got = ts.top_k_top_p_filtering(torch.from_numpy(logits), top_k=top_k, top_p=top_p)
    _eq(want, got)


def test_top_k_1_sampling_is_argmax():
    logits = torch.from_numpy(np.random.RandomState(4).randn(64, 1025).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    got = ts.topk_sampling(logits, top_k=1, generator=gen)
    assert torch.equal(got, logits.argmax(-1))
    want = js.topk_sampling(jax.random.PRNGKey(0), jnp.asarray(logits.numpy()), top_k=1)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_sampling_distribution_matches_filtered_softmax():
    """Gumbel-max sampling with top_k=3 and a temperature draws each kept
    token at its softmax probability (the JAX stream differs, the law not)."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0]])
    n = 20000
    gen = torch.Generator().manual_seed(5)
    draws = ts.topk_sampling(logits.expand(n, 5), top_k=3, temperature=0.7, generator=gen)
    freq = torch.bincount(draws, minlength=5).double() / n
    kept = torch.softmax(ts.top_k_top_p_filtering(logits / 0.7, top_k=3), -1)[0].double()
    assert float(freq[3:].sum()) == 0.0
    assert torch.allclose(freq, kept, atol=0.015), (freq, kept)
