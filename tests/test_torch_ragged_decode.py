"""Kernel 1 of the port (ragged decode attention): its plain PyTorch version
against the JAX reference and the JAX Pallas kernel in interpret mode, on the
same numpy inputs.  The CUDA kernel itself is held to the plain version on
the card by chip_smoke.py.

Tolerances: 1e-5 against ``ragged_decode_attention_reference`` (both f32,
summation order only); 5e-3 against the Pallas kernel, which rounds q and K
to bf16 for the TPU's matrix unit (as tests/test_ragged_decode.py states).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.nn.attention import quantize_kv as jax_quantize_kv
from valle_tpu.ops.ragged_decode import (
    ragged_decode_attention as jax_ragged,
    ragged_decode_attention_reference as jax_reference,
)
from valle_tpu_torch.ops.ragged_decode import (
    ragged_decode_attention,
    ragged_decode_attention_reference,
)


def _case(cap, quantized, seed=0, with_bias=True):
    rng = np.random.RandomState(seed)
    b, h, dh = 5, 4, 16
    q = rng.randn(b, 1, h, dh).astype(np.float32)
    k = rng.randn(b, cap, h, dh).astype(np.float32)
    v = rng.randn(b, cap, h, dh).astype(np.float32)
    # full, mid, a short prefix, zero (finished slot) and past the cache
    lengths = np.array([cap, cap // 2 + 1, 3, 0, cap + 5], np.int32)
    bias = np.where(rng.rand(b, cap) < 0.25, -1e9, 0.0).astype(np.float32) if with_bias else None
    ks = vs = None
    if quantized:
        k, ks = (np.array(a) for a in jax_quantize_kv(jnp.asarray(k)))
        v, vs = (np.array(a) for a in jax_quantize_kv(jnp.asarray(v)))
    return q, k, v, lengths, bias, ks, vs


def _torch(args):
    return [None if a is None else torch.from_numpy(a) for a in args]


def _jax(args):
    return [None if a is None else jnp.asarray(a) for a in args]


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("cap", [33, 70, 256])
def test_plain_version_matches_jax_reference(quantized, cap):
    args = _case(cap, quantized)
    want = np.asarray(jax_reference(*_jax(args)))
    got = ragged_decode_attention_reference(*_torch(args))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("quantized", [False, True])
def test_wrapper_on_cpu_matches_jax_pallas_kernel(quantized):
    args = _case(70, quantized, seed=1)
    want = np.asarray(jax_ragged(*_jax(args), block_c=32, interpret=True))
    got = ragged_decode_attention(*_torch(args))
    assert got.shape == (5, 1, 4, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=5e-3)


def test_zero_length_slot_is_exactly_zero():
    args = _case(40, True, seed=2)
    got = ragged_decode_attention(*_torch(args))
    assert np.all(got.numpy()[3] == 0.0)


def test_bias_holes_contribute_nothing():
    """A -1e9 column gives the same output as dropping it from the cache."""
    q, k, v, _, _, _, _ = _case(12, False, seed=3, with_bias=False)
    bias = np.zeros((5, 12), np.float32)
    bias[:, 4] = -1e9
    lengths = np.full((5,), 12, np.int32)
    got = ragged_decode_attention(*_torch((q, k, v, lengths, bias, None, None)))
    keep = [c for c in range(12) if c != 4]
    want = ragged_decode_attention(*_torch((q, k[:, keep].copy(), v[:, keep].copy(),
                                            lengths - 1, None, None, None)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_3d_query_and_bfloat16_cache():
    q, k, v, lengths, bias, _, _ = _case(20, False, seed=4)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q[:, 0], k, v))
    got = ragged_decode_attention(tq, tk, tv, torch.from_numpy(lengths), torch.from_numpy(bias))
    want = jax_reference(*_jax((np.asarray(tq.float()), np.asarray(tk.float()),
                                np.asarray(tv.float()), lengths, bias, None, None)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_wrapper_rejects_bad_inputs():
    q, k, v, lengths, bias, ks, vs = _torch(_case(16, True, seed=5))
    with pytest.raises(ValueError, match="k_scale"):
        ragged_decode_attention(q, k, v, lengths, bias)  # int8 without scales
    with pytest.raises(ValueError, match="shape"):
        ragged_decode_attention(q, k[:, :, :2], v, lengths, bias, ks, vs)
    with pytest.raises(ValueError, match="Tq"):
        ragged_decode_attention(torch.cat([q, q], 1), k, v, lengths, bias, ks, vs)
