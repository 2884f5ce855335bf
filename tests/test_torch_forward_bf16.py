"""The bf16 forward of kernels 2 and 4 of the port against the JAX kernels.

Both JAX forwards round the probabilities to the input dtype before the P.V
product: ``_fwd_kernel`` (``valle_tpu/ops/fused_attention.py``) rounds the
unnormalised p = exp(s - row max) after dropout and divides by the f32 row
sum afterwards; the library flash kernel behind the dense-bias branch of
``flash_attention_biased`` rounds the normalised P when the keys fit one
block (Tk <= 1024).  The port's plain versions
(``attention_forward_reference``, ``flash_attention_forward_reference``)
round at the same points, so in bf16 they give JAX's outputs up to the order
of the f32 sums: at least 99% of the outputs bit-equal and the rest within
one bf16 ulp of the largest output of their (row, head), on rows with a
visible column.  Without the rounding about 40% of the outputs differ.  (An
output near 0 is a cancelling sum, so a p that rounds the other way moves it
by many of its own ulps; the ulp of the row's largest output is the scale of
that sum.)

The JAX side runs its Pallas kernels in interpret mode on the CPU, as the JAX
package's own tests do.  The CUDA kernels are held to these plain versions
on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from valle_tpu.ops.flash_attention import flash_attention_biased as jax_flash
from valle_tpu.ops.fused_attention import fused_prefix_attention as jax_fused
from valle_tpu_torch.ops.flash_attention import flash_attention_biased
from valle_tpu_torch.ops.fused_attention import fused_prefix_attention
from tests.test_torch_stall_guard import stall_guard

B, T, H, DH = 2, 200, 2, 64
PREFIX_S = 48
MIN_BIT_EQUAL = 0.99

_stall_guard = stall_guard(60)  # about 10x the file's time in the parallel tier-1 run


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed):
    """q, k, v rounded to bf16 (as f32 numpy arrays) and the key lengths."""
    rng = np.random.RandomState(seed)
    qkv = [rng.randn(B, T, H, DH).astype(np.float32) for _ in range(3)]
    qkv = [np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)) for x in qkv]
    lens = np.array([T, rng.randint(T // 2, T)])
    return (*qkv, lens)


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def _ulp_bf16(x):
    """The bf16 ulp at |x| (of the smallest normal at 0)."""
    _, e = np.frexp(np.maximum(np.abs(x), np.float32(2.0 ** -126)))
    return np.ldexp(np.float32(1.0), e - 8)


def _assert_matches_jax(got, want, rows_visible):
    """got, want: (B, T, H, DH) f32 values of bf16 outputs; rows_visible:
    (B, T) bool."""
    got, want = got[rows_visible], want[rows_visible]  # (rows, H, DH)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    diff = np.abs(got - want)
    equal = float(np.mean(diff == 0))
    ulp = _ulp_bf16(np.maximum(np.abs(got), np.abs(want)).max(-1, keepdims=True))
    assert equal >= MIN_BIT_EQUAL, f"only {equal:.4f} of the bf16 outputs equal JAX's"
    assert (diff <= ulp).all(), \
        f"an output is {float((diff / ulp).max())} bf16 ulps of its row off JAX's"


@pytest.mark.parametrize("mode", ["prefix", "causal", "dense"])
def test_prefix_attention_bf16_rounds_p_like_jax(mode):
    q, k, v, lens = _inputs({"prefix": 1, "causal": 2, "dense": 3}[mode])
    prefix_s = {"prefix": PREFIX_S, "causal": 0, "dense": None}[mode]
    kv_bias = np.where(np.arange(T)[None, :] >= lens[:, None], -1e9, 0.0).astype(np.float32)
    want = jax_fused(*(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
                     jnp.asarray(kv_bias), prefix_s=prefix_s, interpret=True)
    got = fused_prefix_attention(_bf16(q), _bf16(k), _bf16(v), torch.from_numpy(kv_bias),
                                 prefix_s=prefix_s)
    assert got.dtype == torch.bfloat16
    # every row sees column 0 structurally, and no length is 0
    _assert_matches_jax(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                        np.ones((B, T), bool))


def test_flash_attention_bf16_rounds_p_like_jax():
    q, k, v, lens = _inputs(4)
    col = np.arange(T)
    masked = (col[None, :] > col[:, None])[None] | (col[None, None, :] >= lens[:, None, None])
    bias = np.where(masked, -1e9, 0.0).astype(np.float32)[:, None]  # (B, 1, T, T)
    with pltpu.force_tpu_interpret_mode():  # one jitted call: see _stall_guard
        want = jax.jit(jax_flash)(*(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)),
                                  jnp.asarray(bias))
    got = flash_attention_biased(_bf16(q), _bf16(k), _bf16(v), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    _assert_matches_jax(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                        (~masked).any(-1))
