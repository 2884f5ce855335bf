"""Kernels 2 and 3 of the port in training (``ops/fused_attention.py``): the
autograd Function on the CPU, which runs the plain forward and the plain
backward, against the JAX package.

  - dropout 0: against ``jax.vjp`` of the JAX ``fused_prefix_attention`` in
    Pallas interpret mode, whose backward is the body of ``_bwd_kernel``, in
    prefix, causal, dense and cross mode.  Tolerance: 2e-5 on the output (as
    tests/test_torch_prefix_attention.py), 1e-5 on the gradients (f32).
  - dropout 0.1: against JAX ``_xla_attention`` with ``jax.random.bernoulli``
    replaced, in the test, by the port's Philox keep mask; same tolerances.
  - the plain backward against torch autograd through the plain forward with
    the same mask, in float64 (1e-12).
  - the routing: every route of ``dot_product_attention`` drops the same
    probabilities for the same generator state.

Every row of the inputs sees at least one visible column; rows that see
none differ between the packages by design (see ops/fused_attention.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.ops import masks as jm
from valle_tpu.ops.attention_impl import _xla_attention as jax_xla_attention
from valle_tpu.ops.fused_attention import fused_prefix_attention as jax_fused
from valle_tpu_torch.ops import masks as tm
from valle_tpu_torch.ops.attention_impl import dot_product_attention
from valle_tpu_torch.ops.fused_attention import (
    attention_backward_reference,
    attention_forward_reference,
    fused_prefix_attention,
    fused_prefix_attention_backward,
)
from valle_tpu_torch.ops.philox import dropout_keep_mask

B, H, DH = 2, 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(mode: str, seed: int = 0):
    """(q, k, v, dout, (B, Tk) key bias, prefix_s) with text padding and
    right-padded audio, so every row sees a visible column."""
    rng = np.random.RandomState(seed)
    tq, tk, s = {"prefix": (150, 150, 37), "causal": (113, 113, 0), "dense": (99, 99, None),
                 "cross": (45, 130, None)}[mode]
    q = (rng.randn(B, tq, H, DH) * 0.5).astype(np.float32)
    k, v = ((rng.randn(B, tk, H, DH) * 0.5).astype(np.float32) for _ in range(2))
    dout = rng.randn(B, tq, H, DH).astype(np.float32)
    lens = np.array([tk, tk - 40])
    pad = np.arange(tk)[None, :] >= lens[:, None]
    if mode == "prefix":  # text padding too
        pad[1, 20:s] = True
    bias = np.where(pad, -1e9, 0.0).astype(np.float32)
    return q, k, v, dout, bias, s


def _dense_bias(bias, prefix_s, tq):
    if prefix_s is None:
        return bias[:, None, None, :]
    return np.asarray(jm.AttnMaskSpec(jnp.asarray(bias), prefix_s).dense(tq))


def _port(q, k, v, dout, bias, prefix_s, **kw):
    tq_, tk_, tv_ = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fused_prefix_attention(tq_, tk_, tv_, torch.from_numpy(bias), prefix_s=prefix_s, **kw)
    grads = torch.autograd.grad(out, (tq_, tk_, tv_), torch.from_numpy(dout))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _check(got_out, got_grads, want_out, want_grads):
    np.testing.assert_allclose(got_out, np.asarray(want_out), atol=2e-5, rtol=0)
    for name, g, w in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("mode", ["prefix", "causal", "dense", "cross"])
def test_backward_matches_jax_kernel_at_dropout_0(mode):
    q, k, v, dout, bias, prefix_s = _case(mode)
    out, vjp = jax.vjp(
        lambda a, b_, c: jax_fused(a, b_, c, jnp.asarray(bias), prefix_s=prefix_s,
                                   interpret=True),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    _check(*_port(q, k, v, dout, bias, prefix_s), out, want)


@pytest.mark.parametrize("mode", ["prefix", "cross"])
def test_dropout_matches_jax_on_the_injected_mask(mode, monkeypatch):
    q, k, v, dout, bias, prefix_s = _case(mode, seed=1)
    rate, seed = 0.1, 987654321
    keep = dropout_keep_mask(seed, B, H, q.shape[1], k.shape[1], rate).numpy()
    assert 0 < keep.mean() < 1
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(keep))
    dense = jnp.asarray(_dense_bias(bias, prefix_s, q.shape[1]))
    out, vjp = jax.vjp(
        lambda a, b_, c: jax_xla_attention(a, b_, c, dense, rate, jax.random.PRNGKey(0), False),
        *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    _check(*_port(q, k, v, dout, bias, prefix_s, dropout_rate=rate, dropout_seed=seed),
           out, want)


@pytest.mark.parametrize("mode", ["prefix", "causal", "dense", "cross"])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_plain_backward_matches_autograd_in_float64(mode, rate):
    q, k, v, dout, bias, prefix_s = (torch.from_numpy(a).double() if isinstance(a, np.ndarray)
                                     else a for a in _case(mode, seed=2))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out, lse = attention_forward_reference(q, k, v, bias, prefix_s, rate, 42)
    want = torch.autograd.grad(out, (q, k, v), dout)
    got = attention_backward_reference(q.detach(), k.detach(), v.detach(), bias, out.detach(),
                                       dout, lse, prefix_s, rate, 42)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-12, rtol=0)
    # the row log-sum-exp is that of the masked logits
    logits = torch.einsum("bqhd,bkhd->bhqk", q.detach(), k.detach()) / DH**0.5
    logits = logits + bias[:, None, None, :]
    if prefix_s is not None:
        logits = logits.masked_fill(
            tm.prefix_lm_attn_mask(prefix_s, k.shape[1] - prefix_s)[: q.shape[1]], -np.inf)
    torch.testing.assert_close(lse, torch.logsumexp(logits, -1), atol=1e-12, rtol=0)
    # the wrapper of kernel 3 takes the plain version for CPU tensors
    again = fused_prefix_attention_backward(
        q.detach(), k.detach(), v.detach(), bias, out.detach(), dout, lse, prefix_s=prefix_s,
        dropout_rate=rate, dropout_seed=42)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("impl", ["xla", "fused", "flash", "flash_kp"])
def test_every_route_drops_the_same_probabilities(impl):
    q, k, v, _, bias, prefix_s = _case("prefix", seed=3)
    q, k, v, bias = (torch.from_numpy(a) for a in (q, k, v, bias))
    spec = tm.AttnMaskSpec(bias, prefix_s)
    rows = torch.ones(q.shape[1], dtype=torch.bool)

    def run(route, rate):
        gen = torch.Generator().manual_seed(11)
        return dot_product_attention(q, k, v, bias=spec, impl=route, dropout_rate=rate, rng=gen)

    got, want = run(impl, 0.1), run("fused", 0.1)
    torch.testing.assert_close(got[:, rows], want[:, rows], atol=2e-6, rtol=0)
    assert not torch.allclose(got, run(impl, 0.0), atol=1e-3)  # dropout did something
    # rate 0: equal to the deterministic route, whatever the generator
    torch.testing.assert_close(run(impl, 0.0), dot_product_attention(q, k, v, bias=spec,
                                                                     impl=impl))
