"""Kernel 4 of the port (dense-bias attention, ``ops/flash_attention.py``):
its plain PyTorch forward and backward against the JAX package's
``flash_attention_biased``, whose dense ``ab`` branch runs JAX's library
Pallas flash kernel, here in Pallas interpret mode on the CPU
(``force_tpu_interpret_mode``); and the port's ``"flash"`` routing of a dense
per-query bias.  The CUDA kernels are held to the plain version on the card
by chip_smoke.py.

Tolerance 1e-5 in f32, absolute on the output and relative to the largest
element of each gradient (q, k, v and the bias), on rows with a visible
column.  A row whose every column is masked differs from JAX by design (JAX
also averages the zero columns it pads to 128); its output gradient is set
to 0, as the losses of the model give it.

The JAX wrapper clips the bias at 0 when it pads the key axis
(``jnp.minimum(ab, where(padded, -1e9, 0))``), which zeroes a positive bias
and splits the gradient at a bias of exactly 0 between the two arguments.
So the soft biases here are negative where T is not a multiple of 128, and
d(bias) of a {0, -1e9} mask is compared at T = 128 only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from valle_tpu.ops.flash_attention import flash_attention_biased as jax_flash
from valle_tpu_torch.ops import attention_impl
from valle_tpu_torch.ops.attention_impl import dot_product_attention
from valle_tpu_torch.ops.flash_attention import (
    flash_attention_backward_reference, flash_attention_biased,
    flash_attention_biased_backward, flash_attention_forward_reference)
from tests.test_torch_stall_guard import stall_guard

B, H, DH = 2, 2, 16
TOL = 1e-5

_stall_guard = stall_guard(120)  # about 4x the file's time in the parallel tier-1 run


def _causal_padding_bias(t, lens):
    """(B, 1, T, T) {0, -1e9}: causal plus key padding past each length."""
    col = np.arange(t)
    masked = (col[None, :] > col[:, None])[None] | (col[None, None, :] >= lens[:, None, None])
    return np.where(masked, -1e9, 0.0).astype(np.float32)[:, None]


def _case(name):
    """(q, k, v, bias, dout, d(bias) compared) of one named case."""
    rng = np.random.RandomState(sum(map(ord, name)))
    tq = tk = {"causal_padding": 37, "causal_padding_128": 128, "soft_per_head": 20,
               "tq_ne_tk": None, "broadcast": 45}[name]
    if name == "tq_ne_tk":
        tq, tk = 12, 20
    q = rng.randn(B, tq, H, DH).astype(np.float32)
    k, v = (rng.randn(B, tk, H, DH).astype(np.float32) for _ in range(2))
    dout = rng.randn(B, tq, H, DH).astype(np.float32)
    bias_grad = True
    if name in ("causal_padding", "causal_padding_128"):
        lens = np.array([tk, 0 if name == "causal_padding" else tk - 29])
        bias = _causal_padding_bias(tk, lens)
        dout[lens == 0] = 0.0  # a fully masked example: the loss skips it
        bias_grad = name == "causal_padding_128"
    elif name == "broadcast":  # one (Tq, Tk) soft bias for every batch row and head
        bias = -np.abs(rng.randn(1, 1, tq, tk)).astype(np.float32) * 2
    else:  # soft, different per head and row
        bias = -np.abs(rng.randn(B, H, tq, tk)).astype(np.float32) * 2
    return q, k, v, bias, dout, bias_grad


def _jax(q, k, v, bias, dout):
    def f(q, k, v, bias):
        return jnp.sum(jax_flash(q, k, v, bias) * dout)

    args = tuple(jnp.asarray(a) for a in (q, k, v, bias))
    with pltpu.force_tpu_interpret_mode():  # one jitted call: see _stall_guard
        out, grads = jax.jit(lambda *a: (jax_flash(*a), jax.grad(f, argnums=(0, 1, 2, 3))(*a)))(
            *args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _close(got, want, name):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(scale, 1.0), err_msg=name)


@pytest.mark.parametrize("name", ["causal_padding", "causal_padding_128", "soft_per_head",
                                  "tq_ne_tk", "broadcast"])
def test_plain_version_matches_jax_library_kernel(name):
    q, k, v, bias, dout, bias_grad = _case(name)
    want_out, want_grads = _jax(q, k, v, bias, dout)

    tq_, tk_, tv_, tb_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias))
    out = flash_attention_biased(tq_, tk_, tv_, tb_)
    (out * torch.from_numpy(dout)).sum().backward()
    full = np.broadcast_to(bias, (B, H) + bias.shape[2:])
    visible = (full > -1e8).any(-1).any(1)  # (B, Tq): rows with a visible column
    _close(out.detach().numpy()[visible], want_out[visible], "out")
    for nm, got, want in zip("qkv", (tq_.grad, tk_.grad, tv_.grad), want_grads):
        _close(got.numpy(), want, f"d{nm}")
    assert tb_.grad.shape == bias.shape
    if bias_grad:
        _close(tb_.grad.numpy(), want_grads[3], "dbias")
    if not visible.all():  # a fully masked row averages v over the Tk columns
        b0 = int(np.argwhere(~visible.all(1))[0, 0])
        np.testing.assert_allclose(out.detach().numpy()[b0], np.broadcast_to(
            v[b0].mean(0), out.shape[1:]), atol=1e-5, rtol=0)


def test_bias_is_added_before_the_scale():
    """A soft bias pins the library's order: (q kᵀ + bias) * scale, not
    q kᵀ * scale + bias (JAX's ``_xla_attention``)."""
    q, k, v, bias, _, _ = _case("soft_per_head")
    tq_, tk_, tv_, tb_ = (torch.from_numpy(a) for a in (q, k, v, bias))
    got = flash_attention_biased(tq_, tk_, tv_, tb_)
    s = torch.einsum("bqhd,bkhd->bhqk", tq_, tk_)
    lib = torch.einsum("bhqk,bkhd->bqhd", torch.softmax((s + tb_) / DH**0.5, -1), tv_)
    xla = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s / DH**0.5 + tb_, -1), tv_)
    torch.testing.assert_close(got, lib, atol=1e-6, rtol=0)
    assert float((got - xla).abs().max()) > 100 * TOL


def test_backward_reference_writes_bias_grad_only_when_asked():
    q, k, v, bias, dout, _ = _case("tq_ne_tk")
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    out, lse = flash_attention_forward_reference(*args)
    d = torch.from_numpy(dout)
    without = flash_attention_biased_backward(*args, out, d, lse)
    with_bias = flash_attention_backward_reference(*args, out, d, lse, bias_grad=True)
    assert without[3] is None and with_bias[3].shape == (B, H, 12, 20)
    for a, b in zip(without[:3], with_bias[:3]):
        assert torch.equal(a, b)


def test_flash_routes_a_dense_bias_to_kernel_4(monkeypatch):
    """``"flash"`` sends a dense per-query bias (Tq > 1, no dropout) to kernel
    4's wrapper, which on the CPU runs the plain version (the launch counter
    does not move); key padding stays on kernel 2, dropout on the plain math."""
    calls = []

    def spy(*args):
        calls.append(args[3].shape)
        return flash_attention_biased(*args)

    monkeypatch.setattr(attention_impl, "flash_attention_biased", spy)
    q, k, v, bias, _, _ = _case("causal_padding_128")
    tq_, tk_, tv_, tb_ = (torch.from_numpy(a) for a in (q, k, v, bias))
    launches = (flash_attention_biased.launches, flash_attention_biased_backward.launches)
    got = dot_product_attention(tq_, tk_, tv_, bias=tb_, impl="flash")
    torch.testing.assert_close(got, flash_attention_forward_reference(tq_, tk_, tv_, tb_)[0])
    assert calls == [tb_.shape]
    for impl in ("xla", "fused", "flash_kp"):
        dot_product_attention(tq_, tk_, tv_, bias=tb_, impl=impl)
    dot_product_attention(tq_, tk_, tv_, bias=tb_[:, :, :1], impl="flash")  # key padding
    dot_product_attention(tq_, tk_, tv_, bias=tb_, impl="flash", dropout_rate=0.1,
                          rng=torch.Generator().manual_seed(0))
    dot_product_attention(tq_[:, :1], tk_, tv_, bias=tb_[:, :, :1], impl="flash")  # decode
    assert calls == [tb_.shape]
    assert (flash_attention_biased.launches,
            flash_attention_biased_backward.launches) == launches


def test_wrapper_rejects_what_it_does_not_take():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="broadcast"):
        flash_attention_biased(q, q, q, torch.zeros(1, 3, 4, 4))
    with pytest.raises(ValueError, match="broadcast"):
        flash_attention_biased(q, q, q, torch.zeros(4, 4))
    with pytest.raises(ValueError, match="shape mismatch"):
        flash_attention_biased(q, q[:, :, :1], q, torch.zeros(1, 1, 4, 4))
