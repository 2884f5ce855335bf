"""Head dims past the kernels' whole-row tiles, on the CPU: the plain
versions of kernels 1-4 at the widths the split tiles (kernels 2-4 above Dh
128), the wider lane layouts and head slices (kernel 1 above Dh 256 or 16
head groups) and the zero padding of the wrappers run, against the JAX
package on the same numpy inputs, and the models at 2 heads of Dh 256.

  - Kernels 2 and 3 (``fused_prefix_attention``) through ``run_padded`` at
    Dh 72, 144, 192, 256 and 512 (padded to 128, 256, 256, 256 and 512:
    each route of the backward on the card, whole, the wide passes of Dh
    256 and the split tiles above it) against JAX's Pallas kernel in
    interpret mode at dropout 0 (output 2e-5, gradients 1e-5: f32
    summation order, as tests/test_torch_attention_grad.py), and at dropout
    0.1 against JAX's ``_xla_attention`` with the port's Philox keep mask
    injected for ``jax.random.bernoulli`` (the same bars), in prefix mode
    and in dense cross-attention (Tq != Tk); dense cross-attention at Dh
    192 also against the Pallas kernel at dropout 0.
  - Kernel 4 (``flash_attention_biased``, a causal + padding bias per batch
    row and a soft bias per head) through ``run_padded`` at the same head
    dims against JAX's library flash kernel in interpret mode: output 1e-5,
    gradients (d(bias) too) 1e-5 x the largest |gradient| of the tensor;
    likewise at Dh 256 on the mel-inference bias layout (one (1, 1, T, T)
    bias broadcast over batch and heads, T not a multiple of the wide
    kernel's 64-row tile) and in cross-attention (9 query rows against 21
    keys).
  - Kernel 1's plain version, through the wrapper's zero pad to whole
    16-byte chunks with the true Dh's scale (Dh 8 and 72 in an int8 cache),
    at Dh 8, 72 and 512 and at 64 heads of Dh 64: against JAX's plain
    ``ragged_decode_attention_reference`` within 1e-5 (f32 summation
    order), and against JAX's ``ragged_decode_attention`` in interpret mode
    within 1e-2: the JAX kernel rounds q, K, V and P to bf16 for the TPU's
    matrix unit (2^-9 relative each), which reaches 8.1e-3 on the 192
    outputs of the 64-head case and stays under 5e-3 on the others.
  - VALL-E at d = 512, 2 heads (Dh 256), 2 + 2 layers, bridged from the JAX
    init (``utils/bridge.py``): the forward losses within rtol 1e-5 under
    ``"flash"`` and ``"fused"`` (kernel 2's plain version), and greedy
    ``generate`` with an int8 cache through kernel 1's plain version (codes
    and lengths equal).  The Transformer TTS at the same widths: loss within
    rtol 1e-5 and every gradient within 2e-5 x its largest |gradient| under
    ``"flash"`` (kernels 2-4's plain versions) against JAX's ``"xla"``.

Each JAX call in interpret mode is one ``jax.jit``, and the file has a time
limit (``tests/test_torch_stall_guard.py``).  The CUDA kernels at these head
dims are held to the plain versions on the card by ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu.models import TransformerTTS as JaxTTS
from valle_tpu.nn.attention import quantize_kv as jax_quantize_kv
from valle_tpu.ops.attention_impl import _xla_attention as jax_xla_attention
from valle_tpu.ops.flash_attention import flash_attention_biased as jax_flash
from valle_tpu.ops.fused_attention import fused_prefix_attention as jax_fused
from valle_tpu.ops import masks as jm
from valle_tpu.ops.ragged_decode import ragged_decode_attention as jax_ragged
from valle_tpu.ops.ragged_decode import ragged_decode_attention_reference as jax_ragged_plain
from valle_tpu.sample import generate as jax_generate
from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.ops.flash_attention import (
    flash_attention_backward_reference, flash_attention_forward_reference)
from valle_tpu_torch.ops.fused_attention import (
    attention_backward_reference, attention_forward_reference, kernel_head_dim, run_padded)
from valle_tpu_torch.ops.philox import dropout_keep_mask
from valle_tpu_torch.ops.ragged_decode import (
    padded_head_dim, ragged_decode_attention_reference)
from valle_tpu_torch.sample import generate
from valle_tpu_torch.utils.bridge import numpy_state_dict_from_jax, state_dict_from_jax
from tests.test_torch_stall_guard import stall_guard

HEAD_DIMS = [72, 144, 192, 256, 512]

_stall_guard = stall_guard(300)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- kernels 2-4


def _prefix_case(dh):
    """(q, k, v, dout, (B, T) key bias, prefix_s): text padding in row 1 and
    right-padded audio, so every row sees a visible column."""
    rng = np.random.RandomState(dh)
    b, t, h, s = 2, 24, 2, 7
    q, k, v = ((rng.randn(b, t, h, dh) * 0.5).astype(np.float32) for _ in range(3))
    dout = rng.randn(b, t, h, dh).astype(np.float32)
    pad = np.arange(t)[None, :] >= np.array([t, t - 5])[:, None]
    pad[1, 5:s] = True
    return q, k, v, dout, np.where(pad, -1e9, 0.0).astype(np.float32), s


def _padded_plain_fused(q, k, v, dout, bias, prefix_s, rate=0.0, seed=None):
    """The port's kernels 2 and 3 as the wrapper runs them on the card (the
    head dim zero-padded by ``run_padded``), through their plain versions:
    (out, (dq, dk, dv))."""
    tq_, tk_, tv_, td_, tb_ = (torch.from_numpy(a) for a in (q, k, v, dout, bias))
    out, lse = run_padded(lambda *a, scale: attention_forward_reference(*a, scale=scale),
                          (tq_, tk_, tv_), tb_, prefix_s, rate, seed, n_sliced=1)
    grads = run_padded(
        lambda q_, k_, v_, o_, d_, *a, scale: attention_backward_reference(
            q_, k_, v_, a[0], o_, d_, *a[1:], scale=scale),
        (tq_, tk_, tv_, out, td_), tb_, lse, prefix_s, rate, seed, n_sliced=3)
    return out.numpy(), [g.numpy() for g in grads]


def _check(got_out, got_grads, want_out, want_grads):
    np.testing.assert_allclose(got_out, np.asarray(want_out), atol=2e-5, rtol=0)
    for name, g, w in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_kernels_2_3_match_jax_at_dropout_0(dh):
    q, k, v, dout, bias, s = _prefix_case(dh)
    assert kernel_head_dim(dh) == {72: 128, 144: 256, 192: 256, 256: 256, 512: 512}[dh]

    def f(a, b_, c, d):
        out, vjp = jax.vjp(lambda a, b_, c: jax_fused(a, b_, c, jnp.asarray(bias), prefix_s=s,
                                                      interpret=True), a, b_, c)
        return out, vjp(d)

    want_out, want_grads = jax.jit(f)(*(jnp.asarray(x) for x in (q, k, v, dout)))
    _check(*_padded_plain_fused(q, k, v, dout, bias, s), want_out, want_grads)


def _cross_case(dh, tq):
    """(q, k, v, dout, (B, Tk) key bias, None): ``tq`` query rows against
    the keys of ``_prefix_case``, dense (cross-attention)."""
    q, k, v, dout, bias, _ = _prefix_case(dh)
    return np.ascontiguousarray(q[:, :tq]), k, v, np.ascontiguousarray(dout[:, :tq]), bias, None


def test_kernels_2_3_match_jax_in_dense_cross_attention():
    """9 query rows against the 24 keys of ``_prefix_case`` at Dh 192 (the
    wide kernels' pad to 256), dropout 0, against the Pallas kernel."""
    q, k, v, dout, bias, _ = _cross_case(192, 9)

    def f(a, b_, c, d):
        out, vjp = jax.vjp(lambda a, b_, c: jax_fused(a, b_, c, jnp.asarray(bias), prefix_s=None,
                                                      interpret=True), a, b_, c)
        return out, vjp(d)

    want_out, want_grads = jax.jit(f)(*(jnp.asarray(x) for x in (q, k, v, dout)))
    _check(*_padded_plain_fused(q, k, v, dout, bias, None), want_out, want_grads)


@pytest.mark.parametrize("dh,tq", [(144, None), (192, None), (256, None), (512, None), (256, 9)],
                         ids=["144", "192", "256", "512", "256-cross-tq9"])
def test_kernels_2_3_match_jax_on_the_injected_dropout_mask(dh, tq, monkeypatch):
    """Prefix mode (``tq`` None), or dense cross-attention of ``tq`` rows."""
    q, k, v, dout, bias, s = _prefix_case(dh) if tq is None else _cross_case(dh, tq)
    rate, seed = 0.1, 987654321
    b, tq_, h, _ = q.shape
    t = k.shape[1]
    keep = dropout_keep_mask(seed, b, h, tq_, t, rate).numpy()
    assert 0 < keep.mean() < 1
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.asarray(keep))
    if s is None:
        dense = jnp.asarray(bias)[:, None, None, :]
    else:
        dense = jnp.asarray(np.asarray(jm.AttnMaskSpec(jnp.asarray(bias), s).dense(t)))
    out, vjp = jax.vjp(
        lambda a, b_, c: jax_xla_attention(a, b_, c, dense, rate, jax.random.PRNGKey(0), False),
        *(jnp.asarray(x) for x in (q, k, v)))
    _check(*_padded_plain_fused(q, k, v, dout, bias, s, rate, seed), out, vjp(jnp.asarray(dout)))


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_kernel_4_matches_jax(dh):
    rng = np.random.RandomState(dh + 1)
    b, t, h = 2, 21, 2
    q, k, v, dout = (rng.randn(b, t, h, dh).astype(np.float32) for _ in range(4))
    bias = -np.abs(rng.randn(b, h, t, t)).astype(np.float32) * 2  # soft, per head
    bias += np.where(np.arange(t)[None, :] > np.arange(t)[:, None], -1e9, 0.0)  # causal
    bias[1, :, :, t - 4:] = -1e9  # key padding
    bias[1, :, t - 4:, :] = np.where(np.arange(t)[None, :] > np.arange(t - 4, t)[:, None],
                                     -1e9, bias[1, :, t - 4:, :])
    _check_kernel_4(q, k, v, dout, bias)


@pytest.mark.parametrize("layout", ["mel-inference-broadcast", "cross-tq9"])
def test_kernel_4_matches_jax_at_head_dim_256_on_other_layouts(layout):
    """The mel loop's bias layout: one (1, 1, T, T) bias, row r seeing
    columns <= min(r, step), broadcast over batch and heads (T = 21, not a
    multiple of 64); or 9 query rows against 21 keys with a (B, 1, Tq, Tk)
    bias and key padding in batch row 1.  The visible entries are soft and
    negative: the JAX wrapper clips the bias at 0 where it pads the keys to
    128, which splits the gradient of an entry of exactly 0
    (tests/test_torch_flash_bias.py)."""
    rng = np.random.RandomState(256 + len(layout))
    b, tk, h, dh = 2, 21, 2, 256
    tq = tk if layout == "mel-inference-broadcast" else 9
    q, dout = (rng.randn(b, tq, h, dh).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, tk, h, dh).astype(np.float32) for _ in range(2))
    col = np.arange(tk)[None, :]
    if layout == "mel-inference-broadcast":
        masked = (col > np.arange(tq)[:, None]) | (col > 13)
        soft = -np.abs(rng.randn(tq, tk)) - 0.01
        bias = np.where(masked, -1e9, soft).astype(np.float32)[None, None]
    else:
        bias = -np.abs(rng.randn(b, 1, tq, tk)).astype(np.float32) - 0.01
        bias[1, :, :, tk - 5:] = -1e9
    _check_kernel_4(q, k, v, dout, bias)


def _check_kernel_4(q, k, v, dout, bias):
    """Kernel 4's plain forward and backward (d(bias) too) through
    ``run_padded`` against JAX's library flash kernel in interpret mode."""
    tq_, tk_, tv_, td_, tb_ = (torch.from_numpy(a) for a in (q, k, v, dout, bias))
    out, lse = run_padded(lambda *a, scale: flash_attention_forward_reference(*a, scale=scale),
                          (tq_, tk_, tv_), tb_, n_sliced=1)
    got = run_padded(lambda q_, k_, v_, o_, d_, bias_, lse_, scale:
                     flash_attention_backward_reference(q_, k_, v_, bias_, o_, d_, lse_,
                                                        bias_grad=True, scale=scale),
                     (tq_, tk_, tv_, out, td_), tb_, lse, n_sliced=3)

    def f(q, k, v, bias):
        return jnp.sum(jax_flash(q, k, v, bias) * jnp.asarray(dout))

    jargs = tuple(jnp.asarray(a) for a in (q, k, v, bias))
    with pltpu.force_tpu_interpret_mode():  # one jitted call: see _stall_guard
        jout, jgrads = jax.jit(lambda *a: (jax_flash(*a), jax.grad(f, argnums=(0, 1, 2, 3))(*a)))(
            *jargs)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5, rtol=0)
    for name, g, w in zip(("q", "k", "v", "bias"), got, jgrads):
        w = np.asarray(w)
        if name == "bias":  # summed over the broadcast dimensions, as the wrapper sums it
            g = g.sum_to_size(tb_.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(float(np.abs(w).max()), 1.0),
                                   err_msg=f"d{name}")


# ---------------------------------------------------------------- kernel 1


@pytest.mark.parametrize("cache,h,dh", [("int8", 4, 8), ("int8", 3, 72), ("float32", 2, 512),
                                        ("bfloat16", 2, 512), ("float32", 64, 64)])
def test_kernel_1_matches_jax(cache, h, dh):
    """Through the zero pad of the kernel's shared-memory slot where the
    int8 head is not a whole number of 16-byte chunks; the padded columns of
    the output are exactly zero."""
    rng = np.random.RandomState(dh + h)
    b, cap = 3, 40
    lengths = np.array([0, 40, 17], np.int32)
    q = rng.randn(b, 1, h, dh).astype(np.float32)
    k, v = (rng.randn(b, cap, h, dh).astype(np.float32) for _ in range(2))
    bias = np.where(rng.rand(b, cap) < 0.1, -1e9, 0.0).astype(np.float32)
    ks = vs = None
    if cache == "int8":
        k, ks = (np.array(a) for a in jax_quantize_kv(jnp.asarray(k)))
        v, vs = (np.array(a) for a in jax_quantize_kv(jnp.asarray(v)))
    elif cache == "bfloat16":  # the values a bf16 cache holds
        k, v = (torch.from_numpy(a).to(torch.bfloat16).float().numpy() for a in (k, v))
    jargs = tuple(None if a is None else jnp.asarray(a) for a in (q, k, v, lengths, bias, ks, vs))
    with pltpu.force_tpu_interpret_mode():  # one jitted call: see _stall_guard
        want = np.asarray(jax.jit(lambda *a: jax_ragged(*a, interpret=True))(*jargs))
    plain = np.asarray(jax.jit(jax_ragged_plain)(*jargs))

    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    if cache == "bfloat16":
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    dhp = padded_head_dim(dh, tk.element_size())
    assert dhp == {8: 16, 72: 80}.get(dh, dh) if cache == "int8" else dhp == dh
    pad = lambda x: torch.nn.functional.pad(x, (0, dhp - dh))  # noqa: E731
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    got = ragged_decode_attention_reference(
        pad(torch.from_numpy(q)), pad(tk), pad(tv), torch.from_numpy(lengths),
        torch.from_numpy(bias), *(None if a is None else torch.from_numpy(a) for a in (ks, vs)),
        scale=scale)
    assert torch.all(got[..., dh:] == 0)
    np.testing.assert_allclose(got[..., :dh].numpy(), plain, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[..., :dh].numpy(), want, atol=1e-2, rtol=0)
    assert np.all(got[0].numpy() == 0)  # a slot of length 0


# ------------------------------------------------------------ whole models

B, S, T, P, Q = 2, 6, 10, 4, 2
VALLE_KW = dict(decoder_dim=512, nhead=2, num_layers=2, num_quantizers=Q, kv_cache_dtype="int8")
TTS_KW = dict(model_name="Transformer", decoder_dim=512, nhead=2, num_layers=2)


def _valle_data():
    rng = np.random.RandomState(5)
    x = rng.randint(1, 512, (B, S)).astype(np.int32)
    x_lens = np.array([S, S - 2], np.int32)
    y = rng.randint(0, 1024, (B, T, Q)).astype(np.int32)
    y_lens = np.array([T, T - 3], np.int32)
    prompts = rng.randint(0, 1024, (B, P, Q)).astype(np.int32)
    prompt_lens = np.array([P, P - 1], np.int32)
    return x, x_lens, y, y_lens, prompts, prompt_lens


@pytest.fixture(scope="module")
def valle_pair():
    x, x_lens, y, y_lens, _, _ = _valle_data()
    model = JaxVALLE(JaxConfig(**VALLE_KW))
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda kk: model.init(
        {"params": kk, "stage": kk}, jnp.asarray(x), jnp.asarray(x_lens), jnp.asarray(y),
        jnp.asarray(y_lens), train_stage=0, deterministic=True,
        nar_stage=jnp.asarray(1)))(key)
    return model, jax.tree.map(np.array, variables)


def _port_valle(variables, **over):
    cfg = ModelConfig(**dict(VALLE_KW, **over))
    assert cfg.decoder_dim // cfg.nhead == 256
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, cfg, "valle", device="cpu"))
    return model


@pytest.mark.parametrize("attn_impl", ["flash", "fused"])
def test_valle_forward_at_head_dim_256_matches_jax(valle_pair, attn_impl):
    jmodel, variables = valle_pair
    x, x_lens, y, y_lens, _, _ = _valle_data()
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train_stage=0, deterministic=True,
                                              nar_stage=jnp.asarray(1)))(
        variables, *(jnp.asarray(a) for a in (x, x_lens, y, y_lens)))
    model = _port_valle(variables, attn_impl=attn_impl)
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in (x, x_lens, y, y_lens)), train_stage=0,
                    nar_stage=1)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)


def test_valle_greedy_generate_at_head_dim_256_matches_jax(valle_pair):
    jmodel, variables = valle_pair
    x, x_lens, _, _, prompts, prompt_lens = _valle_data()
    stop_lens = np.array([6, 4], np.int32)
    want = jax_generate(jmodel, variables, jax.random.PRNGKey(1), jnp.asarray(x),
                        jnp.asarray(x_lens), jnp.asarray(prompts), jnp.asarray(prompt_lens),
                        top_k=1, max_new_tokens=6, forbid_eos=True,
                        stop_lens=jnp.asarray(stop_lens))
    model = _port_valle(variables, attn_impl="flash")
    got = generate(model, *(torch.from_numpy(a).long() for a in (x, x_lens, prompts, prompt_lens)),
                   top_k=1, max_new_tokens=6, forbid_eos=True,
                   stop_lens=torch.from_numpy(stop_lens).long(), ragged_decode=True,
                   generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))


def test_tts_loss_and_gradients_at_head_dim_256_match_jax():
    rng = np.random.RandomState(6)
    data = (rng.randint(1, 512, (B, S)).astype(np.int32), np.array([S, S - 2], np.int32),
            rng.randn(B, T, 100).astype(np.float32), np.array([T, T - 3], np.int32))
    jdata = tuple(jnp.asarray(a) for a in data)
    jmodel = JaxTTS(JaxConfig(**TTS_KW))
    variables = jax.tree.map(np.array, jax.jit(lambda kk: jmodel.init(
        {"params": kk}, *jdata, deterministic=True))(jax.random.PRNGKey(0)))

    def loss(params):
        return jmodel.apply({"params": params}, *jdata, deterministic=True)["loss"]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    cfg = ModelConfig(attn_impl="flash", **TTS_KW)
    want = numpy_state_dict_from_jax(jax.tree.map(np.asarray, want_grads), cfg, "transformer")
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, cfg, "transformer", device="cpu"))
    out = model(*(torch.from_numpy(a) for a in data))
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(want_loss), rtol=1e-5)
    checked = 0
    for name, p in model.named_parameters():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=2e-5 * max(float(np.abs(w).max()), 1e-6), err_msg=name)
        checked += 1
    assert checked == len(want)
