"""int8 weights (W8 / W8A8) of the port (``valle_tpu_torch/nn/qdense.py``)
against the JAX package's (``valle_tpu/nn/qdense.py``) on the CPU.

  - the int8 values and f32 scales of ``_quantize_kernel`` are bit-equal to
    JAX's, on the transposed (out, in) layout;
  - a quantized ``Dense`` on JAX's int8 weights: W8 within 1e-6 of JAX's
    output over its largest value (f32 sums in another order), W8A8 with the
    int8 activations and the int32 sums bit-equal and the output within
    1e-6 likewise;
  - the error bars of ``tests/test_quantize.py`` against the float layer
    (0.01 W8, 0.02 W8A8);
  - the whole model: ``quantize_variables`` on the port's model gives the
    int8 weights and scales of JAX's ``quantize_variables`` bridged
    (``utils/bridge.py``), for VALL-E and VALL-F (whose cross-attention has
    q_proj / kv_proj), also under ``scopes``; the forward losses on those
    weights within rtol 1e-5 (W8) and 1e-4 (W8A8: a rounding of an
    activation may land on the other int8 value);
  - ``act_quant=True`` on float weights changes nothing;
  - the padding of the card's int8 product (``torch._int_mm`` needs more than
    16 rows and K, N multiples of 8), driven on the CPU through the
    wrapper's shape logic with a stand-in product that enforces those rules.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import VALLF as JaxVALLF
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu.nn import qdense as jq
from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.nn import qdense
from valle_tpu_torch.utils.bridge import numpy_state_dict_from_jax

B, S, T, Q = 2, 12, 20, 4
KW = dict(decoder_dim=64, nhead=4, num_layers=2, num_quantizers=Q)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed, shape):
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 0.1
    w[..., 3] = 0.0  # an all-zero output column: the 1e-8 floor of the scale
    return w


@pytest.mark.parametrize("shape", [(33, 17), (2, 64, 192), (64, 1025)])
def test_quantize_kernel_bit_equal_to_jax(shape):
    kernel = _weights(0, shape)  # JAX layout (..., In, Out)
    want_q, want_s = jax.jit(jq._quantize_kernel)(jnp.asarray(kernel))
    got_q, got_s = qdense._quantize_kernel(torch.from_numpy(np.swapaxes(kernel, -1, -2)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(np.swapaxes(got_q.numpy(), -1, -2), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def _jax_dense(act_quant, kernel, bias, x):
    layer = jq.Dense(kernel.shape[1], dtype=jnp.float32, act_quant=act_quant)
    q, scale = jq._quantize_kernel(jnp.asarray(kernel))
    v = {"params": {"kernel": q, "bias": jnp.asarray(bias)}, "qscale": {"kernel": scale}}
    return np.asarray(jax.jit(layer.apply)(v, jnp.asarray(x))), np.asarray(q), np.asarray(scale)


def _port_dense(act_quant, q, scale, bias):
    layer = qdense.Dense(q.shape[0], q.shape[1], act_quant=act_quant, dtype=torch.float32)
    layer.load_state_dict({"weight": torch.from_numpy(q.T.copy()), "bias": torch.from_numpy(bias),
                           "weight_scale": torch.from_numpy(scale)})
    return layer


@pytest.mark.parametrize("act_quant", [False, True], ids=["w8", "w8a8"])
def test_dense_matches_jax_on_its_int8_weights(act_quant):
    rng = np.random.RandomState(1)
    x = rng.randn(4, 7, 128).astype(np.float32)
    kernel, bias = _weights(2, (128, 96)), rng.randn(96).astype(np.float32)
    want, q, scale = _jax_dense(act_quant, kernel, bias, x)
    layer = _port_dense(act_quant, q, scale, bias)
    assert layer.weight.dtype == torch.int8 and not layer.weight.requires_grad
    got = layer(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    if act_quant:  # the int8 activations and the int32 sums themselves
        xf = x.reshape(-1, 128)
        xs = np.maximum(np.abs(xf).max(-1, keepdims=True), np.float32(1e-8)) / np.float32(127)
        x8 = np.clip(np.round(xf / xs), -127, 127).astype(np.int8)
        want_sums = np.asarray(jax.lax.dot_general(
            jnp.asarray(x8), jnp.asarray(q), (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32))
        got_sums = qdense.int8_matmul(torch.from_numpy(x8), layer.weight)
        assert got_sums.dtype == torch.int32
        np.testing.assert_array_equal(got_sums.numpy(), want_sums)


@pytest.mark.parametrize("act_quant,bar", [(False, 0.01), (True, 0.02)], ids=["w8", "w8a8"])
def test_dense_error_bars_against_the_float_layer(act_quant, bar):
    """JAX's bars (tests/test_quantize.py): x (64, 128) -> 96 outputs."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(64, 128, generator=g)
    layer = qdense.Dense(128, 96, act_quant=act_quant)
    exact = layer(x).detach()
    qdense.quantize_weight_(layer, "weight")
    approx = layer(x).detach()
    assert float((approx - exact).abs().max() / exact.abs().max()) < bar


def test_act_quant_on_float_weights_changes_nothing():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(5, 32, generator=g)
    plain = qdense.Dense(32, 24)
    flagged = qdense.Dense(32, 24, act_quant=True)
    flagged.load_state_dict(plain.state_dict())
    torch.testing.assert_close(flagged(x), plain(x), rtol=0, atol=0)


def test_model_act_quant_flag_on_float_weights_changes_nothing():
    """As tests/test_quantize.py::test_train_path_unaffected_by_act_quant_flag."""
    x, x_lens, y, y_lens = _data()
    losses = []
    for act_quant in (False, True):
        torch.manual_seed(0)
        model = get_model(ModelConfig(act_quant=act_quant, **KW), device="cpu")
        with torch.inference_mode():
            losses.append(float(model(x, x_lens, y, y_lens, train_stage=0, nar_stage=2)["loss"]))
    assert losses[0] == losses[1]


def _data():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(1, 512, (B, S)))
    y = torch.from_numpy(rng.randint(0, 1024, (B, T, Q)))
    return x, torch.tensor([S, 9]), y, torch.tensor([T, 15])


@pytest.fixture(scope="module", params=["valle", "vallf"])
def jax_pair(request):
    variant = request.param
    kw = dict(KW, model_name="VALL-F" if variant == "vallf" else "VALL-E")
    model = (JaxVALLF if variant == "vallf" else JaxVALLE)(JaxConfig(**kw))
    x, x_lens, y, y_lens = (jnp.asarray(a.numpy()) for a in _data())
    variables = jax.jit(lambda k: model.init(
        {"params": k, "stage": k}, x, x_lens, y, y_lens, train_stage=0, deterministic=True,
        nar_stage=jnp.asarray(2)))(jax.random.PRNGKey(0))
    return variant, kw, jax.tree.map(np.asarray, variables)


def _quantized_keys(sd):
    return sorted(k[: -len("_scale")] for k in sd if k.endswith("_scale"))


@pytest.mark.parametrize("scopes", [None, ("nar_decoder",)], ids=["all", "nar_scope"])
def test_quantize_variables_matches_jax(jax_pair, scopes):
    variant, kw, variables = jax_pair
    cfg = ModelConfig(**kw)
    want = numpy_state_dict_from_jax(
        jax.tree.map(np.asarray, jax.jit(lambda v: jq.quantize_variables(v, scopes=scopes))(
            variables)), cfg, variant)
    f32 = {k: torch.from_numpy(v) for k, v in numpy_state_dict_from_jax(
        variables, cfg, variant).items()}
    model = get_model(cfg, device="cpu", state_dict=f32)
    qdense.quantize_variables(model, scopes=scopes)
    got = model.state_dict()
    assert set(got) == set(want)
    quantized = _quantized_keys(want)
    assert quantized == _quantized_keys(got) and quantized
    if scopes is None:
        assert "ar_predict_layer.weight" in quantized
        if variant == "vallf":
            assert "ar_decoder.layers.0.multihead_attn.in_proj_weight" in quantized
    else:
        assert all(k.startswith("nar_decoder.") for k in quantized)
    for key in quantized:
        assert got[key].dtype == torch.int8
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
        np.testing.assert_array_equal(got[key + "_scale"].numpy(), want[key + "_scale"],
                                      err_msg=key)


@pytest.mark.parametrize("act_quant,rtol", [(False, 1e-5), (True, 1e-4)], ids=["w8", "w8a8"])
def test_quantized_model_forward_matches_jax(jax_pair, act_quant, rtol):
    """JAX's quantized variables through the bridge: the forward losses and
    metrics (train stage 0, NAR stage 2) on the same int8 weights."""
    variant, kw, variables = jax_pair
    qv = jax.tree.map(np.asarray, jax.jit(jq.quantize_variables)(variables))
    jcfg = JaxConfig(act_quant=act_quant, **kw)
    jmodel = (JaxVALLF if variant == "vallf" else JaxVALLE)(jcfg)
    x, x_lens, y, y_lens = _data()
    want = jax.jit(lambda v, *a: jmodel.apply(v, *a, train_stage=0, deterministic=True,
                                              nar_stage=jnp.asarray(2)))(
        qv, *(jnp.asarray(a.numpy()) for a in (x, x_lens, y, y_lens)))
    cfg = ModelConfig(act_quant=act_quant, **kw)
    sd = {k: torch.from_numpy(v) for k, v in numpy_state_dict_from_jax(qv, cfg, variant).items()}
    model = get_model(cfg, device="cpu", state_dict=sd)
    assert model.ar_decoder.layers[0].linear1.weight.dtype == torch.int8
    with torch.inference_mode():
        got = model(x, x_lens, y, y_lens, train_stage=0, nar_stage=2)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=rtol, err_msg=key)


def test_scales_stay_f32_through_casts():
    """Quantized from f32 before the bf16 cast, the scales stay f32 through
    ``get_model``'s cast and a later ``Module.to(dtype)``; int8 stays int8."""
    torch.manual_seed(0)
    model = get_model(ModelConfig(dtype="bfloat16", **KW), device="cpu", quantize=True)
    lin = model.ar_decoder.layers[1].linear2
    assert lin.weight.dtype == torch.int8 and lin.weight_scale.dtype == torch.float32
    assert lin.bias.dtype == torch.bfloat16
    attn = model.nar_decoder.layers[0].self_attn
    assert attn.in_proj_weight.dtype == torch.int8
    model.to(torch.float16)
    assert lin.weight_scale.dtype == attn.in_proj_weight_scale.dtype == torch.float32
    assert lin.weight.dtype == torch.int8
    with pytest.raises(ValueError, match="no ar_predict_layer.weight_scale"):
        model.load_state_dict({k: v for k, v in model.state_dict().items()
                               if k != "ar_predict_layer.weight_scale"})


@pytest.mark.parametrize("m,k,n", [(8, 1024, 1025), (1, 64, 192), (300, 4096, 1024),
                                   (17, 20, 9)])
def test_int_mm_padding_meets_the_cards_shape_rules(m, k, n):
    """The wrapper's padding around ``torch._int_mm``: at the decode (M=8,
    and M=1), prefill and 1,025-output shapes, a stand-in with the card's
    shape rules gives the plain product's sums."""
    calls = []

    def card_rules_int_mm(a, b):
        assert a.dtype == b.dtype == torch.int8
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and b.shape[1] % 8 == 0
        assert a.shape[1] == b.shape[0]
        calls.append((tuple(a.shape), tuple(b.shape)))
        return qdense.int_mm_reference(a, b)

    g = torch.Generator().manual_seed(3)
    a8 = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    got = qdense._padded_int_mm(a8, w8, card_rules_int_mm)
    want = a8.long() @ w8.long().t()
    assert got.shape == (m, n) and got.dtype == torch.int32 and len(calls) == 1
    torch.testing.assert_close(got.long(), want, rtol=0, atol=0)
    assert qdense.int8_matmul(a8, w8).dtype == torch.int32  # the CPU route: no launch
    assert qdense.int8_matmul.launches == 0
