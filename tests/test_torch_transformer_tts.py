"""The Transformer TTS baseline of the port (``models/transformer_tts.py``)
against the JAX package's ``TransformerTTS`` at d=64, 4 heads, 2 + 2
layers, B=2, S=8, T=20, with the JAX init bridged into the port
(``utils/bridge.py``):

  - the bridge fills every parameter of the port;
  - the loss and every parameter's gradient at dropout 0, at
    ``attn_impl="xla"`` and at ``"flash"`` (JAX's Pallas kernels in
    interpret mode; the port's kernels 2, 3 and 4 through their plain
    versions): loss rtol 1e-5, gradients atol 2e-5 x the largest |gradient|
    of the tensor (f32, summation order);
  - the port's greedy inference under ``"flash"`` against JAX's under
    ``"xla"``, which needs no interpret mode: mels within 1e-5, lengths
    equal; and with the stop bias lowered so no row stops.  Kernel 4's plain
    version is held against JAX's library kernel call by call in
    ``tests/test_torch_flash_bias.py``;
  - a train-mode forward (prenet, positional and attention dropout) is
    finite, and the training step takes float mels at stage 0 only;
  - the ``scaling_xformers`` variant against JAX's on ``"xla"`` (no
    interpret mode): the bridge fills every parameter, loss rtol 1e-5 and
    gradients atol 2e-5 x max |g| in eval mode at the port's ``"xla"`` and
    ``"flash"``, greedy mels within 1e-5 with lengths equal, and the default
    init scales the self-attention output projections and ``linear2`` by
    0.01.  Its train-mode balancers are held in ``tests/test_torch_layers.py``.

The JAX outputs are computed once, in a module fixture, and only JAX's
``"flash"`` loss and gradients run in interpret mode.  The file has a time
limit (``tests/test_torch_stall_guard.py``): an interpret-mode run that
stalls ends this worker with every thread's stack instead of the run.
"""

import functools
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu.models import TransformerTTS as JaxTTS
from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.optim import ScaledAdam, get_lr_fn
from valle_tpu_torch.train.step import init_train_state, make_train_step
from valle_tpu_torch.utils.bridge import numpy_state_dict_from_jax, state_dict_from_jax
from tests.test_torch_stall_guard import stall_guard

B, S, T, STEPS = 2, 8, 20, 6
KW = dict(model_name="Transformer", decoder_dim=64, nhead=4, num_layers=2)
STOP_BIAS = -3.0  # below every stop logit of these weights: no row stops

_stall_guard = stall_guard(300)  # about 5x the file's time in the parallel tier-1 run


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    rng = np.random.RandomState(0)
    x = rng.randint(1, 512, (B, S)).astype(np.int32)
    y = rng.randn(B, T, 100).astype(np.float32)
    return x, np.array([S, S - 2], np.int32), y, np.array([T, T - 5], np.int32)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX variables, loss and gradients per impl, and inference outputs.
    Only the ``"flash"`` loss and gradients reach Pallas kernels, so only
    they run in TPU interpret mode; the greedy inference loops run on
    ``"xla"``."""
    data = tuple(jnp.asarray(a) for a in _data())
    model = JaxTTS(JaxConfig(**KW))
    variables = jax.tree.map(np.array, model.init({"params": jax.random.PRNGKey(0)}, *data,
                                                  deterministic=True))
    ref = {"variables": variables}
    for impl in ("xla", "flash"):
        m = JaxTTS(JaxConfig(attn_impl=impl, **KW))

        def loss(params, m=m):
            return m.apply({"params": params}, *data, deterministic=True)["loss"]

        interpret = pltpu.force_tpu_interpret_mode() if impl == "flash" else nullcontext()
        with interpret:  # one jitted call: see _stall_guard
            value, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
        ref[impl] = (float(value), jax.tree.map(np.asarray, grads))
    m = JaxTTS(JaxConfig(**KW))
    inf = m.apply(variables, data[0], data[1], max_steps=STEPS, method="inference")
    ref["inference"] = {k: np.asarray(v) for k, v in inf.items()}
    low = jax.tree.map(np.copy, variables)
    low["params"]["stop_layer"]["bias"][:] = STOP_BIAS
    inf = m.apply(low, data[0], data[1], max_steps=STEPS, method="inference")
    ref["inference_no_stop"] = {k: np.asarray(v) for k, v in inf.items()}
    return ref


def _port(variables, **over):
    cfg = ModelConfig(**dict(KW, **over))
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, cfg, "transformer", device="cpu"))
    return model


def test_bridge_fills_every_parameter(jax_ref):
    cfg = ModelConfig(**KW)
    sd = numpy_state_dict_from_jax(jax_ref["variables"], cfg, "transformer")
    model = get_model(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    for name, p in model.state_dict().items():
        np.testing.assert_array_equal(p.numpy(), sd[name], err_msg=name)
    params = jax_ref["variables"]["params"]
    np.testing.assert_array_equal(model.decoder_prenet[3].weight.detach().numpy(),
                                  params["decoder_prenet_fc2"]["kernel"].T)
    ca = params["decoder"]["layers"]["cross_attn"]
    np.testing.assert_array_equal(
        model.decoder.layers[1].multihead_attn.in_proj_weight.detach().numpy()[64:],
        ca["kv_proj"]["kernel"][1].T)
    with pytest.raises(ValueError, match="variant"):  # the variant key alone picks the mapping
        numpy_state_dict_from_jax(jax_ref["variables"], cfg, "tts")


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_loss_and_gradients_match_jax(jax_ref, impl):
    want_loss, want_grads = jax_ref[impl]
    want = numpy_state_dict_from_jax(want_grads, ModelConfig(**KW), "transformer")
    model = _port(jax_ref["variables"], attn_impl=impl)
    out = model(*(torch.from_numpy(a) for a in _data()))
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), want_loss, rtol=1e-5)
    checked = 0
    for name, p in model.named_parameters():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=2e-5 * max(float(np.abs(w).max()), 1e-6), err_msg=name)
        checked += 1
    assert checked == len(want)


def test_greedy_inference_matches_jax(jax_ref):
    x, x_lens, _, _ = _data()
    model = _port(jax_ref["variables"], attn_impl="flash")
    got = model.inference(torch.from_numpy(x), torch.from_numpy(x_lens), max_steps=STEPS)
    want = jax_ref["inference"]
    assert got["mel"].shape == (B, STEPS, 100)
    np.testing.assert_allclose(got["mel"].numpy(), want["mel"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])

    with torch.no_grad():
        model.stop_layer.bias.fill_(STOP_BIAS)
    got = model.inference(torch.from_numpy(x), torch.from_numpy(x_lens), max_steps=STEPS)
    want = jax_ref["inference_no_stop"]
    np.testing.assert_allclose(got["mel"].numpy(), want["mel"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])
    assert got["lengths"].tolist() == [STEPS] * B


def test_train_mode_forward_is_finite_and_draws_from_rng(jax_ref):
    model = _port(jax_ref["variables"], attn_impl="flash", dropout=0.1).train()
    batch = tuple(torch.from_numpy(a) for a in _data())
    with torch.no_grad():
        outs = [model(*batch, rng=torch.Generator().manual_seed(seed)) for seed in (1, 1, 2)]
    assert all(torch.isfinite(o["loss"]) for o in outs)
    assert float(outs[0]["loss"]) == float(outs[1]["loss"]) != float(outs[2]["loss"])
    model.eval()
    assert float(model(*batch)["loss"]) == pytest.approx(jax_ref["xla"][0], rel=1e-5)


def test_train_step_takes_float_mels_at_stage_0_only(jax_ref):
    x, x_lens, y, y_lens = _data()
    batch = {"text_tokens": torch.from_numpy(x)[None], "text_tokens_lens":
             torch.from_numpy(x_lens)[None], "audio_features": torch.from_numpy(y)[None],
             "audio_features_lens": torch.from_numpy(y_lens)[None]}
    make_opt = functools.partial(ScaledAdam, lr=0.05, clipping_scale=2.0)
    state = init_train_state(_port(jax_ref["variables"], attn_impl="flash"), make_opt)
    lr_fn = get_lr_fn("eden", 0.05, warmup_steps=200)
    with pytest.raises(ValueError, match="stage 0"):  # the model refuses the AR/NAR stages
        make_train_step(lr_fn, train_stage=1)(state, batch, torch.Generator().manual_seed(0), 0)
    step = make_train_step(lr_fn)
    before = state.model.stop_layer.weight.detach().clone()
    state, metrics = step(state, batch, torch.Generator().manual_seed(0), 0)
    assert sorted(metrics) == sorted(["loss", "mel_loss", "stop_loss", "frames", "lr"])
    assert all(torch.isfinite(v) for v in metrics.values())
    assert not torch.equal(before, state.model.stop_layer.weight)


SX = dict(KW, scaling_xformers=True)


@pytest.fixture(scope="module")
def jax_scaling_ref():
    """The scaling variant's JAX variables, eval-mode loss and gradients
    (one jitted call) and greedy inference, all on ``"xla"``."""
    data = tuple(jnp.asarray(a) for a in _data())
    model = JaxTTS(JaxConfig(**SX))
    variables = jax.tree.map(np.array, model.init({"params": jax.random.PRNGKey(1)}, *data,
                                                  deterministic=True))
    # move the learnable epsilons off their shared init, so the bridge's
    # mapping of each one shows
    norms = [(variables["params"][s]["layers"]["norm2"], "eps_log") for s in ("encoder",
                                                                             "decoder")]
    norms += [(variables["params"][s]["final_norm"], "eps_log") for s in ("encoder", "decoder")]
    rng = np.random.RandomState(2)
    for tree, key in norms:
        tree[key] = (tree[key] + rng.uniform(-0.5, 0.5, np.shape(tree[key]))).astype(np.float32)

    def loss(params):
        return model.apply({"params": params}, *data, deterministic=True)["loss"]

    value, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    inf = jax.jit(functools.partial(model.apply, max_steps=STEPS, method="inference"))(
        variables, data[0], data[1])
    return {"variables": variables, "loss": float(value),
            "grads": jax.tree.map(np.asarray, grads),
            "inference": {k: np.asarray(v) for k, v in inf.items()}}


def test_scaling_xformers_raises(jax_scaling_ref):
    """No longer raises: the scaling variant builds, the bridge fills every
    parameter, and the default init scales the out-projections by 0.01."""
    cfg = ModelConfig(**SX)
    sd = numpy_state_dict_from_jax(jax_scaling_ref["variables"], cfg, "transformer")
    model = get_model(cfg, device="cpu")
    assert set(sd) == set(model.state_dict())
    assert "decoder_prenet_fc.weight" in sd and "decoder.layers.1.norm3.norm.eps" in sd
    assert not any(k.startswith("decoder_prenet.") for k in sd)
    params = jax_scaling_ref["variables"]["params"]
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    assert float(model.decoder.layers[1].norm3.norm.eps) == float(
        params["decoder"]["layers"]["norm2"]["eps_log"][1])
    assert float(model.encoder.norm.norm.eps) == float(params["encoder"]["final_norm"]["eps_log"])

    torch.manual_seed(0)
    plain = get_model(ModelConfig(**KW), device="cpu")
    torch.manual_seed(0)
    scaled = get_model(cfg, device="cpu")  # the encoder draws its weights in the same order
    for i in range(KW["num_layers"]):
        a, b = plain.encoder.layers[i], scaled.encoder.layers[i]
        for name in ("self_attn.out_proj.weight", "linear2.weight"):
            want = a.get_parameter(name) * 0.01
            assert torch.equal(b.get_parameter(name), want), name
        for name in ("self_attn.in_proj_weight", "linear1.weight", "linear2.bias"):
            assert torch.equal(b.get_parameter(name), a.get_parameter(name)), name
    assert float(scaled.encoder.layers[0].norm2.norm.eps) == pytest.approx(np.log(0.25))


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_scaling_loss_and_gradients_match_jax(jax_scaling_ref, impl):
    want = numpy_state_dict_from_jax(jax_scaling_ref["grads"], ModelConfig(**SX), "transformer")
    model = _port(jax_scaling_ref["variables"], attn_impl=impl, scaling_xformers=True)
    out = model(*(torch.from_numpy(a) for a in _data()))
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), jax_scaling_ref["loss"], rtol=1e-5)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=2e-5 * max(float(np.abs(w).max()), 1e-6), err_msg=name)


def test_scaling_greedy_inference_matches_jax(jax_scaling_ref):
    x, x_lens, _, _ = _data()
    model = _port(jax_scaling_ref["variables"], attn_impl="flash", scaling_xformers=True)
    got = model.inference(torch.from_numpy(x), torch.from_numpy(x_lens), max_steps=STEPS)
    want = jax_scaling_ref["inference"]
    assert got["mel"].shape == (B, STEPS, 100)
    np.testing.assert_allclose(got["mel"].numpy(), want["mel"], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got["lengths"].numpy(), want["lengths"])
