"""Layer remat of the port (``nn/layers.py``: ``--remat full | dots_nobatch``)
on the CPU, through the kernels' plain versions:

  - one VALL-E train step at dropout 0.1 (attention, layer, positional and
    prenet dropout) with an accumulation group of A=2 and one step
    generator, and one TTS baseline step: the loss, every gradient and every
    weight after the update under "full" and "dots_nobatch" are bit-equal to
    "none" (the bar: the same products in the same order, and the recompute
    replays the forward's dropout bits), and the step generator ends in the
    same state; in VALL-E kernel 2's plain version runs twice per layer
    and micro-batch under remat (forward and recompute), once without, and
    kernel 3's once;
  - at dropout 0 the port's remat gradients against JAX's ``remat=True``
    gradients (``tests/test_train_step.py::test_remat_grads_match``), at
    ``tests/test_torch_train.py``'s f32 bars (loss rtol 1e-5, gradients atol
    2e-5 x the tensor's largest |gradient|);
  - what a stack keeps for the backward pass, seen through
    ``torch.autograd.graph.saved_tensors_hooks``: without remat the layers'
    operations save their tensors through the hooks; under "full" only the
    layers' inputs are saved through them (one per layer, the checkpoint's
    record); under "dots_nobatch" the same, and the policy keeps exactly
    the outputs of the four Dense projections per layer (``aten.addmm``:
    in, out, linear1, linear2) and recomputes everything else.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.nn import layers
from valle_tpu_torch.nn.embedding import SinePositionalEmbedding, TokenEmbedding
from valle_tpu_torch.nn.dropout import Dropout
from valle_tpu_torch.ops import fused_attention
from valle_tpu_torch.optim import ScaledAdam, get_lr_fn
from valle_tpu_torch.train.step import init_train_state, make_train_step
from valle_tpu_torch.utils.bridge import numpy_state_dict_from_jax, state_dict_from_jax

POLICIES = ("none", "full", "dots_nobatch")
KW = dict(decoder_dim=32, nhead=4, num_layers=2, num_quantizers=3)
TTS_KW = dict(model_name="Transformer", decoder_dim=32, nhead=4, num_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _valle_batch(a=2, b=3, s=9, t=14, q=3):
    rng = np.random.RandomState(0)
    return {"text_tokens": torch.from_numpy(rng.randint(1, 512, (a, b, s))),
            "text_tokens_lens": torch.tensor([[9, 7, 5]] * a),
            "audio_features": torch.from_numpy(rng.randint(0, 1024, (a, b, t, q))),
            "audio_features_lens": torch.tensor([[14, 11, 8]] * a)}


def _tts_batch():
    rng = np.random.RandomState(1)
    return {"text_tokens": torch.from_numpy(rng.randint(1, 512, (1, 2, 8))),
            "text_tokens_lens": torch.tensor([[8, 6]]),
            "audio_features": torch.from_numpy(rng.randn(1, 2, 12, 100).astype(np.float32)),
            "audio_features_lens": torch.tensor([[12, 9]])}


def _count_attention_calls(monkeypatch):
    calls = {"forward": 0, "backward": 0}
    fwd, bwd = (fused_attention.attention_forward_reference,
                fused_attention.attention_backward_reference)

    def counted(fn, key):
        def run(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(fused_attention, "attention_forward_reference", counted(fwd, "forward"))
    monkeypatch.setattr(fused_attention, "attention_backward_reference",
                        counted(bwd, "backward"))
    return calls


def _step(kw, batch, remat, monkeypatch):
    torch.manual_seed(0)
    cfg = ModelConfig(attn_impl="fused", dropout=0.1, remat=remat, **kw)
    model = get_model(cfg, device="cpu", training=True)
    state = init_train_state(model, functools.partial(ScaledAdam, lr=0.05, clipping_scale=2.0))
    calls = _count_attention_calls(monkeypatch)
    grads = {}
    opt_step = state.optimizer.step

    def keep_grads(**k):  # the summed gradients, just before the update
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        return opt_step(**k)

    state.optimizer.step = keep_grads
    rng = torch.Generator().manual_seed(7)
    step = make_train_step(get_lr_fn("eden", 0.05, warmup_steps=200), train_stage=0)
    _, metrics = step(state, batch, rng, 0)
    return {"loss": metrics["loss"], "grads": grads, "weights": model.state_dict(),
            "rng": rng.get_state(), "calls": dict(calls)}


@pytest.mark.parametrize("variant", ["valle", "transformer"])
def test_remat_is_bit_equal_to_none_with_dropout(variant, monkeypatch):
    kw, batch = (KW, _valle_batch()) if variant == "valle" else (TTS_KW, _tts_batch())
    runs = {r: _step(kw, batch, r, monkeypatch) for r in POLICIES}
    base = runs["none"]
    assert base["grads"] and torch.isfinite(base["loss"])
    # VALL-E: kernel 2's plain version once per layer of both stacks and
    # micro-batch (the baseline's attention with dropout takes the plain math)
    per_pass = 2 * 2 * batch["text_tokens"].shape[0] if variant == "valle" else 0
    assert base["calls"] == {"forward": per_pass, "backward": per_pass}, base["calls"]
    for remat in ("full", "dots_nobatch"):
        run = runs[remat]
        assert torch.equal(run["loss"], base["loss"]), remat
        assert run["grads"].keys() == base["grads"].keys()
        for name, g in base["grads"].items():
            assert torch.equal(run["grads"][name], g), (remat, name)
        for name, w in base["weights"].items():
            assert torch.equal(run["weights"][name], w), (remat, name)
        assert torch.equal(run["rng"], base["rng"]), remat
        assert run["calls"] == {"forward": 2 * per_pass, "backward": per_pass}, \
            (remat, run["calls"])


def test_remat_is_bit_equal_to_none_in_the_scaling_layout(monkeypatch):
    """The scaling_xformers TTS (balancers and DoubleSwish as autograd
    Functions, train mode, dropout 0.1): remat replays them and the step
    generator bit-equal to no remat."""
    kw = dict(TTS_KW, scaling_xformers=True)
    runs = {r: _step(kw, _tts_batch(), r, monkeypatch) for r in POLICIES}
    base = runs["none"]
    assert base["grads"] and torch.isfinite(base["loss"])
    for remat in ("full", "dots_nobatch"):
        run = runs[remat]
        assert torch.equal(run["loss"], base["loss"]), remat
        for name, g in base["grads"].items():
            assert torch.equal(run["grads"][name], g), (remat, name)
        assert torch.equal(run["rng"], base["rng"]), remat


def _no_dropout(model):
    """Train mode (so remat applies) with every dropout at 0, the JAX
    model's ``deterministic=True``."""
    model.train()
    for m in model.modules():
        if isinstance(m, (SinePositionalEmbedding, TokenEmbedding)):
            m.dropout = 0.0
        elif isinstance(m, Dropout):
            m.rate = 0.0
    return model


@pytest.fixture(scope="module")
def jax_remat_grads():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 512, (2, 8)).astype(np.int32)
    y = rng.randint(0, 1024, (2, 16, 3)).astype(np.int32)
    data = (x, np.array([8, 6], np.int32), y, np.array([16, 12], np.int32))
    model = JaxVALLE(JaxConfig(dropout=0.0, remat=True, **KW))
    jdata = tuple(jnp.asarray(d) for d in data)
    params = jax.jit(lambda k: model.init({"params": k, "stage": k}, *jdata, train_stage=0,
                                          deterministic=True, nar_stage=jnp.asarray(2)))(
        jax.random.PRNGKey(0))["params"]

    def loss(p):
        return model.apply({"params": p}, *jdata, train_stage=0, deterministic=True,
                           nar_stage=jnp.asarray(2))["loss"]

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return data, jax.tree.map(np.array, params), float(value), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("remat", ["full", "dots_nobatch"])
def test_remat_gradients_match_jax_remat(jax_remat_grads, remat):
    data, params, want_loss, want_grads = jax_remat_grads
    cfg = ModelConfig(dropout=0.0, remat=remat, attn_impl="fused", **KW)
    model = get_model(cfg, device="cpu", training=True)
    model.load_state_dict(state_dict_from_jax({"params": params}, cfg, device="cpu"))
    _no_dropout(model)
    out = model(*(torch.from_numpy(d) for d in data), train_stage=0, nar_stage=2)
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), want_loss, rtol=1e-5)
    want = numpy_state_dict_from_jax(want_grads, ModelConfig(**KW))
    checked = 0
    for name, p in model.named_parameters():
        if p.grad is None:
            assert not p.requires_grad or not np.any(want[name]), name
            continue
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=2e-5 * max(float(np.abs(w).max()), 1e-6), err_msg=name)
        checked += 1
    assert checked > 20


@pytest.mark.parametrize("remat", POLICIES)
def test_what_a_stack_keeps_for_the_backward(remat, monkeypatch):
    b, t, d, n_layers = 2, 10, 32, 2
    stack = layers.TransformerStack(n_layers, d, 4, 4 * d, final_norm=False, attn_impl="fused",
                                    remat=remat).train()
    kept = []
    policy = layers.dots_nobatch_policy

    def observed(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE:
            kept.append((op, args[1].shape[0], args[2].shape[1]))  # addmm(bias, x, w.T)
        return decision

    monkeypatch.setattr(layers, "dots_nobatch_policy", observed)
    packed = []
    x = torch.randn(b, t, d, requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(lambda v: packed.append(v) or v, lambda v: v):
        out = stack(x, rng=torch.Generator().manual_seed(0))[0]
    out.sum().backward()
    assert torch.isfinite(x.grad).all()
    if remat == "none":
        assert len(packed) > 10 * n_layers, len(packed)
    else:  # the checkpoint's own record of each layer's input, x first
        assert len(packed) == n_layers and packed[0] is x, len(packed)
        assert all(v.shape == (b, t, d) for v in packed)
    if remat == "dots_nobatch":
        one_layer = [(torch.ops.aten.addmm.default, b * t, n)
                     for n in (3 * d, d, 4 * d, d)]
        assert kept == one_layer * n_layers, kept
    else:
        assert kept == []
