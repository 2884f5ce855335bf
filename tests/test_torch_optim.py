"""The port's optimizer, schedules and model averaging against the JAX
package: ScaledAdam (``optim/scaled_adam.py``) against JAX ``scaled_adam``
with ``batched_axis_fn=valle_batched_axis`` on one sequence of gradients of
a small VALL-E (weights and gradients bridged with ``utils/bridge.py``, so
the tied NAR tables take one summed gradient), over 10 steps that cross two
size updates, with the 100-step clipping window and with a 4-step window
that engages the median clipping; the same for a small VALL-F and the
Transformer TTS baseline, whose cross-attention packs JAX's ``q_proj`` and
``kv_proj`` leaves into one ``in_proj_weight`` / ``in_proj_bias`` with a
statistic per block; Eden, Noam and Cosine; and ``update_model_avg``.

Tolerances: parameters rtol 2e-5 / atol 1e-6 after 10 steps (f32 sums in
another order), schedules rtol 1e-6 (JAX computes them in f32, the port in
Python floats), the running average 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import VALLF as JaxVALLF
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu.models import TransformerTTS as JaxTTS
from valle_tpu.optim import cosine_lr as jax_cosine
from valle_tpu.optim import eden_lr as jax_eden
from valle_tpu.optim import get_lr_fn as jax_get_lr_fn
from valle_tpu.optim import noam_lr as jax_noam
from valle_tpu.optim import scaled_adam, valle_batched_axis
from valle_tpu.train.state import update_model_avg as jax_update_model_avg
from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.optim import ScaledAdam, cosine_lr, eden_lr, get_lr_fn, noam_lr
from valle_tpu_torch.train.state import partition_params, update_model_avg
from valle_tpu_torch.utils.bridge import numpy_state_dict_from_jax, state_dict_from_jax

KW = dict(decoder_dim=32, nhead=4, num_layers=2, num_quantizers=3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    model = JaxVALLE(JaxConfig(**KW))
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randint(1, 512, (2, 6)), jnp.int32)
    y = jnp.asarray(rng.randint(0, 1024, (2, 10, 3)), jnp.int32)
    lens = jnp.asarray([6, 4], jnp.int32), jnp.asarray([10, 7], jnp.int32)
    variables = jax.jit(lambda k: model.init(
        {"params": k, "stage": k}, x, lens[0], y, lens[1], train_stage=0, deterministic=True,
        nar_stage=jnp.asarray(1)))(jax.random.PRNGKey(0))
    return jax.tree.map(np.array, variables["params"])


def _jax_init(model_name):
    """numpy params of a small VALL-F or Transformer TTS baseline."""
    cfg = JaxConfig(model_name=model_name, **KW)
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randint(1, 512, (2, 6)), jnp.int32)
    lens = jnp.asarray([6, 4], jnp.int32), jnp.asarray([10, 7], jnp.int32)
    if model_name == "Transformer":
        model, y, kw = JaxTTS(cfg), jnp.asarray(rng.randn(2, 10, 100), jnp.float32), {}
    else:
        model = JaxVALLF(cfg)
        y = jnp.asarray(rng.randint(0, 1024, (2, 10, 3)), jnp.int32)
        kw = dict(train_stage=0, nar_stage=jnp.asarray(1))
    variables = jax.jit(lambda k: model.init({"params": k, "stage": k}, x, lens[0], y, lens[1],
                                             deterministic=True, **kw))(jax.random.PRNGKey(0))
    return jax.tree.map(np.array, variables["params"])


@pytest.mark.parametrize("clip_period", [100, 4])
def test_scaled_adam_matches_jax(jax_params, clip_period):
    _check_scaled_adam(jax_params, ModelConfig(**KW), "valle", clip_period)


@pytest.mark.parametrize("model_name,clip_period", [
    ("VALL-F", 100), ("VALL-F", 4), ("Transformer", 100)])
def test_scaled_adam_keeps_cross_attention_blocks_apart(model_name, clip_period):
    """Rows [0:D] and [D:3D] of each cross-attention in-projection keep their
    own RMS, size statistics and clipping term, as JAX's q_proj / kv_proj."""
    cfg = ModelConfig(model_name=model_name, **KW)
    variant = "transformer" if model_name == "Transformer" else "vallf"
    _check_scaled_adam(_jax_init(model_name), cfg, variant, clip_period)


def _check_scaled_adam(jax_params, cfg, variant, clip_period):
    rng = np.random.RandomState(1)
    grads = [jax.tree.map(lambda p: (rng.randn(*p.shape) * 0.1).astype(np.float32), jax_params)
             for _ in range(10)]
    lrs = [eden_lr(0.05, i, 0) for i in range(10)]

    tx = scaled_adam(learning_rate=0.05, clipping_scale=2.0, betas=(0.9, 0.95),
                     clipping_update_period=clip_period, show_dominant_parameters=False,
                     batched_axis_fn=valle_batched_axis)
    params = jax.tree.map(jnp.asarray, jax_params)
    state = tx.init(params)
    update = jax.jit(lambda g, s, p, lr: tx.update(g, s, p, lr=lr))
    for g, lr in zip(grads, lrs):
        upd, state = update(g, state, params, jnp.float32(lr))
        params = optax.apply_updates(params, upd)

    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax({"params": jax_params}, cfg, variant,
                                              device="cpu"))
    trainable, _ = partition_params(model, 0)
    opt = ScaledAdam(trainable.values(), lr=0.05, clipping_scale=2.0, betas=(0.9, 0.95),
                     clipping_update_period=clip_period)
    for g, lr in zip(grads, lrs):
        bridged = numpy_state_dict_from_jax(g, cfg, variant)
        for name, p in trainable.items():
            p.grad = torch.from_numpy(bridged[name])
        opt.step(lr=lr)

    want = numpy_state_dict_from_jax(jax.tree.map(np.asarray, params), cfg, variant)
    got = model.state_dict()
    assert set(trainable) <= set(want)
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=2e-5, atol=1e-6,
                                   err_msg=name)
    assert len(opt.param_groups[0]["params"]) == len(trainable)
    if variant == "valle":  # tied tables are one tensor, updated once
        assert model.nar_predict_layers[0].weight is model.nar_audio_embeddings[2].weight
    else:  # the packed cross-attention projections keep two blocks
        blocked = [n for n, p in trainable.items() if len(opt.state[p].get("blocks", ())) == 2]
        assert blocked and all(".multihead_attn.in_proj_" in n for n in blocked)


def test_schedules_match_jax():
    for step in (0, 1, 100, 199, 200, 501, 5000, 20000):
        for epoch in (0, 1, 7):
            np.testing.assert_allclose(eden_lr(0.05, step, epoch),
                                       float(jax_eden(0.05, step, epoch)), rtol=1e-6)
        np.testing.assert_allclose(noam_lr(0.05, step, 1024, 200.0),
                                   float(jax_noam(0.05, step, 1024, 200.0)), rtol=1e-6)
        np.testing.assert_allclose(cosine_lr(0.05, step, 10000),
                                   float(jax_cosine(0.05, step, 10000)), rtol=1e-6, atol=1e-9)
        for name in ("eden", "noam", "cosine"):
            np.testing.assert_allclose(
                get_lr_fn(name, 0.05, warmup_steps=300)(step, 2),
                float(jax_get_lr_fn(name, 0.05, warmup_steps=300)(step, 2)), rtol=1e-6,
                atol=1e-9)
    with pytest.raises(NotImplementedError):
        get_lr_fn("step", 0.05)


def test_update_model_avg_matches_jax():
    rng = np.random.RandomState(2)
    avg = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    want = dict(avg)
    got = {k: torch.from_numpy(v.copy()) for k, v in avg.items()}
    for step in range(1, 6):
        params = {k: rng.randn(*v.shape).astype(np.float32) for k, v in avg.items()}
        want = jax_update_model_avg(want, params, jnp.asarray(step), 2)
        update_model_avg(got, {k: torch.from_numpy(v) for k, v in params.items()}, step, 2)
        for k in avg:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-7)


def _gate_mix(jax_params, rng):
    """The params rescaled so that Eve's decay gate falls on both sides of
    target_rms 0.1: every leaf (every layer slice of a stacked one) gets an
    RMS of 0.03 or 0.3 at random."""
    def one(p):
        if p.size == 1:
            return p
        out = p.astype(np.float64)
        slices = out if p.ndim > 2 else out[None]
        for s in slices:
            rms = np.sqrt(np.mean(s**2)) or 1.0
            s *= rng.choice([0.03, 0.3]) / rms
        return out.astype(np.float32)

    return jax.tree.map(one, jax_params)


@pytest.mark.parametrize("name,model_name", [
    ("Eve", "VALL-E"), ("Eve", "VALL-F"), ("Adam", "VALL-E"), ("AdamW", "VALL-E")])
def test_cli_optimizers_match_jax(jax_params, name, model_name):
    """Three steps of the optimizer that each CLI's ``make_optimizer``
    builds, on one sequence of gradients, with a learning rate that changes
    every step: Eve follows it, Adam and AdamW keep ``--base-lr`` as the
    JAX CLI's wrapper does.  Tolerance: rtol 1e-5 / atol 1e-7 (f32 sums in
    another order)."""
    from valle_tpu.bin.train import make_optimizer as jax_make_optimizer
    from valle_tpu_torch.bin.train import make_optimizer

    variant = "vallf" if model_name == "VALL-F" else "valle"
    cfg = ModelConfig(model_name=model_name, **KW)
    rng = np.random.RandomState(3)
    start = _gate_mix(jax_params if variant == "valle" else _jax_init(model_name), rng)
    grads = [jax.tree.map(lambda p: (rng.randn(*p.shape) * 0.1).astype(np.float32), start)
             for _ in range(3)]
    lrs = [0.05, 0.02, 0.01]
    args = type("Args", (), {"optimizer_name": name, "base_lr": 0.004})

    tx, jax_clip = jax_make_optimizer(args)
    params = jax.tree.map(jnp.asarray, start)
    state = tx.init(params)
    update = jax.jit(lambda g, s, p, lr: tx.update(g, s, p, lr=lr))
    for g, lr in zip(grads, lrs):
        upd, state = update(g, state, params, jnp.float32(lr))
        params = optax.apply_updates(params, upd)

    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax({"params": start}, cfg, variant, device="cpu"))
    trainable, _ = partition_params(model, 0)
    make_opt, clip = make_optimizer(args)
    assert clip == jax_clip
    opt = make_opt(list(trainable.values()))
    for g, lr in zip(grads, lrs):
        bridged = numpy_state_dict_from_jax(g, cfg, variant)
        for n, p in trainable.items():
            p.grad = torch.from_numpy(bridged[n])
        opt.step(lr=lr)

    want = numpy_state_dict_from_jax(jax.tree.map(np.asarray, params), cfg, variant)
    before = numpy_state_dict_from_jax(start, cfg, variant)
    got = model.state_dict()
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n], rtol=1e-5, atol=1e-7, err_msg=n)
    if name == "Eve":  # the gate decayed some tensors and spared others
        decayed = {n for n, p in trainable.items() if p.numel() > 1
                   and np.linalg.norm(before[n]) > 0.1 * np.sqrt(before[n].size)}
        assert 0 < len(decayed) < len(trainable)
