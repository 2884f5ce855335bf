"""The training path of the port (``train/``, the model's dropout and draws)
against the JAX package, with the JAX init bridged into the port:

  - the loss and every parameter's gradient at dropout 0 against
    ``jax.value_and_grad`` of ``model.apply(..., deterministic=True)`` for
    train stages 0, 1, 2 and prefix modes 0, 1 (the port through its "fused"
    route, i.e. the autograd Function of kernels 2 / 3; the tied NAR tables
    compare as one summed gradient).  Tolerance: loss rtol 1e-5; gradients
    atol 2e-5 x the largest |gradient| of the tensor (f32, summation order);
  - a 6-step ``train_stage=1`` trajectory with accumulation 2 against JAX
    ``make_train_step(..., deterministic=True)`` with ScaledAdam and Eden,
    plain and with the grad-norm clip and model averaging on: per-step
    losses rtol 1e-4, final parameters and averaged model rtol 1e-4 /
    atol 2e-5;
  - stage filtering, the refusal of bf16 parameters (the bf16 training
    build holds f32 ones), and dropout only in train mode.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu.optim import eden_lr as jax_eden
from valle_tpu.optim import scaled_adam, valle_batched_axis
from valle_tpu.train.step import init_train_state as jax_init_train_state
from valle_tpu.train.step import make_train_step as jax_make_train_step
from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.optim import ScaledAdam, eden_lr
from valle_tpu_torch.train.state import partition_params
from valle_tpu_torch.train.step import init_train_state, make_eval_step, make_train_step
from valle_tpu_torch.utils.bridge import numpy_state_dict_from_jax, state_dict_from_jax

B, S, T, Q = 3, 7, 12, 3
KW = dict(decoder_dim=32, nhead=4, num_layers=2, num_quantizers=Q)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=0, a=None):
    rng = np.random.RandomState(seed)
    lead = () if a is None else (a,)
    x = rng.randint(1, 512, lead + (B, S)).astype(np.int32)
    x_lens = np.broadcast_to(np.array([7, 5, 3], np.int32), lead + (B,)).copy()
    y = rng.randint(0, 1024, lead + (B, T, Q)).astype(np.int32)
    y_lens = np.broadcast_to(np.array([12, 9, 6], np.int32), lead + (B,)).copy()
    return x, x_lens, y, y_lens


@pytest.fixture(scope="module")
def variables():
    model = JaxVALLE(JaxConfig(**KW))
    x, x_lens, y, y_lens = (jnp.asarray(a) for a in _data())
    v = jax.jit(lambda k: model.init({"params": k, "stage": k}, x, x_lens, y, y_lens,
                                     train_stage=0, deterministic=True,
                                     nar_stage=jnp.asarray(1)))(jax.random.PRNGKey(0))
    return jax.tree.map(np.array, v)


def _port(variables, **over):
    cfg = ModelConfig(**dict(KW, **over))
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, cfg, device="cpu"))
    return model


@pytest.mark.parametrize("mode,train_stage,nar_stage,prefix_len", [
    (0, 0, 2, None), (0, 1, None, None), (0, 2, 1, None), (1, 0, 1, 3)])
def test_loss_and_gradients_match_jax(variables, mode, train_stage, nar_stage, prefix_len):
    x, x_lens, y, y_lens = _data()
    jmodel = JaxVALLE(JaxConfig(prefix_mode=mode, **KW))
    kw = {}
    if nar_stage is not None:
        kw["nar_stage"] = jnp.asarray(nar_stage)
    if prefix_len is not None:
        kw["prefix_len"] = jnp.asarray(prefix_len)

    def loss(params):
        return jmodel.apply({"params": params}, *(jnp.asarray(a) for a in (x, x_lens, y, y_lens)),
                            train_stage=train_stage, deterministic=True, **kw)["loss"]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
    want = numpy_state_dict_from_jax(jax.tree.map(np.asarray, want_grads), ModelConfig(**KW))

    model = _port(variables, prefix_mode=mode, attn_impl="fused")
    out = model(*(torch.from_numpy(a) for a in (x, x_lens, y, y_lens)), train_stage=train_stage,
                nar_stage=nar_stage, prefix_len=prefix_len)
    out["loss"].backward()
    np.testing.assert_allclose(float(out["loss"].detach()), float(want_loss), rtol=1e-5)
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


def _jax_batch(a=2):
    x, x_lens, y, y_lens = _data(seed=5, a=a)
    return {"text_tokens": x, "text_tokens_lens": x_lens, "audio_features": y,
            "audio_features_lens": y_lens}


@pytest.mark.parametrize("clip_grad_norm,average_period", [(None, 0), (1.0, 2)],
                         ids=["plain", "clip_and_average"])
def test_train_step_trajectory_matches_jax(clip_grad_norm, average_period):
    jmodel = JaxVALLE(JaxConfig(**KW))
    tx = scaled_adam(learning_rate=0.05, clipping_scale=2.0, betas=(0.9, 0.95),
                     show_dominant_parameters=False, batched_axis_fn=valle_batched_axis)
    batch = _jax_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with_avg = average_period > 0
    state = jax_init_train_state(jmodel, tx, jax.random.PRNGKey(0),
                                 jax.tree.map(lambda v: v[0], jbatch), train_stage=1,
                                 with_model_avg=with_avg)
    model = _port({"params": jax.tree.map(np.asarray, state.params)})
    jstep = jax_make_train_step(jmodel, tx, lambda s, e: jax_eden(0.05, s, e), train_stage=1,
                                clip_grad_norm=clip_grad_norm, average_period=average_period,
                                deterministic=True)
    want = []
    for _ in range(6):
        state, metrics = jstep(state, jbatch, jax.random.PRNGKey(1), jnp.zeros((), jnp.int32))
        want.append(float(metrics["loss"]))

    pstate = init_train_state(model, functools.partial(ScaledAdam, lr=0.05, clipping_scale=2.0,
                                                       betas=(0.9, 0.95)), train_stage=1,
                              with_model_avg=with_avg)
    step = make_train_step(lambda s, e: eden_lr(0.05, s, e), train_stage=1,
                           clip_grad_norm=clip_grad_norm, average_period=average_period,
                           deterministic=True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = []
    for _ in range(6):
        pstate, metrics = step(pstate, tbatch, torch.Generator().manual_seed(1), 0)
        got.append(float(metrics["loss"]))
    assert pstate.step == 6 and set(metrics) == {"loss", "ar_loss", "ArTop10Accuracy", "frames",
                                                 "lr"}
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    final = numpy_state_dict_from_jax(jax.tree.map(np.asarray, state.params), ModelConfig(**KW))
    for name, t in model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), final[name], rtol=1e-4, atol=2e-5, err_msg=name)
    assert (pstate.model_avg is None) == (state.model_avg is None)
    if with_avg:
        avg = numpy_state_dict_from_jax(jax.tree.map(np.asarray, state.model_avg),
                                        ModelConfig(**KW))
        params, trained = model.state_dict(), partition_params(model, 1)[0]
        assert len(trained) > 20  # the average lags every trained parameter
        assert all(not torch.equal(pstate.model_avg[n], params[n]) for n in trained)
        for name, t in pstate.model_avg.items():
            np.testing.assert_allclose(t.numpy(), avg[name], rtol=1e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("train_stage,trained", [(1, "ar_"), (2, "nar_")])
def test_stage_filtering_freezes_the_other_decoder(variables, train_stage, trained):
    model = _port(variables, attn_impl="fused")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = init_train_state(model, functools.partial(ScaledAdam, lr=0.05),
                             train_stage=train_stage)
    assert model.training
    batch = {k: torch.from_numpy(v) for k, v in _jax_batch(a=1).items()}
    step = make_train_step(lambda s, e: 0.05, train_stage=train_stage)
    state, _ = step(state, batch, torch.Generator().manual_seed(3), 0)
    trainable, frozen = partition_params(model, train_stage)
    assert trainable and frozen
    assert all(n.startswith(trained) for n in trainable)
    opt_state = state.optimizer.state
    for name, p in frozen.items():
        assert torch.equal(p, before[name]), name
        assert not p.requires_grad and p.grad is None and p not in opt_state, name
    changed = {n for n, p in trainable.items() if not torch.equal(p, before[n])}
    # one step trains the drawn NAR stage only: the other stage's tables get
    # no gradient, but every decoder parameter moves
    assert {n for n in trainable if "_decoder." in n} <= changed
    assert all(p in opt_state for p in trainable.values())


def test_bf16_training_raises():
    """bf16 parameters (the inference build) are refused; the training build
    of a bf16 config holds f32 parameters and is taken."""
    model = get_model(ModelConfig(dtype="bfloat16", **KW), device="cpu")
    with pytest.raises(ValueError, match="bf16"):
        init_train_state(model, ScaledAdam)
    model = get_model(ModelConfig(dtype="bfloat16", **KW), device="cpu", training=True)
    state = init_train_state(model, ScaledAdam)
    assert state.model.training and all(p.dtype == torch.float32 for p in model.parameters())


def test_dropout_only_in_train_mode_and_reproducible(variables):
    model = _port(variables, attn_impl="fused")
    no_drop = _port(variables, attn_impl="fused", dropout=0.0)
    args = [torch.from_numpy(a) for a in _data()]

    def loss(m, seed, **kw):
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return float(m(*args, train_stage=0, rng=gen, **kw)["loss"])

    assert not model.training  # get_model serves inference
    base = loss(model, 0, nar_stage=2)
    assert base == loss(model, 1, nar_stage=2) == loss(no_drop, 2, nar_stage=2)
    with torch.no_grad():
        assert float(model(*args, train_stage=0, nar_stage=2)["loss"]) == base
    model.train()
    assert loss(model, 0, nar_stage=2) == loss(model, 0, nar_stage=2) != base
    assert loss(model, 0, nar_stage=2) != loss(model, 1, nar_stage=2)
    loss(model, 0)  # the NAR stage is drawn from the generator
    with pytest.raises(ValueError, match="nar_stage"):
        model(*args, train_stage=0)

    eval_step = make_eval_step(train_stage=0)
    micro = dict(zip(("text_tokens", "text_tokens_lens", "audio_features",
                      "audio_features_lens"), args))
    out = eval_step(model, micro, torch.Generator().manual_seed(0))
    assert model.training and float(out["loss"]) > 0
    model.eval()
    assert float(out["loss"]) == loss(model, 0)


def test_parameters_without_gradient_move_as_in_jax(variables):
    """Two NAR-only steps that draw different NAR stages: the tables the
    second step does not reach take a zero gradient, so ScaledAdam's
    momentum still moves them and their moments decay, as JAX's update of
    every trainable leaf does (the port's step skipped them before)."""
    from valle_tpu.train.state import merge_params
    from valle_tpu.train.state import partition_params as jax_partition

    seeds = [s for s in range(20)
             if int(torch.randint(1, Q, (), generator=torch.Generator().manual_seed(s))) == 1]
    seeds = [seeds[0], next(s for s in range(20) if s not in seeds)]  # stages 1, then 2
    batch = _jax_batch(a=1)
    model = _port(variables, attn_impl="fused")
    stages = []
    forward_nar = model._forward_nar
    model._forward_nar = lambda *a, **kw: (stages.append(a[6]), forward_nar(*a, **kw))[1]
    state = init_train_state(model, functools.partial(ScaledAdam, lr=0.05, clipping_scale=2.0,
                                                      betas=(0.9, 0.95)), train_stage=2)
    step = make_train_step(lambda s, e: eden_lr(0.05, s, e), train_stage=2, deterministic=True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for s in seeds:
        state, _ = step(state, tbatch, torch.Generator().manual_seed(s), 0)
    assert stages == [1, 2]

    jmodel = JaxVALLE(JaxConfig(**KW))
    tx = scaled_adam(learning_rate=0.05, clipping_scale=2.0, betas=(0.9, 0.95),
                     show_dominant_parameters=False, batched_axis_fn=valle_batched_axis)
    train_p, frozen = jax_partition(jax.tree.map(jnp.asarray, variables["params"]), 2)
    opt_state = tx.init(train_p)
    micro = [jnp.asarray(batch[k][0]) for k in ("text_tokens", "text_tokens_lens",
                                                 "audio_features", "audio_features_lens")]
    grad_fn = jax.jit(jax.grad(lambda tp, stage: jmodel.apply(
        {"params": merge_params(tp, frozen)}, *micro, train_stage=2, deterministic=True,
        nar_stage=stage)["loss"]))
    update = jax.jit(lambda g, s, p, lr: tx.update(g, s, p, lr=lr))
    for i, stage in enumerate(stages):
        grads = grad_fn(train_p, jnp.asarray(stage))
        upd, opt_state = update(grads, opt_state, train_p, jnp.float32(eden_lr(0.05, i, 0)))
        train_p = jax.tree.map(jnp.add, train_p, upd)
    want = numpy_state_dict_from_jax(jax.tree.map(np.asarray, merge_params(train_p, frozen)),
                                     ModelConfig(**KW))
    got = model.state_dict()
    # the stage-1 table that step 2 does not reach moved in step 2 all the same
    assert "nar_stage_embeddings.0.word_embeddings.weight" in want
    for name in got:
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-4, atol=2e-5,
                                   err_msg=name)
