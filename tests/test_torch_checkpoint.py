"""The port's checkpoints (``train/checkpoint.py``): save -> restore round
trips of the weights, the averaged model, the whole optimizer state
(ScaledAdam's clipping window under ``"global"``, its per-parameter
``blocks``; Eve; AdamW) and the meta; keep-last-k pruning that spares the
checkpoints a best marker names; ``latest()`` / ``best()``; the train-stage
switch; and a ``.pt`` the port writes, loaded through the JAX CLI's
``load_model_params``, with and without the averaged model."""

import functools

import jax
import numpy as np
import pytest
import torch

from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu_torch.bin.train import make_optimizer, step_generator
from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.optim import get_lr_fn
from valle_tpu_torch.train.checkpoint import CheckpointManager
from valle_tpu_torch.train.state import partition_params
from valle_tpu_torch.train.step import init_train_state, make_train_step
from valle_tpu_torch.utils.bridge import numpy_state_dict_from_jax

KW = dict(decoder_dim=32, nhead=4, num_layers=2, num_quantizers=3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    arrays = {"text_tokens": rng.randint(1, 512, (2, 3, 7)),
              "text_tokens_lens": np.array([[7, 5, 3]] * 2),
              "audio_features": rng.randint(0, 1024, (2, 3, 12, 3)),
              "audio_features_lens": np.array([[12, 9, 6]] * 2)}
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _state(optimizer="ScaledAdam", train_stage=0, seed=0, steps=2, clip_period=None):
    torch.manual_seed(seed)
    model = get_model(ModelConfig(**KW), device="cpu")
    args = type("Args", (), {"optimizer_name": optimizer, "base_lr": 0.05})
    make_opt, clip = make_optimizer(args)
    if clip_period:
        make_opt = functools.partial(make_opt, clipping_update_period=clip_period)
    state = init_train_state(model, make_opt, train_stage=train_stage, with_model_avg=True)
    step = make_train_step(get_lr_fn("eden", 0.05), train_stage=train_stage, clip_grad_norm=clip,
                           average_period=1)
    for n in range(steps):
        state, _ = step(state, _batch(n), step_generator(seed, n), 1)
    return state, make_opt


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    else:
        assert a == b


@pytest.mark.parametrize("optimizer", ["ScaledAdam", "Eve", "AdamW"])
def test_save_restore_round_trips_everything(tmp_path, optimizer):
    clip_period = 2 if optimizer == "ScaledAdam" else None  # a window that engages
    state, make_opt = _state(optimizer, steps=5, clip_period=clip_period)
    ckpt = CheckpointManager(tmp_path)
    meta = {"train_stage": 0, "epoch": 3, "train_loss": 1.5,
            "sampler_state": {"epoch": 3, "groups_consumed": 2}}
    ckpt.save_step(5, state, meta)
    assert ckpt.last_save["bytes"] == (tmp_path / "checkpoint-5.pt").stat().st_size > 0
    assert not list(tmp_path.glob("*.tmp"))

    fresh, _ = _state(optimizer, seed=1, steps=0, clip_period=clip_period)
    restored, got_meta = ckpt.restore("checkpoint-5", fresh, make_optimizer=make_opt,
                                      from_stage=0, to_stage=0)
    assert got_meta == meta and restored.step == 5
    _assert_same(restored.model.state_dict(), state.model.state_dict())
    _assert_same(restored.model_avg, state.model_avg)
    want, got = state.optimizer.state_dict(), restored.optimizer.state_dict()
    _assert_same(got["state"], want["state"])
    assert got["param_groups"] == want["param_groups"]
    if optimizer == "ScaledAdam":
        glob = restored.optimizer.state["global"]
        assert glob["step"] == 5 and glob["norm_threshold"].isfinite()  # the window engaged
        p = next(iter(restored.optimizer.param_groups[0]["params"]))
        assert restored.optimizer.state[p]["blocks"] == [(0, p.shape[0])]
    # the restored state trains on exactly as the saved one does
    step = make_train_step(get_lr_fn("eden", 0.05), clip_grad_norm=None, average_period=1)
    _, m1 = step(state, _batch(9), step_generator(0, 5), 1)
    _, m2 = step(restored, _batch(9), step_generator(0, 5), 1)
    assert float(m1["loss"]) == float(m2["loss"])
    _assert_same(restored.model.state_dict(), state.model.state_dict())


def test_keep_last_k_spares_best_and_latest_has_the_most_steps(tmp_path):
    state, _ = _state(steps=1)
    ckpt = CheckpointManager(tmp_path, keep_last_k=2)
    assert ckpt.latest() is None and ckpt.best("train") is None
    ckpt.save_epoch(1, state, {"train_loss": 5.0, "valid_loss": 6.0, "step": 8})
    assert ckpt.latest() == "epoch-1" and ckpt.best() == "epoch-1"
    for step, loss in ((10, 4.0), (20, 1.0), (30, 3.0), (40, 2.5), (50, 2.0)):
        ckpt.save_step(step, state, {"train_loss": loss, "step": step})
    names = sorted(p.name for p in tmp_path.glob("*.pt"))
    # checkpoint-20 holds the best train loss and survives the pruning
    assert names == ["checkpoint-20.pt", "checkpoint-40.pt", "checkpoint-50.pt", "epoch-1.pt"]
    assert not (tmp_path / "checkpoint-10.meta.json").exists()
    assert ckpt.best("train") == "checkpoint-20" and ckpt.best("valid") == "epoch-1"
    assert ckpt.latest() == "checkpoint-50"
    # an epoch checkpoint at the same step comes after the step one: its epoch is done
    ckpt.save_epoch(2, state, {"train_loss": 0.5, "step": 50})
    assert ckpt.best("train") == "epoch-2" and ckpt.latest() == "epoch-2"
    ckpt.save_step(51, state, {"step": 51})
    assert ckpt.latest() == "checkpoint-51"
    # without steps in the meta, any step checkpoint comes first (the JAX order)
    for f in tmp_path.glob("*.meta.json"):
        f.write_text("{}")
    ckpt.save_epoch(9, state, {})
    assert ckpt.latest() == "checkpoint-51"


def test_stage_switch_keeps_weights_and_builds_a_fresh_optimizer(tmp_path):
    state, make_opt = _state(train_stage=1, steps=3)
    ckpt = CheckpointManager(tmp_path)
    ckpt.save_step(3, state, {"train_stage": 1, "epoch": 1,
                              "sampler_state": {"epoch": 1, "groups_consumed": 3}})
    target, _ = _state(train_stage=2, seed=4, steps=0)
    restored, meta = ckpt.restore("checkpoint-3", target, make_optimizer=make_opt,
                                  from_stage=1, to_stage=2)
    assert "sampler_state" not in meta and meta["stage_switched"] and meta["epoch"] == 1
    assert restored.step == 3
    _assert_same(restored.model.state_dict(), state.model.state_dict())
    _assert_same(restored.model_avg, state.model_avg)
    opt = restored.optimizer
    trainable = partition_params(restored.model, 2)[0]
    params = opt.param_groups[0]["params"]
    assert [id(p) for p in params] == [id(p) for p in trainable.values()]
    assert opt.state["global"]["step"] == 0
    # ScaledAdam records the RMS of the weights it was built with: the loaded ones
    for name, p in trainable.items():
        if p.numel() > 1:
            rms = p.detach().pow(2).mean().sqrt()
            torch.testing.assert_close(opt.state[p]["param_rms"], rms.reshape(1), msg=name)


@pytest.mark.parametrize("use_averaged", [False, True])
def test_port_checkpoint_loads_through_the_jax_cli(tmp_path, use_averaged):
    from valle_tpu.bin.infer import load_model_params

    state, _ = _state(steps=3)
    ckpt = CheckpointManager(tmp_path)
    ckpt.save_epoch(1, state, {"train_stage": 0})
    cfg = ModelConfig(**KW)
    params = load_model_params(str(tmp_path / "epoch-1.pt"), JaxConfig(**KW), "valle",
                               use_averaged=use_averaged)
    got = numpy_state_dict_from_jax(jax.tree.map(np.asarray, params), cfg)
    want = state.model.state_dict()
    if use_averaged:
        assert any(not torch.equal(state.model_avg[n], want[n]) for n in state.model_avg)
        canonical = {id(p): n for n, p in state.model.named_parameters(remove_duplicate=True)}
        by_key = dict(state.model.state_dict(keep_vars=True))
        want = {k: state.model_avg[canonical[id(by_key[k])]] if id(by_key[k]) in canonical
                else v for k, v in want.items()}
    assert got.keys() == want.keys()
    for name, t in want.items():
        np.testing.assert_array_equal(got[name], t.numpy(), err_msg=name)
