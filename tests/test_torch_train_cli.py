"""The port's training CLI (``valle_tpu_torch.bin.train.main``) on a tiny
synthetic corpus (``tests/torch_corpus.py``), on the CPU:

  (a) parity with the JAX CLI: both warm-start from one ``.npz`` at
      ``--train-stage 1 --dropout 0 --prefix-mode 0``, share ``--seed`` and
      run 2 epochs with their train steps made deterministic (the AR
      positional embeddings keep their fixed dropout of 0.1 under
      ``--dropout 0`` in both packages, and dropout bits differ); every step's
      loss within rtol 1e-4 of the JAX CLI's (the sums its tracker takes),
      the final weights within rtol 1e-4 / atol 2e-5 of the JAX CLI's
      Orbax ``epoch-2`` (``tests/test_torch_train.py``'s tolerances).  Such
      a weight bound holds over 14 steps only while no ReLU gate sits within
      rounding of 0: with one bucket (and corpus seed 1) the weights after
      two steps, 1e-7 apart, flip one gate, the gradients then differ by
      0.016, and ScaledAdam's per-element normalisation makes that a full
      step (the port given JAX's weights gives JAX's gradient to 2e-6); the
      two-bucket configuration here held on corpus seeds 0, 1 and 2;
  (b) the two-stage recipe in one exp dir: stage 2 resumes from stage 1's
      ``epoch-1`` at epoch 2, with the ``ar_*`` weights equal to stage 1's
      final ones and an optimizer over the ``nar_*`` parameters only;
  (c) resume: 4 uninterrupted steps, and 2 steps stopped and resumed for 2
      more, end with bit-equal weights, averaged model and optimizer state
      (dropout 0.1, so step n's generator derivation counts);
  (d) ``--inf-check`` names the parameter the test poisoned with a NaN;
  (e) the TTS baseline with SpecAugment on a log-mel manifest trains 2 steps,
      and a run of it cut mid-epoch and at an epoch's start, then resumed,
      repeats the uninterrupted run (SpecAugment's generator is saved);
      an unknown card trains with ``mfu=n/a``;
  (f) ``--oom-check true`` leaves the losses and weights bit-equal;
  (g) the refusals: ``--device cuda`` without CUDA and ``--num-processes 2``
      without a coordinator address (data parallelism trains:
      ``tests/test_torch_multiprocess_train.py``; ``--dtype bfloat16``
      trains: ``tests/test_torch_train_bf16.py``;
      ``--visualize true`` draws: ``tests/test_torch_visualizer.py``).
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_corpus import write_corpus
from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu_torch.bin import train
from valle_tpu_torch.data import CodeShardWriter, Manifest, SymbolTable
from valle_tpu_torch.models import ModelConfig
from valle_tpu_torch.utils import flatten_tree
from valle_tpu_torch.utils.bridge import numpy_state_dict_from_jax

DIMS = ["--decoder-dim", "64", "--nhead", "4", "--num-decoder-layers", "2"]
KW = dict(decoder_dim=64, nhead=4, num_layers=2)
QUIET = ["--tensorboard", "false", "--log-interval", "1", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(root, **kw):
    return write_corpus(root, writer_cls=CodeShardWriter, manifest_cls=Manifest,
                        table_cls=SymbolTable, **kw)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """24 training utterances of 0.6-1.4 s in 3 speakers, 4 for dev."""
    return _corpus(tmp_path_factory.mktemp("corpus"), splits=(("train", 24), ("dev", 4)))


@pytest.fixture(scope="module")
def train_only(tmp_path_factory):
    """The same 24 training utterances without a dev split: no validation,
    so the JAX CLI compiles one program less."""
    return _corpus(tmp_path_factory.mktemp("train_only"), splits=(("train", 24),))


@pytest.fixture(scope="module")
def init_npz(tmp_path_factory):
    """The flattened flax params of a seeded JAX VALL-E."""
    model = JaxVALLE(JaxConfig(**KW))
    x = jnp.ones((1, 8), jnp.int32)
    y = jnp.ones((1, 16, 8), jnp.int32)
    lens = jnp.asarray([8], jnp.int32), jnp.asarray([16], jnp.int32)
    variables = jax.jit(lambda k: model.init(
        {"params": k, "stage": k}, x, lens[0], y, lens[1], train_stage=0, deterministic=True,
        nar_stage=jnp.asarray(1)))(jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, variables["params"])
    path = tmp_path_factory.mktemp("init") / "init.npz"
    np.savez(path, **flatten_tree(params))
    return path, params


def _argv(corpus, exp, *extra):
    return ["--manifest-dir", str(corpus), "--exp-dir", str(exp), *DIMS, *QUIET, *extra]


def test_losses_and_weights_match_the_jax_cli(train_only, init_npz, tmp_path, monkeypatch):
    from valle_tpu.bin import infer as jax_infer
    from valle_tpu.bin import train as jax_train

    flags = ["--train-stage", "1", "--dropout", "0", "--prefix-mode", "0", "--seed", "7",
             "--num-epochs", "2", "--oom-check", "false", "--max-duration", "4",
             "--num-buckets", "2", "--save-every-n", "0", "--valid-interval", "1000",
             "--average-period", "2", "--init-checkpoint", str(init_npz[0])]
    jax_losses = []

    class Recorder(jax_train.MetricsTracker):
        def update(self, metrics):
            jax_losses.append(metrics["loss"])
            super().update(metrics)

    monkeypatch.setattr(jax_train, "MetricsTracker", Recorder)
    monkeypatch.setattr(jax_train, "make_train_step",
                        functools.partial(jax_train.make_train_step, deterministic=True))
    monkeypatch.setattr(train, "make_train_step",
                        functools.partial(train.make_train_step, deterministic=True))
    jax_exp = tmp_path / "jax"
    jax_exp.mkdir()
    jax_args = jax_train.get_parser().parse_args(
        ["--manifest-dir", str(train_only), "--exp-dir", str(jax_exp), *DIMS, "--tensorboard",
         "false", "--log-interval", "1", *flags])
    jax_train.run(jax_args)
    logging.getLogger().handlers.clear()  # the JAX CLI's log file handler

    out = train.main(_argv(train_only, tmp_path / "port", *flags))
    got = [s["loss"] for s in out["steps"]]
    assert len(got) == len(jax_losses) >= 6, (len(got), len(jax_losses))
    np.testing.assert_allclose(got, jax_losses, rtol=1e-4)
    assert got[-1] < got[0] * 2  # trained, not diverged
    log = (tmp_path / "port" / "log.txt").read_text()
    assert "epoch 2 done" in log and "mfu=n/a" in log and "data loader path: native" in log
    assert (tmp_path / "port" / "model.txt").read_text().count("\n") > 40

    cfg = ModelConfig(**KW)
    ckpt = str(jax_exp / "checkpoints" / "epoch-2")
    want = numpy_state_dict_from_jax(
        jax.tree.map(np.asarray, jax_infer.load_model_params(ckpt, JaxConfig(**KW), "valle")),
        cfg)
    state = out["state"]
    for name, t in state.model.state_dict().items():
        np.testing.assert_allclose(t.numpy(), want[name], rtol=1e-4, atol=2e-5, err_msg=name)
    avg = numpy_state_dict_from_jax(jax.tree.map(np.asarray, jax_infer.load_model_params(
        ckpt, JaxConfig(**KW), "valle", use_averaged=True)), cfg)
    for name, t in state.model_avg.items():
        np.testing.assert_allclose(t.numpy(), avg[name], rtol=1e-4, atol=2e-5, err_msg=name)


FAST = ["--max-duration", "3", "--num-buckets", "1", "--batch-quant", "1", "--oom-check",
        "false", "--valid-interval", "1000", "--save-every-n", "0"]


def _weights(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def test_two_stage_recipe_in_one_exp_dir(corpus, tmp_path):
    exp = tmp_path / "exp"
    first = train.main(_argv(corpus, exp, *FAST, "--train-stage", "1", "--num-epochs", "1",
                             "--average-period", "1"))
    stage1 = _weights(first["state"])
    assert first["resumed_from"] is None and len(first["steps"]) >= 2
    second = train.main(_argv(corpus, exp, *FAST, "--train-stage", "2", "--num-epochs", "2",
                              "--average-period", "1"))
    assert second["resumed_from"] == "epoch-1"
    state = second["state"]
    # stage 2 takes the next epoch, counting steps on from stage 1's
    assert {s["epoch"] for s in second["steps"]} == {2}
    assert second["steps"][0]["step"] == len(first["steps"]) + 1
    final = state.model.state_dict()
    for name, t in final.items():
        if name.startswith("ar_"):
            assert torch.equal(t, stage1[name]), name
    moved = [n for n in final if n.startswith("nar_") and not torch.equal(final[n], stage1[n])]
    assert len(moved) > 20
    trained = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    names = {n for n, p in state.model.named_parameters() if id(p) in trained}
    assert names and all(n.startswith("nar_") for n in names)
    meta = (exp / "checkpoints" / "epoch-2.meta.json").read_text()
    assert '"train_stage": 2' in meta


class _Stop(BaseException):
    """Ends a run between two steps, as a killed process would."""


def test_resumed_run_repeats_the_uninterrupted_one_bit_for_bit(corpus, tmp_path, monkeypatch):
    flags = [*FAST, "--train-stage", "0", "--num-epochs", "1", "--dropout", "0.1",
             "--save-every-n", "2", "--average-period", "1", "--keep-last-k", "1"]
    whole = train.main(_argv(corpus, tmp_path / "whole", *flags))
    n = len(whole["steps"])
    assert n >= 4, n

    make_step = train.make_train_step

    def stopping(*args, **kw):
        step = make_step(*args, **kw)

        def run(state, batch, rng, epoch):
            if state.step == 2:
                raise _Stop
            return step(state, batch, rng, epoch)

        return run

    monkeypatch.setattr(train, "make_train_step", stopping)
    with pytest.raises(_Stop):
        train.main(_argv(corpus, tmp_path / "cut", *flags))
    monkeypatch.setattr(train, "make_train_step", make_step)
    resumed = train.main(_argv(corpus, tmp_path / "cut", *flags))
    assert resumed["resumed_from"] == "checkpoint-2"
    assert [s["step"] for s in resumed["steps"]] == list(range(3, n + 1))
    assert [s["loss"] for s in resumed["steps"]] == [s["loss"] for s in whole["steps"][2:]]
    a, b = whole["state"], resumed["state"]
    assert a.step == b.step == n
    for name, t in a.model.state_dict().items():
        assert torch.equal(t, b.model.state_dict()[name]), name
    for name, t in a.model_avg.items():
        assert torch.equal(t, b.model_avg[name]), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys() and "global" in sa["state"]
    for k, st in sa["state"].items():
        for key, v in st.items():
            other = sb["state"][k][key]
            assert torch.equal(v, other) if isinstance(v, torch.Tensor) else v == other, (k, key)


def test_inf_check_names_the_poisoned_parameter(corpus, init_npz, tmp_path):
    path, params = init_npz
    flat = flatten_tree(params)
    key = "ar_decoder/layers/linear1/kernel"
    flat[key] = flat[key].copy()
    flat[key][1, 0, 0] = np.nan  # layer 1 of the AR stack
    poisoned = tmp_path / "poisoned.npz"
    np.savez(poisoned, **flat)
    with pytest.raises(FloatingPointError) as e:
        train.main(_argv(corpus, tmp_path / "exp", *FAST, "--train-stage", "1",
                         "--num-epochs", "1", "--inf-check", "true", "--init-checkpoint",
                         str(poisoned)))
    msg = str(e.value)
    assert "non-finite params: ['ar_decoder.layers.1.linear1.weight']" in msg, msg
    assert "first non-finite module output: ar_decoder.layers.1.linear1" in msg, msg
    assert list((tmp_path / "exp").glob("batch-crash-step0.npz"))


@pytest.fixture(scope="module")
def mel_corpus(tmp_path_factory):
    """Random log-mels of 100 bins at 93.75 frames/s in float16 shards."""
    return _corpus(tmp_path_factory.mktemp("mels"), splits=(("train", 8),), fmt="vsf",
                   frame_rate=93.75, dim=100, dur=(0.4, 0.8))


def test_tts_baseline_trains_with_spec_augment(mel_corpus, tmp_path):
    out = train.main(_argv(mel_corpus, tmp_path / "exp", "--model-name", "Transformer",
                           "--attn-impl", "flash", "--enable-spec-aug", "true", "--num-epochs",
                           "1", "--max-duration", "2.5", "--num-buckets", "1",
                           "--batch-quant", "1", "--valid-interval", "1000",
                           "--save-every-n", "0", "--profile-steps", "1,2"))
    assert out["loader_path"] == "numpy"  # log-mel manifests take the numpy path
    assert len(out["steps"]) == 2 and all(np.isfinite(s["loss"]) for s in out["steps"])
    assert out["oom_scan"] and out["steps"][0]["shape"][3] >= 30
    assert (tmp_path / "exp" / "profile" / "trace.json").exists()
    assert (tmp_path / "exp" / "checkpoints" / "epoch-1.pt").exists()


def test_resumed_tts_run_with_spec_augment_repeats_the_uninterrupted_one(mel_corpus, tmp_path,
                                                                       monkeypatch):
    """SpecAugment's generator rides in the saved loader state: a run cut
    mid-epoch (resumed from ``checkpoint-1``) and again at the start of
    epoch 2 (resumed from ``epoch-1``) draws the uninterrupted run's masks."""
    flags = ["--model-name", "Transformer", "--attn-impl", "flash", "--enable-spec-aug", "true",
             "--num-epochs", "2", "--max-duration", "2.5", "--num-buckets", "1",
             "--batch-quant", "1", "--valid-interval", "1000", "--save-every-n", "1",
             "--keep-last-k", "1", "--oom-check", "false"]
    whole = train.main(_argv(mel_corpus, tmp_path / "whole", *flags))
    per_epoch = [s["epoch"] for s in whole["steps"]].count(1)
    assert per_epoch >= 2 and len(whole["steps"]) == 2 * per_epoch
    make_step = train.make_train_step

    def stopping_at(n):
        def make(*args, **kw):
            step = make_step(*args, **kw)

            def run(state, batch, rng, epoch):
                if state.step == n:
                    raise _Stop
                return step(state, batch, rng, epoch)

            return run

        return make

    cut = tmp_path / "cut"
    for stop in (1, per_epoch):
        monkeypatch.setattr(train, "make_train_step", stopping_at(stop))
        with pytest.raises(_Stop):
            train.main(_argv(mel_corpus, cut, *flags))
        assert (cut / "checkpoints" / f"checkpoint-{stop}.pt").exists()
    monkeypatch.setattr(train, "make_train_step", make_step)
    out = train.main(_argv(mel_corpus, cut, *flags))
    assert out["resumed_from"] == "epoch-1"
    assert [s["loss"] for s in out["steps"]] == [s["loss"] for s in whole["steps"][per_epoch:]]
    want = whole["state"].model.state_dict()
    for name, t in out["state"].model.state_dict().items():
        assert torch.equal(t, want[name]), name


def test_unknown_card_trains_with_mfu_na(caplog):
    cuda = torch.device("cuda")
    assert train.mfu_peak("float32", cuda, device_name="NVIDIA H100 80GB HBM3") == 67e12
    assert train.mfu_peak("float32", torch.device("cpu")) is None
    with caplog.at_level(logging.WARNING):
        assert train.mfu_peak("float32", cuda, device_name="NVIDIA A100-SXM4-80GB") is None
    assert "'NVIDIA A100-SXM4-80GB'" in caplog.text and "mfu=n/a" in caplog.text


def test_oom_scan_leaves_the_run_bit_equal(corpus, tmp_path):
    flags = [*FAST, "--train-stage", "0", "--num-epochs", "1", "--dropout", "0.1",
             "--add-prenet", "true"]
    without = train.main(_argv(corpus, tmp_path / "a", *flags))
    flags[flags.index("--oom-check") + 1] = "true"
    with_scan = train.main(_argv(corpus, tmp_path / "b", *flags))
    assert len(with_scan["oom_scan"]) >= 1
    assert [s["loss"] for s in with_scan["steps"]] == [s["loss"] for s in without["steps"]]
    want = without["state"].model.state_dict()
    for name, t in with_scan["state"].model.state_dict().items():
        assert torch.equal(t, want[name]), name


def test_refusals(corpus, tmp_path):
    exp = tmp_path / "exp"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--manifest-dir", str(corpus), "--exp-dir", str(exp)])
        with pytest.raises(RuntimeError, match="CUDA"):
            train.main(["--manifest-dir", str(corpus), "--exp-dir", str(exp), "--device", "cuda"])
        assert not exp.exists()
    assert train.get_parser().parse_args(
        ["--manifest-dir", "m", "--exp-dir", "e"]).device == "cuda"
    # data parallelism needs the group's address (it runs in
    # tests/test_torch_multiprocess_train.py)
    with pytest.raises(ValueError, match="coordinator address"):
        train.main(_argv(corpus, exp, "--num-processes", "2"))
    # bf16 mixed precision and remat are ported (tests/test_torch_train_bf16.py,
    # tests/test_torch_remat.py): only --rng-impl, a JAX PRNG's name, has no effect
    remat = next(a for a in train.get_parser()._actions if a.dest == "remat")
    assert "no effect" not in remat.help
    assert "no effect" in next(a for a in train.get_parser()._actions
                               if a.dest == "rng_impl").help
