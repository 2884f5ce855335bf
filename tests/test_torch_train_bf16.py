"""bf16 mixed-precision training of the port against the JAX package's, on
the CPU, with the JAX models' f32 init bridged into the port's training
build (``get_model(cfg, training=True)``: f32 parameters, every module
casting to bf16 at its call):

  - VALL-E at train stages 0, 1 and 2 (and 0 with ``add_prenet``: the
    prenets' convs, BatchNorm and MLP) and the Transformer TTS baseline, at
    dropout 0, JAX under ``dtype="bfloat16", attn_impl="xla"`` and the port
    through its plain versions ("fused": kernels 2 and 3; "flash" for the
    baseline: kernels 2, 3 and 4): the loss within rtol ``LOSS_RTOL`` and
    every gradient tensor within a relative L2 error of ``GRAD_REL_L2``
    (measured: loss 6e-5 / 8e-4 (TTS), median tensor 0.016 / 0.021, worst
    0.046 / 0.044; JAX's own bf16 gradients lie up to 0.057 / 0.13 from its
    f32 ones: this is bf16 rounding at other points, the port's kernels'
    plain versions round the logits later than XLA's bf16 einsum).  The
    one-element gradients of the AR positional ``alpha``s are one sum of
    B x T x D terms that cancel: where ``SCALAR_FLOOR`` times JAX's own
    bf16 distance from the f32 gradient exceeds ``GRAD_REL_L2``, that is
    their bar (measured: the text alpha 0.059 from JAX's bf16 value, which
    is 0.054 from its f32 value; the audio alpha 0.020, under 0.05).  The gradients are f32, as JAX's are;
  - inside the forward, every ``Dense`` output is bf16, every layer norm
    normalises an f32 input, and the layers' outputs (the residual stream)
    are f32, except where a prenet's bf16 output starts the stream (the
    baseline's decoder, VALL-E with ``add_prenet``): the JAX modules' dtypes;
  - after two ScaledAdam steps the parameters, the optimizer state and the
    averaged model are f32;
  - the train CLI with ``--dtype bfloat16 --remat dots_nobatch`` trains 2
    steps and writes a ``.pt`` of f32 weights, which the infer CLI reads
    under ``--dtype bfloat16``.

The TTS checks hold the port's mixed precision to JAX's: a baseline cast
wholly to bf16 (weights, embeddings and norms, as ``get_model`` cast it
before) fails them, with bf16 gradients, a bf16 encoder stream and norms
over bf16 inputs, though its gradients pass ``GRAD_REL_L2`` (worst 0.045).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_corpus import write_corpus
from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu.models import TransformerTTS as JaxTTS
from valle_tpu_torch.bin import infer, train
from valle_tpu_torch.data import CodeShardWriter, Manifest, SymbolTable
from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.nn import layers
from valle_tpu_torch.nn.layers import TransformerLayer
from valle_tpu_torch.nn.qdense import Dense
from valle_tpu_torch.optim import ScaledAdam, get_lr_fn
from valle_tpu_torch.train.step import init_train_state, make_train_step
from valle_tpu_torch.utils.bridge import numpy_state_dict_from_jax, state_dict_from_jax

B, S, T, Q = 3, 9, 16, 3
KW = dict(decoder_dim=64, nhead=4, num_layers=2, num_quantizers=Q, dropout=0.0)
TTS_KW = dict(model_name="Transformer", decoder_dim=64, nhead=4, num_layers=2, dropout=0.0)
LOSS_RTOL = 2e-2
GRAD_REL_L2 = 5e-2
SCALAR_FLOOR = 1.5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _valle_data():
    rng = np.random.RandomState(0)
    x = rng.randint(1, 512, (B, S)).astype(np.int32)
    y = rng.randint(0, 1024, (B, T, Q)).astype(np.int32)
    return x, np.array([9, 7, 5], np.int32), y, np.array([16, 12, 9], np.int32)


def _tts_data():
    rng = np.random.RandomState(1)
    x = rng.randint(1, 512, (2, S)).astype(np.int32)
    y = rng.randn(2, 20, 100).astype(np.float32)
    return x, np.array([S, S - 2], np.int32), y, np.array([20, 15], np.int32)


def _valle_ref(prenet: bool, stages):
    """f32 JAX variables; per train stage JAX's bf16 loss and gradients (as a
    params tree beside the init's batch statistics, which the bridge maps);
    and for the one-element gradients of the first stage, JAX's bf16
    distance from the f32 gradient.  The f32 gradient is the port's in f32,
    which equals JAX's to 2e-5 (``tests/test_torch_train.py``) and spares a
    JAX compile."""
    kw = dict(KW, add_prenet=prenet)
    data = tuple(jnp.asarray(a) for a in _valle_data())
    model = JaxVALLE(JaxConfig(**kw))
    variables = jax.jit(lambda k: model.init({"params": k, "stage": k}, *data, train_stage=0,
                                             deterministic=True, nar_stage=jnp.asarray(1)))(
        jax.random.PRNGKey(0))
    stats = variables.get("batch_stats", {})
    ref = {"variables": jax.tree.map(np.array, variables)}
    jmodel = JaxVALLE(JaxConfig(dtype="bfloat16", attn_impl="xla", **kw))
    for stage in stages:
        def loss(p, stage=stage):
            return jmodel.apply({"params": p, "batch_stats": stats}, *data, train_stage=stage,
                                deterministic=True, nar_stage=jnp.asarray(2))["loss"]

        value, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
        ref[stage] = (float(value), {"params": jax.tree.map(np.asarray, grads),
                                     "batch_stats": ref["variables"].get("batch_stats", {})})
    cfg = ModelConfig(**kw)
    f32 = get_model(cfg, device="cpu")
    f32.load_state_dict(state_dict_from_jax(ref["variables"], cfg, device="cpu"))
    f32(*(torch.from_numpy(a) for a in _valle_data()), train_stage=stages[0],
        nar_stage=2)["loss"].backward()
    want16 = numpy_state_dict_from_jax(ref[stages[0]][1], cfg, "valle")
    ref["scalar_floor"] = {n: _rel_l2(want16[n], p.grad.numpy()) for n, p in
                           f32.named_parameters() if p.numel() == 1 and p.grad is not None}
    return ref


@pytest.fixture(scope="module")
def valle_ref():
    # stage 0's AR gradients are stage 1's halved (its loss is the mean of
    # the AR and NAR losses), in bf16 as in f32: one f32 reference (stage 1)
    # serves both
    return _valle_ref(False, (1, 0, 2))


@pytest.fixture(scope="module")
def prenet_ref():
    return _valle_ref(True, (0,))


@pytest.fixture(scope="module")
def tts_ref():
    data = tuple(jnp.asarray(a) for a in _tts_data())
    init = JaxTTS(JaxConfig(**TTS_KW)).init
    params = jax.jit(lambda k: init({"params": k}, *data, deterministic=True))(
        jax.random.PRNGKey(1))["params"]
    bf16 = JaxTTS(JaxConfig(dtype="bfloat16", attn_impl="xla", **TTS_KW))

    def loss(p):
        return bf16.apply({"params": p}, *data, deterministic=True)["loss"]

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return {"params": jax.tree.map(np.array, params), "loss": float(value),
            "grads": jax.tree.map(np.asarray, grads)}


def _training_build(variables, variant, **kw):
    cfg = ModelConfig(dtype="bfloat16", **kw)
    model = get_model(cfg, device="cpu", training=True)
    model.load_state_dict(state_dict_from_jax(variables, cfg, variant, device="cpu"))
    return model


def _rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _check_grads(model, want_loss, want_grads, cfg, variant, out, scalar_floor=None):
    want = numpy_state_dict_from_jax(want_grads, cfg, variant)

    assert abs(float(out["loss"].detach()) - want_loss) <= LOSS_RTOL * abs(want_loss), \
        (float(out["loss"]), want_loss)
    errors = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            assert not p.requires_grad or not np.any(want[name]), name
            continue
        assert p.grad.dtype == torch.float32, name
        if np.any(want[name]):
            errors[name] = _rel_l2(p.grad.numpy(), want[name])
    bars = {k: max(GRAD_REL_L2, SCALAR_FLOOR * v) for k, v in (scalar_floor or {}).items()
            if k in errors}
    worst = max(errors, key=lambda k: errors[k] / bars.get(k, GRAD_REL_L2))
    assert errors[worst] <= bars.get(worst, GRAD_REL_L2), (worst, errors[worst])
    return errors


class _Dtypes:
    """Forward hooks and a ``layer_norm`` wrapper recording the dtypes of
    every Dense output, every layer output and every norm's input."""

    def __init__(self, model, monkeypatch):
        self.dense, self.layer, self.norm = set(), set(), set()
        for name, m in model.named_modules():
            if isinstance(m, Dense):
                m.register_forward_hook(lambda m, a, out: self.dense.add(out.dtype))
            if isinstance(m, TransformerLayer):
                m.register_forward_hook(
                    lambda m, a, out, n=name: self.layer.add((n.split(".")[0], out[0].dtype)))
        layer_norm = layers.F.layer_norm

        def recorded(x, *a, **kw):
            self.norm.add(x.dtype)
            return layer_norm(x, *a, **kw)

        monkeypatch.setattr(layers.F, "layer_norm", recorded)

    def check(self, layers_by_stack):
        assert self.dense == {torch.bfloat16}, self.dense
        assert self.layer == layers_by_stack, self.layer
        assert self.norm == {torch.float32}, self.norm


@pytest.mark.parametrize("train_stage,prenet", [(0, False), (1, False), (2, False), (0, True)])
def test_valle_bf16_loss_and_gradients_match_jax(request, train_stage, prenet, monkeypatch):
    """With ``add_prenet`` the prenets (convs, BatchNorm, MLP) compute in bf16
    over f32 weights, as JAX's do."""
    ref = request.getfixturevalue("prenet_ref" if prenet else "valle_ref")
    kw = dict(KW, add_prenet=prenet)
    model = _training_build(ref["variables"], "valle", attn_impl="fused", **kw)
    dtypes = _Dtypes(model, monkeypatch)
    out = model(*(torch.from_numpy(a) for a in _valle_data()), train_stage=train_stage,
                nar_stage=2)
    assert out["loss"].dtype == torch.float32
    out["loss"].backward()
    stacks = {0: ("ar_decoder", "nar_decoder"), 1: ("ar_decoder",), 2: ("nar_decoder",)}
    # the prenets' bf16 outputs start the residual stream, as in JAX
    stream = torch.bfloat16 if prenet else torch.float32
    dtypes.check({(s, stream) for s in stacks[train_stage]})
    want_loss, want_grads = ref[train_stage]
    floor = ref["scalar_floor"] if train_stage in (0, 1) else None
    errors = _check_grads(model, want_loss, want_grads, ModelConfig(**kw), "valle", out, floor)
    assert len(errors) > 10
    if prenet:
        assert any("_prenet." in name for name in errors)


def test_tts_bf16_loss_and_gradients_match_jax(tts_ref, monkeypatch):
    model = _training_build({"params": tts_ref["params"]}, "transformer", attn_impl="flash",
                            **TTS_KW)
    dtypes = _Dtypes(model, monkeypatch)
    out = model(*(torch.from_numpy(a) for a in _tts_data()))
    assert out["loss"].dtype == torch.float32
    out["loss"].backward()
    # the decoder's residual stream starts at the prenet's bf16 output, as JAX's does
    dtypes.check({("encoder", torch.float32), ("decoder", torch.bfloat16)})
    errors = _check_grads(model, tts_ref["loss"], tts_ref["grads"], ModelConfig(**TTS_KW),
                          "transformer", out)
    assert len(errors) == len(list(model.parameters()))


def _batch(seed, tts=False):
    rng = np.random.RandomState(seed)
    if tts:
        x, x_lens, y, y_lens = _tts_data()
    else:
        x, x_lens, y, y_lens = _valle_data()
    x = np.stack([x, rng.permutation(x)])
    return {"text_tokens": torch.from_numpy(x), "text_tokens_lens": torch.from_numpy(
        np.stack([x_lens, x_lens])), "audio_features": torch.from_numpy(np.stack([y, y])),
        "audio_features_lens": torch.from_numpy(np.stack([y_lens, y_lens]))}


@pytest.mark.parametrize("variant", ["valle", "transformer"])
def test_parameters_and_optimizer_state_stay_f32(valle_ref, tts_ref, variant):
    if variant == "valle":
        model = _training_build(valle_ref["variables"], "valle", attn_impl="fused",
                                **dict(KW, dropout=0.1))
    else:
        model = _training_build({"params": tts_ref["params"]}, "transformer",
                                attn_impl="flash", **TTS_KW)
    state = init_train_state(model, functools.partial(ScaledAdam, lr=0.05, clipping_scale=2.0),
                             with_model_avg=True)
    step = make_train_step(get_lr_fn("eden", 0.05, warmup_steps=200), average_period=1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for n in range(2):
        state, metrics = step(state, _batch(n, variant == "transformer"),
                              torch.Generator().manual_seed(n), 0)
        assert np.isfinite(float(metrics["loss"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert any(not torch.equal(v, before[k]) for k, v in model.state_dict().items())
    opt_tensors = [v for s in state.optimizer.state.values() for v in s.values()
                   if isinstance(v, torch.Tensor) and v.is_floating_point()]
    assert opt_tensors and all(v.dtype == torch.float32 for v in opt_tensors)
    assert all(v.dtype == torch.float32 for v in state.model_avg.values())


def test_train_cli_bf16_writes_f32_weights_that_infer_reads(tmp_path):
    corpus = write_corpus(tmp_path / "corpus", writer_cls=CodeShardWriter, manifest_cls=Manifest,
                          table_cls=SymbolTable, splits=(("train", 12),))
    exp = tmp_path / "exp"
    dims = ["--decoder-dim", "64", "--nhead", "4", "--num-decoder-layers", "2"]
    out = train.main(["--manifest-dir", str(corpus), "--exp-dir", str(exp), *dims,
                      "--dtype", "bfloat16", "--remat", "dots_nobatch", "--attn-impl", "fused",
                      "--train-stage", "1", "--num-epochs", "1", "--max-duration", "4",
                      "--num-buckets", "1", "--batch-quant", "1", "--oom-check", "false",
                      "--save-every-n", "0", "--tensorboard", "false", "--log-interval", "1",
                      "--device", "cpu"])
    assert len(out["steps"]) >= 2 and all(np.isfinite([s["loss"] for s in out["steps"]]))
    assert all(p.dtype == torch.float32 for p in out["state"].model.parameters())
    saved = torch.load(exp / "checkpoints" / "epoch-1.pt", map_location="cpu",
                       weights_only=False)
    assert {v.dtype for v in saved["model"].values() if v.is_floating_point()} == {torch.float32}
    infer.main(["--checkpoint", str(exp / "checkpoints" / "epoch-1.pt"), *dims,
                "--dtype", "bfloat16", "--text-tokens", str(corpus / "unique_text_tokens.k2symbols"),
                "--text-extractor", "chars", "--text", "abcd", "--top-k", "1", "--max-new-tokens", "8",
                "--output-dir", str(tmp_path / "out"), "--device", "cpu"])
    codes = np.load(tmp_path / "out" / "0_codes.npy")
    assert codes.ndim == 2 and codes.shape[1] == 8
