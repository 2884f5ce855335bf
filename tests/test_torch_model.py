"""VALL-E / VALL-F of the port against the JAX models with the same weights
(the JAX init bridged into the port): the deterministic forward (losses and
metrics, prefix modes 0/1/2/4, with and without the prenets), the AR prefill
(logits and KV) and an AR decode step.

Tolerances: rtol 1e-5 on losses and metrics, atol 1e-5 on logits and K/V
(f32, summation order).  In the VALL-F prefill the prompt filler rows see no
visible column; their K/V differ between the packages (see
ops/fused_attention.py) and are masked in every later read, so the
comparison leaves them out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import VALLF as JaxVALLF
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu.ops import masks as jm
from valle_tpu.sample import _prefill_kv as jax_prefill_kv
from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.ops import masks as tm
from valle_tpu_torch.sample import _prefill_kv
from valle_tpu_torch.utils.bridge import state_dict_from_jax

B, S, T, Q = 3, 7, 12, 4
KW = dict(decoder_dim=32, nhead=4, num_layers=2, num_quantizers=Q)


def _data():
    rng = np.random.RandomState(0)
    x = rng.randint(1, 512, (B, S)).astype(np.int32)
    x_lens = np.array([7, 5, 3], np.int32)
    y = rng.randint(0, 1024, (B, T, Q)).astype(np.int32)
    y_lens = np.array([12, 9, 6], np.int32)
    y_prompts = rng.randint(0, 1024, (B, 4, Q)).astype(np.int32)
    return x, x_lens, y, y_lens, y_prompts


def _init(variant, prenet):
    """(variant, kw, JAX variables as numpy) of one initialised model."""
    kw = dict(KW, add_prenet=prenet, model_name="VALL-F" if variant == "vallf" else "VALL-E")
    model = (JaxVALLF if variant == "vallf" else JaxVALLE)(JaxConfig(**kw))
    x, x_lens, y, y_lens, _ = _data()
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda k: model.init(
        {"params": k, "stage": k}, jnp.asarray(x), jnp.asarray(x_lens), jnp.asarray(y),
        jnp.asarray(y_lens), train_stage=0, deterministic=True,
        nar_stage=jnp.asarray(1)))(key)
    variables = jax.tree.map(np.array, variables)
    if prenet:  # non-trivial BatchNorm running statistics
        rng = np.random.RandomState(1)
        for side in variables["batch_stats"].values():
            for bn in side.values():
                bn["mean"] = rng.randn(*bn["mean"].shape).astype(np.float32) * 0.1
                bn["var"] = rng.rand(*bn["var"].shape).astype(np.float32) + 0.5
    return variant, kw, variables


@pytest.fixture(scope="module", params=["valle", "vallf"])
def pair(request):
    return _init(request.param, prenet=False)


@pytest.fixture(scope="module")
def pair_prenet():
    return _init("valle", prenet=True)


def _port(variant, kw, variables, **over):
    cfg = ModelConfig(**dict(kw, **over))
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, cfg, variant, device="cpu"))
    return model


def _check_forward(pair, mode, train_stage, nar_stage):
    variant, kw, variables = pair
    x, x_lens, y, y_lens, y_prompts = _data()
    extra = {1: dict(prefix_len=np.asarray(3, np.int32)),
             2: dict(prompt_starts=np.array([2, 0, 1], np.int32)),
             4: dict(y_prompts_codes=y_prompts)}.get(mode, {})
    jmodel = (JaxVALLF if variant == "vallf" else JaxVALLE)(JaxConfig(prefix_mode=mode, **kw))
    want = jmodel.apply(
        variables, jnp.asarray(x), jnp.asarray(x_lens), jnp.asarray(y), jnp.asarray(y_lens),
        train_stage=train_stage, deterministic=True,
        nar_stage=None if nar_stage is None else jnp.asarray(nar_stage),
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in extra.items()})
    model = _port(variant, kw, variables, prefix_mode=mode, attn_impl="flash")
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(x_lens), torch.from_numpy(y),
                    torch.from_numpy(y_lens), train_stage=train_stage, nar_stage=nar_stage,
                    **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                       for k, v in extra.items()})
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("mode,train_stage,nar_stage", [
    (0, 0, 1), (0, 2, 3), (1, 0, 2), (2, 0, 2), (4, 2, 3), (0, 1, None)])
def test_forward_losses_and_metrics_match(pair, mode, train_stage, nar_stage):
    _check_forward(pair, mode, train_stage, nar_stage)


def test_prenet_forward_matches(pair_prenet):
    _check_forward(pair_prenet, 0, 0, 2)


def _prefill_inputs():
    x, x_lens, y, _, _ = _data()
    prompt_lens = np.array([12, 4, 9], np.int32)
    return x, x_lens, y, prompt_lens


def _check_prefill_and_decode_step(pair, attn_impl):
    variant, kw, variables = pair
    x, x_lens, prompts, prompt_lens = _prefill_inputs()
    jmodel = (JaxVALLF if variant == "vallf" else JaxVALLE)(JaxConfig(**kw))
    jlogits, (jk, jv), jmem, jkey_pad, jmem_bias, tpre, _ = jax_prefill_kv(
        jmodel, variables, jnp.asarray(x), jnp.asarray(x_lens), jnp.asarray(prompts),
        jnp.asarray(prompt_lens))
    model = _port(variant, kw, variables, attn_impl=attn_impl)
    tx, tx_lens, tprompts, tprompt_lens = (torch.from_numpy(a).long() for a in _prefill_inputs())
    with torch.inference_mode():
        logits, (k, v), mem, key_pad, mem_bias, tpre_t = _prefill_kv(
            model, tx, tx_lens, tprompts, tprompt_lens)
    assert tpre_t == tpre
    np.testing.assert_array_equal(key_pad.numpy(), np.asarray(jkey_pad))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5)
    valid = ~np.asarray(jkey_pad)  # (B, Tpre)
    for a, w in ((k, jk), (v, jv)):
        np.testing.assert_allclose(a.numpy()[:, valid], np.asarray(w)[:, valid], atol=1e-5)

    # one decode step over a model-dtype cache of tpre + 4 columns
    width, t = tpre + 4, 0
    tok = np.array([[5], [1000], [7]], np.int32)
    positions = (prompt_lens + t)[:, None]
    step_valid = np.concatenate([valid, np.zeros((B, 4), bool)], 1)
    step_valid[:, tpre + t] = True
    bias = np.where(step_valid, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    jcache = tuple(jnp.pad(c, ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))) for c in (jk, jv))
    jstep, _ = jmodel.apply(variables, jnp.asarray(tok), jnp.asarray(positions), jcache,
                            tpre + t, jnp.asarray(bias), jmem, jmem_bias,
                            method="ar_decode_step")
    with torch.inference_mode():
        cache = tuple(torch.cat([c, c.new_zeros(c.shape[:2] + (4,) + c.shape[3:])], 2)
                      for c in (k, v))
        for kv_lengths in (None, torch.full((B,), tpre + t + 1, dtype=torch.int32)):
            step, _ = model.ar_decode_step(
                torch.from_numpy(tok).long(), torch.from_numpy(positions).long(),
                tuple(c.clone() for c in cache), tpre + t, torch.from_numpy(bias), mem, mem_bias,
                kv_lengths=kv_lengths)
            np.testing.assert_allclose(step.numpy(), np.asarray(jstep), atol=1e-5)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_prefill_and_decode_step_match(pair, attn_impl):
    _check_prefill_and_decode_step(pair, attn_impl)


def test_prenet_prefill_and_decode_step_match(pair_prenet):
    _check_prefill_and_decode_step(pair_prenet, "flash")


def test_attn_mask_spec_of_prefill_equals_the_merged_bias_on_visible_rows():
    """The port's prefill passes an AttnMaskSpec where JAX merges a dense
    bias; both masks agree wherever a row sees a visible column."""
    key_pad = np.random.RandomState(2).rand(2, 9) < 0.3
    key_pad[:, 0] = False
    merged = np.asarray(jm.mask_to_bias(jm.merge_padding(jm.prefix_lm_attn_mask(4, 5),
                                                         jnp.asarray(key_pad))))
    spec = tm.AttnMaskSpec(tm.mask_to_bias(torch.from_numpy(key_pad)), prefix_s=4).dense(9)
    np.testing.assert_array_equal(merged < -1e8, spec.numpy() < -1e8)


@pytest.mark.parametrize("variant", ["valle", "vallf"])
def test_bf16_prefill_logits_match_jax(variant):
    """In bf16 the JAX model keeps f32 parameters, embeddings and residual
    stream and computes its projections, attention and logits in bf16; the
    port casts only what JAX casts (``models.get_model``).  Prefill logits
    (d=64, 4 heads, 2 layers, Q=4, ``"xla"`` attention on both sides) within
    one bf16 ulp of the largest JAX logit.  A port that cast the whole model
    to bf16 was 1.5 ulps off here, and at 12 layers (d=256) twice as far as
    JAX from the f32 logits."""
    kw = dict(decoder_dim=64, nhead=4, num_layers=2, num_quantizers=Q, dtype="bfloat16",
              model_name="VALL-F" if variant == "vallf" else "VALL-E")
    x, x_lens, prompts, prompt_lens = _prefill_inputs()
    jmodel = (JaxVALLF if variant == "vallf" else JaxVALLE)(JaxConfig(**kw))
    variables = jax.jit(lambda k: jmodel.init(
        {"params": k, "stage": k}, jnp.asarray(x), jnp.asarray(x_lens), jnp.asarray(prompts),
        jnp.full((B,), T, jnp.int32), train_stage=0, deterministic=True,
        nar_stage=jnp.asarray(1)))(jax.random.PRNGKey(0))
    want = jax.jit(lambda v, *a: jax_prefill_kv(jmodel, v, *a)[0])(
        variables, *map(jnp.asarray, (x, x_lens, prompts, prompt_lens)))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    model = _port(variant, kw, jax.tree.map(np.asarray, variables))
    assert model.ar_text_embedding.weight.dtype == torch.float32
    assert model.ar_decoder.layers[0].linear1.weight.dtype == torch.bfloat16
    with torch.inference_mode():
        got = _prefill_kv(model, *(torch.from_numpy(a).long() for a in _prefill_inputs()))[0]
    assert got.dtype == torch.bfloat16
    top = np.abs(want).max()
    ulp = np.ldexp(np.float32(1), np.frexp(top)[1] - 8)  # bf16 ulp at the largest logit
    assert np.abs(got.float().numpy() - want).max() <= ulp
