"""Greedy zero-shot generation: the PyTorch port against the JAX package.

The same seeded inputs and the same weights (bridged from the JAX init) go
through ``valle_tpu.sample.generate`` (``ragged_decode=False``, which
tests/test_ragged_decode.py shows equals ``True``) and
``valle_tpu_torch.sample.generate`` on the CPU, where the port's kernel
wrappers run their plain PyTorch versions.  With ``top_k=1`` both samplers
are greedy, so codes and lengths must be equal, token for token, for VALL-E
and VALL-F, ragged prompt lengths, both KV-cache types, the port's ragged
and dense decode reads, and its attention routes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import VALLF as JaxVALLF
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu.sample import generate as jax_generate
from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.sample import generate
from valle_tpu_torch.utils.bridge import state_dict_from_jax

B, S, P, Q = 5, 7, 6, 3
MAX_NEW = 12


def _inputs():
    rng = np.random.RandomState(0)
    x = rng.randint(1, 512, (B, S)).astype(np.int32)
    x_lens = np.array([7, 4, 6, 3, 5], np.int32)
    prompts = rng.randint(0, 1024, (B, P, Q)).astype(np.int32)
    prompt_lens = np.array([6, 2, 5, 3, 4], np.int32)
    stop_lens = np.array([3, 12, 7, 9, 5], np.int32)
    return x, x_lens, prompts, prompt_lens, stop_lens


@pytest.fixture(scope="module", params=[("valle", "int8"), ("valle", "model"),
                                        ("vallf", "int8"), ("vallf", "model")],
                ids=lambda p: "-".join(p))
def jax_run(request):
    variant, kv_dtype = request.param
    kw = dict(decoder_dim=64, nhead=4, num_layers=2, num_quantizers=Q, kv_cache_dtype=kv_dtype,
              model_name="VALL-F" if variant == "vallf" else "VALL-E")
    jcfg = JaxConfig(**kw)
    model = (JaxVALLF if variant == "vallf" else JaxVALLE)(jcfg)
    x, x_lens, prompts, prompt_lens, stop_lens = _inputs()
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda k: model.init(
        {"params": k, "stage": k}, jnp.asarray(x), jnp.asarray(x_lens), jnp.asarray(prompts),
        jnp.full((B,), P, jnp.int32), train_stage=0, deterministic=True,
        nar_stage=jnp.asarray(1)))(key)
    out = jax_generate(
        model, variables, jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(x_lens),
        jnp.asarray(prompts), jnp.asarray(prompt_lens), top_k=1, max_new_tokens=MAX_NEW,
        forbid_eos=True, stop_lens=jnp.asarray(stop_lens))
    variables = jax.tree.map(np.asarray, variables)
    return kw, variant, variables, np.asarray(out["codes"]), np.asarray(out["lengths"])


@pytest.mark.parametrize("ragged,attn_impl", [(True, "flash"), (False, "xla"), (True, "fused")])
def test_greedy_generate_matches_jax(jax_run, ragged, attn_impl):
    kw, variant, variables, want_codes, want_lens = jax_run
    cfg = ModelConfig(attn_impl=attn_impl, **kw)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables, cfg, variant, device="cpu"))
    x, x_lens, prompts, prompt_lens, stop_lens = (torch.from_numpy(a).long() for a in _inputs())
    out = generate(model, x, x_lens, prompts, prompt_lens, top_k=1, max_new_tokens=MAX_NEW,
                   forbid_eos=True, stop_lens=stop_lens, ragged_decode=ragged,
                   generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(out["lengths"].numpy(), want_lens)
    np.testing.assert_array_equal(out["codes"].numpy(), want_codes)


def test_generate_eos_stop_matches_jax():
    """Without ``forbid_eos`` or ``stop_lens`` a row stops on EOS or at 16x
    its text length; with prepend_bos and prefix mode 1 (prompt codebooks
    folded in up front).  A 4x larger EOS logit makes EOS fire early."""
    kw = dict(decoder_dim=64, nhead=4, num_layers=2, num_quantizers=Q,
              prepend_bos=True, prefix_mode=1)
    jcfg = JaxConfig(**kw)
    model = JaxVALLE(jcfg)
    x, x_lens, prompts, prompt_lens, _ = _inputs()
    x_lens = np.array([1, 1, 2, 1, 1], np.int32)  # 16x caps of 16-32 steps
    key = jax.random.PRNGKey(3)
    variables = jax.jit(lambda k: model.init(
        {"params": k, "stage": k}, jnp.asarray(x), jnp.asarray(x_lens), jnp.asarray(prompts),
        jnp.full((B,), P, jnp.int32), train_stage=0, deterministic=True,
        nar_stage=jnp.asarray(1)))(key)
    variables = jax.tree.map(np.asarray, variables)
    kern = variables["params"]["ar_predict_layer"]["kernel"].copy()
    kern[:, jcfg.eos_id] *= 4.0
    variables["params"]["ar_predict_layer"]["kernel"] = kern
    want = jax_generate(model, variables, jax.random.PRNGKey(1), jnp.asarray(x),
                        jnp.asarray(x_lens), jnp.asarray(prompts), jnp.asarray(prompt_lens),
                        top_k=1, max_new_tokens=40)

    cfg = ModelConfig(attn_impl="flash", **kw)
    port = get_model(cfg, device="cpu")
    port.load_state_dict(state_dict_from_jax(variables, cfg, "valle", device="cpu"))
    got = generate(port, *(torch.from_numpy(a).long() for a in (x, x_lens, prompts, prompt_lens)),
                   top_k=1, max_new_tokens=40, ragged_decode=True)
    np.testing.assert_array_equal(got["lengths"].numpy(), np.asarray(want["lengths"]))
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    assert np.asarray(want["lengths"]).min() < 40  # some row stopped before the budget
