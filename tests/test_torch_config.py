"""The port's ModelConfig, macros and CLI surface against the JAX package's."""

import argparse
import dataclasses

import jax.numpy as jnp
import pytest
import torch

from valle_tpu import macros as jax_macros
from valle_tpu.models import add_model_arguments as jax_add_model_arguments
from valle_tpu.models import config_from_args as jax_config_from_args
from valle_tpu.models.config import ModelConfig as JaxConfig
from valle_tpu_torch import macros
from valle_tpu_torch.models import add_model_arguments, config_from_args, get_model
from valle_tpu_torch.models.config import ModelConfig


def test_field_sets_and_defaults_equal():
    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name: f.default for f in dataclasses.fields(ModelConfig)}
    assert jax_fields == port_fields


@pytest.mark.parametrize("kw", [{}, {"nar_scale_factor": 0.5, "decoder_dim": 64, "nhead": 4},
                                {"num_audio_tokens": 100, "prepend_bos": True}])
def test_derived_properties_equal(kw):
    j, p = JaxConfig(**kw), ModelConfig(**kw)
    for name in ("nar_decoder_dim", "nar_nhead", "nar_num_layers", "eos_id", "bos_id"):
        assert getattr(j, name) == getattr(p, name), name
    assert dataclasses.asdict(j.replace(dtype="bfloat16")) == dataclasses.asdict(
        p.replace(dtype="bfloat16"))


def test_compute_dtype_is_a_torch_dtype():
    assert JaxConfig().compute_dtype == jnp.float32
    assert ModelConfig().compute_dtype is torch.float32
    assert ModelConfig(dtype="bfloat16").compute_dtype is torch.bfloat16


@pytest.mark.parametrize("kw", [{"kv_cache_dtype": "fp8"}, {"attn_impl": "sdpa"},
                                {"dtype": "float16"}, {"remat": "some"}])
def test_validation_matches(kw):
    with pytest.raises(ValueError):
        JaxConfig(**kw)
    with pytest.raises(ValueError):
        ModelConfig(**kw)


def test_remat_bool_normalised_like_jax():
    assert ModelConfig(remat=True).remat == JaxConfig(remat=True).remat == "full"


def test_macros_equal():
    names = [n for n in dir(jax_macros) if n.isupper()]
    assert names == [n for n in dir(macros) if n.isupper()]
    for n in names:
        assert getattr(jax_macros, n) == getattr(macros, n), n


def test_cli_arguments_give_equal_configs():
    argv = ["--decoder-dim", "64", "--nhead", "4", "--num-decoder-layers", "2",
            "--model-name", "VALL-F", "--prefix-mode", "2", "--prepend-bos", "true",
            "--attn-impl", "flash", "--kv-cache-dtype", "int8", "--remat", "full"]
    pj, pp = argparse.ArgumentParser(), argparse.ArgumentParser()
    jax_add_model_arguments(pj)
    add_model_arguments(pp)
    cj = jax_config_from_args(pj.parse_args(argv))
    cp = config_from_args(pp.parse_args(argv))
    assert dataclasses.asdict(cj) == dataclasses.asdict(cp)


def test_get_model_variants_and_unported_options():
    assert get_model(ModelConfig(decoder_dim=32, nhead=2, num_layers=1, num_quantizers=2),
                     device="cpu").variant == "valle"
    cfg_f = ModelConfig(model_name="VALL-F", decoder_dim=32, nhead=2, num_layers=1,
                        num_quantizers=2)
    model = get_model(cfg_f, device="cpu")
    assert model.variant == "vallf" and not model.training
    tts = get_model(ModelConfig(model_name="Transformer", decoder_dim=32, nhead=2,
                                num_layers=1), device="cpu")
    assert type(tts).__name__ == "TransformerTTS" and not tts.training
    # scaling_xformers builds the Transformer's scaling variant, and VALL-E
    # ignores it, as the JAX models do
    sx = get_model(ModelConfig(model_name="Transformer", decoder_dim=32, nhead=2, num_layers=1,
                               scaling_xformers=True), device="cpu")
    assert hasattr(sx, "decoder_prenet_fc") and sx.encoder.layers[0].activation == \
        "balanced_double_swish"
    small = dict(decoder_dim=32, nhead=2, num_layers=1, num_quantizers=2)
    torch.manual_seed(0)
    with_flag = get_model(ModelConfig(scaling_xformers=True, **small), device="cpu")
    torch.manual_seed(0)
    without = get_model(ModelConfig(**small), device="cpu")
    assert with_flag.variant == "valle"
    want = without.state_dict()
    assert all(torch.equal(t, want[k]) for k, t in with_flag.state_dict().items())
    # act_quant (W8A8) is ported: on float weights it builds and changes nothing
    w8a8 = get_model(ModelConfig(act_quant=True, decoder_dim=32, nhead=2, num_layers=1),
                     device="cpu")
    assert w8a8.ar_predict_layer.act_quant and w8a8.ar_predict_layer.weight_scale is None
