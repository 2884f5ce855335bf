"""The weight bridge (``valle_tpu_torch/utils/bridge.py``): a reference-keyed
numpy state_dict goes through the JAX package's ``convert_state_dict`` and
back through the bridge, and must come out equal; the result loads strictly
into the port's model, so its key set is exactly the port's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu.utils.convert_reference import convert_state_dict
from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.utils.bridge import numpy_state_dict_from_jax, state_dict_from_jax

KW = dict(decoder_dim=32, nhead=4, num_layers=2, num_quantizers=4)
PRENET = ("ar_text_prenet", "ar_audio_prenet", "nar_text_prenet", "nar_audio_prenet")


def _reference_sd(cfg, seed=0):
    """Random values under the port's (= the reference's) keys, as numpy.
    Tied weights share one array; the NAR position alphas are fixed at 1."""
    model = get_model(cfg, device="cpu")
    rng = np.random.RandomState(seed)
    sd, seen = {}, {}
    for key, t in model.state_dict().items():
        if key.startswith(PRENET):
            continue
        ptr = t.data_ptr()
        if ptr not in seen:
            seen[ptr] = rng.randn(*t.shape).astype(np.float32)
        sd[key] = seen[ptr]
    sd["nar_text_position.alpha"] = np.ones((1,), np.float32)
    sd["nar_audio_position.alpha"] = np.ones((1,), np.float32)
    return sd


@pytest.mark.parametrize("variant", ["valle", "vallf"])
@pytest.mark.parametrize("share", [True, False])
@pytest.mark.parametrize("norm_first", [True, False])
def test_round_trip_reference_keys(variant, share, norm_first):
    cfg = ModelConfig(share_embedding=share, norm_first=norm_first,
                      model_name="VALL-F" if variant == "vallf" else "VALL-E", **KW)
    sd = _reference_sd(cfg)
    params = convert_state_dict(sd, JaxConfig(**{k: getattr(cfg, k) for k in (
        "share_embedding", "norm_first", "model_name", *KW)}), variant)
    back = numpy_state_dict_from_jax(params, cfg, variant)
    assert set(back) == set(sd)
    for key in sd:
        np.testing.assert_array_equal(back[key], sd[key], err_msg=key)
    model = get_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(params, cfg, variant, device="cpu"), strict=True)
    if share:  # tying survives loading: one tensor, two names
        assert model.nar_predict_layers[0].weight is model.nar_audio_embeddings[2].weight


def test_prenets_map_onto_the_reference_sequential_indices():
    """With prenets the JAX init carries Conv / BatchNorm / Dense subtrees and
    BatchNorm statistics that ``convert_state_dict`` does not cover; the
    bridge maps them onto the reference's nn.Sequential indices, and the
    rest of the tree still round-trips through ``convert_state_dict``."""
    cfg = ModelConfig(add_prenet=True, **KW)
    jcfg = JaxConfig(add_prenet=True, **KW)
    x = jnp.ones((2, 5), jnp.int32)
    y = jnp.ones((2, 6, 4), jnp.int32)
    lens = jnp.asarray([5, 4])
    shapes = jax.eval_shape(lambda k: JaxVALLE(jcfg).init(
        {"params": k, "stage": k}, x, lens, y, lens, train_stage=0, deterministic=True,
        nar_stage=jnp.asarray(1)), jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    variables = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    sd = _reference_sd(cfg, seed=2)
    params = dict(convert_state_dict(sd, jcfg, "valle"))
    params.update({k: variables["params"][k] for k in PRENET})
    back = numpy_state_dict_from_jax({"params": params, "batch_stats": variables["batch_stats"]},
                                     cfg, "valle")
    for key in sd:
        np.testing.assert_array_equal(back[key], sd[key], err_msg=key)
    conv0 = variables["params"]["ar_text_prenet"]["conv0"]["kernel"]  # (5, in, out)
    np.testing.assert_array_equal(back["ar_text_prenet.1.weight"], conv0.transpose(2, 1, 0))
    np.testing.assert_array_equal(back["nar_text_prenet.10.running_var"],
                                  variables["batch_stats"]["nar_text_prenet"]["bn2"]["var"])
    np.testing.assert_array_equal(back["ar_audio_prenet.6.weight"],
                                  variables["params"]["ar_audio_prenet"]["fc3"]["kernel"].T)
    model = get_model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in back.items()}, strict=True)


def test_vallf_cross_attention_is_repacked():
    cfg = ModelConfig(model_name="VALL-F", **KW)
    sd = _reference_sd(cfg, seed=3)
    params = convert_state_dict(sd, JaxConfig(model_name="VALL-F", **KW), "vallf")
    q_kernel = params["ar_decoder"]["layers"]["cross_attn"]["q_proj"]["kernel"][1]
    back = numpy_state_dict_from_jax(params, cfg, "vallf")
    np.testing.assert_array_equal(back["ar_decoder.layers.1.multihead_attn.in_proj_weight"][:32],
                                  q_kernel.T)
