"""Reference-layout ``.pt`` key selection (``utils/convert_reference.py``)
against the JAX package's ``convert_state_dict``.

A seeded reference-layout state dict is built in the test for VALL-E (with
and without ``share_embedding``) and VALL-F: the port's model keys (which
are the reference's names) with seeded weights, plus keys that the JAX
conversion skips: extra keys, and with ``share_embedding`` tied NAR heads
whose values differ from the tables they are tied to.  The port's selection
loads into the port's model, which then computes the same losses (AR, and
NAR at a tied and at the last head) as the JAX model given
``convert_state_dict``'s tree, within rtol 1e-5 (f32, summation order).  The
infer CLI's ``load_model_params`` takes such a ``.pt``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import VALLF as JaxVALLF
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu.utils.convert_reference import convert_state_dict
from valle_tpu_torch.bin.infer import load_model_params
from valle_tpu_torch.models import VALLE, VALLF, ModelConfig, get_model
from valle_tpu_torch.utils.convert_reference import model_keys, select_state_dict

B, S, T, Q = 2, 6, 10, 4
EXTRA = ("ar_decoder.layers.0.self_attn.extra_buffer", "criterion.weight", "step_count")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data():
    rng = np.random.RandomState(0)
    x = rng.randint(1, 512, (B, S)).astype(np.int32)
    y = rng.randint(0, 1024, (B, T, Q)).astype(np.int32)
    return x, np.array([6, 4], np.int32), y, np.array([10, 7], np.int32)


def _reference_sd(cfg, variant):
    """Seeded weights under every key of the model, plus what the JAX
    conversion skips."""
    rng = np.random.RandomState(3)
    sd = {}
    with torch.device("meta"):
        model = (VALLF if variant == "vallf" else VALLE)(cfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    for k, shape in shapes.items():
        v = rng.randn(*shape).astype(np.float32)
        if k.endswith("alpha"):
            v = np.ones(shape, np.float32)
        elif k.endswith(("norm1.weight", "norm2.weight", "norm3.weight", "norm.weight")):
            v = 1.0 + 0.1 * v
        elif "embedding" not in k:
            v = 0.1 * v
        sd[k] = v
    for k in EXTRA:
        sd[k] = rng.randn(3).astype(np.float32)
    return sd


@pytest.mark.parametrize("model_name,share", [("VALL-E", True), ("VALL-E", False),
                                              ("VALL-F", True)])
def test_selection_loads_and_matches_convert_state_dict(model_name, share, tmp_path):
    variant = "vallf" if model_name == "VALL-F" else "valle"
    kw = dict(model_name=model_name, decoder_dim=32, nhead=4, num_layers=2, num_quantizers=Q,
              share_embedding=share)
    cfg = ModelConfig(**kw)
    sd = _reference_sd(cfg, variant)
    for j in range(Q - 2 if share else 0):  # a tied head's value in the file differs
        assert not np.array_equal(sd[f"nar_predict_layers.{j}.weight"],
                                  sd[f"nar_audio_embeddings.{j + 2}.word_embeddings.weight"])

    got = select_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, cfg, variant)
    assert set(got) == set(model_keys(cfg, variant))
    assert not set(EXTRA) & set(got)
    for j in range(Q - 2 if share else 0):
        np.testing.assert_array_equal(
            got[f"nar_predict_layers.{j}.weight"].numpy(),
            sd[f"nar_audio_embeddings.{j + 2}.word_embeddings.weight"])
    port = get_model(cfg, device="cpu", state_dict=got)

    jmodel = (JaxVALLF if variant == "vallf" else JaxVALLE)(JaxConfig(**kw))
    params = convert_state_dict(sd, JaxConfig(**kw), variant)
    data = tuple(jnp.asarray(a) for a in _data())

    def losses(p, stage):
        out = jmodel.apply({"params": p}, *data, train_stage=0, deterministic=True,
                           nar_stage=stage)
        return out["ar_loss"], out["nar_loss"]

    run = jax.jit(losses)
    tensors = tuple(torch.from_numpy(a) for a in _data())
    for stage in (1, Q - 1):  # a tied head (with share_embedding) and the last one
        want_ar, want_nar = run(params, jnp.asarray(stage))
        with torch.no_grad():
            out = port(*tensors, train_stage=0, nar_stage=stage)
        np.testing.assert_allclose(float(out["ar_loss"]), float(want_ar), rtol=1e-5)
        np.testing.assert_allclose(float(out["nar_loss"]), float(want_nar), rtol=1e-5)

    # the infer CLI's .pt route takes the file with its extra keys
    path = tmp_path / "reference.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "epoch": 3}, path)
    loaded = load_model_params(str(path), cfg, variant)
    assert set(loaded) == set(got)
    assert all(torch.equal(loaded[k], got[k]) for k in got)


def test_selection_names_missing_keys():
    cfg = ModelConfig(decoder_dim=32, nhead=4, num_layers=1, num_quantizers=2)
    sd = {k: torch.zeros(1) for k in model_keys(cfg, "valle") if "ar_predict" not in k}
    with pytest.raises(KeyError, match="ar_predict_layer.weight"):
        select_state_dict(sd, cfg)
