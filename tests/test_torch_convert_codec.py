"""The port's EnCodec weight converter (``valle_tpu_torch/codec/convert.py``
and ``valle_tpu_torch.bin.convert_codec``) against the JAX package's, on a
seeded state dict in the transformers layout (``EncodecModel(EncodecConfig())``
with random codebooks, as ``tests/test_encodec_parity.py`` builds it), once
with the weight-norm pair ``parametrizations.weight.original0/1`` (the
layout transformers saves) and once with plain ``.weight`` tensors:

  - both converters give trees whose flattened arrays are bit-equal, with
    the same keys and dtypes;
  - both CLIs, from a ``.pt`` and from a ``.safetensors`` file, write
    ``.npz`` files with the same keys and bit-equal arrays;
  - the port's ``load_codec`` encodes a seeded 1 s wav to the same codes
    from the port's ``.npz`` as from the JAX CLI's.
"""

import sys

import numpy as np
import pytest
import torch

from valle_tpu.bin import convert_codec as jax_cli
from valle_tpu.codec.convert import convert_encodec_state_dict as jax_convert
from valle_tpu_torch.bin import convert_codec
from valle_tpu_torch.codec import load_codec
from valle_tpu_torch.codec.convert import convert_encodec_state_dict
from valle_tpu_torch.utils import flatten_tree


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state_dicts():
    """{"weight_norm": ..., "plain": ...} torch state dicts of one seeded model."""
    from torch.nn.utils import parametrize
    from transformers import EncodecConfig, EncodecModel

    torch.manual_seed(0)
    hf = EncodecModel(EncodecConfig()).eval()
    with torch.no_grad():
        for layer in hf.quantizer.layers:
            layer.codebook.embed.normal_()
    out = {"weight_norm": {k: v.detach().clone() for k, v in hf.state_dict().items()}}
    assert any(k.endswith("parametrizations.weight.original0") for k in out["weight_norm"])
    for m in hf.modules():
        if parametrize.is_parametrized(m, "weight"):
            parametrize.remove_parametrizations(m, "weight")
    out["plain"] = {k: v.detach().clone() for k, v in hf.state_dict().items()}
    assert not any("parametrizations" in k for k in out["plain"])
    return out


def _assert_same_flat(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("layout", ["weight_norm", "plain"])
def test_converters_agree(state_dicts, layout):
    sd = {k: v.numpy() for k, v in state_dicts[layout].items()}
    want = jax_cli.flatten(jax_convert(sd))
    _assert_same_flat(flatten_tree(convert_encodec_state_dict(sd)), want)
    if layout == "plain":  # the folded weight norm gives the plain weights
        folded = {k: v.numpy() for k, v in state_dicts["weight_norm"].items()}
        got = flatten_tree(convert_encodec_state_dict(folded))
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def npz_files(state_dicts, tmp_path_factory):
    from safetensors.torch import save_file

    root = tmp_path_factory.mktemp("convert")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for layout, sd in state_dicts.items():
            for suffix in (".pt", ".safetensors"):
                src = root / f"{layout}{suffix}"
                if suffix == ".pt":
                    torch.save({"state_dict": sd}, src)
                else:
                    save_file({k: v.contiguous() for k, v in sd.items()}, str(src))
                jax_npz, port_npz = root / f"jax_{src.name}.npz", root / f"port_{src.name}.npz"
                mp.setattr(sys, "argv", ["convert_codec", "--input", str(src),
                                         "--output", str(jax_npz)])
                jax_cli.main()
                convert_codec.main(["--input", str(src), "--output", str(port_npz)])
                out[layout, suffix] = (jax_npz, port_npz)
    return out


@pytest.mark.parametrize("suffix", [".pt", ".safetensors"])
@pytest.mark.parametrize("layout", ["weight_norm", "plain"])
def test_clis_write_the_same_npz(npz_files, layout, suffix):
    jax_npz, port_npz = npz_files[layout, suffix]
    with np.load(jax_npz) as w, np.load(port_npz) as g:
        _assert_same_flat({k: g[k] for k in g.files}, {k: w[k] for k in w.files})


def test_port_codec_encodes_the_same_codes_from_both_npz(npz_files):
    jax_npz, port_npz = npz_files["weight_norm", ".safetensors"]
    wav = (0.3 * np.random.RandomState(4).randn(1, 1, 24000)).astype(np.float32)
    want = load_codec(jax_npz, device="cpu").encode(wav)
    got = load_codec(port_npz, device="cpu").encode(wav)
    assert got.shape == (1, 75, 8)
    assert torch.equal(got, want)
