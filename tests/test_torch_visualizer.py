"""The eval visualizer of the port against the JAX package's:

  - ``visualize_forward`` of VALL-E and VALL-F (the text embedding and the
    AR decoder's output over the audio region) against JAX's, within 1e-5
    (f32, summation order), with the JAX init bridged in; the port under
    ``"flash"``, where the merged dense bias goes to kernel 4's plain
    version, and JAX on ``"xla"``;
  - ``models/visualizer.py::visualize`` writes the same file names as JAX's
    on the same arrays;
  - the train CLI with ``--visualize true`` writes the first validation
    batch's PNGs under ``exp_dir/eval/<tag>`` at each validation.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_corpus import write_corpus
from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import VALLF as JaxVALLF
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu.models.visualizer import visualize as jax_visualize
from valle_tpu_torch.bin import train
from valle_tpu_torch.data import CodeShardWriter, Manifest, SymbolTable
from valle_tpu_torch.models import ModelConfig, get_model
from valle_tpu_torch.models.visualizer import visualize
from valle_tpu_torch.utils.bridge import state_dict_from_jax

B, S, T, Q = 3, 7, 12, 3
KW = dict(decoder_dim=32, nhead=4, num_layers=2, num_quantizers=Q)


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
    return x, np.array([7, 5, 3], np.int32), y, np.array([12, 9, 6], np.int32)


@pytest.mark.parametrize("model_name,prepend_bos", [("VALL-E", False), ("VALL-E", True),
                                                    ("VALL-F", False)])
def test_visualize_forward_matches_jax(model_name, prepend_bos):
    kw = dict(KW, model_name=model_name, prepend_bos=prepend_bos)
    model = (JaxVALLF if model_name == "VALL-F" else JaxVALLE)(JaxConfig(**kw))
    data = tuple(jnp.asarray(a) for a in _data())

    def run(k):
        variables = model.init({"params": k, "stage": k}, *data, train_stage=0,
                               deterministic=True, nar_stage=jnp.asarray(1))
        return variables, model.apply(variables, *data, method="visualize_forward")

    variables, (enc, dec) = jax.jit(run)(jax.random.PRNGKey(0))
    cfg = ModelConfig(attn_impl="flash", **kw)
    port = get_model(cfg, device="cpu")
    variant = "vallf" if model_name == "VALL-F" else "valle"
    port.load_state_dict(state_dict_from_jax(jax.tree.map(np.array, variables), cfg, variant,
                                             device="cpu"))
    port.train()  # visualize_forward is deterministic in either mode
    got_enc, got_dec = port.visualize_forward(*(torch.from_numpy(a) for a in _data()))
    assert port.training
    assert got_dec.shape == dec.shape == (B, T + int(prepend_bos), KW["decoder_dim"])
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(enc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_dec.numpy(), np.asarray(dec), rtol=0,
                               atol=1e-5 * float(np.abs(dec).max()))


def test_visualize_writes_the_jax_file_names(tmp_path):
    rng = np.random.RandomState(1)
    x, x_lens, y, y_lens = _data()
    batch = {"text_tokens": x, "text_tokens_lens": x_lens, "audio_features": y,
             "audio_features_lens": y_lens, "utt_id": ["a-1", "b-2", "c-3"],
             "text": ["one", "two", "three"]}
    predicts = (rng.randn(B, S, 8).astype(np.float32), rng.randn(B, T, 8).astype(np.float32))
    visualize(predicts, batch, str(tmp_path / "port"), limit=2)
    jax_visualize(predicts, batch, str(tmp_path / "jax"), limit=2)
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == ["a-1.png", "b-2.png"]
    assert all((tmp_path / "port" / n).stat().st_size > 0 for n in names)


def test_train_cli_visualize_writes_pngs(tmp_path):
    corpus = write_corpus(tmp_path / "corpus", writer_cls=CodeShardWriter, manifest_cls=Manifest,
                          table_cls=SymbolTable, splits=(("train", 8), ("dev", 3)))
    exp = tmp_path / "exp"
    summary = train.main([
        "--manifest-dir", str(corpus), "--exp-dir", str(exp), "--decoder-dim", "32", "--nhead",
        "4", "--num-decoder-layers", "1", "--tensorboard", "false", "--device", "cpu",
        "--num-epochs", "1", "--oom-check", "false", "--valid-interval", "2",
        "--max-duration", "4", "--visualize", "true", "--attn-impl", "flash"])
    tags = sorted(os.listdir(exp / "eval"))
    steps = [v["step"] for v in summary["validations"]]
    assert steps and tags == sorted([f"step-{n}" for n in steps] + ["epoch-1"])
    for tag in tags:
        pngs = sorted(os.listdir(exp / "eval" / tag))
        assert pngs and all(p.endswith(".png") for p in pngs), (tag, pngs)
        assert len(pngs) <= 4
    dev = Manifest.load(corpus / "manifest_dev.jsonl.gz")
    ids = {r["id"] for r in dev.records}
    assert {p[:-len(".png")] for p in os.listdir(exp / "eval" / "epoch-1")} <= ids
