"""Data- and tensor-parallel generation of the port over gloo on the CPU,
the counterpart of ``tests/test_sharded_generate.py``, with the weights of
a seeded JAX VALL-E bridged into the port (d=64, 4 heads, 2 layers, Q=8,
int8 KV cache, greedy, EOS forbidden, kernel 1's decode reads):

  - D=2 (two rank processes, ``tests/torch_ranks.py``), f32: each rank
    generates its half of the rows; the gathered codes and lengths equal
    JAX's unsharded ``generate``;
  - D=2 x T=2 with W8A8 weights (four ranks): the heads and FFN features
    split over each data shard's two ranks; the gathered prefill logits are
    bit-equal to the port's unsharded W8A8 run (the row amax is a MAX over
    the shard and the int32 sums are summed before the scales, so every
    int8 product is exact) and the codes equal it;
  - the serve CLI at ``--data-parallel 2 --device cpu`` (which starts its
    two ranks itself) writes the manifest and codes of
    ``--data-parallel 1``, and refuses a tensor-parallel size that does not
    split the heads.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_infer_cli import _char_symbols, _save_tiny_checkpoint
from tests.torch_ranks import (GEN_KW, MAX_NEW, gen_inputs, gen_model, gen_result, run_ranks)
from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu.sample import generate as jax_generate
from valle_tpu_torch.bin import serve
from valle_tpu_torch.models import ModelConfig
from valle_tpu_torch.utils.bridge import state_dict_from_jax

JAX_KW = {k: GEN_KW[k] for k in ("decoder_dim", "nhead", "num_layers", "num_quantizers",
                                 "kv_cache_dtype")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's unsharded greedy generate, and its weights as a port state
    dict file."""
    model = JaxVALLE(JaxConfig(**JAX_KW))
    inputs = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in gen_inputs().items()}
    b, p, q = inputs["prompt_codes"].shape
    variables = jax.jit(lambda k: model.init(
        {"params": k, "stage": k}, inputs["x"], inputs["x_lens"], inputs["prompt_codes"],
        jnp.full((b,), p, jnp.int32), train_stage=0, deterministic=True,
        nar_stage=jnp.asarray(2)))(jax.random.PRNGKey(0))
    out = jax_generate(model, variables, jax.random.PRNGKey(7), inputs["x"], inputs["x_lens"],
                       inputs["prompt_codes"], inputs["prompt_lens"], top_k=1,
                       max_new_tokens=MAX_NEW, forbid_eos=True)
    path = tmp_path_factory.mktemp("weights") / "valle.pt"
    torch.save(state_dict_from_jax(jax.tree.map(np.asarray, variables),
                                   ModelConfig(**GEN_KW), device="cpu"), path)
    return str(path), np.asarray(out["codes"]), np.asarray(out["lengths"])


def test_data_parallel_greedy_codes_equal_jax(jax_run, tmp_path):
    weights, want_codes, want_lens = jax_run
    run_ranks("generate_job", 2, tmp_path, weights, 2, 1, 0)
    got = torch.load(tmp_path / "generate_2x1.pt")
    np.testing.assert_array_equal(got["lengths"].numpy(), want_lens)
    np.testing.assert_array_equal(got["codes"].numpy(), want_codes)


def test_data_and_tensor_parallel_w8a8_equals_one_rank(jax_run, tmp_path):
    weights = jax_run[0]
    run_ranks("generate_job", 4, tmp_path, weights, 2, 2, 1)
    got = torch.load(tmp_path / "generate_2x2.pt")
    want = gen_result(gen_model(weights, w8a8=True), gen_inputs(), ragged=True)
    assert torch.equal(got["logits"], want["logits"])
    assert torch.equal(got["lengths"], want["lengths"])
    assert torch.equal(got["codes"], want["codes"])


TEXTS = {"a": "hi there", "b": "hello world test", "c": "test hello", "d": "world",
         "e": "hello test", "f": "ho ho ho"}


@pytest.fixture(scope="module")
def serve_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    reqs = root / "reqs.tsv"
    reqs.write_text("".join(f"{rid}\t{text}\n" for rid, text in TEXTS.items()))
    return {"ckpt": str(_save_tiny_checkpoint(root)),
            "symbols": str(_char_symbols(root, " ".join(TEXTS.values()))), "reqs": str(reqs)}


def _serve_argv(files, out_dir, *extra):
    return ["--requests", files["reqs"], "--checkpoint", files["ckpt"], "--text-tokens",
            files["symbols"], "--text-extractor", "chars", "--output-dir", str(out_dir),
            "--batch-size", "4", "--length-buckets", "16,32", "--frames-per-phoneme", "1.5",
            "--top-k", "1", "--dtype", "float32", "--decoder-dim", "64", "--nhead", "4",
            "--num-decoder-layers", "2", "--num-quantizers", "8", "--device", "cpu", *extra]


def test_serve_cli_data_parallel_writes_what_one_rank_writes(serve_files, tmp_path,
                                                             monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the ranks' torch threads
    serve.main(_serve_argv(serve_files, tmp_path / "one"))
    serve.main(_serve_argv(serve_files, tmp_path / "two", "--data-parallel", "2"))
    manifests = [[json.loads(line) for line in (tmp_path / d / "manifest.jsonl").read_text()
                  .splitlines()] for d in ("one", "two")]
    assert manifests[0] == manifests[1] and len(manifests[0]) == len(TEXTS)
    assert {m["bucket"] for m in manifests[0]} == {16, 32}
    for m in manifests[0]:
        a, b = (np.load(tmp_path / d / f"{m['id']}_codes.npy") for d in ("one", "two"))
        np.testing.assert_array_equal(a, b)
    with pytest.raises(Exception, match="split over 3"):
        serve.main(_serve_argv(serve_files, tmp_path / "three", "--tensor-parallel", "3"))
