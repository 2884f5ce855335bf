"""The port's serve CLI (``valle_tpu_torch.bin.serve``) against the JAX
package's (``valle_tpu.bin.serve``) on the CPU.

Both CLIs get the same TSV (prompted and promptless rows, two length
buckets, texts that fill more than one batch), the same tiny VALL-E
checkpoint (d=64, 4 heads, 2 layers, Q=8, the flax init of
``tests/test_infer_cli.py``, as an ``.npz``) and the same stand-in codec
(seeded codes, silent wavs), in f32 with ``--top-k 1`` and the serving
default int8 KV cache: the manifests (ids, frames, buckets, in order) and
every ``*_codes.npy`` are equal unquantized; with ``--quantize-weights
w8a8`` the manifests are equal and at least 97% of the codes (an activation
within f32 rounding of a rounding boundary of its int8 quantization takes the
other int8 value in one package, and this tiny random model's logits are
nearly flat: 4 of 1,280 codes differed, none of them an AR token).  Also
the port's copies of ``_quantize_batch``, ``read_requests``' validation and
``encode_prompts``' grouping, and the refusal of a batch size that does not
split over ``--data-parallel``.
"""

import json
import sys

import numpy as np
import pytest
import torch

from tests.test_infer_cli import _FakeCodec, _char_symbols, _save_tiny_checkpoint, Q
from valle_tpu.bin import serve as jax_serve
from valle_tpu_torch.bin import serve

TEXTS = {"short": "hi", "longer": "hello world test hello world", "noprompt": "test hello",
         "mid": "hello test", "wide": "world hello test", "tiny": "ho"}
W8A8_CODE_MATCH = 0.97
PROMPTED = {"short", "longer", "mid", "wide", "tiny"}
DIMS = ["--decoder-dim", "64", "--nhead", "4", "--num-decoder-layers", "2",
        "--num-quantizers", str(Q)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _TorchFakeCodec(_FakeCodec):
    """``_FakeCodec``'s codes and silent wavs as torch tensors."""

    def encode(self, wav):
        return torch.from_numpy(np.asarray(super().encode(wav))).long()

    def decode(self, codes, out_int16=False):
        return torch.from_numpy(np.asarray(super().decode(np.asarray(codes), out_int16)))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    wav = root / "p.wav"
    wav.write_bytes(b"")
    reqs = root / "reqs.tsv"
    reqs.write_text("# comment line ignored\n" + "".join(
        f"{rid}\t{text}\t{wav if rid in PROMPTED else '-'}\t-\n" for rid, text in TEXTS.items()))
    return {"ckpt": str(_save_tiny_checkpoint(root)),
            "symbols": str(_char_symbols(root, " ".join(TEXTS.values()))),
            "reqs": str(reqs), "root": root}


def _argv(files, out_dir, extra=()):
    return ["--requests", files["reqs"], "--checkpoint", files["ckpt"], "--text-tokens",
            files["symbols"], "--text-extractor", "chars", "--codec-checkpoint", "fake.npz",
            "--output-dir", str(out_dir), "--batch-size", "4", "--length-buckets", "16,32",
            "--frames-per-phoneme", "4", "--top-k", "1", "--dtype", "float32", *DIMS, *extra]


# the w8a8 runs take one bucket (one JAX compile of generate fewer)
RUNS = {"plain": (), "w8a8": ("--quantize-weights", "w8a8", "--length-buckets", "32")}


def _patch_io(mp, module, codec):
    mp.setattr(module, "load_codec", lambda path, **kw: codec)
    mp.setattr(module, "read_wav", lambda path: (np.zeros(24000, np.float32), 24000))
    mp.setattr(module, "convert_audio", lambda w, sr, tsr, ch: w)


def _manifest(out_dir):
    return [json.loads(line) for line in (out_dir / "manifest.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def jax_outputs(files):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _patch_io(mp, jax_serve, _FakeCodec())
        for name, extra in RUNS.items():
            out[name] = files["root"] / f"jax_{name}"
            mp.setattr(sys, "argv", ["serve"] + _argv(files, out[name], extra))
            jax_serve.main()
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_serve_writes_what_jax_writes(files, jax_outputs, tmp_path, monkeypatch, name):
    _patch_io(monkeypatch, serve, _TorchFakeCodec())
    serve.main(_argv(files, tmp_path, RUNS[name]) + ["--device", "cpu"])
    want, got = _manifest(jax_outputs[name]), _manifest(tmp_path)
    assert [m["id"] for m in got] == [m["id"] for m in want]
    assert got == want
    by_id = {m["id"]: m for m in got}
    if name == "plain":
        assert by_id["short"]["bucket"] == 16 and by_id["longer"]["bucket"] == 32
    same = []
    for m in got:
        codes = np.load(tmp_path / f"{m['id']}_codes.npy")
        want_codes = np.load(jax_outputs[name] / f"{m['id']}_codes.npy")
        assert codes.shape == want_codes.shape == (m["frames"], Q) and m["frames"] <= m["bucket"]
        assert codes.dtype == want_codes.dtype
        if name == "plain":
            np.testing.assert_array_equal(codes, want_codes)
        same.append(codes == want_codes)
        assert (tmp_path / f"{m['id']}.wav").exists() == (m["frames"] > 0)
    assert np.concatenate(same).mean() >= W8A8_CODE_MATCH


def test_quantize_batch():
    assert serve._quantize_batch(1, 256) == 8
    assert serve._quantize_batch(8, 256) == 8
    assert serve._quantize_batch(9, 256) == 16
    assert serve._quantize_batch(100, 256) == 128
    assert serve._quantize_batch(200, 256) == 256
    assert serve._quantize_batch(256, 256) == 256
    assert serve._quantize_batch(300, 256) == 256  # capped at --batch-size
    assert serve._quantize_batch(20, 16) == 16


def test_read_requests_validation(tmp_path):
    good = tmp_path / "good.tsv"
    good.write_text("# comment\nr1\thello\n\nr2\tworld\tp.wav\tptext\n")
    rows = serve.read_requests(str(good))
    assert [r["id"] for r in rows] == ["r1", "r2"]
    assert rows[1]["wav"] == "p.wav" and rows[1]["ptext"] == "ptext"
    bad = tmp_path / "bad.tsv"
    bad.write_text("r1\thello\njust-one-field\n")
    with pytest.raises(ValueError, match="bad.tsv:2"):
        serve.read_requests(str(bad))


def test_encode_prompts_batched_groups(monkeypatch):
    """Prompts of at least 3 s truncate to the 225-frame cap and encode in
    one batch; a shorter one is its own group; a promptless row gets none."""
    calls = []

    class Codec(_TorchFakeCodec):
        def encode(self, wav):
            calls.append(wav.shape)
            return super().encode(wav)

    reqs = [{"wav": "a.wav"}, {"wav": "b.wav"}, {"wav": ""}, {"wav": "c.wav"},
            {"wav": "short.wav"}]
    lengths = {"a.wav": 24000 * 4, "b.wav": 24000 * 4, "c.wav": 24000 * 5, "short.wav": 12000}
    monkeypatch.setattr(serve, "read_wav", lambda p: (np.zeros((1, lengths[p]), np.float32),
                                                      24000))
    monkeypatch.setattr(serve, "convert_audio", lambda w, sr, tsr, ch: w)
    serve.encode_prompts(reqs, Codec(), pcap=225, encode_batch=64)
    assert sorted(calls) == [(1, 1, 12000), (3, 1, 225 * 320)]
    assert reqs[0]["prompt"].shape == (225, Q)
    assert "prompt" not in reqs[2]
    assert reqs[4]["prompt"].shape[0] <= 225


def test_parallel_flags_are_refused(files, tmp_path):
    """A batch size that does not split over the data shards is refused
    before any rank starts (data- and tensor-parallel serving itself:
    tests/test_torch_sharded_generate.py)."""
    with pytest.raises(ValueError, match="divide by --data-parallel"):
        serve.main(_argv(files, tmp_path, ("--data-parallel", "3")) + ["--device", "cpu"])
    assert not (tmp_path / "manifest.jsonl").exists()
