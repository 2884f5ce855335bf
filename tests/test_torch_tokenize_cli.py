"""The port's data-side CLIs (``valle_tpu_torch.bin.tokenize_dataset`` and
``.stats``) against the JAX package's, in process on the CPU, on one TSV of
6 seeded wavs (0.3-1.0 s, at 16 and 24 kHz) with texts through the
``chars`` frontend:

  - Encodec mode with a seeded full-width codec ``.npz`` and
    ``--batch-frames 4`` (one full batch and one partial): the manifests
    equal record for record, the codes equal, the symbol tables equal;
  - Fbank mode: the manifests equal, the float16 features within one
    float16 ulp of JAX's (the same numpy arithmetic, rounded once), and the
    symbol tables equal, also after a ``dev`` split with new characters
    extends them;
  - the ``stats`` CLI prints the same text for both output directories;
  - ``--device cuda`` raises without CUDA.
"""

import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from valle_tpu.bin import stats as jax_stats
from valle_tpu.bin import tokenize_dataset as jax_tokenize
from valle_tpu_torch.bin import stats, tokenize_dataset
from valle_tpu_torch.codec import random_codec_params, save_codec_npz
from valle_tpu_torch.data import Manifest

TEXTS = ["the quick brown fox", "jumps over", "the lazy dog", "a b c", "hello there",
         "one more line of text"]
DEV_TEXTS = ["zig zag 7", "quiz, wax!"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tsv(root, name, texts, seed):
    rng = np.random.RandomState(seed)
    lines = []
    for i, text in enumerate(texts):
        sr = (16000, 24000)[i % 2]
        wav = (0.3 * rng.randn(int(rng.uniform(0.3, 1.0) * sr))).clip(-1, 1)
        path = root / f"{name}_{i}.wav"
        wavfile.write(path, sr, (wav * 32767).astype(np.int16))
        lines.append(f"{name}_{i}\t{path}\t{text}")
    tsv = root / f"{name}.tsv"
    tsv.write_text("\n".join(lines) + "\n")
    return tsv


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both CLIs' output directories: ``encodec`` (train split) and ``fbank``
    (train, then dev)."""
    root = tmp_path_factory.mktemp("tokenize")
    train_tsv, dev_tsv = _tsv(root, "train", TEXTS, 0), _tsv(root, "dev", DEV_TEXTS, 1)
    codec = root / "codec.npz"
    save_codec_npz(codec, random_codec_params(seed=3))
    common = ["--text-extractor", "chars"]
    calls = {
        "encodec": [["--tsv", str(train_tsv), "--split", "train", "--codec-checkpoint",
                     str(codec), "--batch-frames", "4"]],
        "fbank": [["--tsv", str(train_tsv), "--split", "train", "--audio-extractor", "Fbank"],
                  ["--tsv", str(dev_tsv), "--split", "dev", "--audio-extractor", "Fbank"]],
    }
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mode, argvs in calls.items():
            jax_dir, port_dir = root / f"jax_{mode}", root / f"port_{mode}"
            for argv in argvs:
                mp.setattr(sys, "argv", ["tokenize_dataset", *argv, *common, "--output-dir",
                                         str(jax_dir)])
                jax_tokenize.main()
                tokenize_dataset.main([*argv, *common, "--output-dir", str(port_dir),
                                       "--device", "cpu"])
            out[mode] = (jax_dir, port_dir)
    return out


def _records(d, split):
    return Manifest.load(d / f"manifest_{split}.jsonl.gz")


@pytest.mark.parametrize("mode", ["encodec", "fbank"])
def test_manifests_and_symbols_equal(runs, mode):
    jax_dir, port_dir = runs[mode]
    for split in ("train", "dev") if mode == "fbank" else ("train",):
        want, got = _records(jax_dir, split), _records(port_dir, split)
        assert got.records == want.records
        assert len(got) == len(TEXTS if split == "train" else DEV_TEXTS)
    table = "unique_text_tokens.k2symbols"
    assert (port_dir / table).read_text() == (jax_dir / table).read_text()
    if mode == "fbank":  # the dev split added its new characters
        assert "z" in (port_dir / table).read_text().split()


def test_codes_equal(runs):
    jax_dir, port_dir = runs["encodec"]
    want, got = _records(jax_dir, "train"), _records(port_dir, "train")
    for i in range(len(want)):
        w, g = want.codes(i), got.codes(i)
        assert g.shape == w.shape and g.shape[1] == 8
        assert g.shape[0] == int(np.ceil(want[i]["duration"] * 24000 / 320))
        np.testing.assert_array_equal(g, w)


def test_fbank_features_within_one_float16_ulp(runs):
    jax_dir, port_dir = runs["fbank"]
    for split in ("train", "dev"):
        want, got = _records(jax_dir, split), _records(port_dir, split)
        for i in range(len(want)):
            w, g = want.codes(i), got.codes(i)  # float16 values, read as f32
            assert g.shape == w.shape and g.shape[1] == 100
            assert np.array_equal(g.astype(np.float16).astype(g.dtype), g)
            ulp = np.spacing(np.abs(w).astype(np.float16)).astype(np.float32)
            assert np.all(np.abs(g - w) <= ulp)


@pytest.mark.parametrize("mode", ["encodec", "fbank"])
def test_stats_prints_what_jax_prints(runs, mode, capsys, monkeypatch):
    jax_dir, port_dir = runs[mode]
    monkeypatch.setattr(sys, "argv", ["stats", "--manifest-dir", str(jax_dir)])
    jax_stats.main()
    want = capsys.readouterr().out
    stats.main(["--manifest-dir", str(port_dir)])
    got = capsys.readouterr().out
    assert got == want and "Cuts count: 6" in got


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_cuda_refused_without_cuda(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        tokenize_dataset.main(["--tsv", str(tmp_path / "none.tsv"), "--output-dir",
                               str(tmp_path / "out")])
