"""The port's infer CLI (``valle_tpu_torch.bin.infer``) against the JAX
package's (``valle_tpu.bin.infer``) on the CPU.

Both CLIs get the same tiny VALL-E checkpoint (d=64, 4 heads, 2 layers,
Q=8, flax init as ``tests/test_infer_cli.py`` builds it), the same
full-width seeded random codec ``.npz``, the same 1 s 16 kHz prompt wav
(resampled to 24 kHz by both) and ``--top-k 1`` (greedy), through the
``chars`` text frontend:

  - the prompt's codes, encoded as each CLI encodes them, are equal;
  - from the ``.npz`` of flattened flax params, from a ``.pt`` written from
    the bridge's state dict (which JAX reads through ``convert_state_dict``)
    and from its ``model_avg`` under ``--use-averaged-model``: every
    ``{n}_codes.npy`` equal, every ``{n}.wav`` within 2 LSB;
  - ``--continual`` (prefix mode 1), the promptless path and
    ``--quantize-weights w8a8`` (int8 weights and activations, quantized on
    the host from the f32 weights) likewise;
  - the flags the port refuses: Orbax directories, ``--continual`` without
    prompts or with text.

Each JAX CLI run is made once, in a module fixture.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from valle_tpu.bin import infer as jax_infer
from valle_tpu.models import VALLE as JaxVALLE
from valle_tpu.models import ModelConfig as JaxConfig
from valle_tpu_torch.bin import infer
from valle_tpu_torch.codec import random_codec_params, save_codec_npz
from valle_tpu_torch.data import write_wav
from valle_tpu_torch.models import ModelConfig
from valle_tpu_torch.utils import flatten_tree, unflatten_tree
from valle_tpu_torch.utils.bridge import numpy_state_dict_from_jax

D, NHEAD, LAYERS, Q = 64, 4, 2, 8
DIMS = ["--decoder-dim", str(D), "--nhead", str(NHEAD), "--num-decoder-layers", str(LAYERS),
        "--num-quantizers", str(Q)]
PROMPT_TEXT, TEXTS = "hello world", "hi there|oh where"  # texts of one length: one compile
MAX_NEW = "20"
LSB = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flax_params():
    model = JaxVALLE(JaxConfig(decoder_dim=D, nhead=NHEAD, num_layers=LAYERS, num_quantizers=Q))
    variables = jax.jit(lambda rng: model.init(
        {"params": rng, "stage": rng}, jnp.zeros((1, 8), jnp.int32), jnp.asarray([8], jnp.int32),
        jnp.zeros((1, 16, Q), jnp.int32), jnp.asarray([16], jnp.int32), train_stage=0,
        deterministic=True, nar_stage=jnp.asarray(2)))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, variables["params"])


def _prompt_wav(path):
    """1 s at 16 kHz: two tones and seeded noise, as 16-bit PCM."""
    rng = np.random.RandomState(0)
    t = np.arange(16000) / 16000.0
    wav = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.1 * np.sin(2 * np.pi * 1250 * t)
    wav = wav + 0.05 * rng.randn(t.size)
    write_wav(str(path), wav.astype(np.float32), 16000)


def _run_jax(argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["infer"] + argv)
        jax_infer.main()


CASES = {
    "npz": lambda f: ["--checkpoint", f["npz"], "--text", TEXTS, "--text-prompts", PROMPT_TEXT,
                      "--audio-prompts", f["wav"]],
    "pt": lambda f: ["--checkpoint", f["pt"], "--text", TEXTS, "--text-prompts", PROMPT_TEXT,
                     "--audio-prompts", f["wav"]],
    "pt_averaged": lambda f: ["--checkpoint", f["pt"], "--use-averaged-model", "true",
                              "--text", TEXTS, "--text-prompts", PROMPT_TEXT,
                              "--audio-prompts", f["wav"]],
    "continual": lambda f: ["--checkpoint", f["npz"], "--continual", "true", "--text", "",
                            "--text-prompts", PROMPT_TEXT, "--audio-prompts", f["wav"],
                            "--prefix-mode", "1"],
    "promptless": lambda f: ["--checkpoint", f["npz"], "--text", TEXTS],
    "w8a8": lambda f: ["--checkpoint", f["npz"], "--text", TEXTS, "--text-prompts", PROMPT_TEXT,
                       "--audio-prompts", f["wav"], "--quantize-weights", "w8a8"],
}
OUTPUTS = {"continual": ["continual"], "promptless": ["0", "1"]}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer")
    params = _flax_params()
    averaged = {k: v * np.float32(0.75) for k, v in flatten_tree(params).items()}
    np.savez(root / "model.npz", **flatten_tree(params))
    cfg = ModelConfig(decoder_dim=D, nhead=NHEAD, num_layers=LAYERS, num_quantizers=Q)
    as_torch = lambda p: {k: torch.from_numpy(v)  # noqa: E731
                          for k, v in numpy_state_dict_from_jax(p, cfg).items()}
    torch.save({"model": as_torch(params), "model_avg": as_torch(unflatten_tree(averaged))},
               root / "model.pt")
    save_codec_npz(root / "codec.npz", random_codec_params(seed=0))
    _prompt_wav(root / "prompt.wav")
    chars = sorted(set(PROMPT_TEXT + TEXTS) - {" ", "|"}) + ["_"]
    (root / "tokens.k2symbols").write_text("".join(f"{s} {i + 1}\n" for i, s in enumerate(chars)))
    return {"root": root, "npz": str(root / "model.npz"), "pt": str(root / "model.pt"),
            "codec": str(root / "codec.npz"), "wav": str(root / "prompt.wav"),
            "symbols": str(root / "tokens.k2symbols")}


def _common(f, out_dir):
    return ["--text-tokens", f["symbols"], "--text-extractor", "chars", "--codec-checkpoint",
            f["codec"], "--top-k", "1", "--max-new-tokens", MAX_NEW, "--output-dir",
            str(out_dir), *DIMS]


@pytest.fixture(scope="module")
def jax_outputs(files):
    """Each case's output directory of the JAX CLI.  The runs share one
    ``EncodecJax`` of the codec file, so that it compiles once."""
    codec = jax_infer.load_codec(files["codec"])
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_infer, "load_codec", lambda path, **kw: codec)
        for name, argv in CASES.items():
            out[name] = files["root"] / f"jax_{name}"
            _run_jax(argv(files) + _common(files, out[name]))
    return out


def test_prompt_codes_equal(files):
    """The prompt wav read, resampled from 16 to 24 kHz and encoded as the
    JAX CLI does it, and as the port's CLI does it."""
    from valle_tpu.data import convert_audio, read_wav

    codec = jax_infer.load_codec(files["codec"])
    wav, sr = read_wav(files["wav"])
    want = np.asarray(codec.encode(convert_audio(wav, sr, 24000, 1)[None]))
    args = infer.get_parser().parse_args(
        ["--checkpoint", files["npz"], "--audio-prompts", files["wav"]])
    got = infer.encode_prompt_wavs(args, infer.load_codec(files["codec"], device="cpu"), Q)
    assert got.shape == want.shape == (1, 75, Q)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_cli_writes_what_jax_writes(files, jax_outputs, tmp_path, name):
    infer.main(CASES[name](files) + _common(files, tmp_path) + ["--device", "cpu"])
    for stem in OUTPUTS.get(name, ["0", "1"]):
        want = np.load(jax_outputs[name] / f"{stem}_codes.npy")
        got = np.load(tmp_path / f"{stem}_codes.npy")
        assert got.dtype == want.dtype and got.shape == want.shape and got.shape[1] == Q
        np.testing.assert_array_equal(got, want)
        sr_w, want_wav = wavfile.read(jax_outputs[name] / f"{stem}.wav")
        sr_g, got_wav = wavfile.read(tmp_path / f"{stem}.wav")
        assert sr_g == sr_w == 24000 and got_wav.shape == want_wav.shape
        assert got_wav.shape[0] == 320 * want.shape[0]
        assert np.abs(got_wav.astype(np.int32) - want_wav.astype(np.int32)).max() <= LSB


def test_averaged_model_differs_from_the_raw_one(jax_outputs):
    """The averaged weights of the .pt are the raw ones x 0.75, so --use-averaged-model
    is seen to load them, and the .pt's raw weights give the .npz's codes."""
    raw = np.load(jax_outputs["pt"] / "0_codes.npy")
    np.testing.assert_array_equal(raw, np.load(jax_outputs["npz"] / "0_codes.npy"))
    avg = np.load(jax_outputs["pt_averaged"] / "0_codes.npy")
    assert raw.shape != avg.shape or (raw != avg).any()


def test_cli_refuses_what_it_does_not_take(files, tmp_path):
    base = ["--text-tokens", files["symbols"], "--text-extractor", "chars", *DIMS,
            "--output-dir", str(tmp_path), "--device", "cpu"]
    with pytest.raises(ValueError, match="Orbax"):
        infer.main(["--checkpoint", str(files["root"])] + base)
    with pytest.raises(ValueError, match="averaged"):
        infer.main(["--checkpoint", files["npz"], "--use-averaged-model", "true"] + base)
    with pytest.raises(ValueError, match="--audio-prompts"):
        infer.main(["--checkpoint", files["npz"], "--continual", "true", "--text", ""] + base)
    with pytest.raises(ValueError, match="empty --text"):
        infer.main(["--checkpoint", files["npz"], "--continual", "true", "--text", "hi",
                    "--audio-prompts", files["wav"], "--codec-checkpoint", files["codec"]]
                   + base)
