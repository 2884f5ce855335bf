"""The port's EnCodec (``valle_tpu_torch/codec``) against the JAX package's
(``valle_tpu/codec/encodec_model.py``) on the CPU, with seeded random
weights in the JAX layout (``random_codec_params``) bridged into the port.

  - each function (``_pad1d``, ``causal_conv1d``,
    ``causal_conv_transpose1d``, ``lstm_stack``, ``resnet_block``,
    ``encode_latents`` / ``decode_latents``, ``rvq_encode`` /
    ``rvq_decode``) at a small config (4 filters, hidden 16, codebook dim
    16): f32 within 1e-5 of the largest |JAX output|, codes equal; with a
    reflect pad longer than its input, an odd kernel at stride 2 in the
    transposed conv, and tied codebook rows;
  - full width (``EncodecConfig()``): ``encode`` of 1 s and ``decode`` of
    75 frames against ``EncodecJax``: codes mismatch <= 0.5% (0 expected),
    wav within 1e-4 of the largest |wav|;
  - bf16 decode within 5% of the largest |f32 wav| (the JAX test's bar,
    ``tests/test_encodec_parity.py``), ``out_int16`` within 2 LSB of the
    host's conversion of the f32 wav;
  - the converter's ``.npz`` layout read and written by both packages;
  - ``encode`` and ``decode`` run with TF32 off for cuDNN and matmuls
    whatever the process's flags, and leave the flags as they found them.

Inputs come from numpy seeds.  The JAX functions take (B, T, C) and the
port's (B, C, T); the tests transpose at the boundary.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from valle_tpu.bin import infer as jax_infer
from valle_tpu.bin.convert_codec import flatten as jax_flatten
from valle_tpu.codec import encodec_model as jm
from valle_tpu_torch.codec import (
    Encodec, EncodecConfig, load_codec, random_codec_params, read_codec_npz, save_codec_npz)
from valle_tpu_torch.codec import encodec_model as tm

SMALL = dict(num_filters=4, hidden_size=16, codebook_dim=16, num_quantizers=8)
RTOL = 1e-5
WAV_RTOL = 1e-4
CODE_MISMATCH = 0.005
BF16_RTOL = 0.05
LSB = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    """(B, T, C) numpy -> the port's (B, C, T) tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 1, 2)))


def _close(got: torch.Tensor, want, rtol=RTOL):
    want = np.swapaxes(np.asarray(want), 1, 2)
    got = got.numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= rtol, err


def _port(tree):
    return tm._torch_tree(tree, torch.device("cpu"), torch.float32)


@pytest.mark.parametrize("length,left,right,mode", [
    (2, 5, 3, "reflect"), (4, 0, 4, "reflect"), (1, 6, 0, "reflect"), (9, 6, 2, "reflect"),
    (3, 4, 1, "constant")])
def test_pad1d(length, left, right, mode):
    x = np.random.RandomState(length).randn(2, length, 3).astype(np.float32)
    want = jm._pad1d(jnp.asarray(x), left, right, mode)
    got = tm._pad1d(_t(x), left, right, mode)
    np.testing.assert_array_equal(got.numpy(), np.swapaxes(np.asarray(want), 1, 2))


@pytest.mark.parametrize("k,stride,dilation,length,causal", [
    (7, 1, 1, 50, True), (3, 1, 3, 37, True), (8, 4, 1, 41, True), (16, 8, 1, 5, True),
    (4, 2, 1, 33, False), (3, 1, 9, 6, False)])
def test_causal_conv1d(k, stride, dilation, length, causal):
    rng = np.random.RandomState(k * 100 + length)
    x = rng.randn(2, length, 5).astype(np.float32)
    params = {"w": rng.randn(k, 5, 6).astype(np.float32), "b": rng.randn(6).astype(np.float32)}
    cfg = EncodecConfig(use_causal_conv=causal)
    want = jm.causal_conv1d(params, jnp.asarray(x), stride=stride, dilation=dilation,
                            cfg=jm.EncodecConfig(use_causal_conv=causal))
    _close(tm.causal_conv1d(_port(params), _t(x), stride=stride, dilation=dilation, cfg=cfg),
           want)


@pytest.mark.parametrize("k,stride,causal", [(7, 2, True), (5, 3, True), (16, 8, True),
                                             (7, 2, False), (4, 2, False)])
def test_causal_conv_transpose1d(k, stride, causal):
    """The JAX weight (k, out, in), transposed (2, 1, 0), is the
    ``F.conv_transpose1d`` weight (in, out, k) as it is: no flip in time."""
    rng = np.random.RandomState(k * 10 + stride)
    x = rng.randn(2, 11, 5).astype(np.float32)
    params = {"w": rng.randn(k, 3, 5).astype(np.float32), "b": rng.randn(3).astype(np.float32)}
    want = jm.causal_conv_transpose1d(params, jnp.asarray(x), stride=stride,
                                      cfg=jm.EncodecConfig(use_causal_conv=causal))
    got = tm.causal_conv_transpose1d(_port(params), _t(x), stride=stride,
                                     cfg=EncodecConfig(use_causal_conv=causal))
    _close(got, want)
    # a flip in time would show here: one impulse in, the kernel's taps out
    # in order, up to the causal trim of the last k - stride samples
    imp = np.zeros((1, 4, 5), np.float32)
    imp[0, 0, 0] = 1.0
    out = tm.causal_conv_transpose1d(_port(params), _t(imp), stride=stride,
                                     cfg=EncodecConfig())
    taps = params["w"][:, :, 0] + params["b"][None, :]  # (k, out)
    n = min(k, 4 * stride)
    np.testing.assert_allclose(out[0].numpy().T[:n], taps[:n], rtol=1e-6)


def test_lstm_stack():
    rng = np.random.RandomState(3)
    hidden, layers = 8, 2
    params = [{"wi": rng.randn(4 * hidden, hidden).astype(np.float32) * 0.4,
               "wh": rng.randn(4 * hidden, hidden).astype(np.float32) * 0.4,
               "bi": rng.randn(4 * hidden).astype(np.float32) * 0.4,
               "bh": rng.randn(4 * hidden).astype(np.float32) * 0.4} for _ in range(layers)]
    x = rng.randn(3, 21, hidden).astype(np.float32)
    want = jm.lstm_stack(params, jnp.asarray(x))
    got = tm.lstm_stack(tm.lstm_module(params, "cpu"), _t(x))
    _close(got, want)


def test_resnet_block():
    cfg = EncodecConfig(**SMALL)
    params = random_codec_params(cfg, seed=1)["encoder"]["layers_1"]
    x = np.random.RandomState(4).randn(2, 30, cfg.num_filters).astype(np.float32)
    want = jm.resnet_block(params, jnp.asarray(x), dilations=(2, 1),
                           cfg=jm.EncodecConfig(**SMALL))
    _close(tm.resnet_block(_port(params), _t(x), dilations=(2, 1), cfg=cfg), want)


@pytest.fixture(scope="module")
def small():
    cfg = EncodecConfig(**SMALL)
    params = random_codec_params(cfg, seed=2)
    return cfg, params, tm.codec_params_to_torch(params, "cpu")


def test_encode_and_decode_latents(small):
    cfg, params, port = small
    rng = np.random.RandomState(5)
    wav = rng.randn(2, 2000, 1).astype(np.float32) * 0.3
    want = jm.encode_latents(params, jnp.asarray(wav), jm.EncodecConfig(**SMALL))
    got = tm.encode_latents(port, _t(wav), cfg)
    _close(got, want)
    lat = rng.randn(2, 9, cfg.hidden_size).astype(np.float32)
    want = jm.decode_latents(params, jnp.asarray(lat), jm.EncodecConfig(**SMALL))
    got = tm.decode_latents(port, _t(lat), cfg)
    assert got.shape[-1] == 9 * cfg.hop_length
    _close(got, want)


def test_rvq_encode_and_decode(small):
    """Latents at the codebooks' scale so that every stage picks among many
    codes; two codebook rows duplicated so their distance ties exactly."""
    cfg, params, _ = small
    cb = params["quantizer"].copy()
    cb[0, 7] = cb[0, 3]
    cb[1, 900] = cb[1, 2]
    rng = np.random.RandomState(6)
    lat = rng.randn(2, 40, cfg.codebook_dim).astype(np.float32) * 2.0
    lat[0, 0] = cb[0, 3]  # stage 0 ties rows 3 and 7: the first index wins
    want = np.asarray(jm.rvq_encode(jnp.asarray(cb), jnp.asarray(lat), 8))
    got = tm.rvq_encode(torch.from_numpy(cb), _t(lat), 8)
    assert got.dtype == torch.int64 and got.shape == (2, 40, 8)
    assert got[0, 0, 0] == 3 and len(np.unique(want[..., 0])) > 20
    np.testing.assert_array_equal(got.numpy(), want)
    want_lat = jm.rvq_decode(jnp.asarray(cb), jnp.asarray(want))
    _close(tm.rvq_decode(torch.from_numpy(cb), got), want_lat)


@pytest.fixture(scope="module")
def full():
    params = random_codec_params(seed=0)
    return params, jm.EncodecJax(params), Encodec(params, device="cpu")


def test_full_width_encode_and_decode(full):
    _, jax_codec, codec = full
    rng = np.random.RandomState(7)
    wav = (rng.randn(1, 1, 24000) * 0.1).astype(np.float32)
    want = np.asarray(jax_codec.encode(wav))
    got = codec.encode(wav)
    assert tuple(got.shape) == want.shape == (1, 75, 8)
    assert (got.numpy() != want).mean() <= CODE_MISMATCH
    codes = rng.randint(0, 1024, (2, 75, 8))
    want_wav = np.asarray(jax_codec.decode(jnp.asarray(codes)))
    got_wav = codec.decode(torch.from_numpy(codes))
    assert tuple(got_wav.shape) == want_wav.shape == (2, 1, 24000)
    err = np.abs(got_wav.numpy() - want_wav).max() / np.abs(want_wav).max()
    assert err <= WAV_RTOL, err


def test_bf16_decode_and_int16(full):
    params, jax_codec, codec = full
    codes = torch.from_numpy(np.random.RandomState(2).randint(0, 1024, (2, 75, 8)))
    f32 = codec.decode(codes).numpy()
    b16 = Encodec(params, decode_dtype="bfloat16", device="cpu")
    assert b16.params["decoder"]["layers_0"]["w"].dtype == torch.bfloat16
    assert b16.params["encoder"]["layers_0"]["w"].dtype == torch.float32
    got = b16.decode(codes)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - f32).max() / np.abs(f32).max() < BF16_RTOL
    want = np.asarray(jax_codec.decode(jnp.asarray(codes.numpy()), out_int16=True))
    i16 = codec.decode(codes, out_int16=True)
    assert i16.dtype == torch.int16
    host = np.round(np.clip(f32, -1, 1) * 32767.0).astype(np.int16)
    assert np.abs(i16.numpy().astype(np.int32) - host.astype(np.int32)).max() <= LSB
    assert np.abs(i16.numpy().astype(np.int32) - want.astype(np.int32)).max() <= LSB


def test_codec_runs_without_tf32_whatever_the_flags(small, monkeypatch):
    """PyTorch lets cuDNN run f32 in TF32 by default; the codec's convs, LSTM
    and distance matmuls must not, or prompt codes flip on the card."""
    cfg, params, _ = small
    codec = Encodec(params, cfg=cfg, device="cpu")
    flags = (torch.backends.cudnn, torch.backends.cuda.matmul)
    seen = []
    for name in ("encode_latents", "rvq_encode", "decode_latents"):
        def spy(*args, _fn=getattr(tm, name)):
            seen.append([f.allow_tf32 for f in flags])
            return _fn(*args)
        monkeypatch.setattr(tm, name, spy)
    for f in flags:
        monkeypatch.setattr(f, "allow_tf32", True)
    wav = np.random.RandomState(9).randn(1, 1, 640).astype(np.float32)
    codes = codec.encode(wav, bandwidth=None)
    codec.decode(codes)
    assert seen == [[False, False]] * 3
    assert [f.allow_tf32 for f in flags] == [True, True]


def test_config_matches_jax():
    for kw in ({}, SMALL, dict(upsampling_ratios=(4, 4), sampling_rate=16000)):
        mine, theirs = EncodecConfig(**kw), jm.EncodecConfig(**kw)
        assert (mine.hop_length, mine.frame_rate) == (theirs.hop_length, theirs.frame_rate)
        for bw in (None, 0.0, 1.5, 3.0, 6.0, 12.0, 24.0):
            assert mine.num_q_for_bandwidth(bw) == theirs.num_q_for_bandwidth(bw)


def test_npz_layout_read_and_written_by_both(tmp_path):
    """The port reads the converter's ``.npz`` (written by the JAX
    package's ``flatten``), and JAX's ``load_codec`` reads the port's."""
    cfg = EncodecConfig(**SMALL)
    params = random_codec_params(cfg, seed=3)
    np.savez(tmp_path / "jax.npz", **jax_flatten(params))
    tree = read_codec_npz(tmp_path / "jax.npz")
    assert isinstance(tree["decoder"]["layers_1"], list)
    for a, b in zip(jax_flatten(tree).items(), jax_flatten(params).items()):
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
    save_codec_npz(tmp_path / "port.npz", params)
    theirs = jax_infer.load_codec(str(tmp_path / "port.npz"))
    theirs.cfg = jm.EncodecConfig(**SMALL)
    mine = load_codec(tmp_path / "jax.npz", device="cpu")
    mine.cfg = cfg
    wav = np.random.RandomState(8).randn(1, 1, 640).astype(np.float32)
    np.testing.assert_array_equal(mine.encode(wav, bandwidth=None).numpy(),
                                  np.asarray(theirs._encode(theirs.params, jnp.asarray(
                                      np.swapaxes(wav, 1, 2)), 8)))
