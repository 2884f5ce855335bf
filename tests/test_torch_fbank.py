"""The port's BigVGAN log-mel features (``valle_tpu_torch/data/fbank.py``)
against the JAX package's (``valle_tpu/data/fbank.py``) on seeded audio at
16 and 24 kHz (16 kHz audio resampled to 24 kHz by each package's
``convert_audio``, as the tokenize CLIs do): the Slaney filterbank, the
features, ``compute_num_frames`` and ``mel_distance`` within ``ATOL`` (both
are the same numpy arithmetic; the bar allows for a BLAS that sums in
another order), the config's dict round trip, and the extractor cached.
"""

import numpy as np
import pytest

from valle_tpu.data import audio_io as jax_audio
from valle_tpu.data import fbank as jax_fbank
from valle_tpu_torch.data import audio_io, fbank

ATOL = 1e-5


def _audio(sr: int, seconds: float, seed: int):
    wav = 0.3 * np.random.RandomState(seed).randn(1, int(sr * seconds))
    return wav.clip(-1, 1).astype(np.float32)


def test_filterbank_matches():
    np.testing.assert_allclose(fbank.mel_filterbank(), jax_fbank.mel_filterbank(), rtol=0,
                               atol=ATOL)
    assert fbank.mel_filterbank().shape == (100, 513)


@pytest.mark.parametrize("sr,seconds", [(24000, 0.71), (16000, 1.3), (24000, 0.01)])
def test_features_match(sr, seconds):
    wav = _audio(sr, seconds, seed=sr + int(seconds * 100))
    want = jax_fbank.get_fbank_extractor().extract(
        jax_audio.convert_audio(wav, sr, 24000, 1)[0], 24000)
    got = fbank.get_fbank_extractor().extract(audio_io.convert_audio(wav, sr, 24000, 1)[0], 24000)
    assert got.dtype == np.float32 and got.shape == want.shape and got.shape[1] == 100
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("duration,shift,sr", [(0.71, 256 / 24000, 24000), (1.3, 0.01, 16000),
                                               (0.001, 256 / 24000, 24000), (2.0, 0.0125, 16000)])
def test_compute_num_frames_matches(duration, shift, sr):
    assert fbank.compute_num_frames(duration, shift, sr) == jax_fbank.compute_num_frames(
        duration, shift, sr)


def test_mel_distance_matches():
    a, b = _audio(24000, 0.8, 1)[0], _audio(24000, 0.7, 2)[0]
    np.testing.assert_allclose(fbank.mel_distance(a, b), jax_fbank.mel_distance(a, b), rtol=0,
                               atol=ATOL)
    assert fbank.mel_distance(a, a) == 0.0


def test_config_and_extractor():
    cfg = fbank.BigVGANFbankConfig()
    assert cfg.to_dict() == jax_fbank.BigVGANFbankConfig().to_dict()
    assert fbank.BigVGANFbankConfig.from_dict(cfg.to_dict()) == cfg
    ex = fbank.get_fbank_extractor()
    assert ex is fbank.get_fbank_extractor() and ex.feature_dim(24000) == 100
    assert ex.frame_shift == 256 / 24000
