"""BigVGAN-compatible 100-band log-mel extractor (24 kHz, FFT 1024, hop 256):
the port's copy of ``valle_tpu/data/fbank.py``.

Hann window, ``center=False`` with end padding to lhotse's expected frame
count, a Slaney-scale mel filterbank over 0-12 kHz (librosa's ``mel``
semantics in numpy, librosa not being a dependency), and log compression
with a 1e-5 clip.  It gives the Transformer baseline's features (the
tokenize CLI's Fbank mode) and the mel distance of evaluations.  It runs in
numpy on the host, as the JAX package's does.
"""

from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional

import numpy as np

SAMPLE_RATE = 24000
N_FFT = 1024
HOP = 256
WIN = 1024


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    mel = f / f_sp
    above = f >= min_log_hz
    mel = np.where(above, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)
    return mel


def _mel_to_hz_slaney(mel):
    mel = np.asarray(mel, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0
    hz = mel * f_sp
    above = mel >= min_log_mel
    hz = np.where(above, min_log_hz * np.exp(logstep * (mel - min_log_mel)), hz)
    return hz


def mel_filterbank(
    sr: int = SAMPLE_RATE,
    n_fft: int = N_FFT,
    n_mels: int = 100,
    fmin: float = 0.0,
    fmax: float = 12000.0,
) -> np.ndarray:
    """librosa.filters.mel(htk=False, norm='slaney') re-implementation;
    returns (n_mels, 1 + n_fft//2) float32."""
    fftfreqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_min, mel_max = _hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax)
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def compute_num_frames(duration: float, frame_shift: float, sampling_rate: int) -> int:
    """lhotse.utils.compute_num_frames semantics (round to hop multiples)."""
    num_samples = round(duration * sampling_rate)
    window_hop = round(frame_shift * sampling_rate)
    n = int(num_samples / window_hop)
    rem = num_samples % window_hop
    return n + 1 if rem * 2 >= window_hop else max(n, 1)


@dataclass
class BigVGANFbankConfig:
    frame_length: float = 1024 / 24000.0
    frame_shift: float = 256 / 24000.0
    remove_dc_offset: bool = True
    round_to_power_of_two: bool = True
    low_freq: float = 0.0
    high_freq: float = 12000.0
    num_mel_bins: int = 100
    use_energy: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "BigVGANFbankConfig":
        return BigVGANFbankConfig(**d)


class BigVGANFbank:
    name = "fbank"

    def __init__(self, config: Optional[BigVGANFbankConfig] = None):
        self.config = config or BigVGANFbankConfig()
        self.mel_basis = mel_filterbank(
            SAMPLE_RATE, N_FFT, self.config.num_mel_bins,
            self.config.low_freq, self.config.high_freq,
        )
        self.window = np.hanning(WIN + 1)[:-1].astype(np.float32)  # torch hann

    @property
    def frame_shift(self) -> float:
        return self.config.frame_shift

    def feature_dim(self, sampling_rate: int) -> int:
        return self.config.num_mel_bins

    def extract(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        """samples: (T,) or (1, T) float32 in [-1, 1] at 24 kHz -> (F, 100)."""
        assert sampling_rate == SAMPLE_RATE, sampling_rate
        y = np.asarray(samples, dtype=np.float32).reshape(-1)
        duration = round(y.shape[-1] / sampling_rate, ndigits=12)
        expected = compute_num_frames(duration, self.frame_shift, sampling_rate)
        pad = (expected - 1) * HOP + WIN - y.shape[-1]
        assert pad >= 0, pad
        y = np.pad(y, (0, pad))

        # frames: center=False
        idx = np.arange(WIN)[None, :] + HOP * np.arange(expected)[:, None]
        frames = y[idx] * self.window[None, :]
        spec = np.fft.rfft(frames, n=N_FFT, axis=-1)
        mag = np.sqrt(spec.real**2 + spec.imag**2 + 1e-9)
        mel = mag @ self.mel_basis.T  # (F, n_mels)
        return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)


_EXTRACTOR = None


def get_fbank_extractor() -> BigVGANFbank:
    global _EXTRACTOR
    if _EXTRACTOR is None:
        _EXTRACTOR = BigVGANFbank()
    return _EXTRACTOR


def mel_distance(wav_a: np.ndarray, wav_b: np.ndarray) -> float:
    """Mean |mel_a - mel_b| over the overlapping frames (eval metric for the
    mel-allclose north star)."""
    ex = get_fbank_extractor()
    a = ex.extract(wav_a, SAMPLE_RATE)
    b = ex.extract(wav_b, SAMPLE_RATE)
    n = min(a.shape[0], b.shape[0])
    return float(np.mean(np.abs(a[:n] - b[:n])))
