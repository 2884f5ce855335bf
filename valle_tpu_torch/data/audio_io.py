"""Host-side wav I/O and resampling: the port's copy of
``valle_tpu/data/audio_io.py``.

scipy-based: wavfile for PCM/float wavs, polyphase resampling, mono mixdown —
the ``convert_audio`` contract of EnCodec (24 kHz mono float32 in [-1, 1]).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (samples (C, T) float32 in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[None, :]
    else:
        data = data.T  # (C, T)
    return data, int(sr)


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """samples: (T,) or (C, T) float in [-1, 1] — or int16 already converted
    on the device (Encodec.decode(out_int16=True)) — -> 16-bit PCM wav."""
    s = np.asarray(samples)
    if s.dtype != np.int16:
        s = np.clip(s.astype(np.float32), -1.0, 1.0)
        s = (s * 32767.0).astype(np.int16)
    if s.ndim == 2:
        s = s.T  # (T, C)
    wavfile.write(path, sample_rate, s)


def resample(samples: np.ndarray, sr_from: int, sr_to: int) -> np.ndarray:
    """Polyphase resample along the last axis."""
    if sr_from == sr_to:
        return samples
    frac = Fraction(sr_to, sr_from)
    return resample_poly(samples, frac.numerator, frac.denominator, axis=-1).astype(
        np.float32
    )


def convert_audio(
    samples: np.ndarray, sr: int, target_sr: int, target_channels: int
) -> np.ndarray:
    """EnCodec convert_audio semantics: resample + channel mixdown/expand."""
    assert samples.ndim == 2, samples.shape
    if target_channels == 1:
        samples = samples.mean(axis=0, keepdims=True)
    elif samples.shape[0] == 1 and target_channels > 1:
        samples = np.repeat(samples, target_channels, axis=0)
    elif samples.shape[0] != target_channels:
        raise ValueError(f"cannot convert {samples.shape[0]} -> {target_channels} channels")
    return resample(samples, sr, target_sr)
