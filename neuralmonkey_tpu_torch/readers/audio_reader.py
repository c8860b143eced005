"""Audio reader (counterpart of
``neuralmonkey_tpu/readers/audio_reader.py``, reference
nm/readers/audio_reader.py and its speech features). WAV files (stdlib
``wave``) -> log-mel filterbank or MFCC feature matrices in pure numpy,
computed on the host."""

from __future__ import annotations

import os
import wave
from typing import Callable, Iterable, List

import numpy as np


def _read_wav(path: str):
    with wave.open(path, "rb") as f:
        rate = f.getframerate()
        n = f.getnframes()
        width = f.getsampwidth()
        data = f.readframes(n)
    dtype = {1: np.int8, 2: np.int16, 4: np.int32}[width]
    signal = np.frombuffer(data, dtype=dtype).astype(np.float32)
    signal /= float(np.iinfo(dtype).max)
    return rate, signal


def _mel_filterbank(n_filters: int, n_fft: int, rate: int) -> np.ndarray:
    def hz_to_mel(hz):
        return 2595.0 * np.log10(1.0 + hz / 700.0)

    def mel_to_hz(mel):
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)

    mel_points = np.linspace(hz_to_mel(0), hz_to_mel(rate / 2),
                             n_filters + 2)
    hz_points = mel_to_hz(mel_points)
    bins = np.floor((n_fft + 1) * hz_points / rate).astype(int)
    fbank = np.zeros((n_filters, n_fft // 2 + 1), np.float32)
    for m in range(1, n_filters + 1):
        left, center, right = bins[m - 1], bins[m], bins[m + 1]
        for k in range(left, center):
            if center > left:
                fbank[m - 1, k] = (k - left) / (center - left)
        for k in range(center, right):
            if right > center:
                fbank[m - 1, k] = (right - k) / (right - center)
    return fbank


def log_mel_features(signal: np.ndarray, rate: int,
                     window_ms: float = 25.0, step_ms: float = 10.0,
                     n_filters: int = 40,
                     preemphasis: float = 0.97) -> np.ndarray:
    """(T, n_filters) log-mel filterbank features."""
    signal = np.append(signal[0], signal[1:] - preemphasis * signal[:-1])
    frame_len = int(rate * window_ms / 1000)
    step = int(rate * step_ms / 1000)
    if len(signal) < frame_len:
        signal = np.pad(signal, (0, frame_len - len(signal)))
    n_frames = 1 + (len(signal) - frame_len) // step
    indices = (np.arange(frame_len)[None, :]
               + step * np.arange(n_frames)[:, None])
    frames = signal[indices] * np.hamming(frame_len)
    n_fft = 1
    while n_fft < frame_len:
        n_fft *= 2
    spectrum = np.abs(np.fft.rfft(frames, n_fft)) ** 2 / n_fft
    fbank = _mel_filterbank(n_filters, n_fft, rate)
    energies = spectrum @ fbank.T
    return np.log(np.maximum(energies, 1e-10)).astype(np.float32)


def mfcc_features(signal: np.ndarray, rate: int,
                  n_coeffs: int = 13, **kwargs) -> np.ndarray:
    """(T, n_coeffs) MFCCs via DCT-II of the log-mel features."""
    logmel = log_mel_features(signal, rate, **kwargs)
    n = logmel.shape[1]
    basis = np.cos(np.pi * np.arange(n_coeffs)[:, None]
                   * (2 * np.arange(n)[None, :] + 1) / (2 * n))
    return (logmel @ basis.T).astype(np.float32)


def audio_reader(prefix: str = "",
                 audio_format: str = "wav",
                 features: str = "logmel",
                 n_filters: int = 40,
                 n_coeffs: int = 13) -> Callable:
    """Reader factory: series file lists one audio path per line."""
    if audio_format != "wav":
        raise ValueError(
            "Only WAV is supported without external decoders")

    def reader(paths: List[str]) -> Iterable[np.ndarray]:
        for list_path in paths:
            with open(list_path, encoding="utf-8") as f:
                for line in f:
                    rel = line.rstrip("\n")
                    if not rel:
                        continue
                    rate, signal = _read_wav(os.path.join(prefix, rel))
                    if features == "mfcc":
                        yield mfcc_features(signal, rate,
                                            n_coeffs=n_coeffs)
                    else:
                        yield log_mel_features(signal, rate,
                                               n_filters=n_filters)
    return reader
