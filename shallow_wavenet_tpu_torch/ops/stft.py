"""STFT + mel filterbank — the torch twin of `shallow_wavenet_tpu/ops/stft.py`.

Framing, Hann window, rFFT and the mel filterbank as one dense matmul, in
the JAX module's op order. The filterbank (HTK mel scale, no area
normalization) and `log_mel_spectrogram_np`, the pure-numpy mirror, are
copies of the JAX module's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Triangular mel filterbank, shape (n_fft//2 + 1, n_mels), float32."""
    if fmax is None:
        fmax = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fb = np.zeros((n_bins, n_mels), dtype=np.float64)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb.astype(np.float32)


def frame_signal(x, frame_length: int, hop_length: int, center: bool = True):
    """(..., T) -> (..., n_frames, frame_length); center=True reflect-pads
    frame_length // 2 on both sides."""
    if center:
        pad = frame_length // 2
        lead = x.shape[:-1]
        x = torch.nn.functional.pad(x.reshape(-1, x.shape[-1]), (pad, pad),
                                    mode="reflect")
        x = x.reshape(lead + x.shape[-1:])
    return x.unfold(-1, frame_length, hop_length)


def stft_magnitude(x, n_fft: int, hop_length: int, win_length: int,
                   center: bool = True):
    """|STFT| of (..., T) -> (..., n_frames, n_fft//2 + 1)."""
    frames = frame_signal(x, win_length, hop_length, center=center)
    win = torch.from_numpy(np.hanning(win_length + 1)[:-1].astype(np.float32))
    frames = frames * win.to(frames.device)
    if win_length < n_fft:
        pad = n_fft - win_length
        frames = torch.nn.functional.pad(frames, (pad // 2, pad - pad // 2))
    return torch.abs(torch.fft.rfft(frames, n=n_fft, dim=-1))


def log_mel_spectrogram(x, sample_rate: int, n_fft: int, hop_length: int,
                        win_length: int, n_mels: int, fmin: float = 0.0,
                        fmax: float | None = None, eps: float = 1e-10):
    """log10 mel power spectrogram of (..., T) -> (..., n_frames, n_mels),
    on x's device."""
    mag = stft_magnitude(x, n_fft, hop_length, win_length)
    fb = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, fmin,
                                         fmax)).to(mag.device)
    return torch.log10(torch.clamp(mag ** 2 @ fb, min=eps))


def log_mel_spectrogram_np(x: np.ndarray, sample_rate: int, n_fft: int,
                           hop_length: int, win_length: int, n_mels: int,
                           fmin: float = 0.0, fmax: float | None = None,
                           eps: float = 1e-10) -> np.ndarray:
    """Pure-numpy mirror of log_mel_spectrogram for pooled CPU workers."""
    pad = win_length // 2
    xp = np.pad(np.asarray(x, np.float32), (pad, pad), mode="reflect")
    n_frames = 1 + (len(xp) - win_length) // hop_length
    starts = np.arange(n_frames) * hop_length
    frames = xp[starts[:, None] + np.arange(win_length)[None, :]]
    frames = frames * np.hanning(win_length + 1)[:-1].astype(np.float32)
    if win_length < n_fft:
        extra = n_fft - win_length
        frames = np.pad(frames, ((0, 0), (extra // 2, extra - extra // 2)))
    mag = np.abs(np.fft.rfft(frames, n=n_fft, axis=-1))
    fb = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)
    return np.log10(np.maximum(mag.astype(np.float32) ** 2 @ fb, eps))
