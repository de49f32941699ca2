"""Mel-cepstrum analysis and MCD — the torch twin of
`shallow_wavenet_tpu/ops/mcep.py`.

Per frame: windowed rFFT -> log|X| -> IFFT to the real cepstrum ->
minimum-phase doubling -> frequency warp to the mel axis by `freqt`, which
is linear and so one dense (m1+1, m2+1) matrix (numpy, cached: a copy of
the JAX module's) applied as a matmul. Every function runs on its input's
device.

Conventions (shared by analysis, MLSA shaping and MCD):
- mcep m satisfies log|H(w)| = Re sum_m m_k e^{-i k beta(w)} with beta the
  all-pass warped phase (the minimum-phase, "doubled" cepstrum, as SPTK's
  mlsadf/mgc2sp use);
- MCD(dB) = (10/ln10) * sqrt(2 * sum_{m>=1} (dc_m)^2), frame-averaged.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from shallow_wavenet_tpu_torch.ops.stft import frame_signal


@functools.lru_cache(maxsize=8)
def freqt_matrix(m1: int, m2: int, alpha: float) -> np.ndarray:
    """Dense matrix W (m1+1, m2+1): warped = cep @ W.

    Rows are freqt applied to unit cepstra. The recursion (per input
    coefficient, highest first) is the Oppenheim-Johnson frequency
    transform used by SPTK's freqt:
      g_new[0] = c1[i] + a*g[0]
      g_new[1] = (1-a^2)*g[0] + a*g[1]
      g_new[j] = g[j-1] + a*(g[j] - g_new[j-1])
    """
    b = 1.0 - alpha * alpha
    w = np.zeros((m1 + 1, m2 + 1), dtype=np.float64)
    for row in range(m1 + 1):
        c1 = np.zeros(m1 + 1)
        c1[row] = 1.0
        g = np.zeros(m2 + 1)
        for i in range(m1, -1, -1):
            gn = np.empty_like(g)
            gn[0] = c1[i] + alpha * g[0]
            if m2 >= 1:
                gn[1] = b * g[0] + alpha * g[1]
            for j in range(2, m2 + 1):
                gn[j] = g[j - 1] + alpha * (g[j] - gn[j - 1])
            g = gn
        w[row] = g
    return w.astype(np.float32)


def _matrix(m1: int, m2: int, alpha: float, device) -> torch.Tensor:
    return torch.from_numpy(freqt_matrix(m1, m2, float(alpha))).to(device)


def spectrum_to_mcep(log_mag, order: int, alpha: float, f0_norm=None):
    """(..., n_bins) natural-log magnitude spectrum -> (..., order+1) mcep.

    f0_norm: optional per-frame F0 / sample_rate, shape log_mag.shape[:-1]:
    the F0-adaptive lag window. Cepstrum k is multiplied by
    sinc(k * f0 / sr), which averages the log spectrum over one harmonic
    spacing, so the mcep tracks the envelope, not the harmonic peaks. It is
    applied to the full cepstrum, before the order-M truncation."""
    n_bins = log_mag.shape[-1]
    n_fft = 2 * (n_bins - 1)
    cep = torch.fft.irfft(log_mag, n=n_fft, dim=-1)
    m1 = n_fft // 2
    if f0_norm is not None:
        k = torch.arange(m1 + 1, dtype=torch.float32, device=cep.device)
        arg = math.pi * k * f0_norm[..., None]           # (..., m1+1)
        lifter = torch.where(arg > 0,
                             torch.sin(arg) / torch.clamp(arg, min=1e-12),
                             1.0)
        cep = torch.cat([cep[..., :m1 + 1] * lifter, cep[..., m1 + 1:]],
                        dim=-1)
    # minimum-phase doubling: h0 = c0, hk = 2 ck (1 <= k < m1), and the
    # Nyquist coefficient h[m1] = c[m1] (it has no mirrored partner)
    half = torch.ones(m1 + 1, device=cep.device)
    half[0] = half[m1] = 0.5
    h = cep[..., :m1 + 1] * 2.0 * half
    return h @ _matrix(m1, order, alpha, cep.device)


def _magnitude(frames, n_fft: int):
    """|rFFT| of the frames, float32. On the card the transform runs in
    float64: cuFFT's fp32 transform errs by about 1e-7 of a frame's
    energy, which at a spectral null (log|X| near the eps floor) moves a
    mel-cepstral coefficient by up to 5e-4 against the native double path
    (measured on an H100, the first frame of a synthetic utterance); the
    host's fp32 transform stays within 1e-4 of it, as the JAX reference
    does."""
    if frames.is_cuda:
        return torch.abs(torch.fft.rfft(frames.double(), n=n_fft,
                                        dim=-1)).float()
    return torch.abs(torch.fft.rfft(frames, n=n_fft, dim=-1))


def mcep_analysis(x, n_fft: int, hop_length: int, win_length: int,
                  order: int, alpha: float, eps: float = 1e-8,
                  f0_hz=None, sample_rate: int = 0,
                  f0_default: float = 300.0):
    """Waveform (..., T) -> mcep (..., n_frames, order+1), on x's device.

    f0_hz: optional per-frame F0 track (unvoiced frames <= 0) for the
    F0-adaptive envelope smoothing (`spectrum_to_mcep`); unvoiced frames
    smooth at f0_default Hz. Needs sample_rate. The track is cropped or
    edge-padded to the spectral frame count."""
    frames = frame_signal(x, win_length, hop_length, center=True)
    win = torch.from_numpy(np.hanning(win_length + 1)[:-1].astype(np.float32))
    frames = frames * win.to(frames.device)
    if win_length < n_fft:
        pad = n_fft - win_length
        frames = torch.nn.functional.pad(frames, (pad // 2, pad - pad // 2))
    mag = _magnitude(frames, n_fft)
    f0_norm = None
    if f0_hz is not None:
        if not sample_rate:
            raise ValueError("f0-adaptive smoothing needs sample_rate")
        n = mag.shape[-2]
        f0_hz = torch.as_tensor(f0_hz, dtype=torch.float32,
                                device=mag.device)[..., :n]
        if f0_hz.shape[-1] < n:
            tail = f0_hz[..., -1:].expand(*f0_hz.shape[:-1],
                                          n - f0_hz.shape[-1])
            f0_hz = torch.cat([f0_hz, tail], dim=-1)
        f0_norm = torch.where(f0_hz > 0, f0_hz, f0_default) / sample_rate
    return spectrum_to_mcep(torch.log(torch.clamp(mag, min=eps)), order,
                            alpha, f0_norm=f0_norm)


def mcep_to_log_spectrum(mc, n_fft: int, alpha: float):
    """mcep (..., M+1) -> natural-log magnitude (..., n_fft//2+1) on the
    linear frequency axis (inverse warp via freqt with -alpha)."""
    order = mc.shape[-1] - 1
    h = mc @ _matrix(order, n_fft // 2, -float(alpha), mc.device)
    # Re sum_k h_k e^{-ikw} on the rFFT grid (zero-padded to n_fft)
    return torch.fft.rfft(h, n=n_fft, dim=-1).real


def mcd(mc_ref, mc_gen, exclude_c0: bool = True):
    """Mel-cepstral distortion in dB between aligned (T, M+1) tracks; a
    0-d tensor."""
    t = min(mc_ref.shape[-2], mc_gen.shape[-2])
    d = mc_ref[..., :t, :] - mc_gen[..., :t, :]
    if exclude_c0:
        d = d[..., 1:]
    per_frame = float(10.0 / np.log(10.0)) * torch.sqrt(
        2.0 * torch.sum(d * d, dim=-1))
    return torch.mean(per_frame)
