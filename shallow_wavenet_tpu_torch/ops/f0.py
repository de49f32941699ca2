"""F0, voicing and band aperiodicity — the torch twin of
`shallow_wavenet_tpu/ops/f0.py`, vectorized over frames on the input's
device.

- F0: normalized autocorrelation through the power spectrum (Wiener-
  Khinchin); the period chosen by a YIN-style cumulative-mean-normalized
  difference with a relative threshold, refined on the window-de-biased
  values with parabolic interpolation, with an octave/subharmonic guard;
  voicing = peak clarity above a threshold and an energy floor; isolated
  outliers repaired against the 5-frame voiced median.
- Band aperiodicity: 1 - the normalized band-limited autocorrelation at
  the fractional F0 lag, per band, on F0-adaptive windows.

Frames are hop-aligned with the mel and mcep analyzers. The native C++
twins (`utils/native.py`) keep the same defaults; `BAP_F0_REFS` and
`bap_window_length` are shared with them from here.
"""

from __future__ import annotations

import numpy as np
import torch

from shallow_wavenet_tpu_torch.ops.stft import frame_signal


def _hann(n: int) -> np.ndarray:
    return np.hanning(n + 1)[:-1].astype(np.float32)


def _window_autocorr(win_np: np.ndarray, n_fft: int) -> np.ndarray:
    """The window's own normalized autocorrelation, floored at 1e-3 (the
    taper de-bias)."""
    wac = np.fft.irfft(np.abs(np.fft.rfft(win_np, n_fft)) ** 2, n_fft)
    return np.maximum((wac / wac[0]).astype(np.float32), 1e-3)


def _norm_autocorr(frames, n_fft):
    """Biased normalized autocorrelation of windowed frames via rFFT."""
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)
    ac = torch.fft.irfft(torch.abs(spec) ** 2, n=n_fft, dim=-1)
    return ac / torch.clamp(ac[..., :1], min=1e-12)


def _first_true(mask):
    """Index of the first True along the last axis (0 where none), as
    jnp.argmax of a boolean mask gives it."""
    return mask.to(torch.int32).argmax(dim=-1)


def _take(a, idx):
    return torch.gather(a, -1, idx[..., None])[..., 0]


def estimate_f0(x, sample_rate: int, hop_length: int, win_length: int = 0,
                f0_min: float = 70.0, f0_max: float = 400.0,
                threshold: float = 0.45):
    """(..., T) waveform -> (f0, vuv) each (..., n_frames), on x's device.

    f0 is 0 where unvoiced; vuv is {0., 1.}. win_length defaults to
    2.5 * sample_rate / f0_min (rounded even): at least 2 periods of the
    lowest pitch stay inside the window for every lag up to
    sample_rate / f0_min."""
    if win_length == 0:
        win_length = int(2.5 * sample_rate / f0_min)
        win_length += win_length % 2
    lag_min = max(int(sample_rate / f0_max), 1)
    lag_max = int(np.ceil(sample_rate / f0_min))
    n_fft = int(2 ** np.ceil(np.log2(win_length + lag_max + 1)))
    dev = x.device

    frames = frame_signal(x, win_length, hop_length, center=True)
    frames = frames - torch.mean(frames, dim=-1, keepdim=True)
    win_np = _hann(win_length)
    win = torch.from_numpy(win_np).to(dev)
    ac = _norm_autocorr(frames * win, n_fft)
    # the refinement works on window-de-biased values (no taper slope at
    # the peak)
    ac_u = ac / torch.from_numpy(_window_autocorr(win_np, n_fft)).to(dev)

    lags_u = ac_u[..., lag_min:lag_max + 1]
    span = lag_max - lag_min

    # selection: YIN's cumulative-mean-normalized difference of the
    # de-biased autocorrelation (de Cheveigne & Kawahara 2002, eq. 8)
    d = torch.clamp(1.0 - ac_u[..., 1:lag_max + 1], min=1e-6)
    tau = torch.arange(1, lag_max + 1, dtype=torch.float32, device=dev)
    cmnd = d * tau / torch.clamp(torch.cumsum(d, dim=-1), min=1e-9)
    cmnd_sl = cmnd[..., lag_min - 1:]
    # the first lag dipping below max(0.2, 1.25 x the frame's minimum),
    # walked forward to that dip's local minimum; the global minimum where
    # nothing dips
    theta = torch.clamp(torch.amin(cmnd_sl, dim=-1, keepdim=True) * 1.25,
                        min=0.2)
    below = cmnd_sl < theta
    i0 = _first_true(below)
    nondec = cmnd_sl[..., 1:] >= cmnd_sl[..., :-1]
    stop = torch.cat([nondec, torch.ones_like(nondec[..., :1])], dim=-1)
    idx = torch.arange(cmnd_sl.shape[-1], device=dev)
    j_loc = _first_true(stop & (idx >= i0[..., None]))
    k_sel = torch.where(torch.any(below, dim=-1), j_loc,
                        torch.argmin(cmnd_sl, dim=-1))

    def refine(j0, window=3):
        """Re-maximize the de-biased values in +-window around j0, then
        parabolic interpolation: (j, value, fractional delta)."""
        offs = torch.arange(-window, window + 1, device=dev)
        widx = torch.clamp(j0[..., None] + offs, 0, span)
        wvals = torch.gather(lags_u, -1, widx)
        j = torch.clamp(j0 + (torch.argmax(wvals, dim=-1) - window), 0, span)
        v = _take(lags_u, j)
        jm1 = _take(lags_u, torch.clamp(j - 1, min=0))
        jp1 = _take(lags_u, torch.clamp(j + 1, max=span))
        denom = jm1 - 2 * v + jp1
        delta = torch.where(torch.abs(denom) > 1e-9,
                            0.5 * (jm1 - jp1) / denom, 0.0)
        return j, v, torch.clamp(delta, -0.5, 0.5)

    k, peak, delta = refine(k_sel)
    lag = lag_min + k.to(torch.float32) + delta
    # octave/subharmonic guard: where the de-biased value at ~lag/m
    # (m = 2, 3) is nearly as high, the shorter lag is the period
    for m in (2, 3):
        jc = torch.round((lag_min + k) / m).to(torch.int64) - lag_min
        ok = jc >= 0
        jc_, vc, dc = refine(torch.clamp(jc, min=0), window=2)
        better = ok & (vc >= 0.9 * peak)
        lag_c = lag_min + jc_.to(torch.float32) + dc
        lag = torch.where(better, lag_c, lag)
    f0 = sample_rate / torch.clamp(lag, min=1.0)

    # voicing: autocorrelation peak clarity + frame energy floor
    energy = torch.mean((frames * win) ** 2, dim=-1)
    vuv = ((peak > threshold)
           & (energy > 1e-6)
           & (f0 >= f0_min) & (f0 <= f0_max)).to(torch.float32)
    f0 = _correct_outliers(f0, vuv)
    return f0 * vuv, vuv


def _pad2(a, mode: str):
    """Pad the last axis by 2 on both sides ('reflect' or 'replicate')."""
    lead = a.shape[:-1]
    out = torch.nn.functional.pad(a.reshape(-1, 1, a.shape[-1]), (2, 2),
                                  mode=mode)
    return out.reshape(lead + out.shape[-1:])


def _correct_outliers(f0, vuv):
    """A voiced frame whose F0 deviates > 18% from the 5-frame voiced
    median is replaced by that median; unvoiced neighbours are replaced by
    the centre value inside the window. Reflect padding (edge below 3
    frames), as the JAX module and native/featext.cc."""
    n = f0.shape[-1]
    mode = "reflect" if n >= 3 else "replicate"
    fpad = _pad2(f0, mode)
    vpad = _pad2(vuv, mode)
    idx = torch.from_numpy(np.arange(n)[:, None] + np.arange(5)[None, :]
                           ).to(f0.device)
    w = fpad[..., idx]                      # (..., n, 5)
    wv = vpad[..., idx]
    center = f0[..., :, None]
    # the median of 5: the middle of the sorted window
    med = torch.sort(torch.where(wv > 0, w, center), dim=-1).values[..., 2]
    return torch.where(torch.abs(f0 - med) > 0.18 * med, med, f0)


# the F0-adaptive window grid, shared with the native C++ twin
# (utils/native.band_aperiodicity_native)
BAP_F0_REFS = (70.0, 110.0, 170.0, 260.0)


def bap_window_length(sample_rate: int, f0_ref: float) -> int:
    """Shortest even window covering ~2.5 periods of f0_ref."""
    w = int(2.5 * sample_rate / f0_ref)
    return w + (w % 2)


def band_aperiodicity(x, f0, sample_rate: int, hop_length: int,
                      win_length: int = 0, n_bands: int = 4):
    """Band aperiodicity (..., n_frames, n_bands) in [0, 1]: 1 - the
    normalized band-limited autocorrelation at the fractional F0 lag; 1.0
    where unvoiced. win_length=0 (the default) gives each frame the
    shortest window of `BAP_F0_REFS` covering ~2.5 periods of its F0."""
    f0 = torch.as_tensor(f0, dtype=torch.float32, device=x.device)
    if win_length == 0:
        refs = BAP_F0_REFS
        passes = [_bap_pass(x, f0, sample_rate, hop_length,
                            bap_window_length(sample_rate, f0_ref), n_bands)
                  for f0_ref in refs]
        out = passes[0]
        for f0_ref, ap in zip(refs[1:], passes[1:]):
            sel = (f0 >= f0_ref)[..., :out.shape[-2], None]
            out = torch.where(sel, ap, out)
        return out
    return _bap_pass(x, f0, sample_rate, hop_length, win_length, n_bands)


def _bap_pass(x, f0, sample_rate, hop_length, win_length, n_bands):
    """One fixed-window pass. The lag is refined per frame on the full-band
    fractional autocorrelation over a small offset grid around
    sample_rate/f0 (band-independent, so it cannot inflate a noise band's
    score)."""
    n_fft = int(2 ** np.ceil(np.log2(2 * win_length)))
    n_bins = n_fft // 2 + 1
    dev = x.device

    frames = frame_signal(x, win_length, hop_length, center=True)
    frames = frames - torch.mean(frames, dim=-1, keepdim=True)
    win_np = _hann(win_length)
    spec = torch.fft.rfft(frames * torch.from_numpy(win_np).to(dev), n=n_fft,
                          dim=-1)
    power = torch.abs(spec) ** 2
    wac = torch.from_numpy(_window_autocorr(win_np, n_fft)).to(dev)

    n_frames = frames.shape[-2]
    f0 = f0[..., :n_frames]
    lag = torch.where(f0 > 0, sample_rate / torch.clamp(f0, min=1.0), 1.0)

    # irfft weights for a cos-sum over the half spectrum
    w_np = np.full(n_bins, 2.0, np.float32)
    w_np[0] = 1.0
    if n_fft % 2 == 0:
        w_np[-1] = 1.0
    k = torch.from_numpy(np.arange(n_bins, dtype=np.float32)).to(dev)
    omega = 2.0 * np.pi / n_fft

    def ac_at(p, tau):
        """Fractional-lag autocorrelation (..., n_frames) of the weighted
        power p (..., n_frames, n_bins) at lags tau (..., n_frames)."""
        return torch.sum(p * torch.cos(omega * tau[..., None] * k), dim=-1)

    pw = power * torch.from_numpy(w_np).to(dev)
    offsets = np.linspace(-0.6, 0.6, 7).astype(np.float32)
    cands = torch.stack([ac_at(pw, lag + float(o)) for o in offsets], dim=-1)
    best = torch.argmax(cands, dim=-1)
    lag = lag + torch.from_numpy(offsets).to(dev)[best]
    # window de-bias at the fractional lag: linear interpolation of the
    # window's own autocorrelation
    li = torch.clamp(torch.floor(lag).to(torch.int64), 0, n_fft - 2)
    fr = lag - li.to(torch.float32)
    wl = wac[li] * (1.0 - fr) + wac[li + 1] * fr

    edges = np.linspace(0, n_bins, n_bands + 1).astype(int)
    aps = []
    for b in range(n_bands):
        mask = np.zeros(n_bins, np.float32)
        mask[edges[b]:edges[b + 1]] = 1.0
        pb = pw * torch.from_numpy(mask).to(dev)
        ac0 = torch.clamp(torch.sum(pb, dim=-1), min=1e-12)
        acl = ac_at(pb, lag)
        ap = 1.0 - torch.clamp(acl / (ac0 * wl), 0.0, 1.0)
        aps.append(torch.where(f0 > 0, ap, 1.0))
    return torch.stack(aps, dim=-1)


def log_f0(f0, vuv, floor: float = 1.0):
    """Continuous log-F0 (0 where unvoiced): the conditioning encoding."""
    return torch.where(vuv > 0, torch.log(torch.clamp(f0, min=floor)), 0.0)
