"""WORLD-equivalent analysis-synthesis vocoder — the torch twin of
`shallow_wavenet_tpu/ops/synthesis.py`.

Source-filter synthesis from the `world` feature set (log-F0 + vuv + mcep
+ band aperiodicity, `bin/feature_extract.py`):

  excitation = mixed pulse train (voiced) / white noise, aperiodicity-
               weighted; pulse amplitude sqrt(sr/f0), so a pulse train at
               any F0 has unit expected power per sample
  spectrum   = exp(mel log envelope), realized by the time-varying MLSA
               filter (`ops/mlsa.mlsa_filter_tv`) on the frame-rate mcep

Aperiodicity mixes per band (WORLD's convention): the pulse train and the
noise are split into the analyzer's n_bap equal linear bands, and each
band mixes sqrt(1-ap_b)*pulse_b + sqrt(ap_b)*noise_b with its own track.

The JAX module draws its noise inside from a PRNG key; here the caller
passes `noise` (T,) or a `torch.Generator` to draw it from, so a test can
hand in JAX's own draw.
"""

from __future__ import annotations

import torch

from shallow_wavenet_tpu_torch.ops.mlsa import mc2b, mlsa_filter_tv


def _rep_tracks(hop: int, t_len: int):
    """Frame-rate -> sample-rate expander: repeat each frame hop times,
    edge-pad when the wav outruns n_frames*hop, truncate to t_len."""
    def rep(a):
        r = torch.repeat_interleave(a, hop, dim=0)
        if r.shape[0] < t_len:
            r = torch.cat([r, r[-1:].expand(t_len - r.shape[0],
                                            *r.shape[1:])])
        return r[:t_len]
    return rep


def _pulse_train(f0_t, vuv_t, sample_rate: int):
    """Unit-power pulse train from sample-rate f0/vuv tracks by phase
    accumulation (a pulse where the running sum of f0/sr crosses an
    integer), coherent across voicing boundaries."""
    inc = torch.where(vuv_t > 0, torch.clamp(f0_t, min=1.0), 0.0) / sample_rate
    phase = torch.cumsum(inc, dim=0)
    crossings = torch.floor(phase) - torch.floor(
        torch.cat([phase.new_zeros(1), phase[:-1]]))
    amp = torch.sqrt(sample_rate / torch.clamp(f0_t, min=1.0))
    return crossings * amp


def _noise(noise, generator, t_len: int, device):
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=torch.float32, device=device)
        if noise.shape != (t_len,):
            raise ValueError(f"noise must be ({t_len},), got "
                             f"{tuple(noise.shape)}")
        return noise
    if generator is None:
        raise ValueError("pass noise or a generator")
    return torch.randn(t_len, generator=generator,
                       device=generator.device).to(device)


def _tracks(f0, vuv, other, hop: int, t_len: int):
    t_len = t_len or f0.shape[0] * hop
    rep = _rep_tracks(hop, t_len)
    f0 = torch.as_tensor(f0, dtype=torch.float32)
    dev = f0.device
    as32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    return (t_len, rep(f0), rep(as32(vuv)),
            torch.clamp(rep(as32(other)), 0.0, 1.0))


def excitation(f0, vuv, ap, sample_rate: int, hop: int, t_len: int = 0, *,
               noise=None, generator: torch.Generator | None = None):
    """Mixed excitation (T,) from frame tracks f0/vuv/ap (n_frames,) with
    one aperiodicity track, on f0's device. Voiced: pulses scaled by
    sqrt(1-ap) plus noise scaled by sqrt(ap); unvoiced: unit noise."""
    t_len, f0_t, vuv_t, ap_t = _tracks(f0, vuv, ap, hop, t_len)
    pulses = _pulse_train(f0_t, vuv_t, sample_rate)
    noise = _noise(noise, generator, t_len, f0_t.device)
    voiced = torch.sqrt(torch.clamp(1.0 - ap_t, min=0.0)) * pulses \
        + torch.sqrt(ap_t) * noise
    return torch.where(vuv_t > 0, voiced, noise)


def excitation_multiband(f0, vuv, bap, sample_rate: int, hop: int,
                         t_len: int = 0, *, noise=None,
                         generator: torch.Generator | None = None):
    """Mixed excitation (T,) with per-band aperiodicity: bap is
    (n_frames, n_bands); the pulse train and the noise are split by
    complementary rFFT masks over equal bin splits of [0, Nyquist] (those
    of `ops/f0.band_aperiodicity`), each band mixed with its own weights.
    Unvoiced frames mix as pure noise."""
    t_len, f0_t, vuv_t, bap_t = _tracks(f0, vuv, bap, hop, t_len)
    n_bands = bap_t.shape[-1]
    bap_t = torch.where(vuv_t[:, None] > 0, bap_t, 1.0)
    pulses = _pulse_train(f0_t, vuv_t, sample_rate)
    noise = _noise(noise, generator, t_len, f0_t.device)

    n_bins = t_len // 2 + 1
    pf = torch.fft.rfft(pulses)
    nf = torch.fft.rfft(noise)
    exc = torch.zeros((t_len,), dtype=torch.float32, device=f0_t.device)
    for b in range(n_bands):
        lo = (b * n_bins) // n_bands
        hi = ((b + 1) * n_bins) // n_bands
        mask = torch.zeros((n_bins,), dtype=torch.float32,
                           device=f0_t.device)
        mask[lo:hi] = 1.0
        p_b = torch.fft.irfft(pf * mask, n=t_len)
        n_b = torch.fft.irfft(nf * mask, n=t_len)
        ap_b = bap_t[:, b]
        exc = exc + torch.sqrt(torch.clamp(1.0 - ap_b, min=0.0)) * p_b \
            + torch.sqrt(ap_b) * n_b
    return exc


@torch.no_grad()
def world_synthesis(feats, sample_rate: int, hop: int, mcep_order: int,
                    alpha: float, t_len: int = 0, per_band: bool = True,
                    n_bap: int = 0, peak_norm: bool = False, *,
                    noise=None, generator: torch.Generator | None = None):
    """A waveform (T,) in [-1, 1] from one utterance's un-normalized
    `world` feature matrix (n_frames, 2 + mcep_order+1 + n_bap), columns
    [log-F0 | vuv | mcep.. | bap..], on its device. n_bap = 0 takes every
    remaining column as bap; pass it where trailing channels follow
    (data.energy_feature). peak_norm rescales by the peak instead of
    clipping."""
    feats = torch.as_tensor(feats, dtype=torch.float32)
    lf0, vuv = feats[:, 0], feats[:, 1]
    mc = feats[:, 2:2 + mcep_order + 1]
    b0 = 2 + mcep_order + 1
    bap = feats[:, b0:b0 + n_bap] if n_bap else feats[:, b0:]
    f0 = torch.where(vuv > 0.5, torch.exp(lf0), 0.0)
    kw = dict(noise=noise, generator=generator)
    if per_band and bap.shape[-1]:
        exc = excitation_multiband(f0, vuv, bap, sample_rate, hop, t_len,
                                   **kw)
    else:
        ap = bap.mean(dim=-1) if bap.shape[-1] else torch.zeros_like(lf0)
        exc = excitation(f0, vuv, ap, sample_rate, hop, t_len, **kw)
    y = mlsa_filter_tv(exc, mc2b(mc, alpha), alpha, hop)
    if peak_norm:
        return y / torch.clamp(torch.max(torch.abs(y)), min=1.0)
    return torch.clamp(y, -1.0, 1.0)
