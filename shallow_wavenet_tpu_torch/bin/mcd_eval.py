"""Objective evaluation CLI — the torch twin of
`shallow_wavenet_tpu/bin/mcd_eval.py`.

    python -m shallow_wavenet_tpu_torch.bin.mcd_eval \
        --preset shallow_laplace_ns --ref-scp eval.scp --gen-dir gen_wav \
        --out mcd.json

Reference-against-generated metrics, frame-aligned copy-synthesis (no
DTW), with the analyzers on `--device` (default the card):

- MCD (dB): mel-cepstral distortion, the primary fidelity metric;
- F0 RMSE (Hz, and in cents) over frames both tracks call voiced;
- V/UV error rate: the share of frames whose voicing decisions disagree;
- LSD (dB): log-spectral distortion over STFT magnitudes, over frames
  where the reference is not silent (frame RMS 40 dB below its peak
  frame); the excluded frames are counted in `lsd_frames_excluded`;
- silence_db: the generated level inside reference-silent frames, dB
  relative to the generated signal's own peak frame (None without
  silent frames).

The JSON summary has the JAX CLI's keys.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np
import torch

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.bin.common import (
    add_config_args, resolve_config, setup_logging,
)
from shallow_wavenet_tpu_torch.data.audio_io import read_wav
from shallow_wavenet_tpu_torch.data.dataset import read_file_list
from shallow_wavenet_tpu_torch.ops.f0 import estimate_f0
from shallow_wavenet_tpu_torch.ops.mcep import mcd, mcep_analysis
from shallow_wavenet_tpu_torch.ops.stft import stft_magnitude

log = logging.getLogger("mcd_eval")


def eval_pair(ref: np.ndarray, gen: np.ndarray, cfg, device=None) -> dict:
    """All metrics for one (reference, generated) waveform pair."""
    dev = resolve_device(device)
    n = min(len(ref), len(gen))
    refn = np.ascontiguousarray(ref[:n], np.float32)
    genn = np.ascontiguousarray(gen[:n], np.float32)
    ref, gen = torch.from_numpy(refn).to(dev), torch.from_numpy(genn).to(dev)
    dc, ns = cfg.data, cfg.noise_shaping

    mc_r = mcep_analysis(ref, dc.n_fft, dc.hop_length, dc.win_length,
                         ns.mcep_order, ns.alpha)
    mc_g = mcep_analysis(gen, dc.n_fft, dc.hop_length, dc.win_length,
                         ns.mcep_order, ns.alpha)
    out = {"mcd_db": float(mcd(mc_r, mc_g))}

    # F0 + voicing agreement
    f0_r, vuv_r = estimate_f0(ref, dc.sample_rate, dc.hop_length,
                              f0_min=dc.f0_min, f0_max=dc.f0_max)
    f0_g, vuv_g = estimate_f0(gen, dc.sample_rate, dc.hop_length,
                              f0_min=dc.f0_min, f0_max=dc.f0_max)
    m = min(f0_r.shape[-1], f0_g.shape[-1])
    f0_r, vuv_r, f0_g, vuv_g = (a[:m].cpu().numpy()
                                for a in (f0_r, vuv_r, f0_g, vuv_g))
    both = (vuv_r > 0.5) & (vuv_g > 0.5)
    out["vuv_error_rate"] = float(np.mean((vuv_r > 0.5) != (vuv_g > 0.5)))
    if both.any():
        dr, dg = f0_r[both], f0_g[both]
        out["f0_rmse_hz"] = float(np.sqrt(np.mean((dr - dg) ** 2)))
        cents = 1200.0 * np.log2(np.maximum(dg, 1e-6)
                                 / np.maximum(dr, 1e-6))
        out["f0_rmse_cents"] = float(np.sqrt(np.mean(cents ** 2)))
    else:
        out["f0_rmse_hz"] = None
        out["f0_rmse_cents"] = None

    # reference-silence mask on the hop grid (shared by LSD + silence_db):
    # frame RMS 40 dB below the utterance's peak frame RMS
    nf = int(n) // dc.hop_length
    fr_ref = refn[: nf * dc.hop_length].reshape(nf, dc.hop_length)
    fr_gen = genn[: nf * dc.hop_length].reshape(nf, dc.hop_length)
    rms_ref = np.sqrt((fr_ref.astype(np.float64) ** 2).mean(axis=1))
    rms_gen = np.sqrt((fr_gen.astype(np.float64) ** 2).mean(axis=1))
    silent = rms_ref < rms_ref.max() * 1e-2

    # log-spectral distortion over STFT magnitudes, reference-silent
    # frames excluded; the magnitude floor is relative to the reference's
    # peak bin (-80 dB), so near-empty bins do not dominate
    sr_mag = stft_magnitude(ref, dc.n_fft, dc.hop_length, dc.win_length)
    sg_mag = stft_magnitude(gen, dc.n_fft, dc.hop_length, dc.win_length)
    k = min(sr_mag.shape[0], sg_mag.shape[0], nf)
    floor = torch.clamp(torch.max(sr_mag) * 1e-4, min=1e-8)
    d = 20.0 * (torch.log10(torch.maximum(sr_mag[:k], floor))
                - torch.log10(torch.maximum(sg_mag[:k], floor)))
    frame_lsd = torch.sqrt(torch.mean(d * d, dim=-1)).cpu().numpy()
    keep = ~silent[:k]
    out["lsd_db"] = float(frame_lsd[keep].mean()) if keep.any() else None
    out["lsd_frames_excluded"] = int((~keep).sum())

    # generated level inside reference-silent frames, dB rel the generated
    # signal's own peak frame (None when the reference has no silence)
    if silent.any() and rms_gen.max() > 0:
        lvl = rms_gen[silent].mean() / rms_gen.max()
        out["silence_db"] = float(20.0 * np.log10(max(lvl, 1e-10)))
    else:
        out["silence_db"] = None
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ref-scp", required=True)
    p.add_argument("--gen-dir", required=True)
    p.add_argument("--out", default=None, help="write JSON summary here")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' on the host)")
    add_config_args(p)
    args = p.parse_args(argv)
    setup_logging()
    cfg = resolve_config(args)
    dev = resolve_device(args.device)

    per_utt = {}
    for wp in read_file_list(args.ref_scp):
        gen_path = Path(args.gen_dir) / Path(wp).name
        if not gen_path.exists():
            log.warning("missing generated wav: %s", gen_path)
            continue
        ref, _ = read_wav(wp, target_sr=cfg.data.sample_rate)
        gen, _ = read_wav(gen_path, target_sr=cfg.data.sample_rate)
        m = eval_pair(ref, gen, cfg, dev)
        per_utt[Path(wp).name] = m
        log.info("%s: MCD %.3f dB  F0-RMSE %s Hz  VUV-err %.3f  LSD %s dB "
                 "(%d silent frames excl)  silence %s dB",
                 Path(wp).name, m["mcd_db"],
                 f"{m['f0_rmse_hz']:.1f}" if m["f0_rmse_hz"] is not None
                 else "n/a",
                 m["vuv_error_rate"],
                 f"{m['lsd_db']:.2f}" if m["lsd_db"] is not None else "n/a",
                 m["lsd_frames_excluded"],
                 f"{m['silence_db']:.1f}" if m["silence_db"] is not None
                 else "n/a")

    def agg(key):
        vals = [m[key] for m in per_utt.values() if m.get(key) is not None]
        return float(np.mean(vals)) if vals else None

    summary = {
        "mcd_db_mean": agg("mcd_db"),
        "f0_rmse_hz_mean": agg("f0_rmse_hz"),
        "f0_rmse_cents_mean": agg("f0_rmse_cents"),
        "vuv_error_rate_mean": agg("vuv_error_rate"),
        "lsd_db_mean": agg("lsd_db"),
        "silence_db_mean": agg("silence_db"),
        "per_utterance": per_utt,
    }
    log.info("mean MCD: %s dB over %d utterances", summary["mcd_db_mean"],
             len(per_utt))
    if args.out:
        Path(args.out).write_text(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
