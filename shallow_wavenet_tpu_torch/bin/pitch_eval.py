"""Pitch-transposition evaluation — the torch twin of `tools/pitch_eval.py`:
does `decode --f0-factor` move the generated pitch by the requested factor?

For each eval utterance and each (factor, gen_dir) pair:
- PER-FRAME F0 ratio (`frame_ratio`): estimate_f0 on the generated wav
  (a wide range, 50-600 Hz, so transposed pitch stays measurable) divided
  frame by frame by the conditioning features' own F0 track, on frames
  voiced in BOTH; the utterance's statistic is the median of those ratios,
  compared to the factor (done criterion: within about 5% per utterance).
  Per frame, not median against median: voicing detection depends on
  timbre and pitch, so the two medians of a wide glide can compare
  different segments;
- MCD of the generated wav against a TRANSPOSED ORACLE (`transposed_oracle`):
  the classical source-filter resynthesis (`ops.synthesis.world_synthesis`,
  peak_norm) of the reference's own world features with lf0 moved by
  ln(factor) on voiced frames, the feature chain's floor for what a
  perfectly conditioned vocoder emits at the new pitch.

Extract the features with `data.envelope_smoothing=true`: the unsmoothed
mcep envelope of dense synthetic harmonics carries the original F0 as comb
ripple, which re-imposes the old periodicity on the transposed excitation,
and the oracle then reads about 1.0 whatever the factor (the JAX tool's
docstring; its smoothed oracle met every factor within 1.1% on the CPU).

F0 estimation, feature extraction and synthesis run on `--device` (default
the card; `--device cpu` on the host). The oracle's noise is drawn from a
`torch.Generator` seeded from `--seed`, anew for each utterance, as the JAX
tool draws from `jax.random.key(0)` for each; a caller may pass the noise
in instead (`noise`).

    python -m shallow_wavenet_tpu_torch.bin.pitch_eval --ref-scp S \
        --config C --pair 0.7:gen_0.7 --pair 1.3:gen_1.3 [--json OUT]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.bin.feature_extract import extract_one
from shallow_wavenet_tpu_torch.bin.mcd_eval import eval_pair
from shallow_wavenet_tpu_torch.config import Config
from shallow_wavenet_tpu_torch.data.audio_io import read_wav
from shallow_wavenet_tpu_torch.data.dataset import read_file_list
from shallow_wavenet_tpu_torch.ops.f0 import estimate_f0
from shallow_wavenet_tpu_torch.ops.synthesis import world_synthesis


def _f0(wav, sr, hop, f0_min, f0_max, device):
    x = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(
        resolve_device(device))
    f0, vuv = estimate_f0(x, sr, hop, f0_min=f0_min, f0_max=f0_max)
    return f0.cpu().numpy(), vuv.cpu().numpy()


def median_f0(wav, sr, hop, f0_min=50.0, f0_max=600.0, device=None):
    """The median F0 over the voiced frames of `wav`, or None."""
    f0, vuv = _f0(wav, sr, hop, f0_min, f0_max, device)
    v = vuv > 0.5
    return float(np.median(f0[v])) if v.any() else None


def frame_ratio(gen, ref_lf0, ref_vuv, sr, hop, f0_min=50.0, f0_max=600.0,
                device=None):
    """Median over frames of gen-F0 / feature-F0 on frames voiced in both
    tracks; (ratio | None, n_common_frames)."""
    f0g, vg = _f0(gen, sr, hop, f0_min, f0_max, device)
    n = min(len(f0g), len(ref_lf0))
    both = (np.asarray(ref_vuv)[:n] > 0.5) & (vg[:n] > 0.5)
    if both.sum() < 3:
        return None, int(both.sum())
    r = f0g[:n][both] / np.exp(np.asarray(ref_lf0)[:n][both])
    return float(np.median(r)), int(both.sum())


def transposed_oracle(feats, cfg: Config, factor: float, t_len: int,
                      noise=None, seed: int = 0, device=None) -> np.ndarray:
    """World synthesis (peak_norm) of un-normalized world features with lf0
    moved by ln(factor) on voiced frames. noise: the (t_len,) excitation
    noise, or None to draw it from a generator seeded from `seed`."""
    dev = resolve_device(device)
    f2 = np.array(feats, np.float32)
    voiced = f2[:, 1] > 0.5
    f2[voiced, 0] += np.log(factor)
    gen = (None if noise is not None
           else torch.Generator(device=dev).manual_seed(seed))
    return world_synthesis(
        torch.from_numpy(f2).to(dev), cfg.data.sample_rate,
        cfg.data.hop_length, cfg.noise_shaping.mcep_order,
        cfg.noise_shaping.alpha, t_len=t_len, n_bap=cfg.data.n_bap,
        per_band=False, peak_norm=True, noise=noise,
        generator=gen).cpu().numpy()


def evaluate(ref_scp, cfg: Config, pairs, seed: int = 0, device=None,
             noise=None, log=print) -> dict:
    """{"pairs": [{"factor", "gen_dir", "rows": [...]}]} for `pairs`, a
    list of (factor, gen_dir); each row as the JAX tool writes it. noise:
    a function of the length giving the oracle's noise, or None (drawn
    from `seed`)."""
    sr, hop = cfg.data.sample_rate, cfg.data.hop_length
    out = {"pairs": []}
    for factor, gdir in pairs:
        rows = []
        for wp in read_file_list(ref_scp):
            gp = Path(gdir) / Path(wp).name
            if not gp.exists():
                log(f"missing {gp}; skipped")
                continue
            ref, _ = read_wav(wp, target_sr=sr)
            gen, _ = read_wav(gp, target_sr=sr)
            feats = extract_one(wp, cfg, device=device)   # UN-normalized
            ratio, n_fr = frame_ratio(gen, feats[:, 0], feats[:, 1], sr,
                                      hop, device=device)
            oracle = transposed_oracle(
                feats, cfg, factor, len(ref),
                noise=None if noise is None else noise(len(ref)),
                seed=seed, device=device)
            m = eval_pair(oracle[: len(gen)], gen, cfg, device)
            rows.append({
                "utt": Path(wp).name, "ratio": ratio,
                "n_common_frames": n_fr, "factor": factor,
                "ratio_err_pct": (abs(ratio / factor - 1) * 100
                                  if ratio else None),
                "mcd_vs_transposed_oracle": m["mcd_db"],
            })
            err = rows[-1]["ratio_err_pct"]
            log(f"factor {factor}: {Path(wp).name}  per-frame ratio "
                f"{ratio and round(ratio, 3)} over {n_fr} frames "
                f"(err {err and round(err, 1)}%)  "
                f"MCD-vs-oracle {m['mcd_db']:.2f} dB")
        errs = [r["ratio_err_pct"] for r in rows
                if r["ratio_err_pct"] is not None]
        log(f"factor {factor}: mean |ratio error| "
            f"{np.mean(errs):.1f}%  worst {np.max(errs):.1f}%"
            if errs else f"factor {factor}: no measurable utterances")
        out["pairs"].append({"factor": factor, "gen_dir": str(gdir),
                             "rows": rows})
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ref-scp", required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--pair", action="append", required=True,
                    help="FACTOR:GEN_DIR, repeatable")
    ap.add_argument("--json", default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the oracle's excitation noise")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' on the host)")
    args = ap.parse_args(argv)
    cfg = Config.from_json(Path(args.config).read_text())
    pairs = []
    for spec in args.pair:
        f_str, _, gdir = spec.partition(":")
        pairs.append((float(f_str), gdir))
    out = evaluate(args.ref_scp, cfg, pairs, args.seed, args.device)
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
