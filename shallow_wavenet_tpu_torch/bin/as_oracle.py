"""Analysis-synthesis oracle — the torch twin of `tools/as_oracle.py`: the
MCD floor of the feature chain and the metric on a corpus, independent of
any neural model.

Per eval utterance of a synthetic corpus: extract the `world` feature set
from the TRUE wav, resynthesize it with the classical source-filter vocoder
(`ops.synthesis.world_synthesis`), and score MCD / F0-RMSE / VUV / LSD
against the original (`bin.mcd_eval.eval_pair`). A neural vocoder
conditioned on these features cannot be expected below this floor.

    python -m shallow_wavenet_tpu_torch.bin.as_oracle [--corpus speechlike]
        [--n 4] [--sr 16000] [--smooth 0|1] [--pb 0|1] [--det 0|1]
        [--seed 0] [--device cpu]

pb=0 (the default) mixes pulse and noise by the per-frame band-MEAN
aperiodicity; pb=1 mixes PER BAND (WORLD's multiband convention,
`ops.synthesis`'s default); det=1 zeroes the voiced frames' aperiodicity
(pulse-only voiced excitation); smooth=1 extracts with
`data.envelope_smoothing=true`. The JAX tool's grid measured the per-frame
mean as the best floor on every corpus and rate, so it defines the oracle.

Extraction, synthesis and scoring run on `--device` (default the card).
The excitation noise is drawn from a `torch.Generator` seeded from
`--seed`, anew for each utterance, as the JAX tool draws from
`jax.random.key(0)` for each; a caller may pass the noise in (`noise`).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.bin.feature_extract import extract_one
from shallow_wavenet_tpu_torch.bin.mcd_eval import eval_pair
from shallow_wavenet_tpu_torch.config import get_config
from shallow_wavenet_tpu_torch.data.audio_io import read_wav
from shallow_wavenet_tpu_torch.data.synthetic import make_corpus
from shallow_wavenet_tpu_torch.ops.synthesis import world_synthesis


def oracle_config(sr: int = 16000, smooth: bool = False):
    """The JAX tool's configuration: config 3's model and noise shaping,
    world features (aux 31) at `sr`."""
    return get_config("shallow_laplace_ns", [
        "data.feature_type=world", "model.aux_channels=31",
        f"data.sample_rate={sr}",
        f"data.envelope_smoothing={'true' if smooth else 'false'}",
    ])


def oracle_row(wav_path: str, cfg, per_band: bool = False,
               det: bool = False, seed: int = 0, noise=None,
               device=None) -> dict:
    """eval_pair of one utterance against its own analysis-synthesis.
    noise: a function of the length giving the (T,) excitation noise, or
    None to draw it from a generator seeded from `seed`."""
    dev = resolve_device(device)
    wav, _ = read_wav(wav_path)
    feats = extract_one(wav_path, cfg, device=dev)   # UN-normalized
    if det:
        # pulse-only voiced excitation: zero the bap columns
        feats = np.array(feats)
        feats[:, 2 + cfg.noise_shaping.mcep_order + 1:] = 0.0
    gen = (None if noise is not None
           else torch.Generator(device=dev).manual_seed(seed))
    syn = world_synthesis(
        torch.from_numpy(np.asarray(feats, np.float32)).to(dev),
        cfg.data.sample_rate, cfg.data.hop_length,
        cfg.noise_shaping.mcep_order, cfg.noise_shaping.alpha,
        t_len=len(wav), per_band=per_band,
        noise=None if noise is None else noise(len(wav)),
        generator=gen).cpu().numpy()
    return eval_pair(wav[: len(syn)], syn, cfg, dev)


def oracle_rows(corpus: str = "speechlike", n: int = 4, sr: int = 16000,
                smooth: bool = False, per_band: bool = False,
                det: bool = False, seed: int = 0, noise=None, device=None,
                log=print) -> list[dict]:
    """One `oracle_row` per eval utterance of a fresh synthetic corpus
    (make_corpus(n_train=1, n_eval=n, style=corpus)), each printed as the
    JAX tool prints it, then the mean MCD."""
    cfg = oracle_config(sr, smooth)
    rows = []
    with tempfile.TemporaryDirectory() as root:
        lists = make_corpus(root, n_train=1, n_eval=n, sample_rate=sr,
                            style=corpus)
        for p in lists["eval"]:
            m = oracle_row(p, cfg, per_band, det, seed, noise, device)
            rows.append(m)
            f0r = m.get("f0_rmse_hz")
            log(f"{os.path.basename(p)}: MCD {m['mcd_db']:.3f} dB  "
                f"F0-RMSE {f0r if f0r is None else round(f0r, 1)} Hz  "
                f"VUV-err {m['vuv_error_rate']:.3f}  "
                f"LSD {m['lsd_db']:.2f} dB")
    mcds = [r["mcd_db"] for r in rows]
    log(f"oracle (corpus={corpus} sr={sr} smooth={int(smooth)} "
        f"pb={int(per_band)} det={int(det)}): "
        f"mean MCD {np.mean(mcds):.3f} dB over {len(rows)} utts")
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--corpus", default="speechlike",
                    help="synthetic corpus style (make_corpus)")
    ap.add_argument("--n", type=int, default=4, help="eval utterances")
    ap.add_argument("--sr", type=int, default=16000)
    ap.add_argument("--smooth", type=int, choices=(0, 1), default=0)
    ap.add_argument("--pb", type=int, choices=(0, 1), default=0)
    ap.add_argument("--det", type=int, choices=(0, 1), default=0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the excitation noise")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' on the host)")
    args = ap.parse_args(argv)
    return oracle_rows(args.corpus, args.n, args.sr, bool(args.smooth),
                       bool(args.pb), bool(args.det), args.seed,
                       device=args.device)


if __name__ == "__main__":
    main()
