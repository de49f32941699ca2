"""Recipe runner — the torch twin of `shallow_wavenet_tpu/bin/run.py`.

    python -m shallow_wavenet_tpu_torch.bin.run --preset shallow_laplace_ns \
        --workdir exp --stage 0 --stop-stage 6 [--device cpu] [key=value ...]

Stages (the JAX recipe's numbering):
  0  data prep       — synthetic corpus + train/eval scp lists, or an
                       external corpus (--wav-dir), or existing scps
  1  feature extract — one HDF5 of features per utterance
  2  statistics      — mean/std (+ avg mcep with noise shaping)
  3  noise shaping   — MLSA pre-emphasis of the training waveforms
  4  train           — teacher-forced training
  5  decode          — AR generation on the card's kernel (copy-synthesis
                       of the eval set)
  6  restoration     — MLSA de-emphasis of the generated waveforms + MCD

`--stage N --stop-stage M` resumes mid-pipeline. `--device` goes to every
stage (default the card; `cpu` runs every stage on the host).
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.bin import (
    calc_stats, decode, feature_extract, mcd_eval, noise_shaping,
)
from shallow_wavenet_tpu_torch.bin import train as train_cli
from shallow_wavenet_tpu_torch.bin.common import resolve_config, setup_logging
from shallow_wavenet_tpu_torch.config import PRESETS
from shallow_wavenet_tpu_torch.data.dataset import read_file_list

log = logging.getLogger("run")


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="shallow_softmax_single",
                   choices=sorted(PRESETS))
    p.add_argument("--config", default=None)
    p.add_argument("--workdir", required=True)
    p.add_argument("--stage", type=int, default=0)
    p.add_argument("--stop-stage", type=int, default=6)
    p.add_argument("--steps", type=int, default=None,
                   help="override train steps")
    p.add_argument("--init-from", default=None,
                   help="fine-tune: warm-start stage-4 params from another "
                        "run's model dir (see bin/train.py --init-from)")
    p.add_argument("--n-train", type=int, default=8)
    p.add_argument("--n-eval", type=int, default=2)
    p.add_argument("--corpus-seed", type=int, default=1234,
                   help="synthetic-corpus RNG seed (stage 0)")
    p.add_argument("--corpus-style", default="harmonic",
                   choices=("harmonic", "speechlike", "formant"),
                   help="synthetic-corpus style (stage 0): 'speechlike' / "
                        "'formant' add F0 glides, unvoiced bursts and "
                        "silence")
    p.add_argument("--corpus-f0-range", default=None,
                   help="speechlike corpus F0 span as 'LO,HI' Hz (stage 0); "
                        "multi-speaker configs split it into per-speaker "
                        "bands")
    p.add_argument("--wav-dir", default=None,
                   help="stage 0: every *.wav under this directory "
                        "(recursive; any PCM width, rate or channel count: "
                        "resampled and downmixed on load), split into "
                        "train/eval scps instead of a synthetic corpus")
    p.add_argument("--device", default=None,
                   help="torch device of every stage (default cuda; 'cpu' "
                        "on the host)")
    p.add_argument("overrides", nargs="*")
    args = p.parse_args(argv)
    setup_logging()
    cfg = resolve_config(args)
    dev = ["--device", str(resolve_device(args.device))]
    ov = list(args.overrides or [])

    wd = Path(args.workdir)
    wd.mkdir(parents=True, exist_ok=True)
    corpus = wd / "corpus"
    feats = wd / "feats"
    stats = wd / "stats.h5"
    shaped = wd / "shaped_wav"
    gen = wd / "gen_wav"
    restored = wd / "restored_wav"
    train_scp = corpus / "train.scp"
    eval_scp = corpus / "eval.scp"
    model_dir = wd / "model"
    cfg_args = (["--config", args.config] if args.config
                else ["--preset", args.preset])

    def stage_on(n):
        return args.stage <= n <= args.stop_stage

    if stage_on(0):
        log.info("== stage 0: data prep ==")
        if train_scp.exists():
            log.info("scp lists already exist in %s — keeping", corpus)
        elif args.wav_dir:
            # external corpus: a sorted split, the last n_eval utterances
            # become the eval set
            wavs = sorted(str(p) for p in Path(args.wav_dir).rglob("*.wav"))
            if len(wavs) < 2:
                raise SystemExit(
                    f"--wav-dir {args.wav_dir}: need at least 2 wavs, "
                    f"found {len(wavs)}")
            n_eval = min(args.n_eval, len(wavs) - 1)
            corpus.mkdir(parents=True, exist_ok=True)
            train_scp.write_text("\n".join(wavs[:-n_eval]) + "\n")
            eval_scp.write_text("\n".join(wavs[-n_eval:]) + "\n")
            log.info("external corpus %s: %d train / %d eval",
                     args.wav_dir, len(wavs) - n_eval, n_eval)
        else:
            from shallow_wavenet_tpu_torch.data.synthetic import make_corpus

            f0r = None
            if args.corpus_f0_range:
                lo, _, hi = args.corpus_f0_range.partition(",")
                f0r = (float(lo), float(hi))
            make_corpus(
                corpus, n_train=args.n_train, n_eval=args.n_eval,
                sample_rate=cfg.data.sample_rate, duration_s=1.0,
                n_speakers=max(cfg.model.n_speakers, 1),
                seed=args.corpus_seed, style=args.corpus_style,
                f0_range=f0r,
            )
            log.info("synthetic corpus (%s): %d train / %d eval",
                     args.corpus_style, args.n_train, args.n_eval)

    if stage_on(1):
        log.info("== stage 1: feature extraction ==")
        # both splits share one feats dir keyed by wav stem: a duplicate
        # stem would cross-wire one split's waveforms with the other's
        # features
        stems: dict[str, str] = {}
        for scp in (train_scp, eval_scp):
            for wp in read_file_list(scp):
                stem = Path(wp).stem
                if stems.setdefault(stem, wp) != wp:
                    raise ValueError(
                        f"duplicate wav stem {stem!r}: {stems[stem]} and "
                        f"{wp} would write the same {stem}.h5 in {feats}")
        for scp in (train_scp, eval_scp):
            feature_extract.main(["--wav-scp", str(scp), "--outdir",
                                  str(feats), *dev, *cfg_args, *ov])

    if stage_on(2):
        log.info("== stage 2: statistics ==")
        calc_stats.main(["--wav-scp", str(train_scp), "--feats-dir",
                         str(feats), "--out", str(stats), *dev, *cfg_args,
                         *ov])

    if stage_on(3):
        if cfg.noise_shaping.enabled:
            log.info("== stage 3: noise shaping (pre-emphasis) ==")
            # both splits: training reads the shaped train waveforms, and
            # the dev loss must measure the same pre-emphasized signal
            for scp in (train_scp, eval_scp):
                noise_shaping.main(["--wav-scp", str(scp), "--stats",
                                    str(stats), "--outdir", str(shaped),
                                    *dev, *cfg_args, *ov])
        else:
            log.info("== stage 3: noise shaping disabled — skipped ==")

    if stage_on(4):
        log.info("== stage 4: training ==")
        extra = ["--steps", str(args.steps)] if args.steps else []
        if cfg.noise_shaping.enabled:
            extra += ["--waveform-dir", str(shaped)]
        if args.init_from:
            extra += ["--init-from", args.init_from]
        train_cli.main(["--train-scp", str(train_scp), "--dev-scp",
                        str(eval_scp), "--feats-dir", str(feats), "--stats",
                        str(stats), "--workdir", str(model_dir), *extra,
                        *dev, *cfg_args, *ov])

    if stage_on(5):
        log.info("== stage 5: decoding ==")
        decode.main(["--eval-scp", str(eval_scp), "--feats-dir", str(feats),
                     "--stats", str(stats), "--workdir", str(model_dir),
                     "--outdir", str(gen), *dev, *cfg_args, *ov])

    if stage_on(6):
        if cfg.noise_shaping.enabled:
            log.info("== stage 6: de-emphasis restoration + MCD ==")
            noise_shaping.main(["--wav-scp", str(eval_scp), "--stats",
                                str(stats), "--outdir", str(restored),
                                "--inv", "--indir", str(gen), *dev,
                                *cfg_args, *ov])
            final = restored
        else:
            log.info("== stage 6: restoration skipped (no noise shaping) ==")
            final = gen
        mcd_eval.main(["--ref-scp", str(eval_scp), "--gen-dir", str(final),
                       "--out", str(wd / "mcd.json"), *dev, *cfg_args, *ov])


if __name__ == "__main__":
    main()
