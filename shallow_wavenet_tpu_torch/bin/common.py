"""Shared CLI plumbing — copies from `shallow_wavenet_tpu/bin/common.py`:
config resolution, logging, utterance loading."""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from shallow_wavenet_tpu_torch.config import Config, feature_dim, get_config
from shallow_wavenet_tpu_torch.data.audio_io import read_wav
from shallow_wavenet_tpu_torch.data.dataset import Utterance, read_file_list
from shallow_wavenet_tpu_torch.data.hdf5_io import read_hdf5
from shallow_wavenet_tpu_torch.data.synthetic import speaker_of


def setup_logging():
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )


def add_config_args(p: argparse.ArgumentParser):
    p.add_argument("--preset", default=None, help="named preset (see config.PRESETS)")
    p.add_argument("--config", default=None, help="path to a config.json")
    p.add_argument("overrides", nargs="*", help="key=value config overrides")


def resolve_config(args) -> Config:
    if args.config:
        cfg = Config.from_json(Path(args.config).read_text())
        if args.overrides:
            cfg = cfg.apply_overrides(list(args.overrides))
    elif args.preset:
        cfg = get_config(args.preset, list(args.overrides or []))
    else:
        raise SystemExit("one of --preset/--config is required")
    fd = feature_dim(cfg)
    if cfg.model.aux_channels != fd:
        raise SystemExit(
            f"model.aux_channels={cfg.model.aux_channels} does not match the "
            f"{cfg.data.feature_type!r} feature dimensionality {fd}; set "
            f"model.aux_channels={fd}"
        )
    return cfg


def feats_path_for(wav_path: str, feats_dir: str | Path) -> Path:
    return Path(feats_dir) / (Path(wav_path).stem + ".h5")


def load_stats(stats_path: str | Path):
    mean = read_hdf5(stats_path, "mean").astype(np.float32)
    std = read_hdf5(stats_path, "std").astype(np.float32)
    return mean, std


def load_utterances(wav_scp: str | Path, feats_dir: str | Path,
                    stats_path: str | Path | None = None,
                    waveform_dir: str | Path | None = None,
                    highpass_cutoff: float = 0.0,
                    sample_rate: int = 0,
                    load_wav: bool = True) -> list[Utterance]:
    """Load (wav, normalized feats) pairs for training/decoding.

    waveform_dir: if given, read the (noise-shaped) training waveform from
    <dir>/<stem>.wav instead of the original wav path.
    highpass_cutoff > 0 applies the corpus high-pass so the model
    trains/evaluates on the same filtered signal the features saw.
    load_wav=False skips reading/filtering the waveforms entirely (decoding
    consumes only the features; wav is set to an empty array).
    """
    stats = load_stats(stats_path) if stats_path else None
    utts = []
    for p in read_file_list(wav_scp):
        if load_wav:
            wav_p = (Path(waveform_dir) / Path(p).name) if waveform_dir else p
            # resample-on-load: features were extracted at the config rate,
            # so the waveform must land there too or wav/cond misalign
            wav, sr = read_wav(wav_p, target_sr=sample_rate)
            # noise-shaped waveforms (waveform_dir) were already high-passed
            # when they were made: filtering twice would double the
            # attenuation
            if highpass_cutoff > 0 and waveform_dir is None:
                from shallow_wavenet_tpu_torch.ops.filters import highpass

                wav = highpass(wav, sample_rate or sr, highpass_cutoff)
        else:
            wav = np.zeros(0, np.float32)
        feats = read_hdf5(feats_path_for(p, feats_dir), "feats").astype(np.float32)
        if stats is not None:
            feats = (feats - stats[0]) / np.maximum(stats[1], 1e-8)
        utts.append(Utterance(wav=wav.astype(np.float32), feats=feats,
                              speaker=speaker_of(p)))
    return utts
