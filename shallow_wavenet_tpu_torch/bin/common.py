"""Shared CLI plumbing — copies from `shallow_wavenet_tpu/bin/common.py`:
config resolution, logging, feature-only utterance loading."""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from shallow_wavenet_tpu_torch.config import Config, feature_dim, get_config
from shallow_wavenet_tpu_torch.data.dataset import Utterance, read_file_list
from shallow_wavenet_tpu_torch.data.hdf5_io import read_hdf5


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


def speaker_of(path: str | Path) -> int:
    """Parse the speaker id out of a `spkN_uttM.wav` filename (0 if absent)."""
    name = Path(path).stem
    if name.startswith("spk") and "_" in name:
        try:
            return int(name.split("_")[0][3:])
        except ValueError:
            return 0
    return 0


def load_stats(stats_path: str | Path):
    mean = read_hdf5(stats_path, "mean").astype(np.float32)
    std = read_hdf5(stats_path, "std").astype(np.float32)
    return mean, std


def load_utterances(wav_scp: str | Path, feats_dir: str | Path,
                    stats_path: str | Path | None = None) -> list[Utterance]:
    """Normalized features of every utterance in the list, for decoding
    (the JAX loader with load_wav=False: wav is an empty array)."""
    stats = load_stats(stats_path) if stats_path else None
    utts = []
    for p in read_file_list(wav_scp):
        feats = read_hdf5(feats_path_for(p, feats_dir), "feats").astype(np.float32)
        if stats is not None:
            feats = (feats - stats[0]) / np.maximum(stats[1], 1e-8)
        utts.append(Utterance(wav=np.zeros(0, np.float32), feats=feats,
                              speaker=speaker_of(p)))
    return utts
