"""File lists and decode batching — copies from
`shallow_wavenet_tpu/data/dataset.py` (training segment sampling comes with
the training slice)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


def read_file_list(path: str | Path) -> list[str]:
    """One path (or `id path`) per line; '#' comments and blanks skipped."""
    out = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        out.append(line.split()[-1])
    return out


@dataclass
class Utterance:
    wav: np.ndarray          # (T,) float32
    feats: np.ndarray        # (F_frames, n_mels) float32, already normalized
    speaker: int = 0


def pad_batch_for_decode(utts: list[Utterance], hop_length: int
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack utterances for batched AR generation: pad cond frames to the max
    length. Returns (cond (B,Fmax,n_mels), n_frames (B,), n_samples (B,))."""
    fmax = max(u.feats.shape[0] for u in utts)
    nm = utts[0].feats.shape[1]
    cond = np.zeros((len(utts), fmax, nm), dtype=np.float32)
    nf = np.zeros(len(utts), dtype=np.int32)
    for i, u in enumerate(utts):
        cond[i, : u.feats.shape[0]] = u.feats
        nf[i] = u.feats.shape[0]
    return cond, nf, nf * hop_length
