"""File lists, receptive-field-aware segment batching and decode batching —
copies from `shallow_wavenet_tpu/data/dataset.py`.

Training batches are random fixed-length segments with left context equal to
the (hop-rounded) receptive field. Batch layout (B = batch, L =
segment_length, R = hop-rounded receptive field, H = hop_length, F =
n_mels):
  x:    (B, R + L)   float32 waveform; the model sees x[:, :-1] and the
                      teacher target is x[:, 1:], loss on the last L steps
  cond: (B, (R + L)//H, F) normalized frame features aligned to x
  spk:  (B,) int32 speaker ids

`SegmentSampler` is the JAX sampler line for line, on numpy's
`default_rng`: the same seed draws the JAX sampler's batches, bit for
bit, and its `state()` is the same JSON-safe dict.
"""

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


def shard_list(items: list, process_index: int, process_count: int) -> list:
    """Static per-process shard of a file list (multi-host data loading,
    SURVEY.md §5.8 — each host reads only its own utterances)."""
    return items[process_index::process_count]


@dataclass
class Utterance:
    wav: np.ndarray          # (T,) float32
    feats: np.ndarray        # (F_frames, n_mels) float32, already normalized
    speaker: int = 0


class SegmentSampler:
    """Infinite iterator of training batches of random segments.

    Each draw picks an utterance, then a random frame-aligned segment of
    `segment_length` samples, and packs `pad_frames` of left context
    (zero/edge padded where the segment starts near t=0).
    """

    def __init__(self, utterances: list[Utterance], *, batch_size: int,
                 segment_length: int, hop_length: int, receptive_field: int,
                 seed: int = 0, silence_boost: float = 0.0):
        if segment_length % hop_length != 0:
            raise ValueError("segment_length must be a multiple of hop_length")
        self.utts = utterances
        self.batch = batch_size
        self.seg = segment_length
        self.hop = hop_length
        # left context, rounded up to whole frames so cond stays frame-aligned
        self.pad_frames = -(-receptive_field // hop_length)
        self.pad = self.pad_frames * hop_length
        self.rng = np.random.default_rng(seed)
        self.min_frames = segment_length // hop_length
        usable = [u for u in self.utts
                  if u.feats.shape[0] >= self.min_frames]
        if not usable:
            raise ValueError("no utterance long enough for segment_length")
        self.utts = usable
        # silence-aware sampling (data.silence_boost): pool of (utt, start
        # frame) whose segment contains >= 10% silent frames; that fraction
        # of draws is redirected to the pool. boost=0 consumes NO extra RNG
        # draws, so existing streams/checkpoints replay identically
        self.silence_boost = float(silence_boost)
        if self.silence_boost > 0:
            self._sil_ui, self._sil_f0 = self._build_silence_pool()
        else:
            self._sil_ui = np.zeros(0, np.int32)
            self._sil_f0 = np.zeros(0, np.int32)

    def _build_silence_pool(self) -> tuple[np.ndarray, np.ndarray]:
        """(utt index, start frame) arrays of every segment position whose
        window contains >= 10% silent frames — vectorized (a real corpus
        has millions of candidate positions; parallel int32 arrays, not a
        Python tuple list)."""
        uis, f0s = [], []
        seg_frames = self.min_frames
        need = max(1, seg_frames // 10)
        for ui, u in enumerate(self.utts):
            n_frames = min(u.feats.shape[0], len(u.wav) // self.hop)
            if n_frames < seg_frames:
                continue
            fe = (u.wav[: n_frames * self.hop]
                  .reshape(n_frames, self.hop) ** 2).mean(axis=1)
            sil = fe < fe.max() * 1e-4          # 40 dB below peak frame
            if not sil.any():
                continue
            csum = np.concatenate([[0], np.cumsum(sil)])
            # windowed silent-frame count per candidate start position
            win = csum[seg_frames:] - csum[:n_frames - seg_frames + 1]
            valid = np.flatnonzero(win >= need).astype(np.int32)
            if valid.size:
                uis.append(np.full(valid.size, ui, np.int32))
                f0s.append(valid)
        if not uis:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        return np.concatenate(uis), np.concatenate(f0s)

    def state(self) -> dict:
        """Serializable iterator state for checkpoint/resume (SURVEY.md §5.4)."""
        return {"bit_generator_state": self.rng.bit_generator.state}

    def set_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state["bit_generator_state"]

    def _draw_one(self):
        seg_frames = self.seg // self.hop
        if (self._sil_ui.size
                and self.rng.random() < self.silence_boost):
            i = int(self.rng.integers(self._sil_ui.size))
            ui, f0 = int(self._sil_ui[i]), int(self._sil_f0[i])
            u = self.utts[ui]
        else:
            u = self.utts[self.rng.integers(len(self.utts))]
            n_frames = u.feats.shape[0]
            f0 = int(self.rng.integers(0, n_frames - seg_frames + 1))
        n_frames = u.feats.shape[0]
        s0 = f0 * self.hop
        total = self.pad + self.seg
        # waveform with left context (zeros before utterance start)
        x = np.zeros(total, dtype=np.float32)
        src_lo = max(0, s0 - self.pad)
        dst_lo = self.pad - (s0 - src_lo)
        seg_hi = min(len(u.wav), s0 + self.seg)
        x[dst_lo:dst_lo + (seg_hi - src_lo)] = u.wav[src_lo:seg_hi]
        # conditioning frames with edge replication on the left
        c = np.empty((self.pad_frames + seg_frames, u.feats.shape[1]),
                     dtype=np.float32)
        cf_lo = f0 - self.pad_frames
        for i in range(self.pad_frames + seg_frames):
            c[i] = u.feats[min(max(cf_lo + i, 0), n_frames - 1)]
        return x, c, u.speaker

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        xs, cs, spks = zip(*(self._draw_one() for _ in range(self.batch)))
        return {
            "x": np.stack(xs),
            "cond": np.stack(cs),
            "speaker": np.asarray(spks, dtype=np.int32),
        }


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
