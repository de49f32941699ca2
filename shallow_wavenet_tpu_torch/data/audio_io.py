"""wav read/write via stdlib `wave` — a copy of
`shallow_wavenet_tpu/data/audio_io.py`.

Reads 8/16/24/32-bit integer PCM, mono or multi-channel (downmixed), and
optionally resamples on load to a target rate. Writes 16-bit PCM mono.
"""

from __future__ import annotations

import wave
from math import gcd
from pathlib import Path

import numpy as np

# int PCM full-scale per sample width (bytes -> positive full scale)
_FULL_SCALE = {1: 127.0, 2: 32767.0, 3: 8388607.0, 4: 2147483647.0}


def _decode_pcm(raw: bytes, sampwidth: int) -> np.ndarray:
    if sampwidth == 2:
        return np.frombuffer(raw, dtype="<i2").astype(np.float32)
    if sampwidth == 3:
        # 24-bit little-endian packed: widen to i4 via a zero pad byte in
        # the LOW position, then arithmetic-shift to restore sign
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        padded = np.zeros((b.shape[0], 4), np.uint8)
        padded[:, 1:] = b
        return (padded.view("<i4")[:, 0] >> 8).astype(np.float32)
    if sampwidth == 4:
        return np.frombuffer(raw, dtype="<i4").astype(np.float32)
    if sampwidth == 1:
        # 8-bit wav is UNSIGNED
        return np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0
    raise ValueError(f"unsupported PCM sample width {sampwidth} bytes")


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase rational resampling (scipy kaiser-windowed FIR)."""
    if sr_in == sr_out:
        return np.asarray(x, np.float32)
    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(np.asarray(x, np.float64), sr_out // g,
                         sr_in // g).astype(np.float32)


def read_wav(path: str | Path, target_sr: int = 0
             ) -> tuple[np.ndarray, int]:
    """Read an integer-PCM wav. Returns (float32 in [-1, 1], sr).

    Multi-channel audio is averaged to mono (the reference pipeline is mono
    speech; SURVEY.md C2). target_sr > 0 resamples on load and returns
    target_sr; non-PCM containers (float/ADPCM) raise `wave.Error` with the
    file named.
    """
    try:
        with wave.open(str(path), "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            ch = w.getnchannels()
            sw = w.getsampwidth()
            raw = w.readframes(n)
    except wave.Error as e:
        raise wave.Error(
            f"{path}: {e} (only integer-PCM wav is supported; convert "
            f"float/compressed audio during data prep)") from e
    x = _decode_pcm(raw, sw) / _FULL_SCALE[sw]
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    x = x.astype(np.float32)
    if target_sr > 0 and sr != target_sr:
        x = resample(x, sr, target_sr)
        sr = target_sr
    return x, sr


def write_wav(path: str | Path, x: np.ndarray, sample_rate: int) -> None:
    """Write float array in [-1, 1] as 16-bit PCM mono wav."""
    x = np.asarray(x, dtype=np.float32)
    q = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(q.tobytes())
