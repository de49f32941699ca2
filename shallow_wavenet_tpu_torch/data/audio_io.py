"""wav writing via stdlib `wave` — a copy of `write_wav` from
`shallow_wavenet_tpu/data/audio_io.py`."""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np


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
