"""Waveform pre-filters — a copy of `shallow_wavenet_tpu/ops/filters.py`.

The corpus high-pass (remove DC and rumble below ~70 Hz) applied before
feature extraction and training; host CPU, scipy, at data-load time.
"""

from __future__ import annotations

import numpy as np
from scipy.signal import butter, sosfiltfilt


def highpass(x: np.ndarray, sample_rate: int, cutoff: float,
             order: int = 5) -> np.ndarray:
    """Zero-phase Butterworth high-pass; no-op for cutoff <= 0."""
    if cutoff <= 0:
        return x
    sos = butter(order, cutoff, btype="highpass", fs=sample_rate,
                 output="sos")
    return sosfiltfilt(sos, x).astype(np.float32)
