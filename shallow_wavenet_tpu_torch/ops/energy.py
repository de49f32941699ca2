"""Frame log-energy conditioning channel — a copy of
`shallow_wavenet_tpu/ops/energy.py`, numpy only, so the torch feature path
and the pooled native path of `bin/feature_extract.py` append the same
channel bit for bit (`data.energy_feature`).

The world feature set encodes digital silence exactly like unvoiced noise
(vuv=0, bap=1; only the floored mcep differs); this channel is the explicit
silence/energy cue: frame log-RMS of the waveform, floored so digital zero
maps to one exact constant.
"""

from __future__ import annotations

import numpy as np

# amplitude floor: log(1e-5) = -11.51; digital-zero frames all land exactly
# here, ~ -100 dBFS — far below any voiced/unvoiced content
ENERGY_FLOOR = 1e-5


def frame_log_energy(wav: np.ndarray, hop_length: int,
                     n_frames: int = 0) -> np.ndarray:
    """(T,) waveform -> (n_frames, 1) float32 log frame RMS.

    Frame i is CENTERED at i*hop (edge-padded), matching the center=True
    framing convention of every other analyzer (stft/mcep/f0). The first
    version used the hop partition wav[i*hop:(i+1)*hop], which leads the
    rest of the conditioning by hop/2 (6.7 ms at 24 kHz/320): a strong
    energy cue firing half a frame early at every onset/offset — the r5
    deep run trained on it regressed 1.5 dB MCD with VUV errors
    0.24-0.42 concentrated at transitions. A frame whose centered window
    lies fully inside digital silence still reads exactly
    log(ENERGY_FLOOR).
    """
    wav = np.asarray(wav, np.float32)
    if n_frames <= 0:
        n_frames = len(wav) // hop_length
    half = hop_length // 2
    pad = np.pad(wav[: n_frames * hop_length].astype(np.float64),
                 (half, hop_length - half), mode="edge")
    fr = pad[: n_frames * hop_length].reshape(n_frames, hop_length)
    rms = np.sqrt(np.mean(fr * fr, axis=1))
    return np.log(np.maximum(rms, ENERGY_FLOOR)).astype(np.float32)[:, None]
