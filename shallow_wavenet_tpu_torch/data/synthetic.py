"""Deterministic synthetic speech-like corpus — a copy of
`shallow_wavenet_tpu/data/synthetic.py` (same RNG call sequence, so the
same seeds write the same wavs, byte for byte).

Harmonic signals with slowly varying F0 and spectral envelope plus a noise
floor — enough structure for training and copy-synthesis smoke runs without
any real speech data.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from shallow_wavenet_tpu_torch.data.audio_io import write_wav


def synth_utterance(seed: int, sample_rate: int, duration_s: float = 1.0
                    ) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(sample_rate * duration_s)
    t = np.arange(n) / sample_rate
    # slowly varying F0 in 80-300 Hz
    f0_base = rng.uniform(90.0, 250.0)
    f0 = f0_base * (1.0 + 0.15 * np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sample_rate
    x = np.zeros(n)
    n_harm = int((sample_rate / 2 - 200) // f0_base)
    decay = rng.uniform(0.5, 0.9)
    for k in range(1, min(n_harm, 20) + 1):
        amp = decay ** (k - 1) * rng.uniform(0.6, 1.0)
        x += amp * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
    # amplitude envelope (syllable-ish) + noise floor
    env = 0.3 + 0.7 * 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 5) * t
                                        + rng.uniform(0, 2 * np.pi)))
    x = x * env + 0.01 * rng.standard_normal(n)
    x = 0.6 * x / np.max(np.abs(x))
    return x.astype(np.float32)


def synth_utterance_speechlike(seed: int, sample_rate: int,
                               duration_s: float = 1.0,
                               f0_range: tuple[float, float] = (90.0, 240.0),
                               f0_clip: tuple[float, float] = (80.0, 300.0),
                               formant_envelope: bool = False,
                               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Harder, speech-shaped test signal (VERDICT r1 item 4): alternating
    voiced stretches (harmonics with F0 GLIDES), unvoiced fricative-like
    noise bursts, and true silence gaps. Returns (wav, f0_track,
    voiced_mask) at SAMPLE resolution — the ground truth the F0-estimator
    accuracy tests frame-average against (tests/test_f0.py).

    f0_range bounds each voiced segment's starting F0; glide targets are
    clipped to f0_clip. The defaults reproduce the round-2..4 corpora
    bit-for-bit (same RNG call sequence); a wide range (e.g. 80-340 Hz)
    is the pitch-control training corpus of VERDICT r4 item 2 — keep
    extraction f0_min/f0_max covering [0.9*lo, 1.15*hi].

    formant_envelope=False weights harmonic k by decay**(k-1) — a
    function of HARMONIC INDEX, so the spectral envelope's shape in Hz
    scales with F0 and envelope tilt alone predicts pitch (a vocoder
    conditioned on mcep can then ignore the lf0 channel entirely,
    measured in the r5 pitch-transposition runs). True instead samples
    2-3 random FIXED-frequency formant resonances per voiced segment and
    weights each harmonic by the envelope at its instantaneous absolute
    frequency H(k*f0(t)) — real speech's source-filter independence, so
    across the corpus mcep carries no pitch information and lf0 is the
    only pitch cue. Default False keeps the historical corpora
    bit-for-bit."""
    rng = np.random.default_rng(seed)
    n = int(sample_rate * duration_s)
    wav = np.zeros(n, np.float64)
    f0_track = np.zeros(n, np.float64)
    voiced = np.zeros(n, bool)
    t0 = 0
    # segment sequence: voiced / unvoiced / silence with speech-ish durations
    while t0 < n:
        kind = rng.choice(["voiced", "unvoiced", "silence"],
                          p=[0.6, 0.25, 0.15])
        dur = int(rng.uniform(0.08, 0.30) * sample_rate)
        t1 = min(t0 + dur, n)
        seg = np.arange(t1 - t0) / sample_rate
        if kind == "voiced" and t1 - t0 > sample_rate // 50:
            fa = rng.uniform(*f0_range)
            fb = np.clip(fa * rng.uniform(0.7, 1.4), *f0_clip)
            f0 = fa + (fb - fa) * seg / seg[-1]          # linear glide
            phase = 2 * np.pi * np.cumsum(f0) / sample_rate
            x = np.zeros(t1 - t0)
            n_harm = min(int((sample_rate / 2 - 200) / fb), 18)
            decay = rng.uniform(0.5, 0.85)
            if formant_envelope:
                # 2-3 Gaussian resonances at F0-independent absolute
                # frequencies + a gentle spectral tilt; each harmonic's
                # amplitude follows the envelope at its own time-varying
                # frequency k*f0(t)
                n_form = rng.integers(2, 4)
                lo_c = np.array([250.0, 900.0, 2000.0])[:n_form]
                hi_c = np.array([900.0, 2200.0, 3600.0])[:n_form]
                centers = rng.uniform(lo_c, hi_c)
                bws = rng.uniform(120.0, 400.0, n_form)
                gains = rng.uniform(0.4, 1.0, n_form)
                tilt = rng.uniform(1e-4, 4e-4)

                def h_env(freq):
                    e = sum(g * np.exp(-0.5 * ((freq - c) / b) ** 2)
                            for g, c, b in zip(gains, centers, bws))
                    return (e + 0.05) * np.exp(-tilt * freq)

                for k in range(1, max(n_harm, 1) + 1):
                    x += (h_env(k * f0)
                          * np.sin(k * phase + rng.uniform(0, 2 * np.pi)))
            else:
                for k in range(1, max(n_harm, 1) + 1):
                    x += (decay ** (k - 1) * rng.uniform(0.5, 1.0)
                          * np.sin(k * phase + rng.uniform(0, 2 * np.pi)))
            # onset/offset ramps (no clicks) + slow amplitude movement
            env = np.minimum(1.0, np.minimum(seg, seg[-1] - seg)
                             / 0.012)
            env = env * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(1, 4)
                                            * seg + rng.uniform(0, 7)))
            x = x * env + 0.005 * rng.standard_normal(t1 - t0)
            wav[t0:t1] = x
            f0_track[t0:t1] = f0
            voiced[t0:t1] = env > 0.1
        elif kind == "unvoiced":
            # band-passed noise burst (fricative-ish): difference filter
            # tilts the noise toward high frequencies
            x = rng.standard_normal(t1 - t0)
            x = np.diff(x, prepend=0.0)
            env = np.minimum(1.0, np.minimum(seg, seg[-1] - seg + 1e-9)
                             / 0.01)
            wav[t0:t1] = 0.25 * x * env
        # silence: leave zeros
        t0 = t1
    peak = np.max(np.abs(wav))
    if peak > 0:
        wav = 0.6 * wav / peak
    return wav.astype(np.float32), f0_track.astype(np.float32), voiced


def make_corpus(root: str | Path, *, n_train: int = 8, n_eval: int = 2,
                sample_rate: int = 16000, duration_s: float = 1.0,
                seed: int = 1234, n_speakers: int = 1,
                style: str = "harmonic",
                f0_range: tuple[float, float] | None = None
                ) -> dict[str, list[str]]:
    """Write wavs + scp file lists under `root`. Returns {'train': [...],
    'eval': [...]} wav paths. Speaker id is seed % n_speakers (encoded in
    the filename `spkN_uttM.wav`). style='speechlike' writes the harder
    glide/burst/silence corpus of synth_utterance_speechlike;
    style='formant' is the same corpus with F0-independent formant
    envelopes (source-filter independence — the pitch-control training
    corpus; see synth_utterance_speechlike).

    f0_range (speechlike only): overall F0 span of the corpus. None keeps
    the historical default (90-240 Hz, bit-identical RNG stream). With
    n_speakers > 1 the span is split log-uniformly into per-speaker bands
    (VERDICT r4 item 2's 'speaker F0 bands'); with one speaker every
    utterance draws from the full span."""
    root = Path(root)
    lists: dict[str, list[str]] = {}
    idx = 0

    def spk_f0(spk: int) -> dict:
        if f0_range is None:
            return {}
        lo, hi = float(f0_range[0]), float(f0_range[1])
        if n_speakers > 1:
            edges = np.exp(np.linspace(np.log(lo), np.log(hi),
                                       n_speakers + 1))
            lo, hi = float(edges[spk]), float(edges[spk + 1])
        return {"f0_range": (lo, hi),
                "f0_clip": (max(0.9 * lo, 1.0), 1.15 * hi)}

    for split, count in (("train", n_train), ("eval", n_eval)):
        paths = []
        for _ in range(count):
            spk = idx % n_speakers
            if style in ("speechlike", "formant"):
                wav, _, _ = synth_utterance_speechlike(
                    seed + idx, sample_rate, duration_s,
                    formant_envelope=(style == "formant"), **spk_f0(spk))
            else:
                wav = synth_utterance(seed + idx, sample_rate, duration_s)
            # stem is unique ACROSS splits: feature files are keyed by stem
            # in one shared feats dir (bin/common.feats_path_for), so a
            # train/eval stem collision would silently cross-wire waveforms
            # with the other split's features
            p = root / "wav" / split / f"spk{spk}_utt{idx:03d}.wav"
            write_wav(p, wav, sample_rate)
            paths.append(str(p))
            idx += 1
        (root / f"{split}.scp").write_text("\n".join(paths) + "\n")
        lists[split] = paths
    return lists


def speaker_of(path: str | Path) -> int:
    """Parse the speaker id out of a `spkN_uttM.wav` filename (0 if absent)."""
    name = Path(path).stem
    if name.startswith("spk") and "_" in name:
        try:
            return int(name.split("_")[0][3:])
        except ValueError:
            return 0
    return 0
