"""Noise shaping CLI — the torch twin of
`shallow_wavenet_tpu/bin/noise_shaping.py`.

    python -m shallow_wavenet_tpu_torch.bin.noise_shaping \
        --preset shallow_laplace_ns --wav-scp train.scp --stats stats.h5 \
        --outdir shaped_wav [--inv --indir gen_wav]

Pre-emphasis: filter training waveforms with the MLSA filter built from
-mag * avg_mcep (the whitening direction, c0 zeroed), so the model trains
on spectrally flattened audio and its noise lands under the speech
envelope after restoration. `--inv` applies the inverse (+mag * avg_mcep)
to generated waveforms (the recipe's stage 6 de-emphasis).

This is CPU data preparation, not a device kernel: it runs the native C++
filter (`utils/native.py`) where the library builds, and otherwise the
plain per-sample recursion of `ops/mlsa.py` on `--device`; both realize the
same Pade structure, and the log says which ran.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.bin.common import (
    add_config_args, resolve_config, setup_logging,
)
from shallow_wavenet_tpu_torch.data.audio_io import read_wav, write_wav
from shallow_wavenet_tpu_torch.data.dataset import read_file_list
from shallow_wavenet_tpu_torch.data.hdf5_io import read_hdf5
from shallow_wavenet_tpu_torch.utils.native import (
    mc2b_native, mlsa_filter_native, native_available,
)

log = logging.getLogger("noise_shaping")


def shaping_coefficients(stats_path: str, mag: float, alpha: float,
                         device=None) -> np.ndarray:
    """mc2b(-mag * avg_mcep) with c0 zeroed (pure shaping, no global gain
    from the corpus energy), float64."""
    avg = read_hdf5(stats_path, "avg_mcep").astype(np.float64)
    avg[0] = 0.0
    c = -mag * avg
    if native_available():
        return mc2b_native(c, alpha)
    from shallow_wavenet_tpu_torch.ops.mlsa import mc2b

    c = torch.as_tensor(c, dtype=torch.float32, device=resolve_device(device))
    return mc2b(c, alpha).cpu().numpy().astype(np.float64)


def filter_waveform(x: np.ndarray, b: np.ndarray, alpha: float,
                    pade_order: int, inverse: bool,
                    device=None) -> np.ndarray:
    if native_available():
        return mlsa_filter_native(x, b, alpha, pade_order, inverse)
    from shallow_wavenet_tpu_torch.ops.mlsa import mlsa_filter

    dev = resolve_device(device)
    return mlsa_filter(torch.from_numpy(np.ascontiguousarray(x, np.float32)
                                        ).to(dev),
                       torch.as_tensor(b, dtype=torch.float32, device=dev),
                       alpha, pade_order, inverse).cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wav-scp", required=True)
    p.add_argument("--stats", required=True, help="stats.h5 with avg_mcep")
    p.add_argument("--outdir", required=True)
    p.add_argument("--inv", action="store_true",
                   help="inverse filter (de-emphasis restoration)")
    p.add_argument("--indir", default=None,
                   help="read wavs from <indir>/<name> instead of scp paths "
                        "(restoring generated audio)")
    p.add_argument("--device", default=None,
                   help="torch device of the plain recursion, where the "
                        "native library does not build (default cuda; "
                        "'cpu' on the host)")
    add_config_args(p)
    args = p.parse_args(argv)
    setup_logging()
    cfg = resolve_config(args)
    dev = resolve_device(args.device)
    ns = cfg.noise_shaping

    log.info("filtering on %s", "the native C++ filter" if native_available()
             else f"the plain recursion on {dev}")
    b = shaping_coefficients(args.stats, ns.mag, ns.alpha, dev)
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    for wp in read_file_list(args.wav_scp):
        src = Path(args.indir) / Path(wp).name if args.indir else Path(wp)
        x, sr = read_wav(src, target_sr=cfg.data.sample_rate)
        if not args.inv and cfg.data.highpass_cutoff > 0:
            from shallow_wavenet_tpu_torch.ops.filters import highpass

            x = highpass(x, sr, cfg.data.highpass_cutoff)
        y = filter_waveform(x, b, ns.alpha, ns.pade_order, args.inv, dev)
        peak = np.abs(y).max()
        if peak > 1.0:
            log.warning("%s: peak %.3f after filtering — clipping", src, peak)
            y = np.clip(y, -1.0, 1.0)
        write_wav(outdir / Path(wp).name, y, sr)
        log.info("%s -> %s (%s)", src, outdir / Path(wp).name,
                 "de-emphasis" if args.inv else "pre-emphasis")


if __name__ == "__main__":
    main()
