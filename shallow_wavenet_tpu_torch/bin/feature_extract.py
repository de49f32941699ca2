"""Feature extraction CLI — the torch twin of
`shallow_wavenet_tpu/bin/feature_extract.py`.

    python -m shallow_wavenet_tpu_torch.bin.feature_extract \
        --preset shallow_laplace_single --wav-scp train.scp --outdir feats

wav scp -> one HDF5 per utterance with dataset 'feats': log-mel
(T//hop, n_mels), or the `world` set [log-F0 | vuv | mcep | bap], plus the
frame log-energy channel where `data.energy_feature` is set. Frames are
trimmed to exactly T//hop, so waveform and features stay aligned.

One process (the default) runs the torch analyzers on `--device` (default
the card; `--device cpu` on the host). `--num-workers N > 1` runs a spawn
pool of N CPU workers instead: the numpy log-mel mirror, or the native C++
world analyzers (`utils/native.py`); the workers never touch the card.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.bin.common import (
    add_config_args, feats_path_for, resolve_config, setup_logging,
)
from shallow_wavenet_tpu_torch.data.audio_io import read_wav, resample
from shallow_wavenet_tpu_torch.data.dataset import read_file_list
from shallow_wavenet_tpu_torch.data.hdf5_io import write_hdf5

log = logging.getLogger("feature_extract")


def extract_one(wav_path: str, cfg, numpy_only: bool = False,
                device=None) -> np.ndarray:
    """One utterance's feature matrix. numpy_only: the pooled workers'
    path (numpy log-mel, native world analyzers), on the host; otherwise
    the torch analyzers on `device` (None means the card)."""
    wav, sr = read_wav(wav_path)
    if sr != cfg.data.sample_rate:
        log.info("%s: resampling %d -> %d Hz", wav_path, sr,
                 cfg.data.sample_rate)
        wav = resample(wav, sr, cfg.data.sample_rate)
        sr = cfg.data.sample_rate
    if cfg.data.highpass_cutoff > 0:
        from shallow_wavenet_tpu_torch.ops.filters import highpass

        wav = highpass(wav, sr, cfg.data.highpass_cutoff)
    n_frames = len(wav) // cfg.data.hop_length

    def with_energy(feats: np.ndarray) -> np.ndarray:
        """data.energy_feature: append the frame log-RMS channel, numpy on
        both paths, so they agree bit for bit."""
        if not cfg.data.energy_feature:
            return feats
        from shallow_wavenet_tpu_torch.ops.energy import frame_log_energy

        e = frame_log_energy(wav, cfg.data.hop_length, feats.shape[0])
        return np.concatenate([feats, e], axis=-1)

    if numpy_only:
        if cfg.data.feature_type == "world":
            from shallow_wavenet_tpu_torch.utils.native import (
                world_features_native,
            )

            return with_energy(world_features_native(wav, cfg))
        from shallow_wavenet_tpu_torch.ops.stft import log_mel_spectrogram_np

        return with_energy(log_mel_spectrogram_np(
            wav, sr, cfg.data.n_fft, cfg.data.hop_length,
            cfg.data.win_length, cfg.data.n_mels, cfg.data.fmin,
            cfg.data.fmax,
        )[:n_frames])
    x = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(
        resolve_device(device))
    if cfg.data.feature_type == "world":
        from shallow_wavenet_tpu_torch.ops.f0 import (
            band_aperiodicity, estimate_f0, log_f0,
        )
        from shallow_wavenet_tpu_torch.ops.mcep import mcep_analysis

        f0, vuv = estimate_f0(x, sr, cfg.data.hop_length,
                              f0_min=cfg.data.f0_min, f0_max=cfg.data.f0_max)
        lf0 = log_f0(f0, vuv)
        mc = mcep_analysis(x, cfg.data.n_fft, cfg.data.hop_length,
                           cfg.data.win_length, cfg.noise_shaping.mcep_order,
                           cfg.noise_shaping.alpha,
                           f0_hz=(f0 * vuv if cfg.data.envelope_smoothing
                                  else None),
                           sample_rate=sr)
        bap = band_aperiodicity(x, f0, sr, cfg.data.hop_length,
                                n_bands=cfg.data.n_bap)
        n = min(lf0.shape[0], mc.shape[0], bap.shape[0], n_frames)
        feats = torch.cat([lf0[:n, None], vuv[:n, None], mc[:n], bap[:n]],
                          dim=-1)
        return with_energy(feats.cpu().numpy())
    from shallow_wavenet_tpu_torch.ops.stft import log_mel_spectrogram

    mel = log_mel_spectrogram(
        x, sr, cfg.data.n_fft, cfg.data.hop_length, cfg.data.win_length,
        cfg.data.n_mels, cfg.data.fmin, cfg.data.fmax,
    )
    return with_energy(mel.cpu().numpy()[:n_frames])


def _worker_init() -> None:
    """Pool workers hide every GPU, so nothing there can initialize CUDA
    on the card the parent or a training job holds."""
    import os

    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _process_one(wp: str, cfg, outdir: str, numpy_only: bool = False,
                 device=None) -> tuple[str, tuple]:
    feats = extract_one(wp, cfg, numpy_only=numpy_only, device=device)
    write_hdf5(feats_path_for(wp, outdir), "feats", feats)
    return wp, feats.shape


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wav-scp", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("--num-workers", type=int, default=1,
                   help="size of a spawn pool of CPU workers (numpy and "
                        "native analyzers); 1 runs the torch analyzers on "
                        "--device")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' on the host)")
    add_config_args(p)
    args = p.parse_args(argv)
    setup_logging()
    cfg = resolve_config(args)
    dev = resolve_device(args.device)

    paths = read_file_list(args.wav_scp)
    Path(args.outdir).mkdir(parents=True, exist_ok=True)
    if args.num_workers > 1:
        import functools
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        if cfg.data.feature_type == "world":
            # build the native library once, here: the workers then load
            # the finished library instead of racing to build it
            from shallow_wavenet_tpu_torch.utils.native import load_native

            load_native()
        # a worker that dies raises here (BrokenProcessPool), not a hang
        with ProcessPoolExecutor(args.num_workers,
                                 mp_context=mp.get_context("spawn"),
                                 initializer=_worker_init) as pool:
            done = list(pool.map(functools.partial(
                _process_one, cfg=cfg, outdir=args.outdir, numpy_only=True),
                paths))
    else:
        done = [_process_one(wp, cfg, args.outdir, device=dev)
                for wp in paths]
    for wp, shape in done:
        log.info("%s -> %s %s", wp, feats_path_for(wp, args.outdir), shape)
    log.info("extracted %d utterances", len(paths))


if __name__ == "__main__":
    main()
