"""Statistics CLI — the torch twin of `shallow_wavenet_tpu/bin/calc_stats.py`.

    python -m shallow_wavenet_tpu_torch.bin.calc_stats \
        --preset shallow_laplace_ns --wav-scp train.scp --feats-dir feats \
        --out stats.h5

Mean and std of the features over the training list (float64 numpy, for
normalization) and, where noise shaping is configured, the training set's
average mel-cepstrum, which drives the MLSA pre-emphasis filter
(`ops/mcep.mcep_analysis` on `--device`, default the card). Writes
stats.h5 with datasets 'mean', 'std' (and 'avg_mcep').
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.bin.common import (
    add_config_args, feats_path_for, resolve_config, setup_logging,
)
from shallow_wavenet_tpu_torch.data.audio_io import read_wav
from shallow_wavenet_tpu_torch.data.dataset import read_file_list
from shallow_wavenet_tpu_torch.data.hdf5_io import read_hdf5, write_hdf5

log = logging.getLogger("calc_stats")


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wav-scp", required=True)
    p.add_argument("--feats-dir", required=True)
    p.add_argument("--out", required=True, help="output stats.h5")
    p.add_argument("--device", default=None,
                   help="torch device of the mcep analysis (default cuda; "
                        "'cpu' on the host)")
    add_config_args(p)
    args = p.parse_args(argv)
    setup_logging()
    cfg = resolve_config(args)
    dev = resolve_device(args.device)

    paths = read_file_list(args.wav_scp)
    # float64 accumulation: float32 sums over a large corpus lose the
    # E[x^2]-E[x]^2 cancellation badly when std << |mean| (log-mel dims)
    n, s1, s2 = 0, 0.0, 0.0
    for wp in paths:
        f = read_hdf5(feats_path_for(wp, args.feats_dir), "feats"
                      ).astype(np.float64)
        n += f.shape[0]
        s1 = s1 + f.sum(axis=0)
        s2 = s2 + (f ** 2).sum(axis=0)
    mean = s1 / n
    var = np.maximum(s2 / n - mean ** 2, 1e-12)
    write_hdf5(args.out, "mean", mean.astype(np.float32))
    write_hdf5(args.out, "std", np.sqrt(var).astype(np.float32))
    log.info("stats over %d frames -> %s", n, args.out)

    if cfg.noise_shaping.enabled:
        from shallow_wavenet_tpu_torch.ops.mcep import mcep_analysis

        ns = cfg.noise_shaping
        tot, cnt = 0.0, 0
        for wp in paths:
            wav, sr = read_wav(wp, target_sr=cfg.data.sample_rate)
            if cfg.data.highpass_cutoff > 0:
                # the shaping filter is fit to the same filtered signal
                # training and generation see
                from shallow_wavenet_tpu_torch.ops.filters import highpass

                wav = highpass(wav, sr, cfg.data.highpass_cutoff)
            mc = mcep_analysis(
                torch.from_numpy(np.ascontiguousarray(wav)).to(dev),
                cfg.data.n_fft, cfg.data.hop_length, cfg.data.win_length,
                ns.mcep_order, ns.alpha,
            )
            tot = tot + mc.cpu().numpy().sum(axis=0)
            cnt += mc.shape[0]
        avg_mcep = (tot / cnt).astype(np.float32)
        write_hdf5(args.out, "avg_mcep", avg_mcep)
        log.info("avg mcep (order %d, alpha %.3f) over %d frames on %s",
                 ns.mcep_order, ns.alpha, cnt, dev)


if __name__ == "__main__":
    main()
