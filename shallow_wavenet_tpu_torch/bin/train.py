"""Training CLI — the torch twin of `shallow_wavenet_tpu/bin/train.py`.
Resumes automatically from the latest checkpoint in --workdir.

    python -m shallow_wavenet_tpu_torch.bin.train --preset shallow_laplace_single \
        --train-scp train.scp --dev-scp dev.scp --feats-dir feats \
        --stats stats.h5 --workdir exp

Data-parallel over N GPUs of one host, one process per GPU:

    torchrun --nproc-per-node N -m shallow_wavenet_tpu_torch.bin.train ...

Each rank trains on its shard of the utterance list (`process_shard`) and
draws `data.batch_size` rows per update from it, so the global batch is
`batch_size x N`, as the JAX CLI draws `batch_size x local devices` rows
per process. Without the launcher a config whose mesh asks for more than
one device (`multihost`, `num_devices > 1`) trains on the one device with
a warning, as the JAX CLI does (`parallel.init_distributed`). `--device
cpu` trains on the host (gloo under the launcher).

`--profile` writes a torch.profiler trace of the whole `fit` to
`<workdir>/profile/` (one `*.pt.trace.json` per process; see
`utils.observability.maybe_profile`). `--debug-nans` fails fast: autograd's
anomaly mode and a finiteness check of every update, which raises
`FloatingPointError` at the first non-finite loss, gradient or parameter
(`utils.observability.enable_debug_mode`; one host sync per update). Both
are off by default and change no number of the run.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import torch
import torch.distributed as dist

from shallow_wavenet_tpu_torch.bin.common import (
    add_config_args, load_utterances, resolve_config, setup_logging,
)
from shallow_wavenet_tpu_torch.data.dataset import SegmentSampler, read_file_list
from shallow_wavenet_tpu_torch.parallel import (
    init_distributed, process_shard, shutdown,
)
from shallow_wavenet_tpu_torch.training import Trainer
from shallow_wavenet_tpu_torch.utils.observability import (
    debug_mode, disable_debug_mode, enable_debug_mode, maybe_profile,
)

log = logging.getLogger("train")


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train-scp", required=True)
    p.add_argument("--dev-scp", default=None,
                   help="held-out list for periodic eval loss")
    p.add_argument("--feats-dir", required=True)
    p.add_argument("--stats", default=None)
    p.add_argument("--waveform-dir", default=None,
                   help="noise-shaped training waveforms")
    p.add_argument("--workdir", required=True)
    p.add_argument("--init-from", default=None,
                   help="warm-start params from another run's latest "
                        "checkpoint (fine-tuning); optimizer, step and LR "
                        "schedule start fresh. Ignored when --workdir "
                        "already has a checkpoint to resume from.")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' trains on the "
                        "host)")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace to <workdir>/profile")
    p.add_argument("--debug-nans", action="store_true",
                   help="fail fast on the first non-finite loss, gradient "
                        "or parameter (anomaly mode; one sync per update)")
    add_config_args(p)
    args = p.parse_args(argv)
    setup_logging()
    cfg = resolve_config(args)
    debug_was_on = debug_mode()
    if args.debug_nans:
        enable_debug_mode()
    joined = dist.is_initialized()
    try:
        device = init_distributed(cfg.mesh, args.device)
        try:
            _train(args, cfg, device)
        finally:
            if not joined:
                shutdown()
    finally:
        # the mode is process-wide: leave a caller's process as it was
        if args.debug_nans and not debug_was_on:
            disable_debug_mode()


def _train(args, cfg, device):
    trainer = Trainer(cfg, device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    utts = load_utterances(args.train_scp, args.feats_dir, args.stats,
                           args.waveform_dir,
                           highpass_cutoff=cfg.data.highpass_cutoff,
                           sample_rate=cfg.data.sample_rate)
    utts = process_shard(utts)
    log.info("loaded %d utterances (this rank)", len(utts))
    sampler = SegmentSampler(
        utts, batch_size=cfg.data.batch_size,
        segment_length=cfg.data.segment_length,
        hop_length=cfg.data.hop_length,
        receptive_field=cfg.model.receptive_field,
        seed=cfg.train.seed,
        silence_boost=cfg.data.silence_boost,
    )

    eval_batches = None
    if args.dev_scp:
        # eval on the SAME signal distribution as training: with noise
        # shaping the dev waveforms must be the pre-emphasized ones, else
        # eval loss measures a spectrally different target
        dev_wavdir = args.waveform_dir
        if dev_wavdir:
            missing = [p for p in read_file_list(args.dev_scp)
                       if not (Path(dev_wavdir) / Path(p).name).exists()]
            if missing:
                log.warning(
                    "%d dev waveform(s) missing from %s; eval loss falls "
                    "back to unshaped dev waveforms", len(missing),
                    dev_wavdir)
                dev_wavdir = None
        dev_utts = load_utterances(args.dev_scp, args.feats_dir, args.stats,
                                   dev_wavdir,
                                   highpass_cutoff=cfg.data.highpass_cutoff,
                                   sample_rate=cfg.data.sample_rate)
        dev_sampler = SegmentSampler(
            dev_utts, batch_size=cfg.data.batch_size,
            segment_length=cfg.data.segment_length,
            hop_length=cfg.data.hop_length,
            receptive_field=cfg.model.receptive_field, seed=12345,
        )
        eval_batches = [next(dev_sampler) for _ in range(4)]

    state = trainer.init_state()
    state, sampler_state, start = trainer.restore(args.workdir, state)
    if sampler_state is not None:
        sampler.set_state(sampler_state)
    if start == 0 and args.init_from:
        # fine-tune: fresh run seeded with pretrained params; own-workdir
        # resume takes precedence so a preempted fine-tune continues itself
        state = trainer.warm_start(args.init_from, state)
    with maybe_profile(Path(args.workdir) / "profile" if args.profile
                       else None):
        trainer.fit(state, sampler, args.workdir, steps=args.steps,
                    eval_batches=eval_batches)


if __name__ == "__main__":
    main()
