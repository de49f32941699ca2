"""Decoding CLI — batched copy-synthesis with the AR kernel; the torch twin
of `shallow_wavenet_tpu/bin/decode.py`.

Reads normalized features (--feats-dir, --stats), loads the weights from the
latest checkpoint of a training run (--workdir, `bin/train.py`) or from a
flat .npz of the flax parameter tree (--params; see
models.wavenet.save_params_npz), upsamples the conditioning, generates each
padded batch with a CUDA AR kernel in one launch, trims every utterance to
n_frames * hop and writes wavs plus decode_summary.json (audio-seconds/s,
RTF and the kernel layout that ran). There is no try-and-fall-back
ladder: the layout is the first of KERNEL_LAYOUTS that fits the device,
chosen from the kernels' own sizes and occupancy query before any launch;
a failed launch raises. The cluster kernel (`csrc/ar_cluster.cu`, a
cluster of N SMs per row, each reading 1/N of the weights) comes first,
unfused and with --fused W, the fused window; the one-SM-per-row kernel
(`csrc/ar_generate.cu`) is the fallback where no cluster fits the model,
dtype and window. After the fp32 layouts of both, before any bf16 one,
the cluster kernel's wide form (fp32, unfused) takes models that no other
fp32 layout holds. Where no layout fits the fused window W at all,
--fused is dropped with a warning and the unfused layouts are tried, as
the JAX tier ladder does (`decode_layout`); where none of those fits
either, the decode raises.

`--f0-factor F` (world features only) moves the log-F0 conditioning by
ln F on voiced frames before synthesis (`shift_f0`): pitch transposition
through the vocoder. `--profile` writes a torch.profiler trace of the
batch loop to `<outdir>/profile/` (`utils.observability.maybe_profile`).

    python -m shallow_wavenet_tpu_torch.bin.decode --preset shallow_laplace_single \
        --eval-scp eval.scp --feats-dir feats --stats stats.h5 \
        --params params.npz --outdir out
    python -m shallow_wavenet_tpu_torch.bin.decode --preset shallow_laplace_single \
        --eval-scp eval.scp --feats-dir feats --stats stats.h5 \
        --workdir exp --outdir out
    python -m shallow_wavenet_tpu_torch.bin.decode --preset deep_baseline \
        --kernel-dtype bfloat16 --eval-scp eval.scp --feats-dir feats \
        --stats stats.h5 --params params.npz --outdir out
    python -m shallow_wavenet_tpu_torch.bin.decode --preset shallow_laplace_single \
        --fused 4 --eval-scp eval.scp --feats-dir feats --stats stats.h5 \
        --params params.npz --outdir out

`--dp` splits each batch's rows over the visible GPUs (cut to
`mesh.num_devices`; with `--device cpu` the host stands in for
`max(1, mesh.num_devices)` devices), one kernel call per device
(`models.generate.generate_dp`). The batch is padded to a multiple of the
devices by repeating its last row, after the noise is drawn at the true
batch shape, and trimmed after: the samples are the single-device
decode's with the same --seed.
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.bin.common import (
    add_config_args, load_stats, load_utterances, resolve_config,
    setup_logging,
)
from shallow_wavenet_tpu_torch.config import Config
from shallow_wavenet_tpu_torch.data.audio_io import write_wav
from shallow_wavenet_tpu_torch.data.dataset import (
    pad_batch_for_decode, read_file_list,
)
from shallow_wavenet_tpu_torch.models.generate import (
    generate_dp, generate_segmented,
)
from shallow_wavenet_tpu_torch.models.wavenet import (
    WaveNet, extract_plain_params, load_params_npz, params_from_flax,
)
from shallow_wavenet_tpu_torch.ops import ar_kernel
from shallow_wavenet_tpu_torch.parallel import dp_devices
from shallow_wavenet_tpu_torch.training import Trainer
from shallow_wavenet_tpu_torch.utils.observability import maybe_profile, span

log = logging.getLogger("decode")

# decode_batch calls in this process: each call's spans carry its number
_CALLS = itertools.count()


def load_model_state(cfg: Config, workdir: str, device=None
                     ) -> tuple[WaveNet, int]:
    """The params of --workdir's latest checkpoint in the port's WaveNet,
    on the device, and the checkpoint's step (0: none found, the model
    keeps the trainer's random init, as in the JAX decode)."""
    trainer = Trainer(cfg, device)
    state, _, step = trainer.restore(workdir, trainer.init_state())
    if step == 0:
        log.warning("no checkpoint found in %s — decoding with random init",
                    workdir)
    model = params_from_flax(WaveNet(cfg.model),
                             trainer.params_tree(state.params))
    return model.to(trainer.device), step

# The kernel layouts, in order: (dtype, streamed, chunk, cluster). Every
# fp32 layout comes before any bf16 one, as in the JAX decode's tier order
# (PALLAS_TIERS), so "auto" lowers the precision only where no fp32 layout
# fits. Within a dtype, the cluster kernel first (cluster=True: its size N
# is the model's, the fused window's and the card's,
# `ar_kernel.cluster_size`; its rings are always resident), then the
# one-SM-per-row kernel, where streaming moves
# the rings of the layers whose dilation is a >1 multiple of the chunk from
# shared to global memory. The fp32 layouts of one kernel give identical
# samples. Last of the fp32 layouts, the cluster kernel's wide form
# (cluster=WIDE: unfused; gate width up to 2048, the rings of the large
# dilations in global memory, the weights streamed in tiles), for models
# that no fp32 layout above holds (the speaker-dependent vocoder's R 512,
# G 1024): after them, so that every model one of them fits keeps it.
WIDE = "wide"
KERNEL_LAYOUTS = (
    ("float32", False, 64, True),
    ("float32", False, 64, False),
    ("float32", True, 64, False),
    ("float32", True, 32, False),
    ("float32", False, 64, WIDE),
    ("bfloat16", False, 64, True),
    ("bfloat16", False, 64, False),
    ("bfloat16", True, 64, False),
    ("bfloat16", True, 32, False),
)


class NoLayoutError(ValueError):
    """No AR kernel layout of the asked dtype and window fits the device."""


def kernel_layout(model_cfg, kernel_dtype: str = "auto", device=None,
                  fused: int = 0, cluster: bool = True) -> dict:
    """The first of KERNEL_LAYOUTS of `kernel_dtype` ("auto": any) that
    fits the CUDA `device`: a cluster layout where the cluster kernel has a
    size for this model, dtype, fused window W (fused > 0) and card
    (`ar_kernel.cluster_size`: its block's shared memory and occupancy),
    an `ar_generate` layout where its shared memory (`ar_smem_bytes`, for
    the fused window when fused > 0) fits a block. On the CPU, where the
    plain version has no such limits, the first of that dtype. A streamed
    layout that streams no layer is the resident one and is skipped;
    cluster=False skips the cluster layouts; the wide form, only on a
    card, takes no fused window. Returns the generate() keywords {"dtype",
    "stream", "chunk", "fused", "cluster"} (cluster: N, or 0 for
    ar_generate), and "wide": True for the wide form. Raises NoLayoutError
    (a ValueError) when none fits."""
    dev = resolve_device(device)
    if kernel_dtype not in ("auto", *ar_kernel.DTYPES):
        raise ValueError(f"unknown kernel dtype {kernel_dtype!r}")
    limit = ar_kernel.smem_limit(dev) if dev.type == "cuda" else None
    for dtype, stream, chunk, clustered in KERNEL_LAYOUTS:
        if kernel_dtype not in ("auto", dtype):
            continue
        if clustered == WIDE:
            n = (ar_kernel.cluster_size(model_cfg, dtype, dev, 0, wide=True)
                 if cluster and not fused and dev.type == "cuda" else 0)
            if n:
                return {"dtype": dtype, "stream": False, "chunk": chunk,
                        "fused": 0, "cluster": n, "wide": True}
            continue
        if clustered:
            n = (ar_kernel.cluster_size(model_cfg, dtype, dev, fused)
                 if cluster else 0)
            if n:
                return {"dtype": dtype, "stream": False, "chunk": chunk,
                        "fused": fused, "cluster": n}
            continue
        if stream and not ar_kernel.stream_split(model_cfg.dilations, chunk,
                                                 True)[1]:
            continue
        if limit is None or ar_kernel.smem_bytes(
                model_cfg, dtype, stream, chunk, fused) <= limit:
            return {"dtype": dtype, "stream": stream, "chunk": chunk,
                    "fused": fused, "cluster": 0}
    raise NoLayoutError(f"no AR kernel layout of dtype {kernel_dtype!r} and "
                        f"fused={fused} fits the shared memory of a block "
                        f"on {dev}")


def decode_layout(model_cfg, kernel_dtype: str = "auto", device=None,
                  fused: int = 0) -> dict:
    """The decode's layout: kernel_layout for the fused window W = fused;
    where none fits W, --fused is dropped with a warning and the unfused
    layout is taken, as the JAX tier ladder retries without --fused
    (`_run_tier_ladder`). The choice is made from the kernels' byte counts
    and occupancy query before any launch; it raises NoLayoutError where
    no unfused layout fits either."""
    try:
        return kernel_layout(model_cfg, kernel_dtype, device, fused)
    except NoLayoutError as e:
        if not fused:
            raise
        layout = kernel_layout(model_cfg, kernel_dtype, device, 0)
        log.warning("%s; --fused %d dropped: decoding on the unfused "
                    "layout %s", e, fused, layout)
        return layout


def warn_waves(model_cfg, layout: dict, batch_size: int, device=None
               ) -> int:
    """Log a warning when a batch of `batch_size` rows is more than the
    card holds clusters of the layout's size at once: the cluster kernel
    then runs the batch in waves, and past a few waves the one-SM-per-row
    kernel is faster (README). Returns the number of waves (1 off the
    cluster kernel or the card)."""
    n, dtype, dev = layout["cluster"], layout["dtype"], resolve_device(device)
    if not n or dev.type != "cuda":
        return 1
    fused = layout["fused"]
    if layout.get("wide"):
        at_once = ar_kernel.max_active_clusters(model_cfg, dtype, n, False,
                                                dev, fused, wide=True)
    else:
        at_once = ar_kernel.max_active_clusters(
            model_cfg, dtype, n,
            ar_kernel.cluster_resident(model_cfg, dtype, n, dev, fused),
            dev, fused)
    waves = -(-batch_size // at_once)
    if waves > 1:
        log.warning("--batch-size %d is more than the %d clusters of %d "
                    "SMs the card holds at once: each batch runs in %d "
                    "waves of the cluster kernel", batch_size, at_once, n,
                    waves)
    return waves


@torch.no_grad()
def decode_batch(model: WaveNet, cfg: Config, utts, noise=None,
                 generator=None, segment_samples: int = 0, device=None,
                 layout: dict | None = None, devices=None):
    """Generate one padded batch; returns the list of trimmed waveforms.

    noise: (B, T) uniforms for the padded batch, or None to draw them from
    `generator` in [1e-7, 1 - 1e-7]. The conditioning is upsampled with no
    shift (the generator's step t uses c_up[t]). segment_samples > 0
    decodes in bounded kernel calls with teacher-forced warm-starts (same
    samples; `generate_segmented` checks the warm-start length). layout:
    the kernel layout (`kernel_layout`), or None for
    kernel_layout(cfg.model, "auto", device). devices: split the rows over
    these devices (`--dp`): the conditioning is upsampled and the noise
    drawn on `device` at the true batch shape, both padded to a multiple
    of the devices by repeating the last row, decoded by `generate_dp` and
    trimmed, so every row is the single call's.
    """
    if segment_samples % 64 != 0:
        raise ValueError("--segment-samples must be a multiple of 64")
    if devices and segment_samples > 0:
        raise ValueError("--dp and --segment-samples are mutually "
                         "exclusive (--dp splits whole utterances)")
    with span("swt.decode.batch", id=next(_CALLS)):
        dev = resolve_device(device)
        if layout is None:
            layout = kernel_layout(cfg.model, "auto", dev)
        with span("swt.decode.pad"):
            cond, _, n_samples = pad_batch_for_decode(utts,
                                                      cfg.data.hop_length)
            spk = (torch.tensor([u.speaker for u in utts], device=dev)
                   if cfg.model.n_speakers > 0 else None)
            model = model.to(dev)
            cond = torch.from_numpy(cond).to(dev)
        with span("swt.decode.upsample"):
            c_up = model.upsample_cond(cond, spk)
        with span("swt.decode.params"):
            pp = extract_plain_params(model)
        with span("swt.decode.noise"):
            if noise is None:
                if generator is None:
                    raise ValueError("decode_batch needs noise or a "
                                     "generator")
                noise = ar_kernel.uniform_noise(c_up.shape[:2], generator)
            noise = torch.as_tensor(noise).to(dev)
        if devices:
            B, pad = len(utts), -len(utts) % len(devices)
            c_up, noise = (torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
                           for x in (c_up, noise))
            wav = generate_dp(pp, cfg.model, c_up, noise, devices,
                              **layout)[:B]
        elif segment_samples > 0:
            wav = generate_segmented(pp, cfg.model, c_up, noise,
                                     segment_samples, device=dev, **layout)
        else:
            # each row stops at its own length (the cluster kernel starts
            # the longest first), so a batch in waves ends sooner
            wav = ar_kernel.generate(pp, cfg.model, c_up, noise=noise,
                                     device=dev, lengths=n_samples,
                                     **layout)
        with span("swt.decode.copy_back"):
            wav = wav.cpu().numpy()
            return [wav[i, : n_samples[i]] for i in range(len(utts))]


def decode_utterances(model: WaveNet, cfg: Config, utts, names, outdir,
                      generator, batch_size: int = 8,
                      segment_samples: int = 0, device=None,
                      kernel_dtype: str = "auto", fused: int = 0,
                      model_step: int | None = None, devices=None,
                      profile: bool = False) -> dict:
    """Decode `utts` in batches, write `<outdir>/<name>` wavs and
    `decode_summary.json`; returns the summary. The kernel layout is
    chosen once, from `kernel_dtype` and `fused` (`decode_layout`: a
    fused window that fits nowhere is dropped), for every batch; the
    summary records the one that ran. model_step: the training step of
    the weights (None for an .npz). devices: split each batch's rows over
    them (`--dp`); the layout and the waves are those of the first device
    at the per-device batch. profile: a torch.profiler trace of the batch
    loop in `<outdir>/profile/`."""
    per_device = -(-batch_size // len(devices)) if devices else batch_size
    layout = decode_layout(cfg.model, kernel_dtype,
                           devices[0] if devices else device, fused)
    log.info("AR kernel layout: %s", layout)
    warn_waves(cfg.model, layout, per_device,
               devices[0] if devices else device)
    outdir = Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    sr = cfg.data.sample_rate
    total_audio_s, total_wall = 0.0, 0.0
    with maybe_profile(outdir / "profile" if profile else None):
        for i in range(0, len(utts), batch_size):
            t0 = time.perf_counter()
            wavs = decode_batch(model, cfg, utts[i: i + batch_size],
                                generator=generator,
                                segment_samples=segment_samples,
                                device=device, layout=layout,
                                devices=devices)
            wall = time.perf_counter() - t0
            audio_s = sum(len(w) for w in wavs) / sr
            total_audio_s += audio_s
            total_wall += wall
            for name, w in zip(names[i: i + batch_size], wavs):
                write_wav(outdir / Path(name).name, w, sr)
            log.info("batch %d: %.2f audio-s in %.2f s (RTF %.3f)",
                     i // batch_size, audio_s, wall,
                     wall / max(audio_s, 1e-9))
    summary = {
        "utterances": len(utts), "model_step": model_step,
        "audio_seconds": total_audio_s, "wall_seconds": total_wall,
        "rtf": total_wall / max(total_audio_s, 1e-9),
        "audio_seconds_per_s": total_audio_s / max(total_wall, 1e-9),
        "kernel": layout,
    }
    if devices:
        summary["dp_devices"] = [str(d) for d in devices]
    (outdir / "decode_summary.json").write_text(json.dumps(summary, indent=2))
    log.info("decode: %s", summary)
    return summary


def shift_f0(utts, cfg: Config, stats_path, factor: float):
    """Scale the log-F0 conditioning column by `factor` on voiced frames:
    pitch transposition through the vocoder (a numpy copy of the JAX
    decode's `shift_f0`). Features arrive normalized, so the column is
    un-normalized, shifted by ln(factor) and re-normalized; unvoiced
    frames (lf0 encoded 0, ops/f0.log_f0) are untouched. The stats are
    read by `bin.common.load_stats` (h5py, or the port's HDF5 codec)."""
    if cfg.data.feature_type != "world":
        raise ValueError("--f0-factor needs data.feature_type=world "
                         "(the mel feature set has no explicit F0 track)")
    if factor <= 0:
        raise ValueError("--f0-factor must be > 0")
    mean, std = load_stats(stats_path)
    shift = float(np.log(factor))
    for u in utts:
        lf0 = u.feats[:, 0] * max(std[0], 1e-8) + mean[0]
        vuv = u.feats[:, 1] * max(std[1], 1e-8) + mean[1]
        voiced = vuv > 0.5
        lf0 = np.where(voiced, lf0 + shift, lf0)
        u.feats[:, 0] = (lf0 - mean[0]) / max(std[0], 1e-8)
    return utts


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--eval-scp", required=True)
    p.add_argument("--feats-dir", required=True)
    p.add_argument("--stats", default=None)
    weights = p.add_mutually_exclusive_group(required=True)
    weights.add_argument("--workdir", default=None,
                         help="training run whose latest checkpoint to "
                              "decode with")
    weights.add_argument("--params", default=None,
                         help=".npz of the flax parameter tree "
                              "(save_params_npz)")
    p.add_argument("--outdir", required=True)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--segment-samples", type=int, default=0,
                   help="decode in bounded segments of this many samples "
                        "(multiple of 64, greater than the model's "
                        "warm-start length: sum(dilations)+1 rounded up to "
                        "64); the samples do not change")
    p.add_argument("--kernel-dtype", default="auto",
                   choices=("auto", *ar_kernel.DTYPES),
                   help="restrict the AR kernel to one weight and ring dtype "
                        "(the float32 layouts give identical samples; "
                        "bfloat16 halves the rings' shared memory)")
    p.add_argument("--fused", type=int, default=0,
                   help="fused window W of the AR kernel: the residual "
                        "recurrence expanded into the gate inputs within "
                        "blocks of W layers (0: unfused; not bit-exact "
                        "against it)")
    p.add_argument("--dp", action="store_true",
                   help="split each batch's utterances over the visible "
                        "GPUs (cut to mesh.num_devices), one kernel call "
                        "per GPU; the same samples as one device with the "
                        "same --seed")
    p.add_argument("--f0-factor", type=float, default=1.0,
                   help="scale the F0 conditioning track by this factor "
                        "before synthesis (world features only): pitch "
                        "transposition; 1.0 = off")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the batch loop to "
                        "<outdir>/profile")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch generator)")
    add_config_args(p)
    args = p.parse_args(argv)
    setup_logging()
    cfg = resolve_config(args)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    utts = load_utterances(args.eval_scp, args.feats_dir, args.stats,
                           load_wav=False)
    if args.f0_factor != 1.0:
        utts = shift_f0(utts, cfg, args.stats, args.f0_factor)
    names = read_file_list(args.eval_scp)
    if args.workdir:
        model, step = load_model_state(cfg, args.workdir, dev)
    else:
        model = params_from_flax(WaveNet(cfg.model),
                                 load_params_npz(args.params)).to(dev)
        step = None
    generator = torch.Generator(device=dev).manual_seed(args.seed)
    devices = dp_devices(cfg.mesh, dev) if args.dp else None
    if devices:
        log.info("--dp: rows split over %s", [str(d) for d in devices])
    decode_utterances(model, cfg, utts, names, args.outdir, generator,
                      batch_size=args.batch_size,
                      segment_samples=args.segment_samples, device=dev,
                      kernel_dtype=args.kernel_dtype, fused=args.fused,
                      model_step=step, devices=devices,
                      profile=args.profile)


if __name__ == "__main__":
    main()
