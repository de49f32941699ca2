"""Autoregressive generation — the torch twin of
`shallow_wavenet_tpu/models/generate.py`.

- `generate_fast`: the eager queue-cached reference (fast-WaveNet ring
  buffers, O(layers) small matmuls per sample) with an explicit noise
  stream. It is the plain version of the AR kernel (`ops.ar_kernel`), run
  on any device.
- `generate_segmented`: long utterances in fixed-size kernel calls, each
  segment warm-started by teacher forcing the previous segment's samples.
- `generate_dp`: the rows of one batch split over devices, each shard one
  kernel call on its own device, gathered on the host.
"""

from __future__ import annotations

import torch

from shallow_wavenet_tpu_torch.config import ModelConfig
from shallow_wavenet_tpu_torch.ops import ar_kernel
from shallow_wavenet_tpu_torch.ops.mulaw import mulaw_quantize
from shallow_wavenet_tpu_torch.parallel.mesh import dp_devices


def seed_feedback(cfg: ModelConfig):
    """Initial x_prev for t=0 (silence): a class id or a sample."""
    if cfg.head == "softmax":
        return mulaw_quantize(torch.tensor(0.0), cfg.quantize_channels)
    return torch.tensor(0.0)


def generate_fast(pp: dict, cfg: ModelConfig, c_up, noise=None,
                  mode: str = "sample", generator=None, device=None):
    """Queue-cached AR generation in eager PyTorch; (B, T) fp32.

    pp: plain params (extract_plain_params); c_up (B, T, C); noise (B, T)
    uniforms in (0, 1), or drawn from `generator`. Shares the kernel's
    noise contract, so both give the same samples from the same uniforms.
    """
    return ar_kernel.generate_plain(pp, cfg, c_up, noise=noise, mode=mode,
                                    generator=generator, device=device)


def generate_segmented(pp: dict, cfg: ModelConfig, c_up, noise,
                       seg_len: int, device=None, *, chunk: int = 64,
                       dtype: str = "float32", stream: bool = False,
                       fused: int = 0, cluster: int = 0, wide: bool = False):
    """Generate (B, T) in kernel calls of at most seg_len output samples.

    Ring state is not carried between calls: each segment after the first
    starts M = warmup_length(cfg, chunk) steps early, forcing those steps'
    inputs from the previous segment's samples, which rebuilds every ring
    exactly (layer l's horizon is the prefix sum of dilations < M). The
    output is therefore identical to one unsegmented call. chunk, dtype,
    stream, fused, cluster and wide pass to every kernel call; the kernel's
    weights are made once (`ar_kernel.kernel_weights`) for all of them.
    """
    B, T, _ = c_up.shape
    M = ar_kernel.warmup_length(cfg, chunk)
    if seg_len <= M:
        raise ValueError(f"seg_len must exceed the warm-start length {M}")
    pp = ar_kernel.kernel_weights(pp, cfg, dtype, fused, device, cluster)
    kw = dict(device=device, chunk=chunk, dtype=dtype, stream=stream,
              fused=fused, cluster=cluster, wide=wide)
    segs = []
    for s in range(0, T, seg_len):
        e = min(s + seg_len, T)
        if s == 0:
            segs.append(ar_kernel.generate(pp, cfg, c_up[:, :e],
                                           noise=noise[:, :e], **kw))
            continue
        # the call spans global samples [s - M, e): local step t < M is
        # forced with x(s - M - 1 + t), the previous M true samples
        prev = segs[-1][:, -(M + 1):-1]
        if cfg.head == "softmax":
            prev = mulaw_quantize(prev, cfg.quantize_channels).float()
        wav = ar_kernel.generate(pp, cfg, c_up[:, s - M:e],
                                 noise=noise[:, s - M:e], teacher=prev,
                                 warmup=M, **kw)
        segs.append(wav[:, M:])
    return torch.cat(segs, dim=1)


def generate_dp(pp: dict, cfg: ModelConfig, c_up, noise, devices=None, *,
                mode: str = "sample", chunk: int = 64, dtype: str = "float32",
                stream: bool = False, fused: int = 0, cluster: int = 0,
                wide: bool = False):
    """The rows of (B, T) generation split over `devices` (torch devices or
    their names; one may repeat; None: every visible CUDA device, raising
    without CUDA): shard i, rows [i B/n, (i+1) B/n), is one
    `ar_kernel.generate` call on devices[i] with that device's own
    `KernelWeights` (made once per distinct device). Every shard is
    launched before any result is collected, so the cards run at once,
    and there is no traffic between them during the AR loop; the shards
    are gathered on the host, (B, T) fp32 on the CPU. The counterpart of
    the JAX `generate_dp` (shard_map over a ('data',) mesh).

    noise: (B, T) uniforms, required, so that the split cannot change
    which uniform a row draws. B must be divisible by len(devices). The
    layout keywords (chunk, dtype, stream, fused, cluster, wide) pass to every
    call. A kernel's rows are independent of the batch, so each row
    equals the single call's; on the CPU, the plain version's products
    at another batch size may sum in another order."""
    devices = [torch.device(d) for d in
               (dp_devices() if devices is None else devices)]
    B = c_up.shape[0]
    if not devices or B % len(devices):
        raise ValueError(f"batch {B} does not split over {len(devices)} "
                         f"devices")
    if noise is None or tuple(noise.shape) != tuple(c_up.shape[:2]):
        raise ValueError("generate_dp needs (B, T) noise")
    per = B // len(devices)
    weights = {}
    outs = []
    for i, dev in enumerate(devices):
        if dev not in weights:
            weights[dev] = ar_kernel.kernel_weights(pp, cfg, dtype, fused,
                                                    dev, cluster)
        rows = slice(i * per, (i + 1) * per)
        outs.append(ar_kernel.generate(
            weights[dev], cfg, c_up[rows].to(dev), noise=noise[rows].to(dev),
            mode=mode, device=dev, chunk=chunk, dtype=dtype, stream=stream,
            fused=fused, cluster=cluster, wide=wide))
    return torch.cat([o.cpu() for o in outs])
