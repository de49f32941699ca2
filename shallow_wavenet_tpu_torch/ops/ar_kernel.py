"""Persistent AR generation: the wrapper around `csrc/ar_generate.cu` and its
plain PyTorch version.

Same contract as `generate_pallas` in shallow_wavenet_tpu/ops/ar_kernel.py,
in its fp32, resident-ring, unfused form: c_up (B, T, C) fp32 and one
uniform per (row, step) in, (B, T) fp32 waveform out; Laplace or softmax
head; "sample" or "greedy"; an optional teacher stream that forces the
feedback input on every step, or on steps t < warmup only (the warm-start
of segmented generation). Softmax class ids are dequantized here, outside
the kernel, with the same op on both versions.

On a CUDA tensor `generate` launches the kernel (one launch for the whole
batch; the time loop runs inside it) or raises; on a CPU tensor it runs the
plain version, `generate_plain`, which repeats the kernel's arithmetic with
the same packed-ring recurrence (layer l owns ring rows [off_l, off_l + d_l),
slot off_l + (t & (d_l - 1))). `launches` counts kernel launches.

Not carried over from the TPU kernel: `stream`, `fused` and
`dtype="bfloat16"` (ROADMAP B5, B6, B4) raise NotImplementedError; the chunk
grid, lane padding and the VMEM estimate/probe are Mosaic artifacts. In
their place `check_supported` raises on a config the recurrence cannot
take, and the kernel's C entry refuses, before it runs, a config whose
layers, classes or shared memory it cannot hold (ValueError here).
"""

from __future__ import annotations

import ctypes

import torch

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.config import ModelConfig
from shallow_wavenet_tpu_torch.models import heads
from shallow_wavenet_tpu_torch.ops import _build
from shallow_wavenet_tpu_torch.ops.mulaw import mulaw_dequantize

# kernel launches since the last reset (callers set it to 0 to count a run)
launches = 0


def warmup_length(cfg: ModelConfig, chunk: int = 64) -> int:
    """Teacher-forced warm-start length for segmented generation:
    sum(dilations) + 1 (every layer's correctness horizon) rounded up to a
    whole chunk — the same M as the JAX package."""
    need = int(sum(cfg.dilations)) + 1
    return -(-need // chunk) * chunk


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError on a config the packed-ring recurrence (kernel and
    plain version) cannot take. The kernel's own limits are checked by its
    C entry; batch rows are independent blocks, so every batch size fits
    once the config does."""
    bad = []
    if cfg.kernel_size != 2:
        bad.append(f"kernel_size={cfg.kernel_size} (needs 2)")
    if cfg.gate_channels % 2:
        bad.append("gate_channels must be even")
    if bad:
        raise ValueError("config not supported by the AR kernel: "
                         + "; ".join(bad))


def uniform_noise(shape, generator: torch.Generator):
    """Uniforms in [1e-7, 1 - 1e-7], drawn on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (1.0 - 2e-7) + 1e-7


def _prepare(pp, cfg, c_up, noise, mode, teacher, warmup, generator,
             unroll, dev, stream, fused, dtype):
    if stream:
        raise NotImplementedError("stream=True (HBM-streamed rings) is "
                                  "ROADMAP item B5")
    if fused:
        raise NotImplementedError("fused=W (fused-window kernel) is ROADMAP "
                                  "item B6")
    if dtype != "float32":
        raise NotImplementedError(f"dtype={dtype!r} (bf16 weights and rings)"
                                  f" is ROADMAP item B4")
    if mode not in ("sample", "greedy"):
        raise ValueError(f"mode must be 'sample' or 'greedy', got {mode!r}")
    if warmup < 0:
        raise ValueError("warmup must be >= 0")
    if warmup > 0 and teacher is None:
        raise ValueError("warmup requires a teacher prefix stream")
    if unroll < 1:
        raise ValueError("unroll must be >= 1")
    check_supported(cfg)
    c_up = torch.as_tensor(c_up, dtype=torch.float32).to(dev).contiguous()
    B, T, C = c_up.shape
    if C != cfg.cond_channels:
        raise ValueError(f"c_up has {C} channels, config {cfg.cond_channels}")

    def stream_of(x, fill, what):
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        if x.ndim != 2 or x.shape[0] != B or x.shape[1] > T:
            raise ValueError(f"{what} must be (B, <=T) = ({B}, <={T}), got "
                             f"{tuple(x.shape)}")
        if x.shape[1] < T:
            x = torch.nn.functional.pad(x, (0, T - x.shape[1]), value=fill)
        return x.contiguous()

    if mode == "greedy":
        noise = torch.full((B, T), 0.5, device=dev)
    elif noise is None:
        if generator is None:
            raise ValueError("sample mode needs generator or noise")
        noise = uniform_noise((B, T), generator).to(dev)
    else:
        noise = stream_of(noise, 0.5, "noise")
    n_forced = 0
    if teacher is not None:
        teacher = stream_of(teacher, 0.0, "teacher")
        n_forced = T if warmup == 0 else min(warmup, T)

    w = {k: torch.as_tensor(v, dtype=torch.float32).to(dev).contiguous()
         for k, v in pp.items()}
    if cfg.head == "softmax":
        w["in_w"] = w.pop("input_embed")
        w["in_b"] = torch.zeros(cfg.residual_channels, device=dev)
    else:
        w["in_w"], w["in_b"] = w.pop("input_w"), w.pop("input_b")
    return c_up, noise, teacher, n_forced, w


def _finish(cfg: ModelConfig, raw):
    if cfg.head == "softmax":
        return mulaw_dequantize(raw.to(torch.int32), cfg.quantize_channels)
    return raw


def generate(pp: dict, cfg: ModelConfig, c_up, noise=None,
             mode: str = "sample", teacher=None, warmup: int = 0,
             generator=None, unroll: int = 1, device=None, *,
             stream: bool = False, fused: int = 0, dtype: str = "float32"):
    """AR generation; returns (B, T) fp32 on `device`.

    pp: plain params (models.wavenet.extract_plain_params); c_up (B, T, C).
    noise: (B, <=T) uniforms in (0, 1), padded with 0.5; drawn from
    `generator` in [1e-7, 1 - 1e-7] when omitted (sample mode).
    teacher: optional (B, <=T) forced feedback stream (samples, or class ids
    as floats for the softmax head), padded with zeros. warmup > 0 forces
    only steps t < warmup; warmup >= sum(dilations) + 1 rebuilds every ring.
    unroll: kept for the `generate_pallas` contract (>= 1); the kernel's
    loop has no unroll knob, and unrolling never changes the samples.
    device: None means "cuda" (raises without CUDA); "cpu" runs the plain
    version.
    """
    dev = resolve_device(device)
    args = _prepare(pp, cfg, c_up, noise, mode, teacher, warmup, generator,
                    unroll, dev, stream, fused, dtype)
    run = _launch if args[0].is_cuda else _plain
    return _finish(cfg, run(cfg, mode == "greedy", *args))


def generate_plain(pp: dict, cfg: ModelConfig, c_up, noise=None,
                   mode: str = "sample", teacher=None, warmup: int = 0,
                   generator=None, unroll: int = 1, device=None, *,
                   stream: bool = False, fused: int = 0,
                   dtype: str = "float32"):
    """The plain PyTorch version of `generate`, on any device: one Python
    step per sample, the kernel's arithmetic in torch ops."""
    dev = resolve_device(device)
    args = _prepare(pp, cfg, c_up, noise, mode, teacher, warmup, generator,
                    unroll, dev, stream, fused, dtype)
    return _finish(cfg, _plain(cfg, mode == "greedy", *args))


@torch.no_grad()
def _plain(cfg, greedy, c_up, noise, teacher, n_forced, w):
    B, T, C = c_up.shape
    dil = cfg.dilations
    L, R, G, S = (len(dil), cfg.residual_channels, cfg.gate_channels,
                  cfg.skip_channels)
    half = G // 2
    offs = [sum(dil[:l]) for l in range(L)]
    dev = c_up.device
    softmax = cfg.head == "softmax"
    rings = torch.zeros(sum(dil), B, R, device=dev)
    cond_wcat = w["cond_w"].permute(1, 0, 2).reshape(C, L * G)
    rs_w = torch.cat([w["skip_w"], w["res_w"]], dim=-1)     # (L, G/2, S+R)
    rs_b = torch.cat([w["skip_b"], w["res_b"]], dim=-1)
    fb = torch.full((B,), float(cfg.quantize_channels // 2) if softmax
                    else 0.0, device=dev)
    out = torch.empty(B, T, device=dev)
    for t in range(T):
        x_in = teacher[:, t] if t < n_forced else fb
        if softmax:
            h = w["in_w"][x_in.long()]
        else:
            h = x_in[:, None] * w["in_w"][0][None, :] + w["in_b"][None, :]
        cc = c_up[:, t] @ cond_wcat
        skip = torch.zeros(B, S, device=dev)
        for l in range(L):
            slot = offs[l] + (t & (dil[l] - 1))
            u = ((rings[slot] @ w["conv_w"][l, 0] + h @ w["conv_w"][l, 1])
                 + w["conv_b"][l]) + cc[:, l * G:(l + 1) * G]
            z = torch.tanh(u[:, :half]) * torch.sigmoid(u[:, half:])
            rings[slot] = h
            rs = z @ rs_w[l] + rs_b[l]
            h = h + rs[:, S:]
            skip = skip + rs[:, :S]
        o = torch.relu(skip)
        o = torch.relu(o @ w["head1_w"] + w["head1_b"])
        o = o @ w["head2_w"] + w["head2_b"]
        if softmax:
            ids = (torch.argmax(o, dim=-1) if greedy
                   else heads.categorical_from_uniform(o, noise[:, t]))
            x = ids.float()
        else:
            x = o[:, 0] if greedy else heads.laplace_from_uniform(
                o, noise[:, t] - 0.5, cfg.log_b_min, cfg.log_b_max)
            x = torch.clamp(x, -1.0, 1.0)
        out[:, t] = x
        fb = x
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ar_generate.argtypes = ([ptr] * 17 + [ctypes.POINTER(i32)]
                                + [i32] * 12 + [f32, f32, ptr])
    lib.ar_generate.restype = i32
    lib.ar_error_string.argtypes = [i32]
    lib.ar_error_string.restype = ctypes.c_char_p
    return lib


def _launch(cfg, greedy, c_up, noise, teacher, n_forced, w):
    global launches
    lib = _bind(_build.load("ar_generate"))
    B, T, C = c_up.shape
    out = torch.empty((B, T), dtype=torch.float32, device=c_up.device)
    dil = (ctypes.c_int * len(cfg.dilations))(*cfg.dilations)
    softmax = cfg.head == "softmax"
    O = cfg.quantize_channels if softmax else 2
    with torch.cuda.device(c_up.device):
        err = lib.ar_generate(
            c_up.data_ptr(), noise.data_ptr(),
            None if teacher is None else teacher.data_ptr(), out.data_ptr(),
            *(w[k].data_ptr() for k in (
                "in_w", "in_b", "conv_w", "conv_b", "cond_w", "res_w",
                "res_b", "skip_w", "skip_b", "head1_w", "head1_b",
                "head2_w", "head2_b")),
            dil, B, T, len(cfg.dilations), cfg.residual_channels,
            cfg.gate_channels, cfg.skip_channels, C, cfg.quantize_channels,
            O, int(softmax), int(greedy), n_forced, cfg.log_b_min,
            cfg.log_b_max, torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise ValueError("config not supported by the AR kernel: "
                         + lib.ar_error_string(err).decode())
    if err != 0:
        raise RuntimeError("ar_generate launch failed: "
                           + lib.ar_error_string(err).decode())
    launches += 1
    return out
