"""The ring-window copy probe: the wrapper around `csrc/ring_probe.cu` and its
plain PyTorch version — the counterpart of the TPU probe
`tools/dma_probe.py`.

A ring of `per` windows of (chunk, R) fp32 per batch row lives in device
memory and persists across the chunks of one launch. Chunk i copies window
i mod per in, adds 1, writes it to chunk i of the output and copies it
back, so every value of output chunk i is i // per + 1 (`expected`). The
CUDA kernel does the copies asynchronously, in one of two `VARIANTS`:
"tma" (a bulk copy completing on an mbarrier, shared -> global by a bulk
copy after an async-proxy fence) or "cp_async" (16-byte cp.async copies in,
plain stores back). Output layout is the TPU probe's: (n_chunks * chunk, B,
R). `SHAPES` are the TPU probe's own, a rate shape of one block per SM,
and each of their batches at the other's chunk count.

On a CUDA device `ring_probe` launches the kernel or raises; on the CPU it
runs the plain version, `ring_probe_plain`, the same loop in torch ops.
`launches` counts kernel launches by variant.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.ops import _build

VARIANTS = ("tma", "cp_async")
# the TPU probe's shape (tools/dma_probe.py:20-22); one block per SM of an
# H100 over 64 chunks, for a rate; and each batch at the other chunk count,
# which tells a launch's fixed cost from a chunk's
SHAPES = {"jax": dict(chunk=64, batch=8, channels=128, per=2, n_chunks=8),
          "jax_64_chunks": dict(chunk=64, batch=8, channels=128, per=2,
                                n_chunks=64),
          "rate_8_chunks": dict(chunk=64, batch=132, channels=128, per=2,
                                n_chunks=8),
          "rate": dict(chunk=64, batch=132, channels=128, per=2,
                       n_chunks=64)}

launches: collections.Counter = collections.Counter()


def variant_name(variant: str) -> str:
    return f"ring_probe[{variant}]"


def expected(chunk: int, batch: int, channels: int, per: int, n_chunks: int,
             device=None):
    """The probe's closed form: output chunk i holds i // per + 1."""
    vals = torch.arange(n_chunks, device=device) // per + 1.0
    return vals.repeat_interleave(chunk)[:, None, None].expand(
        n_chunks * chunk, batch, channels).contiguous()


def moved_bytes(chunk: int, batch: int, channels: int, per: int,
                n_chunks: int) -> int:
    """Bytes one call moves: per chunk and row, the window in, out and
    back."""
    return 3 * n_chunks * batch * chunk * channels * 4


def _check(chunk, batch, channels, per, n_chunks, variant):
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")
    if (min(chunk, per) < 1 or min(batch, n_chunks) < 0 or channels < 4
            or channels % 4):
        raise ValueError(
            f"ring probe shape: chunk, per >= 1, batch, n_chunks >= 0 and "
            f"channels a positive multiple of 4 (16-byte copies); got "
            f"chunk={chunk}, batch={batch}, channels={channels}, per={per}, "
            f"n_chunks={n_chunks}")


def ring_probe(chunk: int = 64, batch: int = 8, channels: int = 128,
               per: int = 2, n_chunks: int = 8, variant: str = "tma",
               device=None):
    """The probe's output (n_chunks * chunk, batch, channels) fp32 on
    `device` (None: CUDA, one launch of `variant`; "cpu": the plain
    version)."""
    _check(chunk, batch, channels, per, n_chunks, variant)
    dev = resolve_device(device)
    if dev.type != "cuda":
        return ring_probe_plain(chunk, batch, channels, per, n_chunks, dev)
    lib = _lib()
    # zeroed, so that the first `per` chunks read zeros
    ring = torch.zeros((batch, per * chunk, channels), device=dev)
    out = torch.empty((n_chunks * chunk, batch, channels), device=dev)
    with torch.cuda.device(dev):
        err = lib.ring_probe(ring.data_ptr(), out.data_ptr(), batch, chunk,
                             channels, per, n_chunks,
                             VARIANTS.index(variant),
                             torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise ValueError(lib.ring_probe_error_string(err).decode())
    if err != 0:
        raise RuntimeError("ring_probe launch failed: "
                           + lib.ring_probe_error_string(err).decode())
    launches[variant_name(variant)] += 1
    return out


def ring_probe_plain(chunk: int = 64, batch: int = 8, channels: int = 128,
                     per: int = 2, n_chunks: int = 8, device=None):
    """The plain PyTorch version of `ring_probe`, on any device."""
    _check(chunk, batch, channels, per, n_chunks, VARIANTS[0])
    dev = resolve_device(device)
    ring = torch.zeros((batch, per * chunk, channels), device=dev)
    out = torch.empty((n_chunks * chunk, batch, channels), device=dev)
    for i in range(n_chunks):
        p = (i % per) * chunk
        win = ring[:, p:p + chunk] + 1.0
        out[i * chunk:(i + 1) * chunk] = win.transpose(0, 1)
        ring[:, p:p + chunk] = win
    return out


def _lib() -> ctypes.CDLL:
    lib = _build.load("ring_probe")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ring_probe.argtypes = [ptr, ptr] + [i32] * 6 + [ptr]
    lib.ring_probe.restype = i32
    lib.ring_probe_error_string.argtypes = [i32]
    lib.ring_probe_error_string.restype = ctypes.c_char_p
    return lib
