"""The ring-window copy probe: the wrapper around `csrc/ring_probe.cu` and its
plain PyTorch version — the counterpart of the TPU probe
`tools/dma_probe.py`.

A ring of `per` windows of (chunk, R) fp32 per batch row lives in device
memory and persists across the chunks of one launch. Chunk i copies window
i mod per in, adds 1, writes it to chunk i of the output and copies it
back, so every value of output chunk i is i // per + 1 (`expected`). The
CUDA kernels do the copies asynchronously, in one of four `VARIANTS`. Two
are the block-for-block port, one block per row with every step serial:
"tma" (a bulk copy completing on an mbarrier, shared -> global by a bulk
copy after an async-proxy fence) or "cp_async" (16-byte cp.async copies in,
plain stores back). Two are the redesign for the H100, one template with
the copy form as its parameter: each row's window split by its t rows over
several blocks (`split`), each block pipelining the chunks through a few
shared-memory stages with a producer warp ahead of four consumer warps:
"tma_pipe" (bulk copies in, back and out, one per t row of the output) or
"cp_async_pipe" (cp.async in, plain stores back and out). Output layout is
the TPU probe's: (n_chunks * chunk, B, R). `SHAPES` are the TPU probe's
own, a rate shape of 132 rows (one serial block per SM), each of their
batches at the other's chunk count, and the TPU probe's batch with a slot
per chunk (no chunk waits for another's write-back); `ORDER_SHAPES` check
the ordering only.

On a CUDA device `ring_probe` and `ring_probe_into` launch the kernel or
raise; on the CPU they run the plain version (`ring_probe_plain`, the same
loop in torch ops). `ring_probe_into` takes a ring and an output made by
the caller, so that a launch can be timed alone. `launches` counts kernel
launches by variant.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.ops import _build

VARIANTS = ("tma", "cp_async", "tma_pipe", "cp_async_pipe")
# ring_probe_pipe's copy form for each pipelined variant
PIPE_COPY = {"tma_pipe": 0, "cp_async_pipe": 1}
# the TPU probe's shape (tools/dma_probe.py:20-22); one block per SM of an
# H100 over 64 chunks, for a rate; each batch at the other chunk count,
# which tells a launch's fixed cost from a chunk's; and the TPU probe's
# batch over 64 chunks with per = 64, the copies without the chain
SHAPES = {"jax": dict(chunk=64, batch=8, channels=128, per=2, n_chunks=8),
          "jax_64_chunks": dict(chunk=64, batch=8, channels=128, per=2,
                                n_chunks=64),
          "rate_8_chunks": dict(chunk=64, batch=132, channels=128, per=2,
                                n_chunks=8),
          "rate": dict(chunk=64, batch=132, channels=128, per=2,
                       n_chunks=64),
          "jax_no_chain": dict(chunk=64, batch=8, channels=128, per=64,
                               n_chunks=64)}
# ordering checks, not timed: per = 1, where each chunk reloads the slot the
# previous one wrote back; per = 3 over a chunk that the split at 132 rows
# on 132 SMs (4 blocks of 13 rows) leaves ragged
ORDER_SHAPES = {"per1": dict(chunk=64, batch=8, channels=128, per=1,
                             n_chunks=5),
                "per3_ragged": dict(chunk=50, batch=132, channels=128,
                                    per=3, n_chunks=7)}
# the pipelined kernel's most stages, its mbarriers' static shared memory
# (csrc/ring_probe.cu kMaxStages), and the blocks per SM its split aims at
MAX_STAGES = 8
STATIC_SMEM = 2 * MAX_STAGES * 8
BLOCKS_PER_SM = 4

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


def l2_bytes(chunk: int, batch: int, channels: int, per: int,
             n_chunks: int) -> int:
    """Bytes the copies in and back move per call, between the ring in L2
    and shared memory."""
    return 2 * n_chunks * batch * chunk * channels * 4


def bound_bytes(chunk: int, batch: int, channels: int, per: int,
                n_chunks: int) -> int:
    """Bytes that must reach device memory per call: the output and the
    zeroed ring, each written once."""
    return 4 * (n_chunks + per) * chunk * batch * channels


def split(chunk: int, batch: int, channels: int, per: int, sms: int,
          smem_per_block: int) -> dict:
    """The pipelined variants' split of each row's window: {"blocks_per_row",
    "rows_per_block", "stages", "smem_bytes"}. Enough pieces of t rows that
    the card holds BLOCKS_PER_SM blocks per SM (at most one t row per
    piece), per + 1 stages (one past the lookahead of per - 1 chunks, so a
    stage's output stores have a chunk's time to read it), and pieces
    small enough that the stages fit a block's shared memory
    (`smem_per_block`, the opt-in maximum). Block b holds row b //
    blocks_per_row, t rows [(b % blocks_per_row) * rows_per_block, + rows)
    (`pieces`); the last piece of a row may hold fewer."""
    row_bytes = 4 * channels
    budget = smem_per_block - STATIC_SMEM
    if budget < row_bytes:
        raise ValueError(f"ring probe split: one t row of {channels} fp32 "
                         f"exceeds a block's {smem_per_block} B of shared "
                         f"memory")
    stages = min(per + 1, MAX_STAGES, budget // row_bytes)
    want = -(-BLOCKS_PER_SM * sms // max(batch, 1))
    rows = -(-chunk // min(chunk, want))
    rows = min(rows, budget // (stages * row_bytes))
    return {"blocks_per_row": -(-chunk // rows), "rows_per_block": rows,
            "stages": stages, "smem_bytes": stages * rows * row_bytes}


def pieces(chunk: int, batch: int, blocks_per_row: int, rows_per_block: int,
           **_) -> list:
    """(row, first t, rows) of each block of the pipelined kernel, in block
    order: the kernel's own indexing."""
    out = []
    for b in range(batch * blocks_per_row):
        t0 = (b % blocks_per_row) * rows_per_block
        out.append((b // blocks_per_row, t0, min(rows_per_block, chunk - t0)))
    return out


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
    version), on a ring and an output made for the call."""
    _check(chunk, batch, channels, per, n_chunks, variant)
    dev = resolve_device(device)
    # zeroed, so that the first `per` chunks read zeros
    ring = torch.zeros((batch, per * chunk, channels), device=dev)
    out = torch.empty((n_chunks * chunk, batch, channels), device=dev)
    return ring_probe_into(ring, out, chunk, per, variant)


def ring_probe_into(ring: torch.Tensor, out: torch.Tensor, chunk: int,
                    per: int, variant: str) -> torch.Tensor:
    """One run of the probe on buffers the caller made: `ring` (B, per *
    chunk, R) fp32, zeroed by the caller (the first `per` chunks read it;
    the run leaves it changed), and `out` (n_chunks * chunk, B, R) fp32,
    which it fills and returns. On CUDA tensors one launch of `variant`,
    nothing allocated; on the CPU the plain version, in place."""
    if ring.dim() != 3 or out.dim() != 3 or chunk < 1 or per < 1:
        raise ValueError(f"ring probe buffers: ring (B, per * chunk, R) and "
                         f"out (n_chunks * chunk, B, R) with chunk, per >= "
                         f"1; got {tuple(ring.shape)}, {tuple(out.shape)}, "
                         f"chunk={chunk}, per={per}")
    batch, channels = ring.shape[0], ring.shape[2]
    n_chunks = out.shape[0] // chunk
    _check(chunk, batch, channels, per, n_chunks, variant)
    if (ring.shape[1] != per * chunk
            or tuple(out.shape) != (n_chunks * chunk, batch, channels)):
        raise ValueError(f"ring probe buffers: ring {tuple(ring.shape)} and "
                         f"out {tuple(out.shape)} do not match chunk="
                         f"{chunk}, per={per}")
    for t in (ring, out):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != ring.device):
            raise ValueError("ring probe buffers: contiguous fp32 on one "
                             "device")
    if ring.device.type != "cuda":
        return _plain_into(ring, out, chunk, per)
    lib = _lib()
    stream = torch.cuda.current_stream(ring.device).cuda_stream
    with torch.cuda.device(ring.device):
        if variant in PIPE_COPY:
            sp = split(chunk, batch, channels, per, *limits(ring.device))
            err = lib.ring_probe_pipe(
                ring.data_ptr(), out.data_ptr(), batch, chunk, channels, per,
                n_chunks, PIPE_COPY[variant], sp["rows_per_block"],
                sp["stages"], stream)
        else:
            err = lib.ring_probe(ring.data_ptr(), out.data_ptr(), batch,
                                 chunk, channels, per, n_chunks,
                                 VARIANTS.index(variant), stream)
    if err < 0:
        raise ValueError(lib.ring_probe_error_string(err).decode())
    if err != 0:
        raise RuntimeError("ring_probe launch failed: "
                           + lib.ring_probe_error_string(err).decode())
    launches[variant_name(variant)] += 1
    return out


@functools.lru_cache(maxsize=None)
def limits(device) -> tuple[int, int]:
    """The CUDA device's (SM count, shared memory per block, opt-in)."""
    lib = _lib()
    sms, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = lib.ring_probe_limits(ctypes.byref(sms), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError("ring_probe_limits failed: "
                           + lib.ring_probe_error_string(err).decode())
    return sms.value, smem.value


def ring_probe_plain(chunk: int = 64, batch: int = 8, channels: int = 128,
                     per: int = 2, n_chunks: int = 8, device=None):
    """The plain PyTorch version of `ring_probe`, on any device."""
    _check(chunk, batch, channels, per, n_chunks, VARIANTS[0])
    dev = resolve_device(device)
    ring = torch.zeros((batch, per * chunk, channels), device=dev)
    out = torch.empty((n_chunks * chunk, batch, channels), device=dev)
    return _plain_into(ring, out, chunk, per)


def _plain_into(ring, out, chunk, per):
    for i in range(out.shape[0] // chunk):
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
    lib.ring_probe_pipe.argtypes = [ptr, ptr] + [i32] * 8 + [ptr]
    lib.ring_probe_pipe.restype = i32
    lib.ring_probe_limits.argtypes = [ctypes.POINTER(i32)] * 2
    lib.ring_probe_limits.restype = i32
    lib.ring_probe_error_string.argtypes = [i32]
    lib.ring_probe_error_string.restype = ctypes.c_char_p
    return lib
