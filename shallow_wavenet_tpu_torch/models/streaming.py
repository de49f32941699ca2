"""Streaming synthesis session — the torch twin of the session in
`shallow_wavenet_tpu/models/streaming.py` (its `StreamPool` is not ported
yet).

Acoustic frames arrive in pieces from an upstream model (a TTS acoustic
model, a codec) and waveform flows out in blocks, with bounded latency,
through the same two mechanisms as the batch path:

- exact block upsampling: the conditioning upsampler is repeat + SAME-conv
  stages, so one output sample depends on input frames within a halo of H
  frames (`upsampler_halo`). Upsampling a frame window with H frames of
  context on each side and trimming them gives the full-utterance rows,
  up to the rounding of products whose lengths differ (a library GEMM may
  sum a window's rows in another order than the whole utterance's);
- ring-state warm-starting: each block after the first is one AR kernel
  call that starts M = warmup_length(cfg, chunk) steps early and forces
  those steps' inputs with the samples before them, which rebuilds every
  dilation ring exactly (as `generate_segmented` does). The streamed
  samples therefore equal, bit for bit, one kernel call over the blocks'
  concatenated conditioning and noise (`cond_so_far`, `noise_so_far`).
  (The JAX session forces step t with sample t instead of t - 1, one step
  late, so its stream parts from its batch call at each block boundary
  wherever the model's output depends on its input; the port does not
  carry that over.)

The JAX session jits its steady-state step into one program per push
(`build_stream_steps`) to save round trips to a remotely attached TPU; in
eager PyTorch that is the same math as its host path, so the port has only
the host path. Block uniforms are drawn as the JAX session draws them,
`np.random.default_rng(seed).uniform(1e-7, 1 - 1e-7, (B, n))` in fp32, so
the same seed gives the same noise in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.config import ModelConfig
from shallow_wavenet_tpu_torch.ops import ar_kernel
from shallow_wavenet_tpu_torch.ops.mulaw import mulaw_quantize


def upsampler_halo(factors) -> int:
    """Exact per-side context (in frames) one upsampled sample depends on.

    Each stage repeats by f then applies a SAME conv of kernel 2f+1
    (radius f at the post-repeat rate). Walking backwards, an output
    dependency radius r at a stage's output rate becomes ceil((r + f) / f)
    at its input rate; the input projection is 1x1 and adds nothing. For
    (4, 4, 4, 5) the fixpoint is H = 2 frames.
    """
    r = 0
    for f in reversed(tuple(factors)):
        r = -(-(r + f) // f)
    return r


class StreamingSynthesizer:
    """Incremental vocoder session: push frames, pull waveform samples.

        syn = StreamingSynthesizer(pp, model, cfg, hop_length=hop, batch=1)
        for frames in frame_source:            # (B, n, aux) each
            wav_piece = syn.push(frames)       # (B, m) np.float32 (m >= 0)
        tail = syn.flush()                     # final samples

    Samples for a frame are emitted once `halo` further frames have arrived
    and a whole block (block_frames) is available, so output lags input by
    at most block_frames + halo frames. `flush()` ends the utterance: the
    remaining frames are synthesized with the utterance-final (zero-pad)
    upsampler edge, and a partial last block is padded with zero
    conditioning to a whole block and trimmed, as the batch path pads.

    pp: plain params of `model` (models.wavenet.extract_plain_params);
    model: the torch WaveNet on `device` (its upsampler runs per block).
    block_frames * hop must be a multiple of `chunk` and at least M; larger
    blocks amortize the M warm-up steps per call, smaller ones cut latency.
    chunk, dtype, stream and fused pass to every kernel call (fused = W:
    the fused window; not bit-exact against fused=0, but the stream still
    equals one fused call). The session runs the kernel the decode picks
    first: the cluster kernel at the model's, fused window's and card's
    size (`ar_kernel.cluster_size`, `self.cluster`), unfused or fused; 0,
    the one-SM-per-row kernel, where no cluster fits. record_noise: keep
    every block's uniforms and conditioning rows, for `noise_so_far` and
    `cond_so_far` (they grow with the session). device: None means CUDA;
    "cpu" runs the plain version.
    """

    def __init__(self, pp: dict, model, cfg: ModelConfig, hop_length: int,
                 batch: int = 1, block_frames: int = 24, chunk: int = 64,
                 dtype: str = "float32", stream: bool = False, speaker=None,
                 seed: int = 0, record_noise: bool = False, fused: int = 0,
                 device=None):
        self.model, self.cfg = model, cfg
        self.hop = int(hop_length)
        self.B = int(batch)
        self.block_frames = int(block_frames)
        if (self.block_frames * self.hop) % chunk != 0:
            raise ValueError(
                f"block_frames * hop ({self.block_frames * self.hop}) must "
                f"be a multiple of chunk ({chunk})")
        self.halo = upsampler_halo(cfg.upsample_factors)
        self.M = ar_kernel.warmup_length(cfg, chunk)
        if self.block_frames * self.hop < self.M:
            raise ValueError(
                f"block_frames * hop ({self.block_frames * self.hop}) must "
                f"cover the warm-start length M={self.M}; raise "
                f"block_frames")
        if self.block_frames < self.halo:
            raise ValueError(
                f"block_frames ({self.block_frames}) must be >= the "
                f"upsampler halo ({self.halo})")
        self.dev = resolve_device(device)
        self.cluster = ar_kernel.cluster_size(cfg, dtype, self.dev,
                                              int(fused))
        # the kernel's weights, made once for every block's call
        self.weights = ar_kernel.kernel_weights(pp, cfg, dtype, int(fused),
                                                self.dev, self.cluster)
        self.speaker = speaker
        self._kw = dict(chunk=chunk, dtype=dtype, stream=stream,
                        fused=int(fused), cluster=self.cluster,
                        device=self.dev)
        self._rng = np.random.default_rng(seed)
        self._frames = None          # (B, F_pending, aux) not yet upsampled
        self._frames_base = 0        # global index of self._frames[:, 0]
        self._done_frames = 0        # frames fully synthesized
        self._hist = None            # warm-up (M + 1 samples, c_up rows, uniforms)
        self._record = bool(record_noise)
        self._noise_cols, self._cond_cols = [], []
        self._closed = False

    def _upsample_block(self, lo: int, hi: int, last: bool):
        """c_up rows for frames [lo, hi): upsample the haloed window and
        trim. At the true utterance edges the SAME-conv zero padding is the
        full utterance's, so there is nothing to trim there."""
        a = max(lo - self.halo, 0)
        b = hi if last else hi + self.halo
        win = self._frames[:, a - self._frames_base:b - self._frames_base]
        with torch.no_grad():
            c_up = self.model.upsample_cond(
                torch.from_numpy(np.ascontiguousarray(win)).to(self.dev),
                self.speaker)
        s = (lo - a) * self.hop
        return c_up[:, s:s + (hi - lo) * self.hop]

    def _generate(self, c_blk):
        n = c_blk.shape[1]
        noise = torch.from_numpy(self._rng.uniform(
            1e-7, 1.0 - 1e-7, (self.B, n)).astype(np.float32)).to(self.dev)
        if self._record:
            self._noise_cols.append(noise)
            self._cond_cols.append(c_blk)
        if self._hist is None:
            out = ar_kernel.generate(self.weights, self.cfg, c_blk,
                                     noise=noise, **self._kw)
        else:
            wav, c_prev, n_prev = self._hist
            prev = wav[:, :-1]
            if self.cfg.head == "softmax":
                prev = mulaw_quantize(prev, self.cfg.quantize_channels).float()
            # the warm-up replays the previous M steps: step s - M + t is
            # forced with sample s - M - 1 + t and sees the conditioning and
            # noise it consumed
            out = ar_kernel.generate(
                self.weights, self.cfg, torch.cat([c_prev, c_blk], dim=1),
                noise=torch.cat([n_prev, noise], dim=1), teacher=prev,
                warmup=self.M, **self._kw)[:, self.M:]
        # roll the history: the M + 1 samples before the next block, from
        # the previous history and this block (before the first block, the
        # silence seed: 0.0, whose class id is the kernel's Q / 2), and the
        # M conditioning rows and uniforms of this block (it has >= M)
        before = (torch.zeros_like(out[:, :1]) if self._hist is None
                  else self._hist[0])
        wav = torch.cat([before, out], dim=1)
        self._hist = (wav[:, -(self.M + 1):], c_blk[:, -self.M:],
                      noise[:, -self.M:])
        return out

    def _drain(self, last: bool) -> np.ndarray:
        """Synthesize every complete block currently available."""
        pieces = []
        while True:
            have = self._frames.shape[1] + self._frames_base
            ready = have - self._done_frames - (0 if last else self.halo)
            if ready < self.block_frames and not (last and ready > 0):
                break
            n = min(ready, self.block_frames)
            is_tail = last and n < self.block_frames
            lo, hi = self._done_frames, self._done_frames + n
            c_blk = self._upsample_block(lo, hi, last=last and hi == have)
            if is_tail:
                # pad the final partial block to a whole one (zero
                # conditioning, as pad_batch_for_decode); trim after
                c_blk = torch.nn.functional.pad(
                    c_blk, (0, 0, 0, (self.block_frames - n) * self.hop))
            out = self._generate(c_blk)
            pieces.append(out[:, :n * self.hop].cpu().numpy())
            self._done_frames = hi
            # drop the frames no longer needed (the upsampling halo stays)
            keep_from = self._done_frames - self.halo
            if keep_from > self._frames_base:
                self._frames = self._frames[:, keep_from - self._frames_base:]
                self._frames_base = keep_from
            if is_tail or (last and self._done_frames == have):
                break
        if not pieces:
            return np.zeros((self.B, 0), np.float32)
        return np.concatenate(pieces, axis=1)

    def push(self, frames) -> np.ndarray:
        """Feed (B, n, aux) frames; returns (B, m) newly synthesized
        samples (m may be 0 while the lookahead or the block fills)."""
        if self._closed:
            raise RuntimeError("session is closed (flush() already called)")
        frames = np.asarray(frames, np.float32)
        if (frames.ndim != 3 or frames.shape[0] != self.B
                or frames.shape[2] != self.cfg.aux_channels):
            raise ValueError(f"expected ({self.B}, n, "
                             f"{self.cfg.aux_channels}) frames, got "
                             f"{frames.shape}")
        self._frames = (frames if self._frames is None
                        else np.concatenate([self._frames, frames], axis=1))
        return self._drain(last=False)

    def flush(self) -> np.ndarray:
        """End the utterance: synthesize all remaining frames (with the
        utterance-final upsampler edge) and close the session."""
        if self._closed:
            raise RuntimeError("session is closed")
        self._closed = True
        if self._frames is None:
            return np.zeros((self.B, 0), np.float32)
        return self._drain(last=True)

    @property
    def samples_emitted(self) -> int:
        return self._done_frames * self.hop

    def _recorded(self, cols, empty):
        if not self._record:
            raise RuntimeError("construct with record_noise=True")
        if not cols:
            return empty
        return torch.cat(cols, dim=1)[:, :self.samples_emitted]

    def noise_so_far(self) -> torch.Tensor:
        """(B, samples_emitted) uniforms consumed so far, in global sample
        order, on the session's device (a padded tail block's pad region is
        trimmed): a batch call with them replays the stream."""
        return self._recorded(self._noise_cols,
                              torch.zeros((self.B, 0), device=self.dev))

    def cond_so_far(self) -> torch.Tensor:
        """(B, samples_emitted, C) conditioning rows the blocks consumed,
        in global sample order, on the session's device."""
        return self._recorded(self._cond_cols, torch.zeros(
            (self.B, 0, self.cfg.cond_channels), device=self.dev))
