"""Streaming synthesis — the torch twins of the session and the
multi-tenant pool in `shallow_wavenet_tpu/models/streaming.py`
(`StreamingSynthesizer`, `StreamPool`).

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

`StreamPool` serves many batch=1 streams that open and end at any time
with one upsampler call and at most two kernel launches per `step()`:
each stream's state lives in its own session, and the pool batches the
upsampling and the launch (see its docstring).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.config import ModelConfig
from shallow_wavenet_tpu_torch.ops import ar_kernel
from shallow_wavenet_tpu_torch.ops.mulaw import mulaw_quantize
from shallow_wavenet_tpu_torch.utils.observability import span

log = logging.getLogger(__name__)


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


def upsample_windows(model, windows, phase, device, speakers):
    """Every frame window's sample-rate conditioning, from one upsampler
    call: the (B_i, F_i, aux) windows stacked row-wise, left-aligned and
    zero-padded on the right to the longest, copied to `device` at once
    (their lengths with them), and upsampled with `valid_frames` = each
    row's own F_i where the lengths differ. Masking after every stage makes
    a padded row equal its window upsampled alone, and each product is
    taken per window at the window's own shape (`ConditioningUpsampler`'s
    `windows`), so a window gets the same bits alone or beside others.
    phase: the upsampler's phase weights
    (`ConditioningUpsampler.phase_weights`, made once); speakers: each
    window's (B_i,) speaker ids or None. Returns each window's
    (B_i, F_i * hop, C) fp32 rows, views of the call's output."""
    lens = np.repeat([w.shape[1] for w in windows],
                     [w.shape[0] for w in windows])
    rows, longest, aux = len(lens), int(lens.max()), windows[0].shape[2]
    host = np.zeros(rows * longest * aux + rows, np.float32)
    frames = host[:-rows].reshape(rows, longest, aux)
    r = 0
    for w in windows:
        frames[r:r + w.shape[0], :w.shape[1]] = w
        r += w.shape[0]
    host[-rows:] = lens                  # exact in fp32
    spk = None
    if model.cfg.n_speakers > 0 and all(s is not None for s in speakers):
        spk = torch.cat([torch.as_tensor(s).reshape(-1) for s in speakers])
    with span("swt.stream.upsample"), torch.no_grad():
        buf = torch.from_numpy(host).to(device)
        valid = None if lens.min() == longest else buf[-rows:].long()
        c_up = model.upsample_cond(
            buf[:-rows].view(rows, longest, aux), spk, valid, phase,
            [(w.shape[0], w.shape[1]) for w in windows])
    hop = c_up.shape[1] // longest
    out, r = [], 0
    for w in windows:
        out.append(c_up[r:r + w.shape[0], :w.shape[1] * hop])
        r += w.shape[0]
    return out


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

    pp: plain params of `model` (models.wavenet.extract_plain_params), or
    the `KernelWeights` made from them for this dtype and fused window on
    `device` (a pool makes them once for all its sessions; their layout is
    then the session's); model: the torch WaveNet on `device` (its
    upsampler runs once per block, `upsample_windows`); phase: the
    upsampler's phase weights (`ConditioningUpsampler.phase_weights`), as
    a pool makes them once for all its sessions; None makes the session's
    own, once.
    block_frames * hop must be a multiple of `chunk` (a multiple of 32) and
    at least M = warmup_length(cfg, chunk); larger blocks amortize the M
    warm-up steps per call, smaller ones cut latency. Every kernel call
    runs the layout the decode picks for `dtype` and the fused window
    `fused` (`ar_kernel.choose_layout`, `self.layout`; fused = W: not
    bit-exact against fused=0, but the stream still equals one fused
    call). The cluster kernel's wide form is refused (ValueError): its
    global ring is not yet made per launch here. record_noise: keep every
    block's uniforms and conditioning rows, for `noise_so_far` and
    `cond_so_far` (they grow with the session). device: None means CUDA;
    "cpu" runs the plain version.
    """

    def __init__(self, pp: dict, model, cfg: ModelConfig, hop_length: int,
                 batch: int = 1, block_frames: int = 24, chunk: int = 64,
                 dtype: str = "float32", speaker=None, seed: int = 0,
                 record_noise: bool = False, fused: int = 0, phase=None,
                 device=None):
        self.model, self.cfg = model, cfg
        self.hop = int(hop_length)
        self.B = int(batch)
        self.block_frames = int(block_frames)
        if chunk < 32 or chunk % 32 != 0:
            raise ValueError("chunk must be a multiple of 32")
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
        if isinstance(pp, ar_kernel.KernelWeights):
            self.layout = pp.layout
            if (self.layout.dtype, self.layout.fused) != (dtype, int(fused)):
                raise ValueError(f"kernel weights for {self.layout}; the "
                                 f"session asks for dtype={dtype!r}, "
                                 f"fused={fused}")
        else:
            self.layout = ar_kernel.choose_layout(cfg, dtype, self.dev,
                                                  int(fused))
        if self.layout.wide:
            raise ValueError(f"{self.layout.name}: the session does not run "
                             f"the cluster kernel's wide form yet")
        # the kernel's weights, made once for every block's call
        self.weights = ar_kernel.kernel_weights(pp, cfg, self.layout,
                                                self.dev)
        if phase is None:
            with torch.no_grad():
                phase = model.upsampler.phase_weights()
        self.phase = phase
        self.speaker = speaker
        self._kw = dict(layout=self.layout, dtype=self.layout.dtype,
                        device=self.dev)
        self._rng = np.random.default_rng(seed)
        self._frames = None          # (B, F_pending, aux) not yet upsampled
        self._frames_base = 0        # global index of self._frames[:, 0]
        self._done_frames = 0        # frames fully synthesized
        self._hist = None            # warm-up (M + 1 samples, c_up rows, uniforms)
        self._blk = None             # the block in flight (c_up rows, uniforms)
        self._record = bool(record_noise)
        self._noise_cols, self._cond_cols = [], []
        self._closed = False
        self.sid = None              # the pool's stream id, for the spans

    def _block_rows(self, c_up, n: int, trim: int):
        """A window's conditioning (`_next_window`, upsampled) -> the
        block's rows: the halo trimmed, a partial block padded with zero
        conditioning to a whole block (as pad_batch_for_decode pads; its
        samples are trimmed by the caller)."""
        c_blk = c_up[:, trim:trim + n * self.hop]
        if n < self.block_frames:
            c_blk = torch.nn.functional.pad(
                c_blk, (0, 0, 0, (self.block_frames - n) * self.hop))
        return c_blk

    def _prepare_block(self, c_blk):
        """One block's kernel inputs for this session's rows: (conditioning,
        uniforms, teacher), the uniforms drawn from the session's own
        stream. The first block runs free (teacher None); each later one
        replays the previous M steps: step s - M + t is forced with sample
        s - M - 1 + t and sees the conditioning and noise it consumed, so
        the call takes `warmup=M`."""
        with span("swt.stream.prepare", id=self.sid):
            n = c_blk.shape[1]
            noise = torch.from_numpy(self._rng.uniform(
                1e-7, 1.0 - 1e-7, (self.B, n)).astype(np.float32)
            ).to(self.dev)
            if self._record:
                self._noise_cols.append(noise)
                self._cond_cols.append(c_blk)
            self._blk = (c_blk, noise)
            if self._hist is None:
                return c_blk, noise, None
            wav, c_prev, n_prev = self._hist
            prev = wav[:, :-1]
            if self.cfg.head == "softmax":
                prev = mulaw_quantize(prev,
                                      self.cfg.quantize_channels).float()
            return (torch.cat([c_prev, c_blk], dim=1),
                    torch.cat([n_prev, noise], dim=1), prev)

    def _finish_block(self, wav):
        """The kernel's output for the rows `_prepare_block` gave it ->
        the block's samples, and the history rolled: the M + 1 samples
        before the next block, from the previous history and this block
        (before the first block, the silence seed: 0.0, whose class id is
        the kernel's Q / 2), and the M conditioning rows and uniforms of
        this block (it has >= M)."""
        c_blk, noise = self._blk
        out = wav if self._hist is None else wav[:, self.M:]
        before = (torch.zeros_like(out[:, :1]) if self._hist is None
                  else self._hist[0])
        samples = torch.cat([before, out], dim=1)
        self._hist = (samples[:, -(self.M + 1):], c_blk[:, -self.M:],
                      noise[:, -self.M:])
        return out

    def _generate(self, c_blk):
        c, noise, teacher = self._prepare_block(c_blk)
        return self._finish_block(ar_kernel.generate(
            self.weights, self.cfg, c, noise=noise, teacher=teacher,
            warmup=0 if teacher is None else self.M, **self._kw))

    def _next_window(self, last: bool):
        """The next block ready to synthesize, as (frames n, haloed frame
        window, trim), or None; nothing is upsampled here. Ready: a whole
        block with the upsampling halo after it; with `last` (the utterance
        has ended), whatever is left, a partial block padded by
        `_block_rows`. The window is the block's frames [lo, hi) with H
        frames of context on each side, none past the utterance's true
        edges (there the SAME-conv zero padding is the full utterance's,
        so there is nothing to trim); trim = the samples of its left
        context."""
        with span("swt.stream.next_block", id=self.sid):
            if self._frames is None:
                return None
            have = self._frames.shape[1] + self._frames_base
            ready = have - self._done_frames - (0 if last else self.halo)
            if ready < self.block_frames and not (last and ready > 0):
                return None
            n = min(ready, self.block_frames)
            lo, hi = self._done_frames, self._done_frames + n
            a = max(lo - self.halo, 0)
            b = hi if last and hi == have else hi + self.halo
            win = self._frames[:, a - self._frames_base:b - self._frames_base]
            return n, win, (lo - a) * self.hop

    def _consume(self, n: int) -> None:
        """Mark n more frames synthesized and drop the frames no longer
        needed (the upsampling halo stays)."""
        self._done_frames += n
        keep_from = self._done_frames - self.halo
        if keep_from > self._frames_base:
            self._frames = self._frames[:, keep_from - self._frames_base:]
            self._frames_base = keep_from

    @property
    def pending_frames(self) -> int:
        """Frames pushed and not yet synthesized."""
        if self._frames is None:
            return 0
        return self._frames.shape[1] + self._frames_base - self._done_frames

    def _drain(self, last: bool) -> np.ndarray:
        """Synthesize every complete block currently available."""
        pieces = []
        while (w := self._next_window(last)) is not None:
            n, win, trim = w
            (c_up,) = upsample_windows(self.model, [win], self.phase,
                                       self.dev, [self.speaker])
            out = self._generate(self._block_rows(c_up, n, trim))
            pieces.append(out[:, :n * self.hop].cpu().numpy())
            self._consume(n)
        if not pieces:
            return np.zeros((self.B, 0), np.float32)
        return np.concatenate(pieces, axis=1)

    def _append(self, frames) -> None:
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

    def push(self, frames) -> np.ndarray:
        """Feed (B, n, aux) frames; returns (B, m) newly synthesized
        samples (m may be 0 while the lookahead or the block fills)."""
        self._append(frames)
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


class StreamPool:
    """Multi-tenant serving: independent batch=1 streams that open and end
    at any time share at most two kernel launches per `step()`.

        pool = StreamPool(pp, model, cfg, hop_length=hop, slots=8)
        a = pool.open(seed=1); b = pool.open(seed=2)
        pool.push(a, frames_a); pool.push(b, frames_b)   # (n, aux) each
        for sid, samples in pool.step().items(): ...     # one cycle
        pool.end(a)
        ... pool.step() ...                              # a's tail

    Why it pays on the card: the cluster kernel runs each row on its own
    cluster, so a launch of k rows takes about one row's time while the k
    clusters fit the card at once; one step for k streams then costs about
    one stream's block.

    The design is eager PyTorch's, not a copy of the jitted JAX pool:
    - each stream's state is a batch=1 `StreamingSynthesizer`: its frames,
      its own numpy uniform stream and its warm-start history. The pool
      makes the kernel weights and the upsampler's phase weights once and
      hands them to every session (serving weights do not change);
    - a step takes from each stream at most one block, the block its
      session would synthesize next (`_next_window`: a whole block once
      the upsampling halo after it has arrived; after `end`, whatever is
      left, a partial block padded to a whole one), upsamples every
      member's haloed window in one call (`upsample_windows`, the
      function a session runs on its own window, so the rows are the
      session's to the bit), and prepares each member's rows through its
      session (`_prepare_block`): that conditioning, its uniforms, and its
      teacher;
    - the rows of every member go to one `ar_kernel.generate` call per
      phase: the streams' first blocks (no warm-up) in one, the
      warm-started blocks (teacher, `warmup=M`) in the other. The
      kernel's warm-up is one scalar per launch, hence two launches; a
      padded tail block rides the launch of its phase, and so does a
      stream that ends before its first whole block (its block is the
      one its session's `flush()` would launch). Each session then rolls
      its own history (`_finish_block`);
    - only members ride: a launch has as many rows as streams with a
      block ready, never filler rows, which would cost clusters and waves
      on the card. Past the clusters the card holds at once
      (`ar_kernel.clusters_at_once`, `clusters_at_once`) a launch runs
      in waves: the pool warns once.
    The kernel's rows do not depend on the batch (its layout is fixed per
    model, dtype, window and card, never per batch), so every stream's
    samples equal, bit for bit, a standalone session's with the same seed
    fed the same frames. On the CPU that rests on the plain version's
    products giving a row the same bits at every batch size.

    slots: the most streams open at once. `dispatches` counts the
    launches, `upsample_calls` the upsampler calls (one a step with a
    block ready) and `upsample_windows` the windows they took. device:
    None means CUDA, and raises without it; "cpu" runs the plain version.
    """

    def __init__(self, pp: dict, model, cfg: ModelConfig, hop_length: int,
                 slots: int = 8, block_frames: int = 24, chunk: int = 64,
                 dtype: str = "float32", fused: int = 0,
                 record_noise: bool = False, device=None):
        self.model, self.cfg = model, cfg
        self.S = int(slots)
        self.dev = resolve_device(device)
        self.layout = ar_kernel.choose_layout(cfg, dtype, self.dev,
                                              int(fused))
        # every session runs the pool's layout, on the pool's weights
        self._session_kw = dict(
            hop_length=hop_length, batch=1, block_frames=block_frames,
            chunk=chunk, dtype=self.layout.dtype, fused=self.layout.fused,
            record_noise=record_noise, device=self.dev)
        self.weights = ar_kernel.kernel_weights(pp, cfg, self.layout,
                                                self.dev)
        with torch.no_grad():
            self.phase = model.upsampler.phase_weights()
        # a session checks the block geometry (chunk, M, halo) and refuses
        # a layout it cannot run up front
        probe = StreamingSynthesizer(self.weights, model, cfg,
                                     phase=self.phase, **self._session_kw)
        self.hop, self.M, self.halo = probe.hop, probe.M, probe.halo
        self._kw = probe._kw
        self._sessions: dict[int, StreamingSynthesizer] = {}
        self._ended: set[int] = set()
        self._next_id = 0
        self._at_once = None
        self._warned = False
        self.dispatches = 0
        self.upsample_calls = 0
        self.upsample_windows = 0
        self._steps = 0

    # ---- lifecycle -------------------------------------------------------

    def open(self, seed: int = 0) -> int:
        """Claim a free slot for a new stream; returns the stream id."""
        if not self.free_slots:
            raise RuntimeError(f"all {self.S} slots busy")
        sid = self._next_id
        self._next_id += 1
        self._sessions[sid] = StreamingSynthesizer(
            self.weights, self.model, self.cfg, seed=seed, phase=self.phase,
            **self._session_kw)
        self._sessions[sid].sid = sid
        return sid

    def push(self, sid: int, frames) -> None:
        """Buffer (n, aux) frames for stream sid; they are synthesized in
        `step()`."""
        s = self.session(sid)
        if sid in self._ended:
            raise RuntimeError(f"stream {sid} already ended")
        frames = np.asarray(frames, np.float32)
        if frames.ndim != 2:
            raise ValueError(f"expected (n, aux) frames, got {frames.shape}")
        if frames.shape[1] != self.cfg.aux_channels:
            raise ValueError(
                f"stream {sid}: expected aux width {self.cfg.aux_channels}, "
                f"got frames of shape {frames.shape}")
        s._append(frames[None])

    def end(self, sid: int) -> None:
        """Mark end-of-stream: later steps emit the remaining samples (the
        utterance-final upsampler edge), then free the slot."""
        self.session(sid)
        self._ended.add(sid)

    @property
    def active(self) -> list[int]:
        return sorted(self._sessions)

    @property
    def free_slots(self) -> int:
        """Slots available to open()."""
        return self.S - len(self._sessions)

    def pending_frames(self, sid: int) -> int:
        return self.session(sid).pending_frames

    def session(self, sid: int) -> StreamingSynthesizer:
        """Stream sid's session: its state (and, with record_noise, its
        `cond_so_far()` and `noise_so_far()`)."""
        if sid not in self._sessions:
            raise KeyError(f"unknown/closed stream {sid}")
        return self._sessions[sid]

    @property
    def clusters_at_once(self) -> int | None:
        """Rows the card runs at once on the pool's cluster layout (None
        off the card or off the cluster kernel)."""
        if self._at_once is None:
            self._at_once = ar_kernel.clusters_at_once(self.cfg, self.layout,
                                                       self.dev)
        return self._at_once

    # ---- the batched cycle ----------------------------------------------

    def step(self) -> dict[int, np.ndarray]:
        """One synthesis cycle: every stream with a block ready gets it
        synthesized, its conditioning in one upsampler call for all of
        them and its samples in at most two launches (first blocks;
        warm-started blocks). Returns {sid: (k,) float32 samples} for the
        streams that emitted; an ended stream with nothing left is closed
        and its slot freed."""
        self._steps += 1
        with span("swt.pool.step", id=self._steps):
            ready = []
            for sid, s in sorted(self._sessions.items()):
                w = s._next_window(last=sid in self._ended)
                if w is not None:
                    ready.append((sid, s, *w))
            phases = ([], [])
            if ready:
                c_ups = upsample_windows(
                    self.model, [r[3] for r in ready], self.phase, self.dev,
                    [r[1].speaker for r in ready])
                self.upsample_calls += 1
                self.upsample_windows += len(ready)
                for (sid, s, n, _, trim), c_up in zip(ready, c_ups):
                    phases[s._hist is not None].append(
                        (sid, n, s._block_rows(c_up, n, trim)))
            out = {}
            for members in phases:
                if members:
                    out.update(self._launch(members))
            for sid in sorted(self._ended):
                if self._sessions[sid].pending_frames == 0:
                    self._close(sid)
            return out

    # ---- internals -------------------------------------------------------

    def _close(self, sid: int) -> None:
        self._sessions.pop(sid)._closed = True
        self._ended.discard(sid)

    def _launch(self, members) -> dict[int, np.ndarray]:
        """One kernel call over the members' rows (all of one phase), then
        each session's history rolled and its frames consumed."""
        rows = [self._sessions[sid]._prepare_block(c_blk)
                for sid, _, c_blk in members]
        c, noise, teacher = (None if r[0] is None else torch.cat(r)
                             for r in zip(*rows))
        at_once = self.clusters_at_once
        if at_once and len(members) > at_once and not self._warned:
            log.warning("%d streams in one launch are more than the %d "
                        "clusters of %d SMs the card holds at once: the "
                        "launch runs in waves", len(members), at_once,
                        self.layout.cluster)
            self._warned = True
        with span("swt.pool.launch", id=int(teacher is not None)):
            wav = ar_kernel.generate(
                self.weights, self.cfg, c, noise=noise, teacher=teacher,
                warmup=0 if teacher is None else self.M, **self._kw)
        self.dispatches += 1
        with span("swt.pool.copy_back"):
            host = wav.cpu().numpy()
        off = 0 if teacher is None else self.M
        out = {}
        with span("swt.pool.finish"):
            for i, (sid, n, _) in enumerate(members):
                s = self._sessions[sid]
                s._finish_block(wav[i:i + 1])
                s._consume(n)
                out[sid] = host[i, off:off + n * self.hop]
        return out
