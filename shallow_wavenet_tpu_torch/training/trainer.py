"""Teacher-forced training loop — the torch twin of
`shallow_wavenet_tpu/training/trainer.py`, on one device or data-parallel
over the ranks of a process group (`parallel.init_distributed`).

The step is the JAX step's math in eager PyTorch:
- the loss: mu-law input and target for the softmax head, the port's
  `WaveNet`, the mask on the last `segment_length` steps;
- optax's chain spelled out on one flat fp32 vector of every parameter
  (`TrainState.params`, the model's parameter order): the global-norm clip
  (scale by max/norm only when norm >= max), Adam (b1 0.9, b2 0.999, eps
  1e-8), decoupled decay of every parameter when weight_decay > 0, and the
  learning rate of `optax.exponential_decay` without staircase. A parameter
  the loss does not reach (the last layer's `res`) gets a zero gradient, as
  in JAX, so it is decayed like every other;
- `grad_accum` microbatches of contiguous rows, one update on their mean;
  `steps_per_call` = K updates per `multi_step` call over a (K, B, ...)
  group already on the device; `context_dropout` on the input copy, its
  mask drawn on the host from (seed, step, microbatch), data-parallel at
  the global batch's rows, of which each rank keeps its own.

The forward splits the flat vector into views (one `split`, whose backward
is one concatenation with zeros for unreached parameters) and runs the
model on them through `torch.func.functional_call`. Checkpoints are
directories `<workdir>/checkpoints/<step>/`: `.npz` files in the flax
parameter-tree layout (`models.wavenet.save_params_npz` names), Adam's
moments likewise, and a JSON file with the step and the sampler state.
`fit` writes `metrics.jsonl` and the same records as TensorBoard scalars
under `<workdir>/tb` (`utils.observability.MetricsWriter`).

Debug mode (`utils.observability.enable_debug_mode`, `--debug-nans`):
every update's loss is checked before its backward, the backward runs
under autograd's anomaly mode, and the loss, gradient norm and parameters
after the update are checked for finite values; the first that is not
raises `FloatingPointError` naming the update (1-based, the count the
records' "step" uses). Off, no check runs and no host sync is added.

Data parallelism. The JAX DP step computes each device's gradient on its
rows, the mean over the data axis (inserted by XLA), then the global-norm
clip on that mean. Here each rank computes the gradient of its own rows
(its `grad_accum` microbatches summed locally), then one `all_reduce` of
the flat gradient with the loss appended makes their mean on every rank,
before the clip and Adam. `DistributedDataParallel` would have nothing to
hook: the step differentiates with respect to the flat vector
`TrainState.params`, not the module's `nn.Parameter`s, and one all-reduce
of that vector per update is DDP's bucketed reduce with a single bucket.
Every rank applies the same reduced gradient to the same parameters, so
every rank ends each update with the same parameters, to the bit. `fit`
writes `config.json`, `metrics.jsonl` and the checkpoints on rank 0 alone
(the JAX `fit`'s `is_main`); every rank computes, and the ranks meet at a
barrier after each save. Each rank keeps its own sampler state: the
checkpoint holds every rank's, gathered to rank 0, and `restore` hands
each rank its own.

No hand-written kernel lies on this path: the JAX step is one XLA program
with no Pallas call, and its products stay `torch.matmul` here.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.config import Config
from shallow_wavenet_tpu_torch.data.prefetch import GroupSampler, Prefetcher
from shallow_wavenet_tpu_torch.models import heads
from shallow_wavenet_tpu_torch.models.wavenet import (
    WaveNet, _unflatten, init_params_tree, load_params_npz, params_from_flax,
    save_params_npz,
)
from shallow_wavenet_tpu_torch.ops.mulaw import mulaw_quantize
from shallow_wavenet_tpu_torch.parallel import mesh
from shallow_wavenet_tpu_torch.utils import observability
from shallow_wavenet_tpu_torch.utils.observability import MetricsWriter, span

log = logging.getLogger(__name__)

# optax.adam's defaults, which the JAX trainer takes
B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass
class TrainState:
    params: torch.Tensor   # flat fp32 vector, the model's parameter order
    opt_state: dict        # {"mu": flat, "nu": flat}: Adam's moments
    step: int              # updates done: Adam's and the schedule's count

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)


class Trainer:
    """The trainer of one device, or of one rank of a data-parallel group.
    `device=None` means CUDA, and raises without it; `device="cpu"` runs
    the same code on the host. dp: reduce each update over the process
    group's ranks; None (the default) does so when a group of more than
    one rank is up, True also at world size 1 (the collective then runs
    and changes no bit)."""

    def __init__(self, cfg: Config, device=None, dp: bool | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dp = mesh.world() > 1 if dp is None else bool(dp)
        if self.dp and not dist.is_initialized():
            raise ValueError("dp=True needs a process group "
                             "(parallel.init_distributed)")
        # the module's own parameters stay on the host, unused: every call
        # passes the state's views through functional_call
        self.model = WaveNet(cfg.model)
        named = list(self.model.named_parameters())
        self.names = [n for n, _ in named]
        self.shapes = [tuple(p.shape) for _, p in named]
        self.sizes = [p.numel() for _, p in named]

    # ---- parameter layout -------------------------------------------------
    def flat_params(self, tree) -> torch.Tensor:
        """A flax-layout parameter tree -> the flat fp32 vector on the
        device. Every parameter must be present with its flax shape."""
        params_from_flax(self.model, tree)
        return torch.cat([p.detach().reshape(-1)
                          for p in self.model.parameters()]).to(self.device)

    def params_tree(self, flat: torch.Tensor) -> dict:
        """The flat vector -> a flax-layout tree of numpy arrays."""
        host = flat.detach().float().cpu().numpy()
        offsets = np.cumsum([0] + self.sizes)
        return _unflatten({
            name.replace(".", "/"): host[lo:hi].reshape(shape)
            for name, shape, lo, hi in zip(self.names, self.shapes,
                                           offsets[:-1], offsets[1:])})

    def _views(self, flat: torch.Tensor) -> dict:
        return {name: v.view(shape) for name, shape, v in
                zip(self.names, self.shapes, torch.split(flat, self.sizes))}

    # ---- init ------------------------------------------------------------
    def init_state(self, seed: int | None = None, tree=None) -> TrainState:
        """A fresh state from `tree` (a flax-layout parameter tree) or, when
        None, from the port's own numpy init `init_params_tree(cfg.model,
        seed)` (seed None: train.seed). Flax's init draws from JAX's PRNG
        and cannot be reproduced here: to start from the JAX trainer's
        init, pass its tree."""
        cfg = self.cfg
        if tree is None:
            tree = init_params_tree(
                cfg.model, cfg.train.seed if seed is None else seed)
        params = self.flat_params(tree)
        log.info("model %s: %.2fM params, receptive field %d samples",
                 cfg.name, params.numel() / 1e6, cfg.model.receptive_field)
        return TrainState(params=params,
                          opt_state={"mu": torch.zeros_like(params),
                                     "nu": torch.zeros_like(params)},
                          step=0)

    def to_device(self, batch: dict) -> dict:
        """Host batch (or stacked group) -> tensors on the device: on CUDA
        through pinned memory and a non-blocking copy. `speaker` is dropped
        when the model has no speaker embedding."""
        out = {}
        for k, v in batch.items():
            if k == "speaker" and self.cfg.model.n_speakers == 0:
                continue
            t = torch.as_tensor(v)
            if t.device.type == "cpu" and self.device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        return out

    # ---- the step --------------------------------------------------------
    def _dropout_generator(self, step: int, micro: int) -> torch.Generator:
        """The host generator of one microbatch's context-dropout mask,
        seeded from (train.seed, step, micro): deterministic and exact
        across resume, distinct per step and microbatch."""
        seed = np.random.SeedSequence(
            [self.cfg.train.seed, step, micro]).generate_state(1)[0]
        return torch.Generator().manual_seed(int(seed))

    def _context_dropout(self, x, generator: torch.Generator):
        """Zero random spans of the waveform used as AR input.

        Span length = train.context_dropout_span_ms; each span is dropped
        i.i.d. with probability train.context_dropout. Only the INPUT copy
        is masked (the caller keeps the unmasked waveform for targets).
        Data-parallel, every rank draws the mask of the global microbatch
        (the ranks' rows in rank order) and keeps its own rows, as JAX's DP
        step draws one (global B, n_spans) mask: each row of the global
        batch gets a mask of its own, the one the single-process update on
        the row concatenation of the ranks' batches gives it."""
        cfg = self.cfg
        b, t = x.shape
        span = max(1, int(round(cfg.train.context_dropout_span_ms
                                * cfg.data.sample_rate / 1000.0)))
        n_spans = -(-t // span)
        r, n = (mesh.rank(), mesh.world()) if self.dp else (0, 1)
        draw = torch.rand((b * n, n_spans), generator=generator)
        keep = draw[r * b:(r + 1) * b] < 1.0 - cfg.train.context_dropout
        mask = keep.repeat_interleave(span, dim=1)[:, :t]
        return x * mask.to(device=x.device, dtype=x.dtype)

    def _loss_fn(self, params: torch.Tensor, batch: dict,
                 generator: torch.Generator | None = None):
        cfg = self.cfg
        x = batch["x"]                         # (B, R+L) float waveform
        cond = batch["cond"]                   # (B, (R+L)/H, F)
        if x.dim() != 2 or cond.dim() != 3:
            raise ValueError(f"x must be (B, T) and cond (B, F, C); got "
                             f"{tuple(x.shape)} and {tuple(cond.shape)}")
        if x.dtype != torch.float32 or cond.dtype != torch.float32:
            raise ValueError(f"x and cond must be float32; got {x.dtype} "
                             f"and {cond.dtype}")
        if cond.shape[1] * cfg.data.hop_length != x.shape[1]:
            raise ValueError(f"cond frames {cond.shape[1]} x hop "
                             f"{cfg.data.hop_length} != x length {x.shape[1]}")
        if cond.shape[2] != cfg.model.aux_channels:
            raise ValueError(f"cond has {cond.shape[2]} channels, the model "
                             f"{cfg.model.aux_channels}")
        spk = batch.get("speaker") if cfg.model.n_speakers > 0 else None
        # the generator is None at eval and when context_dropout == 0
        x_in_src = (self._context_dropout(x, generator)
                    if generator is not None and cfg.train.context_dropout > 0
                    else x)
        if cfg.model.head == "softmax":
            q = cfg.model.quantize_channels
            x_in = mulaw_quantize(x_in_src, q)[:, :-1]
            target = mulaw_quantize(x, q)[:, 1:]
        else:
            x_in, target = x_in_src[:, :-1], x[:, 1:]
        out = functional_call(self.model, self._views(params),
                              (x_in, cond, spk))
        t = x_in.shape[1]
        # loss only where the receptive field is fully inside the context
        mask = (torch.arange(t, device=x.device)
                >= t - cfg.data.segment_length).float()[None, :]
        if cfg.model.head == "softmax":
            return heads.softmax_loss(out, target, mask)
        return heads.laplace_loss(out, target, cfg.model.log_b_min,
                                  cfg.model.log_b_max, mask)

    def value_and_grad(self, state: TrainState, batch: dict):
        """(loss, gradient) of one update on `batch`, before the optimizer:
        the gradient is flat, in the params' layout. With grad_accum = N,
        the means over N microbatches of contiguous rows."""
        accum = max(1, int(self.cfg.train.grad_accum))
        batch = self.to_device(batch)
        drop = self.cfg.train.context_dropout > 0.0
        params = state.params.detach().requires_grad_()
        b = batch["x"].shape[0]
        if b % accum:
            raise ValueError(
                f"batch_size {b} not divisible by grad_accum {accum}")
        rows = b // accum
        loss, grad = None, None
        for i in range(accum):
            mb = (batch if accum == 1 else
                  {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()})
            gen = self._dropout_generator(state.step, i) if drop else None
            with span("swt.train.forward"):
                l_i = self._loss_fn(params, mb, gen)
            debug = observability.debug_mode()
            if debug:
                _check_finite(state.step + 1, loss=l_i)
            try:
                with span("swt.train.backward"):
                    (g_i,) = torch.autograd.grad(l_i, params)
            except RuntimeError as e:
                # anomaly mode's report of a backward op that made a NaN
                if debug and "nan values" in str(e):
                    raise FloatingPointError(
                        f"non-finite gradient at update {state.step + 1}: "
                        f"{e}") from e
                raise
            loss = l_i.detach() if loss is None else loss + l_i.detach()
            grad = g_i if grad is None else grad + g_i
        if accum > 1:
            loss, grad = loss / accum, grad / accum
        return loss, grad

    def learning_rate(self, count: int) -> float:
        """optax.exponential_decay(lr, lr_decay_steps, lr_decay_rate) at
        `count` updates done, in float32: lr * rate ** (count / steps)."""
        tc = self.cfg.train
        if tc.lr_decay_steps <= 0 or tc.lr_decay_rate == 0 or count <= 0:
            return float(np.float32(tc.learning_rate))
        p = np.float32(count) / np.float32(tc.lr_decay_steps)
        return float(np.float32(tc.learning_rate)
                     * np.power(np.float32(tc.lr_decay_rate), p))

    @torch.no_grad()
    def _apply(self, state: TrainState, grad: torch.Tensor):
        """optax.chain(clip_by_global_norm, adam[w]) and apply_updates, in
        optax's op order. Returns (new state, pre-clip global norm)."""
        tc = self.cfg.train
        count = state.step + 1
        norm = torch.linalg.vector_norm(grad)
        g = torch.where(norm < tc.grad_clip_norm, grad,
                        grad / norm * tc.grad_clip_norm)
        mu = (1 - B1) * g + B1 * state.opt_state["mu"]
        nu = (1 - B2) * (g * g) + B2 * state.opt_state["nu"]
        bc1 = np.float32(1) - np.float32(B1) ** np.float32(count)
        bc2 = np.float32(1) - np.float32(B2) ** np.float32(count)
        u = (mu / float(bc1)) / (torch.sqrt(nu / float(bc2)) + EPS)
        if tc.weight_decay > 0:
            u = u + tc.weight_decay * state.params
        params = state.params + (-self.learning_rate(state.step)) * u
        return TrainState(params=params, opt_state={"mu": mu, "nu": nu},
                          step=count), norm

    def _all_reduce(self, loss: torch.Tensor, grad: torch.Tensor):
        """The mean of (loss, gradient) over the ranks: one all_reduce of
        the flat gradient with the loss appended."""
        buf = mesh.all_reduce_mean(torch.cat([grad, loss.reshape(1)]))
        return buf[-1], buf[:-1]

    def step(self, state: TrainState, batch: dict):
        """One update. Returns (new state, {"loss", "grad_norm"}) with the
        metrics as device scalars (no host sync); `state` is left as it
        was. Data-parallel: `batch` is this rank's rows, and the loss and
        gradient are the means over the ranks."""
        with span("swt.train.step", id=state.step + 1):
            loss, grad = self.value_and_grad(state, batch)
            if self.dp:
                loss, grad = self._all_reduce(loss, grad)
            with span("swt.train.apply"):
                state, norm = self._apply(state, grad)
            if observability.debug_mode():
                _check_finite(state.step, loss=loss, grad_norm=norm,
                              params=state.params)
            return state, {"loss": loss, "grad_norm": norm}

    def multi_step(self, state: TrainState, group: dict):
        """K updates over a (K, B, ...) group, in order: the math of K
        `step` calls. Metrics are (K,) device tensors."""
        with span("swt.train.multi_step", id=state.step + 1):
            group = self.to_device(group)
            ms = []
            for i in range(group["x"].shape[0]):
                state, m = self.step(state,
                                     {k: v[i] for k, v in group.items()})
                ms.append(m)
            return state, {k: torch.stack([m[k] for m in ms])
                           for k in ms[0]}

    # ---- eval ------------------------------------------------------------
    @torch.no_grad()
    def eval_loss(self, state: TrainState, batches: list[dict]) -> float:
        """The mean loss over `batches` (data-parallel: and over the
        ranks, each with its own batches)."""
        losses = torch.stack([self._loss_fn(state.params, self.to_device(b))
                              for b in batches])
        if self.dp:
            mesh.all_reduce_mean(losses)
        return float(np.mean(losses.tolist()))

    # ---- checkpointing ---------------------------------------------------
    @staticmethod
    def latest_step(workdir: str | Path) -> int | None:
        """The newest checkpoint's step under `workdir`, or None."""
        root = Path(workdir) / "checkpoints"
        steps = ([int(p.name) for p in root.iterdir() if p.name.isdigit()]
                 if root.is_dir() else [])
        return max(steps) if steps else None

    def save(self, workdir: str | Path, state: TrainState,
             sampler_state: dict | None = None) -> None:
        """Write `<workdir>/checkpoints/<step>/` atomically (a temporary
        directory beside it, then a rename) and keep the newest
        train.keep_checkpoints."""
        root = Path(workdir).resolve() / "checkpoints"
        root.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix=f".{state.step}-", dir=root))
        save_params_npz(tmp / "params.npz", self.params_tree(state.params))
        save_params_npz(tmp / "opt_state.npz", {
            k: self.params_tree(v) for k, v in state.opt_state.items()})
        # the sampler item is always present ({} when the iterator exposes
        # no state) so restore() never has to guess the layout
        (tmp / "state.json").write_text(json.dumps({
            "step": state.step,
            "sampler": (_json_safe(sampler_state)
                        if sampler_state is not None else {})}))
        final = root / str(state.step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        steps = sorted(int(p.name) for p in root.iterdir()
                       if p.name.isdigit())
        for s in steps[:-max(1, self.cfg.train.keep_checkpoints)]:
            shutil.rmtree(root / str(s))

    def restore(self, workdir: str | Path, state: TrainState
                ) -> tuple[TrainState, dict | None, int]:
        """Restore the latest checkpoint. Returns (state, sampler_state,
        step); `state` untouched, None and 0 if there is none. In a
        process group the sampler state is this rank's own; a checkpoint
        written by another number of ranks has none for it (a warning,
        and None)."""
        latest = self.latest_step(workdir)
        if latest is None:
            return state, None, 0
        d = Path(workdir) / "checkpoints" / str(latest)
        opt = load_params_npz(d / "opt_state.npz")
        meta = json.loads((d / "state.json").read_text())
        restored = TrainState(
            params=self.flat_params(load_params_npz(d / "params.npz")),
            opt_state={k: self.flat_params(opt[k]) for k in ("mu", "nu")},
            step=int(meta["step"]))
        log.info("restored checkpoint at step %d", latest)
        sampler = meta["sampler"] or None
        ranks = sampler.get("ranks") if isinstance(sampler, dict) else None
        if ranks is not None or mesh.world() > 1:
            if ranks is not None and len(ranks) == mesh.world():
                sampler = ranks[mesh.rank()]
            else:
                log.warning("checkpoint %s holds the sampler states of %s "
                            "ranks, this run has %d: the samplers start "
                            "from their seeds", d,
                            len(ranks) if ranks is not None else 1,
                            mesh.world())
                sampler = None
        return restored, sampler, latest

    def checkpoint(self, workdir: str | Path, state: TrainState,
                   sampler_state: dict | None = None) -> None:
        """`save` from every rank's call: with more than one rank, every
        rank's sampler state gathered to rank 0 (as {"ranks": [...]}),
        written by rank 0 alone; then the ranks meet at a barrier, so that
        no rank reads a checkpoint half written."""
        if mesh.world() > 1:
            ranks = [None] * mesh.world()
            dist.all_gather_object(ranks, sampler_state)
            sampler_state = {"ranks": ranks}
        if mesh.is_main():
            self.save(workdir, state, sampler_state)
        if dist.is_initialized():
            dist.barrier()

    def warm_start(self, init_workdir: str | Path,
                   state: TrainState) -> TrainState:
        """Fine-tuning init: copy the PARAMS of another run's latest
        checkpoint into `state`; optimizer state, step counter and LR
        schedule restart from zero. The source run must have the same
        model config (the restore checks every shape)."""
        restored, _, latest = self.restore(init_workdir, state)
        if latest == 0:
            raise FileNotFoundError(
                f"no checkpoint to warm-start from under {init_workdir}")
        log.info("warm start: params from %s step %d (optimizer/step reset)",
                 init_workdir, latest)
        return state.replace(params=restored.params)

    # ---- the loop --------------------------------------------------------
    def fit(self, state: TrainState, sampler: Iterator[dict],
            workdir: str | Path, steps: int | None = None,
            eval_batches: list[dict] | None = None) -> TrainState:
        cfg = self.cfg
        steps = cfg.train.steps if steps is None else steps
        workdir = Path(workdir)
        # every rank computes; rank 0 alone writes the run's files
        is_main = mesh.is_main()
        ranks = mesh.world() if self.dp else 1
        workdir.mkdir(parents=True, exist_ok=True)
        if is_main:
            (workdir / "config.json").write_text(cfg.to_json())
        K = max(1, int(cfg.train.steps_per_call))
        # the worker thread assembles each batch (stacks K of them) and
        # copies it to the device while the device runs the step.
        # GroupSampler is bounded by the remaining steps, so the tail group
        # (steps % K) is drawn at exact size and the sampler state saved
        # with the final checkpoint matches the batches consumed
        start = state.step
        prefetch = Prefetcher(
            sampler if K == 1 else GroupSampler(sampler, K,
                                                total=max(steps - start, 0)),
            put_fn=self.to_device)
        t0 = time.time()
        samples_per_batch = None
        step = start
        mf = (workdir / "metrics.jsonl").open("a") if is_main else None
        tb = MetricsWriter(workdir / "tb") if is_main else None
        try:
            while step < steps:
                k = min(K, steps - step)
                if K == 1:
                    batch = next(prefetch)
                    if samples_per_batch is None:
                        samples_per_batch = batch["x"].numel()
                    state, last = self.step(state, batch)
                else:
                    group = next(prefetch)      # device (k, B, ...) leaves
                    state, ms = self.multi_step(state, group)
                    if samples_per_batch is None:
                        samples_per_batch = group["x"].numel() // k
                    last = {kk: v[-1] for kk, v in ms.items()}
                prev, step = step, step + k
                # act whenever the call crossed a boundary (steps advance
                # by k at a time); no per-step device sync. Eval rides the
                # CHECKPOINT cadence, independent of the log cadence
                le, ce = cfg.train.log_every, cfg.train.checkpoint_every
                log_due = step // le > prev // le or step == steps
                ckpt_due = step // ce > prev // ce or step == steps
                if log_due or (ckpt_due and eval_batches is not None):
                    # the clock after the loss's copy to the host, which
                    # waits for the updates: the rates count finished ones
                    loss = float(last["loss"])
                    dt = time.time() - t0
                    done = step - start
                    rec = {
                        "step": step,
                        "loss": loss,
                        "grad_norm": float(last["grad_norm"]),
                        "steps_per_s": done / max(dt, 1e-9),
                        # the global batch: every rank's rows
                        "samples_per_s": (done * samples_per_batch * ranks
                                          / max(dt, 1e-9)),
                    }
                    if ckpt_due and eval_batches is not None:
                        rec["eval_loss"] = self.eval_loss(state, eval_batches)
                    if is_main:
                        mf.write(json.dumps(rec) + "\n")
                        mf.flush()
                        tb.scalars(step, rec)
                        log.info("step %(step)d loss %(loss).4f gnorm "
                                 "%(grad_norm).2f %(steps_per_s).2f it/s",
                                 rec)
                if ckpt_due:
                    self.checkpoint(workdir, state, prefetch.state())
        finally:
            # on ANY exit (exception, Ctrl-C): stop the prefetch worker
            prefetch.close()
            if tb is not None:
                tb.close()
            if mf is not None:
                mf.close()
        return state


def _check_finite(update: int, **tensors) -> None:
    """Debug mode: raise FloatingPointError naming `update` unless every
    entry of every tensor is finite (one host sync)."""
    ok = torch.stack([torch.isfinite(v).all()
                      for v in tensors.values()]).tolist()
    bad = [k for k, good in zip(tensors, ok) if not good]
    if bad:
        raise FloatingPointError(
            f"non-finite {', '.join(bad)} at update {update}")


def _json_safe(obj):
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj
