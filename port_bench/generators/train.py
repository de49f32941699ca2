"""Training: `Trainer.multi_step` fed by the port's own `GroupSampler` and
`Prefetcher`, as `Trainer.fit` feeds it, with no checkpoint and no log.

Mix parameters: `utterances` and `utt_seconds`, the synthetic corpus made
from the seed (waveforms and normalized frames, made on the device in one
call each); `trace_groups`, the groups the traced run profiles after the
window. The batch, segment and steps per call are the configuration's.

Set-up builds one trainer and its state from the seed's weights and
drives it through its first group of K updates: one `multi_step` call on
the first group of the window's own feed, the call the window times. The
window goes on from that state. Its wall time runs from a synchronised
start to the synchronised end of the group in flight when `--seconds`
have passed.

The check, after the window, judges that first group. Its data: each row
of the group as the trainer got it is found in the corpus (a
frame-aligned place whose samples it holds) and cut there again by the
reference, conditioning frames included; `data_rows_off` counts the rows
found nowhere or cut otherwise, and the batches that repeat one of the
group. The reference then follows the K updates on its own cuts from the
same weights. Compared: each update's loss (relative gap, the worst of
the K), the group's clipped gradients as Adam holds them after it (its
first moment over 1 - b1^K) and the parameters' change over the group,
both as the gap between the program's and the reference's norm of each
leaf over the larger of the reference's norm of that leaf and of the
median leaf, worst leaf. Leaves whose reference moment is under a
thousandth of the median leaf's (unreached by the loss: Adam moves them
by round-off alone) are left out of the change.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import inputs, profiling, reference
from port_bench.harness import Record


def corpus(ctx, cfg):
    """(n, L) waveforms and (n, L / hop, aux) normalized frames, made on
    the device from the seed."""
    mix, dev = ctx.mix, ctx.device
    n, hop = mix["utterances"], cfg.data.hop_length
    frames = int(round(mix["utt_seconds"] * cfg.data.sample_rate / hop))
    g = inputs.generator(ctx.seed, "corpus", dev)
    wav = torch.clamp(0.3 * torch.randn((n, frames * hop), generator=g,
                                        device=dev), -1.0, 1.0).cpu().numpy()
    feats = torch.randn((n, frames, cfg.model.aux_channels), generator=g,
                        device=dev).cpu().numpy()
    return wav, feats


def reference_batches(group, wav, feats, segment: int, hop: int):
    """The reference's own cut of each row of `group` (host arrays x (K, B,
    pad + segment) and cond (K, B, frames, aux), as the trainer got them)
    and the count of rows it does not hold: found nowhere in the corpus,
    or not equal to the reference's cut there, or in a batch that repeats
    an earlier one of the group."""
    K, B, T = group["x"].shape
    pad, off, batches, seen = T - segment, 0, [], []
    for k in range(K):
        xs, cs, where = [], [], []
        for b in range(B):
            x, c = group["x"][k, b], group["cond"][k, b]
            at = reference.locate(x[pad:], wav, hop)
            if at is None:
                # counted; the row goes on as given, for the other numbers
                off += 1
                xs.append(x)
                cs.append(c)
                continue
            rx, rc = reference.cut_segment(wav[at[0]], feats[at[0]], at[1],
                                           pad, segment, hop)
            off += not (np.array_equal(rx, x) and np.array_equal(rc, c))
            xs.append(rx)
            cs.append(rc)
            where.append(at)
        if where and where in seen:
            off += B
        seen.append(where)
        batches.append((np.stack(xs), np.stack(cs)))
    return batches, off


def leaf_norms(trainer, flat) -> dict:
    parts = torch.split(flat.detach().float(), trainer.sizes)
    return {name.replace(".", "/"): float(torch.linalg.vector_norm(p))
            for name, p in zip(trainer.names, parts)}


def norm_gap(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's |program norm - reference norm| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    names = [k for k in ref if keep is None or keep(k)]
    med = float(np.median([ref[k] for k in names]))
    worst = max(names, key=lambda k: abs(prog[k] - ref[k])
                / max(ref[k], med))
    return abs(prog[worst] - ref[worst]) / max(ref[worst], med), worst


def reference_numbers(w, mc, tc, seg, batches, rnd=reference.bf16):
    """The reference's losses over `batches`, the leaf norms of Adam's
    first moment after them (bias-corrected) and of its parameters'
    change over them."""
    losses, g, wk = reference.adam_steps(w, mc, tc, seg, batches, rnd)
    return (losses,
            {k: float(torch.linalg.vector_norm(v)) for k, v in g.items()},
            {k: float(torch.linalg.vector_norm(wk[k] - w[k])) for k in w})


def compare(got, ref):
    """(loss gap, gradient gap, change gap, worst gradient leaf, worst
    change leaf) of `got` against `ref`, both (losses, first-moment leaf
    norms, change leaf norms)."""
    med_g = float(np.median(list(ref[1].values())))
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(got[0], ref[0]))
    grad_gap, g_leaf = norm_gap(got[1], ref[1])
    moved_gap, m_leaf = norm_gap(got[2], ref[2],
                                 keep=lambda k: ref[1][k] >= 1e-3 * med_g)
    return loss_gap, grad_gap, moved_gap, g_leaf, m_leaf


def run(ctx) -> Record:
    from shallow_wavenet_tpu_torch.data.dataset import (
        SegmentSampler, Utterance)
    from shallow_wavenet_tpu_torch.data.prefetch import (
        GroupSampler, Prefetcher)
    from shallow_wavenet_tpu_torch.training import Trainer

    cfg, mix, dev = ctx.program_config(), ctx.mix, ctx.device
    mc, tc = ctx.model_dict(), dict(ctx.cell.config["config"]["train"])
    d = cfg.data
    K = int(cfg.train.steps_per_call)
    B, seg = d.batch_size, d.segment_length
    w = inputs.weights(mc, ctx.seed, dev)
    wav, feats = corpus(ctx, cfg)
    sampler = SegmentSampler(
        [Utterance(a, f) for a, f in zip(wav, feats)], batch_size=B,
        segment_length=seg, hop_length=d.hop_length,
        receptive_field=cfg.model.receptive_field,
        seed=inputs.seed_of(ctx.seed, "sampler"),
        silence_boost=d.silence_boost)
    ctx.mark("weights and corpus")
    trainer = Trainer(cfg, dev)
    state = trainer.init_state(tree=inputs.nested_numpy(w))
    start = state.params.detach().clone()
    ctx.mark("trainer")
    tracer = profiling.Tracer(dev) if ctx.trace else None
    if tracer:
        tracer.warm()
    feed = Prefetcher(GroupSampler(sampler, K), put_fn=trainer.to_device)
    try:
        # the first group, through the window's own feed and call: judged
        # after the window
        group = next(feed)
        first = {k: v.cpu().numpy() for k, v in group.items()}
        state, m = trainer.multi_step(state, group)
        prog_losses = [float(v) for v in m["loss"].tolist()]
        moment = leaf_norms(trainer, state.opt_state["mu"]
                            / (1 - reference.ADAM_B1 ** K))
        moved = leaf_norms(trainer, state.params - start)
        del group, start
        t0 = ctx.window_opens()
        updates, wait, ends = 0, 0.0, [t0]
        while True:
            a = time.perf_counter()
            group = next(feed)
            wait += time.perf_counter() - a
            state, _ = trainer.multi_step(state, group)
            updates += K
            ends.append(time.perf_counter())
            if ends[-1] - t0 >= ctx.seconds:
                break
        ctx.sync()
        window_s = time.perf_counter() - t0
        groups = updates // K
        tr = None
        if tracer:
            tracer.start()
            for _ in range(mix["trace_groups"]):
                with profiling.span("pb.prefetch.next", True):
                    group = next(feed)
                with profiling.span("pb.trainer.multi_step", True):
                    state, _ = trainer.multi_step(state, group)
            tracer.stop()
            tr = tracer.result(["pb.prefetch.next", "pb.trainer.multi_step"])
    finally:
        feed.close()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del state, trainer, group
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    cut, rows_off = reference_batches(first, wav, feats, seg, d.hop_length)
    batches = [(torch.from_numpy(x).to(dev), torch.from_numpy(c).to(dev))
               for x, c in cut]
    ref = reference_numbers(w, mc, tc, seg, batches)
    loss_gap, grad_gap, moved_gap, g_leaf, m_leaf = compare(
        (prog_losses, moment, moved), ref)
    readings = {}
    if ctx.readings:
        # the control (the reference in fp8) and the half-batch fault
        # (the reference on the first half of each batch's rows), each in
        # the program's place
        half = [(x[:len(x) // 2], c[:len(c) // 2]) for x, c in batches]
        for what, numbers in (
                ("control", reference_numbers(w, mc, tc, seg, batches,
                                              reference.fp8)),
                ("half_batch", reference_numbers(w, mc, tc, seg, half))):
            got = compare(numbers, ref)
            readings.update({f"{what}.{k}": v for k, v in zip(
                ("loss_gap", "grad_gap", "change_gap"), got)})
    lim = ctx.limits
    # host time per group, enqueue to enqueue: the spread within the run
    per = 1e3 * np.diff(ends)
    q1, q2, q3 = np.percentile(per, [25, 50, 75])
    third = max(len(per) // 3, 1)
    ctx.log(f"{updates} updates in {window_s:.4f} s ({groups} groups of "
            f"{K}); per group median {q2:.3f} ms, quartiles {q1:.3f} and "
            f"{q3:.3f}, first third {np.median(per[:third]):.3f}, last "
            f"third {np.median(per[-third:]):.3f}; data wait "
            f"{1e3 * wait / max(groups, 1):.4f} ms per group; losses "
            f"{prog_losses} against {ref[0]}; worst gradient leaf {g_leaf}, "
            f"worst change leaf {m_leaf}; rows off {rows_off} of {K * B}")
    facts = {"updates": updates, "groups": groups, "K": K, "B": B,
             "segment": seg, "x_len": batches[0][0].shape[1],
             "data_wait_s": wait, "mix": mix, "model": mc,
             "idle_units": (mix["trace_groups"] * K, updates, window_s),
             "readings": readings}
    checks = [("data_rows_off", rows_off, lim["data_rows_off"]),
              ("loss_gap", loss_gap, lim["loss_gap"]),
              ("grad_gap", grad_gap, lim["grad_gap"]),
              ("change_gap", moved_gap, lim["change_gap"])]
    return Record(kind="train", window_s=window_s, facts=facts,
                  checks=checks, attempted=K,
                  failed=sum(v > li for _, v, li in checks),
                  memory_peak_bytes=peak, trace=tr)
