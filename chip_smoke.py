#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (shallow_wavenet_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line; any failure exits nonzero:
  1. toolchain: the card (nvidia-smi name and power limit), torch, CUDA and
     nvcc versions; then every kernel in shallow_wavenet_tpu_torch/csrc is
     built (one nvcc per source, started together) and the build timed;
  2. weights: config 2 (shallow_laplace_single) at full width, random
     flax-layout weights from --seed with a random head2 (zero in the flax
     init), loaded through params_from_flax;
  3. kernel against plain: the AR kernel and its plain PyTorch version on
     the same conditioning and uniforms, B=4, T=4096 — Laplace teacher-
     forced, Laplace free-running (sample and greedy), softmax teacher-
     forced at config-2 widths, and segmented against unsegmented — each
     error beside its limit, and both versions' times; the kernel's time
     per call at B = 1..128 (T = 2048);
  4. main path: bin.decode.decode_utterances on 8 utterances of 75-150
     random normalized frames (1-2 s) writes wavs and decode_summary.json;
     the kernel launch counter, reset just before, must have risen. The
     kernel is then re-run on the main path's inputs (same samples, which
     are checked against the wavs) and held against the plain version,
     teacher-forced with its own samples, at the main path's shapes. Last,
     bin.decode.decode_batch with segment_samples=2048 (its launch count
     read the same way) must give the same samples;
  5. deep kernel against plain: deep_baseline at full width and depth
     (30 layers, R=128, G=256, S=256), random weights, B=4, T=4096, on the
     layouts the decode picks (fp32 and bf16, streamed rings) — fp32
     teacher-forced; fp32 free-running, sample and greedy, each sample
     held against the plain version teacher-forced with the kernel's own
     samples; bf16 on the first step of 64 rows against the bf16 plain
     version, with the fp32 plain version as the control, and the drift
     of the matmul-order bf16 plain version over 4096 steps (a reading);
     streamed at chunk 64 equal to streamed at chunk 32 (fp32 and bf16),
     and streamed equal to resident at config-2 widths with stack_size=8;
     segmented (8192) equal to unsegmented; the resident deep layout
     refused before launch; both variants' times;
  6. deep main path: decode_utterances at deep_baseline with
     --kernel-dtype float32 and then bfloat16, on 8 utterances of 40-80
     random normalized frames (0.5-1.1 s): launches of the chosen variant,
     wavs equal to a re-run of the kernel, the layout, wall seconds, RTF,
     and the plain version teacher-forced with the kernel's own samples:
     fp32 over the first 4096 steps; bf16 over the first 1024 in the
     kernel's summation order (`chain=True`), exactly, with the fp32
     control and the matmul-order version's drift beside it.
Then the card's nvidia-smi line, the kernels' JSON line and, last,
{"ok": true, "device": {...}}. Without CUDA, or outside the repo, it exits
nonzero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np
import torch

from shallow_wavenet_tpu_torch.bin import decode
from shallow_wavenet_tpu_torch.config import get_config
from shallow_wavenet_tpu_torch.data.dataset import (
    Utterance, pad_batch_for_decode,
)
from shallow_wavenet_tpu_torch.models.generate import generate_segmented
from shallow_wavenet_tpu_torch.models.wavenet import (
    WaveNet, extract_plain_params, init_params_tree, params_from_flax,
)
from shallow_wavenet_tpu_torch.ops import _build, ar_kernel
from shallow_wavenet_tpu_torch.ops.mulaw import mulaw_quantize

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12          # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12             # HBM3
TOL_TEACHER = 1e-5               # Laplace teacher-forced, kernel vs plain
# Laplace free-running, kernel vs plain: the two sum in other orders, so
# they differ by fp32 rounding (~1e-6) at every step; this random-weight
# config-2 model does not amplify that under its own feedback (the largest
# error per 512-step window stays flat over 4096 steps on an H100), so
# free running is held to the teacher-forced limit.
TOL_FREE = 1e-5
T_CHECK, B_CHECK = 4096, 4
SWEEP_T, SWEEP_B = 2048, (1, 4, 8, 32, 128)
SEGMENT = 2048
# deep_baseline. Free running is held one step at a time: the random deep
# model is chaotic under its own feedback, so two fp32 summation orders
# drift to O(1) apart within a few hundred steps (printed as
# `divergence_512`, not checked); each free-running sample is held at
# TOL_FREE against the plain version teacher-forced with the kernel's own
# samples. bf16: the kernel sums every dot as one fp32 chain in k order,
# and in bf16 every product (of two bf16 values) is exact in fp32, so the
# plain version that sums in that order (`chain=True`) does the kernel's
# operations one for one. It is held to the bit (TOL_CHAIN) on the main
# path's batch over its first steps, twice the largest streamed dilation
# (1024 at deep_baseline), so every streamed ring is written and read; the
# fp32 plain version, the control, must miss by more than CONTROL_MIN.
# The matmul-order bf16 plain version rounds at the same points but sums
# in another order, so now and then a value lands on the other side of a
# bf16 rounding edge, and the rings carry it forward: within a few hundred
# steps it drifts nearly as far from the kernel as the fp32 version does.
# That drift is printed as a reading, with no limit, beside its distance
# from the chain version, which equals it when the kernel is exact. On the
# first step (zero rings) the matmul-order version still meets the kernel
# to fp32 rounding: held at TOL_BF16_FIRST over 64 rows, where the control
# must miss by CONTROL_FACTOR x that limit.
TOL_CHAIN = 0.0
CONTROL_MIN = 1e-3
TOL_BF16_FIRST = 1e-5
CONTROL_FACTOR = 100.0
DEEP_B, DEEP_T = 4, 4096
FIRST_B, FIRST_T = 64, 16
DEEP_SEG_T, DEEP_SEGMENT = 12288, 8192
DEEP_PLAIN_T = 4096


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def require(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() over `reps` calls, after one warm-up call."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def random_model(mc, seed: int):
    tree = init_params_tree(mc, seed)
    rng = np.random.default_rng(seed + 1000)
    tree["head2"]["kernel"] = (0.05 * rng.standard_normal(
        tree["head2"]["kernel"].shape)).astype(np.float32)
    return params_from_flax(WaveNet(mc), tree).cuda()


def random_cond(mc, model, B: int, T: int, seed: int):
    """c_up (B, T, C) from random normalized frames through the upsampler."""
    hop = int(np.prod(mc.upsample_factors))
    frames = -(-T // hop)
    rng = np.random.default_rng(seed)
    cond = torch.from_numpy(rng.standard_normal(
        (B, frames, mc.aux_channels)).astype(np.float32)).cuda()
    with torch.no_grad():
        return model.upsample_cond(cond)[:, :T].contiguous()


def bound(mc, B: int, T: int, pp, weight_bytes: int = 4
          ) -> tuple[float, str]:
    """Least time (ms) for one generate call: the fp32 multiply-adds of
    every step over the fp32 peak, or c_up + noise + out (fp32) + weights
    (weight_bytes each) over the memory rate, whichever is larger. Rings
    are the kernel's own state and are not counted."""
    L, R, G = len(mc.dilations), mc.residual_channels, mc.gate_channels
    S, C = mc.skip_channels, mc.cond_channels
    O = mc.quantize_channels if mc.head == "softmax" else 2
    macs = L * (2 * R * G + C * G + (G // 2) * (S + R)) + S * S + S * O
    flops = 2.0 * macs * B * T
    nbytes = (4.0 * (B * T * C + 2 * B * T)
              + weight_bytes * sum(v.numel() for v in pp.values()))
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def phase_kernel_vs_plain(mc, model, pp, seed: int) -> dict:
    B, T = B_CHECK, T_CHECK
    c_up = random_cond(mc, model, B, T, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = ar_kernel.uniform_noise((B, T), g)
    teacher = torch.rand((B, T), generator=g, device="cuda") * 2 - 1
    checks = []

    def record(name, err, limit):
        checks.append({"check": name, "max_abs_err": err, "limit": limit,
                       "ok": err <= limit})

    def err(a, b):
        return float((a - b).abs().max())

    # (a) Laplace, teacher-forced
    k = ar_kernel.generate(pp, mc, c_up, noise=noise, teacher=teacher)
    p = ar_kernel.generate_plain(pp, mc, c_up, noise=noise, teacher=teacher)
    record("laplace_teacher_forced", err(k, p), TOL_TEACHER)
    # (b) Laplace, free-running
    for mode in ("sample", "greedy"):
        k = ar_kernel.generate(pp, mc, c_up, noise=noise, mode=mode)
        p, plain_ms = host_ms(lambda: ar_kernel.generate_plain(
            pp, mc, c_up, noise=noise, mode=mode))
        record(f"laplace_free_{mode}", err(k, p), TOL_FREE)
        require(bool(torch.isfinite(k).all()), f"finite kernel output {mode}")
    kernel_ms = cuda_ms(lambda: ar_kernel.generate(pp, mc, c_up, noise=noise))
    # (c) softmax head at config-2 widths, teacher-forced: class ids
    mcs = get_config("shallow_laplace_single", ["model.head=softmax"]).model
    ms = random_model(mcs, seed + 1)
    pps = extract_plain_params(ms)
    ids = torch.randint(0, mcs.quantize_channels, (B, T), generator=g,
                        device="cuda").float()
    q = mcs.quantize_channels
    k = mulaw_quantize(ar_kernel.generate(pps, mcs, c_up, noise=noise,
                                          teacher=ids), q)
    p = mulaw_quantize(ar_kernel.generate_plain(pps, mcs, c_up, noise=noise,
                                                teacher=ids), q)
    d = (k.long() - p.long()).abs()
    flips = float((d != 0).float().mean())
    checks.append({"check": "softmax_teacher_forced_ids",
                   "max_bin_diff": int(d.max()), "limit_bins": 1,
                   "flip_share": flips, "limit_share": 0.01,
                   "ok": int(d.max()) <= 1 and flips < 0.01})
    # (d) segmented against unsegmented, both on the kernel
    full = ar_kernel.generate(pp, mc, c_up, noise=noise)
    seg = generate_segmented(pp, mc, c_up, noise, 2048)
    record("segmented_2048_vs_unsegmented", err(seg, full), 0.0)
    # time per call across batch sizes: one block per row
    sweep = []
    for b in SWEEP_B:
        cb = random_cond(mc, model, b, SWEEP_T, seed + b)
        nb = ar_kernel.uniform_noise((b, SWEEP_T), g)
        ms = cuda_ms(lambda: ar_kernel.generate(pp, mc, cb, noise=nb), 2)
        sweep.append({"B": b, "T": SWEEP_T, "ms": ms,
                      "us_per_step": 1e3 * ms / SWEEP_T})
    result = {"B": B, "T": T, "checks": checks, "kernel_ms": kernel_ms,
              "plain_ms": plain_ms, "batch_sweep": sweep}
    emit("kernel_vs_plain", **result)
    for c in checks:
        require(c["ok"], f"kernel vs plain: {c}")
    return result


def phase_main_path(cfg, model, pp, seed: int, smi: str) -> dict:
    mc, hop, sr = cfg.model, cfg.data.hop_length, cfg.data.sample_rate
    rng = np.random.default_rng(seed + 7)
    frames = np.linspace(75, 150, 8).round().astype(int)
    utts = [Utterance(np.zeros(0, np.float32), rng.standard_normal(
        (f, mc.aux_channels)).astype(np.float32)) for f in frames]
    names = [f"utt{i}.wav" for i in range(len(utts))]
    with tempfile.TemporaryDirectory() as tmp:
        ar_kernel.launches.clear()
        summary = decode.decode_utterances(
            model, cfg, utts, names, tmp,
            torch.Generator(device="cuda").manual_seed(seed), batch_size=8)
        launches = ar_kernel.launches["ar_generate"]
        require(launches >= 1 and sum(ar_kernel.launches.values())
                == launches, "the main path launched the AR kernel, fp32 "
                "resident")
        written = json.loads((Path(tmp) / "decode_summary.json").read_text())
        require(written == summary, "decode_summary.json written")
        pcm = []
        for name, f in zip(names, frames):
            with wave.open(str(Path(tmp) / name)) as w:
                require(w.getnframes() == f * hop, f"{name} length")
                pcm.append(np.frombuffer(w.readframes(w.getnframes()), "<i2"))
    emit("main_path", utterances=len(utts), frames=frames.tolist(),
         launches=launches, audio_seconds=summary["audio_seconds"],
         wall_seconds=summary["wall_seconds"], rtf=summary["rtf"],
         audio_seconds_per_s=summary["audio_seconds_per_s"], card=smi)

    # the main path's kernel call again, on the same inputs
    cond, _, n_samples = pad_batch_for_decode(utts, hop)
    with torch.no_grad():
        c_up = model.upsample_cond(torch.from_numpy(cond).cuda())
    noise = ar_kernel.uniform_noise(
        c_up.shape[:2], torch.Generator(device="cuda").manual_seed(seed))
    out = ar_kernel.generate(pp, mc, c_up, noise=noise)
    require(bool(torch.isfinite(out).all()), "main-path output finite")
    wav = out.cpu().numpy()
    for i, n in enumerate(n_samples):
        q = np.clip(np.round(wav[i, :n] * 32767.0), -32768, 32767)
        require(np.array_equal(q.astype("<i2"), pcm[i]),
                f"utterance {i}: wav equals the kernel's samples")
    B, T = out.shape
    ms = cuda_ms(lambda: ar_kernel.generate(pp, mc, c_up, noise=noise), 2)
    # plain version teacher-forced with the kernel's own samples: every
    # step sees the kernel's history, so only one step's rounding differs
    teacher = torch.cat([torch.zeros(B, 1, device="cuda"), out[:, :-1]], 1)
    plain, plain_ms = host_ms(lambda: ar_kernel.generate_plain(
        pp, mc, c_up, noise=noise, teacher=teacher))
    max_err = float((plain - out).abs().max())
    bound_ms, bound_by = bound(mc, B, T, pp)
    emit("main_path_vs_plain", B=B, T=T, max_abs_err=max_err,
         limit=TOL_TEACHER, kernel_ms=ms, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by)
    require(max_err <= TOL_TEACHER, "main-path kernel vs plain")

    # the segmented decode of the same batch: same noise, same samples
    ar_kernel.launches.clear()
    t0 = time.perf_counter()
    seg = decode.decode_batch(
        model, cfg, utts, segment_samples=SEGMENT,
        generator=torch.Generator(device="cuda").manual_seed(seed))
    seg_wall = time.perf_counter() - t0
    seg_launches = ar_kernel.launches["ar_generate"]
    seg_err = max(float(np.abs(w - wav[i, :n]).max())
                  for i, (w, n) in enumerate(zip(seg, n_samples)))
    emit("main_path_segmented", segment_samples=SEGMENT,
         launches=seg_launches, wall_seconds=seg_wall, max_abs_err=seg_err,
         limit=0.0)
    require(seg_launches == -(-T // SEGMENT), "segmented decode launches")
    require(seg_err == 0.0, "segmented decode equals unsegmented")
    return {"launches": launches, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def err(a, b) -> float:
    return float((a - b).abs().max())


def own_feedback(out):
    """The teacher stream that replays a free-running call: x[t-1], with
    silence (0.0) at t = 0."""
    return torch.cat([torch.zeros_like(out[:, :1]), out[:, :-1]], dim=1)


def phase_deep_kernel_vs_plain(mc, model, pp, seed: int) -> dict:
    B, T = DEEP_B, DEEP_T
    lay32 = decode.kernel_layout(mc, "float32")
    laybf = decode.kernel_layout(mc, "bfloat16")
    require(lay32["stream"] and laybf["stream"],
            f"deep layouts are streamed: {lay32}, {laybf}")
    c_up = random_cond(mc, model, B, T, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = ar_kernel.uniform_noise((B, T), g)
    teacher = torch.rand((B, T), generator=g, device="cuda") * 2 - 1
    checks = []

    def record(name, e, limit, **kw):
        checks.append({"check": name, "max_abs_err": e, "limit": limit,
                       "ok": e <= limit, **kw})

    def gen(c, n, layout, **kw):
        return ar_kernel.generate(pp, mc, c, noise=n, **layout, **kw)

    def plain(c, n, dtype="float32", **kw):
        return ar_kernel.generate_plain(pp, mc, c, noise=n, dtype=dtype,
                                        **kw)

    # fp32 streamed, teacher-forced
    k32 = gen(c_up, noise, lay32, teacher=teacher)
    p32, plain32_ms = host_ms(lambda: plain(c_up, noise, teacher=teacher))
    record("fp32_stream_teacher_forced", err(k32, p32), TOL_TEACHER)
    # fp32 streamed, free-running: each sample against the plain version
    # given the same history (see TOL_FREE above)
    for mode in ("sample", "greedy"):
        k = gen(c_up, noise, lay32, mode=mode)
        require(bool(torch.isfinite(k).all()), f"finite deep output {mode}")
        p = plain(c_up, noise, mode=mode, teacher=own_feedback(k))
        free = plain(c_up[:, :512], noise[:, :512], mode=mode)
        record(f"fp32_stream_free_{mode}", err(k, p), TOL_FREE,
               divergence_512=err(k[:, :512], free))
    # bf16 streamed, teacher-forced, against the matmul-order bf16 plain
    # version: a reading of the drift, with the fp32 plain version beside
    # it (the exact check is in phase_deep_main_path)
    kbf = gen(c_up, noise, laybf, teacher=teacher)
    pbf, plainbf_ms = host_ms(lambda: plain(c_up, noise, "bfloat16",
                                            teacher=teacher))
    readings = [{"reading": "bf16_stream_teacher_forced_matmul_order_drift",
                 "max_abs_err": err(kbf, pbf), "fp32_plain": err(kbf, p32)}]
    cf = random_cond(mc, model, FIRST_B, FIRST_T, seed + 3)
    nf = ar_kernel.uniform_noise((FIRST_B, FIRST_T), g)
    tf = torch.rand((FIRST_B, FIRST_T), generator=g, device="cuda") * 2 - 1
    kf = gen(cf, nf, laybf, teacher=tf)[:, 0]
    e0 = err(kf, plain(cf, nf, "bfloat16", teacher=tf)[:, 0])
    c0 = err(kf, plain(cf, nf, teacher=tf)[:, 0])
    checks.append({"check": "bf16_stream_first_step_64_rows",
                   "max_abs_err": e0, "limit": TOL_BF16_FIRST,
                   "control_fp32": c0,
                   "control_min": CONTROL_FACTOR * TOL_BF16_FIRST,
                   "ok": e0 <= TOL_BF16_FIRST
                   and c0 > CONTROL_FACTOR * TOL_BF16_FIRST})
    # at full width and depth, streamed at chunk 64 equal to chunk 32, which
    # also streams the d = 64 rings
    for dtype, layout in (("float32", lay32), ("bfloat16", laybf)):
        record(f"deep_{dtype}_stream64_vs_stream32",
               err(gen(c_up, noise, layout),
                   gen(c_up, noise, {**layout, "chunk": 32})), 0.0)
    # streamed equal to resident, where both fit: config-2 widths with
    # stack_size=8 (top dilation 128: the d > 64 and d > 32 splits stream)
    mc8 = get_config("shallow_laplace_single", ["model.stack_size=8"]).model
    m8 = random_model(mc8, seed + 2)
    pp8 = extract_plain_params(m8)
    c8 = random_cond(mc8, m8, B, T, seed + 2)
    for dtype in ("float32", "bfloat16"):
        res = ar_kernel.generate(pp8, mc8, c8, noise=noise, dtype=dtype)
        for chunk in (64, 32):
            st = ar_kernel.generate(pp8, mc8, c8, noise=noise, dtype=dtype,
                                    stream=True, chunk=chunk)
            record(f"stack8_{dtype}_stream{chunk}_vs_resident",
                   err(st, res), 0.0)
    # segmented against unsegmented, fp32 streamed
    cs = random_cond(mc, model, B, DEEP_SEG_T, seed + 4)
    ns = ar_kernel.uniform_noise((B, DEEP_SEG_T), g)
    seg = generate_segmented(pp, mc, cs, ns, DEEP_SEGMENT, **lay32)
    record(f"segmented_{DEEP_SEGMENT}_vs_unsegmented",
           err(seg, gen(cs, ns, lay32)), 0.0)
    # the resident layout is refused before any launch (shared memory)
    before = sum(ar_kernel.launches.values())
    try:
        ar_kernel.generate(pp, mc, c_up[:1, :64], mode="greedy")
        refused = ""
    except ValueError as e:
        refused = str(e)
    checks.append({"check": "deep_resident_refused", "error": refused,
                   "ok": "shared memory" in refused
                   and sum(ar_kernel.launches.values()) == before})
    times = {}
    for name, layout, plain_ms, wb in (
            ("fp32", lay32, plain32_ms, 4), ("bf16", laybf, plainbf_ms, 2)):
        ms = cuda_ms(lambda: gen(c_up, noise, layout), 2)
        bound_ms, bound_by = bound(mc, B, T, pp, wb)
        times[name] = {"layout": layout, "ms": ms,
                       "us_per_step": 1e3 * ms / T, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by}
    smem = {f"{dt}_{'stream' if st else 'resident'}{ch}":
            ar_kernel.smem_bytes(mc, dt, st, ch)
            for dt, st, ch in decode.KERNEL_LAYOUTS}
    emit("deep_kernel_vs_plain", B=B, T=T, checks=checks, readings=readings,
         times=times, smem_bytes=smem, smem_limit=ar_kernel.smem_limit("cuda"))
    for c in checks:
        require(c["ok"], f"deep kernel vs plain: {c}")
    return times


def phase_deep_main_path(cfg, model, pp, seed: int, smi: str,
                         kernel_dtype: str) -> dict:
    mc, hop = cfg.model, cfg.data.hop_length
    rng = np.random.default_rng(seed + 8)
    frames = np.linspace(40, 80, 8).round().astype(int)
    utts = [Utterance(np.zeros(0, np.float32), rng.standard_normal(
        (f, mc.aux_channels)).astype(np.float32)) for f in frames]
    names = [f"utt{i}.wav" for i in range(len(utts))]
    with tempfile.TemporaryDirectory() as tmp:
        ar_kernel.launches.clear()
        summary = decode.decode_utterances(
            model, cfg, utts, names, tmp,
            torch.Generator(device="cuda").manual_seed(seed), batch_size=8,
            kernel_dtype=kernel_dtype)
        launched = dict(ar_kernel.launches)
        layout = summary["kernel"]
        name = ar_kernel.variant(layout["dtype"], layout["stream"])
        require(layout == decode.kernel_layout(mc, kernel_dtype)
                and layout["dtype"] == kernel_dtype and layout["stream"],
                f"deep layout {layout}")
        require(launched.get(name, 0) >= 1 and set(launched) == {name},
                f"the deep main path launched {name}: {launched}")
        pcm = []
        for n, f in zip(names, frames):
            with wave.open(str(Path(tmp) / n)) as w:
                require(w.getnframes() == f * hop, f"{n} length")
                pcm.append(np.frombuffer(w.readframes(w.getnframes()), "<i2"))
    emit("deep_main_path", kernel_dtype=kernel_dtype, kernel=layout,
         variant=name, utterances=len(utts), frames=frames.tolist(),
         launches=launched[name], audio_seconds=summary["audio_seconds"],
         wall_seconds=summary["wall_seconds"], rtf=summary["rtf"],
         audio_seconds_per_s=summary["audio_seconds_per_s"], card=smi)

    # the main path's kernel call again, on the same inputs
    cond, _, n_samples = pad_batch_for_decode(utts, hop)
    with torch.no_grad():
        c_up = model.upsample_cond(torch.from_numpy(cond).cuda())
    noise = ar_kernel.uniform_noise(
        c_up.shape[:2], torch.Generator(device="cuda").manual_seed(seed))
    out, full_ms = host_ms(lambda: ar_kernel.generate(
        pp, mc, c_up, noise=noise, **layout))
    require(bool(torch.isfinite(out).all()), "deep main-path output finite")
    wav = out.cpu().numpy()
    for i, n in enumerate(n_samples):
        q = np.clip(np.round(wav[i, :n] * 32767.0), -32768, 32767)
        require(np.array_equal(q.astype("<i2"), pcm[i]),
                f"deep utterance {i}: wav equals the kernel's samples")
    # the plain version teacher-forced with the kernel's own samples: fp32
    # over DEEP_PLAIN_T steps; bf16 in the kernel's summation order over
    # twice the largest streamed dilation (see TOL_CHAIN above)
    bf16 = layout["dtype"] == "bfloat16"
    strm = ar_kernel.stream_split(mc.dilations, layout["chunk"], True)[1]
    B = c_up.shape[0]
    Tp = 2 * max(mc.dilations[l] for l in strm) if bf16 else DEEP_PLAIN_T
    cp, npl = c_up[:, :Tp].contiguous(), noise[:, :Tp].contiguous()
    teacher = own_feedback(out)[:, :Tp]
    ms = cuda_ms(lambda: ar_kernel.generate(pp, mc, cp, noise=npl,
                                            **layout), 2)
    plain, plain_ms = host_ms(lambda: ar_kernel.generate_plain(
        pp, mc, cp, noise=npl, teacher=teacher, dtype=layout["dtype"],
        chain=bf16))
    max_err = err(plain, out[:, :Tp])
    extra = {}
    if bf16:
        limit = TOL_CHAIN
        d = (plain - out[:, :Tp]).abs().amax(0)
        parted = torch.nonzero(d > limit)
        control = err(ar_kernel.generate_plain(
            pp, mc, cp, noise=npl, teacher=teacher), out[:, :Tp])
        matmul = ar_kernel.generate_plain(pp, mc, cp, noise=npl,
                                          teacher=teacher, dtype="bfloat16")
        extra = {"first_parted_step": int(parted[0]) if len(parted) else None,
                 "control_fp32": control, "control_min": CONTROL_MIN,
                 "matmul_order_drift": err(matmul, out[:, :Tp]),
                 "matmul_order_vs_chain": err(matmul, plain)}
    else:
        limit = TOL_TEACHER
    bound_ms, bound_by = bound(mc, B, Tp, pp, 2 if bf16 else 4)
    emit("deep_main_path_vs_plain", variant=name, B=B, T=Tp,
         full_T=out.shape[1], full_call_ms=full_ms, max_abs_err=max_err,
         limit=limit, chain=bf16, **extra, kernel_ms=ms,
         us_per_step=1e3 * ms / Tp, plain_ms=plain_ms, bound_ms=bound_ms,
         bound_by=bound_by)
    require(max_err <= limit, f"deep main-path kernel vs plain ({name})")
    require(not bf16 or extra["control_fp32"] > CONTROL_MIN,
            f"deep main-path fp32 control misses the bf16 kernel ({name})")
    return {"name": name, "launches": launched[name], "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = smi_line()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    emit("toolchain", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], nvcc=nvcc[-1])
    t0 = time.perf_counter()
    libs = _build.build()
    emit("build", seconds=time.perf_counter() - t0,
         libs=sorted(str(v.relative_to(Path(__file__).resolve().parent))
                     for v in libs.values()))

    cfg = get_config("shallow_laplace_single")
    model = random_model(cfg.model, args.seed)
    pp = extract_plain_params(model)
    emit("weights", config=cfg.name, seed=args.seed,
         params=sum(v.numel() for v in model.parameters()),
         compute_dtype=cfg.model.compute_dtype)

    check = phase_kernel_vs_plain(cfg.model, model, pp, args.seed)
    main_path = phase_main_path(cfg, model, pp, args.seed, smi)

    dcfg = get_config("deep_baseline")
    dmodel = random_model(dcfg.model, args.seed)
    dpp = extract_plain_params(dmodel)
    emit("deep_weights", config=dcfg.name, seed=args.seed,
         params=sum(v.numel() for v in dmodel.parameters()),
         compute_dtype=dcfg.model.compute_dtype)
    deep_check = phase_deep_kernel_vs_plain(dcfg.model, dmodel, dpp,
                                            args.seed)
    deep = [phase_deep_main_path(dcfg, dmodel, dpp, args.seed, smi, dt)
            for dt in ("float32", "bfloat16")]

    source = "shallow_wavenet_tpu_torch/csrc/ar_generate.cu"
    kernels = [{
        "name": "ar_generate", "route": "cuda", "source": source,
        "replaces": "shallow_wavenet_tpu/ops/ar_kernel.py:560",
        "launches": main_path["launches"],
        "max_abs_err": main_path["max_abs_err"],
        "ms": main_path["ms"], "plain_ms": main_path["plain_ms"],
        "bound_ms": main_path["bound_ms"],
        "bound_by": main_path["bound_by"], "library_ms": None,
        "check_ms": check["kernel_ms"], "check_plain_ms": check["plain_ms"],
    }]
    for d, replaces, key in zip(deep, (":297", ":616"), ("fp32", "bf16")):
        kernels.append({
            "name": d["name"], "route": "cuda", "source": source,
            "replaces": "shallow_wavenet_tpu/ops/ar_kernel.py" + replaces,
            "launches": d["launches"], "max_abs_err": d["max_abs_err"],
            "ms": d["ms"], "plain_ms": d["plain_ms"],
            "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
            "library_ms": None, "check_ms": deep_check[key]["ms"],
            "check_plain_ms": deep_check[key]["plain_ms"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
