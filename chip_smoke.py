#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (shallow_wavenet_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line; any failure exits nonzero:
  1. toolchain: the card (nvidia-smi name and power limit), torch, CUDA and
     nvcc versions; then every kernel in shallow_wavenet_tpu_torch/csrc is
     built (one nvcc per source, all started together; the registers of
     every instantiation are read from ptxas's report in the build logs):
     `build` waits for the two AR kernels (ar_generate, ar_cluster), and
     the probes' builds go on beside phases 2-11 (`probe_build` waits for
     them before phase 12);
  2. weights: config 2 (shallow_laplace_single) at full width, random
     flax-layout weights from --seed with a random head2 (zero in the flax
     init), loaded through params_from_flax;
  2a. plain_graph: every check below holds a kernel against its plain
     version, `ar_kernel.generate_plain`, which dispatches its torch ops
     from Python once per sample. Here it runs with `graph=True`: one step
     captured in a CUDA graph and replayed per sample, which takes the
     host's dispatch off the run's time. Held to the bit against the eager
     loop over PLAIN_GRAPH_T steps at config 2, B = 4: Laplace
     teacher-forced, free running (sample, greedy) and with a warm-up
     prefix, softmax teacher-forced, the fused window, and bf16 in the
     cluster kernel's order (chain=True, split=8), unfused and fused; each
     call's host ms beside the eager one's;
  3. kernel against plain: the one-SM-per-row AR kernel (ar_generate, the
     fallback layout) and its plain PyTorch version on the same
     conditioning and uniforms, B=4, T=4096 — Laplace teacher-forced,
     Laplace free-running (sample and greedy), softmax teacher-forced at
     config-2 widths, and segmented against unsegmented — each error
     beside its limit, and both versions' times; the kernel's time per
     call at B = 1..128 (T = 2048); then the same checks of the cluster
     kernel (ar_cluster) at the size the decode picks;
  4. main path: bin.decode.decode_utterances on 8 utterances of 75-150
     random normalized frames (1-2 s) writes wavs and decode_summary.json,
     on the layout the decode picks (the cluster kernel); the kernel
     launch counter, reset just before, must have risen. The kernel is
     then re-run on the main path's inputs (same samples, which are
     checked against the wavs) and held against the plain version,
     teacher-forced with its own samples, over the whole call. Last,
     bin.decode.decode_batch with segment_samples=2048 (its launch count
     read the same way) must give the same samples;
  5. deep kernel against plain: deep_baseline at full width and depth
     (30 layers, R=128, G=256, S=256), random weights, B=4, T=2048, on the
     fallback layouts (ar_generate, fp32 and bf16, streamed rings) — fp32
     teacher-forced; fp32 free-running, sample and greedy, each sample
     held against the plain version teacher-forced with the kernel's own
     samples; bf16 on the first step of 64 rows against the bf16 plain
     version, with the fp32 plain version as the control, and the drift
     of the matmul-order bf16 plain version over 4096 steps (a reading);
     streamed at chunk 64 equal to streamed at chunk 32 (fp32 and bf16),
     and streamed equal to resident at config-2 widths with stack_size=8;
     segmented (8192) equal to unsegmented; the resident deep layout
     refused before launch; both variants' times; every layout's shared
     memory, unfused and fused; then ar_generate's fused fallback layouts
     (fused=4, streamed, fp32 and bf16) at B=4, T=2048: fp32
     teacher-forced over the first 1024 steps against the plain version,
     bf16 fed its own samples over the first 1024 to the bit against
     `chain=True` with the fp32 control, and their times;
  6. deep main path: decode_utterances at deep_baseline with
     --kernel-dtype float32 and then bfloat16, on 8 utterances of 40-80
     random normalized frames (0.5-1.1 s), on the cluster kernel: launches
     of the chosen variant, wavs equal to a re-run of the kernel, the
     layout, wall seconds, RTF, and the plain version teacher-forced with
     the kernel's own samples: fp32 over the first 4096 steps; bf16 over
     the first 1024 in the kernel's summation order (`chain=True,
     split=N`), exactly, with the fp32 control and the matmul-order
     version's drift beside it;
  7. fused kernel against plain: the fused window (fused=4) at config 2,
     B=4, T=4096, on both kernels against one set of plain outputs:
     ar_generate (the fallback layout) and the cluster kernel at the size
     the decode picks for fused=4 — Laplace teacher-forced, free-running
     sample and greedy (each sample against the plain version
     teacher-forced with the kernel's own samples), softmax teacher-forced
     ids, fused against the same kernel unfused, segmented (2048) equal to
     unsegmented, and W = 2, 3, 5 teacher-forced over the first 1024 steps
     (each W on its own cluster size); ar_generate's streamed equal to
     resident at config-2 widths with stack_size=8 (and their times);
  8. fused main path: phase 4 with decode_utterances(..., fused=4), on the
     layout the decode picks (the cluster kernel): launches of
     ar_cluster[fused4,...], wavs equal to a re-run, wall seconds and RTF
     beside the unfused main path's, the plain version teacher-forced with
     the kernel's samples over the first 4096 steps, and the segmented
     decode;
  9. deep fused: the deep main path with fused=4, fp32 and bf16, on the
     layouts choose_layout(..., fused=4) picks (the cluster kernel): fp32
     held at 1e-5 over the first 1024 steps, bf16 to the bit against
     `chain=True, split=N` over twice the largest dilation, with the fp32
     control; then the decode's unfused and fused layouts timed in turns
     at B=8 (unfused, fused, fused, unfused);
  10. streaming: models.streaming.StreamingSynthesizer at config 2, B=1,
     80 ms blocks (6 frames), 150 frames pushed 6 at a time, fused=4 and
     unfused (both on the cluster kernel, as the decode picks it): push
     latency
     (mean, p95) and steady-state RTF; the streamed
     samples equal one call over the session's conditioning and uniforms
     (0.0), and that conditioning against the whole utterance's
     upsampling, at the bf16 upsampler's limit; the kernel against the
     plain version at B = 1: the one call teacher-forced with its own
     samples over its first 2048 steps, and the second block's warm-started push
     call (kernel and plain on the same arguments; the kernel's output
     equal to the stream's);
  10a. train: config 2 training (training.Trainer) at full width, bf16
     compute as configured, TF32 off: a corpus of 8 synthetic utterances
     of 2 s (`synth_utterance`, seeds from --seed) with 80-bin log-mel
     features at config 2's STFT settings, computed on the card and
     normalized by the corpus's mean and std; SegmentSampler at config 2's
     data config (B = 8, segment 8,000, x (8, 8,320)). The card's first
     step against the same code on the CPU, one random flax-layout tree,
     one batch of 2 rows: loss and every gradient leaf (relative to the
     leaf's largest entry), bf16 at TOL_TRAIN_BF16 and the fp32-compute
     control at TOL_TRAIN_FP32. Trainer.fit for 64 updates at
     steps_per_call = 8 from the port's init (checkpoints at 32 and 64,
     eval loss at 0, 32, 64 on two held-out batches, both losses must
     fall); ms per update by CUDA events around multi_step over 4 groups
     after a warm-up group, and over 8 single steps (K = 1), samples/s
     (B x 8,320 per update), peak memory, kernels per update and their
     device time over one group (torch.profiler), the bound from the
     code's FLOPs (`yardstick.train_flops`) at the fp32 and the dense bf16
     peaks;
     resume from the step-32 checkpoint in a workdir of its own: the next
     group draws the straight run's batches 33..40 and ends on its
     step-40 loss, to the bit; then the trained weights, restored by
     bin.decode.load_model_state (`--workdir`'s loader), decode 2 corpus
     utterances through decode_utterances on the layout the decode picks
     (the cluster kernel, its launches counted), with the RTF, and the
     kernel re-run on the same inputs is held against the plain version
     teacher-forced with its own samples over its first 1,024 steps at
     TOL_TEACHER. No kernel of this repo lies on the training path (the
     JAX step has no Pallas call): the kernels line gains no row;
  10a'. observe: utils/observability.py at config 2. decode
     --profile (bin.decode.decode_utterances(profile=True)) of 2 of the
     main path's utterances on the cluster kernel, with the profiler off
     and on in turns (off, on, on, off; wall seconds and RTF of each, the
     wavs equal): each trace parses, and holds at least one CUDA kernel
     event whose name holds `ar_cluster_kernel` per decode batch (the
     kernel is launched through ctypes from the port's own library; the
     line prints the events by name and category); bin.train --profile
     --debug-nans on the train phase's corpus (written as wavs and .h5)
     for 16 updates at steps_per_call = 8, its metrics.jsonl equal to
     the same run without the flags to the bit, its trace written (its
     bytes); ms per update with debug mode off and on in turns of single
     updates; a NaN in one batch's x raising FloatingPointError at its
     update under debug mode, for K = 1 and K = 8 (debug mode turned off
     after); whether TensorBoard scalars are written on this host
     (tensorboardX importable: `metrics_writer_live`);
  10b. recipe: config 3 (shallow_laplace_ns: config 2's model with MLSA
     noise shaping) at full width and depth through the port's recipe
     runner, bin.run, on the card: stages 0-6, each its own call and wall
     time, 8 training and 2 eval utterances of 1 s (24 kHz), 16 training
     steps (two calls of steps_per_call = 8). Stage 1 (feature
     extraction, the torch log-mel on the card): every .h5 listed, the
     features against the pooled numpy path (RECIPE_WORKERS spawned CPU
     workers) at TOL_MEL_POOL, audio-s per wall-s; stage 2 (statistics):
     mean and std against a float64 numpy recomputation, avg_mcep on the
     card against the native analysis (`mcep_native`) at
     TOL_MCEP_NATIVE; stage 3 (noise shaping): the native C++ filter ran
     (the CLI's log), it against the plain recursion (`ops.mlsa`) on the
     card on a RECIPE_EXCERPT-sample excerpt, forward and inverse, at
     TOL_MLSA, and de-emphasis of a shaped training wav restoring it below
     the 16-bit floor; stage 4 (training): finite losses, the record and
     checkpoint of step 16; stage 5 (decode): the cluster kernel's
     launches counted (the config-2 row's `recipe_launches`), the wavs
     equal to a re-run of the kernel on the decode's inputs and that
     re-run against the plain version teacher-forced with its own samples
     over its first 1,024 steps at TOL_TEACHER, the RTF; stage 6
     (de-emphasis and evaluation): finite MCD, F0 RMSE, V/UV error and LSD
     in mcd.json, and eval_pair on the card against the CPU for one pair.
     Then the world branch at deep_baseline (world features with the
     energy channel, feature_dim 32), stages 0-2: the features on the
     card against the native pooled path on frames whose voicing agrees,
     at TOL_WORLD, with the share of frames that agree. Its pitch checks
     (`world_pitch`): bin.decode --f0-factor 1.3 of one eval
     utterance cut to 0.5 s with random weights, on the decode's layout
     (ar_cluster[N16,l2]), its launches counted (the deep fp32 row's
     `recipe_pitch_launches`), its conditioning's voiced lf0 moved by
     ln 1.3 within TOL_LF0 and its unvoiced frames and other columns
     left alone, its wavs those of a decode of the features shift_f0
     moved, and the generated wav's per-frame pitch ratio printed (random
     weights: not held); the transposed oracle of bin.pitch_eval on
     the envelope-smoothed features of each eval utterance's first
     PITCH_ORACLE_S at factors 0.7 and 1.3, with pulse-only voiced
     excitation, its per-frame ratio within TOL_PITCH of the factor, and
     the tool's noise-mixed oracle read beside it on the first
     utterance at 1.3 (not held: its reading depends on the noise
     draw); bin.as_oracle on each eval utterance cut likewise, card
     against CPU on one noise draw at TOL_EVAL_DB. The .h5 files go
     through h5py where it is installed, else the port's own HDF5 codec
     (the line says which);
  10c. train_dp: data parallelism on the one card: an NCCL process group
     of one rank, joined through the launcher's variables as torchrun
     sets them (parallel.init_distributed) and left after; the DP trainer
     (each update all-reduced through NCCL) and the plain trainer from
     one init, Trainer.fit over 8 updates each: parameters, Adam's
     moments and records equal to the bit; ms per update of both (the
     median of 3 rounds of turns: plain, DP, DP, plain) and the
     all-reduce alone, on the device's clock and the host's. Scaling
     over cards is not measured (one card);
  10d. decode_dp: decode --dp's path, bin.decode.decode_batch with the
     rows split by models.generate.generate_dp, on the main path's 8
     utterances, over every visible card and over two shards on cuda:0:
     equal to the single call to the bit, with wall times and launches;
  10e. stream_pool: models.streaming.StreamPool at config 2, fp32
     unfused on the decode's layout (the cluster kernel), 80 ms blocks,
     at 1 and 8 streams, at the card's clusters for the layout
     (clusters_at_once) and at one more (two waves, warned once):
     per steady step wall ms (mean, p95), the launches' CUDA-event ms,
     the rest and its host split by call, launches, upsampler calls
     per step and windows per call, and the streams' audio-s per wall-s;
     the first, a middle and the last
     stream equal to standalone sessions to the bit; then a staggered
     open/end scenario over 3 slots, every stream equal to its session,
     at most two launches per step. The cluster kernel's row counts the
     pool's launches;
  11. kfuse sweep: bin.kfuse at config 2, B = 1, 8, 32, T = 2048,
     W = 0, 2, 3, 4, 6 (us per step), on the kernel the decode picks for
     each W (--kernel cluster) and on ar_generate;
  12. kprobe: the AR step's ablation probe (ops.ar_probe) at config 2 on
     the TPU probe's recipe of weights, fp32 and bf16: no_resskip refused
     before launch (S > G/2); the bin.kprobe sweep (B = 1, 8, 32, T = 2048,
     us per step and saving per ablation, launches by variant), and every
     call it timed checked on its own inputs over all its steps: full
     equal to ar_generate and unroll2, unroll4, split2 (and gate_bf16 in
     fp32) equal to full, exactly; every fp32 ablation against its plain
     version fed the kernel's own samples, every bf16 one to the bit
     against the plain version that sums in the kernel's order, with the
     fp32 control; full and ar_generate timed in turns at B = 8;
  13. dma_probe: the ring-window copy probe (ops.ring_probe), its four
     variants (tma and cp_async, one block per row with every step
     serial; the redesign's tma_pipe and cp_async_pipe, each row's window
     split over blocks and pipelined through shared-memory stages) through
     bin.dma_probe.sweep: each exactly equal to the plain version and the
     closed form at the five SHAPES (the TPU probe's, 132 rows over 64
     chunks, each batch at the other chunk count, and B = 8 over 64 chunks
     with per = 64, where no chunk reloads a slot: no chain) and the two
     ORDER_SHAPES (per = 1 over 5 chunks; per = 3 over 7 chunks of a
     chunk the split leaves ragged); then each timed at the launch alone
     (ring.zero_() plus one launch, CUDA events over 20 reps after a
     warm-up) in turns at every SHAPE (tma, cp_async, tma_pipe,
     cp_async_pipe, then the reverse), with the wrapper-call time
     beside it, the bound (the output and the zeroed ring over 3.35
     TB/s), PyTorch's fills of the same bytes (`fill_ms`), the L2-side
     rate, the plain version's time at the rate shape,
     launches by variant and the registers from the build's log;
  14. cluster: the cluster kernel at config 2 and deep_baseline, fp32 and
     bf16: cudaOccupancyMaxActiveClusters for N = 2, 4, 8, 16 (weights
     resident and streamed, where a block fits), the N chosen, a block's
     shared memory and the registers from the build's log; us per step
     (T = 2048, CUDA events, in turns: each variant in order, then in the
     reverse order) of ar_generate and of every N and weight placement
     that fits at B = 1 and 8, and of ar_generate and the N chosen at B =
     16 and 32 (in waves past the card's clusters); one N's two
     placements equal to the bit; the same row decoded at B = 1 and
     inside B = 8, 16 and 32 equal to the bit; at B = 1 over the first
     1024 steps, the N chosen and, where its weights stream from L2, the
     smallest N whose weights fit in shared memory (every template
     instance of the kernel is held): fp32 free running held one step at
     a time at TOL_FREE against the plain version fed the kernel's
     samples, and bf16 to the bit against `chain=True, split=N`, where
     the fp32 control misses by more than CONTROL_MIN. Then the same for
     the fused window (fused=4): us per step in turns of ar_generate's
     fused layout, every N and weight placement of the fused cluster
     kernel that fits at B = 1, and ar_generate's and the chosen N's at
     B = 8 (beside the unfused rows); the same row equal at B = 1, 8 and
     16; each fused template instance held at B = 1 as above (bf16 against
     `chain=True, split=N, fused=4`). Last, per-row lengths: fp32 (and
     at config 2 bf16, on its shared-memory layout), unfused and
     fused=4, on the layout the decode picks, B = 8 rows of
     LENGTHS_FRAMES x hop steps (port_bench's offline_b8 mix), the
     launch with `lengths` (rows stopped at their lengths, longest
     started first) against the padded launch: each row equal to the bit
     within its length and 0 past it; the call's ms in both forms in
     turns (padded, lengths, lengths, padded); and at config 2 fp32 a
     call of MANY_ROWS = CLUSTER_MAX_ROWS + 1 rows of random lengths
     (two launches of one call), each row equal to the bit to the same
     row in one of two single-launch padded calls of half the rows and 0
     past its length, counted as two launches;
  15. cluster_probe: the ablation probe on the cluster kernel (the probe
     instances of csrc/ar_cluster.cu, library ar_cluster_probe) at config
     2 on the probe's recipe of weights, at the decode's N and weight
     placement (fp32 N = 8 from L2, bf16 N = 8 in shared memory): split2
     and no_resskip refused before launch; the bin.kprobe --kernel
     cluster sweep (every other ablation at B = 1 and 8, T = 2048, launches
     by variant), each timed call checked on its own inputs: full equal
     to the production ar_cluster launch and unroll2, unroll4 (and
     gate_bf16 in fp32) equal to full, to the bit; every fp32 ablation
     within TOL_TEACHER of its plain version (`split=N`) fed the kernel's
     own samples, every bf16 one 0.0 against `chain=True, split=N`, the
     fp32 control above KPROBE_CONTROL_MIN (local_exchange's at N = 2,
     where each rank runs half the model; at N = 8 its output is rank 0's
     eighth, and the control is printed); full and the production kernel
     timed in turns at B = 8. Then the per-stage timer (its instance
     runs row k on cluster k for T steps, `ar_probe.TIMED_FORM`) at the
     decode's layouts, config 2 (T = 2048) and deep_baseline (T = 1024),
     fp32 and bf16, unfused and fused 4, B = 8, on the main paths' random
     weights: the timed samples equal to the production launch's, the
     timed/untimed step ratio in turns (untimed, timed, timed, untimed;
     both launched on the same prepared arguments) at most
     TIMER_RATIO_MAX (config 2 fp32 unfused: TIMER_RATIO_MAX_C2_FP32),
     and the stage table (us per step and share of each stage kind).
Every phase line carries `t`, the script's seconds so far. Then the
`plain_seconds` line (the plain versions' host seconds by kind, and where
they ran), the card's nvidia-smi line, the kernels' JSON line and, last,
{"ok": true, "device": {...}}. Without CUDA, or outside the repo, it exits
nonzero before printing any result.

  16. sd_wide (after the cluster phase): the speaker-dependent vocoder
     (port_bench's tamamori_sd_arctic: 30 layers, R 512, G 1024, S 256,
     C 32, 256-class softmax) on the layout the decode picks ("auto": the
     cluster kernel's wide form, `ar_cluster[N16,wide]`, fp32), B = SD_B,
     T = SD_T (past the receptive field, so every global ring is written
     and read): the class ids teacher-forced, and free running (sample and
     greedy), each step's class judged under port_bench's plain reference
     (fp32, TF32 off) fed the same class inputs: sampling, the CDF gap at
     the step's uniform (`reference.cdf_gaps`'s), greedy, the probability
     gap to the argmax, at most SD_GAP for the kernel and for the plain
     version (`split=16, chain=True`; the kernel sums each dot with fp32
     FMAs and the plain version rounds each product first, so the two can
     draw different classes where a uniform falls within that rounding of
     a CDF edge: flips counted), and the TF32 control's classes above
     SD_GAP (the judge can fail). To the bit, the wide form against the
     streamed form (`ar_cluster[N16,l2]`, the same operations in the same
     order) at deep_baseline's widths, which both take, free running with
     per-row lengths (global rings for dilations 128-512 there); the
     rings' bytes by place (`ar_kernel.ring_bytes`); the plain version's
     time for the teacher-forced call, and the wide form's time at B = 2,
     7 (one wave of 7 clusters) and 8 (two waves) beside its bound
     (`yardstick.ar_bound_ms`: the weights beyond the chip read every
     step). Its row in the kernels line carries the widest gap
     (`max_gap`). `--only sd_wide` runs phases 1 and 16 alone.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import logging
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np
import torch

from port_bench import reference, yardstick
from shallow_wavenet_tpu_torch.bin import (
    as_oracle, decode, dma_probe, feature_extract, kfuse, kprobe, mcd_eval,
    pitch_eval,
)
from shallow_wavenet_tpu_torch.bin import noise_shaping as shaping
from shallow_wavenet_tpu_torch.bin import run as recipe
from shallow_wavenet_tpu_torch.bin import train as train_cli
from shallow_wavenet_tpu_torch.bin.common import load_stats, load_utterances
from shallow_wavenet_tpu_torch.config import Config, get_config
from shallow_wavenet_tpu_torch.data import hdf5_io
from shallow_wavenet_tpu_torch.data.audio_io import read_wav, write_wav
from shallow_wavenet_tpu_torch.data.dataset import (
    SegmentSampler, Utterance, pad_batch_for_decode, read_file_list,
)
from shallow_wavenet_tpu_torch.data.prefetch import GroupSampler
from shallow_wavenet_tpu_torch.data.synthetic import synth_utterance
from shallow_wavenet_tpu_torch.models import streaming
from shallow_wavenet_tpu_torch.models.generate import (
    generate_dp, generate_segmented,
)
from shallow_wavenet_tpu_torch.models.streaming import (
    StreamingSynthesizer, StreamPool,
)
from shallow_wavenet_tpu_torch.models.wavenet import (
    WaveNet, _flatten, extract_plain_params, init_params_tree,
    params_from_flax, save_params_npz,
)
from shallow_wavenet_tpu_torch.ops import (
    _build, ar_kernel, ar_probe, mlsa, ring_probe,
)
from shallow_wavenet_tpu_torch.ops.mulaw import mulaw_quantize
from shallow_wavenet_tpu_torch.ops.stft import log_mel_spectrogram
from shallow_wavenet_tpu_torch.parallel import mesh
from shallow_wavenet_tpu_torch.training import Trainer
from shallow_wavenet_tpu_torch.utils import native
from shallow_wavenet_tpu_torch.utils.observability import (
    MetricsWriter, disable_debug_mode, enable_debug_mode,
)

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit)
TOL_TEACHER = 1e-5               # Laplace teacher-forced, kernel vs plain
# Laplace free-running, kernel vs plain: the two sum in other orders, so
# they differ by fp32 rounding (~1e-6) at every step; this random-weight
# config-2 model does not amplify that under its own feedback (the largest
# error per 512-step window stays flat over 4096 steps on an H100), so
# free running is held to the teacher-forced limit.
TOL_FREE = 1e-5
T_CHECK, B_CHECK = 4096, 4
# the prefix over which the plain version's graph replay is held against
# its eager loop
PLAIN_GRAPH_T = 512
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
DEEP_B, DEEP_T = 4, 2048
FIRST_B, FIRST_T = 64, 16
DEEP_SEG_T, DEEP_SEGMENT = 12288, 8192
# the fused config-2 and the unfused deep fp32 main paths hold the plain
# version over their first PLAIN_T steps
PLAIN_T = 4096
# the fused window: W on the main paths, the other windows checked
# teacher-forced over FUSED_W_T steps
FUSED = 4
FUSED_WINDOWS, FUSED_W_T = (2, 3, 5), 1024
# streaming: 80 ms blocks at hop 320, about 2 s of frames in 6-frame pushes.
# The session's conditioning is its haloed windows' upsampling; config 2's
# upsampler computes in bf16, and a GEMM over a window may sum in another
# order than over the whole utterance, so a value can land one bf16 ulp
# (2^-8 relative) away, and the stages after carry it on: held at
# TOL_UPSAMPLE times the largest |c_up|.
STREAM_BLOCK, STREAM_FRAMES = 6, 150
TOL_UPSAMPLE = 2.0 ** -6
KFUSE_B, KFUSE_T = (1, 8, 32), 2048
# the ablation probe at config 2 (its recipe of weights, std 0.05): the
# sweep runs every ablation at KPROBE_B rows over KPROBE_T steps, and the
# first call of each (B, ablation) is checked on its own inputs: full
# against ar_generate and the schedules against full, exactly; every fp32
# ablation against its plain version fed the kernel's own samples, at
# TOL_TEACHER; every bf16 ablation against the plain version that sums in
# the kernel's order (`chain=True`), to the bit (TOL_CHAIN), over every
# step (past twice the largest dilation, 512, so every ring is written and
# read), where the fp32 plain version, the control, must miss by more than
# KPROBE_CONTROL_MIN (its smallest miss on one first step of the CPU
# tests' config: 5.4e-4).
KPROBE_B, KPROBE_T = (1, 8, 32), 2048
KPROBE_CONTROL_MIN = 1e-4
# the ablation probe on the cluster kernel: the sweep at CPROBE_B rows over
# CPROBE_T steps, checked as the kprobe phase checks its own; the timer at
# TIMER_B rows over TIMER_T steps (config 2) and TIMER_DEEP_T
# (deep_baseline), the timed instance at most TIMER_RATIO_MAX times the
# untimed one's step, and its plain version timed over its first
# TIMER_PLAIN_T steps
CPROBE_B, CPROBE_T = (1, 8), 2048
TIMER_B, TIMER_T, TIMER_DEEP_T, TIMER_PLAIN_T = 8, 2048, 1024, 128
TIMER_RATIO_MAX = 1.05
# ... except config 2 fp32 unfused (N = 8, weights from L2), held at
# TIMER_RATIO_MAX_C2_FP32: any change to the kernel's code, even a timed
# instance with no clock read in its loop, makes ptxas schedule the whole
# kernel anew, and there every form of the timer tried on an H100 came
# out slower than TIMER_RATIO_MAX allows, while a copy of the production
# instance built the same way times as the production one (PERF.md §6)
TIMER_RATIO_MAX_C2_FP32 = 1.08
# the cluster phase: every cluster size and weight placement that fits is
# timed at CLUSTER_SIZES_B rows, the size the decode picks and ar_generate
# at every CLUSTER_B, over CLUSTER_T steps; the checks against the plain
# version run at B = 1 over CLUSTER_CHECK_T steps
CLUSTER_B, CLUSTER_SIZES_B = (1, 8, 16, 32), (1, 8)
CLUSTER_T, CLUSTER_CHECK_T = 2048, 1024
CLUSTER_N = (2, 4, 8, 16)
# the cluster phase's per-row lengths: port_bench's offline_b8 frames;
# a call of MANY_ROWS rows of MANY_ROWS_T steps at most takes two launches
LENGTHS_FRAMES = (75, 86, 96, 107, 118, 129, 139, 150)
MANY_ROWS, MANY_ROWS_T = ar_kernel.CLUSTER_MAX_ROWS + 1, 256
# the wide form (phase sd_wide): rows and steps of its checks (T past the
# receptive field, 3,070 samples), the widest gap its classes may read
# under the plain reference's fp32 softmax (fp32 rounding of the CDF at a
# bin edge is about 1e-7 for 256 classes, a wrong class reads on the scale
# of its probability; port_bench's sd_offline_b8 limit), the rows and
# lengths of the to-the-bit check at deep_baseline, and the timed batches
SD_B, SD_T = 2, 4096
SD_GAP = 1e-5
SD_DEEP_LENGTHS = (4096, 3500, 3100, 2048, 1500, 1024, 700, 300)
SD_TIME_B = (2, 7, 8)
SD_CONFIG = Path(__file__).resolve().parent / "port_bench" / "configs" / \
    "tamamori_sd_arctic.json"
# training at config 2 (its data config: B = 8, segment 8,000 samples, 320
# of left context): a corpus of TRAIN_UTTS synthetic utterances of
# TRAIN_SECONDS s; the card's first step held against the same code on the
# CPU at TRAIN_CHECK_B rows (loss and every gradient leaf, relative to the
# leaf's largest entry). fp32 compute: the two sum in other orders, fp32
# rounding only (TOL_TRAIN_FP32). bf16 compute (config 2's): both round to
# bf16 at the same points, but a sum that lands on the other side of a
# bf16 rounding edge moves that value one bf16 ulp (2^-8), and the backward
# carries it on: the CPU tests measure 9.3e-3 between the port and JAX on
# the CPU for the same reason, so the card is held at TOL_TRAIN_BF16 (the
# loss, summed in fp32 after the fp32 head, at TOL_TRAIN_BF16_LOSS). Then
# TRAIN_STEPS updates through Trainer.fit at steps_per_call = 8 (config
# 2's preset), a checkpoint at TRAIN_RESUME_AT to resume from, the time per
# update over TRAIN_TIME_GROUPS groups of 8 (after one warm-up group) and
# over TRAIN_K1_STEPS single steps, and a decode of TRAIN_DECODE_UTTS
# corpus utterances with the trained weights, held against the plain
# version over its first TRAIN_DECODE_T steps
TRAIN_UTTS, TRAIN_SECONDS, TRAIN_CHECK_B = 8, 2.0, 2
TOL_TRAIN_FP32, TOL_TRAIN_BF16, TOL_TRAIN_BF16_LOSS = 1e-4, 2e-2, 1e-3
TRAIN_STEPS, TRAIN_RESUME_AT, TRAIN_TIME_GROUPS, TRAIN_K1_STEPS = 64, 32, 4, 8
TRAIN_DECODE_UTTS, TRAIN_DECODE_T = 2, 1024
# recipe (config 3 through bin.run, stages 0-6; the world branch at
# deep_baseline, stages 0-2)
RECIPE_ARGS = ("--n-train", "8", "--n-eval", "2", "--steps", "16")
RECIPE_STEPS, RECIPE_WORKERS, RECIPE_EXCERPT = 16, 4, 2400
# log10 mel, card against the pooled numpy path: cuFFT and numpy's FFT
# round apart by ~1e-7 of a frame's peak, and a mel band 60-70 dB below
# the peak turns that into ~1e-4 relative, 4e-5 in log10; bands at the
# 1e-10 floor agree exactly
TOL_MEL_POOL = 1e-3
TOL_MCEP_NATIVE = 1e-4           # tests/test_native_featext.py:53
TOL_MLSA = 2e-6                  # tests/test_mlsa_native.py:48
FLOOR_16BIT = 2.0 ** -15         # tests/test_mlsa_native.py:51 (3e-5)
TOL_WORLD, VUV_AGREE_MIN = 2e-4, 0.98   # tests/test_native_featext.py:103
# eval_pair on the card against the CPU: mceps and spectra agree within
# 1e-4, so MCD and LSD within 1e-3 dB; one frame's voicing may flip
# (2% of frames, the F0 suite's limit), which moves the F0 RMSEs by that
# frame's share
TOL_EVAL_DB, TOL_EVAL_VUV, TOL_EVAL_F0_REL = 1e-3, 0.02, 0.05
# the world branch's pitch checks: decode --f0-factor PITCH_FACTOR of one
# eval utterance cut to PITCH_DECODE_S, its voiced lf0 moved by
# ln(PITCH_FACTOR) within TOL_LF0; the transposed oracle at PITCH_FACTORS on
# each eval utterance's first PITCH_ORACLE_S with pulse-only voiced
# excitation, its per-frame ratio within TOL_PITCH of the factor
# (tools/pitch_eval.py's done criterion; tests/test_torch_pitch_chain.py
# holds the same on the CPU); bin.as_oracle on the eval utterances cut to
# PITCH_ORACLE_S, card against CPU at TOL_EVAL_DB. The oracle's MLSA
# synthesis runs its per-sample recursion eagerly (ops/mlsa.py: torch ops
# dispatched per sample), so its length is cut
PITCH_FACTOR, PITCH_FACTORS, PITCH_DECODE_S = 1.3, (0.7, 1.3), 0.5
PITCH_ORACLE_S, TOL_PITCH, TOL_LF0 = 0.15, 0.05, 1e-5
# observe: decode --profile of OBSERVE_UTTS of the main path's utterances,
# with and without the profiler in turns; bin.train --profile --debug-nans
# over OBSERVE_STEPS updates at steps_per_call = 8 on the train phase's
# corpus, against the same run without the flags; debug mode's cost per
# update in turns of OBSERVE_TURN_UPDATES single updates (anomaly mode makes
# an update some 20x slower); a NaN at update OBSERVE_NAN_AT of a group
# raising there
OBSERVE_UTTS, OBSERVE_STEPS, OBSERVE_NAN_AT = 2, 16, 4
OBSERVE_TURN_UPDATES = 2
# data parallelism on the one card: the DP trainer (an NCCL group of one
# rank) against the plain one over DP_UPDATES updates, timed in
# DP_ROUNDS rounds of turns (plain, DP, DP, plain) of DP_UPDATES each (the
# update is the host's dispatch, whose time drifts within a call); the
# NCCL all-reduce of the update's buffer alone over DP_REDUCE_REPS, on the
# device's clock and on the host's
DP_UPDATES, DP_ROUNDS, DP_REDUCE_REPS = 8, 3, 20
# the stream pool at config 2: POOL_STREAMS streams (and the card's
# clusters, and one more), STREAM_BLOCK-frame blocks, STREAM_FRAMES frames
# each; then a staggered scenario over POOL_STAGGER_SLOTS slots of
# POOL_STAGGER (open step, frames) streams
POOL_STREAMS = (1, 8)
POOL_STAGGER_SLOTS = 3
POOL_STAGGER = ((0, 40), (2, 27), (3, 4), (5, 33), (7, 20))
T0 = time.perf_counter()


def emit(phase: str, **kw):
    print(json.dumps({"phase": phase, "t": time.perf_counter() - T0, **kw},
                     default=dataclasses.asdict), flush=True)


def require(ok: bool, what: str):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def registers(ptxas_log: str) -> dict:
    """{"fp32|bf16,unfused|fused": registers} of the AR kernel,
    {"ar_cluster,fp32|bf16[,fused],smem|l2|wide": registers} of the
    cluster kernel (unfused or with the fused window, weights resident or
    streamed from L2, or its wide form) and
    {"ar_probe,fp32|bf16,<ablation>": registers} of the probe kernel, and
    {"ar_cluster_probe,fp32|bf16[,fused],smem|l2,<ablation>|timed":
    registers} of the cluster kernel's probe instances, and
    {"ring_probe,<variant>": registers} of the ring probe's kernels, from
    `ptxas -v` output (other kernels' entries are skipped)."""
    regs, entry = {}, None
    for line in ptxas_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            if not re.search(r"ar_(generate|probe|cluster)_kernel"
                             r"|ring_(probe|pipe)_kernel", entry):
                entry = None
        elif entry and "registers" in line:
            dtype = "bf16" if "bfloat16" in entry else "fp32"
            probe = re.search(r"ar_probe_kernel.*?Li(\d+)E", entry)
            ring = re.search(r"ring_(probe|pipe)_kernelILi(\d)E", entry)
            if ring:
                key = "ring_probe," + ring_probe.VARIANTS[
                    int(ring.group(2)) + (2 if ring.group(1) == "pipe" else 0)]
            elif probe:
                key = (f"ar_probe,{dtype},"
                       f"{ar_probe.ABLATIONS[int(probe.group(1))]}")
            elif "ar_cluster_kernel" in entry:
                res, fused, abl, timed, wide = re.search(
                    r"Lb([01])ELb([01])ELi(\d+)ELb([01])E(Lb1E)?",
                    entry).groups()
                key = (f"ar_cluster,{dtype},"
                       + ("fused," if fused == "1" else "")
                       + ("wide" if wide else "smem" if res == "1"
                          else "l2"))
                if abl != "0" or timed == "1":
                    key = ("ar_cluster_probe" + key[len("ar_cluster"):]
                           + "," + ("timed" if timed == "1" else
                                    ar_probe.ALL_ABLATIONS[int(abl)]))
            else:
                key = dtype + "," + ("fused" if "Lb1E" in entry
                                     else "unfused")
            regs[key] = int(line.split("Used")[1].split("registers")[0])
            entry = None
    return regs


def start_builds() -> dict:
    """Phase 1's compiles, all started together: one nvcc per kernel source
    (`_build.start`). The early phases wait only for the AR kernel; the
    probes' builds go on beside them (`finish_builds`)."""
    return {"t0": time.perf_counter(), "nvcc": _build.start()}


def finish_builds(builds: dict, names) -> tuple[dict, dict]:
    """Wait for the named sources' builds: returns ({name: library},
    registers), the registers from ptxas's report in each build's log."""
    libs = _build.finish({n: builds["nvcc"].pop(n) for n in names})
    return libs, registers("\n".join(_build.log_path(n).read_text()
                                     for n in names))


def event_ms(fn) -> float:
    """Device time of fn(), by CUDA events."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() over `reps` calls, after one warm-up call."""
    fn()
    return event_ms(lambda: [fn() for _ in range(reps)]) / reps


def host_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


# host seconds of the plain versions by kind and where they ran, for the
# plain_seconds line
PLAIN_SECONDS: dict = {}


def plain_time(kind: str, fn, *args, **kw):
    """fn(*args, **kw), its host seconds (card synchronized on both
    sides) added to PLAIN_SECONDS[kind]."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    PLAIN_SECONDS[kind] = (PLAIN_SECONDS.get(kind, 0.0)
                           + time.perf_counter() - t0)
    return out


def plain_version(*args, **kw):
    """ar_kernel.generate_plain with its step replayed from a CUDA graph
    on the card (`graph=True`; equal to the eager loop to the bit,
    phase `plain_graph`)."""
    return plain_time("generate_plain, CUDA-graph replay on the card",
                      ar_kernel.generate_plain, *args, graph=True, **kw)


def probe_plain(*args, **kw):
    return plain_time("ar_probe.probe_plain, eager on the card",
                      ar_probe.probe_plain, *args, **kw)


def ring_plain(*args, **kw):
    return plain_time("ring_probe.ring_probe_plain, on the card",
                      ring_probe.ring_probe_plain, *args, **kw)


def phase_plain_graph(mc, model, pp, seed: int) -> None:
    """The plain version's CUDA-graph replay against its eager loop, to the
    bit, over a PLAIN_GRAPH_T-step prefix at config 2, B = B_CHECK: the
    Laplace head teacher-forced, free running (sample and greedy) and with
    a warm-up prefix; the softmax head teacher-forced; the fused window;
    and the bf16 weights summed in the cluster kernel's order (chain=True,
    split=8), unfused and fused. Each eager and replayed call's host ms."""
    B, T = B_CHECK, PLAIN_GRAPH_T
    c_up = random_cond(mc, model, B, T, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = ar_kernel.uniform_noise((B, T), g)
    teacher = torch.rand((B, T), generator=g, device="cuda") * 2 - 1
    mcs = get_config("shallow_laplace_single", ["model.head=softmax"]).model
    pps = extract_plain_params(random_model(mcs, seed + 1))
    ids = torch.randint(0, mcs.quantize_channels, (B, T), generator=g,
                        device="cuda").float()
    cases = {
        "laplace_teacher_forced": (pp, mc, dict(teacher=teacher)),
        "laplace_free_sample": (pp, mc, {}),
        "laplace_free_greedy": (pp, mc, dict(mode="greedy")),
        "laplace_warmup_100": (pp, mc, dict(teacher=teacher, warmup=100)),
        "softmax_teacher_forced": (pps, mcs, dict(teacher=ids)),
        "fused4_teacher_forced": (pp, mc, dict(teacher=teacher,
                                               fused=FUSED)),
        "bf16_chain_split8": (pp, mc, dict(dtype="bfloat16", chain=True,
                                           split=8)),
        "bf16_chain_split8_fused4": (pp, mc, dict(
            dtype="bfloat16", chain=True, split=8, fused=FUSED)),
    }
    checks = []
    for name, (p, m, kw) in cases.items():
        eager, eager_ms = host_ms(lambda: plain_time(
            "generate_plain, eager loop on the card",
            ar_kernel.generate_plain, p, m, c_up, noise=noise, **kw))
        replay, replay_ms = host_ms(lambda: plain_version(
            p, m, c_up, noise=noise, **kw))
        e = float((eager - replay).abs().max())
        checks.append({"check": name, "max_abs_err": e, "limit": 0.0,
                       "eager_ms": eager_ms, "replay_ms": replay_ms,
                       "ok": e == 0.0})
    emit("plain_graph", B=B, T=T, checks=checks)
    for c in checks:
        require(c["ok"], f"plain version, graph replay vs eager: {c}")


def random_tree(mc, seed: int) -> dict:
    """The port's numpy init with a random head2 (zero in the flax init)."""
    tree = init_params_tree(mc, seed)
    rng = np.random.default_rng(seed + 1000)
    tree["head2"]["kernel"] = (0.05 * rng.standard_normal(
        tree["head2"]["kernel"].shape)).astype(np.float32)
    return tree


def random_model(mc, seed: int):
    return params_from_flax(WaveNet(mc), random_tree(mc, seed)).cuda()


def random_cond(mc, model, B: int, T: int, seed: int):
    """c_up (B, T, C) from random normalized frames through the upsampler."""
    hop = int(np.prod(mc.upsample_factors))
    frames = -(-T // hop)
    rng = np.random.default_rng(seed)
    cond = torch.from_numpy(rng.standard_normal(
        (B, frames, mc.aux_channels)).astype(np.float32)).cuda()
    with torch.no_grad():
        return model.upsample_cond(cond)[:, :T].contiguous()


def bound(mc, B: int, T: int, dtype: str = "float32") -> tuple[float, str]:
    """The benchmark's least time (ms) of one AR kernel call of B rows and
    T steps of the model `mc`, and what bounds it
    (`yardstick.ar_bound_ms`: the unfused model's operations or bytes,
    weights of `dtype`, whatever the layout that ran)."""
    return yardstick.ar_bound_ms(dataclasses.asdict(mc), B, T,
                                 ar_kernel.DTYPES[dtype].itemsize, dtype)


def phase_kernel_vs_plain(mc, model, pp, seed: int) -> dict:
    """Both AR kernels at config 2 against one set of plain outputs:
    ar_generate (cluster 0) and the cluster kernel at the decode's N."""
    B, T = B_CHECK, T_CHECK
    chosen = ar_kernel.choose_layout(mc, "float32")
    N = chosen.cluster
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

    mcs = get_config("shallow_laplace_single", ["model.head=softmax"]).model
    ms = random_model(mcs, seed + 1)
    pps = extract_plain_params(ms)
    ids = torch.randint(0, mcs.quantize_channels, (B, T), generator=g,
                        device="cuda").float()
    q = mcs.quantize_channels
    # the plain outputs, shared by both kernels
    ar_kernel.launches.clear()
    p_tf = plain_version(pp, mc, c_up, noise=noise, teacher=teacher)
    p_free = {}
    for mode in ("sample", "greedy"):
        p_free[mode], plain_ms = host_ms(lambda: plain_version(
            pp, mc, c_up, noise=noise, mode=mode))
    p_ids = mulaw_quantize(plain_version(
        pps, mcs, c_up, noise=noise, teacher=ids), q)
    times = {}
    for layout in (ar_kernel.Layout(), chosen):
        n = layout.cluster
        tag = "" if n == 0 else f"cluster{n}_"
        # (a) Laplace, teacher-forced
        k = ar_kernel.generate(pp, mc, c_up, noise=noise, teacher=teacher,
                               layout=layout)
        record(f"{tag}laplace_teacher_forced", err(k, p_tf), TOL_TEACHER)
        # (b) Laplace, free-running
        for mode in ("sample", "greedy"):
            k = ar_kernel.generate(pp, mc, c_up, noise=noise, mode=mode,
                                   layout=layout)
            record(f"{tag}laplace_free_{mode}", err(k, p_free[mode]),
                   TOL_FREE)
            require(bool(torch.isfinite(k).all()),
                    f"finite kernel output {tag}{mode}")
        wk = ar_kernel.kernel_weights(pp, mc, layout, "cuda")
        times[n] = cuda_ms(lambda: ar_kernel.generate(wk, mc, c_up,
                                                      noise=noise))
        # (c) softmax head at config-2 widths, teacher-forced: class ids
        k = mulaw_quantize(ar_kernel.generate(pps, mcs, c_up, noise=noise,
                                              teacher=ids, layout=layout), q)
        d = (k.long() - p_ids.long()).abs()
        flips = float((d != 0).float().mean())
        checks.append({"check": f"{tag}softmax_teacher_forced_ids",
                       "max_bin_diff": int(d.max()), "limit_bins": 1,
                       "flip_share": flips, "limit_share": 0.01,
                       "ok": int(d.max()) <= 1 and flips < 0.01})
        # (d) segmented against unsegmented, both on the kernel
        full = ar_kernel.generate(pp, mc, c_up, noise=noise, layout=layout)
        seg = generate_segmented(pp, mc, c_up, noise, 2048, layout=layout)
        record(f"{tag}segmented_2048_vs_unsegmented", err(seg, full), 0.0)
    launched = dict(ar_kernel.launches)
    # time per call across batch sizes: one block per row
    sweep = []
    for b in SWEEP_B:
        cb = random_cond(mc, model, b, SWEEP_T, seed + b)
        nb = ar_kernel.uniform_noise((b, SWEEP_T), g)
        ms = cuda_ms(lambda: ar_kernel.generate(pp, mc, cb, noise=nb), 2)
        sweep.append({"B": b, "T": SWEEP_T, "ms": ms,
                      "us_per_step": 1e3 * ms / SWEEP_T})
    result = {"B": B, "T": T, "cluster": N, "checks": checks,
              "kernel_ms": times[0], "cluster_kernel_ms": times[N],
              "plain_ms": plain_ms, "launches": launched,
              "batch_sweep": sweep}
    emit("kernel_vs_plain", **result)
    for c in checks:
        require(c["ok"], f"kernel vs plain: {c}")
    result["max_abs_err"] = next(c["max_abs_err"] for c in checks
                                 if c["check"] == "laplace_teacher_forced")
    result["bound_ms"], result["bound_by"] = bound(mc, B, T)
    return result


def utterances(mc, seed: int, lo: int, hi: int):
    """8 utterances of lo..hi random normalized frames: (frames, utts)."""
    rng = np.random.default_rng(seed)
    frames = np.linspace(lo, hi, 8).round().astype(int)
    return frames, [Utterance(np.zeros(0, np.float32), rng.standard_normal(
        (f, mc.aux_channels)).astype(np.float32)) for f in frames]


def phase_main_path(cfg, model, pp, seed: int, smi: str, fused: int = 0,
                    unfused: dict | None = None) -> dict:
    """The config-2 main path (`main_path`), or with the fused window
    (`fused_main_path`, beside the unfused run's wall time and RTF), both
    on the cluster kernel."""
    phase = "fused_main_path" if fused else "main_path"
    mc, hop = cfg.model, cfg.data.hop_length
    want = ar_kernel.choose_layout(mc, "auto", fused=fused)
    require(want.cluster > 1 and want.fused == fused,
            f"{phase}: the decode's layout {want}")
    name = want.name
    frames, utts = utterances(mc, seed + 7, 75, 150)
    names = [f"utt{i}.wav" for i in range(len(utts))]
    with tempfile.TemporaryDirectory() as tmp:
        ar_kernel.launches.clear()
        summary = decode.decode_utterances(
            model, cfg, utts, names, tmp,
            torch.Generator(device="cuda").manual_seed(seed), batch_size=8,
            fused=fused)
        launched = dict(ar_kernel.launches)
        require(launched.get(name, 0) >= 1 and set(launched) == {name},
                f"the {phase} launched {name}: {launched}")
        require(summary["kernel"] == dataclasses.asdict(want)
                and want.dtype == "float32" and not want.stream,
                f"{phase} layout {summary['kernel']}")
        written = json.loads((Path(tmp) / "decode_summary.json").read_text())
        require(written == summary, "decode_summary.json written")
        pcm = []
        for n, f in zip(names, frames):
            with wave.open(str(Path(tmp) / n)) as w:
                require(w.getnframes() == f * hop, f"{n} length")
                pcm.append(np.frombuffer(w.readframes(w.getnframes()), "<i2"))
    beside = {} if unfused is None else {
        "unfused_wall_seconds": unfused["wall_seconds"],
        "unfused_rtf": unfused["rtf"]}
    emit(phase, variant=name, kernel=summary["kernel"],
         utterances=len(utts), frames=frames.tolist(),
         launches=launched[name], audio_seconds=summary["audio_seconds"],
         wall_seconds=summary["wall_seconds"], rtf=summary["rtf"],
         audio_seconds_per_s=summary["audio_seconds_per_s"], **beside,
         card=smi)

    # the main path's kernel call again, on the same inputs
    cond, _, n_samples = pad_batch_for_decode(utts, hop)
    with torch.no_grad():
        c_up = model.upsample_cond(torch.from_numpy(cond).cuda())
    noise = ar_kernel.uniform_noise(
        c_up.shape[:2], torch.Generator(device="cuda").manual_seed(seed))

    # the kernel's weights made once, so that a timed call is its launch
    w = ar_kernel.kernel_weights(pp, mc, want, "cuda")

    def gen(c, n):
        return ar_kernel.generate(w, mc, c, noise=n)

    out = gen(c_up, noise)
    require(bool(torch.isfinite(out).all()), f"{phase} output finite")
    wav = out.cpu().numpy()
    for i, n in enumerate(n_samples):
        q = np.clip(np.round(wav[i, :n] * 32767.0), -32768, 32767)
        require(np.array_equal(q.astype("<i2"), pcm[i]),
                f"{phase} utterance {i}: wav equals the kernel's samples")
    B, T = out.shape
    full_ms = cuda_ms(lambda: gen(c_up, noise), 2)
    # plain version teacher-forced with the kernel's own samples (every
    # step sees the kernel's history, so only one step's rounding
    # differs): unfused over the whole call, fused over its first PLAIN_T
    # steps
    Tp = PLAIN_T if fused else T
    cp, npl = c_up[:, :Tp].contiguous(), noise[:, :Tp].contiguous()
    ms = full_ms if Tp == T else cuda_ms(lambda: gen(cp, npl), 2)
    plain, plain_ms = host_ms(lambda: plain_version(
        pp, mc, cp, noise=npl, teacher=own_feedback(out)[:, :Tp],
        fused=fused))
    max_err = err(plain, out[:, :Tp])
    bound_ms, bound_by = bound(mc, B, Tp)
    emit(f"{phase}_vs_plain", variant=name, B=B, T=Tp, full_T=T,
         full_call_ms=full_ms, max_abs_err=max_err, limit=TOL_TEACHER,
         kernel_ms=ms, us_per_step=1e3 * ms / Tp, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by)
    require(max_err <= TOL_TEACHER, f"{phase} kernel vs plain")

    # the segmented decode of the same batch: same noise, same samples
    ar_kernel.launches.clear()
    t0 = time.perf_counter()
    seg = decode.decode_batch(
        model, cfg, utts, segment_samples=SEGMENT,
        generator=torch.Generator(device="cuda").manual_seed(seed),
        layout=want)
    seg_wall = time.perf_counter() - t0
    seg_launches = ar_kernel.launches[name]
    seg_err = max(float(np.abs(w - wav[i, :n]).max())
                  for i, (w, n) in enumerate(zip(seg, n_samples)))
    emit(f"{phase}_segmented", segment_samples=SEGMENT,
         launches=seg_launches, wall_seconds=seg_wall, max_abs_err=seg_err,
         limit=0.0)
    require(seg_launches == -(-T // SEGMENT), "segmented decode launches")
    require(seg_err == 0.0, "segmented decode equals unsegmented")
    return {"name": name, "launches": launched[name], "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "wall_seconds": summary["wall_seconds"],
            "rtf": summary["rtf"]}


def err(a, b) -> float:
    return float((a - b).abs().max())


def own_feedback(out):
    """The teacher stream that replays a free-running call: x[t-1], with
    silence (0.0) at t = 0."""
    return torch.cat([torch.zeros_like(out[:, :1]), out[:, :-1]], dim=1)


def phase_deep_kernel_vs_plain(mc, model, pp, seed: int) -> dict:
    """ar_generate's deep layouts, the decode's fallback (cluster=False),
    unfused and fused."""
    B, T = DEEP_B, DEEP_T
    lay32 = ar_kernel.choose_layout(mc, "float32", cluster=False)
    laybf = ar_kernel.choose_layout(mc, "bfloat16", cluster=False)
    lay32f, laybff = (ar_kernel.choose_layout(mc, dt, fused=FUSED,
                                              cluster=False)
                      for dt in ("float32", "bfloat16"))
    require(all(lay.stream for lay in (lay32, laybf, lay32f, laybff)),
            f"deep fallback layouts are streamed: {lay32}, {laybf}, "
            f"{lay32f}, {laybff}")
    ar_kernel.launches.clear()
    c_up = random_cond(mc, model, B, T, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = ar_kernel.uniform_noise((B, T), g)
    teacher = torch.rand((B, T), generator=g, device="cuda") * 2 - 1
    checks = []

    def record(name, e, limit, **kw):
        checks.append({"check": name, "max_abs_err": e, "limit": limit,
                       "ok": e <= limit, **kw})

    def gen(c, n, layout, **kw):
        return ar_kernel.generate(pp, mc, c, noise=n, layout=layout, **kw)

    def plain(c, n, dtype="float32", **kw):
        return plain_version(pp, mc, c, noise=n, dtype=dtype, **kw)

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
                   gen(c_up, noise, dataclasses.replace(layout, chunk=32))),
               0.0)
    # streamed equal to resident, where both fit: config-2 widths with
    # stack_size=8 (top dilation 128: the d > 64 and d > 32 splits stream)
    mc8 = get_config("shallow_laplace_single", ["model.stack_size=8"]).model
    m8 = random_model(mc8, seed + 2)
    pp8 = extract_plain_params(m8)
    c8 = random_cond(mc8, m8, B, T, seed + 2)
    for dtype in ("float32", "bfloat16"):
        res = ar_kernel.generate(pp8, mc8, c8, noise=noise,
                                 layout=ar_kernel.Layout(dtype))
        for chunk in (64, 32):
            st = ar_kernel.generate(pp8, mc8, c8, noise=noise,
                                    layout=ar_kernel.Layout(
                                        dtype, stream=True, chunk=chunk))
            record(f"stack8_{dtype}_stream{chunk}_vs_resident",
                   err(st, res), 0.0)
    # segmented against unsegmented, fp32 streamed
    cs = random_cond(mc, model, B, DEEP_SEG_T, seed + 4)
    ns = ar_kernel.uniform_noise((B, DEEP_SEG_T), g)
    seg = generate_segmented(pp, mc, cs, ns, DEEP_SEGMENT, layout=lay32)
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
    # the fused fallback layouts over the first Tf steps, twice the
    # largest dilation (every ring written and read): fp32 teacher-forced;
    # bf16 fed its own samples, to the bit against chain=True, where the
    # fp32 control misses
    Tf = 2 * max(mc.dilations)
    cf_, nf_, tf_ = (x[:, :Tf].contiguous() for x in (c_up, noise, teacher))
    k = gen(cf_, nf_, lay32f, teacher=tf_)
    p, plain32f_ms = host_ms(lambda: plain(cf_, nf_, teacher=tf_,
                                           fused=FUSED))
    e32f = err(k, p)
    record(f"fp32_stream_fused{FUSED}_teacher_forced_{Tf}", e32f,
           TOL_TEACHER)
    k = gen(cf_, nf_, laybff)
    require(bool(torch.isfinite(k).all()), "finite deep bf16 fused output")
    fb = own_feedback(k)
    chain, plainbff_ms = host_ms(lambda: plain(
        cf_, nf_, "bfloat16", teacher=fb, fused=FUSED, chain=True))
    ebff = err(k, chain)
    ctl = err(k, plain(cf_, nf_, teacher=fb, fused=FUSED))
    checks.append({"check": f"bf16_stream_fused{FUSED}_vs_chain_{Tf}",
                   "max_abs_err": ebff, "limit": TOL_CHAIN,
                   "control_fp32": ctl, "control_min": CONTROL_MIN,
                   "ok": ebff <= TOL_CHAIN and ctl > CONTROL_MIN})
    times = {}
    errs = {"fp32": next(c["max_abs_err"] for c in checks if c["check"]
                         == "fp32_stream_teacher_forced"),
            "bf16": e0}
    for name, layout, plain_ms, cn, e in (
            ("fp32", lay32, plain32_ms, (c_up, noise), errs["fp32"]),
            ("bf16", laybf, plainbf_ms, (c_up, noise), e0),
            ("fp32_fused", lay32f, plain32f_ms, (cf_, nf_), e32f),
            ("bf16_fused", laybff, plainbff_ms, (cf_, nf_), ebff)):
        wl = ar_kernel.kernel_weights(pp, mc, layout, "cuda")
        ms = cuda_ms(lambda: ar_kernel.generate(wl, mc, cn[0], noise=cn[1]),
                     2)
        Tn = cn[0].shape[1]
        bound_ms, bound_by = bound(mc, B, Tn, layout.dtype)
        times[name] = {"layout": layout, "T": Tn, "ms": ms,
                       "us_per_step": 1e3 * ms / Tn, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "max_abs_err": e}
    launched = dict(ar_kernel.launches)
    for name in times:
        times[name]["name"] = times[name]["layout"].name
        times[name]["launches"] = launched[times[name]["name"]]
    smem = {f"{dt}_{'stream' if st else 'resident'}{ch}"
            + (f"_fused{f}" if f else ""):
            ar_kernel.smem_bytes(mc, ar_kernel.Layout(dt, f, stream=st,
                                                      chunk=ch))
            for dt in ar_kernel.DTYPES
            for st, ch in ((False, 64), (True, 64), (True, 32))
            for f in (0, FUSED)}
    emit("deep_kernel_vs_plain", B=B, T=T, checks=checks, readings=readings,
         times=times, launches=launched, smem_bytes=smem,
         smem_limit=ar_kernel.smem_limit("cuda"))
    for c in checks:
        require(c["ok"], f"deep kernel vs plain: {c}")
    return times


def phase_deep_main_path(cfg, model, pp, seed: int, smi: str,
                         kernel_dtype: str, fused: int = 0) -> dict:
    """The deep main path (`deep_main_path`), or with the fused window
    (`deep_fused`: fp32 held over the first steps only, as bf16 is), both
    on the cluster kernel."""
    phase = "deep_fused" if fused else "deep_main_path"
    mc, hop = cfg.model, cfg.data.hop_length
    frames, utts = utterances(mc, seed + 8, 40, 80)
    names = [f"utt{i}.wav" for i in range(len(utts))]
    with tempfile.TemporaryDirectory() as tmp:
        ar_kernel.launches.clear()
        summary = decode.decode_utterances(
            model, cfg, utts, names, tmp,
            torch.Generator(device="cuda").manual_seed(seed), batch_size=8,
            kernel_dtype=kernel_dtype, fused=fused)
        launched = dict(ar_kernel.launches)
        layout = ar_kernel.Layout(**summary["kernel"])
        name = layout.name
        require(layout == ar_kernel.choose_layout(mc, kernel_dtype,
                                                  fused=fused)
                and layout.dtype == kernel_dtype and layout.fused == fused
                and not layout.stream and layout.cluster > 1,
                f"deep layout {layout}")
        require(launched.get(name, 0) >= 1 and set(launched) == {name},
                f"the deep main path launched {name}: {launched}")
        pcm = []
        for n, f in zip(names, frames):
            with wave.open(str(Path(tmp) / n)) as w:
                require(w.getnframes() == f * hop, f"{n} length")
                pcm.append(np.frombuffer(w.readframes(w.getnframes()), "<i2"))
    emit(phase, kernel_dtype=kernel_dtype, kernel=layout,
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
    # the kernel's weights made once, so that a timed call is its launch
    w = ar_kernel.kernel_weights(pp, mc, layout, "cuda")
    out, full_ms = host_ms(lambda: ar_kernel.generate(w, mc, c_up,
                                                      noise=noise))
    require(bool(torch.isfinite(out).all()), "deep main-path output finite")
    wav = out.cpu().numpy()
    for i, n in enumerate(n_samples):
        q = np.clip(np.round(wav[i, :n] * 32767.0), -32768, 32767)
        require(np.array_equal(q.astype("<i2"), pcm[i]),
                f"deep utterance {i}: wav equals the kernel's samples")
    # the plain version teacher-forced with the kernel's own samples:
    # unfused fp32 over PLAIN_T steps; bf16 in the kernel's summation
    # order (chain=True, split=N, fused or not), and fused fp32, over twice
    # the largest dilation, so every ring is written and read (see
    # TOL_CHAIN above)
    bf16 = layout.dtype == "bfloat16"
    split = layout.cluster if bf16 else 0
    B = c_up.shape[0]
    Tp = 2 * max(mc.dilations) if bf16 or fused else PLAIN_T
    cp, npl = c_up[:, :Tp].contiguous(), noise[:, :Tp].contiguous()
    teacher = own_feedback(out)[:, :Tp]
    ms = cuda_ms(lambda: ar_kernel.generate(w, mc, cp, noise=npl), 2)
    plain, plain_ms = host_ms(lambda: plain_version(
        pp, mc, cp, noise=npl, teacher=teacher, dtype=layout.dtype,
        chain=bf16, split=split, fused=fused))
    max_err = err(plain, out[:, :Tp])
    extra = {}
    if bf16:
        limit = TOL_CHAIN
        d = (plain - out[:, :Tp]).abs().amax(0)
        parted = torch.nonzero(d > limit)
        control = err(plain_version(
            pp, mc, cp, noise=npl, teacher=teacher, fused=fused),
            out[:, :Tp])
        matmul = plain_version(pp, mc, cp, noise=npl, teacher=teacher,
                               dtype="bfloat16", fused=fused)
        extra = {"first_parted_step": int(parted[0]) if len(parted) else None,
                 "control_fp32": control, "control_min": CONTROL_MIN,
                 "matmul_order_drift": err(matmul, out[:, :Tp]),
                 "matmul_order_vs_chain": err(matmul, plain)}
    else:
        limit = TOL_TEACHER
    bound_ms, bound_by = bound(mc, B, Tp, layout.dtype)
    emit(f"{phase}_vs_plain", variant=name, B=B, T=Tp,
         full_T=out.shape[1], full_call_ms=full_ms, max_abs_err=max_err,
         limit=limit, chain=bf16, split=split, **extra, kernel_ms=ms,
         us_per_step=1e3 * ms / Tp, plain_ms=plain_ms, bound_ms=bound_ms,
         bound_by=bound_by)
    require(max_err <= limit, f"deep main-path kernel vs plain ({name})")
    require(not bf16 or extra["control_fp32"] > CONTROL_MIN,
            f"deep main-path fp32 control misses the bf16 kernel ({name})")
    return {"name": name, "launches": launched[name], "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "wall_seconds": summary["wall_seconds"],
            "rtf": summary["rtf"], "T": Tp}


def phase_fused_kernel_vs_plain(mc, model, pp, seed: int) -> dict:
    """The fused window at config 2 on both kernels against one set of
    plain outputs: ar_generate (cluster 0, the fallback) and the cluster
    kernel at the size the decode picks for fused=4."""
    B, T = B_CHECK, T_CHECK
    chosen = ar_kernel.choose_layout(mc, "float32", fused=FUSED)
    N = chosen.cluster
    require(N > 1, f"a cluster size for fused={FUSED}")
    c_up = random_cond(mc, model, B, T, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = ar_kernel.uniform_noise((B, T), g)
    teacher = torch.rand((B, T), generator=g, device="cuda") * 2 - 1
    checks = []

    def record(name, e, limit):
        checks.append({"check": name, "max_abs_err": e, "limit": limit,
                       "ok": e <= limit})

    def gen(c, n, layout, **kw):
        return ar_kernel.generate(pp, mc, c, noise=n, layout=layout, **kw)

    def plain(c, n, **kw):
        return plain_version(pp, mc, c, noise=n, **{"fused": FUSED, **kw})

    mcs = get_config("shallow_laplace_single", ["model.head=softmax"]).model
    pps = extract_plain_params(random_model(mcs, seed + 1))
    q = mcs.quantize_channels
    ids = torch.randint(0, q, (B, T), generator=g, device="cuda").float()
    cw, nw, tw = (x[:, :FUSED_W_T].contiguous()
                  for x in (c_up, noise, teacher))
    # the plain outputs, shared by both kernels
    ar_kernel.launches.clear()
    p, plain_ms = host_ms(lambda: plain(c_up, noise, teacher=teacher))
    p_ids = mulaw_quantize(plain_version(
        pps, mcs, c_up, noise=noise, teacher=ids, fused=FUSED), q)
    p_w = {W: plain(cw, nw, teacher=tw, fused=W) for W in FUSED_WINDOWS}
    kernel_ms = {}
    for layout in (ar_kernel.Layout(fused=FUSED), chosen):
        n = layout.cluster
        tag = "" if n == 0 else f"cluster{n}_"
        # Laplace, teacher-forced: against its plain version and the same
        # kernel unfused
        k = gen(c_up, noise, layout, teacher=teacher)
        record(f"{tag}laplace_teacher_forced", err(k, p), TOL_TEACHER)
        unfused = (ar_kernel.choose_layout(mc, "float32") if n
                   else ar_kernel.Layout())
        record(f"{tag}fused_vs_unfused_kernel_teacher_forced",
               err(k, gen(c_up, noise, unfused, teacher=teacher)),
               TOL_TEACHER)
        wk = ar_kernel.kernel_weights(pp, mc, layout, "cuda")
        kernel_ms[n] = cuda_ms(lambda: ar_kernel.generate(
            wk, mc, c_up, noise=noise, teacher=teacher), 2)
        # free-running, each sample against the plain version given the
        # kernel's own history
        for mode in ("sample", "greedy"):
            k = gen(c_up, noise, layout, mode=mode)
            require(bool(torch.isfinite(k).all()),
                    f"finite fused output {tag}{mode}")
            record(f"{tag}laplace_free_{mode}",
                   err(k, plain(c_up, noise, mode=mode,
                                teacher=own_feedback(k))), TOL_FREE)
        # softmax head at config-2 widths, teacher-forced: class ids
        d = (mulaw_quantize(ar_kernel.generate(
            pps, mcs, c_up, noise=noise, teacher=ids, layout=layout),
            q).long() - p_ids.long()).abs()
        flips = float((d != 0).float().mean())
        checks.append({"check": f"{tag}softmax_teacher_forced_ids",
                       "max_bin_diff": int(d.max()), "limit_bins": 1,
                       "flip_share": flips, "limit_share": 0.01,
                       "ok": int(d.max()) <= 1 and flips < 0.01})
        # segmented against unsegmented, both fused
        record(f"{tag}segmented_{SEGMENT}_vs_unsegmented",
               err(generate_segmented(pp, mc, c_up, noise, SEGMENT,
                                      layout=layout),
                   gen(c_up, noise, layout)), 0.0)
        # the other windows, teacher-forced over the first steps, each on
        # the cluster layout the decode picks for it
        for W in FUSED_WINDOWS:
            lW = (ar_kernel.choose_layout(mc, "float32", fused=W) if n
                  else ar_kernel.Layout(fused=W))
            record(f"{tag}W{W}_teacher_forced_{FUSED_W_T}",
                   err(gen(cw, nw, lW, teacher=tw), p_w[W]), TOL_TEACHER)
    # ar_generate: streamed equal to resident where both fit (config-2
    # widths with stack_size=8), and the time of each: the streamed layers'
    # slots are read from global memory in the base stage
    mc8 = get_config("shallow_laplace_single", ["model.stack_size=8"]).model
    m8 = random_model(mc8, seed + 2)
    pp8 = extract_plain_params(m8)
    c8 = random_cond(mc8, m8, B, T, seed + 2)
    stack8_ms = {}
    for dtype in ("float32", "bfloat16"):
        for stream, chunk in ((False, 64), (True, 64), (True, 32)):
            def run8():
                return ar_kernel.generate(pp8, mc8, c8, noise=noise,
                                          layout=ar_kernel.Layout(
                                              dtype, FUSED, stream=stream,
                                              chunk=chunk))
            out = run8()
            if not stream:
                res = out
            else:
                record(f"stack8_{dtype}_stream{chunk}_vs_resident",
                       err(out, res), 0.0)
            key = f"{dtype}_{'stream' if stream else 'resident'}{chunk}"
            stack8_ms[key] = cuda_ms(run8, 2)
    launched = dict(ar_kernel.launches)
    result = {"B": B, "T": T, "fused": FUSED, "cluster": N,
              "checks": checks, "kernel_ms": kernel_ms[0],
              "cluster_kernel_ms": kernel_ms[N], "plain_ms": plain_ms,
              "stack8_ms": stack8_ms, "launches": launched}
    emit("fused_kernel_vs_plain", **result)
    for c in checks:
        require(c["ok"], f"fused kernel vs plain: {c}")
    name = ar_kernel.Layout(fused=FUSED).name
    bound_ms, bound_by = bound(mc, B, T)
    # ar_generate's fused row in the kernels line: launches counted here
    return {**result, "name": name, "launches": launched[name],
            "max_abs_err": next(c["max_abs_err"] for c in checks
                                if c["check"] == "laplace_teacher_forced"),
            "ms": kernel_ms[0], "bound_ms": bound_ms, "bound_by": bound_by}


def phase_deep_fused_times(mc, model, pp, seed: int) -> None:
    """deep_baseline's fused and unfused variants on one batch, each on the
    layout the decode picks for it, timed in turns (unfused, fused, fused,
    unfused)."""
    B, T = 8, 1024
    c = random_cond(mc, model, B, T, seed + 5)
    n = ar_kernel.uniform_noise(
        (B, T), torch.Generator(device="cuda").manual_seed(seed + 5))
    times = {}
    for dtype in ("float32", "bfloat16"):
        layouts = {W: ar_kernel.choose_layout(mc, dtype, fused=W)
                   for W in (0, FUSED)}
        w = {W: ar_kernel.kernel_weights(pp, mc, lay, "cuda")
             for W, lay in layouts.items()}
        us = {0: [], FUSED: []}
        for W in (0, FUSED, FUSED, 0):
            us[W].append(1e3 * cuda_ms(lambda: ar_kernel.generate(
                w[W], mc, c, noise=n), 2) / T)
        times[dtype] = {"layout": layouts[FUSED],
                        "unfused_layout": layouts[0],
                        "unfused_us_per_step": us[0],
                        "fused_us_per_step": us[FUSED]}
    emit("deep_fused_times", B=B, T=T, times=times)


def phase_streaming(cfg, model, pp, seed: int, smi: str) -> None:
    """The streaming session at config 2, B = 1, fused=4 and unfused, both
    on the cluster kernel at the decode's size (the session's default)."""
    mc, hop, sr = cfg.model, cfg.data.hop_length, cfg.data.sample_rate
    frames = np.random.default_rng(seed + 9).standard_normal(
        (1, STREAM_FRAMES, mc.aux_channels)).astype(np.float32)
    with torch.no_grad():
        full = model.upsample_cond(torch.from_numpy(frames).cuda())
    block_s = STREAM_BLOCK * hop / sr
    n_blocks = -(-STREAM_FRAMES // STREAM_BLOCK)
    runs, checks = {}, []
    for W in (FUSED, 0):
        layout = ar_kernel.choose_layout(mc, "float32", fused=W)
        name = layout.name
        syn = StreamingSynthesizer(pp, model, mc, hop, batch=1,
                                   block_frames=STREAM_BLOCK, seed=seed,
                                   record_noise=True, fused=W)
        require(syn.layout == layout and layout.cluster > 1,
                f"the session's layout {syn.layout}, the decode's {layout}")
        ar_kernel.launches.clear()
        pieces, pushes = [], []
        for s0 in range(0, STREAM_FRAMES, STREAM_BLOCK):
            t0 = time.perf_counter()
            pieces.append(syn.push(frames[:, s0:s0 + STREAM_BLOCK]))
            pushes.append((time.perf_counter() - t0, pieces[-1].shape[1]))
        pieces.append(syn.flush())
        launched = dict(ar_kernel.launches)
        require(set(launched) == {name} and launched[name] == n_blocks,
                f"the streaming session launched {name}: {launched}")
        wav = np.concatenate(pieces, axis=1)
        require(wav.shape == (1, STREAM_FRAMES * hop)
                and bool(np.isfinite(wav).all()), "streamed samples")
        # steady state: the pushes that emitted a warm-started block (every
        # emitting push after the first)
        steady = 1e3 * np.array([t for t, m in pushes if m > 0][1:])
        # the kernel half: one call over the session's own conditioning
        # and uniforms; the upsampler half: that conditioning against the
        # whole utterance's
        c_all, n_all = syn.cond_so_far(), syn.noise_so_far()
        one_t = ar_kernel.generate(pp, mc, c_all, noise=n_all,
                                   layout=layout)
        one = one_t.cpu().numpy()
        kerr, uerr = float(np.abs(one - wav).max()), err(c_all, full)
        ulimit = TOL_UPSAMPLE * float(full.abs().max())
        checks += [{"check": f"fused{W}_stream_vs_one_call",
                    "max_abs_err": kerr, "limit": 0.0, "ok": kerr == 0.0},
                   {"check": f"fused{W}_cond_vs_whole_upsampling",
                    "max_abs_err": uerr, "limit": ulimit,
                    "exact": uerr == 0.0,
                    "share_differing": float((c_all != full).float().mean()),
                    "ok": uerr <= ulimit}]
        # the kernel against its plain version at this path's shapes (B = 1):
        # the one call teacher-forced with its own samples over its first
        # block and M steps into the second; and the second block's push
        # call (M forced warm-up steps, then free running), kernel and plain
        # on the same arguments, the kernel's output also equal to the
        # stream's
        n_blk, M = STREAM_BLOCK * hop, syn.M
        Tp = n_blk + M
        tf = err(plain_version(
            pp, mc, c_all[:, :Tp], noise=n_all[:, :Tp],
            teacher=own_feedback(one_t)[:, :Tp], fused=W), one_t[:, :Tp])
        push = dict(noise=n_all[:, n_blk - M:2 * n_blk],
                    teacher=one_t[:, n_blk - M - 1:n_blk - 1], warmup=M)
        kp = ar_kernel.generate(pp, mc, c_all[:, n_blk - M:2 * n_blk],
                                layout=layout, **push)
        pe = err(plain_version(
            pp, mc, c_all[:, n_blk - M:2 * n_blk], fused=W, **push), kp)
        se = float(np.abs(kp[:, M:].cpu().numpy()
                          - wav[:, n_blk:2 * n_blk]).max())
        checks += [{"check": f"fused{W}_kernel_vs_plain_teacher_forced_{Tp}",
                    "max_abs_err": tf, "limit": TOL_TEACHER,
                    "ok": tf <= TOL_TEACHER},
                   {"check": f"fused{W}_push_call_kernel_vs_plain",
                    "max_abs_err": pe, "limit": TOL_FREE,
                    "ok": pe <= TOL_FREE},
                   {"check": f"fused{W}_push_call_vs_stream",
                    "max_abs_err": se, "limit": 0.0, "ok": se == 0.0}]
        runs[f"fused{W}"] = {
            "variant": name, "layout": layout, "launches": launched[name],
            "blocks": n_blocks,
            "block_ms": 1e3 * block_s, "steady_pushes": len(steady),
            "push_ms_mean": float(steady.mean()),
            "push_ms_p95": float(np.percentile(steady, 95)),
            "steady_rtf": float(steady.sum() / 1e3 / (len(steady) * block_s)),
            "first_block_push_ms": 1e3 * [t for t, m in pushes if m > 0][0]}
    emit("streaming", config=cfg.name, B=1, block_frames=STREAM_BLOCK,
         frames=STREAM_FRAMES, hop=hop, warmup=syn.M, runs=runs,
         checks=checks, card=smi)
    for c in checks:
        require(c["ok"], f"streaming: {c}")


def corpus(cfg, seed: int) -> list:
    """TRAIN_UTTS synthetic utterances (`synth_utterance`, seeds from
    --seed) with 80-bin log-mel features at config 2's STFT settings,
    computed on the card and normalized by the corpus's own mean and std."""
    d = cfg.data
    wavs = [synth_utterance(seed + 100 + i, d.sample_rate, TRAIN_SECONDS)
            for i in range(TRAIN_UTTS)]
    with torch.no_grad():
        mel = log_mel_spectrogram(
            torch.from_numpy(np.stack(wavs)).cuda(), d.sample_rate, d.n_fft,
            d.hop_length, d.win_length, d.n_mels, d.fmin, d.fmax)
    mel = mel[:, : len(wavs[0]) // d.hop_length].cpu().numpy()
    mean, std = mel.mean(axis=(0, 1)), mel.std(axis=(0, 1))
    feats = (mel - mean) / np.maximum(std, 1e-8)
    require(bool(np.isfinite(feats).all()), "corpus features finite")
    return [Utterance(w, f) for w, f in zip(wavs, feats)]


def segment_sampler(cfg, utts, seed: int, batch: int | None = None):
    d = cfg.data
    return SegmentSampler(utts, batch_size=batch or d.batch_size,
                          segment_length=d.segment_length,
                          hop_length=d.hop_length,
                          receptive_field=cfg.model.receptive_field,
                          seed=seed, silence_boost=d.silence_boost)


def leaf_errors(want: dict, got: dict) -> dict:
    """{leaf: max |got - want| / max |want|} of two flat parameter trees;
    a leaf whose reference is zero must be zero on both sides (0.0), or
    reads inf."""
    out = {}
    for k, w in want.items():
        scale = float(np.abs(w).max())
        diff = float(np.abs(got[k] - w).max())
        out[k] = diff / scale if scale else (0.0 if diff == 0 else np.inf)
    return out


def phase_train(cfg, seed: int, smi: str) -> None:
    """Config 2 training at full width on the card (A7): the first step
    against the CPU, fp32 and bf16 compute; Trainer.fit for TRAIN_STEPS
    updates at steps_per_call = 8 with its checkpoints and eval loss; ms
    per update at K = 8 and K = 1 and the device's busy share; resume from
    the step-TRAIN_RESUME_AT checkpoint; the trained weights decoded
    through `--workdir`'s loader on the cluster kernel."""
    mc, d = cfg.model, cfg.data
    utts = corpus(cfg, seed)
    pad = -(-mc.receptive_field // d.hop_length) * d.hop_length
    B, T = d.batch_size, pad + d.segment_length
    checks, readings = [], {}

    def record(name, err, limit):
        checks.append({"check": name, "max_abs_err": err, "limit": limit,
                       "ok": err <= limit})

    # the card's first step against the CPU's, one tree, one batch
    batch = next(segment_sampler(cfg, utts, seed + 1, TRAIN_CHECK_B))
    tree = random_tree(mc, seed)
    for dtype, tol, tol_loss in (
            ("bfloat16", TOL_TRAIN_BF16, TOL_TRAIN_BF16_LOSS),
            ("float32", TOL_TRAIN_FP32, TOL_TRAIN_FP32)):
        c = dataclasses.replace(cfg, model=dataclasses.replace(
            mc, compute_dtype=dtype))
        sides = {}
        for dev in ("cuda", "cpu"):
            tr = Trainer(c, dev)
            loss, grad = tr.value_and_grad(tr.init_state(tree=tree), batch)
            sides[dev] = (float(loss), _flatten(tr.params_tree(grad)))
        errs = leaf_errors(sides["cpu"][1], sides["cuda"][1])
        worst = max(errs, key=errs.get)
        rel = abs(sides["cuda"][0] - sides["cpu"][0]) / abs(sides["cpu"][0])
        record(f"{dtype}_first_step_loss_rel", rel, tol_loss)
        record(f"{dtype}_first_step_grad_rel", errs[worst], tol)
        readings[f"{dtype}_worst_leaf"] = worst
        readings[f"{dtype}_loss"] = sides["cuda"][0]

    # Trainer.fit, config 2 as preset (steps_per_call = 8)
    tcfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, checkpoint_every=TRAIN_RESUME_AT, log_every=8))
    K = tcfg.train.steps_per_call
    trainer = Trainer(tcfg)
    eval_batches = [next(segment_sampler(cfg, utts, 12345))
                    for _ in range(2)]
    state0 = trainer.init_state(seed)
    eval0 = trainer.eval_loss(state0, eval_batches)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = trainer.fit(state0, segment_sampler(cfg, utts, seed),
                            workdir, steps=TRAIN_STEPS,
                            eval_batches=eval_batches)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        recs = [json.loads(line) for line in
                (workdir / "metrics.jsonl").read_text().splitlines()]
        require(state.step == TRAIN_STEPS
                and [r["step"] for r in recs]
                == list(range(8, TRAIN_STEPS + 1, 8)),
                f"fit's steps and records: {[r['step'] for r in recs]}")
        require(all(np.isfinite([r["loss"], r["grad_norm"]]).all()
                    for r in recs), "fit's losses finite")
        evals = [eval0] + [r["eval_loss"] for r in recs if "eval_loss" in r]
        require(len(evals) == 3, f"eval at 0 and both checkpoints: {evals}")
        checks.append({"check": "loss_falls", "eval_loss": evals,
                        "loss": [recs[0]["loss"], recs[-1]["loss"]],
                        "ok": evals[-1] < evals[0]
                        and recs[-1]["loss"] < recs[0]["loss"]})
        require(sorted(int(p.name) for p in
                       (workdir / "checkpoints").iterdir())
                == [TRAIN_RESUME_AT, TRAIN_STEPS],
                "a checkpoint at each of the two")

        # ms per update: K = 8 groups already on the card, CUDA events
        # around multi_step after one warm-up group; then K = 1
        src = segment_sampler(cfg, utts, seed + 2)
        groups = [trainer.to_device(next(GroupSampler(src, K)))
                  for _ in range(1 + TRAIN_TIME_GROUPS)]
        singles = [trainer.to_device(next(src))
                   for _ in range(1 + TRAIN_K1_STEPS)]
        s, _ = trainer.multi_step(state, groups[0])
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        h0 = time.perf_counter()
        start.record()
        for g in groups[1:]:
            s, _ = trainer.multi_step(s, g)
        end.record()
        torch.cuda.synchronize()
        k8_host = 1e3 * (time.perf_counter() - h0) / (TRAIN_TIME_GROUPS * K)
        k8 = start.elapsed_time(end) / (TRAIN_TIME_GROUPS * K)
        s, _ = trainer.step(s, singles[0])
        torch.cuda.synchronize()
        start.record()
        for b in singles[1:]:
            s, _ = trainer.step(s, b)
        end.record()
        torch.cuda.synchronize()
        k1 = start.elapsed_time(end) / TRAIN_K1_STEPS
        # kernels per update and their summed device time over one group
        # (torch.profiler), against the unprofiled group's time: the share
        # of the update the device is busy
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            s, _ = trainer.multi_step(s, groups[1])
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / K
        launches = sum(e.count for e in kern) / K
        flops = yardstick.train_flops(dataclasses.asdict(mc), B, T)
        bound32, bound16 = 1e3 * flops / yardstick.PEAK_FP32_FLOPS, \
            1e3 * flops / yardstick.PEAK_BF16_FLOPS

        # resume from the step-32 checkpoint in a workdir of its own: the
        # next group draws the straight run's batches 33..40
        resume_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_resume_"))
        try:
            shutil.copytree(workdir / "checkpoints" / str(TRAIN_RESUME_AT),
                            resume_dir / "checkpoints" / str(TRAIN_RESUME_AT))
            tr2 = Trainer(tcfg)
            st2, sampler_state, step = tr2.restore(resume_dir,
                                                   tr2.init_state(seed + 9))
        finally:
            shutil.rmtree(resume_dir)
        require(step == st2.step == TRAIN_RESUME_AT and sampler_state,
                f"restored step {step}")
        resumed = segment_sampler(cfg, utts, seed + 7)
        resumed.set_state(sampler_state)
        got = next(GroupSampler(resumed, K))
        straight = segment_sampler(cfg, utts, seed)
        want = [next(straight) for _ in range(TRAIN_RESUME_AT + K)]
        same = all(np.array_equal(got[k][i], want[TRAIN_RESUME_AT + i][k])
                   for k in ("x", "cond") for i in range(K))
        checks.append({"check": "resume_draws_the_straight_batches",
                        "steps": [TRAIN_RESUME_AT + 1, TRAIN_RESUME_AT + K],
                        "ok": same})
        # and trains on as the straight run did: the update is
        # deterministic on the card, so the group's last loss is the
        # straight run's record at that step, to the bit
        st2, ms = tr2.multi_step(st2, got)
        rec = next(r for r in recs if r["step"] == TRAIN_RESUME_AT + K)
        record("resumed_loss_vs_straight",
               abs(float(ms["loss"][-1]) - rec["loss"]), 0.0)

        # the trained weights through --workdir's loader, decoded on the
        # layout the decode picks (the cluster kernel)
        model, mstep = decode.load_model_state(cfg, str(workdir))
    finally:
        shutil.rmtree(workdir)
    require(mstep == TRAIN_STEPS, f"decode loaded step {mstep}")
    layout = ar_kernel.choose_layout(mc, "auto")
    name = layout.name
    dutts = [Utterance(np.zeros(0, np.float32), u.feats)
             for u in utts[:TRAIN_DECODE_UTTS]]
    with tempfile.TemporaryDirectory() as out:
        ar_kernel.launches.clear()
        summary = decode.decode_utterances(
            model, cfg, dutts, [f"utt{i}.wav" for i in range(len(dutts))],
            out, torch.Generator(device="cuda").manual_seed(seed),
            model_step=mstep)
        launched = dict(ar_kernel.launches)
    require(set(launched) == {name} and launched[name] == 1
            and summary["kernel"] == dataclasses.asdict(layout)
            and layout.cluster > 1,
            f"the trained decode launched {launched} on {summary['kernel']}")
    cond, _, _ = pad_batch_for_decode(dutts, d.hop_length)
    pp = extract_plain_params(model)
    with torch.no_grad():
        c_up = model.upsample_cond(torch.from_numpy(cond).cuda())
    noise = ar_kernel.uniform_noise(
        c_up.shape[:2], torch.Generator(device="cuda").manual_seed(seed))
    out = ar_kernel.generate(pp, mc, c_up, noise=noise, layout=layout)
    require(bool(torch.isfinite(out).all()), "trained decode finite")
    Tp = TRAIN_DECODE_T
    plain = plain_version(
        pp, mc, c_up[:, :Tp].contiguous(), noise=noise[:, :Tp].contiguous(),
        teacher=own_feedback(out)[:, :Tp])
    record(f"trained_kernel_vs_plain_teacher_forced_{Tp}",
           err(plain, out[:, :Tp]), TOL_TEACHER)

    samples = B * T
    emit("train", config=cfg.name, compute_dtype=mc.compute_dtype, B=B,
         T=T, corpus_utterances=len(utts), corpus_seconds=TRAIN_SECONDS,
         steps=TRAIN_STEPS, steps_per_call=K,
         params=int(state0.params.numel()),
         loss_first=recs[0]["loss"], loss_last=recs[-1]["loss"],
         losses=[r["loss"] for r in recs], eval_loss=evals,
         fit_seconds=fit_s, fit_samples_per_s=recs[-1]["samples_per_s"],
         ms_per_update_k8=k8, host_ms_per_update_k8=k8_host,
         samples_per_s_k8=1e3 * samples / k8,
         ms_per_update_k1=k1, samples_per_s_k1=1e3 * samples / k1,
         k1_over_k8=k1 / k8, peak_memory_bytes=peak,
         device_busy_ms_per_update=busy_ms if busy_ms else "not measured",
         device_busy_share=busy_ms / k8 if busy_ms else "not measured",
         kernels_per_update=launches, gflop_per_update=flops / 1e9,
         bound_ms_fp32=bound32, bound_ms_bf16_tensor_cores=bound16,
         decode={"variant": name, "kernel": layout,
                 "launches": launched[name], "rtf": summary["rtf"],
                 "wall_seconds": summary["wall_seconds"],
                 "model_step": summary["model_step"]},
         checks=checks, readings=readings, card=smi)
    for c in checks:
        require(c["ok"], f"train: {c}")


def trace_kernels(trace: Path, symbol: str) -> dict:
    """{"events": the kernel events of a torch.profiler trace, "matching":
    {name: count} of those whose name holds `symbol`, "categories": every
    event's count by category}."""
    events = json.loads(trace.read_text())["traceEvents"]
    cats, named = {}, {}
    for e in events:
        cat = e.get("cat", "")
        cats[cat] = cats.get(cat, 0) + 1
        if cat == "kernel" and symbol in e.get("name", ""):
            named[e["name"]] = named.get(e["name"], 0) + 1
    return {"events": cats.get("kernel", 0), "matching": named,
            "categories": cats}


def one_trace(directory: Path) -> Path:
    traces = sorted(Path(directory).glob("*.pt.trace.json"))
    require(len(traces) == 1, f"one profiler trace in {directory}: {traces}")
    return traces[0]


def write_corpus(cfg, utts, root: Path) -> list:
    """The in-memory corpus as bin.train reads it: wavs, a list, and each
    utterance's (already normalized) features as <stem>.h5."""
    names = []
    for i, u in enumerate(utts):
        wav = root / f"utt{i}.wav"
        write_wav(wav, u.wav, cfg.data.sample_rate)
        hdf5_io.write_hdf5(root / "feats" / f"utt{i}.h5", "feats", u.feats)
        names.append(str(wav))
    (root / "train.scp").write_text("".join(n + "\n" for n in names))
    return ["--train-scp", str(root / "train.scp"), "--feats-dir",
            str(root / "feats")]


def phase_observe(cfg, model, seed: int, smi: str) -> int:
    """Observability at config 2 (utils/observability.py): decode
    --profile on the cluster kernel, its trace read for the kernel's
    events and the profiler's cost on the RTF in turns; bin.train
    --profile --debug-nans against the same run without the flags, to the
    bit, with the trace; debug mode's cost per update in turns; a NaN
    batch raising FloatingPointError at its update for K = 1 and K = 8;
    whether TensorBoard scalars are written on this host."""
    mc, hop = cfg.model, cfg.data.hop_length
    layout = ar_kernel.choose_layout(mc, "auto")
    name = layout.name
    _, utts = utterances(mc, seed + 7, 75, 150)
    utts = utts[:OBSERVE_UTTS]
    names = [f"utt{i}.wav" for i in range(len(utts))]
    checks, decodes, traces, launches = [], [], [], 0

    def check(what, ok, **kw):
        checks.append({"check": what, "ok": bool(ok), **kw})

    # decode --profile: the profiler off and on in turns (off, on, on, off)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_observe_"))
    try:
        for i, profile in enumerate((False, True, True, False)):
            out = root / f"decode{i}"
            ar_kernel.launches.clear()
            summary = decode.decode_utterances(
                model, cfg, utts, names, out,
                torch.Generator(device="cuda").manual_seed(seed),
                batch_size=8, profile=profile)
            launched = dict(ar_kernel.launches)
            require(set(launched) == {name} and launched[name] == 1,
                    f"observe decode {i} launched {launched}")
            launches += launched[name]
            decodes.append({"profile": profile, "rtf": summary["rtf"],
                            "wall_seconds": summary["wall_seconds"]})
            if profile:
                trace = one_trace(out / "profile")
                found = trace_kernels(trace, "ar_cluster_kernel")
                found["bytes"] = trace.stat().st_size
                traces.append(found)
                check(f"decode_trace_{i}_holds_the_cluster_kernel",
                      sum(found["matching"].values()) >= 1,
                      batches=1, launches=launched[name],
                      matching=found["matching"],
                      kernel_events=found["events"])
            else:
                require(not (out / "profile").exists(), "no trace unasked")
        same = all((root / "decode0" / n).read_bytes()
                   == (root / f"decode{i}" / n).read_bytes()
                   for i in (1, 2, 3) for n in names)
        check("decode_wavs_equal_with_and_without_profile", same)
        off = [d["rtf"] for d in decodes if not d["profile"]]
        on = [d["rtf"] for d in decodes if d["profile"]]

        # bin.train --profile --debug-nans against the same run without
        # the flags, on the train phase's corpus
        tutts = corpus(cfg, seed)
        data = write_corpus(cfg, tutts, root / "corpus")
        common = ["--preset", cfg.name, *data, "--steps",
                  str(OBSERVE_STEPS)]
        over = ["train.log_every=8", f"train.checkpoint_every={OBSERVE_STEPS}"]
        runs = {}
        for key, flags in (("plain", []),
                           ("profile_debug", ["--profile", "--debug-nans"])):
            wd = root / key
            t0 = time.perf_counter()
            train_cli.main(common + ["--workdir", str(wd), *flags, *over])
            torch.cuda.synchronize()
            runs[key] = {
                "seconds": time.perf_counter() - t0,
                "records": [json.loads(line) for line in
                            (wd / "metrics.jsonl").read_text().splitlines()]}
        require(not torch.is_anomaly_enabled(), "bin.train left debug off")
        a, b = (runs[k]["records"] for k in ("plain", "profile_debug"))
        check("train_losses_equal_to_the_bit_with_profile_and_debug_nans",
              [(r["step"], r["loss"], r["grad_norm"]) for r in a]
              == [(r["step"], r["loss"], r["grad_norm"]) for r in b]
              and [r["step"] for r in a] == [8, OBSERVE_STEPS],
              losses=[r["loss"] for r in b])
        # the trace of 16 updates under anomaly mode is some 240 MB: its
        # size is read, not its events
        trace_bytes = one_trace(root / "profile_debug" / "profile"
                                ).stat().st_size
        check("train_trace_written", trace_bytes > 0, bytes=trace_bytes)
        tb_files = sorted(p.name for p in (root / "plain" / "tb").glob("*")) \
            if (root / "plain" / "tb").is_dir() else []
        writer_live = MetricsWriter(root / "tb_probe").live
        check("tensorboard_files_as_the_writer_says",
              bool(tb_files) == writer_live, files=tb_files)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # debug mode's cost per update, in turns (off, on, on, off), and a NaN
    # batch raising at its update for K = 1 and K = 8
    trainer = Trainer(cfg)
    K = cfg.train.steps_per_call
    src = segment_sampler(cfg, tutts, seed + 3)
    group = trainer.to_device(next(GroupSampler(src, K)))
    state = trainer.init_state(seed)
    state, _ = trainer.multi_step(state, group)          # warm-up
    batch = {k: v[0] for k, v in group.items()}
    per_update = {"off": [], "on": []}
    try:
        for debug in (False, True, True, False):
            (enable_debug_mode if debug else disable_debug_mode)()
            _, ms = host_ms(lambda: [trainer.step(state, batch)
                                     for _ in range(OBSERVE_TURN_UPDATES)])
            per_update["on" if debug else "off"].append(
                ms / OBSERVE_TURN_UPDATES)
        enable_debug_mode()
        for k in (1, K):
            bad = {kk: v[:k].clone() for kk, v in group.items()}
            at = min(OBSERVE_NAN_AT, k)
            bad["x"][at - 1, 0, 5] = float("nan")
            try:
                if k == 1:
                    trainer.step(state, {kk: v[0] for kk, v in bad.items()})
                else:
                    trainer.multi_step(state, bad)
                raised = "nothing"
            except FloatingPointError as e:
                raised = str(e)
            check(f"nan_batch_raises_at_its_update_k{k}",
                  raised.endswith(f"loss at update {state.step + at}"),
                  raised=raised)
    finally:
        disable_debug_mode()
    require(not torch.is_anomaly_enabled(), "debug mode off")
    emit("observe", config=cfg.name, variant=name, kernel=layout,
         decode_utterances=len(utts), decodes=decodes,
         rtf_profile_off=off, rtf_profile_on=on,
         profiler_rtf_ratio=(sum(on) / len(on)) / (sum(off) / len(off)),
         decode_traces=traces,
         train_seconds={k: v["seconds"] for k, v in runs.items()},
         train_trace_bytes=trace_bytes,
         ms_per_update_debug_off=per_update["off"],
         ms_per_update_debug_on=per_update["on"],
         debug_ratio=(sum(per_update["on"]) / sum(per_update["off"])),
         metrics_writer_live=writer_live, checks=checks, card=smi)
    for c in checks:
        require(c["ok"], f"observe: {c}")
    return launches


class LogLines(logging.Handler):
    """Every message logged to one logger, kept."""

    def __init__(self, name: str):
        super().__init__(logging.INFO)
        self.lines, self.logger = [], logging.getLogger(name)

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.logger.addHandler(self)
        self.logger.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self)


def world_pitch(wdw: Path, root: Path, seed: int, record) -> dict:
    """The world branch's pitch checks at deep_baseline, on its stage-0..2
    corpus: decode --f0-factor of one eval utterance cut to
    PITCH_DECODE_S on the decode's layout (the cluster kernel), its
    conditioning's lf0 moved by ln(factor) on voiced frames alone, and its
    wavs those of a decode of the features shift_f0 moved; the transposed
    oracle (bin.pitch_eval) at PITCH_FACTORS on each eval utterance's
    envelope-smoothed features with pulse-only voiced excitation, its
    per-frame ratio within TOL_PITCH of the factor (the tool's own,
    noise-mixed oracle read beside it); bin.as_oracle on each eval
    utterance, card against CPU. Returns the readings (the decode's
    launches under "launches")."""
    dcfg = get_config("deep_baseline")
    d, mc = dcfg.data, dcfg.model
    sr, hop = d.sample_rate, d.hop_length
    stats = wdw / "stats.h5"
    evals = read_file_list(wdw / "corpus/eval.scp")
    out = root / "pitch"
    layout = ar_kernel.choose_layout(mc, "auto")
    name = layout.name
    readings = {"variant": name, "kernel": layout}

    # decode --f0-factor of the first eval utterance, cut
    stem = Path(evals[0]).stem
    frames = int(PITCH_DECODE_S * sr) // hop
    raw = hdf5_io.read_hdf5(wdw / "feats" / f"{stem}.h5", "feats")[:frames]
    hdf5_io.write_hdf5(out / "feats" / f"{stem}.h5", "feats", raw)
    (out / "eval.scp").write_text(evals[0] + "\n")
    tree = random_tree(mc, seed)
    save_params_npz(out / "params.npz", tree)
    ar_kernel.launches.clear()
    t0 = time.perf_counter()
    decode.main(["--preset", dcfg.name, "--eval-scp", str(out / "eval.scp"),
                 "--feats-dir", str(out / "feats"), "--stats", str(stats),
                 "--params", str(out / "params.npz"), "--outdir",
                 str(out / "up"), "--seed", str(seed), "--f0-factor",
                 str(PITCH_FACTOR)])
    readings["decode_seconds"] = time.perf_counter() - t0
    launched = dict(ar_kernel.launches)
    require(set(launched) == {name} and launched[name] == 1
            and layout.cluster > 1,
            f"decode --f0-factor launched {launched} on {layout}")
    readings["launches"] = launched[name]
    utts = load_utterances(out / "eval.scp", out / "feats", stats,
                           load_wav=False)
    norm = utts[0].feats.copy()
    decode.shift_f0(utts, dcfg, stats, PITCH_FACTOR)
    mean, std = load_stats(stats)
    lf0 = utts[0].feats[:, 0] * max(std[0], 1e-8) + mean[0]
    voiced = raw[:, 1] > 0.5
    require(voiced.any(), "voiced frames in the cut utterance")
    record("f0_factor_voiced_lf0_moved_by_ln_factor",
           float(np.abs(lf0[voiced] - raw[voiced, 0]
                        - np.log(PITCH_FACTOR)).max()), TOL_LF0,
           voiced_frames=int(voiced.sum()), frames=int(frames))
    record("f0_factor_unvoiced_lf0_untouched",
           float(np.abs(lf0[~voiced] - raw[~voiced, 0]).max())
           if (~voiced).any() else 0.0, TOL_LF0)
    record("f0_factor_other_columns_unchanged",
           float(np.abs(utts[0].feats[:, 1:] - norm[:, 1:]).max()), 0.0)
    decode.decode_utterances(
        params_from_flax(WaveNet(mc), tree).cuda(), dcfg, utts,
        [Path(evals[0]).name], out / "lib",
        torch.Generator(device="cuda").manual_seed(seed))
    wav_name = Path(evals[0]).name
    record("f0_factor_decode_equals_decode_of_shifted_features",
           0.0 if (out / "up" / wav_name).read_bytes()
           == (out / "lib" / wav_name).read_bytes() else 1.0, 0.0)
    gen = read_wav(out / "up" / wav_name)[0]
    readings["generated_ratio_random_weights"] = pitch_eval.frame_ratio(
        gen, raw[:, 0], raw[:, 1], sr, hop, device="cuda")

    # the transposed oracle (bin.pitch_eval) on the envelope-smoothed
    # features of each eval utterance's first PITCH_ORACLE_S. Held: with
    # the voiced frames' aperiodicity zeroed (pulse-only voiced excitation,
    # bin.as_oracle's det=1), its per-frame ratio within TOL_PITCH of the
    # factor. The tool's own oracle mixes noise into voiced frames by their
    # aperiodicity; on this corpus its F0 reading then depends on the
    # noise draw (octave errors, with the JAX tool's own draw too; ROADMAP
    # C5), so it is read on the first utterance at PITCH_FACTOR and
    # not held
    smooth = get_config("deep_baseline", ["data.envelope_smoothing=true"])
    n_or = int(PITCH_ORACLE_S * sr) // hop
    b0 = 2 + smooth.noise_shaping.mcep_order + 1
    readings["oracle_pulse_excitation"], readings["oracle_as_tool"] = {}, {}
    t0 = time.perf_counter()
    for i, w in enumerate(evals):
        feats = feature_extract.extract_one(w, smooth, device="cuda")[:n_or]
        det = feats.copy()
        det[:, b0:b0 + smooth.data.n_bap] = 0.0
        for f in PITCH_FACTORS:
            for key, fe in (("oracle_pulse_excitation", det),
                            ("oracle_as_tool", feats)):
                if key == "oracle_as_tool" and (i or f != PITCH_FACTOR):
                    continue
                oracle = pitch_eval.transposed_oracle(
                    fe, smooth, f, n_or * hop, seed=seed, device="cuda")
                r, nf = pitch_eval.frame_ratio(
                    oracle, feats[:, 0], feats[:, 1], sr, hop,
                    device="cuda")
                readings[key][f"{Path(w).name}@{f}"] = [r, nf]
            r, nf = readings["oracle_pulse_excitation"][f"{Path(w).name}@{f}"]
            record(f"transposed_oracle_ratio_{Path(w).stem}_{f}",
                   abs(r / f - 1) if r else float("inf"), TOL_PITCH,
                   ratio=r, common_frames=nf)
    readings["oracle_seconds"] = time.perf_counter() - t0

    # bin.as_oracle on each eval utterance, cut: card against CPU on one
    # noise draw
    ocfg = as_oracle.oracle_config(sr)
    readings["as_oracle"] = {}
    t0 = time.perf_counter()
    for w in evals:
        cut = out / "oracle" / Path(w).name
        write_wav(cut, read_wav(w)[0][: n_or * hop], sr)

        def noise(n):
            return torch.randn(n, generator=torch.Generator().manual_seed(
                seed))

        rows = {dev: as_oracle.oracle_row(str(cut), ocfg, noise=noise,
                                          device=dev)
                for dev in ("cuda", "cpu")}
        readings["as_oracle"][Path(w).name] = {
            dev: {k: r[k] for k in ("mcd_db", "f0_rmse_hz",
                                    "vuv_error_rate", "lsd_db")}
            for dev, r in rows.items()}
        record(f"as_oracle_mcd_card_vs_cpu_{Path(w).stem}",
               abs(rows["cuda"]["mcd_db"] - rows["cpu"]["mcd_db"]),
               TOL_EVAL_DB, mcd_db=rows["cuda"]["mcd_db"])
    readings["as_oracle_seconds"] = time.perf_counter() - t0
    return readings


def phase_recipe(seed: int, smi: str) -> int:
    """Config 3 (shallow_laplace_ns) through the port's recipe runner,
    bin.run stages 0-6, each stage its own call and wall time, on the
    card, then the world branch's stages 0-2 at deep_baseline. Returns the
    decode's launches of the cluster kernel."""
    cfg = get_config("shallow_laplace_ns")
    mc, d, ns = cfg.model, cfg.data, cfg.noise_shaping
    checks, times = [], {}

    def record(name, e, limit, **kw):
        checks.append({"check": name, "max_abs_err": e, "limit": limit,
                       "ok": e <= limit, **kw})

    def run_stage(key, wd, n, preset="shallow_laplace_ns"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recipe.main(["--preset", preset, "--workdir", str(wd), "--stage",
                     str(n), "--stop-stage", str(n), "--corpus-seed",
                     str(1234 + seed), *RECIPE_ARGS])
        torch.cuda.synchronize()
        times[key] = time.perf_counter() - t0

    def feats_of(directory):
        return {p.name: hdf5_io.read_hdf5(p, "feats")
                for p in sorted(Path(directory).glob("*.h5"))}

    def pooled(wd, preset, out):
        """Both splits' features from one pool of CPU workers."""
        both = out.with_suffix(".scp")
        both.write_text((wd / "corpus/train.scp").read_text()
                        + (wd / "corpus/eval.scp").read_text())
        feature_extract.main(["--wav-scp", str(both), "--outdir", str(out),
                              "--num-workers", str(RECIPE_WORKERS),
                              "--preset", preset])
        return feats_of(out)

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_recipe_"))
    try:
        wd = root / "config3"
        run_stage("stage0", wd, 0)
        train = read_file_list(wd / "corpus/train.scp")
        evals = read_file_list(wd / "corpus/eval.scp")
        audio_s = sum(read_wav(w)[0].size for w in train + evals) / d.sample_rate
        # stage 1: the torch log-mel on the card against the pooled numpy
        # path on the same wavs
        run_stage("stage1", wd, 1)
        card = feats_of(wd / "feats")
        listed = sorted(tuple(hdf5_io.list_hdf5(p))
                        for p in (wd / "feats").glob("*.h5"))
        require(len(card) == len(train) + len(evals)
                and set(listed) == {("feats",)},
                f"stage 1 wrote {len(card)} files, datasets {set(listed)}")
        pool = pooled(wd, "shallow_laplace_ns", root / "pool3")
        require(sorted(pool) == sorted(card), "pooled files")
        record("stage1_log_mel_card_vs_numpy_pool",
               max(float(np.abs(card[k] - pool[k]).max()) for k in card),
               TOL_MEL_POOL)
        # stage 2: mean and std against a float64 numpy recomputation;
        # avg_mcep on the card against the native analysis
        run_stage("stage2", wd, 2)
        stats = wd / "stats.h5"
        f = np.concatenate([card[Path(w).stem + ".h5"] for w in train]
                           ).astype(np.float64)
        mean = f.mean(axis=0)
        std = np.sqrt(np.maximum((f ** 2).mean(axis=0) - mean ** 2, 1e-12))
        for k, want in (("mean", mean), ("std", std)):
            got = hdf5_io.read_hdf5(stats, k)
            record(f"stage2_{k}_vs_float64_numpy",
                   float(np.abs(got - want.astype(np.float32)).max()), 1e-6)
        tot, cnt = 0.0, 0
        for w in train:
            m = native.mcep_native(read_wav(w, target_sr=d.sample_rate)[0],
                                   d.n_fft, d.hop_length, d.win_length,
                                   ns.mcep_order, ns.alpha)
            tot, cnt = tot + m.sum(axis=0), cnt + m.shape[0]
        record("stage2_avg_mcep_card_vs_native",
               float(np.abs(hdf5_io.read_hdf5(stats, "avg_mcep")
                            - tot / cnt).max()), TOL_MCEP_NATIVE)
        # stage 3: the native filter ran; it against the plain recursion on
        # the card on an excerpt, and the de-emphasis of a shaped wav
        with LogLines("noise_shaping") as lines:
            run_stage("stage3", wd, 3)
        ran = [m for m in lines.lines if m.startswith("filtering on")]
        require(ran and all("native" in m for m in ran),
                f"stage 3 ran the native filter: {ran}")
        b = shaping.shaping_coefficients(str(stats), ns.mag, ns.alpha)
        x = read_wav(train[0], target_sr=d.sample_rate)[0]
        for inverse in (False, True):
            got = native.mlsa_filter_native(x[:RECIPE_EXCERPT], b, ns.alpha,
                                            ns.pade_order, inverse)
            plain = plain_time(
                "ops.mlsa.mlsa_filter, eager on the card", mlsa.mlsa_filter,
                torch.from_numpy(x[:RECIPE_EXCERPT]).cuda(),
                torch.tensor(b, dtype=torch.float32, device="cuda"),
                ns.alpha, ns.pade_order, inverse).cpu().numpy()
            record(f"stage3_native_vs_plain_recursion_on_card"
                   f"{'_inverse' if inverse else ''}_{RECIPE_EXCERPT}",
                   float(np.abs(got - plain).max()), TOL_MLSA)
        shaped = shaping.filter_waveform(x, b, ns.alpha, ns.pade_order, False)
        back = shaping.filter_waveform(shaped, b, ns.alpha, ns.pade_order,
                                       True)
        record("stage3_deemphasis_restores_below_16bit_floor",
               float(np.abs(back - x).max()), FLOOR_16BIT)
        # stage 4: training, two calls of steps_per_call = 8
        run_stage("stage4", wd, 4)
        recs = [json.loads(line) for line in
                (wd / "model/metrics.jsonl").read_text().splitlines()]
        losses = [r["loss"] for r in recs if "loss" in r]
        require(losses and all(np.isfinite(losses))
                and recs[-1]["step"] == RECIPE_STEPS
                and (wd / f"model/checkpoints/{RECIPE_STEPS}").is_dir(),
                f"stage 4: losses {losses}, last record {recs[-1]}")
        # stage 5: the decode on the cluster kernel, then the kernel re-run
        # on its inputs against the plain version, teacher-forced with its
        # own samples
        layout = ar_kernel.choose_layout(mc, "auto")
        name = layout.name
        ar_kernel.launches.clear()
        run_stage("stage5", wd, 5)
        launched = dict(ar_kernel.launches)
        summary = json.loads((wd / "gen_wav/decode_summary.json").read_text())
        require(set(launched) == {name} and launched[name] >= 1
                and summary["kernel"] == dataclasses.asdict(layout)
                and layout.cluster > 1,
                f"stage 5 launched {launched} on {summary['kernel']}")
        model, step = decode.load_model_state(cfg, wd / "model", "cuda")
        require(step == RECIPE_STEPS, f"stage 5 decoded step {step}")
        utts = load_utterances(wd / "corpus/eval.scp", wd / "feats", stats,
                               load_wav=False)
        cond, _, n_samples = pad_batch_for_decode(utts, d.hop_length)
        pp = extract_plain_params(model)
        with torch.no_grad():
            c_up = model.upsample_cond(torch.from_numpy(cond).cuda())
        noise = ar_kernel.uniform_noise(
            c_up.shape[:2], torch.Generator(device="cuda").manual_seed(0))
        out = ar_kernel.generate(pp, mc, c_up, noise=noise, layout=layout)
        wav_err = max(float(np.abs(read_wav(wd / "gen_wav" / Path(w).name)[0]
                                   - out[i, :n_samples[i]].cpu().numpy())
                            .max()) for i, w in enumerate(evals))
        record("stage5_wavs_vs_kernel_rerun", wav_err, 0.5 / 32767 + 1e-7)
        Tp = TRAIN_DECODE_T
        plain = plain_version(
            pp, mc, c_up[:, :Tp].contiguous(),
            noise=noise[:, :Tp].contiguous(),
            teacher=own_feedback(out)[:, :Tp])
        record(f"stage5_kernel_vs_plain_teacher_forced_{Tp}",
               float((plain - out[:, :Tp]).abs().max()), TOL_TEACHER)
        # stage 6: de-emphasis and evaluation; eval_pair on the card
        # against the CPU for one pair
        run_stage("stage6", wd, 6)
        mcd = json.loads((wd / "mcd.json").read_text())
        keys = ("mcd_db", "f0_rmse_hz", "vuv_error_rate", "lsd_db")
        require(all(mcd[k + "_mean"] is not None
                    and np.isfinite(mcd[k + "_mean"]) for k in keys),
                f"stage 6 mcd.json: {mcd}")
        ref = read_wav(evals[0], target_sr=d.sample_rate)[0]
        gen = read_wav(wd / "restored_wav" / Path(evals[0]).name,
                       target_sr=d.sample_rate)[0]
        on_card = mcd_eval.eval_pair(ref, gen, cfg, "cuda")
        on_cpu = mcd_eval.eval_pair(ref, gen, cfg, "cpu")
        for k in ("mcd_db", "lsd_db"):
            record(f"stage6_eval_pair_{k}_card_vs_cpu",
                   abs(on_card[k] - on_cpu[k]), TOL_EVAL_DB)
        record("stage6_eval_pair_vuv_error_rate_card_vs_cpu",
               abs(on_card["vuv_error_rate"] - on_cpu["vuv_error_rate"]),
               TOL_EVAL_VUV)
        for k in ("f0_rmse_hz", "f0_rmse_cents"):
            a, b_ = on_card[k], on_cpu[k]
            require((a is None) == (b_ is None), f"eval_pair {k}: {a}, {b_}")
            if a is not None:
                record(f"stage6_eval_pair_{k}_card_vs_cpu_relative",
                       abs(a - b_) / max(abs(b_), 1e-9), TOL_EVAL_F0_REL)
        # the world branch at deep_baseline: stages 0-2, the torch world
        # features on the card against the native pooled path
        wdw = root / "deep_world"
        for n in (0, 1, 2):
            run_stage(f"world_stage{n}", wdw, n, "deep_baseline")
        card_w = feats_of(wdw / "feats")
        pool_w = pooled(wdw, "deep_baseline", root / "pool_world")
        require(sorted(card_w) == sorted(pool_w) and len(card_w) == 10
                and all(v.shape[1] == 32 for v in card_w.values()),
                "world features: files and feature_dim 32")
        agree = np.concatenate([card_w[k][:, 1] == pool_w[k][:, 1]
                                for k in card_w])
        werr = max(float(np.abs(card_w[k][m] - pool_w[k][m]).max())
                   for k in card_w
                   for m in [card_w[k][:, 1] == pool_w[k][:, 1]])
        record("world_features_card_vs_native_pool_vuv_agreeing", werr,
               TOL_WORLD, vuv_agreement=float(agree.mean()),
               vuv_agreement_min=VUV_AGREE_MIN)
        checks[-1]["ok"] &= float(agree.mean()) >= VUV_AGREE_MIN
        pitch = world_pitch(wdw, root, seed, record)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit("recipe", config=cfg.name, world_config="deep_baseline",
         hdf5="h5py" if hdf5_io._h5py() else "the port's codec (no h5py)",
         stage_seconds=times, seconds=sum(times.values()),
         corpus_audio_seconds=audio_s,
         feature_audio_s_per_s=audio_s / times["stage1"],
         decode={"variant": name, "kernel": layout,
                 "launches": launched[name], "rtf": summary["rtf"],
                 "wall_seconds": summary["wall_seconds"]},
         mcd=({k: mcd[k] for k in mcd if k != "per_utterance"}),
         eval_pair_card=on_card, eval_pair_cpu=on_cpu,
         native_library=str(native.lib_path().name), pitch=pitch,
         checks=checks, card=smi)
    for c in checks:
        require(c["ok"], f"recipe: {c}")
    return launched[name], pitch["launches"]


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_train_dp(cfg, seed: int, smi: str) -> None:
    """Data parallelism (A8) on the one card: an NCCL process group of one
    rank, joined through the launcher's variables as `torchrun` sets them
    (`parallel.init_distributed`), and left after. The DP trainer (its
    update all-reduced through NCCL, which at one rank changes no bit)
    against the plain trainer from one init: `fit` over DP_UPDATES
    updates each, the parameters equal to the bit; ms per update of both
    in DP_ROUNDS rounds of turns (plain, DP, DP, plain) on batches
    already on the card, and the all-reduce alone. Scaling over cards is
    not measured: one card."""
    mc = cfg.model
    utts = corpus(cfg, seed)
    launcher = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port()),
                "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"}
    os.environ.update(launcher)
    try:
        dev = mesh.init_distributed(cfg.mesh)
        backend = torch.distributed.get_backend()
        tcfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, steps_per_call=DP_UPDATES))
        dp, plain = Trainer(tcfg, dev, dp=True), Trainer(tcfg, dev, dp=False)
        require(dp.dp and not plain.dp and mesh.world() == 1,
                "one DP rank beside the plain trainer")
        state0 = plain.init_state(seed)
        ends, recs = {}, {}
        for name, tr in (("plain", plain), ("dp", dp)):
            workdir = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{name}_"))
            try:
                ends[name] = tr.fit(state0, segment_sampler(cfg, utts,
                                                            seed + 3),
                                    workdir, steps=DP_UPDATES)
                recs[name] = (workdir / "metrics.jsonl").read_text()
                require((workdir / "checkpoints" / str(DP_UPDATES)).is_dir(),
                        f"{name} fit's checkpoint")
            finally:
                shutil.rmtree(workdir)
        same = (torch.equal(ends["dp"].params, ends["plain"].params)
                and all(torch.equal(ends["dp"].opt_state[k],
                                    ends["plain"].opt_state[k])
                        for k in ("mu", "nu")))
        losses = [json.loads(r)["loss"] for r in recs["dp"].splitlines()]
        checks = [{"check": "dp_fit_params_equal_plain", "updates":
                   DP_UPDATES, "ok": same},
                  {"check": "dp_records_equal_plain",
                   "ok": [json.loads(r)["loss"] for r in
                          recs["plain"].splitlines()] == losses}]

        # ms per update in turns, on batches already on the card
        src = segment_sampler(cfg, utts, seed + 4)
        batches = [plain.to_device(next(src)) for _ in range(DP_UPDATES)]

        def turn(tr):
            st = state0
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for b in batches:
                st, _ = tr.step(st, b)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / DP_UPDATES

        turn(plain), turn(dp)                        # warm-up
        times = {"plain": [], "dp": []}
        for name in ("plain", "dp", "dp", "plain") * DP_ROUNDS:
            times[name].append(turn(plain if name == "plain" else dp))
        buf = torch.cat([state0.params, torch.zeros(1, device=dev)])
        mesh.all_reduce_mean(buf)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        h0 = time.perf_counter()
        for _ in range(DP_REDUCE_REPS):
            mesh.all_reduce_mean(buf)
        # the host's time to issue them, before waiting for the device
        reduce_host_ms = 1e3 * (time.perf_counter() - h0) / DP_REDUCE_REPS
        end.record()
        torch.cuda.synchronize()
        reduce_ms = start.elapsed_time(end) / DP_REDUCE_REPS
    finally:
        mesh.shutdown()
        for v in launcher:
            os.environ.pop(v, None)
    require(not torch.distributed.is_initialized(), "process group left")
    ms = {k: float(np.median(v)) for k, v in times.items()}
    emit("train_dp", config=cfg.name, backend=backend, world=1,
         device=str(dev), B=cfg.data.batch_size, updates=DP_UPDATES,
         losses=losses, ms_per_update_plain=ms["plain"],
         ms_per_update_dp=ms["dp"], turns=times,
         dp_over_plain=ms["dp"] / ms["plain"],
         dp_faster_pairs=sum(d < p for d, p in zip(times["dp"],
                                                   times["plain"])),
         all_reduce_ms=reduce_ms, all_reduce_host_ms=reduce_host_ms,
         all_reduce_bytes=4 * buf.numel(),
         scaling="not measured: one card on this host "
                 f"(torch.cuda.device_count() = {torch.cuda.device_count()})",
         checks=checks, card=smi)
    for c in checks:
        require(c["ok"], f"train_dp: {c}")


def phase_decode_dp(cfg, model, pp, seed: int, smi: str) -> None:
    """`decode --dp`'s path (A8, A5b): the 8 main-path utterances through
    decode_batch with the rows split by `generate_dp`, once over every
    visible card and once over two shards on cuda:0 (the split and the
    gather on the card), each equal to the single call, to the bit; the
    wall time of each and the launches."""
    mc = cfg.model
    layout = ar_kernel.choose_layout(mc, "auto")
    name = layout.name
    _, utts = utterances(mc, seed + 7, 75, 150)
    runs, outs = {}, {}
    for key, devices in (("single", None),
                         ("all_cards", mesh.dp_devices(cfg.mesh)),
                         ("two_shards_one_card", ["cuda:0", "cuda:0"])):
        ar_kernel.launches.clear()
        outs[key], ms = host_ms(lambda: decode.decode_batch(
            model, cfg, utts,
            generator=torch.Generator(device="cuda").manual_seed(seed),
            layout=layout, devices=devices))
        runs[key] = {"devices": [str(d) for d in devices or ["cuda:0"]],
                     "wall_ms": ms, "launches": dict(ar_kernel.launches)}
    checks = []
    for key in ("all_cards", "two_shards_one_card"):
        e = max(float(np.abs(a - b).max())
                for a, b in zip(outs[key], outs["single"]))
        n_dev = len(runs[key]["devices"])
        checks.append({"check": f"{key}_vs_single", "max_abs_err": e,
                       "limit": 0.0,
                       "ok": e == 0.0 and runs[key]["launches"]
                       == {name: n_dev}})
    emit("decode_dp", config=cfg.name, variant=name, kernel=layout,
         utterances=len(utts), cards=torch.cuda.device_count(), runs=runs,
         checks=checks, card=smi)
    for c in checks:
        require(c["ok"], f"decode_dp: {c}")


class LaunchTimer:
    """CUDA events around every `ar_kernel.generate` call made while it is
    active (the stream pool's launches); `take()` returns their summed
    device time since the last take."""

    def __enter__(self):
        self._orig, self._events = ar_kernel.generate, []

        def timed(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = self._orig(*a, **k)
            ev[1].record()
            self._events.append(ev)
            return out

        ar_kernel.generate = timed
        return self

    def take(self) -> float:
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in self._events)
        self._events = []
        return ms

    def __exit__(self, *exc):
        ar_kernel.generate = self._orig


class HostSplit:
    """Host seconds spent in the stream pool's calls while it is active,
    by kind: `_next_window` (a member's haloed window picked),
    `upsample_windows` (the step's one upsampler call), `_prepare_block`
    (uniforms, their copy, the warm-up's concatenations), `_finish_block`
    (the history's roll); `take()` returns {kind: ms} since the last take.
    No synchronization is added: each is the host's time in the call,
    waits included."""

    KINDS = ("_next_window", "upsample_windows", "_prepare_block",
             "_finish_block")

    def __enter__(self):
        owners = {k: streaming if k == "upsample_windows"
                  else StreamingSynthesizer for k in self.KINDS}
        self._orig = {k: (o, getattr(o, k)) for k, o in owners.items()}
        self._ms = dict.fromkeys(self.KINDS, 0.0)
        for k, (o, f) in self._orig.items():
            setattr(o, k, self._timed(k, f))
        return self

    def _timed(self, kind, f):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return f(*a, **kw)
            finally:
                self._ms[kind] += 1e3 * (time.perf_counter() - t0)
        return timed

    def take(self) -> dict:
        out, self._ms = self._ms, dict.fromkeys(self.KINDS, 0.0)
        return out

    def __exit__(self, *exc):
        for k, (o, f) in self._orig.items():
            setattr(o, k, f)


class WarningCount(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.count = 0

    def emit(self, record):
        self.count += 1


def standalone_stream(pp, model, mc, hop, frames, seed: int) -> np.ndarray:
    """A batch=1 session with `seed`, fed `frames` in STREAM_BLOCK-frame
    pushes, then flushed: the samples a pooled stream must equal."""
    syn = StreamingSynthesizer(pp, model, mc, hop, batch=1,
                               block_frames=STREAM_BLOCK, seed=seed)
    pieces = [syn.push(frames[None, i:i + STREAM_BLOCK])
              for i in range(0, len(frames), STREAM_BLOCK)]
    return np.concatenate(pieces + [syn.flush()], axis=1)[0]


def phase_stream_pool(cfg, model, pp, seed: int, smi: str
                      ) -> tuple[int, int]:
    """The multi-tenant pool (A9) at config 2, fp32 unfused on the
    decode's layout, 80 ms blocks: at 1 and 8 streams, at the card's
    clusters for the layout and at one more (two waves), every stream
    pushed STREAM_BLOCK frames before each step(); per steady step (a
    warm-started block from every stream) wall ms, the launches' CUDA
    event ms, the rest, launches, and the streams' audio-s per wall-s;
    the first, a middle and the last stream equal to standalone sessions
    to the bit; then a staggered open/end scenario, every stream equal to
    its session. Returns the pool's kernel launches and the most it
    launched in one step(), over every count's steps, tails and the
    staggered scenario."""
    mc, hop, sr = cfg.model, cfg.data.hop_length, cfg.data.sample_rate
    layout = ar_kernel.choose_layout(mc, "float32")
    name = layout.name
    warnings = WarningCount()
    logging.getLogger("shallow_wavenet_tpu_torch.models.streaming"
                      ).addHandler(warnings)
    rng = np.random.default_rng(seed + 11)
    probe = StreamPool(pp, model, mc, hop, slots=1,
                       block_frames=STREAM_BLOCK)
    require(probe.layout == layout and layout.fused == 0,
            f"the pool's layout {probe.layout}, the decode's {layout}")
    at_once = probe.clusters_at_once
    counts = sorted({*POOL_STREAMS, at_once, at_once + 1})
    block_s = STREAM_BLOCK * hop / sr
    runs, checks, launches, most = {}, [], 0, 0
    with LaunchTimer() as timer, HostSplit() as split:
        for count in counts:
            frames = rng.standard_normal(
                (count, STREAM_FRAMES, mc.aux_channels)).astype(np.float32)
            pool = StreamPool(pp, model, mc, hop, slots=count,
                              block_frames=STREAM_BLOCK)
            sids = [pool.open(seed=seed + 1000 + i) for i in range(count)]
            got = {sid: [] for sid in sids}
            warned = warnings.count
            ar_kernel.launches.clear()
            steps, splits = [], []
            timer.take()
            for lo in range(0, STREAM_FRAMES, STREAM_BLOCK):
                for i, sid in enumerate(sids):
                    pool.push(sid, frames[i, lo:lo + STREAM_BLOCK])
                d0, u0, w0 = (pool.dispatches, pool.upsample_calls,
                              pool.upsample_windows)
                split.take()
                t0 = time.perf_counter()
                out = pool.step()
                wall = 1e3 * (time.perf_counter() - t0)
                splits.append(split.take())
                steps.append((wall, timer.take(), pool.dispatches - d0,
                              len(out), pool.upsample_calls - u0,
                              pool.upsample_windows - w0))
                for sid, w in out.items():
                    got[sid].append(w)
            for sid in sids:
                pool.end(sid)
            while pool.active:
                d0 = pool.dispatches
                for sid, w in pool.step().items():
                    got[sid].append(w)
                most = max(most, pool.dispatches - d0)
            most = max([most, *(x[2] for x in steps)])
            require(most <= 2, f"at most two launches per step: {most}")
            timer.take()
            launched = dict(ar_kernel.launches)
            launches += launched.get(name, 0)
            require(set(launched) == {name}
                    and launched[name] == pool.dispatches,
                    f"the pool launched {launched}, {pool.dispatches}")
            emitting = [i for i, x in enumerate(steps) if x[3]][1:]
            steady = np.array([steps[i] for i in emitting])
            host = {k.strip("_"): float(np.mean([splits[i][k]
                                                 for i in emitting]))
                    for k in HostSplit.KINDS}
            require(len(steady) and (steady[:, 3] == count).all()
                    and (steady[:, 2] == 1).all(),
                    f"{count} streams: one launch of every stream per step")
            wall, kern = steady[:, 0], steady[:, 1]
            held = sorted({0, count // 2, count - 1})
            errs = {}
            for i in held:
                want = standalone_stream(pp, model, mc, hop, frames[i],
                                         seed + 1000 + i)
                wav = np.concatenate(got[sids[i]])
                errs[i] = (float(np.abs(wav - want).max())
                           if wav.shape == want.shape else float("inf"))
            timer.take()
            checks.append({"check": f"{count}_streams_vs_sessions",
                           "streams": held, "max_abs_err": max(errs.values()),
                           "limit": 0.0,
                           "ok": max(errs.values()) == 0.0})
            checks.append({"check": f"{count}_streams_waves_warning",
                           "warnings": warnings.count - warned,
                           "ok": warnings.count - warned
                           == (1 if count > at_once else 0)})
            runs[str(count)] = {
                "steady_steps": len(steady),
                "step_ms_mean": float(wall.mean()),
                "step_ms_p95": float(np.percentile(wall, 95)),
                "kernel_ms_mean": float(kern.mean()),
                "non_kernel_ms_mean": float((wall - kern).mean()),
                "host_ms_per_step": host,
                "launches_per_step": float(steady[:, 2].mean()),
                "upsample_calls_per_step": float(steady[:, 4].mean()),
                "windows_per_upsample_call": float(
                    steady[:, 5].sum() / steady[:, 4].sum()),
                "audio_s_per_wall_s": float(count * block_s * len(steady)
                                            / (wall.sum() / 1e3)),
                "launches": launched[name]}
            for c in checks[-2:]:
                require(c["ok"], f"stream_pool: {c}")

        # staggered: streams open on their step (or when a slot frees),
        # push a block's frames a step, end after their last frame
        pool = StreamPool(pp, model, mc, hop, slots=POOL_STAGGER_SLOTS,
                          block_frames=STREAM_BLOCK)
        frames = [rng.standard_normal((n, mc.aux_channels)).astype(
            np.float32) for _, n in POOL_STAGGER]
        waiting = list(range(len(POOL_STAGGER)))
        sid_of, pushed, got, per_step = {}, {}, {}, []
        ar_kernel.launches.clear()
        step = 0
        while waiting or pool.active:
            while (waiting and POOL_STAGGER[waiting[0]][0] <= step
                   and pool.free_slots):
                i = waiting.pop(0)
                sid_of[i] = pool.open(seed=seed + 2000 + i)
                pushed[i], got[i] = 0, []
            for i, sid in sid_of.items():
                if sid in pool.active and pushed[i] < len(frames[i]):
                    pool.push(sid, frames[i][pushed[i]:
                                             pushed[i] + STREAM_BLOCK])
                    pushed[i] += STREAM_BLOCK
                    if pushed[i] >= len(frames[i]):
                        pool.end(sid)
            d0 = pool.dispatches
            out = pool.step()
            per_step.append(pool.dispatches - d0)
            for i, sid in sid_of.items():
                if sid in out:
                    got[i].append(out[sid])
            step += 1
            require(step < 200, "the staggered streams end")
        timer.take()
    launches += ar_kernel.launches.get(name, 0)
    most = max([most, *per_step])
    logging.getLogger("shallow_wavenet_tpu_torch.models.streaming"
                      ).removeHandler(warnings)
    serr = max(float(np.abs(np.concatenate(got[i]) - standalone_stream(
        pp, model, mc, hop, frames[i], seed + 2000 + i)).max())
        for i in range(len(frames)))
    checks.append({"check": "staggered_vs_sessions",
                   "streams": len(frames), "max_abs_err": serr,
                   "limit": 0.0, "steps": step,
                   "launches_per_step_max": max(per_step),
                   "steps_with_two_launches": per_step.count(2),
                   "ok": serr == 0.0 and max(per_step) <= 2
                   and per_step.count(2) > 0})
    emit("stream_pool", config=cfg.name, variant=name, kernel=layout,
         block_frames=STREAM_BLOCK, frames=STREAM_FRAMES, hop=hop,
         block_ms=1e3 * block_s, warmup=probe.M, clusters_at_once=at_once,
         runs=runs, launches=launches, launches_per_step_max=most,
         checks=checks, card=smi)
    for c in checks:
        require(c["ok"], f"stream_pool: {c}")
    require(most <= 2, f"at most two launches per step: {most}")
    return launches, most


def cluster_fits(mc, dtype: str, fused: int, limit: int):
    """Occupancy and bytes of the cluster kernel for every size of
    CLUSTER_N, weights resident and streamed ({N: {...}}), and the
    (N, from L2) pairs whose block fits with a cluster resident."""
    occ, fits = {}, []
    for size in CLUSTER_N:
        occ[size] = {}
        for l2, key in ((False, "smem"), (True, "l2")):
            lay = ar_kernel.Layout(dtype, fused, size, resident=not l2)
            try:
                b = ar_kernel.cluster_smem_bytes(mc, lay)
            except ValueError as e:
                occ[size] = {"refused": str(e)}
                break
            occ[size][f"{key}_bytes"] = b
            active = (ar_kernel.clusters_at_once(mc, lay, "cuda")
                      if b <= limit else None)
            occ[size][f"{key}_clusters"] = active
            if active:
                fits.append((size, l2))
    return occ, fits


def cluster_lengths(mc, model, pp, tag: str, dtypes=("float32",)
                    ) -> tuple[list, dict]:
    """The cluster kernel on rows of their own lengths (LENGTHS_FRAMES x
    hop), each of `dtypes`, unfused and fused=FUSED, on the decode's
    layout: the checks that each row equals the padded launch's to the bit
    within its length and is 0 past it, and {<dtype>_fused<W>: {"padded":
    [ms, ms], "lengths": [ms, ms]}}, whole calls timed in turns."""
    hop = int(np.prod(mc.upsample_factors))
    lengths = [f * hop for f in LENGTHS_FRAMES]
    B, T = len(lengths), max(lengths)
    c = random_cond(mc, model, B, T, 29)
    u = ar_kernel.uniform_noise(
        (B, T), torch.Generator(device="cuda").manual_seed(29))
    checks, ms = [], {}
    for dtype in dtypes:
        for W in (0, FUSED):
            lay = ar_kernel.choose_layout(mc, dtype, fused=W)
            w = ar_kernel.kernel_weights(pp, mc, lay, "cuda")
            outs, t = {}, {"padded": [], "lengths": []}
            for k in ("padded", "lengths", "lengths", "padded"):
                lens = lengths if k == "lengths" else None
                t[k].append(event_ms(lambda: outs.setdefault(
                    k, ar_kernel.generate(w, mc, c, noise=u, lengths=lens))))
            same = all(torch.equal(outs["lengths"][r, :n],
                                   outs["padded"][r, :n])
                       and not outs["lengths"][r, n:].any()
                       for r, n in enumerate(lengths))
            checks.append({"check": f"{tag}_{dtype}_fused{W}_"
                           f"{lay.name}_lengths_equal_padded",
                           "ok": same})
            ms[f"{dtype}_fused{W}"] = t
    return checks, ms


def cluster_many_rows(mc, model, pp, tag: str) -> dict:
    """One fp32 call of MANY_ROWS rows of random lengths in [1,
    MANY_ROWS_T] on the decode's unfused layout, which the kernel runs as
    two launches (CLUSTER_MAX_ROWS clusters, then one), the rows longest
    first: the check that each row equals the same row of one of two
    single-launch padded calls (the first half of the rows, the rest) to
    the bit within its length and is 0 past it, and that `launches`
    counted the call as two."""
    B, T = MANY_ROWS, MANY_ROWS_T
    c = random_cond(mc, model, B, T, 31)
    u = ar_kernel.uniform_noise(
        (B, T), torch.Generator(device="cuda").manual_seed(31))
    lengths = np.random.default_rng(31).integers(1, T + 1, B).tolist()
    lay = ar_kernel.choose_layout(mc, "float32")
    w = ar_kernel.kernel_weights(pp, mc, lay, "cuda")
    name = lay.name
    before = ar_kernel.launches[name]
    got = ar_kernel.generate(w, mc, c, noise=u, lengths=lengths)
    two = ar_kernel.launches[name] - before
    h = B // 2
    want = torch.cat([ar_kernel.generate(w, mc, c[a:b].contiguous(),
                                         noise=u[a:b].contiguous())
                      for a, b in ((0, h), (h, B))])
    same = all(torch.equal(got[r, :n], want[r, :n]) and not got[r, n:].any()
               for r, n in enumerate(lengths))
    return {"check": f"{tag}_float32_{name}_{B}_rows_equal_padded",
            "ok": same and two == 2, "launches": two}


def phase_cluster(smi: str, regs: dict, models: dict) -> dict:
    """The cluster kernel at config 2 and deep_baseline, fp32 and bf16,
    unfused and with the fused window (see phase 14 above). models:
    {preset: (model config, model, plain params)}. Returns {variant: row}
    for the kernels line, one for each variant held against its plain
    version here."""
    limit = ar_kernel.smem_limit("cuda")
    # the card's property, which the chooser reads, against the limit the
    # kernels' own library reads
    lib_limit = ctypes.c_int(0)
    require(ar_kernel._lib().ar_smem_limit(ctypes.byref(lib_limit)) == 0
            and lib_limit.value == limit,
            f"shared memory limit: torch {limit}, ar_smem_limit "
            f"{lib_limit.value}")
    g = torch.Generator(device="cuda").manual_seed(17)
    ar_kernel.launches.clear()
    runs, checks, checked = {}, [], {}
    for preset, (mc, model, pp) in models.items():
        # one batch of the largest size; the smaller are its first rows
        Bmax = max(CLUSTER_B)
        c_all = random_cond(mc, model, Bmax, CLUSTER_T, 23)
        n_all = ar_kernel.uniform_noise((Bmax, CLUSTER_T), g)
        c1 = c_all[:1, :CLUSTER_CHECK_T].contiguous()
        n1 = n_all[:1, :CLUSTER_CHECK_T].contiguous()
        for dtype in ar_kernel.DTYPES:
            tag = f"{preset}_{dtype}"
            fns, chosen, old, layouts, occs, fitted = {}, {}, {}, {}, {}, {}
            for W in (0, FUSED):
                lay = layouts[W] = ar_kernel.choose_layout(mc, dtype,
                                                           fused=W)
                old[W] = ar_kernel.choose_layout(mc, dtype, fused=W,
                                                 cluster=False)
                require(lay.cluster > 1,
                        f"{tag}: a cluster layout for fused={W}: {lay}")
                chosen[W] = lay.name
                occs[W], fits = cluster_fits(mc, dtype, W, limit)
                fitted[W] = fits
                w_old = ar_kernel.kernel_weights(pp, mc, old[W], "cuda")
                w_new = {size: ar_kernel.kernel_weights(
                    pp, mc, ar_kernel.Layout(dtype, W, size), "cuda")
                         for size in {size for size, _ in fits}}
                # every size and placement that fits, by its `launches`
                # name
                fns[old[W].name] = (
                    lambda c, u, w=w_old: ar_kernel.generate(w, mc, c,
                                                             noise=u))
                for size, l2 in fits:
                    fit = ar_kernel.Layout(dtype, W, size, resident=not l2)
                    fns[fit.name] = (
                        lambda c, u, fit=fit, w=w_new[size]:
                        ar_kernel.generate(w, mc, c, noise=u, layout=fit))
                require(chosen[W] in fns, f"{tag}: {chosen[W]} fits")
            gen0, gen4 = (old[W].name for W in (0, FUSED))
            unfused = [k for k in fns if k != gen4 and "fused" not in k]
            us, outs = {}, {}
            for b in CLUSTER_B:
                cb, nb = c_all[:b].contiguous(), n_all[:b].contiguous()
                # unfused: ar_generate and every size and placement at
                # CLUSTER_SIZES_B, else the chosen; fused: ar_generate's
                # and every size and placement at B = 1, ar_generate's and
                # the chosen at B = 8, the chosen at B = 16
                names = (list(unfused) if b in CLUSTER_SIZES_B
                         else [gen0, chosen[0]])
                names += ([gen4] + [k for k in fns if "fused" in k
                                    and "ar_cluster" in k] if b == 1
                          else [gen4, chosen[FUSED]] if b == 8
                          else [chosen[FUSED]] if b == 16 else [])
                out = {k: fns[k](cb, nb) for k in names}
                outs[b] = {W: out[chosen[W]] for W in (0, FUSED)
                           if chosen[W] in out}
                # one size, both placements: the same sums, to the bit
                for W in (0, FUSED):
                    for size in {size for size, _ in fitted[W]}:
                        smem, l2 = (ar_kernel.Layout(dtype, W, size,
                                                     resident=r).name
                                    for r in (True, False))
                        if smem in out and l2 in out:
                            checks.append({
                                "check": f"{tag}_{smem}_equals_l2_B{b}",
                                "ok": torch.equal(out[smem], out[l2])})
                # in turns: each in order, then in the reverse order
                t = {k: [] for k in names}
                for k in names + names[::-1]:
                    t[k].append(1e3 * event_ms(lambda: fns[k](cb, nb))
                                / CLUSTER_T)
                us[b] = t
            for W in (0, FUSED):
                bs = [b for b in CLUSTER_B if W in outs[b]]
                same = all(torch.equal(outs[b][W], outs[bs[-1]][W][:b])
                           for b in bs)
                checks.append({"check": f"{tag}_fused{W}_row_equal_at_B_"
                               + "_".join(map(str, bs)), "ok": same})
                require(bool(torch.isfinite(outs[bs[-1]][W]).all()),
                        f"{tag} fused={W} cluster output finite")
            # held against the plain version at B = 1 over the first steps:
            # the size the decode picks, and, where its weights stream from
            # L2, the smallest size whose weights fit in shared memory
            for W in (0, FUSED):
                held = [chosen[W]]
                res = [ar_kernel.Layout(dtype, W, size).name
                       for size, l2 in fitted[W] if not l2]
                if res and res[0] != chosen[W] and chosen[W].endswith(
                        ",l2]"):
                    held.append(res[0])
                for name in held:
                    size = int(re.search(r"N(\d+)", name).group(1))
                    k = fns[name](c1, n1)
                    ms = event_ms(lambda: fns[name](c1, n1))
                    if name == chosen[W]:
                        checks.append({
                            "check": f"{tag}_{name}_prefix_of_T{CLUSTER_T}",
                            "ok": torch.equal(
                                k, outs[1][W][:, :CLUSTER_CHECK_T])})
                    fb = own_feedback(k)
                    fp32, plain_ms = host_ms(
                        lambda: plain_version(
                            pp, mc, c1, noise=n1, teacher=fb, fused=W))
                    if dtype == "float32":
                        e = err(fp32, k)
                        checks.append({"check": f"{name}_{tag}_free_one_step"
                                       "_vs_plain", "max_abs_err": e,
                                       "limit": TOL_FREE,
                                       "ok": e <= TOL_FREE})
                    else:
                        chain, plain_ms = host_ms(
                            lambda: plain_version(
                                pp, mc, c1, noise=n1, teacher=fb,
                                dtype=dtype, chain=True, split=size,
                                fused=W))
                        e, ctl = err(chain, k), err(fp32, k)
                        cmin = CONTROL_MIN if preset == "deep_baseline" \
                            else KPROBE_CONTROL_MIN
                        checks.append({"check": f"{name}_{tag}_vs_chain_"
                                       f"split{size}", "max_abs_err": e,
                                       "limit": TOL_CHAIN,
                                       "control_fp32": ctl,
                                       "control_min": cmin,
                                       "ok": e <= TOL_CHAIN and ctl > cmin})
                    bound_ms, bound_by = bound(mc, 1, CLUSTER_CHECK_T, dtype)
                    checked[name] = {
                        "name": name, "preset": preset, "dtype": dtype,
                        "fused": W, "max_abs_err": e, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "B": 1, "T": CLUSTER_CHECK_T}
            for W in (0, FUSED):
                n, resident = layouts[W].cluster, layouts[W].resident
                key = ("ar_cluster,"
                       + ("bf16," if dtype == "bfloat16" else "fp32,")
                       + ("fused," if W else "")
                       + ("smem" if resident else "l2"))
                runs[f"{tag}_fused{W}"] = {
                    "N": n, "weights": "shared memory" if resident else "L2",
                    "variant": chosen[W], "fallback": old[W],
                    "smem_bytes": ar_kernel.cluster_smem_bytes(
                        mc, layouts[W]),
                    "registers": regs.get(key), "occupancy": occs[W]}
            runs[f"{tag}_us_per_step"] = us
        c2 = preset == "shallow_laplace_single"
        more, runs[f"{preset}_lengths_ms"] = cluster_lengths(
            mc, model, pp, preset,
            ("float32", "bfloat16") if c2 else ("float32",))
        checks += more
        if c2:
            checks.append(cluster_many_rows(mc, model, pp, preset))
    launches = dict(ar_kernel.launches)
    for d in checked.values():
        d["launches"] = launches.get(d["name"], 0)
    emit("cluster", T=CLUSTER_T, check_T=CLUSTER_CHECK_T, smem_limit=limit,
         runs=runs, checks=checks, held=checked, launches=launches,
         card=smi)
    for c in checks:
        require(c["ok"], f"cluster: {c}")
    return checked


def phase_kfuse(smi: str) -> None:
    """The bin.kfuse sweep on the kernel the decode picks for each W (the
    cluster kernel) and on ar_generate."""
    ar_kernel.launches.clear()
    rows = {k: kfuse.sweep("shallow_laplace_single", batches=KFUSE_B,
                           steps=KFUSE_T, kernel=k) for k in kfuse.KERNELS}
    require(all(np.isfinite(r["us_per_step"]) and r["us_per_step"] > 0
                for rs in rows.values() for r in rs), "kfuse sweep times")
    require(all(r["layout"]["cluster"] > 1 for r in rows["cluster"]),
            "kfuse: every W on the cluster kernel")
    emit("kfuse_sweep", preset="shallow_laplace_single", T=KFUSE_T,
         rows=rows, launches=dict(ar_kernel.launches), card=smi)


def phase_kprobe(smi: str) -> dict:
    """The AR step's ablation probe at config 2, fp32 and bf16: no_resskip
    refused before launch; the bin.kprobe sweep (the phase's main path, its
    launches counted by variant), each of its calls checked on its own
    inputs (see KPROBE_* above); full and ar_generate timed in turns
    (full, ar_generate, ar_generate, full) at B = 8; and the plain version
    of full, free running, timed at B = 8 and held against the kernel."""
    mc = get_config("shallow_laplace_single").model
    require((mc.log_b_min, mc.log_b_max) == ar_probe.LOG_B_CLIP,
            "config 2 clips log_b where the probe does")
    w = {dt: {k: v.cuda() for k, v in ar_probe.probe_weights(mc, dt).items()}
         for dt in ar_kernel.DTYPES}
    defined = [ab for ab in ar_probe.ABLATIONS if ab != "no_resskip"]
    checks = []

    def record(name, e, limit, **kw):
        checks.append({"check": name, "max_abs_err": e, "limit": limit,
                       "ok": e <= limit, **kw})

    # no_resskip is undefined at config 2 (S = 128 > G/2 = 64): refused
    # before launch
    try:
        ar_probe.probe(w["float32"], mc, torch.zeros(128, 2, mc.cond_channels,
                                                     device="cuda"),
                       torch.full((128, 2), 0.5, device="cuda"), "no_resskip")
        refused = ""
    except ValueError as e:
        refused = str(e)
    checks.append({"check": "no_resskip_refused", "error": refused,
                   "ok": "no_resskip" in refused})
    # the sweep, its launches counted by variant
    ar_probe.launches.clear()
    outs = {dt: {} for dt in ar_kernel.DTYPES}
    sweep = {dt: kprobe.sweep("shallow_laplace_single", dt, KPROBE_B,
                              KPROBE_T, outputs=outs[dt])
             for dt in ar_kernel.DTYPES}
    launched = dict(ar_probe.launches)
    want = {ar_probe.variant(dt, ab) for dt in ar_kernel.DTYPES
            for ab in defined}
    require(set(launched) == want,
            f"the kprobe sweep launched every defined variant: {launched}")
    for dt, rows in sweep.items():
        require(all(r["us_per_step"] > 0 for r in rows if "error" not in r)
                and {(r["B"], r["ablate"]) for r in rows if "error" in r}
                == {(1, "split2")} | {(b, "no_resskip") for b in KPROBE_B},
                f"kprobe sweep {dt}: refused only split2 at B = 1 and "
                f"no_resskip")
    # each timed call on its own inputs: full is the production step to the
    # bit, the schedules compute full, every ablation meets its plain
    # version fed the kernel's own samples
    for dt, by_b in outs.items():
        wd = w[dt]
        for B, o in by_b.items():
            c, n, full = o["cond"], o["noise"], o["full"]
            gen = ar_kernel.generate(ar_probe.plain_params(wd), mc,
                                     c.transpose(0, 1).contiguous(),
                                     noise=n.t().contiguous(),
                                     layout=ar_kernel.Layout(dt))
            record(f"{dt}_B{B}_full_vs_ar_generate", err(full.t(), gen), 0.0,
                   equal=torch.equal(full.t(), gen))
            for ab in defined:
                if ab not in o:             # refused at this B
                    continue
                k = o[ab]
                require(bool(torch.isfinite(k).all()),
                        f"probe {dt} {ab} B = {B} finite")
                if ab in ar_probe.SCHEDULES or (ab, dt) == ("gate_bf16",
                                                            "float32"):
                    record(f"{dt}_B{B}_{ab}_vs_full", err(k, full), 0.0,
                           equal=torch.equal(k, full))
                fb = own_feedback(k.t())
                if dt == "float32":
                    record(f"float32_B{B}_{ab}_vs_plain", err(k, (
                        probe_plain(wd, mc, c, n, ab, feedback=fb))),
                        TOL_TEACHER)
                    continue
                e = err(k, probe_plain(wd, mc, c, n, ab, feedback=fb,
                                       chain=True))
                ctl = err(k, probe_plain(w["float32"], mc, c, n, ab,
                                         feedback=fb))
                checks.append({
                    "check": f"bfloat16_B{B}_{ab}_vs_chain", "max_abs_err": e,
                    "limit": TOL_CHAIN, "control_fp32": ctl,
                    "control_min": KPROBE_CONTROL_MIN,
                    "ok": e <= TOL_CHAIN and ctl > KPROBE_CONTROL_MIN})
    # full against the production kernel on the same call, in turns
    o = outs["float32"][8]
    c, n = o["cond"], o["noise"]
    turns = {}
    for dt, wd in w.items():
        pp = ar_probe.plain_params(wd)
        cb, nb = c.transpose(0, 1).contiguous(), n.t().contiguous()
        us = {"full": [], "ar_generate": []}
        for name in ("full", "ar_generate", "ar_generate", "full"):
            fn = ((lambda: ar_probe.probe(wd, mc, c, n, "full"))
                  if name == "full" else
                  (lambda: ar_kernel.generate(pp, mc, cb, noise=nb,
                                              layout=ar_kernel.Layout(dt))))
            us[name].append(1e3 * cuda_ms(fn, 2) / KPROBE_T)
        turns[dt] = us
    # the plain version's time: full, free running, at B = 8, held at
    # TOL_FREE (config 2 does not amplify fp32 rounding under its own
    # feedback on these weights either)
    free, plain_ms = host_ms(lambda: probe_plain(
        w["float32"], mc, c, n, "full"))
    record("float32_B8_full_free_running_vs_plain", err(o["full"], free),
           TOL_FREE)
    row = next(r for r in sweep["float32"]
               if (r["B"], r["ablate"]) == (8, "full"))
    times = {"max_abs_err": next(ck["max_abs_err"] for ck in checks
                                 if ck["check"] == "float32_B8_full_vs_plain"),
             "ms": row["us_per_step"] * KPROBE_T / 1e3, "plain_ms": plain_ms}
    emit("kprobe", config="shallow_laplace_single", T=KPROBE_T,
         checks=checks, full_B8=times, sweep=sweep, launches=launched,
         full_vs_ar_generate_us_B8=turns, card=smi)
    for ck in checks:
        require(ck["ok"], f"kprobe: {ck}")
    bound_ms, bound_by = bound(mc, 8, KPROBE_T)
    return {"launches": sum(launched.values()), "launches_by_variant":
            launched, "bound_ms": bound_ms, "bound_by": bound_by, **times}


def phase_dma_probe(smi: str, regs: dict) -> dict:
    """The ring-window copy probe's four variants (phase 13 above): the
    sweep's checks and launches (the phase's main path, counted) and its
    launch-alone times in turns; the plain version timed at the rate
    shape. Returns the kernels line's rows, one per variant."""
    ring_probe.launches.clear()
    rows = dma_probe.sweep()
    launched = dict(ring_probe.launches)
    kw = ring_probe.SHAPES["rate"]
    _, plain_ms = host_ms(lambda: ring_plain(**kw, device="cuda"))
    emit("dma_probe", rows=rows, plain_ms_rate=plain_ms, launches=launched,
         card=smi)
    for r in rows:
        require(r["exact"], f"ring probe {r['variant']} at {r['shape']}: "
                f"max_abs_err {r['max_abs_err']}")
    require({r["shape"] for r in rows} == set(dma_probe.SHAPES)
            and all(r["timed"] == (r["shape"] in ring_probe.SHAPES)
                    for r in rows), "ring probe: every shape checked, "
            "every SHAPE timed")
    out = {}
    for v in ring_probe.VARIANTS:
        name = ring_probe.variant_name(v)
        at = {r["shape"]: r for r in rows if r["variant"] == v}
        require(launched.get(name, 0) >= 1, f"{name} launched")
        out[v] = {"name": name, "launches": launched[name],
                  "max_abs_err": max(r["max_abs_err"] for r in at.values()),
                  "ms": at["rate"]["ms"], "ms_call": at["rate"]["ms_call"],
                  "fill_ms": at["rate"]["fill_ms"],
                  "us_per_chunk_b8": at["jax_64_chunks"]["us_per_chunk"],
                  "plain_ms": plain_ms,
                  "bound_ms": 1e3 * ring_probe.bound_bytes(**kw)
                  / yardstick.PEAK_BYTES,
                  "bound_by": "bytes", "registers": regs.get(
                      "ring_probe," + v)}
    return out


def phase_cluster_probe(smi: str, regs: dict, models: dict) -> list:
    """The ablation probe on the cluster kernel and its per-stage timer
    (phase 15 above). models: {preset: (model config, model, plain
    params)}. Returns the kernels line's rows: the sweep's, one per dtype,
    and the timed instances', one per layout."""
    mc = get_config("shallow_laplace_single").model
    w = {dt: {k: v.cuda() for k, v in ar_probe.probe_weights(mc, dt).items()}
         for dt in ar_kernel.DTYPES}
    layouts = {dt: ar_kernel.choose_layout(mc, dt, "cuda")
               for dt in ar_kernel.DTYPES}
    checks = []

    def record(name, e, limit, **kw):
        checks.append({"check": name, "max_abs_err": e, "limit": limit,
                       "ok": e <= limit, **kw})

    # refused before launch: split2 (two rows per cluster) and no_resskip
    # (S = 128 > G/2 = 64 at config 2)
    ar_probe.launches.clear()
    for ab in ("split2", "no_resskip"):
        try:
            ar_probe.probe(w["float32"], mc,
                           torch.zeros(128, 2, mc.cond_channels,
                                       device="cuda"),
                           torch.full((128, 2), 0.5, device="cuda"), ab,
                           kernel="cluster")
            refused = ""
        except ValueError as e:
            refused = str(e)
        checks.append({"check": f"{ab}_refused_on_the_cluster",
                       "error": refused,
                       "ok": ab in refused and not ar_probe.launches})
    # the sweep, its launches counted by variant
    ar_probe.launches.clear()
    outs = {dt: {} for dt in ar_kernel.DTYPES}
    sweep = {dt: kprobe.sweep("shallow_laplace_single", dt, CPROBE_B,
                              CPROBE_T, outputs=outs[dt], kernel="cluster")
             for dt in ar_kernel.DTYPES}
    launched = dict(ar_probe.launches)
    defined = [ab for ab in ar_probe.CLUSTER_ABLATIONS if ab != "no_resskip"]
    want = {ar_probe.variant(dt, ab, "cluster", layouts[dt].cluster,
                             layouts[dt].resident)
            for dt in ar_kernel.DTYPES for ab in defined}
    require(set(launched) == want, f"the cluster probe sweep launched every "
            f"defined variant: {launched}")
    for dt, rows in sweep.items():
        require(all(r["us_per_step"] > 0 for r in rows if "error" not in r)
                and {(r["B"], r["ablate"]) for r in rows if "error" in r}
                == {(b, "no_resskip") for b in CPROBE_B},
                f"cluster probe sweep {dt}: refused only no_resskip")
    errs = {dt: [] for dt in ar_kernel.DTYPES}
    for dt, by_b in outs.items():
        wd, n = w[dt], layouts[dt].cluster
        for B, o in by_b.items():
            c, nz, full = o["cond"], o["noise"], o["full"]
            gen = ar_kernel.generate(ar_probe.plain_params(wd), mc,
                                     c.transpose(0, 1).contiguous(),
                                     noise=nz.t().contiguous(),
                                     layout=layouts[dt])
            record(f"{dt}_B{B}_full_vs_ar_cluster", err(full.t(), gen), 0.0,
                   equal=torch.equal(full.t(), gen))
            for ab in defined:
                k = o[ab]
                require(bool(torch.isfinite(k).all()),
                        f"cluster probe {dt} {ab} B = {B} finite")
                if ab in ("unroll2", "unroll4") or (ab, dt) == (
                        "gate_bf16", "float32"):
                    record(f"{dt}_B{B}_{ab}_vs_full", err(k, full), 0.0,
                           equal=torch.equal(k, full))
                fb = own_feedback(k.t())
                if dt == "float32":
                    e = err(k, probe_plain(wd, mc, c, nz, ab, feedback=fb,
                                           split=n))
                    record(f"float32_B{B}_{ab}_vs_plain_split{n}", e,
                           TOL_TEACHER)
                    errs[dt].append(e)
                    continue
                e = err(k, probe_plain(wd, mc, c, nz, ab, feedback=fb,
                                       chain=True, split=n))
                ctl = err(k, probe_plain(w["float32"], mc, c, nz, ab,
                                         feedback=fb, split=n))
                errs[dt].append(e)
                # local_exchange's output at N = 8 is rank 0's eighth of
                # the model, whose fp32 control misses by less than
                # KPROBE_CONTROL_MIN (2.4e-5 to 3.7e-5 on an H100): its
                # control is held at N = 2 below
                local = ab == "local_exchange"
                checks.append({
                    "check": f"bfloat16_B{B}_{ab}_vs_chain_split{n}",
                    "max_abs_err": e, "limit": TOL_CHAIN,
                    "control_fp32": ctl,
                    "control_min": None if local else KPROBE_CONTROL_MIN,
                    "ok": e <= TOL_CHAIN and (local
                                              or ctl > KPROBE_CONTROL_MIN)})
    # local_exchange at N = 2, where each rank runs half the model: 0.0
    # against `chain=True, split=2`, its fp32 control above
    # KPROBE_CONTROL_MIN (a check launch, not counted in the sweep)
    B8 = max(CPROBE_B)
    o = outs["bfloat16"][B8]
    k2 = ar_probe.probe(w["bfloat16"], mc, o["cond"], o["noise"],
                        "local_exchange", kernel="cluster",
                        layout=ar_kernel.choose_layout(mc, "bfloat16",
                                                       "cuda", cluster=2))
    fb = own_feedback(k2.t())
    e = err(k2, probe_plain(w["bfloat16"], mc, o["cond"], o["noise"],
                            "local_exchange", feedback=fb, chain=True,
                            split=2))
    ctl = err(k2, probe_plain(w["float32"], mc, o["cond"], o["noise"],
                              "local_exchange", feedback=fb, split=2))
    checks.append({"check": f"bfloat16_B{B8}_local_exchange_N2_vs_chain_"
                   "split2", "max_abs_err": e, "limit": TOL_CHAIN,
                   "control_fp32": ctl, "control_min": KPROBE_CONTROL_MIN,
                   "ok": e <= TOL_CHAIN and ctl > KPROBE_CONTROL_MIN})
    # full against the production kernel on the same call, in turns
    turns = {}
    for dt, wd in w.items():
        o, lay = outs[dt][B8], layouts[dt]
        c, nz = o["cond"], o["noise"]
        pk = ar_probe.cluster_weights(wd, mc, lay, "cuda")
        kw = ar_kernel.kernel_weights(ar_probe.plain_params(wd), mc, lay,
                                      "cuda")
        cb, nb = c.transpose(0, 1).contiguous(), nz.t().contiguous()
        us = {"full": [], "ar_cluster": []}
        for name in ("full", "ar_cluster", "ar_cluster", "full"):
            fn = ((lambda: ar_probe.probe(
                wd, mc, c, nz, "full", kernel="cluster", packed=pk))
                if name == "full" else
                (lambda: ar_kernel.generate(kw, mc, cb, noise=nb)))
            us[name].append(1e3 * cuda_ms(fn, 2) / CPROBE_T)
        turns[dt] = us
    # the plain version's time, full free running at B = 8; fp32 held at
    # TOL_FREE (config 2 does not amplify fp32 rounding under its own
    # feedback), bf16 (matmul order, which drifts from the kernel's) timed
    plain_ms = {}
    for dt, lay in layouts.items():
        o, n = outs[dt][B8], lay.cluster
        free, plain_ms[dt] = host_ms(lambda: probe_plain(
            w[dt], mc, o["cond"], o["noise"], "full", split=n))
        if dt == "float32":
            record(f"float32_B{B8}_full_free_running_vs_plain_split{n}",
                   err(o["full"], free), TOL_FREE)
    emit("cluster_probe", config="shallow_laplace_single", T=CPROBE_T,
         layouts={dt: {"N": lay.cluster,
                       "weights": "shared memory" if lay.resident else "L2"}
                  for dt, lay in layouts.items()},
         checks=checks, sweep=sweep, launches=launched,
         full_vs_ar_cluster_us_B8=turns,
         registers={k: v for k, v in regs.items()
                    if k.startswith("ar_cluster_probe")}, card=smi)
    for ck in checks:
        require(ck["ok"], f"cluster_probe: {ck}")
    rows = []
    for dt, lay in layouts.items():
        mine = {k: v for k, v in launched.items()
                if k.startswith("ar_cluster_probe[bf16,")
                == (dt == "bfloat16")}
        full_row = next(r for r in sweep[dt]
                        if (r["B"], r["ablate"]) == (B8, "full"))
        bound_ms, bound_by = bound(mc, B8, CPROBE_T, dt)
        rows.append({
            "name": ar_probe.variant(dt, "full", "cluster", lay.cluster,
                                     lay.resident)[:-len(",full]")] + "]",
            "launches": sum(mine.values()), "launches_by_variant": mine,
            "max_abs_err": max(errs[dt]),
            "ms": full_row["us_per_step"] * CPROBE_T / 1e3,
            "plain_ms": plain_ms[dt],
            "bound_ms": bound_ms, "bound_by": bound_by})
    # the timer at the decode's layouts
    g = torch.Generator(device="cuda").manual_seed(29)
    ar_probe.launches.clear()
    timed = []
    for preset, (pmc, model, pp) in models.items():
        T = TIMER_T if preset == "shallow_laplace_single" else TIMER_DEEP_T
        c_up = random_cond(pmc, model, TIMER_B, T, 31)
        nz = ar_kernel.uniform_noise((TIMER_B, T), g)
        for dt in ar_kernel.DTYPES:
            for W in (0, FUSED):
                r = kprobe.time_stages(pp, pmc, c_up, nz, dt, W)
                _, pms = host_ms(lambda: plain_version(
                    pp, pmc, c_up[:, :TIMER_PLAIN_T], noise=nz[:, :TIMER_PLAIN_T],
                    dtype=dt, fused=W))
                c2_fp32 = (preset, dt, W) == ("shallow_laplace_single",
                                              "float32", 0)
                timed.append({"preset": preset, **r,
                              "ratio_max": TIMER_RATIO_MAX_C2_FP32 if c2_fp32
                              else TIMER_RATIO_MAX,
                              "plain_ms": pms, "plain_T": TIMER_PLAIN_T})
    timer_launches = dict(ar_probe.launches)
    emit("cluster_timer", B=TIMER_B, runs=timed,
         launches=timer_launches, card=smi)
    for r in timed:
        require(r["equal"], f"timer {r['preset']} {r['variant']}: timed "
                f"samples equal the production launch's")
        require(r["ratio"] <= r["ratio_max"], f"timer {r['preset']} "
                f"{r['variant']}: timed/untimed {r['ratio']}")
    for r in timed:
        pmc, _, pp = models[r["preset"]]
        bound_ms, bound_by = bound(pmc, r["B"], r["T"], r["dtype"])
        rows.append({
            "name": r["variant"], "preset": r["preset"],
            "launches": timer_launches.get(r["variant"], 0),
            "max_abs_err": 0.0 if r["equal"] else None,
            "ms": 1e-3 * r["T"] * sum(r["us_timed"]) / len(r["us_timed"]),
            "untimed_ms": 1e-3 * r["T"] * sum(r["us_untimed"])
            / len(r["us_untimed"]),
            "overhead": r["ratio"], "plain_ms": r["plain_ms"],
            "plain_T": r["plain_T"], "bound_ms": bound_ms,
            "bound_by": bound_by})
    return rows


def sd_classes(mc, out):
    """The softmax head's class ids of dequantized samples."""
    return mulaw_quantize(out, mc.quantize_channels).long()


def sd_gaps(w, mcd, x_prev, c_up, noise, outs, greedy: bool):
    """The gap of each (B, T) sample set of `outs` and, last, of the TF32
    control, under port_bench's plain reference (fp32, TF32 off) at the
    same inputs: x_prev each step's class input, c_up the conditioning.
    Sampling, the CDF gap of class k at uniform u, max(0, CDF[k-1] - u,
    u - CDF[k]) under the reference's fp32 CDF (`reference.cdf_gaps`'s);
    greedy, the probability gap max(p) - p[k]. A sample that is no class's
    value reads 1. The control's class is the TF32 reference's at u (its
    argmax, greedy), judged by the same fp32 softmax."""
    q = mcd["quantize_channels"]
    with torch.no_grad():
        logits = reference.ar_outputs(w, mcd, x_prev, c_up)
        tf32 = reference.ar_outputs(w, mcd, x_prev, c_up, reference.tf32)
    if greedy:
        p = torch.softmax(logits, dim=-1)

        def gap(k):
            return p.max(dim=-1).values - p.gather(-1, k[..., None])[..., 0]
        control = tf32.argmax(dim=-1)
    else:
        cdf = reference.softmax_cdf(logits)

        def gap(k):
            hi = cdf.gather(-1, k[..., None])[..., 0]
            lo = torch.where(k > 0, cdf.gather(-1, (k - 1).clamp(min=0)[
                ..., None])[..., 0], torch.zeros_like(hi))
            return torch.maximum(lo - noise, noise - hi).clamp(min=0.0)
        control = reference.cdf_class(reference.softmax_cdf(tf32), noise)
    gaps = []
    for out in outs:
        ids, off = reference.class_ids(out.reshape(-1), q)
        g = gap(ids.view(out.shape))
        gaps.append(torch.where(off.view(out.shape), torch.ones_like(g), g))
    return gaps + [gap(control)]


def phase_sd_wide(smi: str, seed: int) -> dict:
    """Phase 16 (above): the wide form at the speaker-dependent vocoder's
    widths against the plain reference and the plain version, and to the
    bit against the streamed form at deep_baseline's. Returns the kernels
    line's row."""
    tree = json.loads(SD_CONFIG.read_text())["config"]
    mc, mcd = Config.from_dict(tree).model, tree["model"]
    layout = ar_kernel.choose_layout(mc)
    require(layout == ar_kernel.Layout(cluster=16, wide=True,
                                       resident=False),
            f"the decode's layout (auto) at the vocoder's widths: {layout}")
    model = random_model(mc, seed)
    pp = extract_plain_params(model)
    # the reference's weights: the same tensors under their flax names
    w = {k.replace(".", "/"): v for k, v in model.state_dict().items()}
    B, T, q = SD_B, SD_T, mc.quantize_channels
    c_up = random_cond(mc, model, B, T, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    noise = ar_kernel.uniform_noise((B, T), g)
    ids = torch.randint(0, q, (B, T), generator=g, device="cuda").float()
    plain_kw = dict(chain=True, split=layout.cluster)
    checks = []

    def held(name, x_prev, k, p, greedy=False):
        gk, gp, gc = (float(v.max()) for v in sd_gaps(
            w, mcd, x_prev, c_up, noise, (k, p), greedy))
        checks.append({"check": name, "gap": "prob" if greedy else "cdf",
                       "max_gap": gk, "plain_max_gap": gp,
                       "control_max_gap": gc, "limit": SD_GAP,
                       "flips_vs_plain": int((sd_classes(mc, k)
                                              != sd_classes(mc, p)).sum()),
                       "ok": gk <= SD_GAP and gp <= SD_GAP})

    ar_kernel.launches.clear()
    ar_kernel.ring_bytes.clear()
    k = ar_kernel.generate(pp, mc, c_up, noise=noise, teacher=ids,
                           layout=layout)
    p, plain_ms = host_ms(lambda: plain_version(pp, mc, c_up, noise=noise,
                                                teacher=ids, **plain_kw))
    held("teacher_forced", ids, k, p)
    for mode in ("sample", "greedy"):
        k = ar_kernel.generate(pp, mc, c_up, noise=noise, mode=mode,
                               layout=layout)
        # the kernel's own classes as the inputs of the plain version and
        # the reference: the silence class at t = 0, then each step's draw
        own = torch.cat([torch.full_like(k[:, :1], q // 2),
                         sd_classes(mc, k)[:, :-1].float()], dim=1)
        held(f"free_{mode}", own, k,
             plain_version(pp, mc, c_up, noise=noise, mode=mode,
                           teacher=own, **plain_kw),
             greedy=mode == "greedy")
    # the judge's power: the TF32 control's classes fail it
    control = max(c["control_max_gap"] for c in checks)
    checks.append({"check": "tf32_control_fails", "control_max_gap":
                   control, "limit": SD_GAP, "ok": control > SD_GAP})
    name = layout.name
    launched = dict(ar_kernel.launches)
    rings = dict(ar_kernel.ring_bytes)
    shared, glob = ar_kernel.cluster_rings(mc, layout)
    require(set(launched) == {name} and launched[name] == 3,
            f"the wide form's launches: {launched}")
    require(rings == {"shared": 3 * B * shared * mc.residual_channels * 4,
                      "global": 3 * B * glob * mc.residual_channels * 4},
            f"ring bytes {rings} for {shared} shared, {glob} global rows")
    # to the bit against the streamed form at deep_baseline's widths
    dmc = get_config("deep_baseline").model
    dmodel = random_model(dmc, seed + 2)
    dpp = extract_plain_params(dmodel)
    DB, DT = len(SD_DEEP_LENGTHS), max(SD_DEEP_LENGTHS)
    dc = random_cond(dmc, dmodel, DB, DT, seed + 3)
    dn = ar_kernel.uniform_noise((DB, DT), g)
    streamed = ar_kernel.generate(
        dpp, dmc, dc, noise=dn, lengths=SD_DEEP_LENGTHS,
        layout=ar_kernel.Layout(cluster=16, resident=False))
    wide = ar_kernel.generate(dpp, dmc, dc, noise=dn, layout=layout,
                              lengths=SD_DEEP_LENGTHS)
    dshared, dglob = ar_kernel.cluster_rings(dmc, layout)
    bits = float((wide - streamed).abs().max())
    checks.append({"check": "deep_wide_vs_streamed_free_sample",
                   "max_abs_err": bits, "limit": 0.0, "ok": bits == 0.0,
                   "shared_rows": dshared, "global_rows": dglob,
                   "lengths": list(SD_DEEP_LENGTHS)})
    times = []
    for b in SD_TIME_B:
        cb = random_cond(mc, model, b, T, seed + b)
        nb = ar_kernel.uniform_noise((b, T), g)
        wk = ar_kernel.kernel_weights(pp, mc, layout, "cuda")
        ms = cuda_ms(lambda: ar_kernel.generate(wk, mc, cb, noise=nb), 2)
        bound_ms, bound_by = yardstick.ar_bound_ms(mcd, b, T)
        times.append({"B": b, "T": T, "ms": ms, "us_per_step": 1e3 * ms / T,
                      "bound_ms": bound_ms, "bound_by": bound_by})
    emit("sd_wide", nvidia_smi=smi, layout=layout, variant=name, B=B, T=T,
         checks=checks, plain_ms=plain_ms, launches=launched,
         ring_bytes=rings,
         shared_rows=shared, global_rows=glob,
         smem_bytes=ar_kernel.cluster_smem_bytes(mc, layout),
         clusters_at_once=ar_kernel.clusters_at_once(mc, layout),
         times=times)
    for c in checks:
        require(c["ok"], f"sd_wide: {c}")
    # the kernels line's row: B = SD_B rows of T steps, as the plain
    # version's teacher-forced call
    return {"name": name, "launches": launched[name], "max_abs_err": None,
            "max_gap": max(c["max_gap"] for c in checks if "max_gap" in c),
            "ms": times[0]["ms"], "plain_ms": plain_ms,
            "bound_ms": times[0]["bound_ms"],
            "bound_by": times[0]["bound_by"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--only", choices=("sd_wide",), default=None,
                   help="run the toolchain and build phases and this phase "
                        "alone")
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
    builds = start_builds()
    try:
        return run(args, smi, builds)
    finally:
        for _, proc, _ in builds["nvcc"].values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()


def run(args, smi: str, builds: dict) -> int:
    libs, regs = finish_builds(builds, ("ar_generate", "ar_cluster"))
    emit("build", seconds=time.perf_counter() - builds["t0"],
         libs=sorted(str(v.relative_to(Path(__file__).resolve().parent))
                     for v in libs.values()),
         registers=regs, building=sorted(builds["nvcc"]))
    if args.only == "sd_wide":
        phase_sd_wide(smi, args.seed)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    cfg = get_config("shallow_laplace_single")
    model = random_model(cfg.model, args.seed)
    pp = extract_plain_params(model)
    emit("weights", config=cfg.name, seed=args.seed,
         params=sum(v.numel() for v in model.parameters()),
         compute_dtype=cfg.model.compute_dtype)
    phase_plain_graph(cfg.model, model, pp, args.seed)

    check = phase_kernel_vs_plain(cfg.model, model, pp, args.seed)
    main_path = phase_main_path(cfg, model, pp, args.seed, smi)
    fused_check = phase_fused_kernel_vs_plain(cfg.model, model, pp,
                                              args.seed)
    fused_main = phase_main_path(cfg, model, pp, args.seed, smi, FUSED,
                                 main_path)

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
    deep_fused = [phase_deep_main_path(dcfg, dmodel, dpp, args.seed, smi, dt,
                                       fused=FUSED)
                  for dt in ("float32", "bfloat16")]
    phase_deep_fused_times(dcfg.model, dmodel, dpp, args.seed)
    phase_streaming(cfg, model, pp, args.seed, smi)
    phase_train(cfg, args.seed, smi)
    observe_launches = phase_observe(cfg, model, args.seed, smi)
    recipe_launches, pitch_launches = phase_recipe(args.seed, smi)
    phase_train_dp(cfg, args.seed, smi)
    phase_decode_dp(cfg, model, pp, args.seed, smi)
    pool_launches, pool_most = phase_stream_pool(cfg, model, pp, args.seed,
                                                 smi)
    held = phase_cluster(smi, regs, {cfg.name: (cfg.model, model, pp),
                                     dcfg.name: (dcfg.model, dmodel, dpp)})
    sd_wide = phase_sd_wide(smi, args.seed)
    phase_kfuse(smi)
    libs, regs = finish_builds(builds, ("ar_probe", "ring_probe",
                                        "ar_cluster_probe"))
    emit("probe_build", seconds=time.perf_counter() - builds["t0"],
         libs=sorted(str(v.relative_to(Path(__file__).resolve().parent))
                     for v in libs.values()),
         registers=regs)
    probe = phase_kprobe(smi)
    cluster_probe = phase_cluster_probe(
        smi, regs, {cfg.name: (cfg.model, model, pp),
                    dcfg.name: (dcfg.model, dmodel, dpp)})
    rings = phase_dma_probe(smi, regs)

    tpu = "shallow_wavenet_tpu/ops/ar_kernel.py"
    csrc = "shallow_wavenet_tpu_torch/csrc/"

    def row(d, source, replaces, **kw):
        return {"name": d["name"], "route": "cuda", "source": csrc + source,
                "replaces": tpu + replaces, "launches": d["launches"],
                "max_abs_err": d["max_abs_err"], "ms": d["ms"],
                "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
                "bound_by": d["bound_by"], "library_ms": None, **kw}

    # the cluster kernel on the main paths (config 2, deep fp32, deep
    # bf16), unfused and with the fused window
    kernels = [row(main_path, "ar_cluster.cu", ":560",
                   check_ms=check["cluster_kernel_ms"],
                   stream_pool_launches=pool_launches,
                   stream_pool_launches_per_step_max=pool_most,
                   recipe_launches=recipe_launches,
                   observe_launches=observe_launches)]
    kernels += [row(deep[0], "ar_cluster.cu", ":560",
                    recipe_pitch_launches=pitch_launches),
                row(deep[1], "ar_cluster.cu", ":616")]
    kernels.append(row(fused_main, "ar_cluster.cu", ":368",
                       check_ms=fused_check["cluster_kernel_ms"],
                       check_plain_ms=fused_check["plain_ms"]))
    kernels += [row(d, "ar_cluster.cu", r)
                for d, r in zip(deep_fused, (":368", ":742"))]
    # its wide form, on the speaker-dependent vocoder's main path: judged
    # by the classes' gaps (max_gap), launches counted in sd_wide
    kernels.append(row(sd_wide, "ar_cluster.cu", ":560",
                       max_gap=sd_wide["max_gap"], counted_in="sd_wide"))
    # its other template instances, on no main path on an H100: launches
    # counted in the cluster phase
    kernels += [row(d, "ar_cluster.cu",
                    (":742" if d["fused"] else ":616")
                    if d["dtype"] == "bfloat16"
                    else ":368" if d["fused"] else ":560",
                    counted_in="cluster")
                for d in held.values()
                if d["name"] not in {k["name"] for k in kernels}]
    # ar_generate, the fallback layouts, unfused and fused: launches
    # counted in the phases that hold them against their plain versions
    kernels.append(row({**check, "name": "ar_generate",
                        "launches": check["launches"]["ar_generate"],
                        "ms": check["kernel_ms"]}, "ar_generate.cu", ":560",
                       counted_in="kernel_vs_plain"))
    kernels.append(row(fused_check, "ar_generate.cu", ":368",
                       counted_in="fused_kernel_vs_plain"))
    for key, r in (("fp32", ":297"), ("bf16", ":616"),
                   ("fp32_fused", ":378"), ("bf16_fused", ":742")):
        kernels.append(row(deep_check[key], "ar_generate.cu", r,
                           counted_in="deep_kernel_vs_plain"))
    kernels.append({
        "name": "ar_probe", "route": "cuda",
        "source": "shallow_wavenet_tpu_torch/csrc/ar_probe.cu",
        "replaces": "tools/kprobe.py:46", "launches": probe["launches"],
        "launches_by_variant": probe["launches_by_variant"],
        "max_abs_err": probe["max_abs_err"], "ms": probe["ms"],
        "plain_ms": probe["plain_ms"], "bound_ms": probe["bound_ms"],
        "bound_by": probe["bound_by"], "library_ms": None})
    # the probe on the cluster kernel (its sweep's launches, one row per
    # dtype) and the timed instances (launches counted in the
    # timer's run)
    for r in cluster_probe:
        timed = r["name"].endswith(",timed]")
        kernels.append({
            "route": "cuda", "source": csrc + "ar_cluster.cu",
            "replaces": (tpu + (":368" if "fused" in r["name"] else ":560"))
            if timed else "tools/kprobe.py:46",
            "library_ms": None,
            "counted_in": "cluster_timer" if timed else "cluster_probe",
            **r})
    for r in rings.values():
        kernels.append({
            "route": "cuda",
            "source": "shallow_wavenet_tpu_torch/csrc/ring_probe.cu",
            "replaces": "tools/dma_probe.py:25", "library_ms": None, **r})
    emit("plain_seconds", seconds=sum(PLAIN_SECONDS.values()),
         by_kind=PLAIN_SECONDS,
         where="on the card: generate_plain's step replayed from a CUDA "
               "graph, the probe's and the MLSA recursion's eager")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
