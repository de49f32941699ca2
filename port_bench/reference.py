"""The plain reference the benchmark judges the program's outputs by.

Plain PyTorch, written from the model's equations (a frozen copy of the
WaveNet's upsampler, its autoregressive step in teacher-forced form, its
Laplace head, loss and optimizer), importing nothing of the program. It
takes the weights as a flat mapping of flax-layout names
(`layer0/conv/kernel`, ...) to tensors and the model configuration as a
plain mapping (`yardstick.dilations` reads its depth).

Precision follows the configuration's statement:
- products of `rnd`-rounded inputs summed in fp32, every activation rounded
  after its op (`rnd`: bf16 for a `compute_dtype` of bfloat16), for the
  upsampler and the training stack;
- the AR step in fp32 with TF32 off (the decode's kernel precision).
The controls swap `rnd` for fp8 (e4m3) and round the AR step's product
inputs to TF32: the precision below the stated one, which the comparison
has to reject.

How a generated waveform is judged: every step of the AR recurrence sees
only the samples before it, so teacher forcing the stack with the
program's own samples gives, at each position, the distribution the
reference would have sampled from after the program's history; its
inverse CDF at the same uniform is the reference's sample. The widest gap
between a program's sample and that one is the number compared: rounding
in the program moves it by the rounding of one step, while an altered or
misplaced sample, a wrong conditioning row or a wrong weight moves it by
the sample's own scale. The softmax head's samples are classes: the
program's samples are mapped back to class ids by the mu-law table, and
the gap is how far the uniform lies outside the program's class's interval
of the reference's CDF (`cdf_gaps`): compared as probabilities, not as
sampled classes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.yardstick import dilations

LN2 = math.log(2.0)
ADAM_B1 = 0.9


def bf16(x):
    return x.to(torch.bfloat16).float()


def fp8(x):
    """Round to float8 e4m3, saturating at its largest finite value (448),
    in the forward pass; identity backward."""
    q = x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float()
    return x + (q - x).detach()


def fp32(x):
    return x


def tf32(x):
    """Round fp32 to TF32 (10 mantissa bits), to nearest, ties away from
    zero, as the tensor cores take fp32 inputs."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


# ---------------------------------------------------------------------------
# The conditioning upsampler
# ---------------------------------------------------------------------------

def _leaky(x, rnd, slope: float = 0.1):
    # the slope rounded to the activation's precision before the product
    s = rnd(torch.tensor(slope, device=x.device))
    return torch.where(x >= 0, x, rnd(x * s))


def _dense(x, w, b, rnd, out_rnd=True):
    """x @ w with both inputs rounded, products summed in fp32, + bias,
    the result rounded (the 1x1 conv)."""
    y = torch.matmul(rnd(x), rnd(w))
    if b is not None:
        y = y + b
    return rnd(y) if out_rnd else y


def phase_weights(kernel, factor: int):
    """The repeat-then-smooth stage's (3C, f*C) phase-matmul weights: output
    sample i*f + p = sum over m in {-1, 0, 1} of A[p, m] @ c[i + m], A the
    sum of the SAME conv's taps j that land in frame i + m, added in j
    order."""
    k, c_in, ch = kernel.shape
    zero = torch.zeros(c_in, ch, dtype=kernel.dtype, device=kernel.device)
    a = [[zero] * factor for _ in range(3)]
    for p in range(factor):
        for j in range(k):
            m = (p - factor + j) // factor
            a[m + 1][p] = a[m + 1][p] + kernel[j]
    w2 = torch.stack([torch.stack(row) for row in a])    # (3, f, C, ch)
    return w2.permute(0, 2, 1, 3).reshape(3 * c_in, factor * ch)


def upsample(w, mc, frames, rnd=bf16):
    """(B, F, aux) normalized frames -> (B, F * hop, C) fp32 conditioning:
    a 1x1 projection, then per factor a repeat and a SAME conv of kernel
    2f + 1 (in its phase form), a leaky ReLU after each."""
    c = _leaky(_dense(frames, w["upsampler/proj/kernel"],
                      w["upsampler/proj/bias"], rnd), rnd)
    for si, f in enumerate(mc["upsample_factors"]):
        b, n, _ = c.shape
        cp = torch.nn.functional.pad(c, (0, 0, 1, 1))
        nb = torch.cat([cp[:, :-2], cp[:, 1:-1], cp[:, 2:]], dim=-1)
        y = torch.matmul(rnd(nb), rnd(phase_weights(
            w[f"upsampler/smooth{si}/kernel"], f)))
        y = y.reshape(b, n * f, -1) + w[f"upsampler/smooth{si}/bias"]
        c = _leaky(rnd(y), rnd)
    return c


def halo(factors) -> int:
    """Frames of context on each side that one upsampled sample depends
    on: a stage's SAME conv of kernel 2f + 1 after a repeat by f reaches
    f samples at its output rate, ceil((r + f) / f) frames at its input
    rate; walked back from the last stage."""
    r = 0
    for f in reversed(tuple(factors)):
        r = -(-(r + f) // f)
    return r


def upsample_blocks(w, mc, frames, block: int, rnd=bf16):
    """A stream's conditioning, (F * hop, C): each block of `block` frames
    upsampled from a window of its frames and `halo` frames on each side
    (cut at the utterance's edges, where the SAME conv's zero padding is
    the utterance's own) and trimmed to the block. Equal to upsampling the
    whole utterance up to the rounding of products of other lengths."""
    F, hop = frames.shape[0], math.prod(mc["upsample_factors"])
    H = halo(mc["upsample_factors"])
    rows = []
    for lo in range(0, F, block):
        hi = min(lo + block, F)
        a, b = max(lo - H, 0), min(hi + H, F)
        c = upsample(w, mc, frames[None, a:b], rnd)[0]
        rows.append(c[(lo - a) * hop:(hi - a) * hop])
    return torch.cat(rows)


# ---------------------------------------------------------------------------
# The AR step, teacher-forced
# ---------------------------------------------------------------------------

def _shift(x, d: int):
    """x[:, t - d] with zeros for t < d."""
    return torch.nn.functional.pad(x, (0, 0, d, 0))[:, :x.shape[1]]


def ar_outputs(w, mc, x_prev, c_up, rnd=fp32):
    """The AR step's head outputs at every position, fp32: (mu, log b)
    for the Laplace head, the Q class logits for the softmax head.
    Position t sees the feedback input x_prev[:, t] and the conditioning
    row c_up[:, t]. The feedback is, by head: Laplace, the previous sample
    (0.0 at t = 0) through the input projection; softmax, the previous
    class id, whose row of the input embedding is the residual input (no
    bias), at t = 0 the class Q // 2 (the mu-law class just above 0.0,
    as the model's decode starts). Every product's inputs go through `rnd`
    (fp32: unchanged; `tf32` for the control), its sums in fp32."""
    def mm(a, b):
        return torch.matmul(rnd(a), rnd(b))

    if mc["head"] == "softmax":
        h = w["input_embed/embedding"][x_prev.long()]
    else:
        h = (x_prev[..., None] * w["input_proj/kernel"][0]
             + w["input_proj/bias"])
    skip = 0.0
    for li, d in enumerate(dilations(mc)):
        k = w[f"layer{li}/conv/kernel"]
        u = (mm(_shift(h, d), k[0]) + mm(h, k[1]) + w[f"layer{li}/conv/bias"]
             + mm(c_up, w[f"layer{li}/cond/kernel"]))
        half = u.shape[-1] // 2
        z = torch.tanh(u[..., :half]) * torch.sigmoid(u[..., half:])
        h = h + mm(z, w[f"layer{li}/res/kernel"]) + w[f"layer{li}/res/bias"]
        skip = skip + mm(z, w[f"layer{li}/skip/kernel"]) \
            + w[f"layer{li}/skip/bias"]
    o = torch.relu(mm(torch.relu(skip), w["head1/kernel"]) + w["head1/bias"])
    return mm(o, w["head2/kernel"]) + w["head2/bias"]


def laplace_sample(o, u, mc):
    """The Laplace head's sample at uniform u in (0, 1): the inverse CDF at
    u - 1/2, clipped to [-1, 1]."""
    mu = o[..., 0]
    log_b = torch.clamp(o[..., 1], mc["log_b_min"], mc["log_b_max"])
    v = u - 0.5
    x = mu - torch.exp(log_b) * torch.sign(v) * torch.log1p(-2.0 * v.abs())
    return torch.clamp(x, -1.0, 1.0)


@torch.no_grad()
def sample_gaps(w, mc, c_up, noise, wav, control: bool = False,
                c_low=None):
    """|program sample - reference sample| at every position of one row:
    c_up (T, C), noise (T,) and wav (T,) the program's samples, all on one
    device, the reference teacher-forced with the program's samples. A
    control's reading in place of the program's, on the same history:
    `control` (True), the TF32 reference's sample; `c_low`, the fp32
    reference's sample on that conditioning (the upsampler's fp8
    control)."""
    x_prev = torch.cat([wav.new_zeros(1), wav[:-1]])[None]
    ref = laplace_sample(ar_outputs(w, mc, x_prev, c_up[None])[0], noise, mc)
    if control:
        wav = laplace_sample(ar_outputs(w, mc, x_prev, c_up[None], tf32)[0],
                             noise, mc)
    elif c_low is not None:
        wav = laplace_sample(ar_outputs(w, mc, x_prev, c_low[None])[0],
                             noise, mc)
    return (wav - ref).abs()


def mulaw_table(q: int) -> torch.Tensor:
    """The Q waveform values of the softmax head's classes, float64: class
    k's bin centre y = (k + 1/2) 2 / Q - 1 on the companded scale, expanded
    by the inverse mu-law, x = sign(y) ((1 + mu)^|y| - 1) / mu, mu = Q - 1."""
    mu = q - 1
    y = (torch.arange(q, dtype=torch.float64) + 0.5) * (2.0 / q) - 1.0
    return torch.sign(y) * ((1.0 + mu) ** y.abs() - 1.0) / mu


def class_ids(wav, q: int):
    """(ids, off): the class of each sample of `wav`, the nearest entry
    of `mulaw_table(q)`, and whether the sample lies more than 1e-6 from
    every entry (no class gives it: entries lie at least 1.7e-4 apart)."""
    table = mulaw_table(q).to(wav.device)
    dist = (wav.double()[:, None] - table[None]).abs()
    best, ids = dist.min(dim=-1)
    return ids, best > 1e-6


def softmax_cdf(logits):
    """The fp32 CDF over the classes: softmax times upper-triangular ones
    (the op the model's inverse-CDF sampler names)."""
    q = logits.shape[-1]
    i = torch.arange(q, device=logits.device)
    ones = (i[:, None] <= i[None, :]).float()
    return torch.matmul(torch.softmax(logits.float(), dim=-1), ones)


def cdf_class(cdf, u):
    """The class the inverse CDF gives at uniform u: #{k : cdf[k] < u},
    at most Q - 1."""
    ids = (cdf < u[..., None]).sum(dim=-1)
    return ids.clamp(max=cdf.shape[-1] - 1)


@torch.no_grad()
def cdf_gaps(w, mc, c_up, noise, wav, control=False, c_low=None):
    """The softmax head's gap at every position of one row: c_up (T, C),
    noise (T,) and wav (T,) the program's (dequantized) samples, all on
    one device, the reference teacher-forced with the program's classes.
    For class k at uniform u the gap is max(0, CDF[k-1] - u, u - CDF[k])
    (CDF[-1] = 0) under the reference's fp32 CDF: 0 where u lies in k's
    interval, the CDF's rounding at a bin edge, and on the scale of a
    class's probability for a wrong class, weight or conditioning row. A
    sample that is no class's value reads 1. `control` (True) puts the
    TF32 reference's class at u in the program's place; `c_low`, the fp32
    reference's class on that conditioning (the upsampler's fp8 control);
    both judged by the same fp32 CDF."""
    q = mc["quantize_channels"]
    ids, off = class_ids(wav, q)
    x_prev = torch.cat([ids.new_full((1,), q // 2), ids[:-1]])[None]
    cdf = softmax_cdf(ar_outputs(w, mc, x_prev, c_up[None])[0])
    if control:
        ids = cdf_class(softmax_cdf(ar_outputs(w, mc, x_prev, c_up[None],
                                               tf32)[0]), noise)
    elif c_low is not None:
        ids = cdf_class(softmax_cdf(ar_outputs(w, mc, x_prev,
                                               c_low[None])[0]), noise)
    hi = cdf.gather(-1, ids[:, None])[:, 0]
    lo = torch.where(ids > 0, cdf.gather(-1, (ids - 1).clamp(min=0)[:, None])
                     [:, 0], torch.zeros_like(hi))
    gap = torch.maximum(lo - noise, noise - hi).clamp(min=0.0)
    if not control and c_low is None:
        gap = torch.where(off, torch.ones_like(gap), gap)
    return gap


def judge(mc):
    """(the compared number's name, its per-position gaps) for the model's
    head: `max_cdf_gap` and `cdf_gaps` for softmax, `max_sample_gap` and
    `sample_gaps` for Laplace. Both gap functions take the same arguments,
    the controls' (`control`, `c_low`) included."""
    if mc["head"] == "softmax":
        return "max_cdf_gap", cdf_gaps
    return "max_sample_gap", sample_gaps


# ---------------------------------------------------------------------------
# Training: the loss, its gradient, the clip and Adam
# ---------------------------------------------------------------------------

def _sigmoid(x, rnd):
    # 1 / (1 + exp(-x)), each op rounded (the model's form)
    return rnd(torch.reciprocal(rnd(rnd(torch.exp(-x)) + 1)))


def train_forward(w, mc, x_in, cond, rnd=bf16):
    """The stack's head outputs (B, T, 2) fp32 for the training loss:
    x_in (B, T) the input samples, cond (B, F, aux) the frames, position t
    conditioned on the upsampled row t + 1."""
    t = x_in.shape[1]
    c = rnd(upsample(w, mc, cond, rnd)[:, 1:t + 1])
    h = _dense(x_in[..., None], w["input_proj/kernel"],
               w["input_proj/bias"], rnd)
    skips = 0.0
    for li, d in enumerate(dilations(mc)):
        k = w[f"layer{li}/conv/kernel"]
        y = torch.matmul(rnd(_shift(h, d)), rnd(k[0])) \
            + torch.matmul(rnd(h), rnd(k[1]))
        conv = rnd(y + w[f"layer{li}/conv/bias"])
        u = rnd(conv + _dense(c, w[f"layer{li}/cond/kernel"], None, rnd))
        half = u.shape[-1] // 2
        z = rnd(rnd(torch.tanh(u[..., :half])) * _sigmoid(u[..., half:], rnd))
        h = rnd(h + _dense(z, w[f"layer{li}/res/kernel"],
                           w[f"layer{li}/res/bias"], rnd))
        skips = skips + _dense(z, w[f"layer{li}/skip/kernel"],
                               w[f"layer{li}/skip/bias"], rnd)
    out = rnd(torch.relu(rnd(skips)))
    out = rnd(torch.relu(_dense(out, w["head1/kernel"], w["head1/bias"],
                                rnd)))
    return _dense(out, w["head2/kernel"], w["head2/bias"], fp32)


def train_loss(w, mc, segment: int, x, cond, rnd=bf16):
    """The Laplace NLL over the last `segment` positions: x (B, T) the
    waveform (input x[:, :-1], target x[:, 1:]), cond (B, T / hop, aux)."""
    o = train_forward(w, mc, x[:, :-1], cond, rnd)
    target = x[:, 1:]
    mu = o[..., 0]
    log_b = torch.clamp(o[..., 1], mc["log_b_min"], mc["log_b_max"])
    nll = LN2 + log_b + (target - mu).abs() * torch.exp(-log_b)
    t = nll.shape[1]
    mask = (torch.arange(t, device=x.device) >= t - segment).float()
    mask = mask[None].expand_as(nll)
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def adam_steps(w, mc, tc, segment: int, batches, rnd=bf16):
    """Run len(batches) updates from the weights `w`: the loss and its
    gradient, the global-norm clip (scale by clip / norm only when norm >=
    clip), Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) at the
    exponentially decayed learning rate. Returns (losses, Adam's first
    moment after the last update, bias-corrected: the updates' clipped
    gradients as Adam holds them, the weights after the last update)."""
    b1, b2, eps = ADAM_B1, 0.999, 1e-8
    names = sorted(w)
    params = {k: w[k].detach().clone() for k in names}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    losses = []
    for step, (x, cond) in enumerate(batches):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss = train_loss(leaves, mc, segment, x, cond, rnd)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names], allow_unused=True)))
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in grads.items()}
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if float(norm) >= tc["grad_clip_norm"]:
            grads = {k: g / norm * tc["grad_clip_norm"]
                     for k, g in grads.items()}
        count = step + 1
        lr = tc["learning_rate"] * tc["lr_decay_rate"] ** (
            step / tc["lr_decay_steps"])
        for k in names:
            mu[k] = (1 - b1) * grads[k] + b1 * mu[k]
            nu[k] = (1 - b2) * grads[k] * grads[k] + b2 * nu[k]
            upd = (mu[k] / (1 - b1 ** count)) / (
                torch.sqrt(nu[k] / (1 - b2 ** count)) + eps)
            if tc["weight_decay"] > 0:
                upd = upd + tc["weight_decay"] * params[k]
            params[k] = params[k] - lr * upd
        losses.append(float(loss.detach()))
    moment = {k: v / (1 - b1 ** len(batches)) for k, v in mu.items()}
    return losses, moment, params


# ---------------------------------------------------------------------------
# Training data: the segments a batch row is cut from
# ---------------------------------------------------------------------------

def cut_segment(wav, feats, s0: int, pad: int, segment: int, hop: int):
    """One training row cut from an utterance: the `segment` samples from
    s0 (a frame boundary) with `pad` samples of left context before them,
    zeros before the utterance's start; and the frames that cover those
    samples, the first frame repeated for frames before the start."""
    x = np.zeros(pad + segment, np.float32)
    lo = s0 - pad
    x[max(-lo, 0):] = wav[max(lo, 0):s0 + segment]
    f_lo = lo // hop
    idx = np.clip(np.arange(f_lo, f_lo + (pad + segment) // hop), 0,
                  len(feats) - 1)
    return x, feats[idx]


def locate(tail, wavs, hop: int):
    """(utterance, start sample) of the frame-aligned place in `wavs`, a
    (n, L) array of equal-length utterances, whose samples are `tail`;
    None where there is none."""
    n, L = wavs.shape
    flat = wavs.reshape(-1)
    j = int(np.argmin(np.abs(tail)))        # an unclipped sample
    for c in np.flatnonzero(flat == tail[j]) - j:
        u, s0 = divmod(int(c), L)
        if s0 % hop == 0 and s0 + len(tail) <= L \
                and np.array_equal(wavs[u, s0:s0 + len(tail)], tail):
            return u, s0
    return None
