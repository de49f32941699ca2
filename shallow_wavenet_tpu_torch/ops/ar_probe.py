"""The AR step's ablation probe: the wrapper around `csrc/ar_probe.cu` and its
plain PyTorch version — the counterpart of the TPU probe `tools/kprobe.py`.

The probe runs the unfused AR step of the resident kernel with one part
stripped out (`ABLATIONS`, the TPU probe's list and order), so that the
time each part costs can be read off against `full`. Every ablation is a
well-defined function, but only `full` and the three schedules of it
(`unroll2`, `unroll4`, `split2`) compute the vocoder's step. The probe's
model is the TPU probe's: a Laplace head with the log-scale clip
`LOG_B_CLIP`, the input encoded as x + in_b (unit input weights), and no
biases. `full` is the production kernel's function on such weights
(`plain_params`), and on the card its kernel is the production body, so
it equals `ar_generate` to the bit there.

Layouts are the TPU probe's: conditioning (T, B, C) fp32, uniforms (T, B),
samples out (T, B). The weights are a dict (`WEIGHTS`) of fp32 or bf16
tensors, made by `probe_weights` (the TPU probe's recipe) or carried from
the TPU probe's seven arrays by `weights_from_jax`. The TPU probe pads the
gate halves to its 128-lane tile (gp = 128); the port uses the production
geometry gp = G/2, so the two agree where G = 256.

On a CUDA tensor `probe` launches the kernel (one launch per call; the
time loop runs inside it) or raises; on a CPU tensor it runs the plain
version, `probe_plain`, which repeats the kernel's arithmetic (rounding to
bf16 where the kernel does) with matmuls that sum in their own order, or
(`chain=True`) in the kernel's.
`check_shape` raises, on both versions, on what an ablation cannot take:
`no_resskip` adds z[:R] and z[:S], so it needs R, S <= G/2 (undefined at
config 2, where S = 128 > G/2 = 64); `split2` runs two rows per block, so
it needs an even batch; `chunk` (a multiple of 4, for the unrolled loops)
must divide T. The kernel's C entry refuses the same, and a config whose
resident rings do not fit one block's shared memory (deep_baseline: the
probe has no streamed rings, as the TPU probe has none). `launches` counts
kernel launches by variant.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.config import ModelConfig
from shallow_wavenet_tpu_torch.ops import _build
from shallow_wavenet_tpu_torch.ops.ar_kernel import DTYPES, check_supported

ABLATIONS = ("full", "no_cond", "no_prev", "no_buf", "no_resskip",
             "no_head", "no_sample", "matmuls_only", "cheap_gate",
             "no_gate", "unroll2", "unroll4", "split2", "gate_bf16")
# other schedules of full's own function
SCHEDULES = ("unroll2", "unroll4", "split2")
LOG_B_CLIP = (-9.0, 3.0)
WEIGHTS = ("in_b", "conv_w", "cond_w", "res_w", "skip_w", "h1_w", "h2_w")

# kernel launches by variant (`variant`) since the last reset; callers
# clear it to count a run
launches: collections.Counter = collections.Counter()


def variant(dtype: str, ablate: str) -> str:
    """The kernel variant's name, as `launches` counts it."""
    return f"ar_probe[{'bf16,' if dtype == 'bfloat16' else ''}{ablate}]"


def _weight_shapes(cfg: ModelConfig) -> dict:
    L, R, G = len(cfg.dilations), cfg.residual_channels, cfg.gate_channels
    S, C = cfg.skip_channels, cfg.cond_channels
    return {"in_b": (R,), "conv_w": (L, 2, R, G), "cond_w": (L, C, G),
            "res_w": (L, G // 2, R), "skip_w": (L, G // 2, S),
            "h1_w": (S, S), "h2_w": (S, 2)}


def _port_layout(in_b, conv_w, cond_wcat, res_w, skip_w, h1, h2) -> dict:
    L, _, _, G = conv_w.shape
    C = cond_wcat.shape[0]
    cond_w = cond_wcat.reshape(C, L, G).permute(1, 0, 2).contiguous()
    return dict(zip(WEIGHTS, (in_b, conv_w, cond_w, res_w, skip_w, h1, h2)))


def weights_from_jax(arrays) -> dict:
    """The TPU probe's seven weight arrays (`tools/kprobe.py:221-222`:
    in_b (R), conv_w (L, 2, R, 2gp), cond_wcat (C, L * 2gp), res_w (L, gp,
    R), skip_w (L, gp, S), h1 (S, S), h2 (S, 2); numpy or JAX arrays, fp32
    or bf16) in the port's layout: the same values and dtype, cond_wcat as
    cond_w (L, C, G), CPU tensors. gp must be G/2 (the port has no lane
    padding)."""
    def tensor(a):
        a = np.asarray(a)
        if a.dtype == np.float32:
            return torch.from_numpy(a.copy())
        if a.dtype.name == "bfloat16":      # exact through fp32
            return torch.from_numpy(a.astype(np.float32)).bfloat16()
        raise ValueError(f"probe weights must be float32 or bfloat16, got "
                         f"{a.dtype}")
    return _port_layout(*(tensor(a) for a in arrays))


def probe_weights(cfg: ModelConfig, dtype: str = "float32",
                  seed: int = 0) -> dict:
    """The TPU probe's weights (`tools/kprobe.py:215-222`): normal with std
    0.05 from `np.random.default_rng(seed)`, drawn in its order and shapes
    (with gp = G/2), cast to `dtype`, in the port's layout on the CPU."""
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                         f"{dtype!r}")
    rng = np.random.default_rng(seed)
    L, R, G = len(cfg.dilations), cfg.residual_channels, cfg.gate_channels
    S, C, gp = cfg.skip_channels, cfg.cond_channels, cfg.gate_channels // 2

    def mk(*shape):
        return torch.from_numpy(rng.standard_normal(shape) * 0.05).to(
            DTYPES[dtype])

    return _port_layout(mk(R), mk(L, 2, R, G), mk(C, L * G), mk(L, gp, R),
                        mk(L, gp, S), mk(S, S), mk(S, 2))


def plain_params(weights: dict) -> dict:
    """The probe's weights as the production kernel's plain params
    (`ops.ar_kernel`, Laplace head), fp32 on their device: unit input
    weights and zero biases, as the TPU timing prototypes build them. On
    these `full` is `ar_kernel.generate`'s function."""
    w = {k: v.float() for k, v in weights.items()}
    L, _, R, G = w["conv_w"].shape
    S = w["h1_w"].shape[0]
    dev = w["conv_w"].device

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    return {"input_w": torch.ones(1, R, device=dev), "input_b": w["in_b"],
            "conv_w": w["conv_w"], "conv_b": zeros(L, G),
            "cond_w": w["cond_w"], "res_w": w["res_w"], "res_b": zeros(L, R),
            "skip_w": w["skip_w"], "skip_b": zeros(L, S),
            "head1_w": w["h1_w"], "head1_b": zeros(S), "head2_w": w["h2_w"],
            "head2_b": zeros(2)}


def check_shape(cfg: ModelConfig, ablate: str, B: int, T: int,
                chunk: int) -> None:
    """Raise ValueError where ablation `ablate` is undefined (see the
    module docstring); the kernel's C entry refuses the same."""
    if ablate not in ABLATIONS:
        raise ValueError(f"unknown ablation {ablate!r}; one of {ABLATIONS}")
    check_supported(cfg)
    half = cfg.gate_channels // 2
    if ablate == "no_resskip" and (cfg.residual_channels > half
                                   or cfg.skip_channels > half):
        raise ValueError(
            f"no_resskip adds z[:R] and z[:S]: it needs R <= G/2 and S <= "
            f"G/2, got R={cfg.residual_channels}, S={cfg.skip_channels}, "
            f"G/2={half}")
    if ablate == "split2" and B % 2:
        raise ValueError(f"split2 runs two batch rows per block: it needs "
                         f"an even batch, got B={B}")
    if chunk < 4 or chunk % 4 or T % chunk:
        raise ValueError(f"chunk must be a positive multiple of 4 that "
                         f"divides T, got chunk={chunk}, T={T}")


def _prepare(weights, cfg, cond, noise, ablate, chunk, dev):
    cond = torch.as_tensor(cond, dtype=torch.float32).to(dev).contiguous()
    if cond.ndim != 3 or cond.shape[2] != cfg.cond_channels:
        raise ValueError(f"cond must be (T, B, {cfg.cond_channels}), got "
                         f"{tuple(cond.shape)}")
    T, B, _ = cond.shape
    noise = torch.as_tensor(noise, dtype=torch.float32).to(dev).contiguous()
    if tuple(noise.shape) != (T, B):
        raise ValueError(f"noise must be (T, B) = ({T}, {B}), got "
                         f"{tuple(noise.shape)}")
    check_shape(cfg, ablate, B, T, chunk)
    if set(weights) != set(WEIGHTS):
        raise ValueError(f"probe weights are {WEIGHTS}, got {sorted(weights)}")
    dtypes = {weights[k].dtype for k in WEIGHTS}
    if len(dtypes) != 1 or next(iter(dtypes)) not in DTYPES.values():
        raise ValueError(f"probe weights must share one dtype of "
                         f"{sorted(DTYPES)}, got {dtypes}")
    for k, shape in _weight_shapes(cfg).items():
        if tuple(weights[k].shape) != shape:
            raise ValueError(f"{k} must be {shape} for this config, got "
                             f"{tuple(weights[k].shape)}")
    w = {k: weights[k].to(dev).contiguous() for k in WEIGHTS}
    return cond, noise, w


def probe(weights: dict, cfg: ModelConfig, cond, noise, ablate: str,
          chunk: int = 128, device=None):
    """Samples (T, B) fp32 of ablation `ablate` on `device` (None: CUDA;
    "cpu" runs `probe_plain`). cond (T, B, C) fp32, noise (T, B) uniforms
    in (0, 1); weights as `probe_weights` makes them, fp32 or bf16 (the
    kernel's storage type); `chunk` sets where no_cond refreshes its
    conditioning (the TPU probe's grid chunk)."""
    dev = resolve_device(device)
    cond, noise, w = _prepare(weights, cfg, cond, noise, ablate, chunk, dev)
    if not cond.is_cuda:
        return _plain(cfg, cond, noise, w, ablate, chunk, None, False)
    return _launch(cfg, cond, noise, w, ablate, chunk)


def probe_plain(weights: dict, cfg: ModelConfig, cond, noise, ablate: str,
                chunk: int = 128, device=None, feedback=None,
                chain: bool = False):
    """The plain PyTorch version of `probe`, on any device. The schedules
    (`SCHEDULES`) compute `full`.

    feedback: optional (B, T); step t's input is feedback[:, t] (the
    previous sample, 0.0 at t = 0) instead of the version's own last
    sample, so the version can be held against a kernel given that
    kernel's own samples. Forced so, no step waits for another, and the
    version runs the whole call at once, layer by layer (a ring's read at t
    is the layer's input at t - d); without it, one Python step per sample.

    chain: sum every dot as one fp32 chain in k order, the kernel's order,
    instead of matmuls that sum in their own. In bf16 every product (of two
    bf16 values) is exact in fp32, so this is the bf16 kernel's arithmetic
    operation for operation: on a card it meets the kernel to the bit
    wherever torch's tanh, exp and log1p give the kernel's values. Slow on
    the CPU (one op per k); on CUDA one cumsum per dot."""
    dev = resolve_device(device)
    cond, noise, w = _prepare(weights, cfg, cond, noise, ablate, chunk, dev)
    if feedback is not None:
        feedback = torch.as_tensor(feedback, dtype=torch.float32).to(dev)
        if tuple(feedback.shape) != tuple(noise.shape[::-1]):
            raise ValueError(f"feedback must be (B, T) = "
                             f"{tuple(noise.shape[::-1])}, got "
                             f"{tuple(feedback.shape)}")
    return _plain(cfg, cond, noise, w, ablate, chunk, feedback, chain)


def _sigmoid(x):
    # 1 / (1 + exp(-x)), each op at x's dtype: the kernel's sigmoid in
    # fp32, and XLA's bf16 sigmoid (gate_bf16)
    return torch.reciprocal(torch.exp(-x) + 1)


# elements of one product block in chain mode (256 MB in fp32)
_CHAIN_BLOCK = 1 << 26


def _dots(chain: bool, *pairs):
    """[x @ m for (x, m) in pairs], all of one k length. In `chain` mode
    each output is one fp32 chain in k order, from 0, as the kernel's
    dot_cols: the products are formed, then summed along k, a block of rows
    at a time."""
    if not chain:
        return [x @ m for x, m in pairs]
    widths = [m.shape[1] for _, m in pairs]
    M, K = pairs[0][0].shape
    rows = max(1, _CHAIN_BLOCK // (K * sum(widths)))
    accs = []
    for i in range(0, M, rows):
        p = torch.cat([x[i:i + rows, :, None] * m for x, m in pairs], dim=-1)
        if p.is_cuda:
            # ATen's CUDA cumsum over a dim that is not the innermost gives
            # each output one thread that adds in k order in fp32, from 0
            accs.append(p.cumsum(1)[:, -1])
        else:
            # the CPU's cumsum accumulates in double: add step by step
            acc = torch.zeros_like(p[:, 0])
            for k in range(K):
                acc += p[:, k]
            accs.append(acc)
    return torch.cat(accs).split(widths, dim=-1)


@torch.no_grad()
def _plain(cfg, cond, noise, w, ablate, chunk, feedback, chain):
    T, B, C = cond.shape
    dil = cfg.dilations
    L, R, G = len(dil), cfg.residual_channels, cfg.gate_channels
    offs = [sum(dil[:l]) for l in range(L)]
    dev = cond.device
    wdt = w["conv_w"].dtype
    # bf16 values held in fp32: their products are exact, so fp32 matmuls
    # are the kernel's bf16 dots with fp32 sums (in another order)
    w = {k: v.float() for k, v in w.items()}
    w["cond_wcat"] = w["cond_w"].permute(1, 0, 2).reshape(C, L * G)
    w["rs_w"] = torch.cat([w["skip_w"], w["res_w"]], dim=-1)  # (L, G/2, S+R)

    def rnd(x):
        return _round(x, wdt)

    def encode(x_in):
        return rnd(rnd(x_in)[:, None] + w["in_b"][None, :])

    no_cond = ablate in ("no_cond", "matmuls_only")
    if feedback is not None:
        # every step at once: rows are (t, b), t-major
        frames = (torch.arange(T, device=dev) // chunk * chunk if no_cond
                  else slice(None))
        (cc,) = _dots(chain, (rnd(cond[frames]).reshape(T * B, C),
                              w["cond_wcat"]))

        def tap0(l, h):
            d = min(dil[l], T)
            hv = h.view(T, B, R)
            return torch.cat([torch.zeros_like(hv[:d]), hv[:T - d]]).view(
                T * B, R)

        x = _rows(cfg, w, wdt, ablate, chain, encode(
            feedback.t().reshape(T * B)), cc, noise.reshape(T * B), tap0)
        return x.view(T, B)

    rings = torch.zeros(sum(dil), B, R, device=dev)
    fb = torch.zeros(B, device=dev)
    out = torch.empty(T, B, device=dev)
    for t in range(T):
        if not no_cond or t % chunk == 0:
            (cc,) = _dots(chain, (rnd(cond[t]), w["cond_wcat"]))

        def tap0(l, h):
            slot = offs[l] + (t & (dil[l] - 1))
            prev = rings[slot].clone()
            rings[slot] = h
            return prev

        fb = out[t] = _rows(cfg, w, wdt, ablate, chain, encode(fb), cc,
                            noise[t], tap0)
    return out


def _round(x, wdt):
    # x as the kernel stores it in wdt (fp32 values out)
    return x.to(wdt).float()


def _rows(cfg, w, wdt, ablate, chain, h, cc, noise, tap0):
    """Samples of the rows h (N, R) (encoded inputs), cc (N, L*G)
    (conditioning terms) and noise (N,): the layers, the head and the
    draw, rounding to the storage type wdt where the kernel does; tap0(l,
    h) gives layer l's tap-0 input for its input h."""
    L, R, G = len(cfg.dilations), cfg.residual_channels, cfg.gate_channels
    S, half = cfg.skip_channels, G // 2
    no_buf = ablate in ("no_buf", "matmuls_only")
    no_sample = ablate in ("no_sample", "matmuls_only")

    def rnd(x):
        return _round(x, wdt)

    def gate(ua, ub):
        if ablate == "no_gate":
            return rnd(ua)
        if ablate == "cheap_gate":
            return rnd(ua * ub)
        if ablate == "gate_bf16":
            return (torch.tanh(ua.to(wdt)) * _sigmoid(ub.to(wdt))).float()
        return rnd(torch.tanh(ua) * _sigmoid(ub))

    skip = torch.zeros(h.shape[0], S, device=h.device)
    for l in range(L):
        ccl = cc[:, l * G:(l + 1) * G]
        if ablate == "no_prev":
            (g1,) = _dots(chain, (h, w["conv_w"][l, 1]))
            u = g1 + ccl
        else:
            prev = h if no_buf else tap0(l, h)
            g0, g1 = _dots(chain, (prev, w["conv_w"][l, 0]),
                           (h, w["conv_w"][l, 1]))
            u = (g0 + g1) + ccl
        z = gate(u[:, :half], u[:, half:])
        if ablate == "no_resskip":
            h = rnd(h + z[:, :R])
            skip = skip + z[:, :S]
        else:
            (rs,) = _dots(chain, (z, w["rs_w"][l]))
            h = rnd(h + rs[:, S:])
            skip = skip + rs[:, :S]
    if ablate == "no_head":
        mu = log_b = skip[:, 0] + skip[:, 1]
    else:
        (o,) = _dots(chain, (rnd(torch.relu(skip)), w["h1_w"]))
        (o,) = _dots(chain, (rnd(torch.relu(o)), w["h2_w"]))
        mu, log_b = o[:, 0], torch.clamp(o[:, 1], *LOG_B_CLIP)
    if no_sample:
        x = mu
    else:
        u_t = noise - 0.5
        x = mu - torch.exp(log_b) * torch.sign(u_t) * torch.log1p(
            -2.0 * torch.abs(u_t))
    return torch.clamp(x, -1.0, 1.0)


def _lib() -> ctypes.CDLL:
    lib = _build.load("ar_probe")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.ar_probe.argtypes = ([ptr] * 10 + [ctypes.POINTER(i32)] + [i32] * 10
                             + [f32, f32, ptr])
    lib.ar_probe.restype = i32
    lib.ar_probe_error_string.argtypes = [i32]
    lib.ar_probe_error_string.restype = ctypes.c_char_p
    return lib


def _launch(cfg, cond, noise, w, ablate, chunk):
    lib = _lib()
    T, B, C = cond.shape
    L = len(cfg.dilations)
    out = torch.empty((T, B), dtype=torch.float32, device=cond.device)
    bf16 = w["conv_w"].dtype == torch.bfloat16
    with torch.cuda.device(cond.device):
        err = lib.ar_probe(
            cond.data_ptr(), noise.data_ptr(), out.data_ptr(),
            *(w[k].data_ptr() for k in WEIGHTS),
            (ctypes.c_int * L)(*cfg.dilations), B, T, L,
            cfg.residual_channels, cfg.gate_channels, cfg.skip_channels, C,
            chunk, int(bf16), ABLATIONS.index(ablate), *LOG_B_CLIP,
            torch.cuda.current_stream().cuda_stream)
    if err < 0:
        raise ValueError("config not supported by the probe kernel: "
                         + lib.ar_probe_error_string(err).decode())
    if err != 0:
        raise RuntimeError("ar_probe launch failed: "
                           + lib.ar_probe_error_string(err).decode())
    launches[variant("bfloat16" if bf16 else "float32", ablate)] += 1
    return out
