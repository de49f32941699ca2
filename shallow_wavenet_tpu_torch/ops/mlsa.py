"""MLSA filter (Mel Log Spectrum Approximation) — the torch twin of
`shallow_wavenet_tpu/ops/mlsa.py`.

Realizes H(z) = exp sum_m c(m) Phi_m(z~) with the all-pass
z~^{-1} = (z^{-1}-a)/(1-a z^{-1}) through the [L/L] Pade approximation of
exp:

  exp(F) ~= P(F)/P(-F),  P(w) = sum_l A_l w^l
  t_l = F^l v (cascaded basic filters), v = x - sum_l A_l (-F)^l v,
  y = sum_l A_l t_l

where the basic filter F(z) = sum_{m=1..M} b(m) Phi_m(z), b = mc2b(c, a),
is strictly causal (one-sample delay), so the feedback loop is realizable.

The per-sample recursion is a plain loop over tensors on the input's
device, as the JAX module's lax.scan is: the reference and the fallback.
On the card it costs launches per sample, so long signals go through the
native C++ filter of `utils/native.py` (the data-prep fast path), which
realizes the same structure.
"""

from __future__ import annotations

import functools
from math import factorial

import torch


@functools.lru_cache(maxsize=4)
def pade_coefficients(order: int) -> tuple[float, ...]:
    """A_l of the [L/L] Pade approximant of exp at 0, l = 0..L."""
    return tuple(
        factorial(2 * order - l) * factorial(order)
        / (factorial(2 * order) * factorial(l) * factorial(order - l))
        for l in range(order + 1)
    )


def mc2b(mc, alpha: float):
    """Mel-cepstrum -> MLSA filter coefficients: b[M]=c[M];
    b[m] = c[m] - alpha*b[m+1] (SPTK mc2b), from order M down."""
    mc = torch.as_tensor(mc)
    b = torch.empty_like(mc)
    b_next = torch.zeros(mc.shape[:-1], dtype=mc.dtype, device=mc.device)
    for m in range(mc.shape[-1] - 1, -1, -1):
        b_next = mc[..., m] - alpha * b_next
        b[..., m] = b_next
    return b


def _basic_filter_step(e, u_prev, b1_to_m, alpha: float):
    """One time-step of F(z) for every chain at once: update the all-pass
    states e (..., M) given each chain's input one sample ago u_prev (...);
    returns (e_new, F_out)."""
    m = e.shape[-1]
    aa = 1.0 - alpha * alpha
    e_new = [aa * u_prev + alpha * e[..., 0]]
    for j in range(1, m):
        e_new.append(-alpha * e_new[j - 1] + e[..., j - 1] + alpha * e[..., j])
    e_new = torch.stack(e_new, dim=-1)
    return e_new, e_new @ b1_to_m


def _pade_terms(pade_order: int, device):
    """(A_l * (-1)^{l+1}, A_l) for l = 1..L, as fp32 tensors."""
    pade = pade_coefficients(pade_order)
    L = pade_order
    signs = torch.tensor([(-1.0) ** (l + 1) for l in range(1, L + 1)],
                         device=device)
    coef = torch.tensor(pade[1:], dtype=torch.float32, device=device)
    return coef * signs, coef


def _recursion(x, b_of, alpha: float, pade_order: int):
    """y[t] = v + sum_l A_l t_l with the chains' states carried over t;
    b_of(t) gives the (M+1,) coefficients of sample t."""
    L = pade_order
    m = b_of(0).shape[0] - 1
    signed, coef = _pade_terms(pade_order, x.device)
    e = torch.zeros((L, m), dtype=torch.float32, device=x.device)
    u_prev = torch.zeros((L,), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(x.shape[0]):
        b = b_of(t)
        e, tl = _basic_filter_step(e, u_prev, b[1:], float(alpha))
        # v = x + sum_l A_l (-1)^{l+1} t_l ; y = v + sum_l A_l t_l
        v = x[t] + torch.sum(signed * tl)
        ys.append(v + torch.sum(coef * tl))
        u_prev = torch.cat([v[None], tl[:-1]])
    return torch.stack(ys) if ys else x.new_zeros(0)


@torch.no_grad()
def mlsa_filter(x, b, alpha: float, pade_order: int = 5,
                inverse: bool = False):
    """Filter waveform x (T,) through exp(b0 + F(z)) (or its inverse), on
    x's device. b: (M+1,) mc2b coefficients. Returns (T,) float32."""
    x = torch.as_tensor(x, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32, device=x.device)
    if inverse:
        b = -b
    return torch.exp(b[0]) * _recursion(x, lambda t: b, alpha, pade_order)


@torch.no_grad()
def mlsa_filter_tv(x, b_frames, alpha: float, hop: int,
                   pade_order: int = 5):
    """Time-varying MLSA synthesis filter: per-frame mc2b coefficients
    b_frames (n_frames, M+1), held within each hop (SPTK mlsadf's frame-rate
    update), edge-padded past the last frame. Returns (T,) with
    T = len(x)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    t_len = x.shape[0]
    b_t = torch.repeat_interleave(
        torch.as_tensor(b_frames, dtype=torch.float32, device=x.device),
        hop, dim=0)
    if b_t.shape[0] < t_len:
        b_t = torch.cat([b_t, b_t[-1:].expand(t_len - b_t.shape[0], -1)])
    b_t = b_t[:t_len]
    return torch.exp(b_t[:, 0]) * _recursion(x, lambda t: b_t[t], alpha,
                                             pade_order)
