"""Output heads: losses + sampling — the torch twins of
`shallow_wavenet_tpu/models/heads.py`.

(a) softmax head: 256-way categorical over 8-bit mu-law classes, CE loss,
    categorical sampling.
(b) Laplacian head: (mu, log b); NLL = log(2b) + |x - mu| / b; sampling via
    inverse CDF x = mu - b * sign(u) * ln(1 - 2|u|), u ~ U(-1/2, 1/2).

The key-based JAX samplers take an explicit `torch.Generator` here; their
draws cannot match JAX's PRNG bits. The shared-noise samplers
(`*_from_uniform`) are what the decode and the parity tests use.
"""

from __future__ import annotations

import math

import torch


def softmax_loss(logits, target_ids, mask=None):
    """Mean CE in nats. logits (B, T, Q), target_ids (B, T) int."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, target_ids[..., None].long())[..., 0]
    return _masked_mean(nll, mask)


def laplace_loss(out, target, log_b_min=-9.0, log_b_max=3.0, mask=None):
    """Mean Laplacian NLL. out (B, T, 2) = (mu, log b), target (B, T)."""
    mu, log_b = out[..., 0], torch.clamp(out[..., 1], log_b_min, log_b_max)
    nll = math.log(2.0) + log_b + torch.abs(target - mu) * torch.exp(-log_b)
    return _masked_mean(nll, mask)


def _masked_mean(x, mask):
    if mask is None:
        return torch.mean(x)
    # broadcast first so a (1, T) mask counts every batch row it covers
    mask = torch.broadcast_to(mask.to(x.dtype), x.shape)
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def sample_softmax(logits, generator: torch.Generator):
    """Categorical sample of class ids; logits (..., Q) -> (...) int32."""
    p = torch.softmax(logits.float(), dim=-1)
    ids = torch.multinomial(p.reshape(-1, p.shape[-1]), 1,
                            generator=generator)
    return ids.reshape(p.shape[:-1]).to(torch.int32)


def sample_laplace(out, generator: torch.Generator, log_b_min=-9.0,
                   log_b_max=3.0):
    """Laplace inverse-CDF sample; out (..., 2) -> (...) float32."""
    mu = out[..., 0]
    # u in (-1/2, 1/2); nudged away from the endpoints for a finite log
    u = torch.rand(mu.shape, generator=generator, device=mu.device,
                   dtype=mu.dtype)
    u = u * (1.0 - 2e-7) + (-0.5 + 1e-7)
    return laplace_from_uniform(out, u, log_b_min, log_b_max)


def laplace_from_uniform(out, u, log_b_min=-9.0, log_b_max=3.0):
    """Laplace inverse CDF from a supplied u in (-1/2, 1/2).
    out (..., 2) = (mu, log b); returns (...)."""
    mu, log_b = out[..., 0], torch.clamp(out[..., 1], log_b_min, log_b_max)
    return mu - torch.exp(log_b) * torch.sign(u) * torch.log1p(
        -2.0 * torch.abs(u))


def _upper_tri(q: int, dtype, device):
    i = torch.arange(q, device=device)
    return (i[:, None] <= i[None, :]).to(dtype)


def categorical_from_uniform(logits, u):
    """Inverse-CDF categorical sampling from ONE uniform per draw:
    id = #{q : cdf(q) < u}. logits (..., Q), u (...) in (0, 1).

    The CDF is p @ upper-triangular ones, the op the TPU kernel and the JAX
    function use, not `cumsum`: a uniform close to a bin edge then picks the
    same class on both sides far more often."""
    q = logits.shape[-1]
    p = torch.softmax(logits, dim=-1)
    cdf = p @ _upper_tri(q, p.dtype, p.device)
    ids = (cdf < u[..., None]).to(torch.int32).sum(dim=-1)
    return torch.clamp(ids, 0, q - 1).to(torch.int32)
