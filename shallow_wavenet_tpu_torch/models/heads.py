"""Output-head samplers — the torch twins of `shallow_wavenet_tpu/models/heads.py`.

(a) softmax head: 256-way categorical over 8-bit mu-law classes.
(b) Laplacian head: (mu, log b); sampling via inverse CDF
    x = mu - b * sign(u) * ln(1 - 2|u|), u ~ U(-1/2, 1/2).

Only the shared-noise samplers the decode path uses live here; the losses
and key-based samplers come with the training slice.
"""

from __future__ import annotations

import torch


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
