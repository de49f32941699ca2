"""mu-law companding codec — the torch twin of `shallow_wavenet_tpu/ops/mulaw.py`.

encode: f(x) = sign(x) * ln(1 + mu|x|) / ln(1 + mu), mu = 255, x in [-1, 1];
quantize to `channels` uniform bins. decode: inverse + bin-centre
de-quantization. Same op order as the JAX functions, so fp32 results agree
exactly except where the `**` in `mulaw_decode` rounds differently (1 ulp).
"""

from __future__ import annotations

import torch


def mulaw_encode(x, mu: int = 255):
    """Compand x in [-1, 1] to [-1, 1] with mu-law."""
    x = torch.as_tensor(x)
    mu = torch.tensor(mu, dtype=x.dtype, device=x.device)
    return torch.sign(x) * torch.log1p(mu * torch.abs(x)) / torch.log1p(mu)


def mulaw_decode(y, mu: int = 255):
    """Inverse of mulaw_encode."""
    mu = torch.tensor(mu, dtype=y.dtype, device=y.device)
    return torch.sign(y) * ((1.0 + mu) ** torch.abs(y) - 1.0) / mu


def mulaw_quantize(x, channels: int = 256):
    """x in [-1, 1] -> int32 class ids in [0, channels)."""
    y = mulaw_encode(x, channels - 1)
    # [-1, 1] -> [0, channels): floor of the affine map, clipped at the top
    q = torch.floor((y + 1.0) * 0.5 * channels)
    return torch.clamp(q, 0, channels - 1).to(torch.int32)


def mulaw_dequantize(q, channels: int = 256, dtype=torch.float32):
    """Class ids -> bin-centre waveform values in [-1, 1]."""
    y = (q.to(dtype) + 0.5) * (2.0 / channels) - 1.0
    return mulaw_decode(y, channels - 1)
