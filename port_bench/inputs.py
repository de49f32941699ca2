"""Inputs the benchmark makes from `--seed` and hands to both the program
and the reference: the weights, normalized frames, uniforms and training
waveforms. Nothing here imports the program.

Weights follow the port's init recipe (`init_params_tree`): lecun-normal
kernels (std 1/sqrt(fan_in)), biases of std 0.01, unit-variance
embeddings, and, as chip_smoke's `random_tree` does so that the head
carries signal, a head2 kernel of std 0.05 (zero bias). They are drawn on
the device in one call from a `torch.Generator` seeded from the run's seed
and cut into leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.yardstick import dilations

# purposes of the seed streams drawn from one run seed
STREAMS = {"weights": 1, "traffic": 2, "corpus": 4,
           "sampler": 5, "streams": 6, "warm": 7}


def seed_of(seed: int, purpose: str, *index: int) -> int:
    """A 63-bit seed for one purpose (and index) of the run's seed; any
    whole number >= 0 is a valid run seed."""
    if seed < 0:
        raise ValueError("--seed must be >= 0")
    state = np.random.SeedSequence(
        [int(seed), STREAMS[purpose], *map(int, index)]).generate_state(2)
    return int((int(state[0]) << 31) ^ int(state[1])) & (2 ** 63 - 1)


def generator(seed: int, purpose: str, device, *index: int):
    return torch.Generator(device=device).manual_seed(
        seed_of(seed, purpose, *index))


def rng(seed: int, purpose: str, *index: int) -> np.random.Generator:
    return np.random.default_rng(seed_of(seed, purpose, *index))


def leaves(mc) -> list[tuple[str, tuple, float]]:
    """The flax-layout leaves of the model: (name, shape, std)."""
    R, G, S = (mc["residual_channels"], mc["gate_channels"],
               mc["skip_channels"])
    C, A, half = mc["cond_channels"], mc["aux_channels"], G // 2
    k = mc["kernel_size"]
    O = mc["quantize_channels"] if mc["head"] == "softmax" else 2
    out = [("upsampler/proj/kernel", (A, C), A ** -0.5),
           ("upsampler/proj/bias", (C,), 0.01)]
    for si, f in enumerate(mc["upsample_factors"]):
        out += [(f"upsampler/smooth{si}/kernel", (2 * f + 1, C, C),
                 (C * (2 * f + 1)) ** -0.5),
                (f"upsampler/smooth{si}/bias", (C,), 0.01)]
    if mc["n_speakers"] > 0:
        out.append(("speaker_embed/embedding", (mc["n_speakers"], C), 1.0))
    if mc["head"] == "softmax":
        out.append(("input_embed/embedding", (mc["quantize_channels"], R),
                    1.0))
    else:
        out += [("input_proj/kernel", (1, R), 1.0),
                ("input_proj/bias", (R,), 0.01)]
    for li in range(len(dilations(mc))):
        p = f"layer{li}/"
        out += [(p + "conv/kernel", (k, R, G), (R * k) ** -0.5),
                (p + "conv/bias", (G,), 0.01),
                (p + "cond/kernel", (C, G), C ** -0.5),
                (p + "res/kernel", (half, R), half ** -0.5),
                (p + "res/bias", (R,), 0.01),
                (p + "skip/kernel", (half, S), half ** -0.5),
                (p + "skip/bias", (S,), 0.01)]
    out += [("head1/kernel", (S, S), S ** -0.5), ("head1/bias", (S,), 0.01),
            ("head2/kernel", (S, O), 0.05), ("head2/bias", (O,), 0.0)]
    return out


def weights(mc, seed: int, device) -> dict:
    """{flax name: fp32 tensor on `device`}: one normal draw, cut and
    scaled per leaf."""
    spec = leaves(mc)
    sizes = [int(np.prod(s)) for _, s, _ in spec]
    scale = torch.cat([torch.full((n,), std, device=device)
                       for n, (_, _, std) in zip(sizes, spec)])
    flat = torch.randn(sum(sizes), device=device,
                       generator=generator(seed, "weights", device)) * scale
    return {name: part.view(shape) for (name, shape, _), part in
            zip(spec, torch.split(flat, sizes))}


def nested_numpy(w: dict) -> dict:
    """The flat mapping as a nested tree of numpy arrays (the layout the
    port's `params_from_flax` and `Trainer.init_state(tree=...)` take)."""
    tree: dict = {}
    for name, v in w.items():
        node = tree
        *parents, leaf = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().cpu().numpy()
    return tree


def uniforms(shape, gen: torch.Generator):
    """Uniforms in [1e-7, 1 - 1e-7] on the generator's device (the decode's
    noise range)."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (1.0 - 2e-7) + 1e-7


def stream_uniforms(stream_seed: int, n_blocks: int, block: int):
    """The uniforms a pooled stream opened with `stream_seed` consumes:
    each block's `default_rng(seed).uniform(1e-7, 1 - 1e-7, (1, block))`
    in fp32, in order (the session's documented draw)."""
    r = np.random.default_rng(stream_seed)
    return np.concatenate([r.uniform(1e-7, 1.0 - 1e-7, (1, block))
                           .astype(np.float32) for _ in range(n_blocks)],
                          axis=1)[0]
