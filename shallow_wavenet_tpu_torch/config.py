"""Config system: one dataclass tree, JSON serde, `key=value` CLI overrides.

A verbatim copy of `shallow_wavenet_tpu/config.py`, so the port's preset
names and numbers are the JAX package's without importing it (the port
never loads JAX). Keep the two files identical below this docstring;
`tests/test_torch_ops.py` checks that they are.

Replaces the reference's argparse-per-script + run.sh shell vars + per-recipe
conf/ files (SURVEY.md §5.6, component C1). The five named presets mirror the
five driver configs in BASELINE.json:7-11.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class ModelConfig:
    """Shallow/deep WaveNet hyper-parameters (SURVEY.md §A.2, component C6).

    shallow vs deep is purely a choice of (n_stacks, stack_size,
    residual/skip widths) — SURVEY.md §A.2.
    """

    n_stacks: int = 2           # repeats of the dilation cycle
    stack_size: int = 6         # dilations 1,2,4,...,2**(stack_size-1) per cycle
    residual_channels: int = 64
    gate_channels: int = 128    # split in two for tanh/sigmoid gates
    skip_channels: int = 128
    aux_channels: int = 80      # conditioning (log-mel) channels
    kernel_size: int = 2        # causal dilated conv taps
    head: str = "laplace"       # "softmax" (mu-law 256-way) | "laplace" (mu, log b)
    quantize_channels: int = 256  # softmax head classes (8-bit mu-law)
    upsample_factors: tuple[int, ...] = (4, 4, 4, 5)  # prod == hop_length
    cond_channels: int = 64     # post-upsample conditioning width
    n_speakers: int = 0         # >0 adds a speaker embedding to conditioning
    compute_dtype: str = "bfloat16"  # MXU-friendly; params stay float32
    log_b_min: float = -9.0     # Laplace scale clamp (SURVEY.md §A.3)
    log_b_max: float = 3.0
    # fold the k causal-conv taps into ONE (B*T, k*R) @ (k*R, G)
    # contraction instead of k separate K=R contractions: doubles the MXU
    # contraction depth of the training stack's hottest matmul (shallow
    # R=64 -> K=128 = full MXU depth) at the cost of materializing the
    # concatenated tap activations. Identical math and parameter tree
    # (sum over taps == contraction over the concatenated axis);
    # outputs equal to fp32 regrouping tolerance. Measured r4 — see
    # BASELINE.md training-throughput table
    fold_taps: bool = False

    @property
    def dilations(self) -> tuple[int, ...]:
        return tuple(
            2 ** i for _ in range(self.n_stacks) for i in range(self.stack_size)
        )

    @property
    def receptive_field(self) -> int:
        # kernel 2: each layer adds its dilation to the receptive field
        return 1 + sum(self.dilations) * (self.kernel_size - 1)


@dataclass(frozen=True)
class DataConfig:
    """Feature extraction + batching knobs (components C2, C10)."""

    sample_rate: int = 24000
    n_fft: int = 1024
    hop_length: int = 320
    win_length: int = 1024
    n_mels: int = 80
    fmin: float = 40.0
    fmax: float = 8000.0
    segment_length: int = 8000   # waveform samples per training crop
    batch_size: int = 8          # per-process utterance segments
    highpass_cutoff: float = 0.0
    # conditioning feature set: "mel" (log-mel, n_mels dims) or "world"
    # (log-F0 + vuv + mcep + band aperiodicity — the reference's WORLD/SPTK
    # path, components C2/C12; dims = 2 + mcep_order+1 + n_bap)
    feature_type: str = "mel"
    f0_min: float = 70.0
    f0_max: float = 400.0
    n_bap: int = 4
    # F0-adaptive lag-window smoothing of the mcep spectral envelope
    # (CheapTrick's core idea; world features only — the mcep then tracks
    # the envelope rather than harmonic peaks on strongly voiced frames)
    envelope_smoothing: bool = False
    # silence-aware segment sampling: this fraction of training draws is
    # forced to come from segments containing >=10% silent frames (frame
    # energy 40 dB below the utterance's peak frame). Silence is rare in
    # random crops, so deep AR models under-learn to stay quiet and
    # destabilize in long silent stretches (BASELINE.md r3 deep speechlike
    # row); 0.0 = off (exact round-3 sampling stream)
    silence_boost: float = 0.0
    # append a frame log-RMS channel to the conditioning (ops/energy.py):
    # the explicit silence/energy cue. The world set otherwise encodes
    # digital silence exactly like unvoiced noise (vuv=0, bap=1), which
    # cues a hiss floor in silent stretches (BASELINE.md r4 -21..-29 dB);
    # feature_dim grows by 1 when enabled
    energy_feature: bool = False


@dataclass(frozen=True)
class NoiseShapeConfig:
    """MLSA noise-shaping pre/de-emphasis (components C4, C5; SURVEY.md §A.4)."""

    enabled: bool = False
    mcep_order: int = 24
    alpha: float = 0.466         # all-pass warping @24 kHz
    mag: float = 0.5             # beta scaling of the averaged mcep
    pade_order: int = 5


@dataclass(frozen=True)
class TrainConfig:
    """Trainer knobs (component C11)."""

    steps: int = 200000
    learning_rate: float = 1e-4
    lr_decay_steps: int = 200000
    lr_decay_rate: float = 0.5
    weight_decay: float = 0.0
    grad_clip_norm: float = 10.0
    checkpoint_every: int = 10000
    keep_checkpoints: int = 5
    log_every: int = 100
    seed: int = 0
    # optimizer steps per device dispatch: K prefetched batches are stacked
    # and scanned inside ONE jitted call (lax.scan over the train step).
    # Identical math to K separate calls; amortizes the host->device
    # dispatch latency, which dominates wall clock for small models
    steps_per_call: int = 1
    # in-dispatch gradient accumulation: split each batch into N
    # microbatches, lax.scan the grads, ONE optimizer update on their
    # mean. Identical math to one big-batch step (mean-of-means over
    # equal microbatches; clip applied to the accumulated grad), but each
    # backward runs at B/N — the workaround for the XLA backward-pass
    # batch cliff beyond B~12 on v5e (BASELINE.md r3: B=16 backward is
    # 3.9x B=8; with grad_accum, effective B=32 trains at 4x the B=8
    # per-microbatch cost instead of 4 x 3.9x). batch_size % grad_accum
    # must be 0
    grad_accum: int = 1
    # AR-context span dropout (the pitch-binding lever; BASELINE.md r5
    # pitch mechanism): with probability context_dropout per span, a
    # span of the teacher-forced INPUT waveform is zeroed — the target
    # is never masked, and eval/inference never drop. Spans at or above
    # one pitch period (15 ms covers F0 >= ~67 Hz) remove the free
    # periodicity signal from the AR context inside that span, so the
    # only consistent pitch source the model can reduce loss with is
    # the lf0 conditioning row — the gradient pressure that binds pitch
    # to the conditioning, which teacher forcing otherwise removes.
    # 0.0 (the default) leaves the training step byte-identical to the
    # pre-knob trainer. Keyed off (seed, global step): deterministic and
    # checkpoint-exact across resume.
    context_dropout: float = 0.0
    context_dropout_span_ms: float = 15.0


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh for data parallelism (SURVEY.md §2.2, §5.8).

    The reference has no distributed backend; the rebuild's DP axis rides
    ICI within a slice and DCN across hosts via XLA collectives.
    """

    data_axis: str = "data"
    num_devices: int = 0         # 0 = all visible devices
    multihost: bool = False      # call jax.distributed.initialize()


def feature_dim(cfg: "Config") -> int:
    """Conditioning dimensionality implied by the data config — must equal
    model.aux_channels."""
    extra = 1 if cfg.data.energy_feature else 0
    if cfg.data.feature_type == "mel":
        return cfg.data.n_mels + extra
    if cfg.data.feature_type == "world":
        return 2 + (cfg.noise_shaping.mcep_order + 1) + cfg.data.n_bap + extra
    raise ValueError(f"unknown feature_type {cfg.data.feature_type!r}")


@dataclass
class Config:
    name: str = "default"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    noise_shaping: NoiseShapeConfig = field(default_factory=NoiseShapeConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # ---- serde ----------------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Config":
        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, dict):
                fields = {f.name: f for f in dataclasses.fields(tp)}
                kwargs = {}
                for k, v in val.items():
                    if k not in fields:
                        raise KeyError(f"unknown config key {tp.__name__}.{k}")
                    ft = fields[k].type
                    ft = _resolve_type(tp, ft)
                    if dataclasses.is_dataclass(ft):
                        kwargs[k] = build(ft, v)
                    elif isinstance(v, list):
                        kwargs[k] = tuple(v)
                    else:
                        kwargs[k] = v
                return tp(**kwargs)
            return val

        return build(cls, d)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    # ---- CLI overrides --------------------------------------------------
    def apply_overrides(self, overrides: list[str]) -> "Config":
        """Apply `section.key=value` overrides, e.g. `model.head=softmax`."""
        d = self.to_dict()
        for ov in overrides:
            if "=" not in ov:
                raise ValueError(f"override must be key=value, got {ov!r}")
            key, _, raw = ov.partition("=")
            parts = key.split(".")
            node = d
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"unknown config section {p!r} in {key!r}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"unknown config key {key!r}")
            node[leaf] = _parse_value(raw, node[leaf])
        return Config.from_dict(d)


def _resolve_type(owner, ft):
    """Dataclass field types may be strings under `from __future__ import annotations`."""
    if isinstance(ft, str):
        return globals().get(ft, str)
    return ft


def _parse_value(raw: str, current: Any) -> Any:
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, (tuple, list)):
        return tuple(json.loads(raw))
    return raw


# ---------------------------------------------------------------------------
# Named presets — one per BASELINE.json config (lines 7-11).
# ---------------------------------------------------------------------------

def _preset_1() -> Config:
    """Config 1: shallow, softmax mu-law, single-speaker copy-synthesis.

    CPU-runnable PR1 reference — tiny dims, 16 kHz-ish synthetic corpus.
    """
    c = Config(name="shallow_softmax_single")
    c.model = ModelConfig(
        n_stacks=1, stack_size=6, residual_channels=32, gate_channels=64,
        skip_channels=64, aux_channels=32, head="softmax",
        upsample_factors=(4, 4, 5), cond_channels=32,
        compute_dtype="float32",
    )
    c.data = DataConfig(
        sample_rate=16000, n_fft=512, hop_length=80, win_length=400,
        n_mels=32, fmax=7600.0, segment_length=4000, batch_size=4,
    )
    c.train = TrainConfig(steps=2000, learning_rate=4e-4,
                          checkpoint_every=500, log_every=50)
    return c


def _preset_2() -> Config:
    """Config 2: shallow, Laplacian head, single speaker, 24 kHz."""
    c = Config(name="shallow_laplace_single")
    c.model = ModelConfig(head="laplace")
    # 8 optimizer steps per dispatch (hardware-probed: 57 -> 82 steps/s on
    # a remote-attached v5e; identical math — see TrainConfig)
    c.train = TrainConfig(steps_per_call=8)
    return c


def _preset_3() -> Config:
    """Config 3: Laplacian head + data-driven MLSA noise shaping."""
    c = _preset_2()
    c.name = "shallow_laplace_ns"
    c.noise_shaping = NoiseShapeConfig(enabled=True)
    return c


def _preset_4() -> Config:
    """Config 4: multi-speaker, data-parallel over a v5e-8 host."""
    c = _preset_3()
    c.name = "multispk_dp"
    c.model = dataclasses.replace(c.model, n_speakers=4)
    c.data = dataclasses.replace(c.data, batch_size=8)  # per device
    c.mesh = MeshConfig(num_devices=0)
    return c


def _preset_5() -> Config:
    """Config 5: deep baseline (full-depth stack), N>=2 hosts.

    The data knobs default to the MEASURED-STABLE configuration (BASELINE.md
    r4/r5): world conditioning + silence-aware sampling + the explicit
    frame-energy channel. The as-shipped mel/no-boost combination was the
    measured-unstable one (deep AR blows up in long digital silence —
    r3 10.59 dB utterance); do not revert these without re-measuring.
    """
    c = Config(name="deep_baseline")
    c.model = ModelConfig(
        n_stacks=3, stack_size=10, residual_channels=128, gate_channels=256,
        skip_channels=256, head="laplace",
        aux_channels=32,  # world feature_dim: 2 + 25 + 4 + energy
    )
    c.data = DataConfig(feature_type="world", silence_boost=0.25,
                        energy_feature=True)
    c.noise_shaping = NoiseShapeConfig(enabled=True)
    c.mesh = MeshConfig(multihost=True)
    c.train = TrainConfig(steps_per_call=8)
    return c


PRESETS = {
    "shallow_softmax_single": _preset_1,
    "shallow_laplace_single": _preset_2,
    "shallow_laplace_ns": _preset_3,
    "multispk_dp": _preset_4,
    "deep_baseline": _preset_5,
}


def get_config(name: str, overrides: list[str] | None = None) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    cfg = PRESETS[name]()
    if overrides:
        cfg = cfg.apply_overrides(overrides)
    return cfg
