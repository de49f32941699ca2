"""Trainer: eager PyTorch teacher-forced training loop, Adam, checkpoints."""

from shallow_wavenet_tpu_torch.training.trainer import Trainer, TrainState  # noqa: F401
