"""shallow_wavenet_tpu_torch — the PyTorch/CUDA port of shallow_wavenet_tpu.

The JAX package beside it is the reference; this package imports nothing of
it (and never `jax` or `flax`). Module layout and names follow the JAX
package so each function's counterpart is easy to find:

  config.py  — copy of the dataclass config tree and presets
  ops/       — mu-law codec, STFT/log-mel, high-pass; mel-cepstrum and
               MCD, the MLSA filter, F0 and band aperiodicity, frame
               energy, WORLD-style synthesis; the AR-generation kernel
               wrapper and its build
  csrc/      — hand-written CUDA C++ kernels (compiled with nvcc at first use)
  models/    — torch WaveNet, output heads (losses, samplers), AR generation
               (one device, or a batch's rows split over devices), the
               streaming session and the multi-tenant StreamPool
  data/      — file lists, segment sampling, prefetching, decode batching,
               wav and HDF5 I/O (its own HDF5 codec where h5py is
               missing), the synthetic corpus
  training/  — the teacher-forced trainer (one device, or data-parallel
               over ranks) and its checkpoints
  parallel/  — the launcher's process group (torchrun), per-rank file-list
               shards, the gradient's mean all-reduce
  utils/     — ctypes bindings over the repo's native C++ signal library
  bin/       — the recipe runner (stages 0-6) and its CLIs: feature
               extraction, statistics, noise shaping, train (data-parallel
               under torchrun), copy-synthesis decode (--dp), evaluation;
               the probes

Entry points take `device=None`, meaning "cuda", and raise when CUDA is
absent; pass `device="cpu"` to run the plain PyTorch versions on the host.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """`None` means "cuda". Raise when CUDA is asked for and absent: there
    is no silent CPU path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the host")
    return dev
