"""Process group and per-rank data sharding — the torch twin of
`shallow_wavenet_tpu/parallel/mesh.py`.

The JAX package builds a 1-D ('data',) mesh over every device it sees and
lets XLA insert the gradient all-reduce. The port is data-parallel over
processes instead: one process drives one device, the launcher
(`torchrun --nproc-per-node N`) starts one process per rank and sets
`WORLD_SIZE`, `RANK`, `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT`, and
the trainer all-reduces its gradient itself (`training/trainer.py`).

`init_distributed` follows `make_mesh`'s rule, with those variables in the
place of JAX's coordinator variables:
- none set: one process on one device. A config that asks for more
  (`multihost`, or `num_devices > 1`) logs one warning and trains on the
  one device, as `make_mesh` goes on single-process when it finds no
  coordinator;
- any set: a configured launch. `torch.distributed.init_process_group`
  joins the group (NCCL on a CUDA device, gloo on the CPU), and each rank
  takes `cuda:LOCAL_RANK`. A failed initialize raises: going on alone
  would leave N processes writing checkpoints into one workdir.

What `num_devices` means here. In JAX it caps the devices one process
puts in its mesh (0: all). A port process always drives exactly one
device, so here it caps the data-parallel width:
- training: the width is the launcher's world size. `num_devices` larger
  than that width is cut to it, as JAX cuts it to the visible devices
  (without a launcher, with the warning above); a positive value smaller
  than a launched world raises, since the port cannot leave a launched
  rank idle;
- `decode --dp` (`dp_devices`): the visible CUDA devices cut to
  `num_devices` (0: all); on the CPU the host stands in for
  `max(1, num_devices)` devices, so the split runs there too.
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

from shallow_wavenet_tpu_torch import resolve_device
from shallow_wavenet_tpu_torch.config import MeshConfig
from shallow_wavenet_tpu_torch.data.dataset import shard_list

log = logging.getLogger(__name__)

# the variables `torchrun` sets for every rank; any of them set means a
# configured launch
LAUNCHER_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")

# how long a collective may wait for a rank before it raises
TIMEOUT = datetime.timedelta(minutes=10)


def launched() -> bool:
    """Whether the launcher's variables name a process group to join."""
    return any(os.environ.get(v) for v in LAUNCHER_VARS)


def init_distributed(mesh_cfg: MeshConfig | None = None,
                     device=None) -> torch.device:
    """Join the launcher's process group, or run as one process; returns
    this rank's device. device: None means CUDA (raises without it), on a
    launch `cuda:LOCAL_RANK`; "cpu" runs on the host (gloo). A group that
    is already up is joined as it is."""
    cfg = mesh_cfg or MeshConfig()
    dev = resolve_device(device)
    if not launched() and not dist.is_initialized():
        if cfg.multihost or cfg.num_devices > 1:
            log.warning("mesh asks for %s, but no launcher variable (%s) is "
                        "set: training as one process on %s",
                        "multihost" if cfg.multihost
                        else f"{cfg.num_devices} devices",
                        ", ".join(LAUNCHER_VARS), dev)
        return dev
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        try:
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method="env://", timeout=TIMEOUT,
                device_id=dev if dev.type == "cuda" else None)
        except (ValueError, RuntimeError) as e:
            raise RuntimeError(
                "init_process_group failed on a configured launch (" +
                ", ".join(f"{v}={os.environ.get(v)}" for v in LAUNCHER_VARS)
                + "): refusing to continue as one process, whose "
                "checkpoints would collide with the other ranks'") from e
    if 0 < cfg.num_devices < world():
        raise ValueError(f"mesh.num_devices={cfg.num_devices} is smaller "
                         f"than the launched world of {world()} ranks")
    log.info("process group up: rank %d of %d on %s (%s)", rank(), world(),
             dev, dist.get_backend())
    return dev


def shutdown() -> None:
    """Leave the process group, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def process_shard(items: list) -> list:
    """This rank's static shard of a host-side list (each rank reads only
    its own utterances)."""
    return shard_list(items, rank(), world())


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of `t` over the ranks, in place, as one all_reduce; `t`
    itself. Nothing without a process group; at world size 1 the values
    stay as they are, though the collective still runs. Every rank ends
    with the same bits."""
    if not dist.is_initialized():
        return t
    dist.all_reduce(t)
    if world() > 1:
        t /= world()
    return t


def dp_devices(mesh_cfg: MeshConfig | None = None,
               device=None) -> list[torch.device]:
    """The devices `decode --dp` splits a batch over: the visible CUDA
    devices cut to `mesh_cfg.num_devices` (0: all); with device "cpu",
    the host `max(1, num_devices)` times."""
    cfg = mesh_cfg or MeshConfig()
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * max(1, cfg.num_devices)
    n = torch.cuda.device_count()
    if cfg.num_devices > 0:
        n = min(n, cfg.num_devices)
    return [torch.device("cuda", i) for i in range(n)]
