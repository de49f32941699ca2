"""Export a JAX training run's Orbax checkpoint to the PyTorch port's layout.

    python tools/export_torch_checkpoint.py <jax_workdir> <out_workdir> [--step N]

Reads `<jax_workdir>/config.json`, restores the latest checkpoint (or step
N) through the JAX `Trainer` (`init_state`, then `restore`), and writes
what the port's `Trainer.restore` reads:

    <out_workdir>/config.json
    <out_workdir>/checkpoints/<step>/params.npz     the flax parameter tree
    <out_workdir>/checkpoints/<step>/opt_state.npz  Adam's mu and nu, same names
    <out_workdir>/checkpoints/<step>/state.json     {"step", "sampler"}

written by the port's own `Trainer.save`, so the names cannot drift from
`models.wavenet.save_params_npz`. Then, on a host without JAX (the GPU
host), `python -m shallow_wavenet_tpu_torch.bin.train --workdir
<out_workdir> ...` resumes the run and `python -m
shallow_wavenet_tpu_torch.bin.decode --workdir <out_workdir> ...` decodes
with it.

This script needs JAX, Flax, optax and Orbax to read the checkpoint, so it
lives outside the port's package (which imports none of them); run it
where JAX runs and copy its output to the GPU host.

The optimizer state: Adam's moments are found by type
(`optax.ScaleByAdamState`) in the chain's state, which differs between
`adam` and `adamw`; every `count` in the chain must equal the checkpoint's
step, since the port keeps one count (`TrainState.step`), and the export
raises if one does not. The sampler state goes into `state.json`
unchanged. A multi-process JAX run's checkpoint holds only process 0's
sampler state (Orbax writes its JSON item from the primary host alone);
the port restores it in a single process, and under a launcher of another
rank count it warns and starts the samplers from their seeds.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

log = logging.getLogger("export_torch_checkpoint")


def _numpy_tree(tree):
    """A (possibly frozen) flax tree of arrays -> nested dicts of numpy."""
    if hasattr(tree, "items"):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def adam_moments(opt_state, step: int):
    """(mu, nu) of the chain's `optax.ScaleByAdamState`, after checking
    that every `count` in the chain equals `step`."""
    import jax
    import optax

    def has_count(x):
        return isinstance(x, tuple) and "count" in getattr(x, "_fields", ())

    counted = [x for x in jax.tree_util.tree_leaves(opt_state,
                                                    is_leaf=has_count)
               if has_count(x)]
    counts = {type(x).__name__: int(x.count) for x in counted}
    if not counted or any(int(x.count) != step for x in counted):
        raise ValueError(f"optimizer counts {counts} do not all equal the "
                         f"checkpoint's step {step}: the port keeps one count")
    adam = [x for x in counted if isinstance(x, optax.ScaleByAdamState)]
    if len(adam) != 1:
        raise ValueError(f"expected one ScaleByAdamState in the optimizer "
                         f"state, found {len(adam)}")
    return _numpy_tree(adam[0].mu), _numpy_tree(adam[0].nu)


def restore_jax(jax_workdir, step: int | None = None):
    """(cfg, state, sampler_state, step) of the JAX run's checkpoint: the
    latest, or `step`. Raises FileNotFoundError where there is none."""
    import orbax.checkpoint as ocp

    from shallow_wavenet_tpu.config import Config
    from shallow_wavenet_tpu.training import Trainer

    wd = Path(jax_workdir)
    cfg = Config.from_json((wd / "config.json").read_text())
    trainer = Trainer(cfg)
    state = trainer.init_state()
    if step is None:
        state, sampler, step = trainer.restore(wd, state)
        if step == 0:
            raise FileNotFoundError(f"no checkpoint under {wd}/checkpoints")
        return cfg, state, sampler, step
    mngr = trainer._ckpt_manager(wd)
    if step not in mngr.all_steps():
        raise FileNotFoundError(f"no checkpoint of step {step} under "
                                f"{wd}/checkpoints ({mngr.all_steps()})")
    restored = mngr.restore(step, args=ocp.args.Composite(
        state=ocp.args.StandardRestore(state),
        sampler=ocp.args.JsonRestore()))
    return cfg, restored["state"], restored.get("sampler") or None, step


def export(jax_workdir, out_workdir, step: int | None = None) -> int:
    """Write the port's checkpoint of the JAX run's latest (or `step`)
    checkpoint, and its config, under `out_workdir`. Returns the step."""
    from shallow_wavenet_tpu_torch.config import Config as PortConfig
    from shallow_wavenet_tpu_torch.training import TrainState
    from shallow_wavenet_tpu_torch.training import Trainer as PortTrainer

    _, state, sampler, step = restore_jax(jax_workdir, step)
    if int(state.step) != step:
        raise ValueError(f"checkpoint {step} holds step {int(state.step)}")
    mu, nu = adam_moments(state.opt_state, step)
    out = Path(out_workdir)
    out.mkdir(parents=True, exist_ok=True)
    text = (Path(jax_workdir) / "config.json").read_text()
    port_cfg = PortConfig.from_json(text)
    trainer = PortTrainer(port_cfg, "cpu")
    params = trainer.flat_params(_numpy_tree(state.params))
    trainer.save(out, TrainState(
        params=params, opt_state={"mu": trainer.flat_params(mu),
                                  "nu": trainer.flat_params(nu)},
        step=step), sampler)
    (out / "config.json").write_text(text)
    log.info("exported %s step %d to %s (%d parameters)", jax_workdir, step,
             out, params.numel())
    return step


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("jax_workdir", help="the JAX trainer's --workdir")
    p.add_argument("out_workdir", help="the port's workdir to write")
    p.add_argument("--step", type=int, default=None,
                   help="the checkpoint to export (default the latest)")
    args = p.parse_args(argv)
    import jax

    # reading a checkpoint needs no accelerator: keep JAX on the host
    jax.config.update("jax_platforms", "cpu")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s "
                               "%(message)s")
    return export(args.jax_workdir, args.out_workdir, args.step)


if __name__ == "__main__":
    main()
