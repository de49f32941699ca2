"""HDF5 feature reading — a copy of `read_hdf5` from
`shallow_wavenet_tpu/data/hdf5_io.py`. `h5py` is imported only here, when a
file is read, so the rest of the port runs on hosts without it."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def read_hdf5(path: str | Path, name: str) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        if name not in f:
            raise KeyError(f"dataset {name!r} not in {path}")
        return f[name][()]
