"""ctypes bindings to the repo's native C++ signal library — the port's own
copy of `shallow_wavenet_tpu/utils/native.py`.

The sources are the repo's `native/mlsa.cc` and `native/featext.cc` (the
MLSA filter, mc2b, F0, band aperiodicity and mel-cepstrum analysis with a
plain C interface). This module compiles them itself, with
`g++ -O3 -fPIC -std=c++17 -shared`, at first use and under a lock of its
own, into `build/` beside this package (gitignored); the library's name
carries a hash of the sources and the flags, so an edited source never
loads a stale build. `native/` itself is only read.

These are CPU data-prep helpers (the feature pool's workers, noise
shaping), not device kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import shutil
import subprocess
from pathlib import Path

import numpy as np

from shallow_wavenet_tpu_torch.ops.f0 import BAP_F0_REFS, bap_window_length

log = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parent.parent
SOURCES = tuple(_PKG.parent / "native" / n for n in ("mlsa.cc", "featext.cc"))
BUILD_DIR = _PKG / "build"
FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_lib = None


def lib_path() -> Path:
    h = hashlib.sha1(" ".join(FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libswt_native_{h.hexdigest()[:12]}.so"


def _build(path: Path) -> None:
    """Compile the sources into `path`. Concurrent builders (spawned pool
    workers on a clean checkout) serialize on a lock; the first links the
    library, the rest find it."""
    import fcntl

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return
        cxx = shutil.which("g++")
        if cxx is None:
            raise OSError("g++ not found: the native library cannot be built")
        tmp = path.with_suffix(".tmp")
        subprocess.run([cxx, *FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                       check=True, capture_output=True, text=True)
        tmp.rename(path)


def load_native(build: bool = True) -> ctypes.CDLL:
    """Load (building if needed) the native library. Raises OSError or
    CalledProcessError if it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    path = lib_path()
    if build and not path.exists():
        _build(path)
    lib = ctypes.CDLL(str(path))
    fp = ctypes.POINTER(ctypes.c_float)
    dp = ctypes.POINTER(ctypes.c_double)
    lib.swt_mlsa_filter.argtypes = [
        fp, ctypes.c_int64, dp, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, fp,
    ]
    lib.swt_mlsa_filter.restype = None
    lib.swt_mc2b.argtypes = [dp, ctypes.c_int, ctypes.c_double, dp]
    lib.swt_mc2b.restype = None
    lib.swt_f0_estimate.argtypes = [
        fp, ctypes.c_int64, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, fp, fp,
        ctypes.c_int64,
    ]
    lib.swt_f0_estimate.restype = None
    lib.swt_band_aperiodicity.argtypes = [
        fp, ctypes.c_int64, fp, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, fp, ctypes.c_int64,
    ]
    lib.swt_band_aperiodicity.restype = None
    lib.swt_mcep.argtypes = [
        fp, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, fp, ctypes.c_int64,
    ]
    lib.swt_mcep.restype = None
    lib.swt_mcep_f0.argtypes = [
        fp, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_double, fp, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, fp, ctypes.c_int64,
    ]
    lib.swt_mcep_f0.restype = None
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the library loads (building it if needed); logs why not."""
    try:
        load_native()
        return True
    except (OSError, subprocess.CalledProcessError) as e:
        log.warning("native library unavailable: %s", e)
        return False


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def mlsa_filter_native(x: np.ndarray, b: np.ndarray, alpha: float,
                       pade_order: int = 5, inverse: bool = False
                       ) -> np.ndarray:
    """Native MLSA filter; x (T,) float32, b (M+1,) mc2b coefficients."""
    lib = load_native()
    x = np.ascontiguousarray(x, np.float32)
    b = np.ascontiguousarray(b, np.float64)
    y = np.empty_like(x)
    lib.swt_mlsa_filter(_fp(x), x.size, _dp(b), b.size - 1, float(alpha),
                        int(pade_order), int(inverse), _fp(y))
    return y


def mc2b_native(c: np.ndarray, alpha: float) -> np.ndarray:
    lib = load_native()
    c = np.ascontiguousarray(c, np.float64)
    b = np.empty_like(c)
    lib.swt_mc2b(_dp(c), c.size - 1, float(alpha), _dp(b))
    return b


def _n_frames_centered(t: int, win: int, hop: int) -> int:
    """Frame count of ops/stft.frame_signal(center=True): reflect-pad win//2
    each side, then 1 + (padded - win) // hop."""
    return 1 + (t + 2 * (win // 2) - win) // hop


def _f0_win(sample_rate: int, f0_min: float) -> int:
    w = int(2.5 * sample_rate / f0_min)
    return w + w % 2


def f0_native(x: np.ndarray, sample_rate: int, hop_length: int,
              win_length: int = 0, f0_min: float = 70.0,
              f0_max: float = 400.0, threshold: float = 0.45
              ) -> tuple[np.ndarray, np.ndarray]:
    """Native twin of ops/f0.estimate_f0 (same defaults and algorithm)."""
    lib = load_native()
    if win_length == 0:
        win_length = _f0_win(sample_rate, f0_min)
    x = np.ascontiguousarray(x, np.float32)
    n = _n_frames_centered(x.size, win_length, hop_length)
    f0 = np.empty(n, np.float32)
    vuv = np.empty(n, np.float32)
    lib.swt_f0_estimate(_fp(x), x.size, float(sample_rate), hop_length,
                        win_length, f0_min, f0_max, threshold, _fp(f0),
                        _fp(vuv), n)
    return f0, vuv


def _bap_pass_native(lib, x, f0, sample_rate, hop_length, win_length,
                     n_bands):
    n = min(_n_frames_centered(x.size, win_length, hop_length), f0.shape[0])
    f0c = np.ascontiguousarray(f0[:n], np.float32)
    out = np.empty((n, n_bands), np.float32)
    lib.swt_band_aperiodicity(_fp(x), x.size, _fp(f0c), float(sample_rate),
                              hop_length, win_length, n_bands, _fp(out), n)
    return out


def band_aperiodicity_native(x: np.ndarray, f0: np.ndarray,
                             sample_rate: int, hop_length: int,
                             win_length: int = 0, n_bands: int = 4
                             ) -> np.ndarray:
    """Native twin of ops/f0.band_aperiodicity (win_length=0 runs the same
    F0-adaptive window passes and per-frame selection)."""
    lib = load_native()
    x = np.ascontiguousarray(x, np.float32)
    if win_length:
        return _bap_pass_native(lib, x, f0, sample_rate, hop_length,
                                win_length, n_bands)
    passes = [_bap_pass_native(lib, x, f0, sample_rate, hop_length,
                               bap_window_length(sample_rate, f0_ref),
                               n_bands)
              for f0_ref in BAP_F0_REFS]
    out = passes[0]
    for f0_ref, ap in zip(BAP_F0_REFS[1:], passes[1:]):
        n = min(out.shape[0], ap.shape[0])
        out, ap = out[:n], ap[:n]
        sel = np.asarray(f0[:n]) >= f0_ref
        out[sel] = ap[sel]
    return out


def mcep_native(x: np.ndarray, n_fft: int, hop_length: int, win_length: int,
                order: int, alpha: float, eps: float = 1e-8,
                f0: np.ndarray | None = None, sample_rate: int = 0,
                f0_default: float = 300.0) -> np.ndarray:
    """Native twin of ops/mcep.mcep_analysis (freqt as the SPTK C loop);
    f0 + sample_rate enable the F0-adaptive envelope smoothing."""
    if n_fft <= 0 or n_fft & (n_fft - 1):
        raise ValueError(
            f"native mcep needs a power-of-two n_fft (got {n_fft}); use the "
            f"torch path (feature_extract --num-workers 1) for other sizes")
    lib = load_native()
    x = np.ascontiguousarray(x, np.float32)
    n = _n_frames_centered(x.size, win_length, hop_length)
    out = np.empty((n, order + 1), np.float32)
    if f0 is None:
        lib.swt_mcep(_fp(x), x.size, n_fft, hop_length, win_length, order,
                     float(alpha), eps, _fp(out), n)
    else:
        if not sample_rate:
            raise ValueError("f0-adaptive smoothing needs sample_rate")
        f0 = np.ascontiguousarray(f0, np.float32)
        lib.swt_mcep_f0(_fp(x), x.size, n_fft, hop_length, win_length,
                        order, float(alpha), eps, _fp(f0), f0.size,
                        float(sample_rate), float(f0_default), _fp(out), n)
    return out


def world_features_native(wav: np.ndarray, cfg) -> np.ndarray:
    """The `world` conditioning set ([lf0, vuv, mcep, bap]) through the
    native library: the pooled-worker twin of the torch world path of
    `bin/feature_extract.extract_one`."""
    sr = cfg.data.sample_rate
    f0, vuv = f0_native(wav, sr, cfg.data.hop_length,
                        f0_min=cfg.data.f0_min, f0_max=cfg.data.f0_max)
    lf0 = np.where(vuv > 0, np.log(np.maximum(f0, 1.0)), 0.0)
    mc = mcep_native(wav, cfg.data.n_fft, cfg.data.hop_length,
                     cfg.data.win_length, cfg.noise_shaping.mcep_order,
                     cfg.noise_shaping.alpha,
                     f0=(f0 * vuv if cfg.data.envelope_smoothing else None),
                     sample_rate=sr)
    bap = band_aperiodicity_native(wav, f0, sr, cfg.data.hop_length,
                                   n_bands=cfg.data.n_bap)
    n = min(lf0.shape[0], mc.shape[0], bap.shape[0],
            len(wav) // cfg.data.hop_length)
    return np.concatenate(
        [lf0[:n, None].astype(np.float32), vuv[:n, None], mc[:n], bap[:n]],
        axis=-1,
    )
