"""Host-side helpers of the port: the ctypes bindings over the repo's native
C++ signal library (`native.py`), and observability (`observability.py`:
TensorBoard scalars, profiler traces, the fail-fast NaN mode).

The JAX package's `utils/compile_cache.py` (a persistent XLA compilation
cache, so a repeated CLI call costs seconds rather than a compile) has no
counterpart module: eager PyTorch compiles nothing per call, and the port's
CUDA kernels are built once into `shallow_wavenet_tpu_torch/build/`, keyed
by a hash of their source and flags (`ops/_build.py`), which plays that
role."""
