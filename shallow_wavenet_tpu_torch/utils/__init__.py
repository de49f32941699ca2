"""Host-side helpers of the port: the ctypes bindings over the repo's native
C++ signal library (`native.py`)."""
