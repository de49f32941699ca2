"""Data I/O: file lists, decode batching, wav and HDF5 files."""
