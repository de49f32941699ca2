"""HDF5 feature files — the port of `shallow_wavenet_tpu/data/hdf5_io.py`.

Per-utterance features ('feats') and the corpus statistics ('mean', 'std',
'avg_mcep') are named datasets at the root of `.h5` files. Where h5py is
installed it reads and writes them, imported only when a file is touched.
A host without h5py (the GPU host has none) uses the small codec below,
which writes and reads the same files: HDF5 in its oldest layout
(superblock 0, version-1 object headers, a symbol-table root group, the
layout h5py writes by default) holding contiguous little-endian numeric
datasets. h5py reads the codec's files, and the codec reads h5py's.
"""

from __future__ import annotations

import importlib.util
import struct
from pathlib import Path

import numpy as np


def _h5py():
    """The h5py module, or None where it is not installed."""
    if importlib.util.find_spec("h5py") is None:
        return None
    import h5py

    return h5py


def write_hdf5(path: str | Path, name: str, data: np.ndarray) -> None:
    """Write/overwrite dataset `name` in HDF5 file `path`."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    h5py = _h5py()
    if h5py is None:
        sets = _read_file(path) if Path(path).exists() else {}
        sets[name] = np.asarray(data)
        _write_file(path, sets)
        return
    with h5py.File(path, "a") as f:
        if name in f:
            del f[name]
        f.create_dataset(name, data=np.asarray(data))


def read_hdf5(path: str | Path, name: str) -> np.ndarray:
    h5py = _h5py()
    if h5py is None:
        sets = _read_file(path)
        if name not in sets:
            raise KeyError(f"dataset {name!r} not in {path}")
        return sets[name]
    with h5py.File(path, "r") as f:
        if name not in f:
            raise KeyError(f"dataset {name!r} not in {path}")
        return f[name][()]


def list_hdf5(path: str | Path) -> list[str]:
    h5py = _h5py()
    if h5py is None:
        return sorted(_read_file(path))
    with h5py.File(path, "r") as f:
        out: list[str] = []
        f.visit(lambda k: out.append(k))
        return out


# ---------------------------------------------------------------------------
# the codec: HDF5 file format specification 2.0, with 8-byte offsets and
# lengths; root-level datasets only

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_INTERNAL_K = 16                     # group B-tree node: 2K children
_BTREE_BYTES = 24 + 2 * _INTERNAL_K * 8 + (2 * _INTERNAL_K + 1) * 8


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(kind: int, body: bytes, flags: int = 0) -> bytes:
    body = _pad8(body)
    return struct.pack("<HHB3x", kind, len(body), flags) + body


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BxHII4x", 1, len(messages), 1, len(body)) + body


def _datatype(dt: np.dtype) -> bytes:
    if dt.kind == "f" and dt.itemsize in (4, 8):
        bits = dt.itemsize * 8
        exp, mant, bias = (8, 23, 127) if bits == 32 else (11, 52, 1023)
        return (bytes([0x11, 0x20, bits - 1, 0])
                + struct.pack("<IHHBBBBI", dt.itemsize, 0, bits, mant, exp,
                              0, mant, bias))
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        return (bytes([0x10, 0x08 if dt.kind == "i" else 0, 0, 0])
                + struct.pack("<IHH", dt.itemsize, 0, dt.itemsize * 8))
    raise TypeError(f"the HDF5 codec writes ints and float32/64, not {dt}")


def _dataset_header(a: np.ndarray, data_addr: int) -> bytes:
    space = struct.pack("<BBBx4x", 1, a.ndim, 0) + struct.pack(
        f"<{a.ndim}Q", *a.shape)
    fill = bytes([2, 2, 2, 0])           # allocated late, never written
    layout = struct.pack("<BBQQ", 3, 1, data_addr, a.nbytes)
    return _object_header([_message(0x1, space),
                           _message(0x3, _datatype(a.dtype), flags=1),
                           _message(0x5, fill, flags=1),
                           _message(0x8, layout)])


def _write_file(path, sets: dict) -> None:
    names = sorted(sets)
    for n in names:
        if "/" in n or not n:
            raise ValueError(f"the HDF5 codec writes root datasets, not {n!r}")
    arrays = {}
    for n in names:
        a = np.asarray(sets[n])
        if a.ndim == 0:
            a = a.reshape(1)
        arrays[n] = np.ascontiguousarray(a.astype(a.dtype.newbyteorder("<")))
    leaf_k = max(4, -(-len(names) // 2))
    heap_data, name_off = bytearray(8), {}
    for n in names:
        name_off[n] = len(heap_data)
        heap_data += _pad8(n.encode() + b"\0")
    root_ohdr = 96
    root = _object_header([_message(0x11, b"\0" * 16)])
    heap = root_ohdr + len(root)
    heap_seg = heap + 32
    btree = heap_seg + len(heap_data)
    snod = btree + _BTREE_BYTES
    pos = snod + 8 + 2 * leaf_k * 40
    headers, data_at = {}, {}
    for n in names:
        a = arrays[n]
        size = len(_dataset_header(a, 0))
        headers[n] = pos
        data_at[n] = pos + size
        pos = data_at[n] + a.nbytes + (-a.nbytes % 8)
    root = _object_header([_message(0x11, struct.pack("<QQ", btree, heap))])
    out = bytearray()
    out += _SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
    out += struct.pack("<HHI", leaf_k, _INTERNAL_K, 0)
    out += struct.pack("<QQQQ", 0, _UNDEF, pos, _UNDEF)
    out += struct.pack("<QQI4xQQ", 0, root_ohdr, 1, btree, heap)
    out += root
    # a free-list offset of 1 is the library's "no free block"
    out += b"HEAP" + bytes([0, 0, 0, 0]) + struct.pack(
        "<QQQ", len(heap_data), 1, heap_seg)
    out += heap_data
    node = b"TREE" + struct.pack("<BBHQQ", 0, 0, 1 if names else 0,
                                 _UNDEF, _UNDEF)
    if names:
        node += struct.pack("<QQQ", 0, snod, name_off[names[-1]])
    out += node + b"\0" * (_BTREE_BYTES - len(node))
    entries = b"".join(struct.pack("<QQI4x16x", name_off[n], headers[n], 0)
                       for n in names)
    out += b"SNOD" + struct.pack("<BxH", 1, len(names)) + entries
    out += b"\0" * (2 * leaf_k * 40 - len(entries))
    for n in names:
        a = arrays[n]
        assert len(out) == headers[n]
        out += _dataset_header(a, data_at[n])
        out += _pad8(a.tobytes())
    assert len(out) == pos
    Path(path).write_bytes(bytes(out))


def _messages(buf: bytes, addr: int) -> list[tuple[int, bytes]]:
    """(type, body) of every message of the version-1 object header at
    `addr`, continuation blocks included."""
    version, n, _, size = struct.unpack_from("<BxHII", buf, addr)
    if version != 1:
        raise ValueError(f"object header version {version} (the codec reads "
                         "version 1: h5py's default layout)")
    out, blocks = [], [(addr + 16, size)]
    while blocks and len(out) < n:
        at, size = blocks.pop(0)
        end = at + size
        while at + 8 <= end and len(out) < n:
            kind, length = struct.unpack_from("<HH", buf, at)
            body = buf[at + 8:at + 8 + length]
            if kind == 0x10:
                blocks.append(struct.unpack_from("<QQ", body))
            out.append((kind, body))
            at += 8 + length
    return out


def _dtype_of(body: bytes) -> np.dtype:
    cls, b0 = body[0] & 0x0F, body[1]
    (size,) = struct.unpack_from("<I", body, 4)
    order = ">" if b0 & 1 else "<"
    if cls == 1:
        return np.dtype(f"{order}f{size}")
    if cls == 0:
        return np.dtype(f"{order}{'i' if b0 & 0x08 else 'u'}{size}")
    raise TypeError(f"HDF5 datatype class {cls} is not numeric")


def _dataset(buf: bytes, addr: int) -> np.ndarray:
    shape = dtype = data = None
    for kind, body in _messages(buf, addr):
        if kind == 0x1:
            version, rank = body[0], body[1]
            at = 8 if version == 1 else 4
            shape = struct.unpack_from(f"<{rank}Q", body, at)
        elif kind == 0x3:
            dtype = _dtype_of(body)
        elif kind == 0x8:
            if body[0] != 3 or body[1] not in (0, 1):
                raise ValueError("the codec reads contiguous or compact "
                                 "datasets (layout message version 3)")
            if body[1] == 0:
                (n,) = struct.unpack_from("<H", body, 2)
                data = bytes(body[4:4 + n])
            else:
                at, n = struct.unpack_from("<QQ", body, 2)
                data = buf[at:at + n] if at != _UNDEF else b""
    count = int(np.prod(shape)) if shape else 1
    a = np.frombuffer(data, dtype, count=count).reshape(shape)
    return a.astype(dtype.newbyteorder("="))


def _read_file(path) -> dict:
    buf = Path(path).read_bytes()
    if buf[:8] != _SIGNATURE or buf[8] not in (0, 1) or buf[13:15] != b"\x08\x08":
        raise ValueError(f"{path}: not an HDF5 file with superblock 0 or 1 "
                         "and 8-byte offsets")
    root = 56 if buf[8] == 0 else 60
    (ohdr,) = struct.unpack_from("<Q", buf, root + 8)
    table = [b for k, b in _messages(buf, ohdr) if k == 0x11]
    if not table:
        raise ValueError(f"{path}: the root group has no symbol table")
    btree, heap = struct.unpack_from("<QQ", table[0])
    if buf[heap:heap + 4] != b"HEAP":
        raise ValueError(f"{path}: bad local heap")
    (seg,) = struct.unpack_from("<Q", buf, heap + 24)

    def name(off):
        end = buf.index(b"\0", seg + off)
        return buf[seg + off:end].decode()

    out = {}

    def walk(node):
        if buf[node:node + 4] != b"TREE":
            raise ValueError(f"{path}: bad group B-tree node")
        _, level, used = struct.unpack_from("<BBH", buf, node + 4)
        for i in range(used):
            (child,) = struct.unpack_from("<Q", buf, node + 24 + 8 + 16 * i)
            if level:
                walk(child)
                continue
            if buf[child:child + 4] != b"SNOD":
                raise ValueError(f"{path}: bad symbol table node")
            (count,) = struct.unpack_from("<H", buf, child + 6)
            for e in range(count):
                off, obj, cache = struct.unpack_from("<QQI", buf,
                                                     child + 8 + 40 * e)
                if cache == 1:
                    raise ValueError(f"{path}: the codec reads root "
                                     "datasets, not groups")
                out[name(off)] = _dataset(buf, obj)

    walk(btree)
    return out
