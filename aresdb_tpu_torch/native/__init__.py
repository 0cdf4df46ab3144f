"""Native (C++) runtime components, loaded via ctypes.

The shared library is built on first import with g++ (the environment's
native toolchain); Python fallbacks exist for every component so the
framework degrades gracefully where no compiler is present.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "cuckoo_index.cpp")
_LIB = os.path.join(_DIR, "libaresnative.so")

_lock = threading.Lock()
_lib = None
_load_error: str = ""


def _build() -> None:
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", _SRC, "-o", _LIB,
    ]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)


def load():
    """Returns the ctypes library handle, building if needed; None on failure."""
    global _lib, _load_error
    with _lock:
        if _lib is not None:
            return _lib
        if _load_error:
            return None
        try:
            src_mtime = os.path.getmtime(_SRC)
            if not os.path.exists(_LIB) or \
                    os.path.getmtime(_LIB) < src_mtime:
                _build()
            lib = ctypes.CDLL(_LIB)
        except (OSError, subprocess.SubprocessError) as e:
            _load_error = str(e)
            return None
        c = ctypes.c_void_p
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)

        lib.cuckoo_new.restype = c
        lib.cuckoo_new.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.cuckoo_free.argtypes = [c]
        lib.cuckoo_size.restype = ctypes.c_int64
        lib.cuckoo_size.argtypes = [c]
        lib.cuckoo_bytes.restype = ctypes.c_int64
        lib.cuckoo_bytes.argtypes = [c]
        lib.cuckoo_set_cutoff.argtypes = [c, ctypes.c_uint32]
        lib.cuckoo_find.restype = ctypes.c_int
        lib.cuckoo_find.argtypes = [c, u8p, i32p, u32p]
        lib.cuckoo_find_or_insert.restype = ctypes.c_int
        lib.cuckoo_find_or_insert.argtypes = [
            c, u8p, ctypes.c_int32, ctypes.c_uint32, ctypes.c_uint32,
            i32p, u32p]
        lib.cuckoo_update.restype = ctypes.c_int
        lib.cuckoo_update.argtypes = [c, u8p, ctypes.c_int32, ctypes.c_uint32]
        lib.cuckoo_delete.argtypes = [c, u8p]
        lib.cuckoo_classify.argtypes = [
            c, u8p, ctypes.c_int, u8p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_uint32, ctypes.c_uint32,
            u8p, i32p, u32p, i32p]
        lib.cuckoo_dump.restype = ctypes.c_int64
        lib.cuckoo_dump.argtypes = [c, u8p, i32p, u32p, ctypes.c_int64]
        lib.cuckoo_reserve.argtypes = [c, ctypes.c_int64]
        lib.pk2_reserve.argtypes = [c, ctypes.c_int64]
        # partitioned primary key: identical surface, pk2_ prefix
        for pre in ("pk2_",):
            getattr(lib, pre + "new").restype = c
            getattr(lib, pre + "new").argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            getattr(lib, pre + "free").argtypes = [c]
            getattr(lib, pre + "size").restype = ctypes.c_int64
            getattr(lib, pre + "size").argtypes = [c]
            getattr(lib, pre + "bytes").restype = ctypes.c_int64
            getattr(lib, pre + "bytes").argtypes = [c]
            getattr(lib, pre + "set_cutoff").argtypes = \
                lib.cuckoo_set_cutoff.argtypes
            getattr(lib, pre + "find").restype = ctypes.c_int
            getattr(lib, pre + "find").argtypes = lib.cuckoo_find.argtypes
            getattr(lib, pre + "find_or_insert").restype = ctypes.c_int
            getattr(lib, pre + "find_or_insert").argtypes = \
                lib.cuckoo_find_or_insert.argtypes
            getattr(lib, pre + "update").restype = ctypes.c_int
            getattr(lib, pre + "update").argtypes = \
                lib.cuckoo_update.argtypes
            getattr(lib, pre + "delete").argtypes = \
                lib.cuckoo_delete.argtypes
            getattr(lib, pre + "classify").argtypes = \
                lib.cuckoo_classify.argtypes
            getattr(lib, pre + "dump").restype = ctypes.c_int64
            getattr(lib, pre + "dump").argtypes = lib.cuckoo_dump.argtypes
        lib.scatter_rows.argtypes = [
            u8p, u8p, i64p, i64p, ctypes.c_int64, ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def scatter_rows(dst, src, dst_idx, src_idx) -> bool:
    """dst[dst_idx[i]] = src[src_idx[i]] row-wise via the native library
    (fused gather+scatter, GIL released). Returns False when the native
    path is unavailable or the arrays don't qualify — callers fall back to
    numpy. Hot path of columnar ingestion (table_shard._write_rows_arrays)."""
    import numpy as np

    lib = load()
    if lib is None:
        return False
    if dst.dtype != src.dtype or dst.shape[1:] != src.shape[1:]:
        return False
    if not dst.flags["C_CONTIGUOUS"] or not src.flags["C_CONTIGUOUS"]:
        return False
    n = len(dst_idx)
    if n == 0:
        return True
    row_bytes = dst.dtype.itemsize
    for d in dst.shape[1:]:
        row_bytes *= d
    dst_idx = np.ascontiguousarray(dst_idx, np.int64)
    src_idx = np.ascontiguousarray(src_idx, np.int64)
    i64p_ = ctypes.POINTER(ctypes.c_int64)
    u8p_ = ctypes.POINTER(ctypes.c_uint8)
    lib.scatter_rows(
        dst.ctypes.data_as(u8p_), src.ctypes.data_as(u8p_),
        dst_idx.ctypes.data_as(i64p_), src_idx.ctypes.data_as(i64p_),
        ctypes.c_int64(n), ctypes.c_int64(row_bytes))
    return True
