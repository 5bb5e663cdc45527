"""zstd one-shot compression through the runtime libzstd (libzstd.so.1)
by ctypes, for the pure-Python AGC reader (core/agc_ref.py) and the AGC
writer of the test inputs (utils/cases.py::write_agc).  Neither needs
the `zstandard` package or zstd's development headers.  The library is
loaded at the first call; a machine without it raises naming it.
"""
from __future__ import annotations

import ctypes
import threading

_lock = threading.Lock()
_lib = None


def _zstd():
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL("libzstd.so.1")
            except OSError as e:
                raise RuntimeError(
                    "the runtime libzstd (libzstd.so.1) cannot be loaded")\
                    from e
            sz, p = ctypes.c_size_t, ctypes.c_void_p
            for name, res, args in (
                    ("ZSTD_compress", sz, [p, sz, p, sz, ctypes.c_int]),
                    ("ZSTD_decompress", sz, [p, sz, p, sz]),
                    ("ZSTD_findFrameCompressedSize", sz, [p, sz]),
                    ("ZSTD_compressBound", sz, [sz]),
                    ("ZSTD_isError", ctypes.c_uint, [sz]),
                    ("ZSTD_getErrorName", ctypes.c_char_p, [sz])):
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
            _lib = lib
        return _lib


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"{what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def compress(data: bytes, level: int = 3) -> bytes:
    """One zstd frame of `data` (its content size in the frame header)."""
    lib = _zstd()
    cap = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = _check(lib, lib.ZSTD_compress(out, cap, data, len(data), level),
               "ZSTD_compress")
    return out.raw[:n]


def decompress(blob: bytes, out_size: int) -> bytes:
    """The first zstd frame of `blob` inflated, at most `out_size` bytes;
    bytes after the frame (an AGC part's trailing marker) are left out."""
    lib = _zstd()
    fs = _check(lib, lib.ZSTD_findFrameCompressedSize(blob, len(blob)),
                "ZSTD_findFrameCompressedSize")
    out = ctypes.create_string_buffer(max(out_size, 1))
    n = _check(lib, lib.ZSTD_decompress(out, out_size, blob, fs),
               "ZSTD_decompress")
    return out.raw[:n]
