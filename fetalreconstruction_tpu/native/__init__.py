"""Native C++ tier: build-on-demand loader for the csrc/ modules.

The reference ships its host runtime in C/C++ (niftilib I/O, SLIC in C,
TBB orchestration); the device compute path here is JAX/XLA, and the host-side
native tier is csrc/{slic.cc, niftiz.cc}, compiled on first use with g++
into one shared library and loaded via ctypes.  Everything has a pure
NumPy fallback — the native tier is an accelerator, never a requirement.

Set FETALRECON_NO_NATIVE=1 to disable (falls back to Python paths).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC_DIR = os.path.join(os.path.dirname(__file__), "csrc")
_SOURCES = ["slic.cc", "niftiz.cc"]
_SO_NAME = "libfetalrecon_native.so"


def _build(so_path: str) -> bool:
    srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-pthread",
           *srcs, "-lz", "-o", so_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        return True
    except (OSError, subprocess.SubprocessError) as e:  # pragma: no cover
        sys.stderr.write(f"[native] build failed ({e}); using Python "
                         "fallbacks\n")
        return False


def _configure(lib: ctypes.CDLL) -> None:
    c_ubyte_p = ctypes.POINTER(ctypes.c_ubyte)
    lib.fr_slic_segment.restype = ctypes.c_int
    lib.fr_slic_segment.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32)]
    lib.fr_slic_segment_batch.restype = ctypes.c_int
    lib.fr_slic_segment_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.fr_nz_read.restype = c_ubyte_p
    lib.fr_nz_read.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_longlong)]
    lib.fr_nz_free.restype = None
    lib.fr_nz_free.argtypes = [c_ubyte_p]
    lib.fr_nz_read_many.restype = ctypes.c_int
    lib.fr_nz_read_many.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(c_ubyte_p), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_int]
    lib.fr_nz_write.restype = ctypes.c_int
    lib.fr_nz_write.argtypes = [ctypes.c_char_p, c_ubyte_p,
                                ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_int]


def get_lib():
    """The native library handle, or None when unavailable/disabled."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if _TRIED:
            return _LIB
        if os.environ.get("FETALRECON_NO_NATIVE"):
            _TRIED = True
            return None
        so_path = os.path.join(os.path.dirname(__file__), _SO_NAME)
        try:
            stale = (not os.path.exists(so_path)
                     or any(os.path.getmtime(os.path.join(_SRC_DIR, s))
                            > os.path.getmtime(so_path) for s in _SOURCES))
            if stale and not _build(so_path):
                _TRIED = True
                return None
            lib = ctypes.CDLL(so_path)
            _configure(lib)
            _LIB = lib
        except OSError as e:  # pragma: no cover
            sys.stderr.write(f"[native] load failed ({e}); using Python "
                             "fallbacks\n")
            _LIB = None
        _TRIED = True
        return _LIB


def read_bytes(path: str):
    """Decompressed file contents via the native codec, or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = ctypes.c_longlong(0)
    p = lib.fr_nz_read(os.fspath(path).encode(), ctypes.byref(n))
    if not p:
        return None
    try:
        return ctypes.string_at(p, n.value)
    finally:
        lib.fr_nz_free(p)


def read_bytes_many(paths, nthreads: int = 0):
    """Threaded batch read; returns list of bytes|None, or None if the
    native tier is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    if n == 0:
        return []
    if nthreads <= 0:
        nthreads = min(n, os.cpu_count() or 1)
    c_paths = (ctypes.c_char_p * n)(
        *[os.fspath(p).encode() for p in paths])
    bufs = (ctypes.POINTER(ctypes.c_ubyte) * n)()
    lens = (ctypes.c_longlong * n)()
    lib.fr_nz_read_many(n, c_paths, bufs, lens, nthreads)
    out = []
    for i in range(n):
        if bufs[i]:
            out.append(ctypes.string_at(bufs[i], lens[i]))
            lib.fr_nz_free(bufs[i])
        else:
            out.append(None)
    return out


def write_bytes(path: str, data: bytes, gzip_frame: bool,
                level: int = 6) -> bool:
    """Write (optionally gzip-compressed) bytes; False if unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    buf = (ctypes.c_ubyte * len(data)).from_buffer_copy(data)
    rc = lib.fr_nz_write(os.fspath(path).encode(), buf, len(data),
                         1 if gzip_frame else 0, level)
    return rc == 0


def slic_segment(img, num_superpixels: int, compactness: float = 10.0,
                 iterations: int = 5):
    """Native SLIC labels (H, W) int32, or None when unavailable."""
    import numpy as np
    lib = get_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, np.float32)
    h, w = img.shape
    out = np.empty((h, w), np.int32)
    rc = lib.fr_slic_segment(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w,
        int(num_superpixels), float(compactness), int(iterations),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out if rc >= 1 else None


def slic_segment_batch(imgs, num_superpixels: int,
                       compactness: float = 10.0, iterations: int = 5,
                       nthreads: int = 0):
    """Native batched SLIC over (N, H, W); returns (labels, counts) or
    None when unavailable."""
    import numpy as np
    lib = get_lib()
    if lib is None:
        return None
    imgs = np.ascontiguousarray(imgs, np.float32)
    n, h, w = imgs.shape
    if nthreads <= 0:
        nthreads = min(n, os.cpu_count() or 1)
    labels = np.empty((n, h, w), np.int32)
    counts = np.empty((n,), np.int32)
    lib.fr_slic_segment_batch(
        imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, h, w,
        int(num_superpixels), float(compactness), int(iterations),
        nthreads, labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels, counts
