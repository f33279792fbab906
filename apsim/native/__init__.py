"""ctypes loader for the native C++ helpers (``apsim_native.cpp`` beside this file).

Builds the shared library on first use with g++ (the C ABI + ctypes keeps
the binding dependency-free) and caches the .so under the checkout's
``build/native`` (``APSIM_NATIVE_CACHE`` overrides), keyed by a content
hash.  Every entry point has a pure
Python/NumPy fallback, so the package works even without a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

__all__ = [
    "get_lib",
    "native_available",
    "hash_corpus",
    "pad_batch",
    "crc32",
    "native_pair_dots",
]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "apsim_native.cpp")
_lock = threading.Lock()
_lib = None
_tried = False


def _build(src: str) -> str | None:
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    checkout = os.path.dirname(os.path.dirname(os.path.dirname(src)))
    cache = os.environ.get(
        "APSIM_NATIVE_CACHE", os.path.join(checkout, "build", "native")
    )
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, f"apsim_native_{digest}.so")
    if os.path.exists(so):
        return so
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-ffp-contract=off",
        "-shared", "-fPIC", src, "-o", so + ".tmp",
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(so + ".tmp", so)
        return so
    except Exception as e:  # no compiler / failure -> Python fallback
        print(f"apsim_native build failed ({e}); using Python fallback",
              file=sys.stderr)
        return None


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SRC):
            return None
        so = _build(_SRC)
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        lib.apsim_crc32.restype = ctypes.c_uint32
        lib.apsim_crc32.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.apsim_hash_corpus.restype = ctypes.c_int64
        lib.apsim_hash_corpus.argtypes = [
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.c_uint32,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
        ]
        lib.apsim_pad_batch.restype = ctypes.c_int32
        lib.apsim_pad_batch.argtypes = [
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        ]
        lib.apsim_pair_dots.restype = None
        lib.apsim_pair_dots.argtypes = [
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.apsim_group_dots.restype = None
        lib.apsim_group_dots.argtypes = [
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def crc32(data: bytes) -> int:
    lib = get_lib()
    if lib is None:
        import zlib

        return zlib.crc32(data)
    return int(lib.apsim_crc32(data, len(data)))


def hash_corpus(docs: list[str], num_features: int):
    """Native HashingTF over a document list -> (indptr, indices, values).
    Returns None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    blobs = [d.encode("utf-8") for d in docs]
    offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
    for i, b in enumerate(blobs):
        offsets[i + 1] = offsets[i] + len(b)
    text = b"".join(blobs)
    # worst-case nnz = token count <= bytes/2 + n_docs; start smaller
    cap = max(int(offsets[-1] // 4) + len(blobs) + 16, 1024)
    while True:
        indptr = np.zeros(len(blobs) + 1, dtype=np.int64)
        indices = np.empty(cap, dtype=np.int32)
        values = np.empty(cap, dtype=np.float64)
        nnz = lib.apsim_hash_corpus(
            text, offsets, len(blobs), num_features, indptr, indices, values,
            cap,
        )
        if nnz >= 0:
            return indptr, indices[:nnz].copy(), values[:nnz].copy()
        cap *= 2


def native_pair_dots(
    a_indptr, a_indices, a_data, b_indptr, b_indices, b_data, a_rows, b_rows
):
    """Exact fp64 dots of (a_rows[p] of A) · (b_rows[p] of B); None if the
    native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    a_rows = np.ascontiguousarray(a_rows, np.int64)
    b_rows = np.ascontiguousarray(b_rows, np.int64)
    # the C loop indexes indptr[row + 1] unchecked — an out-of-range row id
    # (an upstream bug, e.g. a leaked padded row) must raise here instead of
    # reading past the arrays (observed as a segfault)
    for rows, indptr, name in (
        (a_rows, a_indptr, "a_rows"), (b_rows, b_indptr, "b_rows"),
    ):
        if rows.size and (
            int(rows.min()) < 0 or int(rows.max()) >= len(indptr) - 1
        ):
            raise IndexError(
                f"{name} out of range [0, {len(indptr) - 1}): "
                f"min={int(rows.min())}, max={int(rows.max())}"
            )
    out = np.empty(a_rows.size, dtype=np.float64)
    lib.apsim_pair_dots(
        np.ascontiguousarray(a_indptr, np.int64),
        np.ascontiguousarray(a_indices, np.int32),
        np.ascontiguousarray(a_data, np.float64),
        np.ascontiguousarray(b_indptr, np.int64),
        np.ascontiguousarray(b_indices, np.int32),
        np.ascontiguousarray(b_data, np.float64),
        a_rows, b_rows, a_rows.size, out,
    )
    return out


def native_group_dots(indptr, cindices, data, a_rows, b_rows, scratch):
    """Grouped same-matrix fp64 pair dots (see apsim_group_dots in the C
    source): ``a_rows`` MUST be sorted ascending and ``cindices`` must be the
    compact-dim translation of the CSR's indices with values in
    ``[0, len(scratch))``.  ``scratch`` must be all-zero on entry (it is
    restored to all-zero on return).  Returns None if the native library is
    unavailable; bit-identical to ``native_pair_dots`` on the same pairs."""
    lib = get_lib()
    if lib is None:
        return None
    a_rows = np.ascontiguousarray(a_rows, np.int64)
    b_rows = np.ascontiguousarray(b_rows, np.int64)
    indptr = np.ascontiguousarray(indptr, np.int64)
    cindices = np.ascontiguousarray(cindices, np.int32)
    data = np.ascontiguousarray(data, np.float64)
    if cindices.size != data.size or len(indptr) < 1 or int(indptr[-1]) > cindices.size:
        raise ValueError("CSR arrays inconsistent")
    # the C loop indexes indptr[row + 1] and scratch[cindex] unchecked
    for rows, name in ((a_rows, "a_rows"), (b_rows, "b_rows")):
        if rows.size and (
            int(rows.min()) < 0 or int(rows.max()) >= len(indptr) - 1
        ):
            raise IndexError(
                f"{name} out of range [0, {len(indptr) - 1}): "
                f"min={int(rows.min())}, max={int(rows.max())}"
            )
    # NOTE cindices range vs scratch is validated ONCE at translation build
    # time (rescore.build_compact) — a per-call scan would be O(corpus nnz)
    # and cost more than the dots themselves
    out = np.empty(a_rows.size, dtype=np.float64)
    lib.apsim_group_dots(
        indptr, cindices, data, a_rows, b_rows, a_rows.size, scratch, out,
    )
    return out


def pad_batch(indptr, indices, values, k: int, pad_dim: int):
    """Native padded-batch builder; returns (dims, vals, lengths) or None."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(indptr) - 1
    dims = np.empty((n, k), dtype=np.int32)
    vals = np.empty((n, k), dtype=np.float32)
    lengths = np.empty(n, dtype=np.int32)
    rc = lib.apsim_pad_batch(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        np.ascontiguousarray(values, np.float64),
        n, k, pad_dim, dims, vals, lengths,
    )
    if rc != 0:
        raise ValueError("row nnz exceeds padded width")
    return dims, vals, lengths
