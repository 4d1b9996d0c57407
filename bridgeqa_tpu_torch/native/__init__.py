"""Native (C++) data-loader kernels, ctypes-bound.

Replaces the reference's host-side per-sample vote-label Python loop
(``lib/dataset.py:496-510``) with a one-pass C++ kernel
(``src/dataset_ops.cpp``), called from ``data/pipeline.py``. Built on
first use with g++ (cached .so); callers fall back to the numpy
implementation when no compiler is available, so the package stays
importable everywhere. (The augmentation/gather steps stay in numpy: the
reference's interleaved per-axis box rotations pin the exact FP evaluation
order, and numpy fancy-indexing is already a native-speed gather.)

A copy of ``bridgeqa_tpu/native/__init__.py`` and its C++ source, kept in
the port because the port imports nothing of the JAX package, with one
change: the library is built into ``build/native/`` at the repository root
(listed in ``.gitignore``), not into the package directory, and written
under a temporary name first, so that worker processes building it at once
never load a half-written file. ``tests/test_torch_feed.py`` holds the two
equal. Both paths are host data code; ``available()`` says which one runs.
"""

import ctypes
import os
import subprocess

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "src", "dataset_ops.cpp")
_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
                         "build", "native", "_dataset_ops.so")
_lib = None
_build_error = None


def _build():
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    try:
        if not os.path.exists(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.compute_votes.restype = ctypes.c_int
        lib.compute_votes.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        _lib = lib
    except Exception as e:  # noqa: BLE001 — any failure means "no native path"
        _build_error = e
    return _lib


def available() -> bool:
    return _load() is not None


def _fptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def compute_votes(points, instance_labels, sem_ok):
    """points (N, 3) float32, instance_labels (N,) int32, sem_ok (N,) uint8
    -> (votes (N, 9) float32, mask (N,) float32). Numpy fallback preserves
    identical semantics (first-point-decides, min/max extents)."""
    points = np.ascontiguousarray(points, np.float32)
    instance_labels = np.ascontiguousarray(instance_labels, np.int32)
    sem_ok = np.ascontiguousarray(sem_ok, np.uint8)
    n = points.shape[0]
    votes = np.zeros((n, 9), np.float32)
    mask = np.zeros((n,), np.float32)

    lib = _load()
    if lib is not None:
        lib.compute_votes(
            _fptr(points), instance_labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            sem_ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(n), _fptr(votes), _fptr(mask),
        )
        return votes, mask

    for inst in np.unique(instance_labels):
        ind = np.where(instance_labels == inst)[0]
        if not sem_ok[ind[0]]:
            continue
        x = points[ind]
        center = 0.5 * (x.min(0) + x.max(0))
        votes[ind] = np.tile(center - x, (1, 3))
        mask[ind] = 1.0
    return votes, mask
