"""ctypes loader for the native preprocessing library (top-level native/).

The port compiles its own copy of ``native/nngp_native.cpp`` into
``nngp_tpu_torch/_build/`` on first use, with the flags of
``native/Makefile`` (without OpenMP where the toolchain lacks it),
instead of loading the committed
``native/libnngp_native.so``: that binary was built with ``-march=native``
on another host and may hold instructions the running CPU lacks.  When no
C++ compiler is available the callers fall back to their NumPy paths
(the O(n^2) maxmin ordering, the Python first-fit colouring); ``path()``
says which one ran.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from nngp_tpu_torch.ops._build import REPO_DIR, host_library

_SRC = os.path.join(REPO_DIR, "native", "nngp_native.cpp")
_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")


@functools.cache
def _load():
    # OpenMP where the toolchain has it (the source also builds without,
    # single-threaded), else the NumPy paths
    lib, errors = None, []
    for flags in (_FLAGS + ("-fopenmp",), _FLAGS):
        try:
            lib = ctypes.CDLL(host_library(_SRC, "nngp_native", flags))
            break
        except (RuntimeError, OSError) as e:
            errors.append(str(e).strip().splitlines()[-1])
    if lib is None:
        print("native preprocessing library unavailable ("
              + "; ".join(errors) + "); using the NumPy paths", flush=True)
        return None
    lib.maxmin_order.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.maxmin_order.restype = None
    lib.greedy_coloring.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.greedy_coloring.restype = ctypes.c_int32
    return lib


def path() -> str:
    """'native' when the C++ library loads, else 'numpy'."""
    return "native" if _load() is not None else "numpy"


def maxmin_order_native(x: np.ndarray):
    """Native exact maxmin ordering, or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    n, d = x.shape
    out = np.empty(n, dtype=np.int64)
    lib.maxmin_order(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        d,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out


def greedy_coloring_native(indptr: np.ndarray, indices: np.ndarray, n: int):
    """Native first-fit coloring over CSR adjacency, or None."""
    lib = _load()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    out = np.empty(n, dtype=np.int32)
    lib.greedy_coloring(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out
