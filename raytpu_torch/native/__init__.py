"""The native (C++) SAH/SBVH builder, loaded via ctypes.

The source is ``csrc/bvh_builder.cpp``, a verbatim copy of raytpu's
``raytpu/native/bvh_builder.cpp`` (tests/test_torch_host.py pins the
bytes), compiled with the same g++ flags, so both packages build
identical trees. The shared object is content-hashed into
``RAYTPU_NATIVE_CACHE`` when it is set, else into the port's git-ignored
build directory (raytpu's default is a directory under ``tempfile``).
With ``RAYTPU_NO_NATIVE`` set (read at first use, as raytpu reads it), or
with no toolchain, there is no native library and the host BVH build
falls back to the pure-Python builder in ``accel/bvh.py``, as raytpu's
does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from ..kernels._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "bvh_builder.cpp")
_FLAGS = ["-O2", "-march=native", "-std=c++17", "-shared", "-fPIC"]
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _cache_dir() -> str:
    d = os.environ.get("RAYTPU_NATIVE_CACHE", BUILD_DIR)
    os.makedirs(d, exist_ok=True)
    return d


def _load() -> Optional[ctypes.CDLL]:
    """Compile (once, content-hashed) and load the native library; None
    under RAYTPU_NO_NATIVE or when the source or the compiler is
    missing."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("RAYTPU_NO_NATIVE"):
        return None
    try:
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(_FLAGS).encode()
            ).hexdigest()[:16]
        so_path = os.path.join(_cache_dir(), f"bvh_builder_{digest}.so")
        if not os.path.exists(so_path):
            tmp = so_path + f".tmp{os.getpid()}"
            subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp],
                           check=True, capture_output=True)
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.raytpu_bvh_build.restype = ctypes.c_int
    lib.raytpu_bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # p0
        ctypes.POINTER(ctypes.c_float),  # e1
        ctypes.POINTER(ctypes.c_float),  # e2
        ctypes.c_int,                    # n
        ctypes.c_int,                    # leaf_size
        ctypes.POINTER(ctypes.c_float),  # nodes8 out
        ctypes.POINTER(ctypes.c_float),  # node8_rows out
        ctypes.POINTER(ctypes.c_int32),  # tri_order out
        ctypes.POINTER(ctypes.c_int32),  # out_counts
    ]
    _LIB = lib
    return _LIB


def native_available() -> bool:
    return _load() is not None


def native_build_bvh(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                     leaf_size: int):
    """Run the C++ builder; returns (threaded_nodes [N,8] f32,
    node8_rows [N8,128] f32, tri_order [L] i32) or None when the native
    library is unavailable."""
    lib = _load()
    if lib is None or p0.shape[0] == 0:
        return None
    n = int(p0.shape[0])
    p0 = np.ascontiguousarray(p0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    # m = worst-case reference count: n plus the builder's SBVH
    # duplication budget (n*2/5 + 8, bvh_builder.cpp)
    m = n + n * 2 // 5 + 8
    nodes = np.empty((2 * m + 1, 8), np.float32)
    wide = np.empty((m + 1, 128), np.float32)
    order = np.empty(m + (m + 1) * leaf_size, np.int32)
    counts = np.zeros(3, np.int32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.raytpu_bvh_build(
        ptr(p0, ctypes.c_float), ptr(e1, ctypes.c_float),
        ptr(e2, ctypes.c_float), n, leaf_size,
        ptr(nodes, ctypes.c_float), ptr(wide, ctypes.c_float),
        ptr(order, ctypes.c_int32), ptr(counts, ctypes.c_int32),
    )
    if rc != 0:
        return None
    n_nodes, n_wide, order_len = (int(c) for c in counts)
    return (
        nodes[:n_nodes].copy(),
        wide[:n_wide].copy(),
        order[:order_len].copy(),
    )
