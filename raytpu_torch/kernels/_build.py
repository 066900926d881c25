"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface (the strand walks
share ``csrc/strand_common.cuh``). At first use it is
compiled by ``nvcc`` into a shared object under the package's git-ignored
``_build/`` directory, keyed by a hash of the source and the flags, and
loaded with ``ctypes``; the wrappers pass ``data_ptr()``s and the current
stream. This needs neither ninja nor pybind11 and compiles in seconds,
because no source includes PyTorch's headers.

The flags pin the float rules the kernels share with their plain torch
versions: no FMA contraction, IEEE division and square root, and no
flush-to-zero. A missing ``nvcc`` or a failed build raises; nothing falls
back to the plain version.

Building and loading are thread-safe: one re-entrant module lock
(``LOCK``) serialises them, so two threads that ask for one library at
once build it once, and the wrappers' lazy initialisers hold the same lock
around ``load_library``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = [
    "-arch=sm_90a", "-O3", "--fmad=false", "-prec-div=true",
    "-prec-sqrt=true", "-ftz=false", "-std=c++17", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LOCK = threading.RLock()
# per source name, the libraries this process built (nvcc runs) and loaded
# (``load_library`` calls), under LOCK
BUILDS: dict = {}
LOADS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
        "CUDA kernels cannot be built"
    )


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to with the current flags (keyed by
    the source, every shared header in ``csrc/`` and the flags)."""
    h = hashlib.sha256()
    for src in [name + ".cu"] + sorted(
            f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"{name}_{digest}.so")


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its shared object is missing, then load
    it. The compiler's output, with ptxas's register and spill report, is
    kept beside it as ``<so>.log``. Holds ``LOCK`` throughout; the
    temporary file is named per process and thread."""
    so_path = library_path(name)
    with LOCK:
        if not os.path.exists(so_path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = so_path + f".tmp{os.getpid()}.{threading.get_ident()}"
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, os.path.join(CSRC, name + ".cu"),
                 "-o", tmp],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {name}.cu (rc {proc.returncode}):"
                    f"\n{proc.stdout}\n{proc.stderr}"
                )
            with open(so_path + ".log", "w") as f:
                f.write(proc.stdout + proc.stderr)
            os.replace(tmp, so_path)
            BUILDS[name] = BUILDS.get(name, 0) + 1
        LOADS[name] = LOADS.get(name, 0) + 1
        return ctypes.CDLL(so_path)


def build_log(name: str) -> str:
    """The compiler output kept from the build of ``csrc/<name>.cu``."""
    with open(library_path(name) + ".log") as f:
        return f.read()


def kernel_resources(name: str) -> dict:
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads",
    "smem"}} from ptxas's report in the build log of ``csrc/<name>.cu``
    (bytes for spills and static shared memory)."""
    out, kernel = {}, None
    for line in build_log(name).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            kernel = m.group(1)
            out[kernel] = dict(registers=0, spill_stores=0, spill_loads=0,
                               smem=0)
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[kernel].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[kernel]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[kernel]["smem"] = int(s.group(1)) if s else 0
    return out
