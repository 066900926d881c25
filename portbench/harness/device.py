"""The run's surroundings: environment, caches, the card, banned modules.

* ``clean_env`` drops every inherited ``RAYTPU_*`` variable, so each cell
  measures the program's defaults, and points the build and kernel caches
  that PyTorch and Triton honour at fixed directories inside the checkout.
  The program builds its own CUDA libraries and native BVH builder under
  its package's ``kernels/_build/``, also inside the checkout, keyed by
  source: only the first run of a checkout builds.
* ``heap_only_malloc`` serves every allocation from glibc's heap and keeps
  what is freed, so that a frame's large host buffers are reused instead
  of mapped anew and faulted in page by page, at a cost that swings from
  run to run on a shared host.
* ``card`` names the card and its power limit (``nvidia-smi``).
* ``banned_modules``: what the process has loaded of JAX or of the JAX
  package, by whole top-level names (``raytpu_torch`` is not ``raytpu``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

BANNED = ("jax", "jaxlib", "flax", "raytpu")


def process_start() -> float:
    """This process's start on the ``time.time()`` clock (from /proc, at
    clock-tick resolution); now, where /proc is missing."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def clean_env(root: str) -> list:
    """Drop ``RAYTPU_*`` and fix the cache directories; returns the names
    dropped."""
    dropped = sorted(k for k in os.environ if k.startswith("RAYTPU_"))
    for k in dropped:
        del os.environ[k]
    cache = os.path.join(root, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    return dropped


# glibc's mallopt parameters
M_TRIM_THRESHOLD = -1
M_MMAP_MAX = -4
TRIM_BYTES = 1 << 30


def heap_only_malloc() -> bool:
    """No allocation of this process mapped on its own (``M_MMAP_MAX`` 0),
    and free heap returned to the system only past 1 GiB at its top;
    whether glibc took both settings (False off glibc)."""
    try:
        libc = ctypes.CDLL("libc.so.6")
        return bool(libc.mallopt(M_MMAP_MAX, 0)) and bool(
            libc.mallopt(M_TRIM_THRESHOLD, TRIM_BYTES))
    except (OSError, AttributeError):
        return False


def card() -> dict:
    """{"name", "power_limit_w"} of card 0 (the limit None where
    nvidia-smi cannot say)."""
    import torch

    limit = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
        limit = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return {"name": torch.cuda.get_device_name(0), "power_limit_w": limit}


def banned_modules() -> list:
    """Loaded modules whose top-level name is one of ``BANNED``."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})
