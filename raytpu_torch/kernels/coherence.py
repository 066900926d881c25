"""The engine's coherence sort key: the CUDA kernel and its plain torch
version.

``_ray_sort_key`` (engine/render.py) keys a wave's rays before each sorted
query: dead lanes last, then the direction's octant (major), then the
Morton cell of the origin, the scene's root box quantised to ``bits``
bits an axis (raytpu's RAYTPU_MORTON_BITS, at most 9 so that the dead key
``1 << (3 * bits + 3)`` stays in int32). The fused wave mode sorts by the
unique composite ``key << 32 | pxi`` (int64).

``coherence_key_torch`` is the plain version, raytpu's torch ops in its
order, which the CPU runs: ~60 elementwise launches a key.
``coherence_key_cuda`` launches ``csrc/coherence_key.cu`` (one thread a
lane) and returns the same tensor, bit for bit; the kernel follows the
plain version's float order and ATen's float-to-int conversion on the
card."""

from __future__ import annotations

import ctypes

import torch


def _morton(q, bits: int):
    """Interleave three ``bits``-wide integer coordinates into a
    3*bits-bit Morton code."""
    def spread(x):  # Part1By2 bit spreading (<= 10-bit inputs)
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    return spread(q[0]) | (spread(q[1]) << 1) | (spread(q[2]) << 2)


def dead_key(bits: int) -> int:
    """The key of a dead lane: above every live key, so dead lanes sort
    last."""
    return 1 << (3 * bits + 3)


def coherence_key_torch(ro, rd, alive, bmin, bmax, bits: int, pxi=None):
    """The coherence key of each lane (int32 [R]), or with ``pxi`` (int32
    [R]) the composite ``key << 32 | pxi`` (int64 [R]): ``ro``, ``rd``
    f32 [R, 3], ``alive`` bool [R], the scene's root box ``bmin``,
    ``bmax`` f32 [3]."""
    cells = float(1 << bits)
    ext = torch.clamp(bmax - bmin, min=1e-6)
    q = torch.clamp(((ro - bmin) / ext * cells).to(torch.int32), 0,
                    (1 << bits) - 1)
    morton = _morton((q[:, 0], q[:, 1], q[:, 2]), bits)
    octant = (
        (rd[:, 0] < 0).to(torch.int32)
        | ((rd[:, 1] < 0).to(torch.int32) << 1)
        | ((rd[:, 2] < 0).to(torch.int32) << 2)
    )
    key = torch.where(alive, (octant << (3 * bits)) | morton, dead_key(bits))
    if pxi is None:
        return key
    return (key.long() << 32) | pxi.long()


_LIB = None


def _library():
    """The built kernel library with its C signature declared."""
    global _LIB
    from ._build import LOCK, load_library

    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    with LOCK:
        if _LIB is None:
            lib = load_library("coherence_key")
            lib.coherence_key_launch.restype = ctypes.c_int
            lib.coherence_key_launch.argtypes = (
                [ptr] * 7 + [i64] * 6 + [i32] * 2 + [ptr])
            lib.coherence_key_error_string.restype = ctypes.c_char_p
            lib.coherence_key_error_string.argtypes = [ctypes.c_int]
            _LIB = lib
    return _LIB


def coherence_key_cuda(ro, rd, alive, bmin, bmax, bits: int, pxi=None):
    """``coherence_key_torch`` as one ``csrc/coherence_key.cu`` launch on
    the current stream, over CUDA tensors (rows and lanes at any stride;
    ``bmin`` and ``bmax`` contiguous). Raises ValueError on bad inputs and
    RuntimeError on a failed launch. ``coherence_key_cuda.launches``
    counts the launches (a call over 0 lanes launches nothing)."""
    r = ro.shape[0]
    dev = ro.device
    if dev.type != "cuda":
        raise ValueError(f"coherence_key_cuda needs CUDA tensors, got {dev}")
    if not 0 <= bits <= 9:
        raise ValueError(f"bits must lie in 0..9, got {bits}")
    args = dict(ro=(ro, torch.float32, (r, 3)), rd=(rd, torch.float32, (r, 3)),
                alive=(alive, torch.bool, (r,)),
                bmin=(bmin, torch.float32, (3,)),
                bmax=(bmax, torch.float32, (3,)))
    if pxi is not None:
        args["pxi"] = (pxi, torch.int32, (r,))
    for name, (t, dtype, shape) in args.items():
        if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"{name}: want {dtype} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not (bmin.is_contiguous() and bmax.is_contiguous()):
        raise ValueError("bmin and bmax must be contiguous")
    key = torch.empty(r, dtype=torch.int32 if pxi is None else torch.int64,
                      device=dev)
    if r == 0:
        return key
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.coherence_key_launch(
            ro.data_ptr(), rd.data_ptr(), alive.data_ptr(), bmin.data_ptr(),
            bmax.data_ptr(), None if pxi is None else pxi.data_ptr(),
            key.data_ptr(), *ro.stride(), *rd.stride(), alive.stride(0),
            0 if pxi is None else pxi.stride(0), r, bits, stream)
    if rc != 0:
        raise RuntimeError("coherence key launch failed: "
                           + lib.coherence_key_error_string(rc).decode())
    coherence_key_cuda.launches += 1
    return key


coherence_key_cuda.launches = 0
