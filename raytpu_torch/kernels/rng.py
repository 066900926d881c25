"""Reference-exact random number generator, vectorised in torch.

The reference shader carries one u32 of RNG state per thread
(src/shader.wgsl:45) seeded per pixel per chunk (src/shader.wgsl:398) and
draws floats with a Murmur3-style multiply-rotate hash
(src/shader.wgsl:137-149):

    hash(k): k *= 0xcc9e2d51; k = rotl(k, 15); k *= 0x1b873593
    rand():  RNG = hash(RNG); return bitcast<f32>(0x3f800000 | (RNG >> 9)) - 1

torch has no uint32 shifts or compares on every backend, so the state is
carried as **int32 bits**: multiplies and left shifts wrap to the same low
32 bits as u32 arithmetic, and every right shift is masked because int32
``>>`` is arithmetic. A lane that would not have executed rand() in the
reference keeps its previous state (``rand_masked``), which replays the
exact per-lane call sequence of raytpu.kernels.rng bit for bit.
"""

from __future__ import annotations

import torch


def _i32(u: int) -> int:
    """A u32 constant as the int32 with the same bits."""
    u &= 0xFFFFFFFF
    return u - (1 << 32) if u >= (1 << 31) else u


_C1 = _i32(0xCC9E2D51)
_C2 = _i32(0x1B873593)
_ONE_BITS = 0x3F800000


def hash_u32(k: torch.Tensor) -> torch.Tensor:
    """One Murmur3 mixing round (src/shader.wgsl:137-143) on int32 bits."""
    k = k * _C1
    k = (k << 15) | ((k >> 17) & 0x7FFF)
    return k * _C2


def u32_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """bitcast(0x3f800000 | (bits >> 9)) - 1.0 in [0, 1)
    (src/shader.wgsl:146-149)."""
    mantissa = _ONE_BITS | ((bits >> 9) & 0x7FFFFF)
    return mantissa.view(torch.float32) - 1.0


def rand(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance every lane's state and return (new_state, value)."""
    new = hash_u32(state)
    return new, u32_to_unit_float(new)


def rand_masked(
    state: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """rand() only where ``mask``: lanes outside keep their state (their
    returned value is unspecified and must be consumed under the mask)."""
    new = hash_u32(state)
    return torch.where(mask, new, state), u32_to_unit_float(new)


def seed_pixels(
    px: torch.Tensor,
    py: torch.Tensor,
    width: int,
    chunk_size: int,
    seed: int,
) -> torch.Tensor:
    """Per-pixel initial RNG state (int32 bits).

    The reference seeds each thread as
    ``(gid.x+1) * (gid.y+1) * (current_chunk+1) * seed`` (src/shader.wgsl:398)
    where gid is the *chunk-local* pixel coordinate and ``current_chunk``
    indexes row-major ``chunk_size``-square tiles over the frame
    (src/shader.wgsl:400-404). All multiplies wrap mod 2^32. ``px``/``py``
    are non-negative int32 pixel coordinates."""
    px = px.to(torch.int32)
    py = py.to(torch.int32)
    cs = chunk_size
    chunks_per_row = max(width // chunk_size, 1)
    chunk = (py // cs) * chunks_per_row + (px // cs)
    lx = px % cs
    ly = py % cs
    s = (lx + 1) * (ly + 1)
    s = s * (chunk + 1)
    return s * _i32(seed)
