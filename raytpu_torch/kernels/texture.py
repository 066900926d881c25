"""Bilinear texture sampling from the flat texel buffer.

Torch counterpart of ``raytpu.kernels.texture``: WGSL
``textureSampleLevel(TEXTURES[i], SAMPLER, uv, 0.0)`` (src/shader.wgsl:350)
with the reference's sampler state — linear min/mag filtering and the
wgpu default ClampToEdge address mode (src/state.rs:699-704). Texels were
normalised to [0,1] at pack time; filtering happens in f32.

Storage is one flat [total_texels, 4] buffer with per-texture
(width, height, offset) descriptors, each texture at its native size."""

from __future__ import annotations

import torch


def sample_bilinear(
    atlas: torch.Tensor,  # [N_texels, 4] f32 (all textures, row-major each)
    desc: torch.Tensor,  # [T, 3] i32 (width, height, flat offset)
    tex_id: torch.Tensor,  # [R] i32
    uv: torch.Tensor,  # [R, 2] f32
) -> torch.Tensor:
    """Returns [R,4] f32 samples."""
    d = desc[tex_id.long()]  # [R,3]
    wi = d[:, 0]
    hi = d[:, 1]
    off = d[:, 2]
    w = wi.to(torch.float32)
    h = hi.to(torch.float32)
    # texel-space coordinates; GPU convention puts texel centres at +0.5
    x = uv[:, 0] * w - 0.5
    y = uv[:, 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0

    def clamp(v, hi_excl):
        return torch.minimum(
            torch.clamp(v.to(torch.int32), min=0), hi_excl - 1
        )

    ix0 = clamp(x0, wi)
    ix1 = clamp(x0 + 1, wi)
    iy0 = clamp(y0, hi)
    iy1 = clamp(y0 + 1, hi)

    t00 = atlas[(off + iy0 * wi + ix0).long()]
    t10 = atlas[(off + iy0 * wi + ix1).long()]
    t01 = atlas[(off + iy1 * wi + ix0).long()]
    t11 = atlas[(off + iy1 * wi + ix1).long()]
    fx = fx[:, None]
    fy = fy[:, None]
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy
