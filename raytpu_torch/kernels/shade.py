"""The engine's per-bounce shading body: the CUDA kernel and its plain
torch version.

``_shade_core`` (engine/render.py) shades each lane's closest hit, the
reference megakernel's src/shader.wgsl:339-374 up to the shadow query:
face-forward + hit point + base colour + material dispatch + masked RNG
draws + NEE light pick. raytpu writes it as jnp code
(``raytpu/engine/render.py:473``) that XLA fuses on the TPU; no Pallas
kernel stands behind it. In torch ops it is ~220 elementwise launches a
call, each over every lane of the wave, so on the card it runs as one
hand-written kernel, ``csrc/shade.cu``.

``shade_core_torch`` is the plain version: torch ops in raytpu's order,
which the CPU runs. ``shade_core_cuda`` launches the kernel (one thread a
lane) and returns the same dict; the kernel is bit-equal to the plain
version run on the same CUDA tensors (csrc/shade.cu says where ATen's
CUDA kernels fix a rounding). On lanes where ``bounce_on`` is false the
kernel writes zeros to ``p``, ``scattered``, ``att_mult``, ``ldir``,
``dist`` and ``contrib``, which every caller reads only under
``bounce_on``; ``rng``, ``bounce_on`` and ``emissive_delta`` are defined
on every lane, as the plain version's are.

The helpers ``_shade_inputs`` (one ``tri_row`` gather decoded; flat
mode's base colour uses it too), ``_apply_linear``, ``_dot3`` and
``_normalize`` and the shader's f32 constants live here with the plain
version."""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from ..types import ScenePack
from . import rng as rngk
from .intersect import barycentrics
from .texture import sample_bilinear

# f32 values held as Python floats (exactly representable, so every torch
# op sees the same f32 constant raytpu uses)
PI = float(np.float32(3.1415926))  # src/shader.wgsl:3
INV_PI = float(np.float32(0.3183098))  # src/shader.wgsl:4
F32_EPSILON = float(np.float32(1.1920929e-7))  # src/shader.wgsl:2


def _dot3(a, b):
    """Explicitly-associated 3-component dot: (ax*bx + ay*by) + az*bz."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm3(v):
    return torch.sqrt(_dot3(v, v))


def _normalize(v):
    return v / _norm3(v)[..., None]


def _bits_i32(x):
    return x.contiguous().view(torch.int32)


def _shade_inputs(pack: ScenePack, ro, rd, hit):
    """Decode the winning triangle from ONE tri_row gather: barycentric
    recompute, interpolated object-space pos / normal / uv, the material
    parameters, and the object's linear transform."""
    tri = torch.clamp(hit.tri, min=0).long()
    row = pack.tri_row[tri]  # [R,64]
    u, v = barycentrics(ro, rd, row)
    w0 = (1.0 - u - v)[:, None]
    wu = u[:, None]
    wv = v[:, None]
    pos = row[:, 9:12] * w0 + row[:, 12:15] * wu + row[:, 15:18] * wv
    normal = row[:, 18:21] * w0 + row[:, 21:24] * wu + row[:, 24:27] * wv
    uv = row[:, 27:29] * w0 + row[:, 29:31] * wu + row[:, 31:33] * wv
    if pack.n_materials == 1:
        mrow = pack.mat_table[0]
        r = row.shape[0]
        mat = dict(
            metallic=mrow[0].expand(r),
            emission=mrow[2].expand(r),
            ior=mrow[3].expand(r),
            tex_id=_bits_i32(mrow[4:5]).expand(r),
            has_tex=(_bits_i32(mrow[5:6]) == 1).expand(r),
            color=mrow[8:12].expand(r, 4),
        )
    else:
        mat = dict(
            metallic=row[:, 42],
            emission=row[:, 43],
            ior=row[:, 44],
            tex_id=_bits_i32(row[:, 45]),
            has_tex=_bits_i32(row[:, 46]) == 1,
            color=row[:, 47:51],
        )
    return pos, normal, uv, mat, row


def _apply_linear(pack, row, pos):
    """p = (object_to_world * vec4(pos, 0)).xyz — only the 3x3 part
    (src/shader.wgsl:345), per triangle in tri_row cols 33:42 (or the one
    object's row). Explicit mat-vec keeps f32 association fixed."""
    if pack.n_objects == 1:
        lin = [pack.object_linear[0, i] for i in range(9)]
    else:
        lin = [row[:, 33 + i] for i in range(9)]
    return torch.stack(
        [
            lin[3 * i + 0] * pos[:, 0]
            + lin[3 * i + 1] * pos[:, 1]
            + lin[3 * i + 2] * pos[:, 2]
            for i in range(3)
        ],
        dim=-1,
    )


def shade_core_torch(pack: ScenePack, ro, rd, hit, rng, active):
    """The megakernel's per-bounce shading body (src/shader.wgsl:339-374
    up to the shadow query): face-forward + hit point + base colour +
    material dispatch + masked RNG draws + NEE light pick. Pure per-lane
    math (lanes outside ``active`` draw no RNG and contribute nothing).
    Returns a dict: emissive_delta [R,4], att_mult [R,4], scattered/p
    [R,3], bounce_on, ldir/dist/contrib (the shadow ray), and the rng."""
    r = ro.shape[0]
    pos, normal, uv, mat, row = _shade_inputs(pack, ro, rd, hit)
    metallic, emission, ior = mat["metallic"], mat["emission"], mat["ior"]
    tex_id, has_tex, m_color = mat["tex_id"], mat["has_tex"], mat["color"]

    # face-forward normal (src/shader.wgsl:339-343)
    front = _dot3(rd, normal) < 0.0
    normal = torch.where(front[:, None], normal, -normal)

    # hit point with the w=0 translation-dropping quirk (:345)
    p = _apply_linear(pack, row, pos) + normal * F32_EPSILON

    # base colour: bilinear texture or factor (:349-353)
    if pack.has_textures:
        tex_rgba = sample_bilinear(pack.tex_atlas, pack.tex_size, tex_id, uv)
        in_color = torch.where(has_tex[:, None], tex_rgba, m_color)
    else:
        in_color = m_color

    # --- material dispatch (:355-368) ---
    is_emissive = active & (emission > 0.0)
    is_metal = active & ~is_emissive & (metallic > 0.0)
    is_mixed = active & ~is_emissive & ~(metallic > 0.0)

    emissive_delta = torch.where(
        is_emissive[:, None], m_color * emission[:, None], 0.0
    )

    # metal: perfect mirror, roughness unused (:228-239)
    d_dot_n = _dot3(rd, normal)[:, None]
    scat_metal = rd - 2.0 * d_dot_n * normal
    att_metal = in_color  # out_color / pdf with pdf = 1

    # 50/50 diffuse-glass mix (:362-367); one rand for the choice
    rng, r_mix = rngk.rand_masked(rng, is_mixed)
    is_diffuse = is_mixed & (r_mix > 0.5)

    # diffuse: cosine hemisphere in the quirky global-z frame (:212-226)
    rng, u1 = rngk.rand_masked(rng, is_diffuse)
    rng, u2 = rngk.rand_masked(rng, is_diffuse)
    r_disk = torch.sqrt(u1)
    theta = 2.0 * PI * u2
    dx = r_disk * torch.cos(theta)
    dy = r_disk * torch.sin(theta)
    dz = torch.sqrt(1.0 - dx * dx - dy * dy)
    dz = torch.where(rd[:, 2] < 0.0, -dz, dz)
    scat_diffuse = torch.stack([dx, dy, dz], dim=-1)
    pdf_diffuse = torch.abs(rd[:, 2]) * INV_PI
    att_diffuse = (in_color / PI) / pdf_diffuse[:, None]

    # glass: the reference's refraction formula verbatim (:241-257),
    # including `-(1.0 - |out_perp| * normal)` broadcasting 1.0 - vec3
    uv_dir = _normalize(rd)
    cos_theta = torch.clamp(-_dot3(uv_dir, normal), max=1.0)
    out_perp = ior[:, None] * (uv_dir + cos_theta[:, None] * normal)
    perp_len = torch.sqrt(torch.abs(_dot3(out_perp, out_perp)))
    out_parallel = -(1.0 - perp_len[:, None] * normal)
    scat_glass = out_perp + out_parallel
    att_glass = in_color

    att_mult = torch.where(
        is_metal[:, None],
        att_metal,
        torch.where(is_diffuse[:, None], att_diffuse * 0.5, att_glass * 0.5),
    )
    scattered = torch.where(
        is_metal[:, None],
        scat_metal,
        torch.where(is_diffuse[:, None], scat_diffuse, scat_glass),
    )
    bounce_on = is_metal | is_mixed

    # --- next-event estimation setup (:370-374) ---
    rng, r_light = rngk.rand_masked(rng, bounce_on)
    if pack.n_lights == 1:
        lrow = pack.light_table[0].expand(r, 8)
    else:
        li = torch.clamp(
            (r_light * pack.n_lights_f).to(torch.int32), 0, pack.n_lights - 1
        )
        lrow = pack.light_table[li.long()]
    lpos = lrow[:, 0:3]
    lcolor = lrow[:, 4:8]
    to_light = lpos - p
    dist = _norm3(to_light)
    ldir = to_light / dist[:, None]
    # radiance += (color / sqrt(dist)) / (1/N) — unattenuated (:372-374)
    contrib = (lcolor / torch.sqrt(dist)[:, None]) / (1.0 / pack.n_lights_f)
    return dict(
        rng=rng, p=p, scattered=scattered, att_mult=att_mult,
        bounce_on=bounce_on, emissive_delta=emissive_delta,
        ldir=ldir, dist=dist, contrib=contrib,
    )


def _check(name, x, dtype, shape, dev, contiguous=False, align=0):
    """Raise ValueError unless ``x`` is a ``dtype`` tensor on ``dev`` of
    ``shape`` (None matches any size), contiguous and ``align``-byte
    aligned where asked."""
    if (not isinstance(x, torch.Tensor) or x.dtype != dtype
            or x.device != dev or x.dim() != len(shape)
            or any(w is not None and w != s for w, s in zip(shape, x.shape))
            or (contiguous and not x.is_contiguous())
            or (align and x.data_ptr() % align)):
        want = "x".join("N" if w is None else str(w) for w in shape)
        got = (f"{x.dtype} {tuple(x.shape)} on {x.device}"
               if isinstance(x, torch.Tensor) else type(x).__name__)
        raise ValueError(
            f"{name}: want a {'contiguous ' if contiguous else ''}{dtype} "
            f"[{want}] tensor on {dev}"
            f"{f' aligned to {align} bytes' if align else ''}, got {got}")


def _check_pack(pack, dev) -> None:
    """The pack's tables on ``dev``: tri_row [T, 64] and tex_atlas [N, 4]
    contiguous and 16-byte aligned (the kernel's float4 loads), the small
    tables contiguous, none of the four row tables empty. A frozen pack's
    tables stay as ``pack_scene`` made them, so each (pack, device) is
    checked once, not on every call."""
    if _CHECKED_PACKS.get((id(pack), dev)) is pack:
        return
    _check("tri_row", pack.tri_row, torch.float32, (None, 64), dev, True, 16)
    _check("object_linear", pack.object_linear, torch.float32, (None, 16),
           dev, True)
    _check("mat_table", pack.mat_table, torch.float32, (None, 16), dev, True)
    _check("light_table", pack.light_table, torch.float32, (None, 8), dev,
           True)
    _check("n_lights_f", pack.n_lights_f, torch.float32, (), dev)
    _check("tex_atlas", pack.tex_atlas, torch.float32, (None, 4), dev, True,
           16)
    _check("tex_size", pack.tex_size, torch.int32, (None, 3), dev, True)
    for name, table in (("tri_row", pack.tri_row),
                        ("object_linear", pack.object_linear),
                        ("mat_table", pack.mat_table),
                        ("light_table", pack.light_table)):
        if table.shape[0] == 0:
            raise ValueError(f"{name}: want at least one row")
    if pack.has_textures and pack.tex_size.shape[0] == 0:
        raise ValueError("tex_size: a pack with textures has no texture")
    _CHECKED_PACKS[(id(pack), dev)] = pack


# the packs that passed _check_pack, by (id, device); an entry goes with
# its pack, so a new pack at a freed id is checked again
_CHECKED_PACKS = weakref.WeakValueDictionary()


def _check_inputs(pack, ro, rd, hit, rng, active) -> None:
    """The kernel's inputs: rays [R, 3] float32 (any strides), tri and rng
    int32 [R] and active bool [R] on one CUDA device, checked every call,
    and the pack's tables there (``_check_pack``)."""
    dev = ro.device
    r = ro.shape[0] if ro.dim() == 2 else None
    _check("ro", ro, torch.float32, (None, 3), dev)
    _check("rd", rd, torch.float32, (r, 3), dev)
    _check("hit.tri", hit.tri, torch.int32, (r,), dev)
    _check("rng", rng, torch.int32, (r,), dev)
    _check("active", active, torch.bool, (r,), dev)
    _check_pack(pack, dev)


_LIB = None


def _library():
    """The built kernel library with its C signature declared."""
    global _LIB
    from ._build import LOCK, load_library

    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    with LOCK:
        if _LIB is None:
            lib = load_library("shade")
            lib.shade_core_launch.restype = ctypes.c_int
            lib.shade_core_launch.argtypes = (
                [ptr] * 21 + [i64] * 7 + [i32] * 5 + [ptr])
            lib.shade_core_error_string.restype = ctypes.c_char_p
            lib.shade_core_error_string.argtypes = [ctypes.c_int]
            _LIB = lib
    return _LIB


def shade_core_cuda(pack: ScenePack, ro, rd, hit, rng, active):
    """Launch ``csrc/shade.cu`` on the current stream (one thread a lane,
    blocks of 128) over CUDA tensors: ``shade_core_torch``'s arguments and
    dict, with zeros in ``p``, ``scattered``, ``att_mult``, ``ldir``,
    ``dist`` and ``contrib`` where ``bounce_on`` is false. Raises
    ValueError on bad inputs and RuntimeError on a failed launch.
    ``shade_core_cuda.launches`` counts the launches (a call over 0 lanes
    launches nothing)."""
    if ro.device.type != "cuda":
        raise ValueError(f"shade_core_cuda needs CUDA tensors, got "
                         f"{ro.device}")
    _check_inputs(pack, ro, rd, hit, rng, active)
    r = ro.shape[0]
    dev = ro.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = dict(rng=empty(r, dtype=torch.int32), p=empty(r, 3),
               scattered=empty(r, 3), att_mult=empty(r, 4),
               bounce_on=empty(r, dtype=torch.bool),
               emissive_delta=empty(r, 4), ldir=empty(r, 3), dist=empty(r),
               contrib=empty(r, 4))
    if r == 0:
        return out
    lib = _library()
    tables = (pack.tri_row, pack.object_linear, pack.mat_table,
              pack.light_table, pack.n_lights_f, pack.tex_atlas,
              pack.tex_size)
    outs = ("rng", "p", "scattered", "att_mult", "bounce_on",
            "emissive_delta", "ldir", "dist", "contrib")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.shade_core_launch(
            ro.data_ptr(), rd.data_ptr(), hit.tri.data_ptr(),
            rng.data_ptr(), active.data_ptr(),
            *(t.data_ptr() for t in tables),
            *(out[k].data_ptr() for k in outs),
            *ro.stride(), *rd.stride(), hit.tri.stride(0), rng.stride(0),
            active.stride(0), r, pack.n_lights, int(pack.n_materials > 1),
            int(pack.n_objects > 1), int(bool(pack.has_textures)), stream)
    if rc != 0:
        raise RuntimeError("shade launch failed: "
                           + lib.shade_core_error_string(rc).decode())
    shade_core_cuda.launches += 1
    return out


shade_core_cuda.launches = 0
