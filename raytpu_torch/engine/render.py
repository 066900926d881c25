"""The renderer: ray generation, bounce loop, sample accumulation, tiling.

Torch counterpart of ``raytpu.engine.render`` in path mode's *query*
schedule. One wavefront of rays per framebuffer tile: every per-bounce
step is a vectorised op over the tile, with boolean masks standing in for
the reference megakernel's divergent branches (src/shader.wgsl:299-419),
and the data-dependent material/RNG control flow replayed exactly
(masked RNG advances, kernels/rng.py), so images match raytpu at matched
seed rather than merely statistically.

The main path, per tile: 32x32-block pixel layout, per-pixel RNG seeding,
jittered camera rays, then ``_trace_paths`` (path mode) or ``_flat_shade``
(flat mode). The route is raytpu's TPU branch: flat mode and every wave
of a scene of <= 256 triangle slots go through the packet route's BVH8
walk; every path-mode wave of a larger scene goes through the strand
walk, with the rays coherence-sorted before each query except the primary
one. Either kernel runs as CUDA on a CUDA device and as its plain version
on the CPU. ``_shade_core`` shades the hits.

Reference quirks reproduced on purpose (as in raytpu):

* hit point ``p = (object_to_world * vec4(pos, 0.0)).xyz + n*eps`` — w = 0
  drops the instance translation (src/shader.wgsl:345);
* the diffuse BRDF samples a cosine hemisphere around the *global* z axis,
  sign-flipped by the incoming direction, and its pdf uses the incoming
  direction's z (src/shader.wgsl:212-226);
* ``metal_brdf`` ignores roughness (src/shader.wgsl:228-239);
* ``glass_brdf`` is the reference's refraction formula with its
  scalar-minus-vector broadcast (src/shader.wgsl:241-257);
* next-event light contributions are added to radiance *unattenuated*; the
  final attenuation multiplies everything once at path exit
  (src/shader.wgsl:370-380);
* pixels outside the dispatched chunk grid stay black (``_in_chunk_grid``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import rng as rngk
from ..kernels.intersect import (
    F32_MAX,
    Hit,
    barycentrics,
    intersect_any_bruteforce,
    intersect_bruteforce,
)
from ..kernels.packet import make_packet_intersectors
from ..kernels.strand import make_strand_intersectors
from ..kernels.texture import sample_bilinear
from ..scene.pack import SORT_MIN_TRIS
from ..types import CameraPack, RenderConfig, ScenePack

# f32 values held as Python floats (exactly representable, so every torch
# op sees the same f32 constant raytpu uses)
PI = float(np.float32(3.1415926))  # src/shader.wgsl:3
INV_PI = float(np.float32(0.3183098))  # src/shader.wgsl:4
F32_EPSILON = float(np.float32(1.1920929e-7))  # src/shader.wgsl:2
MORTON_BITS = 6  # origin quantisation bits per axis in the sort key
NEG_INF = float("-inf")


def _dot3(a, b):
    """Explicitly-associated 3-component dot: (ax*bx + ay*by) + az*bz."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm3(v):
    return torch.sqrt(_dot3(v, v))


def _normalize(v):
    return v / _norm3(v)[..., None]


def cast_rays(px_f, py_f, world, projection, width: int, height: int):
    """Pinhole ray generation, exactly src/shader.wgsl:299-310.

    clip = pixel/(w,h)*2-1 (y then negated); unproject via the inverse
    perspective at z=0; the *vec4* is normalised before truncation to xyz;
    rotate into world with w=0; origin = world @ (0,0,0,1)."""
    clip_x = px_f / float(width) * 2.0 - 1.0
    clip_y = py_f / float(height) * 2.0 - 1.0
    ndc_y = -clip_y
    cam = [
        projection[i, 0] * clip_x + projection[i, 1] * ndc_y + projection[i, 3]
        for i in range(4)
    ]
    inv_len4 = 1.0 / torch.sqrt(
        cam[0] * cam[0] + cam[1] * cam[1] + cam[2] * cam[2] + cam[3] * cam[3]
    )
    cx, cy, cz = cam[0] * inv_len4, cam[1] * inv_len4, cam[2] * inv_len4
    d = torch.stack(
        [
            world[i, 0] * cx + world[i, 1] * cy + world[i, 2] * cz
            for i in range(3)
        ],
        dim=-1,
    )
    d = _normalize(d)
    o = world[:3, 3].expand(d.shape)
    return o, d


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


def _in_chunk_grid(px, py, w: int, h: int, cs: int):
    """Pixels the reference actually renders: x is truncated to whole
    chunks, y only to the frame, and the pixel's chunk index must be below
    the ``w*h/chunk_size`` dispatch count (src/state.rs:330-334,
    src/shader.wgsl:400-408)."""
    cols = max(w // cs, 1)
    chunk = (py // cs) * cols + (px // cs)
    return (px // cs < w // cs) & (py < h) & (chunk < (w * h) // cs)


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


def _ray_sort_key(pack: ScenePack, ro, rd, alive):
    """Coherence key: dead lanes last, then direction octant (major), then
    the Morton cell of the origin (scene bounds quantised, 6 bits/axis)."""
    bits = MORTON_BITS
    cells = float(1 << bits)
    ext = torch.clamp(pack.scene_bmax - pack.scene_bmin, min=1e-6)
    q = torch.clamp(
        ((ro - pack.scene_bmin) / ext * cells).to(torch.int32), 0,
        (1 << bits) - 1,
    )
    morton = _morton((q[:, 0], q[:, 1], q[:, 2]), bits)
    octant = (
        (rd[:, 0] < 0).to(torch.int32)
        | ((rd[:, 1] < 0).to(torch.int32) << 1)
        | ((rd[:, 2] < 0).to(torch.int32) << 2)
    )
    key = (octant << (3 * bits)) | morton
    return torch.where(alive, key, 1 << (3 * bits + 3))


def _sorted_query(fn, pack, ro, rd, tmin, tmax, alive, returns_hit):
    """Run an intersector on coherence-sorted rays and unsort the result
    (raytpu's payload mode: a stable sort of the key, then gathers in and
    the inverse scatter out). Per-ray results never depend on the order:
    ties break to the lowest slot."""
    r = ro.shape[0]
    perm = torch.sort(_ray_sort_key(pack, ro, rd, alive), stable=True)[1]
    tm = torch.as_tensor(tmax, dtype=torch.float32, device=ro.device)
    out = fn(ro[perm], rd[perm], tmin, tm.expand(r)[perm])
    if returns_hit:
        t = torch.empty_like(out.t)
        tri = torch.empty_like(out.tri)
        t[perm] = out.t
        tri[perm] = out.tri
        return Hit(t=t, tri=tri, valid=tri >= 0)
    blocked = torch.empty_like(out)
    blocked[perm] = out
    return blocked


def _shade_core(pack: ScenePack, ro, rd, hit, rng, active):
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


def _trace_paths(pack: ScenePack, closest, any_hit, ro, rd, rng,
                 bounces: int, mask=None, sort_bounced=False,
                 bounce_pair=None, count_mask=None):
    """One full path per lane: the reference's ``pixel_color``
    (src/shader.wgsl:321-381), vectorised with masks. ``mask`` restricts
    which lanes trace at all (lanes outside return 0 radiance). Query
    schedule: immediate NEE, and with ``sort_bounced`` every query but
    the primary one runs coherence-sorted. When ``bounce_pair`` (the
    strand pair) is given, every wave uses it: primary, shadow and bounce,
    as raytpu does by default. The bounce loop stops once no lane is alive
    (a bounce over dead lanes changes nothing).

    With ``count_mask`` also returns the number of ray queries issued by
    masked lanes, as a Python int: 1 primary + 2 per bounce iteration a
    lane survives (the reference's cost model, SURVEY.md §3.4)."""
    if bounce_pair is not None:
        closest, any_hit = bounce_pair
    n_rays = int(count_mask.sum()) if count_mask is not None else None
    r = ro.shape[0]
    dev = ro.device
    radiance = torch.zeros((r, 4), dtype=torch.float32, device=dev)
    attenuation = torch.tensor(
        [1.0, 1.0, 1.0, 0.0], device=dev
    ).expand(r, 4)
    alive = torch.ones(r, dtype=torch.bool, device=dev)
    if mask is not None:
        alive = alive & mask

    for b in range(bounces):
        if not bool(alive.any()):
            break
        # dead lanes get tmax = -inf: no query may produce hits for them
        tmax = torch.where(alive, F32_MAX, NEG_INF)
        if sort_bounced and b > 0:
            hit = _sorted_query(closest, pack, ro, rd, 0.001, tmax, alive,
                                True)
        else:
            hit = closest(ro, rd, 0.001, tmax)
        active = alive & hit.valid

        sh = _shade_core(pack, ro, rd, hit, rng, active)
        rng = sh["rng"]
        bounce_on = sh["bounce_on"]
        radiance = radiance + sh["emissive_delta"]
        attenuation = torch.where(
            bounce_on[:, None], attenuation * sh["att_mult"], attenuation
        )

        # --- next-event estimation visibility (:370-374) ---
        shadow_tmax = torch.where(bounce_on, sh["dist"], NEG_INF)
        if sort_bounced:
            blocked = _sorted_query(any_hit, pack, sh["p"], sh["ldir"], 0.0,
                                    shadow_tmax, bounce_on, False)
        else:
            blocked = any_hit(sh["p"], sh["ldir"], 0.0, shadow_tmax)
        radiance = radiance + torch.where(
            (bounce_on & ~blocked)[:, None], sh["contrib"], 0.0
        )

        # continue the path (:376-377)
        ro = torch.where(bounce_on[:, None], sh["p"], ro)
        rd = torch.where(bounce_on[:, None], sh["scattered"], rd)
        alive = bounce_on
        if n_rays is not None:
            n_rays += 2 * int((alive & count_mask).sum())
    if n_rays is not None:
        return radiance * attenuation, rng, n_rays
    return radiance * attenuation, rng


def _flat_shade(pack: ScenePack, closest, ro, rd):
    """raytpu extension: primary-hit base colour (BASELINE config 1)."""
    hit = closest(ro, rd, 0.001, F32_MAX)
    _, _, uv, mat, _ = _shade_inputs(pack, ro, rd, hit)
    if pack.has_textures:
        tex = sample_bilinear(pack.tex_atlas, pack.tex_size, mat["tex_id"],
                              uv)
        color = torch.where(mat["has_tex"][:, None], tex, mat["color"])
    else:
        color = mat["color"]
    return torch.where(hit.valid[:, None], color, 0.0)


# routes raytpu has that this package does not yet run, with the ROADMAP
# item that ports each
_NOT_PORTED = {
    "bvh": "ROADMAP 1.10 (threaded-BVH walk)",
    "binned": "ROADMAP 1.15 (binned kernel)",
}


def _choose_intersectors(pack: ScenePack, config: RenderConfig):
    """Resolve config.intersector to ((closest, any), packet_mode,
    bounce_pair), as raytpu's TPU branch does.

    "auto" and "packet" give the packet route's pair; ``bounce_pair`` is
    the strand pair when the pack has a strand tree (> 256 slots), else
    None, and ``_trace_paths`` then sends every path-mode wave through it.
    raytpu's VMEM budget check has no counterpart: on the card every table
    lives in global memory. "strand" uses the strand pair everywhere and
    raises on a pack without a tree. Each kernel is the CUDA one for a
    pack on a CUDA device, its plain version on the CPU; both walk rays in
    32x32-block order. "brute" is the torch sweep in row order."""
    which = config.intersector
    if config.bounce_backend != "sorted":
        raise NotImplementedError(
            f"bounce_backend={config.bounce_backend!r} is not ported; "
            "only 'sorted' runs"
        )
    if which in _NOT_PORTED:
        raise NotImplementedError(
            f"intersector={which!r} is not ported yet: {_NOT_PORTED[which]}"
        )
    if which in ("auto", "packet"):
        bounce_pair = None
        if pack.bvh.strand_rows is not None:
            bounce_pair = make_strand_intersectors(pack)
        return make_packet_intersectors(pack), True, bounce_pair
    if which == "strand":
        pair = make_strand_intersectors(pack)
        return pair, True, pair
    if which == "brute":
        def closest(ro, rd, tmin, tmax):
            return intersect_bruteforce(
                ro, rd, pack.tri_p0, pack.tri_e1, pack.tri_e2, tmin, tmax
            )

        def any_hit(ro, rd, tmin, tmax):
            return intersect_any_bruteforce(
                ro, rd, pack.tri_p0, pack.tri_e1, pack.tri_e2, tmin, tmax
            )

        return (closest, any_hit), False, None
    raise ValueError(f"unknown intersector {which!r}")


def _pixel_layout(w: int, tile_h: int, packet_mode: bool, device):
    """Pixel index layout for one tile: (px, py_local, unpermute).

    Packet mode orders rays in 32x32-pixel blocks (padded) so neighbouring
    rays take neighbouring paths; ``unpermute`` maps the flat [R,4] buffer
    back to [tile_h, w, 4]."""
    if not packet_mode:
        px = torch.arange(w, dtype=torch.int32, device=device).repeat(tile_h)
        py = torch.arange(
            tile_h, dtype=torch.int32, device=device
        ).repeat_interleave(w)
        return px, py, lambda img: img.reshape(tile_h, w, 4)

    B = 32
    wp = -(-w // B) * B
    hp = -(-tile_h // B) * B
    pxg, pyg = np.meshgrid(np.arange(wp), np.arange(hp))

    def order(a):
        return a.reshape(hp // B, B, wp // B, B).transpose(0, 2, 1, 3).reshape(-1)

    px = torch.as_tensor(order(pxg), dtype=torch.int32, device=device)
    py = torch.as_tensor(order(pyg), dtype=torch.int32, device=device)

    def unpermute(img):
        img = img.reshape(hp // B, wp // B, B, B, 4)
        img = img.permute(0, 2, 1, 3, 4).reshape(hp, wp, 4)
        return img[:tile_h, :w]

    return px, py, unpermute


def render_tile(pack: ScenePack, camera: CameraPack, y0: int,
                config: RenderConfig, tile_h: int, seed=None) -> torch.Tensor:
    """Render rows [y0, y0 + tile_h) of the frame; returns [tile_h, W, 4]
    on the pack's device. ``seed`` overrides config.seed."""
    w, h = config.width, config.height
    dev = pack.device
    (closest, any_hit), packet_mode, bounce_pair = _choose_intersectors(
        pack, config)
    px, py_local, unpermute = _pixel_layout(w, tile_h, packet_mode, dev)
    py = y0 + py_local
    rng = rngk.seed_pixels(px, py, w, config.chunk_size,
                           config.seed if seed is None else seed)

    # pixels outside the dispatched chunk grid stay black (_in_chunk_grid)
    in_grid = _in_chunk_grid(px, py, w, h, config.chunk_size)

    pxf = px.to(torch.float32)
    pyf = py.to(torch.float32)
    sort_bounced = packet_mode and pack.n_triangles > SORT_MIN_TRIS
    acc = torch.zeros((px.shape[0], 4), dtype=torch.float32, device=dev)
    for _ in range(config.samples):
        # per-pixel jitter: + vec2(rand(), rand()) (src/shader.wgsl:413)
        rng, jx = rngk.rand(rng)
        rng, jy = rngk.rand(rng)
        ro, rd = cast_rays(pxf + jx, pyf + jy, camera.world,
                           camera.projection, w, h)
        if config.mode == "flat":
            color = _flat_shade(pack, closest, ro, rd)
        else:
            color, rng = _trace_paths(
                pack, closest, any_hit, ro, rd, rng, config.bounces,
                mask=in_grid, sort_bounced=sort_bounced,
                bounce_pair=bounce_pair,
            )
        acc = acc + color
    img = acc / float(config.samples)
    img = torch.where(in_grid[:, None], img, 0.0)
    return unpermute(img)


def count_rays(pack: ScenePack, camera: CameraPack,
               config: RenderConfig) -> int:
    """Count the ray queries the reference would issue for this frame: one
    primary query per in-grid lane and sample plus, per bounce iteration a
    lane survives, one shadow and one continuation query (the cost model
    of src/shader.wgsl:321-381, SURVEY.md §3.4). Exact: it runs the real
    trace loop with a counter, in path mode whatever ``config.mode`` says,
    as raytpu's ``count_rays`` does. The total is a Python int."""
    tile_h = _auto_tile_rows(config, pack.n_triangles)
    total = 0
    for y0 in range(0, config.height, tile_h):
        rows = min(tile_h, config.height - y0)
        total += _count_tile(pack, camera, y0, config, tile_h, rows)
    return total


def _count_tile(pack: ScenePack, camera: CameraPack, y0: int,
                config: RenderConfig, tile_h: int, valid_rows: int) -> int:
    w, h = config.width, config.height
    dev = pack.device
    (closest, any_hit), packet_mode, bounce_pair = _choose_intersectors(
        pack, config)
    px, py_local, _ = _pixel_layout(w, tile_h, packet_mode, dev)
    py = y0 + py_local
    rng = rngk.seed_pixels(px, py, w, config.chunk_size, config.seed)
    # (py < y0 + valid_rows) also drops padding lanes that alias the next
    # tile's pixels: they must not be counted twice
    in_grid = _in_chunk_grid(px, py, w, h, config.chunk_size) & (
        py < y0 + valid_rows)
    pxf = px.to(torch.float32)
    pyf = py.to(torch.float32)
    sort_bounced = packet_mode and pack.n_triangles > SORT_MIN_TRIS
    total = 0
    for _ in range(config.samples):
        rng, jx = rngk.rand(rng)
        rng, jy = rngk.rand(rng)
        ro, rd = cast_rays(pxf + jx, pyf + jy, camera.world,
                           camera.projection, w, h)
        _, rng, n = _trace_paths(
            pack, closest, any_hit, ro, rd, rng, config.bounces,
            mask=in_grid, sort_bounced=sort_bounced,
            bounce_pair=bounce_pair, count_mask=in_grid,
        )
        total += n
    return total


def _auto_tile_rows(config: RenderConfig, n_tris: int) -> int:
    if config.tile_rows is not None:
        return config.tile_rows
    if n_tris <= config.bruteforce_max_tris:
        # brute force materialises [rays, tri_chunk] intermediates
        budget = 1 << 24
        rows = budget // (config.width * min(n_tris, 512))
    else:
        # per-ray state only; bigger tiles amortise sorts and per-wave
        # overheads (2^21 rays: a whole 1080p frame in one tile)
        rows = (1 << 21) // config.width
    return int(np.clip(rows, 1, config.height))


def render_frame_tiles(pack: ScenePack, camera: CameraPack,
                       config: RenderConfig):
    """Generator over (y0, rows, tile [rows, W, 4] numpy f32)."""
    tile_h = _auto_tile_rows(config, pack.n_triangles)
    for y0 in range(0, config.height, tile_h):
        tile = render_tile(pack, camera, y0, config, tile_h)
        rows = min(tile_h, config.height - y0)
        yield y0, rows, tile[:rows].cpu().numpy()


def render_frame(pack: ScenePack, camera: CameraPack,
                 config: RenderConfig) -> np.ndarray:
    """Full frame, stitched from tiles on the host; returns [H, W, 4] f32
    (the SAMPLES texture contents, src/state.rs:691-696)."""
    out = np.zeros((config.height, config.width, 4), np.float32)
    for y0, rows, tile in render_frame_tiles(pack, camera, config):
        out[y0 : y0 + rows] = tile
    return out
