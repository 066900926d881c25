"""The renderer: ray generation, bounce loop, sample accumulation, tiling.

Torch counterpart of ``raytpu.engine.render``: path mode's *query*
schedule and, on waves of 2^20 lanes or more, its *fused* wave mode
(``_wave_mode``, ``_fused_bounces``). One wavefront of rays per
framebuffer tile: every per-bounce
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
one. A stream pack (no BVH8) takes the strand route, or the binned
treelet route when it has no strand tree. The binned route, and
``bounce_backend="binned"``, defer each bounce's shadow rays into the next
bounce's mixed binned query (``_mixed_bounce_query``);
``bounce_backend="mixed"`` does the same through the strand walk's mixed
form. raytpu's wave modes (``query``, ``fused``, ``resort``, ``compact``)
and sort knobs (RAYTPU_SORT_MODE, RAYTPU_SORT_SEG, RAYTPU_COMPACT,
RAYTPU_MORTON_BITS, RAYTPU_B0_STRAND, RAYTPU_B0S_NOSORT,
RAYTPU_SORT_MIN_TRIS) are read where raytpu reads them; each leaves the
frame bit-identical. Every kernel runs
as CUDA on a CUDA device and as its plain version on the CPU. The
``brute`` sweep and the threaded-BVH walk (``bvh``) are plain torch ops on
either device and run only when asked for. ``_shade_core`` shades the
hits.

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

import os

import numpy as np
import torch

from ..kernels import rng as rngk
from ..kernels.intersect import F32_MAX, Hit, barycentrics, make_intersectors
from ..kernels.binned import make_binned_intersectors, make_binned_query
from ..kernels import packet as packetk
from ..kernels.packet import make_packet_intersectors
from ..kernels.strand import make_strand_intersectors, make_strand_mixed_query
from ..kernels.texture import sample_bilinear
from ..obs import span, spanned
from ..scene.pack import _sort_min_tris
from ..types import CameraPack, RenderConfig, ScenePack

# f32 values held as Python floats (exactly representable, so every torch
# op sees the same f32 constant raytpu uses)
PI = float(np.float32(3.1415926))  # src/shader.wgsl:3
INV_PI = float(np.float32(0.3183098))  # src/shader.wgsl:4
F32_EPSILON = float(np.float32(1.1920929e-7))  # src/shader.wgsl:2
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


def _morton_bits() -> int:
    """Origin-quantisation bits per axis of the coherence key:
    RAYTPU_MORTON_BITS, default 6, at most 9 (so ``octant << 3*bits``
    stays in int32), raytpu's knob."""
    return min(int(os.environ.get("RAYTPU_MORTON_BITS", "6")), 9)


def _dead_key() -> int:
    """The key of a dead lane: above every live key, so dead lanes sort
    last."""
    return 1 << (3 * _morton_bits() + 3)


def _ray_sort_key(pack: ScenePack, ro, rd, alive):
    """Coherence key: dead lanes last, then direction octant (major), then
    the Morton cell of the origin (scene bounds quantised,
    ``_morton_bits()`` per axis)."""
    bits = _morton_bits()
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
    return torch.where(alive, key, _dead_key())


def _compact_prefix(r: int, alive) -> int:
    """RAYTPU_COMPACT's live-prefix width for a sorted query of ``r`` rays
    (raytpu's payload mode): the smallest of the tiers r/4 and r/2, rounded
    up to 128, that holds every live lane, else r. Off (r) unless
    RAYTPU_COMPACT is set to anything but "0", and below 512 rays."""
    if os.environ.get("RAYTPU_COMPACT", "0") == "0" or r < 512:
        return r
    tiers = [p for p in (-(-(r // 4) // 128) * 128, -(-(r // 2) // 128) * 128)
             if 0 < p < r]
    with span("raytpu::engine.sync.compact"):
        n = int(alive.sum())
    return next((p for p in tiers if n <= p), r)


def _unsort(out, idx, n: int, returns_hit):
    """The results ``out`` of the rays at positions ``idx`` scattered back
    among ``n`` lanes; a lane not in ``idx`` gets a dead lane's result
    (t = -inf, tri = -1; not blocked)."""
    dev = idx.device
    if returns_hit:
        t = torch.full((n,), NEG_INF, device=dev)
        tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
        t[idx] = out.t
        tri[idx] = out.tri
        return Hit(t=t, tri=tri, valid=tri >= 0)
    blocked = torch.zeros(n, dtype=torch.bool, device=dev)
    blocked[idx] = out
    return blocked


@spanned("raytpu::engine.sort")
def _sorted_query(fn, pack, ro, rd, tmin, tmax, alive, returns_hit):
    """Run an intersector on coherence-sorted rays and unsort the result.
    Per-ray results never depend on the order (ties break on the tie keys)
    and every mode restores the exact original positions, so the modes
    are bit-identical. RAYTPU_SORT_MODE picks the permutation plumbing, as
    in raytpu:

    * ``payload`` (the default; ``payload_split``, raytpu's two-sort split
      of the same permutation, is the same here): a stable sort of the key,
      the rays gathered in, a closest query's bound taken from the sorted
      key (dead lanes carry -inf, live ones F32_MAX), one scatter out. With
      RAYTPU_COMPACT the query runs on the live prefix only
      (``_compact_prefix``); the dead tail gets a dead lane's result;
    * ``gather``: the key alone argsorted, every column (the bound too)
      moved with gathers, and the inverse permutation built with one
      scatter and gathered from;
    * ``seg``: segments of RAYTPU_SORT_SEG rays (131,072) sorted
      independently, the last padded with dead lanes (the dead key, ro 0,
      rd 1, bound -inf), the padded wave queried and cut back."""
    r = ro.shape[0]
    dev = ro.device
    key = _ray_sort_key(pack, ro, rd, alive)
    tm = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(r)
    mode = os.environ.get("RAYTPU_SORT_MODE", "payload")
    if mode == "seg":
        seg = int(os.environ.get("RAYTPU_SORT_SEG", "131072"))
        n_seg = max(1, -(-r // seg))
        pad = n_seg * seg - r
        key = torch.cat([key, key.new_full((pad,), _dead_key())])
        perm = torch.sort(key.reshape(n_seg, seg), dim=1, stable=True)[1]
        perm = (perm + torch.arange(n_seg, device=dev)[:, None] * seg
                ).reshape(-1)
        ro = torch.cat([ro, ro.new_zeros((pad, 3))])
        rd = torch.cat([rd, rd.new_ones((pad, 3))])
        tm = torch.cat([tm, tm.new_full((pad,), NEG_INF)])
        out = _unsort(fn(ro[perm], rd[perm], tmin, tm[perm]), perm, r + pad,
                      returns_hit)
        return Hit(*(x[:r] for x in out)) if returns_hit else out[:r]
    if mode == "gather":
        perm = torch.argsort(key, stable=True)
        out = fn(ro[perm], rd[perm], tmin, tm[perm])
        inv = torch.empty_like(perm)
        inv.scatter_(0, perm, torch.arange(r, device=dev))
        if returns_hit:
            return Hit(t=out.t[inv], tri=out.tri[inv],
                       valid=out.tri[inv] >= 0)
        return out[inv]
    if mode not in ("payload", "payload_split"):
        raise ValueError(f"unknown RAYTPU_SORT_MODE {mode!r}")
    key_s, perm = torch.sort(key, stable=True)
    if returns_hit:
        # a closest query's bound is the alive bit: F32_MAX or -inf
        tm_s = torch.where(key_s == _dead_key(), NEG_INF, F32_MAX)
    else:
        tm_s = tm[perm]
    live = perm[:_compact_prefix(r, alive)]
    return _unsort(fn(ro[live], rd[live], tmin, tm_s[:live.shape[0]]), live,
                   r, returns_hit)


@spanned("raytpu::engine.sort")
def _mixed_bounce_query(mixed_fn, pack, ro, rd, alive, s_ro, s_rd, s_dist,
                        s_on):
    """One sorted mixed query serving a bounce's continuation rays AND the
    previous bounce's deferred shadow rays (raytpu's
    ``_mixed_bounce_query``): both sets are concatenated, coherence-sorted
    together with ``_ray_sort_key`` and walked in one call; only ``tri``
    is unsorted (shading recomputes everything from the triangle).
    Returns (Hit for the continuation rays, blocked for the shadow rays)."""
    r = ro.shape[0]
    aro = torch.cat([ro, s_ro])
    ard = torch.cat([rd, s_rd])
    atm = torch.cat([torch.where(alive, F32_MAX, NEG_INF),
                     torch.where(s_on, s_dist, NEG_INF)])
    smask = torch.cat([torch.zeros(r, device=ro.device),
                       torch.ones(r, device=ro.device)])
    perm = torch.sort(_ray_sort_key(pack, aro, ard, torch.cat([alive, s_on])),
                      stable=True)[1]
    _, tri = mixed_fn(aro[perm], ard[perm], atm[perm], smask[perm],
                      tmin=0.001, shadow_tmin=0.0)
    tri_u = torch.empty_like(tri)
    tri_u[perm] = tri
    hit = Hit(t=torch.zeros(r, device=ro.device), tri=tri_u[:r],
              valid=tri_u[:r] >= 0)
    return hit, tri_u[r:] >= 0


@spanned("raytpu::engine.shade")
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


def _compact_tiers(r: int):
    """Live-prefix tier sizes for the fused wave mode: multiples of 256
    covering r/d for each divisor (RAYTPU_COMPACT_DIV), sorted ascending,
    excluding r itself. Empty below 2048 lanes (raytpu's
    ``_compact_tiers``, verbatim)."""
    divs = [
        int(d) for d in os.environ.get(
            "RAYTPU_COMPACT_DIV", "16,4,2"
        ).split(",") if int(d) > 1
    ] if r >= 2048 else []
    return sorted({min(-(-(r // d) // 256) * 256, r) for d in divs} - {r})


def _bounce_work(pack: ScenePack, closest, any_hit, sop, sdp, rngp, alivep,
                 sort_shadow: bool = True):
    """One bounce's query + shade + NEE at whatever width the caller chose
    (the whole wave, or the live prefix of a coherence-sorted one):
    closest query, shading, shadow query (coherence-sorted with
    ``sort_shadow``), radiance delta. Per-lane math only, so safe at any
    width and order (raytpu's ``_bounce_work``). Returns (delta [R, 4],
    attenuation multiplier [R, 4], next_ro, next_rd, bounce_on, rng); a
    lane's delta is its emissive term or its NEE term, never both."""
    tm = torch.where(alivep, F32_MAX, NEG_INF)
    hit = closest(sop, sdp, 0.001, tm)
    sh = _shade_core(pack, sop, sdp, hit, rngp, alivep & hit.valid)
    bounce_on = sh["bounce_on"]
    delta = sh["emissive_delta"] + _nee(
        pack, any_hit, sh["p"], sh["ldir"], sh["dist"], sh["contrib"],
        bounce_on, sort_shadow)
    nro = torch.where(bounce_on[:, None], sh["p"], sop)
    nrd = torch.where(bounce_on[:, None], sh["scattered"], sdp)
    return delta, sh["att_mult"], nro, nrd, bounce_on, sh["rng"]


def _wave_mode(r: int, fusable: bool) -> str:
    """raytpu's bounce-wave schedule for a tile of ``r`` lanes
    (``render.py:1080-1086``): RAYTPU_WAVE_MODE, by default "fused" on
    waves of at least RAYTPU_LARGE_WAVE lanes (2^20) and "query" below;
    "resort" and "compact" are raytpu's other two. The three sorted modes
    apply only to sorted waves with immediate NEE (``fusable``); elsewhere
    the query schedule runs."""
    large_wave = r >= int(os.environ.get("RAYTPU_LARGE_WAVE", str(1 << 20)))
    mode = os.environ.get("RAYTPU_WAVE_MODE",
                          "fused" if large_wave else "query")
    if mode not in ("fused", "query", "resort", "compact"):
        raise ValueError(f"unknown RAYTPU_WAVE_MODE {mode!r}")
    return mode if fusable else "query"


# the schedule of the last _trace_paths call: the wave mode and the work
# width of every bounce run (the full tile in query mode). Each call
# overwrites it, so after a frame of several tiles or samples it describes
# the last tile-sample's path only (chip_smoke.py and the tests read it
# after one-tile, one-sample frames).
WAVE_STATS = dict(mode=None, widths=[])


@spanned("raytpu::engine.paths")
def _trace_paths(pack: ScenePack, closest, any_hit, ro, rd, rng,
                 bounces: int, mask=None, sort_bounced=False,
                 bounce_pair=None, count_mask=None, mixed_fn=None):
    """One full path per lane: the reference's ``pixel_color``
    (src/shader.wgsl:321-381), vectorised with masks. ``mask`` restricts
    which lanes trace at all (lanes outside return 0 radiance). Query
    schedule: immediate NEE, and with ``sort_bounced`` every query but
    the primary one runs coherence-sorted (RAYTPU_B0S_NOSORT leaves the
    first shadow wave unsorted). When ``bounce_pair`` (the strand pair) is
    given, every bounce wave uses it, and so do the primary and first
    shadow waves unless RAYTPU_B0_STRAND=0, as raytpu does. The bounce
    loop stops once no lane is alive (a bounce over dead lanes changes
    nothing).

    The sorted wave modes (``_wave_mode``) run bounce 0 as above and
    bounces 1.. their own way; per-lane math never depends on order or
    width, so each frame is the query schedule's:

    * fused (raytpu's ``fused_step``): the wave stays in coherence-sorted
      order; each bounce sorts only the previous bounce's work tier (the
      live lanes lie inside it) by the unique key ``key << 32 | pixel``,
      runs ``_bounce_work`` on the smallest tier of ``_compact_tiers``
      holding every live lane, and passes the lanes beyond it through;
      one scatter by pixel index at path exit restores the order;
    * resort (raytpu's ``persistent_sort``): each bounce moves the whole
      path state by one sort of ``key << 32 | pixel`` and runs its queries
      and shading in that order, the shadow wave unsorted; one scatter at
      path exit;
    * compact (raytpu's ``compact_step``): each bounce sorts the wave,
      runs the whole bounce on the smallest tier holding every live lane,
      and scatters radiance and path state back.

    With ``mixed_fn`` (a binned or strand mixed query) NEE is deferred, as
    raytpu's ``use_mixed`` branch does it: bounce b's shadow rays ride
    bounce b+1's continuation query in one mixed call
    (``_mixed_bounce_query``), and the last bounce's shadow rays go
    through the any-hit query after the loop. Each lane's pending NEE
    radiance lands before the next bounce's emissive term, the reference's
    per-lane order, so the image is the immediate schedule's up to
    triangle ties.

    With ``count_mask`` also returns the number of ray queries issued by
    masked lanes, as a Python int: 1 primary + 2 per bounce iteration a
    lane survives (the reference's cost model, SURVEY.md §3.4)."""
    b_closest, b_any = bounce_pair if bounce_pair is not None else (
        closest, any_hit)
    if os.environ.get("RAYTPU_B0_STRAND", "1") != "0":
        closest, any_hit = b_closest, b_any
    n_rays = None
    if count_mask is not None:
        with span("raytpu::engine.sync.count"):
            n_rays = int(count_mask.sum())
    r = ro.shape[0]
    dev = ro.device
    radiance = torch.zeros((r, 4), dtype=torch.float32, device=dev)
    with span("raytpu::engine.sync.attenuation"):  # a copy from the host
        attenuation = torch.tensor(
            [1.0, 1.0, 1.0, 0.0], device=dev
        ).expand(r, 4)
    alive = torch.ones(r, dtype=torch.bool, device=dev)
    if mask is not None:
        alive = alive & mask
    pend = None  # the deferred shadow rays: (p, ldir, dist, contrib, on)
    mode = _wave_mode(r, sort_bounced and mixed_fn is None)
    WAVE_STATS.update(mode=mode, widths=[])

    for b in range(bounces):
        if b == 1 and mode != "query":
            run = dict(fused=_fused_bounces, resort=_resort_bounces,
                       compact=_compact_bounces)[mode]
            return run(pack, b_closest, b_any, ro, rd, rng, radiance,
                       attenuation, alive, bounces, count_mask, n_rays)
        with span("raytpu::engine.bounce"):
            with span("raytpu::engine.sync.alive"):
                any_alive = bool(alive.any())
            if not any_alive:
                break
            WAVE_STATS["widths"].append(r)
            if mixed_fn is None:
                # immediate NEE: the bounce's query, shading, shadow query and
                # continuation (:339-377); dead lanes get tmax = -inf, so no
                # query may produce hits for them
                query, shadow = (closest, any_hit) if b == 0 else (b_closest,
                                                                   b_any)
                if sort_bounced and b > 0:
                    def query(o, d, tmin, tmax, alive=alive):
                        return _sorted_query(b_closest, pack, o, d, tmin, tmax,
                                             alive, True)
                sort_shadow = sort_bounced and not (
                    b == 0 and os.environ.get("RAYTPU_B0S_NOSORT"))
                delta, mult, ro, rd, bounce_on, rng = _bounce_work(
                    pack, query, shadow, ro, rd, rng, alive, sort_shadow)
                radiance = radiance + delta
            else:
                if pend is None:
                    hit = closest(ro, rd, 0.001,
                                  torch.where(alive, F32_MAX, NEG_INF))
                else:
                    # continuation + the previous bounce's shadow rays in ONE
                    # query; the deferred NEE lands BEFORE this bounce's
                    # emissive term (reference order)
                    p_p, p_dir, p_dist, p_contrib, p_on = pend
                    hit, blocked = _mixed_bounce_query(
                        mixed_fn, pack, ro, rd, alive, p_p, p_dir, p_dist,
                        p_on)
                    radiance = radiance + torch.where(
                        (p_on & ~blocked)[:, None], p_contrib, 0.0
                    )
                sh = _shade_core(pack, ro, rd, hit, rng, alive & hit.valid)
                rng = sh["rng"]
                bounce_on = sh["bounce_on"]
                mult = sh["att_mult"]
                radiance = radiance + sh["emissive_delta"]
                # the contribution is fixed here; only its visibility test
                # waits for the next query
                pend = (sh["p"], sh["ldir"], sh["dist"], sh["contrib"],
                        bounce_on)
                # continue the path (:376-377)
                ro = torch.where(bounce_on[:, None], sh["p"], ro)
                rd = torch.where(bounce_on[:, None], sh["scattered"], rd)
            attenuation = torch.where(
                bounce_on[:, None], attenuation * mult, attenuation
            )
            alive = bounce_on
            if n_rays is not None:
                with span("raytpu::engine.sync.count"):
                    n_rays += 2 * int((alive & count_mask).sum())
    if pend is not None:
        with span("raytpu::engine.sync.pending"):
            any_pending = bool(pend[4].any())
        if any_pending:
            # the last bounce's shadow wave, alone (raytpu's resolve_last)
            radiance = radiance + _nee(pack, b_any, *pend, sort_bounced)
    if n_rays is not None:
        return radiance * attenuation, rng, n_rays
    return radiance * attenuation, rng


def _resort_bounces(pack, closest, any_hit, ro, rd, rng, radiance,
                    attenuation, alive, bounces, count_mask, n_rays):
    """Bounces 1..B-1 of ``_trace_paths`` in resort wave mode, from bounce
    0's state, with the strand pair; returns what ``_trace_paths``
    returns. Each bounce permutes the whole path state (the count mask
    too) by one sort of the unique key ``key << 32 | pixel`` and runs at
    full width in that order, its shadow wave unsorted (its origins are
    the sorted hit points); one scatter by pixel index at path exit."""
    r = ro.shape[0]
    state = dict(ro=ro, rd=rd, rng=rng, rad=radiance, att=attenuation,
                 alive=alive,
                 pxi=torch.arange(r, dtype=torch.int32, device=ro.device))
    if n_rays is not None:
        state["cm"] = count_mask
    for _ in range(1, bounces):
        with span("raytpu::engine.bounce"):
            with span("raytpu::engine.sync.alive"):
                any_alive = bool(state["alive"].any())
            if not any_alive:
                break  # a bounce over dead lanes changes nothing
            WAVE_STATS["widths"].append(r)
            with span("raytpu::engine.sort"):
                key = _ray_sort_key(pack, state["ro"], state["rd"],
                                    state["alive"])
                perm = torch.sort((key.long() << 32) | state["pxi"].long())[1]
                state = {k: x[perm] for k, x in state.items()}
            delta, mult, nro, nrd, bounce_on, rng_b = _bounce_work(
                pack, closest, any_hit, state["ro"], state["rd"], state["rng"],
                state["alive"], sort_shadow=False)
            state.update(
                ro=nro, rd=nrd, rng=rng_b, rad=state["rad"] + delta,
                att=torch.where(bounce_on[:, None], state["att"] * mult,
                                state["att"]),
                alive=bounce_on)
            if n_rays is not None:
                with span("raytpu::engine.sync.count"):
                    n_rays += 2 * int((bounce_on & state["cm"]).sum())
    # one scatter back to pixel order, radiance * attenuation first
    pxi = state["pxi"].long()
    out = torch.empty((r, 4), dtype=torch.float32, device=ro.device)
    out[pxi] = state["rad"] * state["att"]
    rng_out = torch.empty_like(state["rng"])
    rng_out[pxi] = state["rng"]
    if n_rays is not None:
        return out, rng_out, n_rays
    return out, rng_out


def _compact_bounces(pack, closest, any_hit, ro, rd, rng, radiance,
                     attenuation, alive, bounces, count_mask, n_rays):
    """Bounces 1..B-1 of ``_trace_paths`` in compact wave mode, from bounce
    0's state, with the strand pair; returns what ``_trace_paths``
    returns. Each bounce sorts the wave by its coherence key (dead lanes
    last), runs ``_bounce_work`` on the smallest tier of ``_compact_tiers``
    holding every live lane, and scatters the radiance delta, the
    attenuation multiplier and the path state back to pixel order; the
    lanes beyond the tier are dead and pass through. Radiance and
    attenuation take three colour columns per bounce (w is left as
    raytpu's ``compact_step`` leaves it)."""
    r = ro.shape[0]
    dev = ro.device
    tiers = _compact_tiers(r)
    for _ in range(1, bounces):
        with span("raytpu::engine.bounce"):
            with span("raytpu::engine.sync.alive"):
                n_alive = int(alive.sum())
            if n_alive == 0:
                break  # a bounce over dead lanes changes nothing
            with span("raytpu::engine.sort"):
                perm = torch.sort(_ray_sort_key(pack, ro, rd, alive),
                                  stable=True)[1]
            p = next((t for t in tiers if n_alive <= t), r)
            WAVE_STATS["widths"].append(p)
            live = perm[:p]
            delta, mult, nro, nrd, bounce_on, rng_p = _bounce_work(
                pack, closest, any_hit, ro[live], rd[live], rng[live],
                alive[live])
            # the dead lanes beyond the tier keep their state: zero delta,
            # no bounce
            d3 = torch.zeros((r, 3), dtype=torch.float32, device=dev)
            m3 = torch.zeros((r, 3), dtype=torch.float32, device=dev)
            on = torch.zeros(r, dtype=torch.bool, device=dev)
            ro, rd, rng = ro.clone(), rd.clone(), rng.clone()
            d3[live], m3[live], on[live] = delta[:, :3], mult[:, :3], bounce_on
            ro[live], rd[live], rng[live] = nro, nrd, rng_p
            zero = torch.zeros((r, 1), dtype=torch.float32, device=dev)
            radiance = radiance + torch.cat([d3, zero], dim=1)
            attenuation = torch.where(
                on[:, None], attenuation * torch.cat([m3, zero + 1.0], dim=1),
                attenuation)
            alive = on
            if n_rays is not None:
                with span("raytpu::engine.sync.count"):
                    n_rays += 2 * int((alive & count_mask).sum())
    if n_rays is not None:
        return radiance * attenuation, rng, n_rays
    return radiance * attenuation, rng


def _fused_bounces(pack, closest, any_hit, ro, rd, rng, radiance,
                   attenuation, alive, bounces, count_mask, n_rays):
    """Bounces 1..B-1 of ``_trace_paths`` in fused wave mode, from bounce
    0's state; returns what ``_trace_paths`` returns."""
    r = ro.shape[0]
    tiers = _compact_tiers(r)
    # the path state in sorted order: radiance/attenuation as 3 columns
    # (their w columns are 0 at exit), the pixel index, the count mask
    state = dict(ro=ro.clone(), rd=rd.clone(), rng=rng.clone(),
                 rad=radiance[:, :3].clone(), att=attenuation[:, :3].clone(),
                 alive=alive.clone(),
                 pxi=torch.arange(r, dtype=torch.int32, device=ro.device))
    if n_rays is not None:
        state["cm"] = count_mask.clone()
    wsz = r  # the first sort window: every lane may be alive
    for _ in range(1, bounces):
        with span("raytpu::engine.bounce"):
            # the live lanes lie in the window (the tier that holds them is
            # the smallest at or above n_alive); the count is read once
            with span("raytpu::engine.sync.alive"):
                n_alive = int(state["alive"][:wsz].sum())
            if n_alive == 0:
                break  # a bounce over dead lanes changes nothing
            with span("raytpu::engine.sort"):
                key = _ray_sort_key(pack, state["ro"][:wsz], state["rd"][:wsz],
                                    state["alive"][:wsz])
                # (key, pixel) is unique, so this is raytpu's two-level sort
                perm = torch.sort(
                    (key.long() << 32) | state["pxi"][:wsz].long())[1]
                for x in state.values():
                    x[:wsz] = x[:wsz][perm]
            p = next((t for t in tiers if n_alive <= t), r)
            WAVE_STATS["widths"].append(p)
            s = {k: x[:p] for k, x in state.items()}
            delta, mult, nro, nrd, bounce_on, rng_p = _bounce_work(
                pack, closest, any_hit, s["ro"], s["rd"], s["rng"], s["alive"])
            s["att"].copy_(torch.where(bounce_on[:, None],
                                       s["att"] * mult[:, :3], s["att"]))
            s["rad"].copy_(s["rad"] + delta[:, :3])
            s["ro"].copy_(nro)
            s["rd"].copy_(nrd)
            s["rng"].copy_(rng_p)
            s["alive"].copy_(bounce_on)
            if n_rays is not None:
                with span("raytpu::engine.sync.count"):
                    n_rays += 2 * int((bounce_on & s["cm"]).sum())
            wsz = p  # the next sort window: this bounce's work tier
    # one scatter back to pixel order, radiance * attenuation first
    pxi = state["pxi"].long()
    out = torch.zeros((r, 4), dtype=torch.float32, device=ro.device)
    out[pxi, :3] = state["rad"] * state["att"]
    rng_out = torch.empty_like(state["rng"])
    rng_out[pxi] = state["rng"]
    if n_rays is not None:
        return out, rng_out, n_rays
    return out, rng_out


@spanned("raytpu::engine.nee")
def _nee(pack, any_hit, p, ldir, dist, contrib, on, sort_bounced):
    """Next-event radiance: ``contrib`` where the shadow ray from ``p``
    towards the light reaches it (an any-hit query over [0, dist])."""
    shadow_tmax = torch.where(on, dist, NEG_INF)
    if sort_bounced:
        blocked = _sorted_query(any_hit, pack, p, ldir, 0.0, shadow_tmax, on,
                                False)
    else:
        blocked = any_hit(p, ldir, 0.0, shadow_tmax)
    return torch.where((on & ~blocked)[:, None], contrib, 0.0)


@spanned("raytpu::engine.flat")
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


def _choose_intersectors(pack: ScenePack, config: RenderConfig):
    """Resolve config.intersector to ((closest, any), packet_mode,
    mixed_fn, prefer_mixed, bounce_pair), as raytpu's TPU branch does.

    "auto" applies raytpu's budget rule (``packet_tables_fit``: the BVH8
    rows and leaf rows at 128-lane padding within 100 MiB; a stream pack
    has no BVH8 rows): "packet" when they fit; otherwise "strand" when the
    pack has a strand tree, else "binned" when it has treelets, else
    "brute" at most ``bruteforce_max_tris`` slots and "bvh" above, as
    raytpu's branch ends. "packet" gives the packet route's pair;
    ``bounce_pair`` is the strand pair when the pack has a strand tree
    (above 256 slots, where its tables fit the pack budget or the pack
    streams: scene/pack.py), else None, and ``_trace_paths`` then sends
    every path-mode wave through it.
    With ``bounce_backend="binned"`` ``mixed_fn`` is the binned query,
    with ``"mixed"`` the strand walk's mixed query
    (``make_strand_mixed_query``; a pack without a strand tree raises);
    either carries the deferred-NEE bounces.
    "strand" uses the strand pair everywhere, with the strand mixed query
    for ``bounce_backend="mixed"``, and raises on a pack without a tree.
    "binned" runs every query through the treelets, with
    ``prefer_mixed`` set (deferred NEE above 256 slots). Each kernel is the
    CUDA one for a pack on a CUDA device, its plain version on the CPU;
    all walk rays in 32x32-block order. "brute" and "bvh" go through
    ``make_intersectors`` in row order, with ``packet_mode`` False, as
    raytpu's last branch does: the torch sweep, and the threaded-BVH walk
    with raytpu's visit-order ties. "auto" picks them only for a pack
    with no BVH8 rows, strand tree or treelets, at the end of raytpu's TPU
    branch (raytpu's CPU "auto" picks them at 2048 slots; the port follows
    its TPU branch on both devices)."""
    which = config.intersector
    if config.bounce_backend not in ("sorted", "binned", "mixed"):
        raise ValueError(f"unknown bounce_backend {config.bounce_backend!r}")
    if which == "auto":
        if packetk.packet_tables_fit(pack):
            which = "packet"
        elif pack.bvh.strand_rows is not None:
            which = "strand"
        elif pack.tl_nodes is not None:
            which = "binned"
        elif pack.n_triangles <= config.bruteforce_max_tris:
            which = "brute"
        else:
            which = "bvh"
    if which == "binned":
        if pack.tl_nodes is None:
            raise ValueError(
                "intersector='binned' needs treelet tables; pack the "
                "scene with treelets='always' (or 'auto' above 4096 "
                "triangles)"
            )
        return (make_binned_intersectors(pack), True, make_binned_query(pack),
                True, None)
    if which == "packet":
        if pack.bvh.node8_rows is None:
            raise ValueError(
                "intersector='packet' needs the BVH8 rows, which a "
                "tables='stream' pack drops; use 'auto', 'strand' or "
                "'binned'"
            )
        mixed = None
        if config.bounce_backend == "binned":
            if pack.tl_nodes is None:
                raise ValueError(
                    "bounce_backend='binned' needs treelet tables; pack "
                    "the scene with treelets='always' (or 'auto' above "
                    "4096 triangles)"
                )
            mixed = make_binned_query(pack)
        elif config.bounce_backend == "mixed":
            if pack.bvh.strand_rows is None:
                raise ValueError(
                    "bounce_backend='mixed' needs a strand tree; pack "
                    "the scene with the default packed tables"
                )
            mixed = make_strand_mixed_query(pack)
        bounce_pair = None
        if pack.bvh.strand_rows is not None:
            bounce_pair = make_strand_intersectors(pack)
        return make_packet_intersectors(pack), True, mixed, False, bounce_pair
    if which == "strand":
        pair = make_strand_intersectors(pack)
        mixed = None
        if config.bounce_backend == "mixed":
            mixed = make_strand_mixed_query(pack)
        return pair, True, mixed, False, pair
    if which in ("brute", "bvh"):
        return (make_intersectors(
            pack, bruteforce_max_tris=config.bruteforce_max_tris,
            which=which), False, None, False, None)
    raise ValueError(f"unknown intersector {which!r}")


def _route(pack: ScenePack, config: RenderConfig):
    """(closest, any_hit, packet_mode, sort_bounced, mixed_fn, bounce_pair)
    for one tile: ``mixed_fn`` is None unless the waves are sorted and the
    route prefers deferred NEE or ``bounce_backend`` is "binned" or
    "mixed" (raytpu's ``use_mixed`` rule)."""
    (closest, any_hit), packet_mode, mixed_fn, prefer_mixed, bounce_pair = (
        _choose_intersectors(pack, config))
    sort_bounced = packet_mode and pack.n_triangles > _sort_min_tris()
    use_mixed = sort_bounced and (
        prefer_mixed or config.bounce_backend in ("binned", "mixed"))
    return (closest, any_hit, packet_mode, sort_bounced,
            mixed_fn if use_mixed else None, bounce_pair)


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

    px, py = order(pxg), order(pyg)
    # each a copy from the host, which waits for the device
    with span("raytpu::entry.sync.layout"):
        px = torch.as_tensor(px, dtype=torch.int32, device=device)
    with span("raytpu::entry.sync.layout"):
        py = torch.as_tensor(py, dtype=torch.int32, device=device)

    def unpermute(img):
        img = img.reshape(hp // B, wp // B, B, B, 4)
        img = img.permute(0, 2, 1, 3, 4).reshape(hp, wp, 4)
        return img[:tile_h, :w]

    return px, py, unpermute


def placed(pack: ScenePack, camera: CameraPack, device=None) -> tuple:
    """(pack, camera) where a render entry point runs: on ``device`` when
    the caller names one; else a pack of tensors stays where it is and an
    ``as_numpy`` pack moves to the card. The camera goes with the pack.
    Each entry point calls this once, so a numpy pack is moved once."""
    if device is None:
        if not pack.on_host:
            return pack, camera
        device = "cuda"
    return pack.to(device), camera.to(device)


@spanned("raytpu::entry.tile")
def render_tile(pack: ScenePack, camera: CameraPack, y0: int,
                config: RenderConfig, tile_h: int, seed=None,
                device=None) -> torch.Tensor:
    """Render rows [y0, y0 + tile_h) of the frame; returns [tile_h, W, 4]
    on the pack's device (``placed``'s). ``seed`` overrides config.seed."""
    pack, camera = placed(pack, camera, device)
    w, h = config.width, config.height
    dev = pack.device
    closest, any_hit, packet_mode, sort_bounced, mixed_fn, bounce_pair = (
        _route(pack, config))
    px, py_local, unpermute = _pixel_layout(w, tile_h, packet_mode, dev)
    py = y0 + py_local
    rng = rngk.seed_pixels(px, py, w, config.chunk_size,
                           config.seed if seed is None else seed)

    # pixels outside the dispatched chunk grid stay black (_in_chunk_grid)
    in_grid = _in_chunk_grid(px, py, w, h, config.chunk_size)

    pxf = px.to(torch.float32)
    pyf = py.to(torch.float32)
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
                bounce_pair=bounce_pair, mixed_fn=mixed_fn,
            )
        acc = acc + color
    img = acc / float(config.samples)
    img = torch.where(in_grid[:, None], img, 0.0)
    return unpermute(img)


def count_rays(pack: ScenePack, camera: CameraPack,
               config: RenderConfig, device=None) -> int:
    """Count the ray queries the reference would issue for this frame: one
    primary query per in-grid lane and sample plus, per bounce iteration a
    lane survives, one shadow and one continuation query (the cost model
    of src/shader.wgsl:321-381, SURVEY.md §3.4). Exact: it runs the real
    trace loop with a counter, in path mode whatever ``config.mode`` says,
    as raytpu's ``count_rays`` does. The total is a Python int."""
    pack, camera = placed(pack, camera, device)
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
    closest, any_hit, packet_mode, sort_bounced, mixed_fn, bounce_pair = (
        _route(pack, config))
    px, py_local, _ = _pixel_layout(w, tile_h, packet_mode, dev)
    py = y0 + py_local
    rng = rngk.seed_pixels(px, py, w, config.chunk_size, config.seed)
    # (py < y0 + valid_rows) also drops padding lanes that alias the next
    # tile's pixels: they must not be counted twice
    in_grid = _in_chunk_grid(px, py, w, h, config.chunk_size) & (
        py < y0 + valid_rows)
    pxf = px.to(torch.float32)
    pyf = py.to(torch.float32)
    total = 0
    for _ in range(config.samples):
        rng, jx = rngk.rand(rng)
        rng, jy = rngk.rand(rng)
        ro, rd = cast_rays(pxf + jx, pyf + jy, camera.world,
                           camera.projection, w, h)
        _, rng, n = _trace_paths(
            pack, closest, any_hit, ro, rd, rng, config.bounces,
            mask=in_grid, sort_bounced=sort_bounced,
            bounce_pair=bounce_pair, count_mask=in_grid, mixed_fn=mixed_fn,
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
                       config: RenderConfig, first_row: int = 0,
                       device=None):
    """Generator over (y0, rows, tile [rows, W, 4] numpy f32): the
    progressive API of the GUI and checkpoint/resume (the reference's
    per-chunk loop, src/main.rs:310-317). Tiles that end at or before
    ``first_row`` are neither rendered nor yielded (a resumed checkpoint;
    raytpu renders them and its caller drops them). The device is
    ``placed``'s."""
    pack, camera = placed(pack, camera, device)
    tile_h = _auto_tile_rows(config, pack.n_triangles)
    for y0 in range(0, config.height, tile_h):
        rows = min(tile_h, config.height - y0)
        if y0 + rows <= first_row:
            continue
        tile = render_tile(pack, camera, y0, config, tile_h)
        with span("raytpu::entry.sync.readback"):
            host = tile[:rows].cpu().numpy()
        yield y0, rows, host


@spanned("raytpu::entry.frame")
def render_frame(pack: ScenePack, camera: CameraPack,
                 config: RenderConfig, device=None) -> np.ndarray:
    """Full frame, stitched from tiles on the host; returns [H, W, 4] f32
    (the SAMPLES texture contents, src/state.rs:691-696). The device is
    ``placed``'s: the pack's, or the card for an ``as_numpy`` pack."""
    with span("raytpu::entry.alloc"):
        out = np.zeros((config.height, config.width, 4), np.float32)
    for y0, rows, tile in render_frame_tiles(pack, camera, config,
                                             device=device):
        with span("raytpu::entry.stitch"):
            out[y0 : y0 + rows] = tile
    return out
