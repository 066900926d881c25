"""The renderer: ray generation, bounce loop, sample accumulation, tiling.

Torch counterpart of ``raytpu.engine.render``: path mode's *query*
schedule and, on sorted waves of RAYTPU_LARGE_WAVE (2^20) lanes or
more, its *fused* wave mode (``_wave_mode``, ``_fused_bounces``). One
wavefront of rays per framebuffer tile: every per-bounce step is a
vectorised op over the tile, with boolean masks standing in for the
reference megakernel's divergent branches (src/shader.wgsl:299-419),
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
form. raytpu's sort knobs RAYTPU_MORTON_BITS, RAYTPU_B0_STRAND,
RAYTPU_B0S_NOSORT and RAYTPU_SORT_MIN_TRIS are read where raytpu reads
them; each leaves the frame bit-identical. raytpu's other wave modes
(resort, compact) and sort plumbing (gather, seg, the live-prefix cut)
are not ported: they change raytpu's schedule, never its frame (README).
Every kernel runs as CUDA on a CUDA device and as its plain version on
the CPU. The
``brute`` sweep and the threaded-BVH walk (``bvh``) are plain torch ops on
either device and run only when asked for. ``_shade_core`` shades the
hits: one ``kernels/csrc/shade.cu`` launch a call on the card, its plain
version (kernels/shade.py) on the CPU; ``_ray_sort_key`` likewise writes
each coherence key with one ``kernels/csrc/coherence_key.cu`` launch
(kernels/coherence.py).

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
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..kernels import rng as rngk
from ..kernels.intersect import F32_MAX, Hit, make_intersectors
from ..kernels.binned import make_binned_intersectors, make_binned_query
from ..kernels.coherence import (coherence_key_cuda, coherence_key_torch,
                                 dead_key)
from ..kernels import packet as packetk
from ..kernels.packet import make_packet_intersectors
from ..kernels.shade import (_normalize, _shade_inputs, shade_core_cuda,
                             shade_core_torch)
from ..kernels.strand import make_strand_intersectors, make_strand_mixed_query
from ..kernels.texture import sample_bilinear
from ..obs import span, spanned
from ..scene.pack import _sort_min_tris
from ..types import CameraPack, RenderConfig, ScenePack

NEG_INF = float("-inf")


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


def _in_chunk_grid(px, py, w: int, h: int, cs: int):
    """Pixels the reference actually renders: x is truncated to whole
    chunks, y only to the frame, and the pixel's chunk index must be below
    the ``w*h/chunk_size`` dispatch count (src/state.rs:330-334,
    src/shader.wgsl:400-408)."""
    cols = max(w // cs, 1)
    chunk = (py // cs) * cols + (px // cs)
    return (px // cs < w // cs) & (py < h) & (chunk < (w * h) // cs)


def _morton_bits() -> int:
    """Origin-quantisation bits per axis of the coherence key:
    RAYTPU_MORTON_BITS, default 6, at most 9 (so ``octant << 3*bits``
    stays in int32), raytpu's knob."""
    return min(int(os.environ.get("RAYTPU_MORTON_BITS", "6")), 9)


def _ray_sort_key(pack: ScenePack, ro, rd, alive, bits: int | None = None,
                  pxi=None):
    """Coherence key: dead lanes last, then direction octant (major), then
    the Morton cell of the origin (scene bounds quantised, ``bits`` per
    axis, ``_morton_bits()`` unless given); with ``pxi`` the fused loop's
    unique int64 ``key << 32 | pxi``. One ``csrc/coherence_key.cu``
    launch on CUDA tensors, the plain version (kernels/coherence.py) on
    the CPU."""
    if bits is None:
        bits = _morton_bits()
    args = (ro, rd, alive, pack.scene_bmin, pack.scene_bmax, bits, pxi)
    if ro.device.type == "cuda":
        return coherence_key_cuda(*args)
    return coherence_key_torch(*args)


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
    """Run an intersector on coherence-sorted rays and unsort the result
    (raytpu's ``payload`` mode): a stable sort of the key, the rays
    gathered in, a closest query's bound taken from the sorted key (dead
    lanes carry -inf, live ones F32_MAX), one scatter out. Per-ray results
    never depend on the order (ties break on the tie keys), so the frame is
    the unsorted query's."""
    r = ro.shape[0]
    bits = _morton_bits()
    key_s, perm = torch.sort(_ray_sort_key(pack, ro, rd, alive, bits),
                             stable=True)
    if returns_hit:
        # a closest query's bound is the alive bit: F32_MAX or -inf
        tm_s = torch.where(key_s == dead_key(bits), NEG_INF, F32_MAX)
    else:
        tm_s = torch.as_tensor(tmax, dtype=torch.float32,
                               device=ro.device).expand(r)[perm]
    return _unsort(fn(ro[perm], rd[perm], tmin, tm_s), perm, r, returns_hit)


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
    up to the shadow query), kernels/shade.py's: one ``csrc/shade.cu``
    launch on CUDA tensors, the plain torch version on the CPU. Returns a
    dict: emissive_delta [R,4], att_mult [R,4], scattered/p [R,3],
    bounce_on, ldir/dist/contrib (the shadow ray), and the rng; callers
    read all but rng, bounce_on and emissive_delta under bounce_on."""
    if ro.device.type == "cuda":
        return shade_core_cuda(pack, ro, rd, hit, rng, active)
    return shade_core_torch(pack, ro, rd, hit, rng, active)


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
    (``render.py:1080-1086``): "fused" on sorted waves with immediate NEE
    (``fusable``) of at least RAYTPU_LARGE_WAVE lanes (2^20), else
    "query"."""
    large_wave = r >= int(os.environ.get("RAYTPU_LARGE_WAVE", str(1 << 20)))
    return "fused" if fusable and large_wave else "query"


# the schedule of the last _trace_paths call: the wave mode and the work
# width of every bounce run (the full tile in query mode). Each call
# overwrites it, so after a frame of several tiles or samples it describes
# the last tile-sample's path only (chip_smoke.py and the tests read it
# after one-tile, one-sample frames).
WAVE_STATS = dict(mode=None, widths=[])


@spanned("raytpu::engine.paths")
def _trace_paths(pack: ScenePack, route: Route, ro, rd, rng, bounces: int,
                 mask=None, count: bool = False):
    """One full path per lane: the reference's ``pixel_color``
    (src/shader.wgsl:321-381), vectorised with masks, through ``route``'s
    kernels. ``mask`` restricts which lanes trace at all (lanes outside
    return 0 radiance). Query schedule: immediate NEE, and with
    ``route.sort_bounced`` every query but the primary one runs
    coherence-sorted (RAYTPU_B0S_NOSORT leaves the first shadow wave
    unsorted). When ``route.bounce_pair`` (the strand pair) is given,
    every bounce wave uses it, and so do the primary and first shadow
    waves unless RAYTPU_B0_STRAND=0, as raytpu does. The bounce loop stops
    once no lane is alive (a bounce over dead lanes changes nothing).

    On waves ``_wave_mode`` calls large, bounce 0 runs as above and
    bounces 1.. in raytpu's fused wave mode (``fused_step``,
    ``_fused_bounces``): the wave stays in coherence-sorted order; each
    bounce sorts only the previous bounce's work tier (the live lanes lie
    inside it) by the unique key ``key << 32 | pixel``, runs
    ``_bounce_work`` on the smallest tier of ``_compact_tiers`` holding
    every live lane, and passes the lanes beyond it through; one scatter
    by pixel index at path exit restores the order. Per-lane math never
    depends on order or width, so the frame is the query schedule's.

    With ``route.mixed_fn`` (a binned or strand mixed query) NEE is
    deferred, as raytpu's ``use_mixed`` branch does it: bounce b's shadow
    rays ride bounce b+1's continuation query in one mixed call
    (``_mixed_bounce_query``), and the last bounce's shadow rays go
    through the any-hit query after the loop. Each lane's pending NEE
    radiance lands before the next bounce's emissive term, the reference's
    per-lane order, so the image is the immediate schedule's up to
    triangle ties.

    Returns (radiance [R, 4], rng, n_rays). With ``count``, n_rays is the
    number of ray queries the masked lanes issue, as a Python int: 1
    primary + 2 per bounce iteration a lane survives (the reference's cost
    model, SURVEY.md §3.4); else None. A lane stays alive only inside the
    mask (the shading sets ``bounce_on`` on active lanes alone), so the
    live lanes are the ones to count."""
    sort_bounced, mixed_fn = route.sort_bounced, route.mixed_fn
    closest, any_hit = route.closest, route.any_hit
    b_closest, b_any = route.bounce_pair or (closest, any_hit)
    if os.environ.get("RAYTPU_B0_STRAND", "1") != "0":
        closest, any_hit = b_closest, b_any
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
    n_rays = None
    if count:
        with span("raytpu::engine.sync.count"):
            n_rays = int(alive.sum())
    pend = None  # the deferred shadow rays: (p, ldir, dist, contrib, on)
    mode = _wave_mode(r, sort_bounced and mixed_fn is None)
    WAVE_STATS.update(mode=mode, widths=[])

    for b in range(bounces):
        if b == 1 and mode == "fused":
            out, rng, n = _fused_bounces(pack, b_closest, b_any, ro, rd, rng,
                                         radiance, attenuation, alive,
                                         bounces, count)
            return out, rng, n_rays + n if count else None
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
            if count:
                with span("raytpu::engine.sync.count"):
                    n_rays += 2 * int(alive.sum())
    if pend is not None:
        with span("raytpu::engine.sync.pending"):
            any_pending = bool(pend[4].any())
        if any_pending:
            # the last bounce's shadow wave, alone (raytpu's resolve_last)
            radiance = radiance + _nee(pack, b_any, *pend, sort_bounced)
    return radiance * attenuation, rng, n_rays


def _fused_bounces(pack, closest, any_hit, ro, rd, rng, radiance,
                   attenuation, alive, bounces, count):
    """Bounces 1..B-1 of ``_trace_paths`` in fused wave mode, from bounce
    0's state: (radiance * attenuation, rng, the queries of these bounces
    with ``count``, else 0)."""
    r = ro.shape[0]
    tiers = _compact_tiers(r)
    # the path state in sorted order: radiance/attenuation as 3 columns
    # (their w columns are 0 at exit), the pixel index
    state = dict(ro=ro.clone(), rd=rd.clone(), rng=rng.clone(),
                 rad=radiance[:, :3].clone(), att=attenuation[:, :3].clone(),
                 alive=alive.clone(),
                 pxi=torch.arange(r, dtype=torch.int32, device=ro.device))
    n_rays = 0
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
                # (key, pixel) is unique, so this is raytpu's two-level sort
                perm = torch.sort(_ray_sort_key(
                    pack, state["ro"][:wsz], state["rd"][:wsz],
                    state["alive"][:wsz], pxi=state["pxi"][:wsz]))[1]
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
            if count:
                with span("raytpu::engine.sync.count"):
                    n_rays += 2 * int(bounce_on.sum())
            wsz = p  # the next sort window: this bounce's work tier
    # one scatter back to pixel order, radiance * attenuation first
    pxi = state["pxi"].long()
    out = torch.zeros((r, 4), dtype=torch.float32, device=ro.device)
    out[pxi, :3] = state["rad"] * state["att"]
    rng_out = torch.empty_like(state["rng"])
    rng_out[pxi] = state["rng"]
    return out, rng_out, n_rays


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


class Route(NamedTuple):
    """One tile's kernels and schedule (``_route``)."""

    closest: Callable
    any_hit: Callable
    packet_mode: bool  # rays in 32x32-block order (``_pixel_layout``)
    sort_bounced: bool  # every query but the primary one coherence-sorted
    mixed_fn: Callable | None  # deferred NEE's mixed query, else None
    bounce_pair: tuple | None  # the strand (closest, any_hit) pair


def _route(pack: ScenePack, config: RenderConfig) -> Route:
    """Resolve config.intersector and config.bounce_backend to a ``Route``,
    as raytpu's TPU branch does.

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
    With ``bounce_backend="binned"`` the mixed query is the binned query,
    with ``"mixed"`` the strand walk's mixed query
    (``make_strand_mixed_query``; a pack without a strand tree raises);
    either carries the deferred-NEE bounces.
    "strand" uses the strand pair everywhere, with the strand mixed query
    for ``bounce_backend="mixed"``, and raises on a pack without a tree.
    "binned" runs every query through the treelets, with deferred NEE
    above 256 slots. Each kernel is the CUDA one for a pack on a CUDA
    device, its plain version on the CPU; all walk rays in 32x32-block
    order (``packet_mode``). "brute" and "bvh" go through
    ``make_intersectors`` in row order, with ``packet_mode`` False, as
    raytpu's last branch does: the torch sweep, and the threaded-BVH walk
    with raytpu's visit-order ties. "auto" picks them only for a pack
    with no BVH8 rows, strand tree or treelets, at the end of raytpu's TPU
    branch (raytpu's CPU "auto" picks them at 2048 slots; the port follows
    its TPU branch on both devices).

    ``sort_bounced`` holds on the walk routes above RAYTPU_SORT_MIN_TRIS
    slots, and ``mixed_fn`` is the mixed query only where the waves are
    sorted and the route is "binned" or ``bounce_backend`` is "binned" or
    "mixed" (raytpu's ``use_mixed`` rule); else None."""
    which = config.intersector
    backend = config.bounce_backend
    if backend not in ("sorted", "binned", "mixed"):
        raise ValueError(f"unknown bounce_backend {backend!r}")
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
    packet_mode, mixed, bounce_pair = True, None, None
    prefer_mixed = which == "binned"
    if which == "binned":
        if pack.tl_nodes is None:
            raise ValueError(
                "intersector='binned' needs treelet tables; pack the "
                "scene with treelets='always' (or 'auto' above 4096 "
                "triangles)"
            )
        pair, mixed = make_binned_intersectors(pack), make_binned_query(pack)
    elif which == "packet":
        if pack.bvh.node8_rows is None:
            raise ValueError(
                "intersector='packet' needs the BVH8 rows, which a "
                "tables='stream' pack drops; use 'auto', 'strand' or "
                "'binned'"
            )
        if backend == "binned":
            if pack.tl_nodes is None:
                raise ValueError(
                    "bounce_backend='binned' needs treelet tables; pack "
                    "the scene with treelets='always' (or 'auto' above "
                    "4096 triangles)"
                )
            mixed = make_binned_query(pack)
        elif backend == "mixed":
            if pack.bvh.strand_rows is None:
                raise ValueError(
                    "bounce_backend='mixed' needs a strand tree; pack "
                    "the scene with the default packed tables"
                )
            mixed = make_strand_mixed_query(pack)
        if pack.bvh.strand_rows is not None:
            bounce_pair = make_strand_intersectors(pack)
        pair = make_packet_intersectors(pack)
    elif which == "strand":
        pair = bounce_pair = make_strand_intersectors(pack)
        if backend == "mixed":
            mixed = make_strand_mixed_query(pack)
    elif which in ("brute", "bvh"):
        pair = make_intersectors(
            pack, bruteforce_max_tris=config.bruteforce_max_tris,
            which=which)
        packet_mode = False
    else:
        raise ValueError(f"unknown intersector {which!r}")
    sort_bounced = packet_mode and pack.n_triangles > _sort_min_tris()
    use_mixed = sort_bounced and (
        prefer_mixed or backend in ("binned", "mixed"))
    return Route(*pair, packet_mode, sort_bounced,
                 mixed if use_mixed else None, bounce_pair)


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

    def order(a):
        return a.reshape(hp // B, B, wp // B, B).permute(0, 2, 1, 3).reshape(-1)

    # built where the rays are: no host array, no copy, no sync
    cols = torch.arange(wp, dtype=torch.int32, device=device)
    rows = torch.arange(hp, dtype=torch.int32, device=device)
    px = order(cols.expand(hp, wp))
    py = order(rows[:, None].expand(hp, wp))

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


class _Tile(NamedTuple):
    """A tile's lanes before its first sample (``_tile``)."""

    route: Route
    py: torch.Tensor  # each lane's frame row
    in_grid: torch.Tensor  # the lanes the reference renders
    unpermute: Callable  # [R, 4] lanes -> [tile_h, W, 4]
    rng: torch.Tensor  # the per-pixel seeds
    pxf: torch.Tensor  # the lanes' pixel coordinates as float32
    pyf: torch.Tensor


def _tile(pack: ScenePack, y0: int, config: RenderConfig, tile_h: int,
          seed: int) -> _Tile:
    """Rows [y0, y0 + tile_h) as lanes: the route, its pixel layout,
    per-pixel RNG seeding and the chunk grid (pixels outside it stay
    black: ``_in_chunk_grid``)."""
    w = config.width
    route = _route(pack, config)
    px, py_local, unpermute = _pixel_layout(w, tile_h, route.packet_mode,
                                            pack.device)
    py = y0 + py_local
    rng = rngk.seed_pixels(px, py, w, config.chunk_size, seed)
    in_grid = _in_chunk_grid(px, py, w, config.height, config.chunk_size)
    return _Tile(route, py, in_grid, unpermute, rng, px.to(torch.float32),
                 py.to(torch.float32))


def _camera_rays(tile: _Tile, camera: CameraPack, config: RenderConfig,
                 rng):
    """One sample's camera rays, each pixel jittered by + vec2(rand(),
    rand()) (src/shader.wgsl:413): (ro, rd, rng)."""
    rng, jx = rngk.rand(rng)
    rng, jy = rngk.rand(rng)
    ro, rd = cast_rays(tile.pxf + jx, tile.pyf + jy, camera.world,
                       camera.projection, config.width, config.height)
    return ro, rd, rng


@spanned("raytpu::entry.tile")
def render_tile(pack: ScenePack, camera: CameraPack, y0: int,
                config: RenderConfig, tile_h: int, seed=None,
                device=None) -> torch.Tensor:
    """Render rows [y0, y0 + tile_h) of the frame; returns [tile_h, W, 4]
    on the pack's device (``placed``'s). ``seed`` overrides config.seed."""
    pack, camera = placed(pack, camera, device)
    tile = _tile(pack, y0, config, tile_h,
                 config.seed if seed is None else seed)
    rng = tile.rng
    acc = torch.zeros((rng.shape[0], 4), dtype=torch.float32,
                      device=pack.device)
    for _ in range(config.samples):
        with span("raytpu::entry.sample"):
            ro, rd, rng = _camera_rays(tile, camera, config, rng)
            if config.mode == "flat":
                color = _flat_shade(pack, tile.route.closest, ro, rd)
            else:
                color, rng, _ = _trace_paths(pack, tile.route, ro, rd, rng,
                                             config.bounces,
                                             mask=tile.in_grid)
            acc = acc + color
    img = acc / float(config.samples)
    img = torch.where(tile.in_grid[:, None], img, 0.0)
    return tile.unpermute(img)


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
    tile = _tile(pack, y0, config, tile_h, config.seed)
    # (py < y0 + valid_rows) also drops padding lanes that alias the next
    # tile's pixels: they must not be counted twice
    mask = tile.in_grid & (tile.py < y0 + valid_rows)
    rng = tile.rng
    total = 0
    for _ in range(config.samples):
        ro, rd, rng = _camera_rays(tile, camera, config, rng)
        _, rng, n = _trace_paths(pack, tile.route, ro, rd, rng,
                                 config.bounces, mask=mask, count=True)
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
    """Full frame; returns a new [H, W, 4] f32 array on every call (the
    SAMPLES texture contents, src/state.rs:691-696). Each tile's rows are
    copied once, asynchronously, straight into the host frame, and the
    host waits once a frame. On a card the frame is page-locked: while
    the caller holds the array its memory is a block of torch's pinned
    host cache, which takes it back when the array is dropped. Every row
    comes from a tile, so the frame is never zeroed. The device is
    ``placed``'s: the pack's, or the card for an ``as_numpy`` pack."""
    pack, camera = placed(pack, camera, device)
    cuda = pack.device.type == "cuda"
    with span("raytpu::entry.alloc"):
        frame = torch.empty((config.height, config.width, 4),
                            dtype=torch.float32, pin_memory=cuda)
    tile_h = _auto_tile_rows(config, pack.n_triangles)
    for y0 in range(0, config.height, tile_h):
        rows = min(tile_h, config.height - y0)
        tile = render_tile(pack, camera, y0, config, tile_h)
        with span("raytpu::entry.readback"):
            frame[y0 : y0 + rows].copy_(tile[:rows], non_blocking=True)
    with span("raytpu::entry.sync.readback"):
        if cuda:
            torch.cuda.current_stream(pack.device).synchronize()
    return frame.numpy()
