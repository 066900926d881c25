"""Smoke test of raytpu_torch on one NVIDIA GPU (run from the repo root):

    python3 chip_smoke.py

Builds the CUDA kernels from source (strand walk, the packet route's
BVH8 walk, the binned route's treelet walk, the block-scheduled strand
walk and the per-step probe, one nvcc each, in parallel; beside them,
phase 2b holds the default strand walk and block walk instances' machine
code to the stored digests, ``tools/sass_diff.py``), holds each
walk bit for bit against its plain torch version (phases 3, 3b, 3c, 3d;
3e and 3f the mixed-lane forms of the strand and packet walks, also
against their separate closest-hit and any-hit launches; 3g the strand
walk over ribbon rows, one record a step and with the K-wide fetch, also
against the strand layout, and its stats counters; 3h the packet walk's near-first instances, also against storage
order, and both orders' stats; 3i the strand walk's schedule form in each
fetch form and the block walk's deferral form, also against the default
instances, with every counter, then swept over pool sizes, claim sizes,
the dual and K-wide forms and the deferral form's G and skip_done on a
ray count that fills no block's warps),
renders small frames on the card and on the CPU (phase 4, the packet
route in path and flat mode; phase 4b, the binned route on a stream
pack), then drives the entry points in this process, so each kernel's
launch count can be read:

* phase 5, the strand route through ``raytpu_torch.cli.main``: path mode
  at the repo's headline configuration (1920x1080, 1 spp, 4 bounces, a
  259k-triangle gallery), which runs raytpu's fused wave mode; the same
  frame in query mode must give the same PNG; every wave of the frame held
  to the brute sweep on a 16,384-ray sample (ROADMAP fault 3.4);
* phase 5b, phase 5's CLI run with ``RAYTPU_STRAND_PERSISTENT=0``: every
  strand query on the block walk, each wave sampled against the brute
  sweep, both walks equal on every ray, the same PNG;
* phase 6, the packet route through the CLI at bench.py's settings: (a)
  the pbr+nee scene and (b) a cube stand-in, every ray of every
  packet_walk call of a frame held to the brute sweep; (c) flat mode on
  the gallery at 1920x1080, its primary wave sampled against the brute
  sweep, every ray where packet_walk and strand_walk differ held to it,
  and the rays the walk's unrepaired rules lose (ROADMAP fault 3.5),
  classed;
* phase 7a, the binned route at bench.py's config 6 shape through
  ``pack_scene(tables="auto")`` and ``render_frame``: the gallery scaled
  to 2.9M triangles at 640x360, 1 spp, 4 bounces, whose BVH8 and leaf
  rows exceed the pack budget, so the pack streams by raytpu's TPU rule
  (bench.py config 6's check: no BVH8 rows, a strand tree); every launch
  of a frame against the plain version, the primary wave against the
  brute sweep and strand_walk, and fault 3.5's lost rays, as in 6c, on the
  primary wave and on every closest-hit lane of every bounce query; its
  strand tables exceed raytpu's 100 MiB budget, and strand_walk's default
  instance is timed there in turns with the pipelined schedule form
  (raytpu's tree_any), with claims of 16 batches and of 1;
* phase 7b, deferred NEE beside the strand route: phase 5's scene and
  configuration with ``bounce_backend="binned"``, held to phase 5's frame,
  its binned mixed queries sampled against the brute sweep, and fault
  3.5's lost rays counted on every closest-hit lane of each;
* phase 8, the per-step probe (``raytpu_torch.tools.step_bench``): every
  arm on the card against its plain replay at W 8, 40, 128 and 1024 (1
  and 16 iterations, each launch's grid printed), then the full table;
* phase 9, the rest of raytpu's surface: (a) the threaded-BVH route
  (``intersector="bvh"``, plain torch ops) on a 2.6k-triangle gallery,
  one wave's tri and t bits equal to the CPU's and a 64x64 frame; (b)
  checkpoint/resume on phase 5's gallery at 640x360, interrupted after 2
  of 4 tiles, bit-equal to the uninterrupted frame; (c) row and sample
  shards against the single-device frame; (d) the CLI with ``--profile``,
  whose trace must name strand_walk's kernel; (e) the CLI with ``--gui``
  without a display, the same PNG as the plain run; (f) a card frame of
  the multi-mesh scene against the port's copy of raytpu's scalar oracle;
  (g) the pack options on 9a's scene: the ``bvh`` route refusing a stream
  pack and rendering a ``tables="all"`` one, an ``as_numpy`` pack pickled
  and moved to the card rendering the direct pack's PNG, ``auto`` on a
  ``treelets="never"`` pack over a shrunk budget taking raytpu's TPU
  route (``bvh``), and the CLI in a child process under
  ``RAYTPU_NO_NATIVE=1`` (the pure-Python BVH builder);
* phase 10, raytpu's remaining engine arms on phase 5's frame: (a)
  ``bounce_backend="mixed"`` (deferred NEE through the strand walk's
  mixed form), whose PNG must equal phase 7b's and whose mixed queries
  are sampled against the brute sweep; (b) ``RAYTPU_WAVE_MODE=resort``
  and ``compact``; (c) ``RAYTPU_SORT_MODE=gather``, ``seg`` and
  ``RAYTPU_COMPACT=1``, each PNG equal to phase 5's;
* phase 11, raytpu's kernel options: (a) phase 5's frame and 10a's with
  ``RAYTPU_RIBBON=1`` and ``=4`` (the strand walks over the pack's ribbon
  rows, one record a step and with the K-wide fetch), each PNG equal to
  its phase's, and the ribbon forms timed beside the strand layout on the
  1080p primary wave and 10a's largest mixed query; (b) 6c
  with ``RAYTPU_ORDER_MODE=all`` (packet_walk's near-first instance), the
  PNG equal to 6c's, near-first timed beside storage order; each with and
  without stats;
* phase 12, raytpu's schedule flags on phase 5's frame: raytpu's schedule
  defaults set in the environment (the strand walk's pipelined schedule
  form), ``RAYTPU_STRAND_PIPE=0``, ``PIPE=1 DUAL=1`` and ``RAYTPU_RIBBON=4
  RAYTPU_STRAND_WALKERS=128``, each also with ``bounce_backend="mixed"``,
  each PNG equal to phase 5's or 10a's, and the block route with
  ``RAYTPU_STRAND_GROUPS=16 RAYTPU_STRAND_SKIP_DONE=1`` (the deferral
  form), its PNG equal to 5b's; every form timed in turns with the default
  instance on the primary wave, bounce 1's wave and 10a's largest mixed
  query, and held to its plain version there;
* phase 13, raytpu's own bench scene, its procedural atrium
  (``raytpu_torch/tools/scenes.py``): (a) bench.py's config 5, the
  300,702-triangle atrium at 1920x1080, 1 spp, 4 bounces, chunk 8 through
  ``render_frame`` (fused wave mode), a cold and two warm frames with
  Mrays/s and a profile, every wave sampled against the brute sweep,
  fault 3.4's lost rays counted on the primary wave and every bounce
  lane, query mode's and the block walk's PNGs equal to it, card against
  CPU at 64x36; (b) config 6, the 3,555,630-triangle atrium packed
  ``tables="auto"`` (it must stream) at 640x360, the same figures, the
  primary wave against the plain version and the brute sweep, and
  bench.py's ``RAYTPU_STREAM_BINNED`` arm; (c) raytpu's four captured
  waves through ``tools/strand_ab.py`` (``--block --check``) and
  ``tools/waves.py`` (``stats``, ``ab``), the launches of ``stats`` and
  ``ab`` held to one plain replay each, one table, and the port's capture
  of raytpu's fixture tile against the committed bands.

Every phase prints its result; a failed phase exits non-zero. The last
two lines are the per-kernel JSON record (each kernel, and each form:
mixed, ribbon, K-wide fetch, near-first, the schedule and deferral forms)
and ``{"ok": true, "device": {...}}``. Each kernel's bound is the larger of the bytes it must move
over 3.35 TB/s and its operations over 67 TFLOP/s f32 (one H100 SXM's
peaks). A walk's bytes are the distinct node and leaf rows that the
per-ray plain walk reads on the measured rays, each once, plus the rays
in and the results out; its operations are that walk's box and triangle
tests. The block walk, the ribbon forms and the schedule and deferral
forms are held to the default per-ray walk's work on their wave: what
they load or test beyond that is their own cost, not the function's.

Needs a CUDA device, nvcc and the repo checkout; imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

KERNELS = {
    "strand": dict(
        name="strand_walk",
        route="cuda",
        source="raytpu_torch/kernels/csrc/strand_walk.cu",
        replaces="raytpu/kernels/strand_persistent.py:52",
    ),
    "packet": dict(
        name="packet_walk",
        route="cuda",
        source="raytpu_torch/kernels/csrc/packet_walk.cu",
        replaces="raytpu/kernels/intersect_pallas.py:71",
    ),
    "binned": dict(
        name="binned_walk",
        route="cuda",
        source="raytpu_torch/kernels/csrc/binned_walk.cu",
        replaces="raytpu/kernels/binned.py:50",
    ),
    "block": dict(
        name="strand_block",
        route="cuda",
        source="raytpu_torch/kernels/csrc/strand_block.cu",
        replaces="raytpu/kernels/strand.py:55",
    ),
    "step": dict(
        name="step_bench",
        route="cuda",
        source="raytpu_torch/kernels/csrc/step_bench.cu",
        replaces="benchmarks/step_bench.py:62",
    ),
    "strand_mixed": dict(
        name="strand_walk (mixed)",
        route="cuda",
        source="raytpu_torch/kernels/csrc/strand_walk.cu",
        replaces="raytpu/kernels/strand_persistent.py:52",
    ),
    "packet_mixed": dict(
        name="packet_walk (mixed)",
        route="cuda",
        source="raytpu_torch/kernels/csrc/packet_walk.cu",
        replaces="raytpu/kernels/intersect_pallas.py:71",
    ),
    "strand_ribbon": dict(
        name="strand_walk (ribbon)",
        route="cuda",
        source="raytpu_torch/kernels/csrc/strand_walk.cu",
        replaces="raytpu/kernels/strand_persistent.py:52",
    ),
    "strand_mixed_ribbon": dict(
        name="strand_walk (mixed, ribbon)",
        route="cuda",
        source="raytpu_torch/kernels/csrc/strand_walk.cu",
        replaces="raytpu/kernels/strand_persistent.py:52",
    ),
    "strand_ribbon_wide": dict(
        name="strand_walk (ribbon, K-wide fetch)",
        route="cuda",
        source="raytpu_torch/kernels/csrc/strand_walk.cu",
        replaces="raytpu/kernels/strand_persistent.py:52",
    ),
    "strand_mixed_ribbon_wide": dict(
        name="strand_walk (mixed, ribbon, K-wide fetch)",
        route="cuda",
        source="raytpu_torch/kernels/csrc/strand_walk.cu",
        replaces="raytpu/kernels/strand_persistent.py:52",
    ),
    "packet_near": dict(
        name="packet_walk (near-first)",
        route="cuda",
        source="raytpu_torch/kernels/csrc/packet_walk.cu",
        replaces="raytpu/kernels/intersect_pallas.py:71",
    ),
    "packet_mixed_near": dict(
        name="packet_walk (mixed, near-first)",
        route="cuda",
        source="raytpu_torch/kernels/csrc/packet_walk.cu",
        replaces="raytpu/kernels/intersect_pallas.py:71",
    ),
}
# strand_walk's schedule form (strand_common.cuh:sched_kernel), one entry
# per fetch form and mode ("strand_<form>", "strand_mixed_<form>"), and
# strand_block's deferral form
SCHED_FORMS = ("load", "pipe", "dual", "smem", "wide")
for _form in SCHED_FORMS:
    for _key, _mode in (("strand", ""), ("strand_mixed", "mixed, ")):
        KERNELS[f"{_key}_{_form}"] = dict(
            name=f"strand_walk ({_mode}schedule, {_form})",
            route="cuda",
            source="raytpu_torch/kernels/csrc/strand_walk.cu",
            replaces="raytpu/kernels/strand_persistent.py:52",
        )
KERNELS["block_defer"] = dict(
    name="strand_block (deferral)",
    route="cuda",
    source="raytpu_torch/kernels/csrc/strand_block.cu",
    replaces="raytpu/kernels/strand.py:55",
)
# phase 3i's schedule sets (raytpu's keywords): raytpu's factory defaults
# (strand.py:507-546 at >= 4096 triangles), tests/test_strand.py:150-159's
# small pool with many refills, and one set per fetch form; the ribbon sets
# walk the ribbon rows
RAYTPU_SCHED = dict(walkers=128, service_k=16, flush_occ=0.5, pipe=True,
                    unroll=4)
SCHED_SETS = {
    "raytpu defaults": RAYTPU_SCHED,
    "small pool": dict(walkers=8, service_k=2, pipe=True, unroll=4,
                       ctl_every=4, flush_pop=2),
    "no pipe": dict(walkers=128, service_k=16, flush_occ=0.5),
    "dual": dict(RAYTPU_SCHED, dual=True),
    "fetch_smem": dict(RAYTPU_SCHED, fetch_smem=True),
    "ribbon K=4": dict(walkers=128, service_k=16, flush_occ=0.5,
                       ribbon_k=4),
    "ribbon K=8": dict(walkers=128, service_k=16, flush_occ=0.5,
                       ribbon_k=8),
}
# and the block walk's deferral sets (raytpu's groups and skip_done)
DEFER_SETS = {"G=16 skip_done": dict(defer=True, groups=16, skip_done=True),
              "G=4": dict(defer=True, groups=4)}
# phase 3i's sweep of the launch shapes: raytpu's pool sizes (which add no
# code) and claim sizes on the pipe form, the dual and K-wide forms at each
# claim size, and the deferral form's G and skip_done, on a ray count whose
# batches fill neither a block's 4 warps nor its 2 pairs (2,045 batches of
# 32 rays, 1,023 of 64)
SWEEP_RAYS = 65536 - 101
SWEEP_SETS = {
    **{f"pipe walkers={w} service_k={k}": dict(RAYTPU_SCHED, walkers=w,
                                               service_k=k)
       for w in (1, 128, 4096) for k in (1, 16, 64)},
    **{f"dual service_k={k}": dict(RAYTPU_SCHED, dual=True, service_k=k)
       for k in (1, 16, 64)},
    **{f"ribbon K={r} service_k={k}": dict(walkers=128, service_k=k,
                                           flush_occ=0.5, ribbon_k=r)
       for r in (4, 8) for k in (1, 16, 64)},
}
DEFER_SWEEP = {f"G={g}" + (" skip_done" if s else ""): dict(
    defer=True, groups=g, skip_done=s) for g in (1, 4, 16, 32)
    for s in (False, True)}
# one H100 SXM's peaks (NVIDIA's data sheet, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# operations per box test (6 sub, 6 mul, 4 max, 4 min, 1 compare) and per
# Moller-Trumbore triangle test (cross 9, det 5, div 1, tvec 3, u 6,
# cross 9, v 6, t 6, 8 compares and the u + v add)
SLAB_OPS = 21
TRI_OPS = 53
# step_bench's full arm per state element and iteration: 3 for IDX, NEG
# and RO, 12 for the six bounds, 4 max, 4 min, 1 compare (rolls and the
# queue move data)
STEP_FULL_OPS = 24
F32_MAX = float(np.float32(3.40282347e38))
MAIN_ARGS = dict(width=1920, height=1080, seed=1, chunk_size=64, samples=1,
                 bounces=4)
# rays of phase 5b's frame on which the two strand walks differ, and on
# which strand_walk misses the brute sweep's hit: 69 before ROADMAP fault
# 3.4 was repaired (box tests that missed by rounding, ties between
# spatial-split copies); pinned, so that any change fails the phase
STRAND_WALKS_DIFFER = 0
STRAND_WALK_LOST_HITS = 0
# rays of phase 6c's 1080p flat primary wave on which packet_walk misses
# the brute sweep's result, counted on the 16,384-ray sample and on the
# whole wave (where it differs from strand_walk), and pinned: 4 of the
# wave before ROADMAP fault 3.5 was repaired (the box test and the tie
# rule of fault 3.4)
PACKET_LOST_HITS = 0
PACKET_WAVE_LOST_HITS = 0
SAMPLE = 16384  # rays per wave held to the brute sweep
GALLERY_CAM = {"origin": [0, 2.5, -9], "at": [0, -0.5, 0], "fov": 0.7}


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def soup(ntri, seed=0):
    """Random triangle soup (the strand tests' scenes)."""
    rng = np.random.default_rng(seed)
    p0 = (rng.random((ntri, 3), np.float32) - 0.5) * 10
    e1 = rng.normal(size=(ntri, 3)).astype(np.float32)
    e2 = rng.normal(size=(ntri, 3)).astype(np.float32)
    return p0, e1, e2


def soup_rays(n, seed):
    """Random rays with exactly-zero (both signs) direction components,
    octant-sorted as the engine's sort would group them."""
    rng = np.random.default_rng(seed)
    ro = (rng.random((n, 3), np.float32) - 0.5) * 8.0
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    rd[::11, 0] = 0.0
    rd[5::13, 1] = -0.0
    rd[7::17, 2] = 0.0
    octant = (rd[:, 0] < 0) + 2 * (rd[:, 1] < 0) + 4 * (rd[:, 2] < 0)
    idx = np.argsort(octant, kind="stable")
    return ro[idx], rd[idx]


def slot_rows(p0, e1, e2):
    """A scene's (bvh, bvh8, slot-ordered triangle rows [S, 10], slot ->
    triangle) for triangles p0/e1/e2."""
    from raytpu_torch.accel.bvh import build_bvh

    bvh, bvh8 = build_bvh(p0, e1, e2)
    order = bvh.tri_order
    per = np.zeros((order.shape[0], 10), np.float32)
    v = order >= 0
    per[v, 0:3], per[v, 3:6], per[v, 6:9] = (
        p0[order[v]], e1[order[v]], e2[order[v]])
    return bvh, bvh8, per, order


def tie_scene():
    """40 small triangles plus 11 exact copies of triangle 0 (12 copies
    over two leaves) and 500 rays aimed at it: (bvh, bvh8,
    slot-ordered triangle rows [S, 10], slot -> triangle, ro, rd)."""
    r = np.random.default_rng(7)
    p0 = (r.random((40, 3), np.float32) - 0.5) * 10
    e1 = (r.normal(size=(40, 3)) * 0.3).astype(np.float32)
    e2 = (r.normal(size=(40, 3)) * 0.3).astype(np.float32)
    p0, e1, e2 = (np.concatenate([a, np.repeat(a[:1], 11, 0)])
                  for a in (p0, e1, e2))
    bvh, bvh8, per, order = slot_rows(p0, e1, e2)
    c = p0[0] + (e1[0] + e2[0]) / 3
    ro = (r.random((500, 3), np.float32) - 0.5) * 12
    rd = c - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return bvh, bvh8, per, order, ro, rd


def kernel_fns(which: str):
    """(tables of (bvh, BVH8 rows, leaf rows), kernel wrapper, plain
    version) of the strand walk or the packet route's BVH8 walk: the
    tables are the walk's arguments before the rays, on the leaf rows'
    device."""
    import torch

    if which == "strand":
        from raytpu_torch.accel.strandtree import build_strand_tree
        from raytpu_torch.kernels.strand import (
            first_slots,
            strand_query_cuda,
            strand_query_torch,
        )

        return (lambda bvh, rows8, leaf: (
                    torch.from_numpy(np.ascontiguousarray(
                        build_strand_tree(bvh).rows)).to(leaf.device),
                    leaf, first_slots(leaf)),
                strand_query_cuda, strand_query_torch)
    from raytpu_torch.kernels.packet import (
        packet_query_cuda,
        packet_query_torch,
    )
    from raytpu_torch.kernels.strand import first_slots

    return (lambda bvh, rows8, leaf: (
                torch.from_numpy(np.ascontiguousarray(rows8)).to(leaf.device),
                leaf, first_slots(leaf)), packet_query_cuda,
            packet_query_torch)


def _counters() -> dict:
    """Each kernel's launch count as (wrapper, attribute): packet_walk's
    wrapper counts its mixed form and its near-first instances apart, the
    strand walks' wrappers their launches over ribbon rows."""
    from raytpu_torch.kernels.binned import binned_walk_cuda
    from raytpu_torch.kernels.packet import packet_query_cuda
    from raytpu_torch.kernels.strand import (
        strand_block_query_cuda,
        strand_mixed_query_cuda,
        strand_query_cuda,
    )
    from raytpu_torch.tools.step_bench import step_bench_cuda

    forms = {}
    for form in SCHED_FORMS:
        forms[f"strand_{form}"] = (strand_query_cuda, f"{form}_launches")
        forms[f"strand_mixed_{form}"] = (strand_mixed_query_cuda,
                                         f"{form}_launches")
    return dict(**forms, block_defer=(strand_block_query_cuda,
                                      "defer_launches"),
                strand=(strand_query_cuda, "launches"),
                packet=(packet_query_cuda, "launches"),
                binned=(binned_walk_cuda, "launches"),
                block=(strand_block_query_cuda, "launches"),
                step=(step_bench_cuda, "launches"),
                strand_mixed=(strand_mixed_query_cuda, "launches"),
                packet_mixed=(packet_query_cuda, "mixed_launches"),
                strand_ribbon=(strand_query_cuda, "ribbon_launches"),
                strand_mixed_ribbon=(strand_mixed_query_cuda,
                                     "ribbon_launches"),
                strand_ribbon_wide=(strand_query_cuda,
                                    "ribbon_wide_launches"),
                strand_mixed_ribbon_wide=(strand_mixed_query_cuda,
                                          "ribbon_wide_launches"),
                packet_near=(packet_query_cuda, "ordered_launches"),
                packet_mixed_near=(packet_query_cuda,
                                   "mixed_ordered_launches"))


def reset_launches() -> None:
    """Every launch count, and the binned queries' round counts, to 0."""
    from raytpu_torch.kernels.binned import QUERY_STATS

    for fn, attr in _counters().values():
        setattr(fn, attr, 0)
    QUERY_STATS.update(queries=0, rounds=0, max_rounds=0)


def read_launches() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}



def rounds_note() -> str:
    """The binned queries' round counts since the last reset."""
    from raytpu_torch.kernels.binned import QUERY_STATS

    q = QUERY_STATS
    per = q["rounds"] / q["queries"] if q["queries"] else 0.0
    return (f"{q['queries']} binned queries, {per:.2f} rounds per query "
            f"(max {q['max_rounds']})")


@contextlib.contextmanager
def env(**values):
    """Set environment variables for the block, restore them after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: bytes over its memory rate or
    operations over its f32 rate, whichever is larger, and which it is
    (with both counts and both times)."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                n_bytes=n_bytes, n_ops=n_ops, bytes_ms=bytes_ms,
                ops_ms=ops_ms)


def walk_bound(counts: dict, n_rays: int, ray_bytes: int) -> dict:
    """A walk's bound from a plain walk's ``counts`` on its rays: the
    distinct table bytes read, ``ray_bytes`` in and 8 out (t, tri) per
    ray; the box and triangle tests."""
    return dict(bound(counts["bytes"] + n_rays * (ray_bytes + 8),
                      counts["boxes"] * SLAB_OPS
                      + counts.get("tris", 0) * TRI_OPS),
                boxes=counts["boxes"], tris=counts.get("tris", 0))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def t_err(a, b) -> float:
    """Largest |a - b| over lanes whose t differ (equal infinities are 0)."""
    import torch

    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def same_bits(a, b) -> bool:
    import torch

    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def same_walk(a, b, skip: int = 0) -> bool:
    """Two strand walks' outputs agree bit for bit: t, tri and, where both
    carry them, the int32 [8] counters from [skip] on."""
    import torch

    return (same_bits(a[0], b[0]) and torch.equal(a[1], b[1])
            and all(torch.equal(x[skip:], y[skip:])
                    for x, y in zip(a[2:], b[2:])))


def brute_mismatches(t_k, tri_k, t_b, tri_b, order) -> int:
    """Lanes where the kernel and the brute sweep disagree on hit/miss,
    on the original triangle, or on t. Slots are compared through
    ``order``: spatial splits may store one triangle in several slots with
    identical data, and the sweep sees all of them."""
    import torch

    hit = tri_k >= 0
    orig_k = order[torch.clamp(tri_k, min=0).long()]
    orig_b = order[torch.clamp(tri_b, min=0).long()]
    bad = (hit != (tri_b >= 0)) | (hit & ((orig_k != orig_b) | (t_k != t_b)))
    return int(bad.sum())


def sample_of(n: int, seed: int):
    """A seeded sample of min(n, SAMPLE) ray indices on the card, sorted."""
    import torch

    idx = np.random.default_rng(seed).choice(n, size=min(n, SAMPLE),
                                             replace=False)
    return torch.from_numpy(np.sort(idx)).to("cuda")


BRUTE_ELEMS = 1 << 25  # rays x slots of one brute-sweep chunk, at most


def brute_chunk(n_slots: int, n_rays: int) -> int:
    """The brute sweep's chunk for ``n_rays`` rays: the larger of
    gcd(n_slots, 4096) and the largest divisor of ``n_slots`` whose chunk
    holds at most BRUTE_ELEMS ray-slot pairs. A few rays sweep millions of
    slots in a few chunks; the result does not depend on the chunk (the
    lowest slot wins a tie either way)."""
    cap = max(1, BRUTE_ELEMS // max(n_rays, 1))
    best = 1
    for d in range(1, math.isqrt(n_slots) + 1):
        if n_slots % d == 0:
            best = max([best] + [x for x in (d, n_slots // d) if x <= cap])
    return max(best, math.gcd(n_slots, 4096))


def brute_closest(pack, ro, rd, tmax, tmin, idx):
    """The brute sweep's closest hit (a ``Hit``) for the rays ``idx``."""
    from raytpu_torch.kernels.intersect import intersect_bruteforce

    return intersect_bruteforce(
        ro[idx], rd[idx], pack.tri_p0, pack.tri_e1, pack.tri_e2, tmin,
        tmax[idx], chunk=brute_chunk(pack.n_triangles, idx.numel()))


def same_as_brute(pack, t, tri, brute):
    """Per ray: is a walk's closest hit (t, tri) the brute sweep's? The
    same when t is equal and the triangles' rows are (spatial splits store
    one triangle in several slots with identical rows)."""
    import torch

    same_row = (pack.tri_row[tri.clamp(min=0).long(), :9]
                == pack.tri_row[brute.tri.clamp(min=0).long(), :9]).all(1)
    return ((tri >= 0) == brute.valid) & (
        ~brute.valid | (same_row & (t.view(torch.int32)
                                    == brute.t.view(torch.int32))))


def brute_agrees(pack, t, tri, ro, rd, tmax, tmin, any_hit, idx):
    """Per ray of ``idx``: does the walk's result (t, tri; any-hit: the
    blocked bit) equal the brute sweep's over the pack's slots?"""
    from raytpu_torch.kernels.intersect import intersect_any_bruteforce

    if any_hit:
        brute = intersect_any_bruteforce(
            ro[idx], rd[idx], pack.tri_p0, pack.tri_e1, pack.tri_e2, tmin,
            tmax[idx], chunk=brute_chunk(pack.n_triangles, idx.numel()))
        return (tri[idx] >= 0) == brute
    return same_as_brute(pack, t[idx], tri[idx],
                         brute_closest(pack, ro, rd, tmax, tmin, idx))


def differing(pack, hit_a, hit_b):
    """Indices of the rays where two closest-hit results (t, tri) differ:
    hit or miss, t bits, or the triangle's rows."""
    import torch

    (ta, tra), (tb, trb) = hit_a, hit_b
    va, vb = tra >= 0, trb >= 0
    diff = (va != vb) | (va & (
        (ta.view(torch.int32) != tb.view(torch.int32))
        | (pack.tri_row[tra.clamp(min=0).long(), :9]
           != pack.tri_row[trb.clamp(min=0).long(), :9]).any(1)))
    return diff.nonzero().squeeze(1)


def differ_vs_brute(pack, hit_a, hit_b, ro, rd, tmax, tmin) -> tuple:
    """Two walks' closest hits (t, tri) on the same rays: the rays where
    they differ (hit or miss, t bits, the triangle's rows), each held to the
    brute sweep: (rays that differ, a wrong there, b wrong there)."""
    idx = differing(pack, hit_a, hit_b)
    if idx.numel() == 0:
        return 0, 0, 0
    wrong = [int((~brute_agrees(pack, t, tri, ro, rd, tmax, tmin, False,
                                idx)).sum()) for t, tri in (hit_a, hit_b)]
    return idx.numel(), wrong[0], wrong[1]


@contextlib.contextmanager
def unrepaired_box_test():
    """raytpu's plain slab test, ``near <= far``, in the plain packet,
    treelet and strand walks and the binned select for the block
    (FAR_SCALE 1: a multiply by 1 is exact). With identity tie keys
    (``arange``) in place of ``first_slots`` a walk also keeps the raw-slot
    tie rule: the walks as they were before ROADMAP faults 3.4 (the strand
    walks) and 3.5 (the others) were repaired."""
    from raytpu_torch.kernels import binned, packet, strand

    mods = (packet, binned, strand)
    saved = [m.FAR_SCALE for m in mods]
    for m in mods:
        m.FAR_SCALE = 1.0
    try:
        yield
    finally:
        for m, v in zip(mods, saved):
            m.FAR_SCALE = v


def f32_hex(x) -> str:
    return " ".join(f"{int(v):08x}" for v in
                    np.asarray(x, np.float32).reshape(-1).view(np.uint32))


LOST_SHOWN = 16  # lost rays of one wave printed with their bits


def lost_hits(label: str, pack, ro, rd, right, run, tmax=None,
              tmin: float = 0.001, fault: str = "3.5") -> dict:
    """ROADMAP fault 3.5 (or ``fault``: 3.4 for the strand walks) on a
    closest-hit wave: the rays the unrepaired rules lose, and why.
    ``run(idx, first, repaired_box)`` is the plain walk
    (or query) on rays ``idx`` with tie keys ``first``; ``right`` the
    repaired kernel's (t, tri) on the whole wave; ``tmax`` the rays' bounds
    (F32_MAX when None). The unrepaired walk (identity keys, unrepaired box
    test) runs on every ray; where it differs from ``right`` the brute
    sweep decides. Each lost ray is classed by the repair that alone
    recovers it: ``slab`` (the box test), ``tie`` (the key), ``either``, or
    ``both`` (neither alone). Prints the counts and the first LOST_SHOWN
    lost rays' bits, with their winner's and their wrong triangle's; fails
    if the repaired kernel is wrong on any ray where the two differ.
    Returns {rays, lost, differ, wrong, <class>: count}."""
    import torch

    n = ro.shape[0]
    ident = torch.arange(pack.n_triangles, dtype=torch.int32, device="cuda")
    first = pack.bvh.first_slots
    if tmax is None:
        tmax = torch.full((n,), F32_MAX, device="cuda")
    t0 = time.perf_counter()
    old = run(torch.arange(n, device="cuda"), ident, False)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx = differing(pack, old, right)
    brute = brute_closest(pack, ro, rd, tmax, tmin, idx)
    ok_old = same_as_brute(pack, old[0][idx], old[1][idx], brute)
    right_wrong = int((~same_as_brute(pack, right[0][idx], right[1][idx],
                                      brute)).sum())
    lost = idx[~ok_old]
    classes = dict(slab=0, tie=0, either=0, both=0)
    if lost.numel():
        lost_brute = type(brute)(*(x[~ok_old] for x in brute))
        rows = pack.tri_row[:, :9].cpu().numpy()
        by_box, by_key = (same_as_brute(pack, *run(lost, keys, box),
                                        lost_brute).tolist()
                          for keys, box in ((ident, True), (first, False)))
        for i, j in enumerate(lost.tolist()):
            cls = ("either" if by_box[i] and by_key[i] else "slab"
                   if by_box[i] else "tie" if by_key[i] else "both")
            classes[cls] += 1
            if i >= LOST_SHOWN:
                continue
            win, got = int(lost_brute.tri[i]), int(old[1][j])
            print(f"  {label} lost ray {j} ({cls}): ro {f32_hex(ro[j].cpu())}; "
                  f"rd {f32_hex(rd[j].cpu())}; brute slot {win} t "
                  f"{f32_hex(lost_brute.t[i:i + 1].cpu())} tri "
                  f"{f32_hex(rows[win])}; unrepaired slot {got} t "
                  f"{f32_hex(old[0][j:j + 1].cpu())} "
                  + (f"tri {f32_hex(rows[got])}" if got >= 0 else "(miss)"))
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    by_class = ", ".join(f"{v} {k}" for k, v in classes.items())
    shown = ("" if lost.numel() <= LOST_SHOWN
             else f" (the first {LOST_SHOWN} printed)")
    print(f"phase {label} fault {fault}: the unrepaired rules lose "
          f"{lost.numel()} of {n} rays ({by_class}){shown}; "
          f"the repaired kernel is wrong on {right_wrong} of the "
          f"{idx.numel()} rays where the two differ (unrepaired plain run "
          f"{run_s:.1f} s, brute checks {check_s:.1f} s)")
    if right_wrong:
        fail(f"phase {label}: the repaired kernel disagrees with the brute "
             f"sweep on {right_wrong} rays (ROADMAP fault {fault})")
    return dict(rays=n, lost=lost.numel(), differ=idx.numel(),
                wrong=right_wrong, **classes)


def bounce_lost_hits(label: str, pack, calls: list) -> dict:
    """Fault 3.5 (``lost_hits``) on every live closest-hit lane of every
    recorded binned mixed query (``recorded_mixed``), as one wave: the
    unrepaired run is the binned query on those lanes with binned_walk's
    plain version, the unrepaired box test and identity keys (per-lane
    results do not depend on the other lanes of a query). Fails as
    ``lost_hits`` does; returns its counts."""
    import torch

    from raytpu_torch.kernels import binned as binned_mod
    from raytpu_torch.kernels.binned import binned_walk_torch, make_binned_query

    if {(c[4], c[5]) for c in calls} != {(0.001, 0.0)}:
        fail(f"phase {label}: a bounce query with another tmin")
    lanes = [((smask == 0.0) & (tmax > 0.0)).nonzero().squeeze(1)
             for _, _, tmax, smask, *_ in calls]
    ro, rd, tmax, t, tri = (torch.cat([c[k][i] for c, i in zip(calls, lanes)])
                            for k in (0, 1, 2, 6, 7))

    def run(idx, keys, box):
        keyed = dataclasses.replace(pack, bvh=dataclasses.replace(
            pack.bvh, first_slots=keys))
        kernel = binned_mod.binned_walk
        binned_mod.binned_walk = binned_walk_torch
        try:
            with (contextlib.nullcontext() if box
                  else unrepaired_box_test()):
                return make_binned_query(keyed)(
                    ro[idx], rd[idx], tmax[idx],
                    torch.zeros(idx.numel(), device="cuda"), tmin=0.001,
                    shadow_tmin=0.0)
        finally:
            binned_mod.binned_walk = kernel

    sizes = ", ".join(str(i.numel()) for i in lanes)
    return lost_hits(f"{label} bounce waves ({len(calls)} binned mixed "
                     f"queries, closest-hit lanes {sizes})", pack, ro, rd,
                     (t, tri), run, tmax=tmax)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_times(calls: list) -> list:
    """Device ms of each call in ``calls``, in order
    (``raytpu_torch/tools/timing.py:queued_events``: all are queued behind
    a sleep kernel, so CUDA events between them time the launches alone,
    not the host time between small launches). Fails if the host took
    longer to queue them than the card slept."""
    from raytpu_torch.tools.timing import queued_events

    try:
        return queued_events(calls)
    except RuntimeError as e:
        fail(str(e))


def profile_frame(render, top: int = 6) -> str:
    """One call of ``render`` under torch.profiler: wall ms, device busy
    ms (the union of the device's kernel and copy intervals) and its
    share, the number of device events, and the ``top`` torch ops with
    the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    busy /= 1e3
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)[:top]
    top = ", ".join(f"{e.key[6:]} {e.self_device_time_total / 1e3:.2f}"
                    for e in ops)
    return (f"wall {wall:.1f} ms, device busy {busy:.2f} ms "
            f"({busy / wall:.1%}), {len(spans)} device events; most device "
            f"ms: {top}")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"phase 1 device: ok — {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0])


def start_sass_check():
    """Start tools/sass_diff on this checkout's sources against the stored
    digests (``raytpu_torch/tools/sass_digests.json``: every instance it
    names, each source it names rebuilt), in a process group of its own
    beside the build."""
    from raytpu_torch.tools.sass_diff import DIGESTS

    return subprocess.Popen(
        [sys.executable, "-m", "raytpu_torch.tools.sass_diff", "--digests",
         DIGESTS], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)


def phase_sass(proc) -> None:
    """Phase 2b: the sass_diff run's report; fails, naming the held
    instances, if one's instructions changed (a digest file from another
    nvcc is reported as not comparable)."""
    from raytpu_torch.tools.sass_diff import DIGESTS

    with open(DIGESTS) as f:
        held = [instance_name(k) for src in json.load(f)["sources"].values()
                for k in src]
    out, _ = proc.communicate(timeout=900)
    print(f"phase 2b machine code of the {len(held)} held instances "
          f"({', '.join(held)}), against the stored digests "
          f"(tools/sass_diff, rc {proc.returncode}): "
          + " | ".join(out.strip().splitlines()))
    if proc.returncode not in (0, 2):
        fail(f"phase 2b: a held instance of {held} no longer compiles to "
             "the stored instructions (see the differ list above)")


def phase_build():
    """Build every kernel, one nvcc per source, all started together."""
    from raytpu_torch.kernels import _build

    def build(name):
        t0 = time.perf_counter()
        _build.load_library(name)
        return name, time.perf_counter() - t0

    # one library per source: a kernel's mixed form lives in its source
    names = sorted({os.path.splitext(os.path.basename(k["source"]))[0]
                    for k in KERNELS.values()})
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(build, names))
    notes = []
    for name, secs in built:
        # ptxas -v: each kernel's registers, spills and shared memory
        notes.append(f"{name}.cu in {secs:.2f} s: " + " | ".join(
            f"{k} {r['registers']} registers, {r['spill_stores']} B spill "
            f"stores, {r['spill_loads']} B spill loads, {r['smem']} B smem"
            for k, r in _build.kernel_resources(name).items()))
    print(f"phase 2 build: ok — {len(built)} sources in "
          f"{time.perf_counter() - t0:.2f} s; " + "; ".join(notes))


def phase_kernel(errs: list, which: str, label: str) -> None:
    """One kernel vs its plain version on CUDA tensors (closest t bits and
    tri, any-hit blocked bit) on 3 soups x 65536 rays with dead lanes,
    zero direction components, finite-tmax closest-hit and shadow lanes;
    vs the brute sweep on 4096 rays of each and on the tie scene. Any
    mismatch fails the phase."""
    import torch

    from raytpu_torch.kernels.intersect import (
        intersect_any_bruteforce,
        intersect_bruteforce,
    )

    tables_of, kernel, plain = kernel_fns(which)
    name = KERNELS[which]["name"]
    dev = "cuda"
    total_bad = 0
    notes = []
    for ntri in (5, 300, 3000):
        bvh, bvh8, per, order = slot_rows(*soup(ntri))
        g = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for k, a in (
            ("leaf", per.reshape(-1, 80)), ("order", order))}
        tables = tables_of(bvh, bvh8.node_rows, g["leaf"])
        ro_np, rd_np = soup_rays(65536, seed=ntri)
        ro = torch.from_numpy(ro_np).to(dev)
        rd = torch.from_numpy(rd_np).to(dev)
        tmax_c, tmax_s = phase3_lanes()
        args = (*tables, ro, rd)
        tk, trk = kernel(*args, tmax_c, 0.001, False)
        tp, trp = plain(*args, tmax_c, 0.001, False)
        torch.cuda.synchronize()
        if not (same_bits(tk, tp) and torch.equal(trk, trp)):
            fail(f"{name} {ntri} tris closest: kernel != plain on "
                 f"{int((tk != tp).sum())} t, {int((trk != trp).sum())} tri")
        dead = tmax_c < 0
        if not (bool((trk[dead] == -1).all())
                and bool((tk[dead] == float("-inf")).all())):
            fail(f"{name} {ntri} tris: a dead lane returned a hit")
        _, ark = kernel(*args, tmax_s, 0.0, True)
        _, arp = plain(*args, tmax_s, 0.0, True)
        torch.cuda.synchronize()
        if not torch.equal(ark >= 0, arp >= 0):
            fail(f"{name} {ntri} tris any-hit: blocked differs on "
                 f"{int(((ark >= 0) != (arp >= 0)).sum())} rays")
        errs.append(t_err(tk, tp))
        n = 4096
        tri_p0 = g["leaf"].reshape(-1, 10)
        hb = intersect_bruteforce(ro[:n], rd[:n], tri_p0[:, 0:3],
                                  tri_p0[:, 3:6], tri_p0[:, 6:9], 0.001,
                                  tmax_c[:n], chunk=8)
        bad = brute_mismatches(tk[:n], trk[:n], hb.t, hb.tri, g["order"])
        bb = intersect_any_bruteforce(ro[:n], rd[:n], tri_p0[:, 0:3],
                                      tri_p0[:, 3:6], tri_p0[:, 6:9], 0.0,
                                      tmax_s[:n], chunk=8)
        bad_any = int(((ark[:n] >= 0) != bb).sum())
        total_bad += bad + bad_any
        notes.append(f"{ntri} tris: {int((trk >= 0).sum())} hits, "
                     f"{int((ark >= 0).sum())} blocked, vs brute "
                     f"{bad} closest / {bad_any} any-hit mismatches")
    # ties: 12 identical triangles over two leaves; the lowest slot wins
    bvh, bvh8, per, order, ro_np, rd_np = tie_scene()
    leaf, ro, rd, tmax = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in (per.reshape(-1, 80), ro_np, rd_np,
                                    np.full(ro_np.shape[0], F32_MAX,
                                            np.float32)))
    tables = tables_of(bvh, bvh8.node_rows, leaf)
    _, tie_k = kernel(*tables, ro, rd, tmax, 0.001, False)
    rows = leaf.reshape(-1, 10)
    hb = intersect_bruteforce(ro, rd, rows[:, 0:3], rows[:, 3:6],
                              rows[:, 6:9], 0.001, tmax, chunk=8)
    tie_bad = tie_mismatches(tables[-1], tie_k, hb.tri)
    total_bad += tie_bad
    notes.append(f"tie scene: {tie_bad} tie-key mismatches")
    print(f"phase {label} {name} vs plain: bit-equal on 3 soups x 65536 "
          "rays (closest t/tri, any-hit blocked); " + "; ".join(notes))
    if total_bad:
        fail(f"{name}: {total_bad} kernel-vs-brute mismatches")


def mixed_fns(which: str):
    """(kernel, plain version, device dispatcher) of a walk's mixed form,
    each called as ``fn(*tables, ro, rd, tmax, smask, tmin,
    shadow_tmin)``."""
    if which == "strand":
        from raytpu_torch.kernels.strand import (
            strand_mixed_query,
            strand_mixed_query_cuda,
            strand_mixed_query_torch,
        )

        return (strand_mixed_query_cuda, strand_mixed_query_torch,
                strand_mixed_query)
    from raytpu_torch.kernels.packet import (
        packet_query,
        packet_query_cuda,
        packet_query_torch,
    )

    def kernel(*args):
        *head, smask, tmin, shadow_tmin = args
        return packet_query_cuda(*head, tmin, False, smask, shadow_tmin)

    def plain(*args, counts=None):
        *head, smask, tmin, shadow_tmin = args
        return packet_query_torch(*head, tmin, False, counts, smask=smask,
                                  shadow_tmin=shadow_tmin)

    def dispatch(*args):
        *head, smask, tmin, shadow_tmin = args
        return packet_query(*head, tmin, False, smask, shadow_tmin)

    return kernel, plain, dispatch


def mixed_vs_separate(kernel, tables, ro, rd, tmax, smask, t_m, tri_m,
                      tmin=0.001, shadow_tmin=0.0) -> int:
    """Lanes where a mixed launch's result (t_m, tri_m) differs from the
    separate closest-hit launch (t bits, tri) and any-hit launch (the
    blocked bit) of the same walk."""
    import torch

    shad = smask == 1.0
    neg = torch.full_like(tmax, float("-inf"))
    t_c, tri_c = kernel(*tables, ro, rd, torch.where(shad, neg, tmax), tmin,
                        False)
    _, tri_a = kernel(*tables, ro, rd, torch.where(shad, tmax, neg),
                      shadow_tmin, True)
    bad_c = ~shad & ((tri_m != tri_c) | (t_m.view(torch.int32)
                                         != t_c.view(torch.int32)))
    bad_a = shad & ((tri_m >= 0) != (tri_a >= 0))
    return int((bad_c | bad_a).sum())


def mixed_lanes(n: int, dev: str):
    """Bounds and shadow flags of a mixed launch over n rays: every other
    lane a shadow lane (bound 6), the rest closest (F32_MAX, every tenth
    5.0, an open bound), every seventh lane dead (both kinds)."""
    import torch

    smask = torch.zeros(n, device=dev)
    smask[1::2] = 1.0
    tmax = torch.full((n,), F32_MAX, device=dev)
    tmax[::10] = 5.0
    tmax = torch.where(smask == 1.0, torch.full_like(tmax, 6.0), tmax)
    tmax[::7] = float("-inf")
    return tmax, smask


def phase_mixed_kernel(errs: list, which: str, label: str) -> int:
    """Phase 3e (strand) / 3f (packet): the walk's mixed form on phase 3's
    3 soups x 65536 rays, half of them shadow lanes, dead lanes of both
    kinds: the kernel against its plain version (closest lanes t bits and
    tri, shadow lanes the blocked bit) and against the walk's separate
    closest-hit and any-hit launches, lane for lane. For the packet walk
    also raytpu's capped two-round check (tests/test_intersect.py): a
    round capped at 6 and a second round over [6, tmax) from tmin =
    shadow_tmin = 6 give the one-round answer. No engine path calls the
    packet walk's mixed form, as in raytpu: its launches are those of the
    queries through ``packet_query`` (the one round and the two capped
    rounds on each soup), counted from 0."""
    import torch

    tables_of, sep_kernel, _ = kernel_fns(which)
    kernel, plain, dispatch = mixed_fns(which)
    name = KERNELS[which + "_mixed"]["name"]
    dev = "cuda"
    notes, launches = [], 0
    for ntri in (5, 300, 3000):
        bvh, bvh8, per, order = slot_rows(*soup(ntri))
        leaf = torch.from_numpy(per.reshape(-1, 80).copy()).to(dev)
        tables = tables_of(bvh, bvh8.node_rows, leaf)
        ro_np, rd_np = soup_rays(65536, seed=ntri)
        ro = torch.from_numpy(ro_np).to(dev)
        rd = torch.from_numpy(rd_np).to(dev)
        tmax, smask = mixed_lanes(65536, dev)
        shad = smask == 1.0
        if which == "packet":
            cap = 6.0
            reset_launches()
            t_m, tri_m = dispatch(*tables, ro, rd, tmax, smask, 0.001,
                                         0.0)
            t1, tri1 = dispatch(*tables, ro, rd,
                                       torch.clamp(tmax, max=cap), smask,
                                       0.001, 0.0)
            unresolved = (tri1 < 0) & (tmax > cap)
            t2, tri2 = dispatch(
                *tables, ro, rd,
                torch.where(unresolved, tmax, float("-inf")), smask, cap,
                cap)
            torch.cuda.synchronize()
            launches += read_launches()["packet_mixed"]
            # two walks may return different copies of one triangle: the
            # closest lanes are compared on the tie key
            first = tables[-1]

            def key(tri):
                return torch.where(tri >= 0, first[tri.clamp(min=0).long()],
                                   -1)

            tri12 = torch.where(tri1 >= 0, tri1, tri2)
            t12 = torch.where(tri1 >= 0, t1, t2)
            hit = ~shad & (tri_m >= 0)
            two_bad = int((~shad & (key(tri12) != key(tri_m))).sum()
                          + (hit & (t12.view(torch.int32)
                                    != t_m.view(torch.int32))).sum()
                          + (shad & ((tri12 >= 0) != (tri_m >= 0))).sum())
            if two_bad:
                fail(f"{name} {ntri} tris: the capped two rounds differ "
                     f"from one round on {two_bad} lanes")
        else:
            t_m, tri_m = kernel(*tables, ro, rd, tmax, smask, 0.001, 0.0)
        t_p, tri_p = plain(*tables, ro, rd, tmax, smask, 0.001, 0.0)
        torch.cuda.synchronize()
        bad = int((~shad & ((tri_m != tri_p) | (t_m.view(torch.int32)
                                               != t_p.view(torch.int32)))
                   | (shad & ((tri_m >= 0) != (tri_p >= 0)))).sum())
        if bad:
            fail(f"{name} {ntri} tris: kernel != plain on {bad} lanes")
        dead = tmax < 0
        if not bool((tri_m[dead] == -1).all()):
            fail(f"{name} {ntri} tris: a dead lane returned a hit")
        sep = mixed_vs_separate(sep_kernel, tables, ro, rd, tmax, smask, t_m,
                                tri_m)
        if sep:
            fail(f"{name} {ntri} tris: the mixed launch differs from the "
                 f"separate closest and any-hit launches on {sep} lanes")
        errs.append(t_err(t_m[~shad], t_p[~shad]))
        notes.append(f"{ntri} tris: {int((~shad & (tri_m >= 0)).sum())} "
                     f"closest hits, {int((shad & (tri_m >= 0)).sum())} "
                     "shadow lanes blocked")
    extra = (f"; capped two rounds == one round on every lane; "
             f"{launches} launches through packet_query"
             if which == "packet" else "")
    print(f"phase {label} {name} vs plain: bit-equal on 3 soups x 65536 "
          "lanes (half shadow lanes; closest t/tri, shadow blocked), equal "
          "to the separate closest-hit and any-hit launches lane for lane; "
          + "; ".join(notes) + extra)
    return launches


def to_card(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to("cuda")


def phase3_lanes(n: int = 65536):
    """Phase 3's closest-hit bounds (every tenth 5.0, an open bound; every
    seventh lane dead) and shadow bounds (6.0; every fifth lane dead)."""
    import torch

    tmax_c = torch.full((n,), F32_MAX, device="cuda")
    tmax_c[3::10] = 5.0
    tmax_c[::7] = float("-inf")
    tmax_s = torch.full((n,), 6.0, device="cuda")
    tmax_s[::5] = float("-inf")
    return tmax_c, tmax_s


def tie_key(first, tri):
    import torch

    return torch.where(tri >= 0, first[tri.clamp(min=0).long()], -1)


def phase_ribbon_kernel(errs: dict) -> None:
    """Phase 3g: strand_walk over ribbon rows (rpo = rows per octant) on
    phase 3's 3 soups x 65536 rays, closest-hit, any-hit and mixed, one
    record a step (ribbon_k 1) and with the K-wide fetch (ribbon_k 4 and
    8), each instance without and with stats: bit for bit (t and tri of
    every lane, and with stats=True the int32 [8] counters) against its
    plain version and against the strand layout's launch (the K-wide
    fetch: t, tri and every counter but [0], which counts its windows);
    then stats_sweep at STATS_RAYS."""
    import torch

    from raytpu_torch.accel.strandtree import (
        build_ribbon_tree,
        build_strand_tree,
    )
    from raytpu_torch.kernels.strand import (
        first_slots,
        strand_mixed_query_cuda,
        strand_mixed_query_torch,
        strand_query_cuda,
        strand_query_torch,
    )

    notes = []
    for ntri in (5, 300, 3000):
        bvh, _, per, _ = slot_rows(*soup(ntri))
        leaf = to_card(per.reshape(-1, 80))
        first = first_slots(leaf)
        rib = build_ribbon_tree(bvh)
        rib_rows = to_card(rib.rows)
        strand_rows = to_card(build_strand_tree(bvh).rows)
        rpo = rib.rows_per_oct
        ro, rd = (to_card(a) for a in soup_rays(65536, seed=ntri))
        tmax_c, tmax_s = phase3_lanes()
        tmax_m, smask = mixed_lanes(65536, "cuda")
        forms = (("closest", strand_query_cuda, strand_query_torch,
                  (tmax_c, 0.001, False)),
                 ("any-hit", strand_query_cuda, strand_query_torch,
                  (tmax_s, 0.0, True)),
                 ("mixed", strand_mixed_query_cuda, strand_mixed_query_torch,
                  (tmax_m, smask, 0.001, 0.0)))
        stats = []
        for form, kernel, plain, tail in forms:
            head = (leaf, first, ro, rd, *tail)
            mixed = "mixed_" if form == "mixed" else ""
            for st in (False, True):
                k0 = kernel(strand_rows, *head, stats=st)
                p0 = plain(strand_rows, *head, stats=st)
                out = {k: (kernel(rib_rows, *head, rpo=rpo, ribbon_k=k,
                                  stats=st),
                           plain(rib_rows, *head, rpo=rpo, ribbon_k=k,
                                 stats=st)) for k in (1, 4, 8)}
                torch.cuda.synchronize()
                checks = [("strand kernel vs plain", k0, p0, 0)]
                for k, (k1, p1) in out.items():
                    # the K-wide fetch's stats[0] counts its windows
                    checks += [(f"ribbon K={k} kernel vs plain", k1, p1, 0),
                               (f"ribbon K={k} vs strand kernel", k1, k0,
                                0 if k == 1 else 1)]
                for what, a, b, skip in checks:
                    if not same_walk(a, b, skip):
                        fail(f"phase 3g {ntri} tris {form} stats={st}: "
                             f"{what} differ on {int((a[1] != b[1]).sum())} "
                             f"tri, stats {[x.tolist() for x in a[2:]]} vs "
                             f"{[x.tolist() for x in b[2:]]}")
                errs[f"strand_{mixed}ribbon"].append(t_err(out[1][0][0],
                                                           out[1][1][0]))
                for k in (4, 8):
                    errs[f"strand_{mixed}ribbon_wide"].append(
                        t_err(out[k][0][0], out[k][1][0]))
            stats.append(f"{form} {out[1][0][2].tolist()}, fetches K=4 "
                         f"{int(out[4][0][2][0])}, K=8 {int(out[8][0][2][0])}")
        notes.append(f"{ntri} tris (rpo {rib.rows_per_oct}): "
                     + ", ".join(stats))
    ragged = stats_sweep(strand_rows, rib_rows, rpo, leaf, first)
    print("phase 3g strand_walk over ribbon rows, one record a step and the "
          "K-wide fetch (K 4, 8), each without and with stats: bit-equal (t, "
          "tri, stats) to its plain version and to the strand layout's "
          "launch (the K-wide fetch's stats[0] apart: its windows) on 3 "
          "soups x 65536 rays, closest, any-hit and mixed; stats [loads, 0, "
          "0, installs, leaf tests, leaf rows reached, 0, 0]: "
          + "; ".join(notes) + f"; at {STATS_RAYS} rays (3000 tris, strand "
          "rows and ribbon K 1, 2, 4, 5, 8, closest, any-hit, mixed, each "
          "without and with stats), each bit-equal (t, tri, stats) to its "
          f"plain version: {ragged}")


# phase 3g's ray counts for the stats instances: a partial warp, a warp
# and one lane, a partial block (65,435 = 511 blocks of 4 warps and 27
# lanes), and a 1080p-sized wave with a partial warp
STATS_RAYS = (1, 31, 33, 65536 - 101, 2**20 + 7)


def stats_sweep(strand_rows, rib_rows, rpo, leaf, first) -> str:
    """Every walk_kernel instance of the strand walks (strand rows; ribbon
    rows at K 1 and with the K-wide fetch at K 2, 4, 5, 8; closest-hit,
    any-hit, mixed), without and with stats, against its plain version at
    each of STATS_RAYS rays: t, tri and the int32 [8] counters, which each
    block of 4 warps sums before one atomic a counter (the plain walk's t
    and tri do not depend on ``stats``: one plain run serves both).
    Returns the closest-hit strand counters per ray count."""
    import torch

    from raytpu_torch.kernels.strand import (
        strand_mixed_query_cuda,
        strand_mixed_query_torch,
        strand_query_cuda,
        strand_query_torch,
    )

    notes = []
    for n in STATS_RAYS:
        ro, rd = (to_card(a) for a in soup_rays(n, seed=n))
        tmax, smask = mixed_lanes(n, "cuda")
        for form, kernel, plain, tail in (
                ("closest", strand_query_cuda, strand_query_torch,
                 (tmax, 0.001, False)),
                ("any-hit", strand_query_cuda, strand_query_torch,
                 (tmax, 0.0, True)),
                ("mixed", strand_mixed_query_cuda, strand_mixed_query_torch,
                 (tmax, smask, 0.001, 0.0))):
            args = (leaf, first, ro, rd, *tail)
            for rows, kw in ((strand_rows, {}),
                             *((rib_rows, dict(rpo=rpo, ribbon_k=k))
                               for k in (1, 2, 4, 5, 8))):
                want = plain(rows, *args, stats=True, **kw)
                for st in (False, True):
                    got = kernel(rows, *args, stats=st, **kw)
                    torch.cuda.synchronize()
                    if not same_walk(got, want):
                        fail(f"phase 3g {n} rays {form} "
                             f"{kw or 'strand rows'} stats={st}: t, tri or "
                             f"stats differ from the plain version's "
                             f"({[x.tolist() for x in got[2:]]} vs "
                             f"{want[2].tolist()})")
                if form == "closest" and not kw:
                    notes.append(f"{n}: {got[2].tolist()}")
    return ", ".join(notes)


# phase 3h's sweep of packet_walk's counters over block and packet
# boundaries: ray counts under a warp, over one, three blocks and a part,
# and a packet of 4096 and a part; packets of one block and of three
PACKET_SWEEP_RAYS = (1, 31, 33, 434, 4096 + 33)
PACKET_SWEEP_SIZES = (128, 384)


def packet_registers() -> str:
    """packet_walk's instances' registers, spills and static shared memory
    from ptxas's report, by instance_name."""
    from raytpu_torch.kernels import _build

    return ", ".join(
        f"{instance_name(k)} {r['registers']} ({r['spill_stores']} B spill, "
        f"{r['smem']} B smem)" for k, r in sorted(
            _build.kernel_resources("packet_walk").items(),
            key=lambda kv: instance_name(kv[0])))


def packet_stats_sweep(rows8, leaf, first) -> int:
    """Every packet_walk instance (closest-hit, any-hit and mixed, each
    order, with and without stats) bit for bit (t, tri, stats) against its
    plain version with stats at PACKET_SWEEP_RAYS x PACKET_SWEEP_SIZES, the
    rays of the second packet of 128 all dead where there is one; returns
    the launches made."""
    import torch

    from raytpu_torch.kernels.packet import (
        packet_query_cuda,
        packet_query_torch,
    )

    n_launches = 0
    for n in PACKET_SWEEP_RAYS:
        ro, rd = (to_card(a) for a in soup_rays(n, seed=n))
        tmax, smask = mixed_lanes(n, "cuda")
        tmax[128:256] = float("-inf")
        for form, tail, kw in (
                ("closest", (tmax, 0.001, False), {}),
                ("any-hit", (tmax, 0.0, True), {}),
                ("mixed", (tmax, 0.001, False),
                 dict(smask=smask, shadow_tmin=0.0))):
            args = (rows8, leaf, first, ro, rd, *tail)
            for packet in PACKET_SWEEP_SIZES:
                for ordered in (False, True):
                    want = packet_query_torch(*args, **kw, ordered=ordered,
                                              with_stats=True, packet=packet)
                    for st in (False, True):
                        got = packet_query_cuda(*args, **kw, ordered=ordered,
                                                with_stats=st, packet=packet)
                        n_launches += 1
                        torch.cuda.synchronize()
                        if not (same_bits(got[0], want[0])
                                and torch.equal(got[1], want[1])
                                and (not st or torch.equal(got[2],
                                                           want[2]))):
                            fail(f"phase 3h sweep {n} rays {form} packet "
                                 f"{packet} ordered={ordered} stats={st}: "
                                 "t, tri or stats differ from the plain "
                                 "version's")
                    if (packet == 128 and n > 256
                            and int(want[2][1].abs().sum()) != 0):
                        fail(f"phase 3h sweep {n} rays: the all-dead "
                             "packet counts")
    return n_launches


def phase_near_kernel(errs: dict) -> int:
    """Phase 3h: packet_walk's near-first instances (ordered=True) and its
    storage-order ones on phase 3's 3 soups x 65536 rays, closest-hit,
    any-hit and mixed, each without and with stats (default packet, and
    384 rays a packet, which does not divide R): bit for bit (t, tri, and
    with stats every stats lane) against their plain versions (the
    ``kernels`` line's error is the near-first instances' without stats),
    and near-first against storage order on
    t bits and the tie key (closest lanes) and the blocked bit (shadow
    lanes). The mixed near-first queries go through ``packet_query``, as
    3f's do: their launches, counted from 0, are the kernel form's. Then
    every instance over block and packet boundaries
    (``packet_stats_sweep``, on the 3,000-triangle soup), and the
    instances' registers."""
    import torch

    from raytpu_torch.kernels.packet import (
        packet_query,
        packet_query_cuda,
        packet_query_torch,
    )
    from raytpu_torch.kernels.strand import first_slots

    notes, launches = [], 0
    for ntri in (5, 300, 3000):
        _, bvh8, per, _ = slot_rows(*soup(ntri))
        leaf = to_card(per.reshape(-1, 80))
        first = first_slots(leaf)
        rows8 = to_card(bvh8.node_rows)
        ro, rd = (to_card(a) for a in soup_rays(65536, seed=ntri))
        tmax_c, tmax_s = phase3_lanes()
        tmax_m, smask = mixed_lanes(65536, "cuda")
        shad = smask == 1.0
        pops = {}
        for form, tail, kw in (
                ("closest", (tmax_c, 0.001, False), {}),
                ("closest/384", (tmax_c, 0.001, False), dict(packet=384)),
                ("any-hit", (tmax_s, 0.0, True), {}),
                ("mixed", (tmax_m, 0.001, False),
                 dict(smask=smask, shadow_tmin=0.0))):
            args = (rows8, leaf, first, ro, rd, *tail)
            out = {}
            for ordered in (False, True):
                ks = {}
                for st in (False, True):
                    if form == "mixed" and ordered:
                        reset_launches()
                        ks[st] = packet_query(*args, ordered=True,
                                              with_stats=st, **kw)
                        torch.cuda.synchronize()
                        launches += read_launches()["packet_mixed_near"]
                    else:
                        ks[st] = packet_query_cuda(*args, ordered=ordered,
                                                   with_stats=st, **kw)
                out[ordered] = (ks, packet_query_torch(
                    *args, ordered=ordered, with_stats=True, **kw))
            torch.cuda.synchronize()
            for ordered, (ks, p) in out.items():
                for st, k in ks.items():
                    if not (same_bits(k[0], p[0]) and torch.equal(k[1], p[1])
                            and (not st or torch.equal(k[2], p[2]))):
                        fail(f"phase 3h {ntri} tris {form} ordered={ordered} "
                             f"stats={st}: kernel != plain on "
                             f"{int((k[1] != p[1]).sum())} tri"
                             + (f", {int((k[2] != p[2]).sum())} stats lanes"
                                if st else ""))
            near, store = out[True][0][True], out[False][0][True]
            if form == "any-hit":
                bad = int(((near[1] >= 0) != (store[1] >= 0)).sum())
            else:
                closest = ~shad if form == "mixed" else torch.ones_like(shad)
                bad = int((closest & (
                    (near[0].view(torch.int32) != store[0].view(torch.int32))
                    | (tie_key(first, near[1]) != tie_key(first, store[1])))
                ).sum() + (~closest & ((near[1] >= 0)
                                       != (store[1] >= 0))).sum())
            if bad:
                fail(f"phase 3h {ntri} tris {form}: near-first differs from "
                     f"storage order on {bad} lanes")
            key = "packet_mixed_near" if form == "mixed" else "packet_near"
            errs[key].append(t_err(out[True][0][False][0], out[True][1][0]))
            pops[form] = (int(store[2][:, 0].sum()), int(near[2][:, 0].sum()))
        notes.append(f"{ntri} tris: node pops storage/near-first " + ", ".join(
            f"{f} {a}/{b}" for f, (a, b) in pops.items()))
    swept = packet_stats_sweep(rows8, leaf, first)
    print("phase 3h packet_walk: both orders, each without and with stats, "
          "bit-equal (t, tri, stats) to their plain versions, near-first "
          "equal to storage order on t bits and the tie key (closest lanes) "
          "and the blocked "
          "bit, on 3 soups x 65536 rays, closest, any-hit and mixed; "
          f"{launches} mixed near-first launches through packet_query; "
          + "; ".join(notes)
          + f"; every instance bit-equal to its plain version over "
          f"{PACKET_SWEEP_RAYS} rays x packets {PACKET_SWEEP_SIZES} "
          f"({swept} launches; an all-dead packet counts 0); registers: "
          + packet_registers())
    return launches


def sched_rows(kw: dict, rows: dict) -> tuple:
    """(rows, keywords) of a schedule set: a set with ``ribbon_k`` walks
    the ribbon rows (``rows``' nonzero rpo) with that rpo."""
    if "ribbon_k" not in kw:
        return rows[0], kw
    rpo = max(rows)
    return rows[rpo], dict(kw, rpo=rpo)


def form_key(kind: str, kw: dict) -> str:
    """The KERNELS key of a schedule set's form (``sched_rows``' keywords):
    kind is "strand" or "strand_mixed"."""
    from raytpu_torch.kernels.strand import TOP_NODES, _schedule, sched_form

    sched = _schedule(kw.get("rpo", 0), TOP_NODES,
                      **{k: v for k, v in kw.items()
                         if k not in ("ribbon_k", "rpo")})
    return f"{kind}_{sched_form(sched)}"


def agree(form: str, a, b, first, smask=None) -> int:
    """Lanes where two walks of one scene disagree on the contract: closest
    lanes on t bits and the tie key, any-hit lanes on the blocked bit."""
    import torch

    if form == "any-hit":
        return int(((a[1] >= 0) != (b[1] >= 0)).sum())
    closest = (smask != 1.0) if smask is not None else torch.ones_like(
        a[1], dtype=torch.bool)
    return int((closest & ((a[0].view(torch.int32) != b[0].view(torch.int32))
                           | (tie_key(first, a[1]) != tie_key(first, b[1])))
                ).sum() + (~closest & ((a[1] >= 0) != (b[1] >= 0))).sum())


def phase_sched_kernel(errs: dict) -> dict:
    """Phase 3i: strand_walk's schedule form on phase 3's 3 soups x 65536
    rays, closest-hit, any-hit and mixed, at each of SCHED_SETS (every
    fetch form: load, pipe, dual, smem, K-wide ribbon), and strand_block's
    deferral form, closest-hit and any-hit, at each of DEFER_SETS: each bit
    for bit (t, tri, every counter) against its plain version, and against
    the default instance on t bits and the tie key (closest lanes) and the
    blocked bit. The launches go through ``strand_query``,
    ``strand_mixed_query`` and ``strand_block_query``; their counts, from 0,
    are returned (the fetch_smem forms' main-path count: no factory passes
    raytpu's fetch_smem)."""
    import torch

    from raytpu_torch.accel.strandtree import (
        build_ribbon_tree,
        build_strand_tree,
    )
    from raytpu_torch.kernels import strand as S

    notes = []
    reset_launches()
    for ntri in (5, 300, 3000):
        bvh, _, per, _ = slot_rows(*soup(ntri))
        leaf = to_card(per.reshape(-1, 80))
        first = S.first_slots(leaf)
        rib = build_ribbon_tree(bvh)
        rows = {0: to_card(build_strand_tree(bvh).rows),
                rib.rows_per_oct: to_card(rib.rows)}
        ro, rd = (to_card(a) for a in soup_rays(65536, seed=ntri))
        tmax_c, tmax_s = phase3_lanes()
        tmax_m, smask = mixed_lanes(65536, "cuda")
        modes = (("closest", S.strand_query, S.strand_query_torch,
                  (tmax_c, 0.001, False)),
                 ("any-hit", S.strand_query, S.strand_query_torch,
                  (tmax_s, 0.0, True)),
                 ("mixed", S.strand_mixed_query, S.strand_mixed_query_torch,
                  (tmax_m, smask, 0.001, 0.0)))
        rounds = []
        for form, kernel, plain, tail in modes:
            base = kernel(rows[0], leaf, first, ro, rd, *tail)
            for name, kw in SCHED_SETS.items():
                tree, kw = sched_rows(kw, rows)
                args = (tree, leaf, first, ro, rd, *tail)
                k = kernel(*args, stats=True, **kw)
                p = plain(*args, stats=True, **kw)
                torch.cuda.synchronize()
                if not (same_bits(k[0], p[0]) and torch.equal(k[1], p[1])
                        and torch.equal(k[2], p[2])):
                    fail(f"phase 3i {ntri} tris {form} {name}: kernel != "
                         f"plain on {int((k[1] != p[1]).sum())} tri, stats "
                         f"{k[2].tolist()} vs {p[2].tolist()}")
                bad = agree(form, k, base, first,
                            smask if form == "mixed" else None)
                if bad:
                    fail(f"phase 3i {ntri} tris {form} {name}: differs from "
                         f"the default instance on {bad} lanes")
                key = form_key("strand_mixed" if form == "mixed"
                               else "strand", kw)
                errs[key].append(t_err(k[0], p[0]))
                if form == "closest":
                    rounds.append(f"{name} {k[2].tolist()}")
        for form, tail in (("closest", (tmax_c, 0.001, False)),
                           ("any-hit", (tmax_s, 0.0, True))):
            args = (rows[0], leaf, first, ro, rd, *tail)
            base = S.strand_block_query(*args)
            for name, kw in DEFER_SETS.items():
                k = S.strand_block_query(*args, True, **kw)
                p = S.strand_block_query_torch(*args, True, **kw)
                torch.cuda.synchronize()
                if not (same_bits(k[0], p[0]) and torch.equal(k[1], p[1])
                        and torch.equal(k[2], p[2])):
                    fail(f"phase 3i {ntri} tris block {form} {name}: kernel "
                         f"!= plain on {int((k[1] != p[1]).sum())} tri, "
                         f"{int((k[2] != p[2]).any(1).sum())} stats rows")
                bad = agree(form, k, base, first)
                if bad:
                    fail(f"phase 3i {ntri} tris block {form} {name}: "
                         f"differs from the default instance on {bad} lanes")
                errs["block_defer"].append(t_err(k[0], p[0]))
                if form == "closest":
                    mean = float(k[2][:, 2].double().mean())
                    rounds.append(f"block {name}: leaf rounds per block "
                                  f"mean {mean:.1f}")
        notes.append(f"{ntri} tris: " + "; ".join(rounds))
    launches = read_launches()
    print("phase 3i schedule forms: bit-equal (t, tri, every counter) to "
          "their plain versions and equal to the default instances on t "
          "bits and the tie key (closest lanes) and the blocked bit, on 3 "
          "soups x 65536 rays, closest, any-hit and mixed, sets "
          f"{list(SCHED_SETS)}, block {list(DEFER_SETS)}; closest counters "
          "[loads, leaf rounds, claims, installs, leaf tests, enqueues, 0, "
          "0]: " + " | ".join(notes) + "; launches through the dispatchers: "
          + ", ".join(f"{k} {launches[k]}" for k in KERNELS
                      if k.startswith(("strand_load", "strand_pipe",
                                       "strand_dual", "strand_smem",
                                       "strand_wide", "strand_mixed_",
                                       "block_defer"))
                      and launches[k]))
    return launches


def phase_sched_sweep(errs: dict) -> None:
    """Phase 3i's sweep: on the 3000-triangle soup with SWEEP_RAYS rays,
    every set of SWEEP_SETS (closest-hit, any-hit and mixed) and of
    DEFER_SWEEP (closest-hit and any-hit) through its kernel and its plain
    version, bit for bit (t, tri, every counter), and against the default
    instance on t bits and the tie key (closest lanes) and the blocked bit;
    the pool sizes must also give one another's results and counters."""
    import torch

    from raytpu_torch.accel.strandtree import (
        build_ribbon_tree,
        build_strand_tree,
    )
    from raytpu_torch.kernels import strand as S

    n = SWEEP_RAYS
    bvh, _, per, _ = slot_rows(*soup(3000))
    leaf = to_card(per.reshape(-1, 80))
    first = S.first_slots(leaf)
    rib = build_ribbon_tree(bvh)
    rows = {0: to_card(build_strand_tree(bvh).rows),
            rib.rows_per_oct: to_card(rib.rows)}
    ro, rd = (to_card(a[:n]) for a in soup_rays(65536, seed=3000))
    tmax_c, tmax_s = (x[:n].contiguous() for x in phase3_lanes())
    tmax_m, smask = (x[:n].contiguous() for x in mixed_lanes(65536, "cuda"))
    modes = (("closest", S.strand_query_cuda, S.strand_query_torch,
              (tmax_c, 0.001, False)),
             ("any-hit", S.strand_query_cuda, S.strand_query_torch,
              (tmax_s, 0.0, True)),
             ("mixed", S.strand_mixed_query_cuda, S.strand_mixed_query_torch,
              (tmax_m, smask, 0.001, 0.0)))
    pools = {}
    for form, kernel, plain, tail in modes:
        base = kernel(rows[0], leaf, first, ro, rd, *tail)
        for name, kw in SWEEP_SETS.items():
            tree, kw = sched_rows(kw, rows)
            args = (tree, leaf, first, ro, rd, *tail)
            k = kernel(*args, stats=True, **kw)
            p = plain(*args, stats=True, **kw)
            torch.cuda.synchronize()
            if not (same_bits(k[0], p[0]) and torch.equal(k[1], p[1])
                    and torch.equal(k[2], p[2])):
                fail(f"phase 3i sweep {form} {name}: kernel != plain on "
                     f"{int((k[1] != p[1]).sum())} tri, stats "
                     f"{k[2].tolist()} vs {p[2].tolist()}")
            bad = agree(form, k, base, first,
                        smask if form == "mixed" else None)
            if bad:
                fail(f"phase 3i sweep {form} {name}: differs from the "
                     f"default instance on {bad} lanes")
            if name.startswith("pipe walkers="):
                got = pools.setdefault((form, kw["service_k"]), k)
                if not (same_bits(got[0], k[0]) and torch.equal(got[1], k[1])
                        and torch.equal(got[2], k[2])):
                    fail(f"phase 3i sweep {form} {name}: the pool size "
                         "changed a result or a counter")
            key = form_key("strand_mixed" if form == "mixed" else "strand",
                           kw)
            errs[key].append(t_err(k[0], p[0]))
    for form, tail in (("closest", (tmax_c, 0.001, False)),
                       ("any-hit", (tmax_s, 0.0, True))):
        args = (rows[0], leaf, first, ro, rd, *tail)
        base = S.strand_block_query_cuda(*args)
        for name, kw in DEFER_SWEEP.items():
            k = S.strand_block_query_cuda(*args, True, **kw)
            p = S.strand_block_query_torch(*args, True, **kw)
            torch.cuda.synchronize()
            if not (same_bits(k[0], p[0]) and torch.equal(k[1], p[1])
                    and torch.equal(k[2], p[2])):
                fail(f"phase 3i sweep block {form} {name}: kernel != plain "
                     f"on {int((k[1] != p[1]).sum())} tri, "
                     f"{int((k[2] != p[2]).any(1).sum())} stats rows")
            bad = agree(form, k, base, first)
            if bad:
                fail(f"phase 3i sweep block {form} {name}: differs from "
                     f"the default instance on {bad} lanes")
            errs["block_defer"].append(t_err(k[0], p[0]))
    print(f"phase 3i sweep ({n} rays, 3000 tris): closest, any-hit and "
          f"mixed at {list(SWEEP_SETS)}, and the block walk's deferral "
          f"closest and any-hit at {list(DEFER_SWEEP)}: each bit-equal (t, "
          "tri, every counter) to its plain version and equal to the "
          "default instance; the pool sizes 1, 128 and 4096 give equal "
          "results and counters")


def tie_mismatches(first, tri, brute_tri) -> int:
    """Rays of the tie scene whose triangle is not the sweep's: the sweep
    keeps the lowest slot of 12 copies, which is every copy's tie key."""
    return int((tie_key(first, tri) != brute_tri).sum())


def treelet_soup(ntri: int, budget: int):
    """A soup cut into treelets at ``budget`` rows: (treelet arrays,
    slot-ordered triangle rows [S, 10], slot -> triangle) as numpy."""
    from raytpu_torch.accel.treelets import build_treelets

    _, bvh8, per, order = slot_rows(*soup(ntri))
    return build_treelets(bvh8, per.reshape(-1, 80), budget_rows=budget), \
        per, order


def tl_pack(tl, per, dev):
    """The treelet tables and the tie keys of the slot rows ``per`` as the
    attributes make_binned_query reads."""
    import torch

    from raytpu_torch.kernels.strand import first_slots

    attrs = {k: torch.from_numpy(np.ascontiguousarray(getattr(tl, a))).to(
        dev) for k, a in (("tl_nodes", "tnodes"), ("tl_leaves", "tleaves"),
                          ("tl_bmin", "tbox_min"), ("tl_bmax", "tbox_max"))}
    attrs["bvh"] = type("Bvh", (), dict(first_slots=first_slots(
        torch.from_numpy(per).to(dev))))
    return type("TreeletPack", (), attrs)


def phase_binned_kernel(errs: list) -> None:
    """Phase 3c: binned_walk vs its plain version on CUDA tensors (t bits
    and tri) on 3 soups x 65536 rays, treelets at budgets 48 and 2048, each
    ray on a random treelet, with closest, shadow and dead lanes and
    random incoming best t and slots; then the whole binned query on the
    card against the brute sweep on 4096 rays of each soup (closest t and
    triangle, shadow blocked) and on the tie scene."""
    import torch

    from raytpu_torch.accel.treelets import build_treelets
    from raytpu_torch.kernels.binned import (
        binned_walk_cuda,
        binned_walk_torch,
        make_binned_query,
    )
    from raytpu_torch.kernels.intersect import (
        intersect_any_bruteforce,
        intersect_bruteforce,
    )
    from raytpu_torch.kernels.strand import first_slots

    dev = "cuda"
    n = 65536
    total_bad = 0
    notes = []
    reset_launches()
    for ntri in (300, 3000, 30000):
        for budget in (48, 2048):
            tl, per, order = treelet_soup(ntri, budget)
            rng = np.random.default_rng(ntri + budget)
            ro_np, rd_np = soup_rays(n, seed=ntri)
            shadow = rng.random(n) < 0.4
            tmax = np.where(shadow, rng.uniform(1, 12, n), F32_MAX)
            incoming = ~shadow & (rng.random(n) < 0.3)
            tmax[incoming] = rng.uniform(1, 12, int(incoming.sum()))
            tmax[::7] = -np.inf
            tri0 = np.where(incoming, rng.integers(0, per.shape[0], n), -1)
            tid = rng.integers(0, tl.n_treelets, n)
            args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (tl.tnodes, tl.tleaves, tid.astype(np.int32),
                              ro_np, rd_np, tmax.astype(np.float32),
                              shadow.astype(np.float32),
                              tri0.astype(np.int32))]
            args.insert(2, first_slots(torch.from_numpy(per).to(dev)))
            tk, trk = binned_walk_cuda(*args, 0.001, 0.0)
            tp, trp = binned_walk_torch(*args, 0.001, 0.0)
            torch.cuda.synchronize()
            if not (same_bits(tk, tp) and torch.equal(trk, trp)):
                fail(f"binned_walk {ntri} tris budget {budget}: kernel != "
                     f"plain on {int((tk != tp).sum())} t, "
                     f"{int((trk != trp).sum())} tri")
            errs.append(t_err(tk, tp))
            notes.append(f"{ntri} tris budget {budget}: {tl.n_treelets} "
                         f"treelets, {int((trk >= 0).sum())} hits/blocked")
        # the whole query on the card (treelets at budget 48) vs the sweep
        tl, per, order = treelet_soup(ntri, 48)
        ro = torch.from_numpy(ro_np[:4096]).to(dev)
        rd = torch.from_numpy(rd_np[:4096]).to(dev)
        smask = torch.zeros(4096, device=dev)
        smask[1::2] = 1.0
        tmax = torch.where(smask == 1.0, 6.0, F32_MAX)
        tmax[3::10] = 5.0  # finite closest-hit bound (open)
        tmax[::7] = float("-inf")
        t, tri = make_binned_query(tl_pack(tl, per, dev))(
            ro, rd, tmax, smask, tmin=0.001, shadow_tmin=0.0)
        rows = torch.from_numpy(per).to(dev)
        c = smask == 0.0
        hb = intersect_bruteforce(ro[c], rd[c], rows[:, 0:3], rows[:, 3:6],
                                  rows[:, 6:9], 0.001, tmax[c], chunk=8)
        bad = brute_mismatches(t[c], tri[c], hb.t, hb.tri,
                               torch.from_numpy(order).to(dev))
        bb = intersect_any_bruteforce(ro[~c], rd[~c], rows[:, 0:3],
                                      rows[:, 3:6], rows[:, 6:9], 0.0,
                                      tmax[~c], chunk=8)
        bad_any = int(((tri[~c] >= 0) != bb).sum())
        total_bad += bad + bad_any
        notes.append(f"query vs brute: {bad} closest / {bad_any} shadow "
                     "mismatches")
    # ties: 12 identical triangles over two leaves; the lowest slot wins
    _, bvh8, per, order, ro_np, rd_np = tie_scene()
    tl = build_treelets(bvh8, per.reshape(-1, 80))
    ro, rd, rows = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (ro_np, rd_np, per))
    tmax = torch.full((ro_np.shape[0],), F32_MAX, device=dev)
    tie_pack = tl_pack(tl, per, dev)
    _, tie_k = make_binned_query(tie_pack)(
        ro, rd, tmax, torch.zeros_like(tmax), tmin=0.001, shadow_tmin=0.0)
    hb = intersect_bruteforce(ro, rd, rows[:, 0:3], rows[:, 3:6],
                              rows[:, 6:9], 0.001, tmax, chunk=8)
    tie_bad = tie_mismatches(tie_pack.bvh.first_slots, tie_k, hb.tri)
    total_bad += tie_bad
    notes.append(f"tie scene: {tie_bad} tie-key mismatches")
    torch.cuda.synchronize()
    print(f"phase 3c binned_walk vs plain: bit-equal on 3 soups x 65536 "
          f"rays x budgets 48/2048 (t/tri, mixed closest/shadow/dead lanes); "
          + "; ".join(notes) + f"; {rounds_note()}, "
          f"{read_launches()['binned']} binned_walk launches")
    if total_bad:
        fail(f"binned query: {total_bad} mismatches against the brute sweep")


def strand_soup(ntri: int, dev: str):
    """A soup's strand tree, leaf rows, tie keys and slot -> triangle on
    ``dev``."""
    import torch

    from raytpu_torch.accel.strandtree import build_strand_tree
    from raytpu_torch.kernels.strand import first_slots

    bvh, _, per, order = slot_rows(*soup(ntri))
    tree, leaf, order = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for a in (build_strand_tree(bvh).rows,
                                   per.reshape(-1, 80), order))
    return tree, leaf, first_slots(leaf), order


def same_triangles(tri_a, tri_b, order) -> bool:
    """Hit/miss equal, and the same original triangle on every hit."""
    import torch

    hit = tri_a >= 0
    return bool(torch.equal(hit, tri_b >= 0)) and bool(torch.equal(
        order[tri_a.clamp(min=0).long()][hit],
        order[tri_b.clamp(min=0).long()][hit]))


def phase_block_kernel(errs: list) -> None:
    """Phase 3d: strand_block vs its plain version on CUDA tensors on 3
    soups (300 / 3,000 / 30,000 triangles) x 65,535 octant-sorted rays (not
    a multiple of 32; every 7th lane dead; finite-tmax closest lanes),
    closest and any-hit: t bits, tri and the per-strand counters equal.
    Against strand_walk on the same rays: closest t bits equal, the same
    original triangle, the same blocked bit. Against the brute sweep on
    4096 rays of each soup and on the tie scene: no mismatch."""
    import torch

    from raytpu_torch.kernels.intersect import (
        intersect_any_bruteforce,
        intersect_bruteforce,
    )
    from raytpu_torch.kernels.strand import (
        first_slots,
        strand_block_query_cuda,
        strand_block_query_torch,
        strand_query_cuda,
    )

    dev = "cuda"
    n = 65535
    total_bad = 0
    notes = []
    for ntri in (300, 3000, 30000):
        tree, leaf, first, order = strand_soup(ntri, dev)
        ro_np, rd_np = soup_rays(65536, seed=ntri)
        ro = torch.from_numpy(ro_np[:n]).to(dev)
        rd = torch.from_numpy(rd_np[:n]).to(dev)
        tmax_c = torch.full((n,), F32_MAX, device=dev)
        tmax_c[3::10] = 5.0  # finite closest-hit bound (open)
        tmax_c[::7] = float("-inf")  # dead lanes
        tmax_s = torch.full((n,), 6.0, device=dev)  # shadow rays
        tmax_s[::7] = float("-inf")
        args = (tree, leaf, first, ro, rd)
        tk, trk, sk = strand_block_query_cuda(*args, tmax_c, 0.001, False,
                                              True)
        tp, trp, sp = strand_block_query_torch(*args, tmax_c, 0.001, False,
                                               True)
        torch.cuda.synchronize()
        if not (same_bits(tk, tp) and torch.equal(trk, trp)
                and torch.equal(sk, sp)):
            fail(f"strand_block {ntri} tris closest: kernel != plain on "
                 f"{int((tk != tp).sum())} t, {int((trk != trp).sum())} tri, "
                 f"{int((sk != sp).any(1).sum())} strands' counters")
        dead = tmax_c < 0
        if not (bool((trk[dead] == -1).all())
                and bool((tk[dead] == float("-inf")).all())):
            fail(f"strand_block {ntri} tris: a dead lane returned a hit")
        _, ak, sak = strand_block_query_cuda(*args, tmax_s, 0.0, True, True)
        _, ap, sap = strand_block_query_torch(*args, tmax_s, 0.0, True, True)
        torch.cuda.synchronize()
        if not (torch.equal(ak, ap) and torch.equal(sak, sap)):
            fail(f"strand_block {ntri} tris any-hit: kernel != plain on "
                 f"{int((ak != ap).sum())} tri, "
                 f"{int((sak != sap).any(1).sum())} strands' counters")
        errs.append(t_err(tk, tp))
        # the per-ray walk on the same rays
        tw, trw = strand_query_cuda(*args, tmax_c, 0.001, False)
        _, aw = strand_query_cuda(*args, tmax_s, 0.0, True)
        torch.cuda.synchronize()
        walk_bad = int((tk.view(torch.int32) != tw.view(torch.int32)).sum())
        if not same_triangles(trk, trw, order):
            walk_bad += 1
        walk_bad += int(((ak >= 0) != (aw >= 0)).sum())
        # the brute sweep on the first 4096 rays
        m = 4096
        rows = leaf.reshape(-1, 10)
        hb = intersect_bruteforce(ro[:m], rd[:m], rows[:, 0:3], rows[:, 3:6],
                                  rows[:, 6:9], 0.001, tmax_c[:m], chunk=8)
        bad = brute_mismatches(tk[:m], trk[:m], hb.t, hb.tri, order)
        bb = intersect_any_bruteforce(ro[:m], rd[:m], rows[:, 0:3],
                                      rows[:, 3:6], rows[:, 6:9], 0.0,
                                      tmax_s[:m], chunk=8)
        bad_any = int(((ak[:m] >= 0) != bb).sum())
        total_bad += bad + bad_any + walk_bad
        steps, leaves = sk[:, 0].double(), sk[:, 1].double()
        notes.append(
            f"{ntri} tris: {int((trk >= 0).sum())} hits, "
            f"{int((ak >= 0).sum())} blocked; steps per strand mean "
            f"{float(steps.mean()):.1f} max {int(steps.max())}, leaf visits "
            f"mean {float(leaves.mean()):.1f} max {int(leaves.max())}; vs "
            f"strand_walk {walk_bad} mismatches; vs brute {bad} closest / "
            f"{bad_any} any-hit mismatches")
    # ties: 12 identical triangles over two leaves; the lowest slot wins
    from raytpu_torch.accel.strandtree import build_strand_tree

    bvh, _, per, _, ro_np, rd_np = tie_scene()
    cu = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        build_strand_tree(bvh).rows, per.reshape(-1, 80), ro_np, rd_np,
        np.full(ro_np.shape[0], F32_MAX, np.float32))]
    cu.insert(2, first_slots(cu[1]))
    _, tie_k = strand_block_query_cuda(*cu, 0.001, False)
    rows = cu[1].reshape(-1, 10)
    hb = intersect_bruteforce(cu[3], cu[4], rows[:, 0:3], rows[:, 3:6],
                              rows[:, 6:9], 0.001, cu[5], chunk=8)
    tie_bad = tie_mismatches(cu[2], tie_k, hb.tri)
    total_bad += tie_bad
    notes.append(f"tie scene: {tie_bad} tie-key mismatches")
    print(f"phase 3d strand_block vs plain: bit-equal on 3 soups x {n} rays "
          "(closest t/tri, any-hit tri, per-strand counters); "
          + "; ".join(notes))
    if total_bad:
        fail(f"strand_block: {total_bad} mismatches against strand_walk or "
             "the brute sweep")


def _writer():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tests.tools.glb_writer import GlbBuilder, box, quad

    return GlbBuilder, box, quad


def grid_mesh(n: int, size: float):
    """XZ floor grid of 2*n*n triangles (tests/test_production_parity.py's
    _grid_mesh, vectorised)."""
    xs = np.linspace(-size / 2, size / 2, n + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, xs)
    pos = np.stack([gx, np.zeros_like(gx), gz], -1).reshape(-1, 3)
    nrm = np.tile(np.array([0, 1, 0], np.float32), (pos.shape[0], 1))
    u, v = np.meshgrid(np.linspace(0, 1, n + 1, dtype=np.float32),
                       np.linspace(0, 1, n + 1, dtype=np.float32))
    uv = np.stack([u, v], -1).reshape(-1, 2)
    j, i = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a = (j * (n + 1) + i).reshape(-1)
    b, c = a + 1, a + (n + 1)
    idx = np.stack([a, c, b, b, c, c + 1], -1).reshape(-1)
    return (pos.astype(np.float32), nrm, uv.astype(np.float32),
            idx.astype(np.uint32))


def write_gallery(path: str, cells: int):
    """The gallery layout of tests/test_production_parity.py, untextured:
    a floor grid, metal/glass/diffuse boxes, an emissive quad, two lights."""
    GlbBuilder, box, quad = _writer()
    b = GlbBuilder()
    floor_m = b.add_material(color=(0.8, 0.8, 0.8, 1))
    metal = b.add_material(color=(0.9, 0.8, 0.5, 1), metallic=1.0)
    glass = b.add_material(color=(0.85, 0.9, 1.0, 1), ior=1.5)
    diffuse = b.add_material(color=(0.7, 0.3, 0.3, 1))
    glow = b.add_material(color=(1.0, 0.7, 0.3, 1), emission=5.0)
    pos, nrm, uv, idx = grid_mesh(cells, 16.0)
    b.add_node(mesh=b.add_mesh([(pos, nrm, uv, idx, floor_m, np.uint32)]),
               translation=[0, -2, 0])
    bp, bn, bu, bi = box()
    for mat, at in ((metal, [-2.5, -1, 0]), (glass, [0, -1, 1.5]),
                    (diffuse, [2.5, -1, 0])):
        b.add_node(mesh=b.add_mesh([(bp, bn, bu, bi, mat, np.uint32)]),
                   translation=at)
    qp, qn, qu, qi = quad(size=2.0)
    b.add_node(mesh=b.add_mesh([(qp, qn, qu, qi, glow, np.uint16)]),
               translation=[0, 2.5, -2])
    b.add_node(light=b.add_light(intensity=40.0), translation=[4, 5, 6])
    b.add_node(light=b.add_light(color=(0.4, 0.6, 1.0), intensity=25.0),
               translation=[-5, 4, 3])
    b.write(path)


def phase_card_vs_cpu(tmp: str):
    """A <= 256-slot scene (the packet route) rendered on the card and on
    the CPU, in path and in flat mode: the PNG pixels must agree within
    tests/imgdiff.py's bar."""
    import torch

    from raytpu_torch.engine.render import render_frame
    from raytpu_torch.io.metrics import ssim
    from raytpu_torch.io.png import quantize_rgba32f
    from raytpu_torch.scene.camera import camera_from_lookat
    from raytpu_torch.scene.gltf import load_scene
    from raytpu_torch.scene.pack import pack_camera, pack_scene
    from raytpu_torch.types import RenderConfig

    path = os.path.join(tmp, "small.glb")
    write_gallery(path, cells=6)
    scene = load_scene(path)
    cam = camera_from_lookat([0, 2.5, -9], [0, -0.5, 0], 0.7, 64, 64)
    packs = {dev: (pack_scene(scene, dev), pack_camera(cam, dev))
             for dev in ("cuda", "cpu")}
    slots = packs["cpu"][0].n_triangles
    if slots > 256 or packs["cuda"][0].bvh.strand_rows is not None:
        fail(f"small scene has {slots} slots or a strand tree")
    notes = []
    for mode in ("path", "flat"):
        cfg = RenderConfig(width=64, height=64, seed=3, samples=2, bounces=4,
                           chunk_size=16, mode=mode)
        reset_launches()
        frames = {dev: render_frame(*packs[dev], cfg) for dev in packs}
        torch.cuda.synchronize()
        counts = read_launches()
        qa = quantize_rgba32f(frames["cuda"])
        qb = quantize_rgba32f(frames["cpu"])
        frac = float(np.any(qa != qb, axis=-1).mean())
        raw = float(np.any(frames["cuda"] != frames["cpu"], axis=-1).mean())
        s = ssim(qa, qb)
        lit = float((qa.max(-1) > 0).mean())
        notes.append(f"{mode}: {frac:.4f} of PNG pixels differ ({raw:.4f} of "
                     f"f32 pixels), SSIM {s:.5f}, {lit:.3f} non-black, "
                     f"{counts['packet']} packet_walk / {counts['strand']} "
                     "strand_walk launches")
        if frac > 0.02 or s < 0.99 or lit < 0.1:
            fail(f"card and CPU {mode} frames disagree")
        if counts["packet"] == 0 or counts["strand"] != 0:
            fail(f"the card's {mode} frame did not take the packet route")
    print(f"phase 4 card vs cpu: {slots} slots, 64x64 2spp 4 bounces; "
          + "; ".join(notes))


def png_pixels_differ(a, b) -> int:
    """PNG pixels that differ between two f32 frames (png_diff's first
    number, without its SSIM)."""
    from raytpu_torch.io.png import quantize_rgba32f

    return int(np.any(quantize_rgba32f(a) != quantize_rgba32f(b),
                      axis=-1).sum())


def png_diff(a, b) -> tuple:
    """(PNG pixels that differ, their share, SSIM) of two f32 frames as the
    PNGs the user gets (tests/imgdiff.py's bar: share <= 0.02, SSIM >=
    0.99)."""
    from raytpu_torch.io.metrics import ssim
    from raytpu_torch.io.png import quantize_rgba32f

    qa, qb = quantize_rgba32f(a), quantize_rgba32f(b)
    diff = np.any(qa != qb, axis=-1)
    return int(diff.sum()), float(diff.mean()), ssim(qa, qb)


def with_budget(pack, scene, budget: int):
    """The pack with its treelets rebuilt at ``budget`` rows."""
    import dataclasses

    import torch

    from raytpu_torch.accel.bvh import build_bvh
    from raytpu_torch.accel.treelets import build_treelets
    from raytpu_torch.scene.pack import flatten_world_triangles

    bvh8 = build_bvh(*flatten_world_triangles(scene)[:3])[1]
    tl = build_treelets(bvh8, pack.bvh.leaf_tris.cpu().numpy(),
                        budget_rows=budget)
    dev = pack.device
    return dataclasses.replace(pack, **{
        k: torch.from_numpy(a).to(dev) for k, a in (
            ("tl_nodes", tl.tnodes), ("tl_leaves", tl.tleaves),
            ("tl_bmin", tl.tbox_min), ("tl_bmax", tl.tbox_max))})


def phase_binned_card_vs_cpu(tmp: str):
    """Phase 4b: a ~5,000-triangle gallery packed tables="stream",
    rendered through intersector="binned" on the card and on the CPU at
    64x64, 2 spp, 4 bounces, with the default treelets and rebuilt at
    budget 64: the PNG pixels must agree within tests/imgdiff.py's bar,
    and the card's frame must run every query through binned_walk."""
    import torch

    from raytpu_torch.engine.render import render_frame
    from raytpu_torch.scene.camera import camera_from_lookat
    from raytpu_torch.scene.gltf import load_scene
    from raytpu_torch.scene.pack import pack_camera, pack_scene
    from raytpu_torch.types import RenderConfig

    path = os.path.join(tmp, "gallery5k.glb")
    write_gallery(path, cells=50)
    scene = load_scene(path)
    cam = camera_from_lookat([0, 2.5, -9], [0, -0.5, 0], 0.7, 64, 64)
    packs = {dev: (pack_scene(scene, dev, tables="stream"),
                   pack_camera(cam, dev)) for dev in ("cuda", "cpu")}
    base = packs["cuda"][0]
    if base.bvh.node8_rows is not None or base.tl_nodes is None:
        fail("the stream pack kept its BVH8 rows or has no treelets")
    cfg = RenderConfig(width=64, height=64, seed=3, samples=2, bounces=4,
                       chunk_size=16, intersector="binned")
    notes = []
    for label, budget in (("default treelets", None), ("budget 64", 64)):
        if budget is not None:
            packs = {dev: (with_budget(packs[dev][0], scene, budget),
                           packs[dev][1]) for dev in packs}
        reset_launches()
        t0 = time.perf_counter()
        card = render_frame(*packs["cuda"], cfg)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        counts = read_launches()
        rounds = rounds_note()
        t0 = time.perf_counter()
        cpu = render_frame(*packs["cpu"], cfg)
        cpu_s = time.perf_counter() - t0
        n_diff, frac, s = png_diff(card, cpu)
        raw = float(np.any(card != cpu, axis=-1).mean())
        lit = float((card.max(-1) > 0).mean())
        notes.append(
            f"{label} ({packs['cuda'][0].tl_nodes.shape[0]} treelets): "
            f"{n_diff} PNG pixels differ ({frac:.4f}; {raw:.4f} of f32 "
            f"pixels), SSIM {s:.5f}, {lit:.3f} non-black, card {card_s:.2f} "
            f"s / cpu {cpu_s:.2f} s, {counts['binned']} binned_walk / "
            f"{counts['strand']} strand_walk / {counts['packet']} packet_walk "
            f"launches, {rounds}")
        if frac > 0.02 or s < 0.99 or lit < 0.1:
            fail(f"card and CPU binned frames disagree ({label})")
        if counts["binned"] == 0 or counts["strand"] or counts["packet"]:
            fail(f"the card's binned frame did not run on binned_walk alone "
                 f"({label})")
    print(f"phase 4b binned card vs cpu: {base.n_triangles} slots, stream "
          "pack, 64x64 2spp 4 bounces; " + "; ".join(notes))


def read_png_rgb(path: str) -> np.ndarray:
    """Decode the 8-bit RGB, filter-0 PNG that io/png.py writes."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = int.from_bytes(body[0:4], "big"), int.from_bytes(
                body[4:8], "big")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        fail("unexpected PNG row filter")
    return raw[:, 1:].reshape(h, w, 3)


def primary_wave(cam, w: int, h: int, chunk: int, seed: int):
    """The frame's primary rays (sample 0) in 32x32-block order on the
    card, as render_tile casts them."""
    from raytpu_torch.engine.render import _pixel_layout, cast_rays
    from raytpu_torch.kernels import rng as rngk

    px, py, _ = _pixel_layout(w, h, True, "cuda")
    state = rngk.seed_pixels(px, py, w, chunk, seed)
    state, jx = rngk.rand(state)
    state, jy = rngk.rand(state)
    ro, rd = cast_rays(px.float() + jx, py.float() + jy, cam.world,
                       cam.projection, w, h)
    return ro.contiguous(), rd.contiguous()


def wave_check(which: str, tables, pack, ro, rd, errs: list):
    """A closest-hit wave through one kernel (CUDA events, 5 launches) and
    its plain version (1 run), ``tables`` being their arguments before the
    rays: (kernel ms, plain ms, mismatches against the brute sweep on a
    seeded SAMPLE of its rays, the bound from the plain walk's counts).
    Fails unless bit-equal."""
    import torch

    _, kernel, plain = kernel_fns(which)
    tmax = torch.full((ro.shape[0],), F32_MAX, device="cuda")
    ms = cuda_ms(lambda: kernel(*tables, ro, rd, tmax, 0.001, False),
                 reps=5)
    plain_ms = cuda_ms(lambda: plain(*tables, ro, rd, tmax, 0.001, False),
                       reps=1)
    tk, trk = kernel(*tables, ro, rd, tmax, 0.001, False)
    counts = {}
    tp, trp = plain(*tables, ro, rd, tmax, 0.001, False, counts=counts)
    if not (same_bits(tk, tp) and torch.equal(trk, trp)):
        fail(f"primary wave: {KERNELS[which]['name']} != its plain version")
    errs.append(t_err(tk, tp))
    ok = brute_agrees(pack, tk, trk, ro, rd, tmax, 0.001, False,
                      sample_of(ro.shape[0], seed=1))
    return ms, plain_ms, int((~ok).sum()), walk_bound(counts, ro.shape[0],
                                                      28)


def waves_vs_brute(pack, calls, query, seed: int | None) -> tuple:
    """Each recorded wave (the factory's arguments) through ``query`` on
    the card, held to the brute sweep on a seeded SAMPLE of its rays, or
    on every ray with no seed: (mismatches, rays checked, a note per
    wave)."""
    import torch

    bad = checked = 0
    notes = []
    for i, a in enumerate(calls):
        ro, rd, tmax, tmin, any_hit = a[3:8]
        t, tri = query(*a[:8])
        idx = (torch.arange(ro.shape[0], device="cuda") if seed is None
               else sample_of(ro.shape[0], seed + i))
        n_bad = int((~brute_agrees(pack, t, tri, ro, rd, tmax, tmin, any_hit,
                                   idx)).sum())
        bad += n_bad
        checked += idx.numel()
        notes.append(f"{'any' if any_hit else 'closest'} {n_bad}")
    return bad, checked, notes


def cli_argv(glb: str, png: str, args: dict, cam_json=None, mode="path"):
    argv = ["--scene", glb, "--output", png, "--mode", mode]
    if cam_json is not None:
        argv += ["--camera", cam_json]
    for k, v in args.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return argv


def run_cli(argv) -> tuple:
    """``raytpu_torch.cli.main(argv)`` with every launch count set to 0
    just before and read just after: (seconds, launch counts)."""
    import torch

    from raytpu_torch import cli

    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_launches()
    if rc != 0:
        fail(f"cli.main({' '.join(argv)}) returned {rc}")
    return secs, counts


def phase_main(tmp: str, errs: list) -> dict:
    """Phase 5: the strand route, path mode on the 259k-triangle gallery
    at 1920x1080: two frames in the default schedule (fused wave mode at
    this width), its work tier per bounce, two frames of the same pack
    with RAYTPU_WAVE_MODE=query (0 PNG pixels may differ), the primary
    wave through strand_walk and its plain version, then the CLI run."""
    import torch

    from raytpu_torch.engine.render import WAVE_STATS, render_frame
    from raytpu_torch.scene.camera import load_camera_json
    from raytpu_torch.scene.gltf import load_scene
    from raytpu_torch.scene.pack import pack_camera, pack_scene
    from raytpu_torch.types import RenderConfig

    glb = os.path.join(tmp, "gallery.glb")
    cam_json = os.path.join(tmp, "camera.json")
    png = os.path.join(tmp, "frame.png")
    write_gallery(glb, cells=360)
    with open(cam_json, "w") as f:
        json.dump(GALLERY_CAM, f)
    w, h = MAIN_ARGS["width"], MAIN_ARGS["height"]

    t0 = time.perf_counter()
    scene = load_scene(glb)
    with timed_treelets() as tl_s, \
            timed_treelets("build_ribbon_tree") as rib_s:
        pack = pack_scene(scene, "cuda")
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    n_tris = sum(int(scene.prim_index_count[p]) // 3
                 for p in range(len(scene.prim_index_count)))
    cam = pack_camera(load_camera_json(cam_json, w, h), "cuda")
    cfg = RenderConfig(**MAIN_ARGS)

    def frames():
        secs = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = render_frame(pack, cam, cfg)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return out, secs, dict(WAVE_STATS)

    frame, frame_s, waves = frames()
    with env(RAYTPU_WAVE_MODE="query"):
        frame_q, query_s, waves_q = frames()
    n_diff = png_pixels_differ(frame, frame_q)
    print(f"phase 5 wave modes: default '{waves['mode']}', work width per "
          f"bounce {waves['widths']}, frames {frame_s[0]:.3f} / "
          f"{frame_s[1]:.3f} s; '{waves_q['mode']}' widths "
          f"{waves_q['widths']}, frames {query_s[0]:.3f} / {query_s[1]:.3f} "
          f"s; {n_diff} PNG pixels differ ({int(np.any(frame != frame_q, -1).sum())} "
          "f32 pixels)")
    if waves["mode"] != "fused" or waves_q["mode"] != "query" or n_diff:
        fail("phase 5: the fused frame is not the query frame")
    print("phase 5 profile, fused: "
          + profile_frame(lambda: render_frame(pack, cam, cfg)))
    with env(RAYTPU_WAVE_MODE="query"):
        print("phase 5 profile, query: "
              + profile_frame(lambda: render_frame(pack, cam, cfg)))

    # the kernel and its plain version on the frame's primary wave
    ro, rd = primary_wave(cam, w, h, MAIN_ARGS["chunk_size"], 1)
    ms, plain_ms, bad, bnd = wave_check(
        "strand", (pack.bvh.strand_rows, pack.bvh.leaf_tris,
                   pack.bvh.first_slots), pack, ro, rd, errs)
    print(f"phase 5 main path: {n_tris} triangles ({pack.n_triangles} slots), "
          f"pack {pack_s:.2f} s (treelets {sum(tl_s):.2f} s, ribbon rows "
          f"{sum(rib_s):.2f} s of it), frame 1 "
          f"{frame_s[0]:.3f} s, frame 2 {frame_s[1]:.3f} s at {w}x{h} 1spp 4 "
          f"bounces; primary wave {ro.shape[0]} rays: strand_walk {ms:.3f} "
          f"ms, plain {plain_ms:.1f} ms, bit-equal; vs brute on {SAMPLE} "
          f"rays: {bad} mismatches")
    if bad:
        fail("primary wave: strand_walk disagrees with the brute sweep")
    # every wave of a frame: strand_walk vs the brute sweep on a sample
    from raytpu_torch.kernels.strand import strand_query_cuda

    with recorded_queries("strand_query") as calls:
        render_frame(pack, cam, cfg)
        torch.cuda.synchronize()
    bad, checked, notes = waves_vs_brute(pack, calls, strand_query_cuda, 10)
    print(f"phase 5 strand_walk vs brute on a {SAMPLE}-ray sample of each of "
          f"the frame's {len(calls)} waves ({checked} rays): mismatches per "
          f"wave {', '.join(notes)}")
    if bad:
        fail(f"phase 5: strand_walk disagrees with the brute sweep on {bad} "
             "sampled rays")

    argv = cli_argv(glb, png, MAIN_ARGS, cam_json)
    cli_s, counts = run_cli(argv)
    img = read_png_rgb(png)
    lit = float((img.max(-1) > 0).mean())
    print(f"phase 5 cli: raytpu_torch.cli.main({' '.join(argv)}) -> "
          f"rc 0 in {cli_s:.2f} s, {img.shape[1]}x{img.shape[0]} PNG, "
          f"{lit:.3f} non-black, {counts['strand']} strand_walk / "
          f"{counts['packet']} packet_walk launches")
    if img.shape != (h, w, 3) or lit <= 0.10:
        fail("main-path PNG is wrong or mostly black")
    if counts["strand"] == 0 or counts["packet"] or counts["block"]:
        fail("the path waves of a >256-slot scene did not all take strand_walk")
    if pack.bvh.ribbon_rows is None:
        fail("phase 5: the pack has no ribbon rows")
    return dict(launches=counts["strand"], ms=ms, plain_ms=plain_ms, **bnd,
                glb=glb, cam_json=cam_json, png=png, pack=pack, cam=cam,
                frame=frame, frame_s=frame_s, ro=ro, rd=rd)


class recorded_queries:
    """Context manager: the arguments of every call of the dispatcher
    ``name`` of the kernel module ``module`` (``strand``: ``strand_query``
    or ``strand_block_query``; ``packet``: ``packet_query``) that the
    intersector factories made inside it, as a list (a factory looks its
    dispatcher up when it is called). The rays are copied: the fused wave
    mode queries views of its path state, which it then updates in
    place."""

    def __init__(self, name: str, module: str = "strand"):
        self.name, self.module = name, module

    def __enter__(self):
        import importlib

        self.mod = importlib.import_module("raytpu_torch.kernels."
                                           + self.module)
        self.real = getattr(self.mod, self.name)
        self.calls = []

        def record(*args, **kwargs):
            self.calls.append(args[:3] + tuple(a.clone() for a in args[3:6])
                              + args[6:])
            return self.real(*args, **kwargs)

        setattr(self.mod, self.name, record)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


def phase_block_route(main_rec: dict, errs: list) -> dict:
    """Phase 5b: phase 5's CLI run with RAYTPU_STRAND_PERSISTENT=0 (set
    just before, restored just after): every strand query on strand_block.
    Each of the frame's waves again through strand_block, held to the
    brute sweep on a seeded SAMPLE of its rays, and through both walks:
    the rays where they differ (t bits, the triangle's rows, the blocked
    bit) must number STRAND_WALKS_DIFFER, each held to the brute sweep
    (strand_walk wrong on STRAND_WALK_LOST_HITS, strand_block on none), and
    the PNG must equal phase 5's. On the largest sorted closest-hit wave
    (the largest after the primary one): strand_block's ms beside
    strand_walk's, the plain version (bit-equal with its counters); steps
    and leaf visits per strand; the bound from the per-ray walk's work on
    that wave's live lanes. Returns the kernel's record and that wave."""
    import torch

    from raytpu_torch.kernels.strand import (
        strand_block_query_cuda,
        strand_block_query_torch,
        strand_query_cuda,
        strand_query_torch,
    )

    png = main_rec["png"].replace(".png", "_block.png")
    argv = cli_argv(main_rec["glb"], png, MAIN_ARGS, main_rec["cam_json"])
    with env(RAYTPU_STRAND_PERSISTENT="0"), \
            recorded_queries("strand_block_query") as calls:
        cli_s, counts = run_cli(argv)
    n_diff = int(np.any(read_png_rgb(png) != read_png_rgb(main_rec["png"]),
                        axis=-1).sum())
    sizes = [a[3].shape[0] for a in calls]
    print(f"phase 5b block route: raytpu_torch.cli.main with "
          f"RAYTPU_STRAND_PERSISTENT=0 -> rc 0 in {cli_s:.2f} s, "
          f"{counts['block']} strand_block / {counts['strand']} strand_walk "
          f"/ {counts['packet']} packet_walk launches, wave sizes {sizes}; "
          f"{n_diff} PNG pixels differ from phase 5's")
    if counts["block"] == 0 or counts["strand"] or counts["packet"]:
        fail("phase 5b: the strand queries did not all run on strand_block")
    pack = main_rec["pack"]
    bad, checked, notes = waves_vs_brute(pack, calls,
                                         strand_block_query_cuda, 20)
    print(f"phase 5b strand_block vs brute on a {SAMPLE}-ray sample of each "
          f"of the frame's {len(calls)} waves ({checked} rays): mismatches "
          f"per wave {', '.join(notes)}")
    if bad:
        fail(f"phase 5b: strand_block disagrees with the brute sweep on {bad} "
             "sampled rays")
    # every wave of the frame again: the per-strand counters, and the
    # per-ray walk on the same rays; where the two differ, the brute sweep
    # says which found the reference's hit
    steps, leaves, notes = [], [], []
    n_differ = block_wrong = walk_wrong = 0
    for i, a in enumerate(calls):
        tb, trb, st = strand_block_query_cuda(*a[:8], True)
        tw, trw = strand_query_cuda(*a[:8])
        steps.append(st[:, 0].double())
        leaves.append(st[:, 1].double())
        any_hit = a[7]
        diff = (trb >= 0) != (trw >= 0)
        if not any_hit:
            diff |= tb.view(torch.int32) != tw.view(torch.int32)
            diff |= (pack.tri_row[trb.clamp(min=0).long(), :9]
                     != pack.tri_row[trw.clamp(min=0).long(), :9]).any(1)
        idx = diff.nonzero().squeeze(1)
        n_differ += idx.numel()
        if idx.numel() == 0:
            continue
        ab = brute_agrees(pack, tb, trb, *a[3:8], idx)
        aw = brute_agrees(pack, tw, trw, *a[3:8], idx)
        block_wrong += int((~ab).sum())
        walk_wrong += int((~aw).sum())
        notes.append(f"wave {i} ({'any' if any_hit else 'closest'}): "
                     f"{idx.numel()} rays differ; brute sides with "
                     f"strand_block on {int((ab & ~aw).sum())}, strand_walk "
                     f"on {int((aw & ~ab).sum())}, both on "
                     f"{int((ab & aw).sum())}, neither on "
                     f"{int((~ab & ~aw).sum())}")
    steps_all, leaves_all = torch.cat(steps), torch.cat(leaves)
    print(f"phase 5b strand_block vs strand_walk on the frame's waves: "
          f"{n_differ} rays differ (pinned at {STRAND_WALKS_DIFFER}); "
          + ("; ".join(notes) or "no ray differs"))
    print(f"phase 5b strand_walk vs brute where the walks differ: wrong on "
          f"{walk_wrong} of those {n_differ} rays (pinned at "
          f"{STRAND_WALK_LOST_HITS}, ROADMAP fault 3.4, repaired)")
    if block_wrong:
        fail(f"phase 5b: strand_block disagrees with the brute sweep on "
             f"{block_wrong} rays where the walks differ")
    if (n_differ != STRAND_WALKS_DIFFER
            or walk_wrong != STRAND_WALK_LOST_HITS):
        fail(f"phase 5b: the walks differ on {n_differ} rays and strand_walk "
             f"loses {walk_wrong} hits, not the pinned {STRAND_WALKS_DIFFER} "
             f"and {STRAND_WALK_LOST_HITS}: update the pins and ROADMAP")
    print(f"phase 5b PNG vs phase 5's: {n_diff} pixels differ")
    if n_diff:
        fail("phase 5b: the block route's PNG is not phase 5's")
    big = max((i for i in range(1, len(calls)) if not calls[i][7]),
              key=lambda i: sizes[i])
    wave = calls[big][:8]
    tree, leaf, first, ro, rd, tmax, tmin, any_hit = wave
    ms = cuda_ms(lambda: strand_block_query_cuda(*wave), reps=5)
    walk_ms = cuda_ms(lambda: strand_query_cuda(*wave), reps=5)
    plain_ms = cuda_ms(lambda: strand_block_query_torch(*wave), reps=1)
    tk, trk, sk = strand_block_query_cuda(*wave, True)
    tp, trp, sp = strand_block_query_torch(*wave, True)
    torch.cuda.synchronize()
    if not (same_bits(tk, tp) and torch.equal(trk, trp)
            and torch.equal(sk, sp)):
        fail("phase 5b: strand_block != its plain version on the largest wave")
    errs.append(t_err(tk, tp))
    s_steps, s_leaves = sk[:, 0].double(), sk[:, 1].double()
    print(f"phase 5b largest sorted closest-hit wave (call {big}, "
          f"{ro.shape[0]} rays, "
          f"{sk.shape[0]} strands): strand_block {ms:.3f} ms, strand_walk "
          f"{walk_ms:.3f} ms, plain {plain_ms:.1f} ms, bit-equal with its "
          f"counters; per strand steps mean "
          f"{float(s_steps.mean()):.1f} max {int(s_steps.max())}, leaf visits "
          f"mean {float(s_leaves.mean()):.1f} max {int(s_leaves.max())}; over "
          f"the frame's {len(calls)} waves ({steps_all.numel()} strands) "
          f"steps mean {float(steps_all.mean()):.1f} max "
          f"{int(steps_all.max())}, leaf visits mean "
          f"{float(leaves_all.mean()):.1f} max {int(leaves_all.max())}")
    # the function's work: the per-ray walk's on the wave's live lanes
    # (the warps' tests of dead lanes and of nodes a lane's own walk skips
    # are the block walk's cost); every lane's ray in and result out
    work = {}
    live = tmax >= 0.0
    strand_query_torch(tree, leaf, first, ro[live], rd[live], tmax[live],
                       tmin, any_hit, counts=work)
    return dict(launches=counts["block"], ms=ms, plain_ms=plain_ms,
                **walk_bound(work, ro.shape[0], 28), png=png, wave=wave)


class timed_treelets:
    """Context manager: the seconds of every call of the function ``name``
    that ``pack_scene`` calls (the treelet build by default, or
    ``build_ribbon_tree``) inside it, as a list; each call's positional
    arguments appended to ``args`` when given."""

    def __init__(self, name: str = "build_treelets", args=None):
        self.name = name
        self.args = args

    def __enter__(self):
        from raytpu_torch.scene import pack as pack_mod

        self.mod, self.real, self.secs = (pack_mod,
                                          getattr(pack_mod, self.name), [])

        def timed(*args, **kwargs):
            if self.args is not None:
                self.args.append(args)
            t0 = time.perf_counter()
            out = self.real(*args, **kwargs)
            self.secs.append(time.perf_counter() - t0)
            return out

        setattr(pack_mod, self.name, timed)
        return self.secs

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.real)


def write_pbr_nee(path: str):
    """bench.py's pbr+nee layout (bench.py:240-262, BASELINE config 4): a
    diffuse backdrop, metal/glass/diffuse boxes, an emissive panel, one
    light and a glTF camera; 40 triangles."""
    GlbBuilder, box, quad = _writer()
    b = GlbBuilder()
    diffuse = b.add_material(color=(0.7, 0.7, 0.7, 1), ior=1.1)
    metal = b.add_material(color=(0.9, 0.8, 0.6, 1), metallic=1.0)
    glass = b.add_material(color=(0.9, 0.9, 1.0, 1), ior=1.5)
    glow = b.add_material(color=(1.0, 0.5, 0.2, 1), emission=6.0)
    pos, nrm, uv, idx = quad(size=10.0)
    b.add_node(mesh=b.add_mesh([(pos, nrm, uv, idx, diffuse, np.uint16)]),
               translation=[0, 0, -4])
    bp, bn, bu, bi = box()
    for m, x in ((metal, -3.0), (glass, 0.0), (diffuse, 3.0)):
        b.add_node(mesh=b.add_mesh([(bp, bn, bu, bi, m, np.uint32)]),
                   translation=[x, 0, -1.5])
    b.add_node(mesh=b.add_mesh([(pos, nrm, uv, idx, glow, np.uint16)]),
               matrix=[0.2, 0, 0, 0, 0, 0.2, 0, 0, 0, 0, 0.2, 0, 0, 4, 0, 1])
    b.add_node(light=b.add_light(intensity=50.0), translation=[0, 5, 8])
    b.add_node(camera=b.add_camera(1.0, 0.8), translation=[0, 0, 12])
    b.write(path)


def write_cube(path: str):
    """A stand-in for the reference cube.glb (ROADMAP 1.1's values): one
    box, colour 0.8, metallic 0, roughness 0.5, and a point light at
    (4.0762, 5.9039, -1.0055); 12 triangles."""
    GlbBuilder, box, _ = _writer()
    b = GlbBuilder()
    m = b.add_material(color=(0.8, 0.8, 0.8, 1), metallic=0.0, roughness=0.5)
    bp, bn, bu, bi = box()
    b.add_node(mesh=b.add_mesh([(bp, bn, bu, bi, m, np.uint16)]))
    b.add_node(light=b.add_light(intensity=54351.41),
               translation=[4.0762, 5.9039, -1.0055])
    b.write(path)


def packet_cell(label: str, glb: str, cam_json, args: dict, mode: str,
                min_lit: float, tmp: str, errs: list) -> dict:
    """One packet-route cell: the CLI run (launch counts, PNG), then two
    frames of the same configuration timed apart from load and pack, and
    ``count_rays``. For flat mode also the primary wave through the kernel
    and its plain version, and through strand_walk: wherever the two walks
    differ, the brute sweep decides."""
    import torch

    from raytpu_torch.engine.render import count_rays, render_frame
    from raytpu_torch.scene.camera import load_camera_json
    from raytpu_torch.scene.gltf import load_scene
    from raytpu_torch.scene.pack import pack_camera, pack_scene
    from raytpu_torch.types import RenderConfig

    png = os.path.join(tmp, f"cell_{label}.png")
    argv = cli_argv(glb, png, args, cam_json, mode)
    cli_s, counts = run_cli(argv)
    img = read_png_rgb(png)
    lit = float((img.max(-1) > 0).mean())

    w, h = args["width"], args["height"]
    scene = load_scene(glb)
    pack = pack_scene(scene, "cuda")
    camera = (load_camera_json(cam_json, w, h) if cam_json is not None
              else scene.camera)
    cam = pack_camera(camera, "cuda")
    cfg = RenderConfig(**args, mode=mode)
    frame_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        frame = render_frame(pack, cam, cfg)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    rays = count_rays(pack, cam, cfg)
    line = (f"phase 6{label} {mode} {w}x{h} {args['samples']}spp "
            f"{args['bounces']} bounces, {pack.n_triangles} slots: cli rc 0 "
            f"in {cli_s:.2f} s, {counts['packet']} packet_walk / "
            f"{counts['strand']} strand_walk launches, {lit:.3f} non-black; "
            f"frame 1 {frame_s[0]:.4f} s, frame 2 {frame_s[1]:.4f} s, "
            f"count_rays {rays}, {rays / frame_s[1]:.4g} rays/s")
    rec = dict(launches=counts["packet"])
    from raytpu_torch.kernels import packet as packet_mod

    if mode == "path":
        # every packet_walk call of a frame, every ray held to the brute
        # sweep (closest: t bits and the triangle's rows; any-hit: the
        # blocked bit)
        with recorded_queries("packet_query", "packet") as calls:
            render_frame(pack, cam, cfg)
            torch.cuda.synchronize()
        bad, checked, notes = waves_vs_brute(
            pack, calls, packet_mod.packet_query_cuda, None)
        n_any = sum(1 for a in calls if a[7])
        # the primary wave: the frame's largest closest-hit query
        rec["primary"] = max((a for a in calls if not a[7]),
                             key=lambda a: a[3].shape[0])[:8]
        line += (f"; packet_walk vs brute on every ray of the frame's "
                 f"{len(calls)} calls ({len(calls) - n_any} closest, {n_any} "
                 f"any-hit; {checked} rays): {bad} mismatches")
        if bad:
            print(line)
            fail(f"cell {label}: packet_walk disagrees with the brute sweep "
                 f"on {bad} rays")
    if mode == "flat":
        ro, rd = primary_wave(cam, w, h, args["chunk_size"], args["seed"])
        tables = (pack.bvh.node8_rows, pack.bvh.leaf_tris,
                  pack.bvh.first_slots)
        ms, plain_ms, bad, bnd = wave_check("packet", tables, pack, ro, rd,
                                            errs)
        line += (f"; primary wave {ro.shape[0]} rays: packet_walk {ms:.3f} "
                 f"ms, plain {plain_ms:.1f} ms, bit-equal; vs brute on "
                 f"{SAMPLE} rays: {bad} mismatches (pinned at "
                 f"{PACKET_LOST_HITS}); plain-walk work {bnd['boxes']} box / "
                 f"{bnd['tris']} triangle tests")
        if bad != PACKET_LOST_HITS:
            fail(f"primary wave: packet_walk misses the brute sweep on {bad} "
                 f"sampled rays, not the pinned {PACKET_LOST_HITS}")
        # the whole wave: where packet_walk and strand_walk differ, the
        # brute sweep decides
        from raytpu_torch.kernels.strand import strand_query_cuda

        tmax = torch.full((ro.shape[0],), F32_MAX, device="cuda")
        right = packet_mod.packet_query_cuda(*tables, ro, rd, tmax, 0.001,
                                             False)
        node8 = pack.bvh.node8_rows

        def run(idx, keys, box):
            with (contextlib.nullcontext() if box
                  else unrepaired_box_test()):
                return packet_mod.packet_query_torch(
                    node8, pack.bvh.leaf_tris, keys, ro[idx], rd[idx],
                    tmax[idx], 0.001, False)

        lost_hits("6c", pack, ro, rd, right, run)
        n_diff, packet_wrong, strand_wrong = differ_vs_brute(
            pack, right,
            strand_query_cuda(pack.bvh.strand_rows, pack.bvh.leaf_tris,
                              pack.bvh.first_slots, ro, rd, tmax, 0.001,
                              False),
            ro, rd, tmax, 0.001)
        line += (f"; packet_walk and strand_walk differ on {n_diff} rays of "
                 f"the wave, wrong there: packet_walk {packet_wrong} (pinned "
                 f"at {PACKET_WAVE_LOST_HITS}), strand_walk {strand_wrong}")
        print(line)
        line = None
        if strand_wrong:
            fail("phase 6c: strand_walk disagrees with the brute sweep")
        if packet_wrong != PACKET_WAVE_LOST_HITS:
            fail(f"phase 6c: packet_walk misses the brute sweep on "
                 f"{packet_wrong} rays of the wave, not the pinned "
                 f"{PACKET_WAVE_LOST_HITS}: update the pin and ROADMAP fault "
                 "3.5")
        rec.update(ms=ms, plain_ms=plain_ms, **bnd, pack=pack, cam=cam,
                   cfg=cfg, frame=frame, frame_s=frame_s, ro=ro, rd=rd)
    if line is not None:
        print(line)
    if img.shape != (h, w, 3) or lit <= min_lit:
        fail(f"cell {label}: PNG is wrong or has <= {min_lit} non-black")
    # flat mode and <= 256-slot scenes take the packet route on every wave
    if counts["packet"] == 0 or counts["strand"] != 0:
        fail(f"cell {label} did not take the packet route on every wave")
    return rec


def phase_packet_route(tmp: str, main_rec: dict, errs: list) -> dict:
    """Phase 6: the packet route through the CLI at bench.py's settings."""
    pbr = os.path.join(tmp, "pbr_nee.glb")
    write_pbr_nee(pbr)
    cube = os.path.join(tmp, "cube.glb")
    write_cube(cube)
    cube_cam = os.path.join(tmp, "cube_camera.json")
    with open(cube_cam, "w") as f:
        json.dump({"origin": [0, 0, -20], "at": [0, 0, 0], "fov": 0.3}, f)
    cells = [
        packet_cell("a", pbr, None, dict(width=256, height=256, seed=1,
                                         chunk_size=32, samples=4, bounces=4),
                    "path", 0.10, tmp, errs),
        packet_cell("b", cube, cube_cam, dict(width=512, height=512, seed=1,
                                              chunk_size=64, samples=4,
                                              bounces=4),
                    "path", 0.02, tmp, errs),
        packet_cell("c", main_rec["glb"], main_rec["cam_json"],
                    dict(width=1920, height=1080, seed=1, chunk_size=64,
                         samples=1, bounces=1),
                    "flat", 0.10, tmp, errs),
    ]
    return dict(cells[2], launches=sum(c["launches"] for c in cells),
                a_primary=cells[0]["primary"])


class recorded_walks:
    """Context manager: the arguments of every treelet walk the binned
    queries run inside it, as a list (the round loop looks the dispatcher
    up at each call)."""

    def __enter__(self):
        from raytpu_torch.kernels import binned as binned_mod

        self.mod, self.real, self.calls = (binned_mod, binned_mod.binned_walk,
                                           [])

        def record(*args):
            self.calls.append(args)
            return self.real(*args)

        binned_mod.binned_walk = record
        return self.calls

    def __exit__(self, *exc):
        self.mod.binned_walk = self.real


def phase_stream(tmp: str, errs: list) -> dict:
    """Phase 7a: the binned route at bench.py's config 6 shape
    (bench.py:421-440): the gallery scaled to ~2.9M triangles, packed
    tables="auto", 640x360, 1 spp, 4 bounces, chunk 8, seed 1,
    intersector="binned", through render_frame. The pack must stream by
    raytpu's TPU rule (treelets, BVH8 and leaf rows over the pack budget):
    bench.py's own check for config 6 (bench.py:424-427), no BVH8 rows and
    a strand tree. The largest binned_walk launch of a frame is replayed
    through the kernel and its plain version; the primary wave's binned
    and strand closest hits on the same pack are held to the brute sweep
    on a sample and wherever they differ; fault 3.5's lost rays are
    counted on the primary wave and on every closest-hit lane of every
    bounce query of a frame. The pack's strand tables are over raytpu's 100 MiB budget
    (raytpu's tree_any), where the strand factory keeps the per-ray walk's
    default instance unless RAYTPU_STRAND_HBM is set: on the primary wave
    that instance is timed in turns with the pipelined schedule form
    tree_any selects, with raytpu's claims of 16 batches and with claims of
    1 (the grid, in blocks, printed beside each), each held to it on t bits
    and the tie key."""
    import torch

    from raytpu_torch.engine.render import count_rays, render_frame
    from raytpu_torch.kernels.binned import (
        binned_walk_cuda,
        binned_walk_torch,
        make_binned_intersectors,
    )
    from raytpu_torch.kernels.strand import (
        STRAND_TABLE_BUDGET,
        _n_nodes,
        _schedule,
        make_strand_intersectors,
        sched_grid,
        strand_query_cuda,
    )
    from raytpu_torch.scene.camera import camera_from_lookat
    from raytpu_torch.scene.gltf import load_scene
    from raytpu_torch.scene.pack import (
        ROW_BYTES,
        TABLE_BUDGET,
        pack_camera,
        pack_scene,
    )
    from raytpu_torch.types import RenderConfig

    glb = os.path.join(tmp, "gallery_stream.glb")
    write_gallery(glb, cells=1200)
    w, h = 640, 360
    t0 = time.perf_counter()
    scene = load_scene(glb)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tl_args = []
    with timed_treelets(args=tl_args) as tl_s:
        pack = pack_scene(scene, "cuda")
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    # build_treelets(bvh8, leaf_tris): the rows the stream rule counted
    ((bvh8, leaf_rows),) = tl_args
    rule_mb = (bvh8.node_rows.shape[0] + leaf_rows.shape[0]) * ROW_BYTES
    rule_mb /= 2**20
    n_tris = sum(int(c) // 3 for c in scene.prim_index_count)
    n_tl, sn = pack.tl_nodes.shape[0], pack.tl_nodes.shape[1]
    sl = pack.tl_leaves.shape[1]
    tl_mb = (pack.tl_nodes.numel() + pack.tl_leaves.numel()) * 4 / 2**20
    streams = pack.bvh.node8_rows is None
    print(f"phase 7a pack: {n_tris} triangles ({pack.n_triangles} slots), "
          f"glb load {load_s:.2f} s, pack_scene(tables='auto') "
          f"{pack_s:.2f} s; BVH8 + leaf rows {rule_mb:.1f} MiB against the "
          f"{TABLE_BUDGET / 2**20:.0f} MiB pack budget, with treelets: "
          f"streams {streams}; node8_rows is None: {streams}, strand_rows "
          f"is not None: {pack.bvh.strand_rows is not None} (bench.py "
          f"config 6's check)")
    print(f"phase 7a treelets: built in {sum(tl_s):.2f} s; T {n_tl}, Sn {sn}, "
          f"Sl {sl}; tl_nodes + tl_leaves {tl_mb:.1f} MB")
    if rule_mb * 2**20 <= TABLE_BUDGET:
        fail("phase 7a: the pack's BVH8 and leaf rows fit the pack budget")
    if pack.bvh.node8_rows is not None or pack.bvh.strand_rows is None:
        fail("phase 7a: the auto pack did not stream (bench.py config 6's "
             "check: node8_rows is None, strand_rows is not None)")
    cam = pack_camera(camera_from_lookat(
        GALLERY_CAM["origin"], GALLERY_CAM["at"], GALLERY_CAM["fov"], w, h),
        "cuda")
    cfg = RenderConfig(width=w, height=h, seed=1, samples=1, bounces=4,
                       chunk_size=8, intersector="binned")
    frame_s = []
    for i in range(2):
        reset_launches()
        with recorded_walks() as calls:
            t0 = time.perf_counter()
            frame = render_frame(pack, cam, cfg)
            torch.cuda.synchronize()
            frame_s.append(time.perf_counter() - t0)
        counts = read_launches()
        rounds = rounds_note()
    with recorded_mixed() as bounce_calls:
        render_frame(pack, cam, cfg)
        torch.cuda.synchronize()
    rays = count_rays(pack, cam, cfg)
    lit = float((frame.max(-1) > 0).mean())
    print(f"phase 7a frame: {w}x{h} 1spp 4 bounces, intersector='binned': "
          f"frame 1 {frame_s[0]:.3f} s, frame 2 {frame_s[1]:.3f} s, "
          f"count_rays {rays}, {rays / frame_s[1]:.4g} rays/s; "
          f"{counts['binned']} binned_walk / {counts['strand']} strand_walk "
          f"/ {counts['packet']} packet_walk launches; {rounds}; "
          f"{lit:.3f} non-black")
    if not np.isfinite(frame).all() or lit <= 0.10:
        fail("phase 7a frame is not finite or mostly black")
    if counts["binned"] == 0 or counts["strand"] or counts["packet"]:
        fail("phase 7a did not run every query on binned_walk")

    # the frame's launches: the kernel on each, timed with CUDA events,
    # and its plain version on each (bit-equal; its counts give each
    # launch's bound), timed on the largest
    sizes = [a[3].shape[0] for a in calls]
    kernel_ms = [cuda_ms(lambda a=a: binned_walk_cuda(*a), reps=3)
                 for a in calls]
    reps = 3
    per_launch = device_times([lambda a=a: binned_walk_cuda(*a)
                               for _ in range(reps) for a in calls])
    frame_dev_ms = sum(per_launch) / reps
    bounds = []
    for a in calls:
        tk, trk = binned_walk_cuda(*a)
        one = {}
        tp, trp = binned_walk_torch(*a, counts=one)
        if not (same_bits(tk, tp) and torch.equal(trk, trp)):
            fail("phase 7a: binned_walk != its plain version on a frame "
                 "launch")
        errs.append(t_err(tk, tp))
        bounds.append(walk_bound(one, a[3].shape[0], 40))
    big = calls[int(np.argmax(sizes))]
    event_ms = kernel_ms[int(np.argmax(sizes))]
    ms = float(np.mean(per_launch[int(np.argmax(sizes))::len(calls)]))
    plain_ms = cuda_ms(lambda: binned_walk_torch(*big), reps=1)
    work = {}
    binned_walk_torch(*big, counts=work)
    # per ray the treelet, ro, rd, tmax, smask and tri0 in
    bnd = walk_bound(work, big[3].shape[0], 40)
    # primary wave: binned and strand closest hits, each held to the brute
    # sweep on a sample and wherever the two differ on the whole wave
    ro, rd = primary_wave(cam, w, h, 8, 1)
    tmax = torch.full((ro.shape[0],), F32_MAX, device="cuda")
    hb = make_binned_intersectors(pack)[0](ro, rd, 0.001, tmax)
    hs = make_strand_intersectors(pack)[0](ro, rd, 0.001, tmax)
    torch.cuda.synchronize()
    idx = sample_of(ro.shape[0], seed=7)
    binned_bad, strand_bad = (
        int((~brute_agrees(pack, hit.t, hit.tri, ro, rd, tmax, 0.001, False,
                           idx)).sum()) for hit in (hb, hs))

    from raytpu_torch.kernels import binned as binned_mod

    def run(idx, keys, box):
        keyed = dataclasses.replace(pack, bvh=dataclasses.replace(
            pack.bvh, first_slots=keys))
        kernel = binned_mod.binned_walk
        binned_mod.binned_walk = binned_walk_torch
        try:
            with (contextlib.nullcontext() if box
                  else unrepaired_box_test()):
                hit = make_binned_intersectors(keyed)[0](
                    ro[idx], rd[idx], 0.001, tmax[idx])
        finally:
            binned_mod.binned_walk = kernel
        return hit.t, hit.tri

    tree, leaf, first = (pack.bvh.strand_rows, pack.bvh.leaf_tris,
                         pack.bvh.first_slots)
    table_mb = (tree.numel() + leaf.numel()) * 4 / 2**20
    if table_mb * 2**20 <= STRAND_TABLE_BUDGET:
        fail("phase 7a: the stream pack's strand tables fit the budget")
    pipe = dict(RAYTPU_SCHED, tree_any=True)
    wave = (leaf, first, ro, rd, tmax, 0.001, False)
    # the pipe form at raytpu's claims of 16 batches, and of 1: the grid
    # fills the card's resident capacity, or takes one block a claim
    grids = {k: sched_grid(_schedule(0, _n_nodes(tree, 0),
                                     **dict(pipe, service_k=k)), 0,
                           ro.shape[0]) for k in (16, 1)}
    forms = {"default": {},
             **{f"pipe, service_k {k} ({g} blocks)": dict(pipe, service_k=k)
                for k, g in grids.items()}}
    pipe_ms = in_turns({k: (lambda kw=kw: strand_query_cuda(tree, *wave,
                                                           **kw))
                        for k, kw in forms.items()})
    base = strand_query_cuda(tree, *wave)
    for k, kw in forms.items():
        if agree("closest", strand_query_cuda(tree, *wave, **kw), base,
                 first):
            fail(f"phase 7a: strand_walk's {k} form differs from the "
                 "default instance on the primary wave")
    torch.cuda.synchronize()
    print(f"phase 7a strand tables {table_mb:.1f} MiB (over the "
          f"{STRAND_TABLE_BUDGET / 2**20:.0f} MiB budget): primary wave "
          f"({ro.shape[0]} rays) in turns, ms a launch: " + ", ".join(
              f"{k} {v:.4f}" for k, v in pipe_ms.items())
          + "; each equal to the default on t bits and the tie key")
    lost_hits("7a", pack, ro, rd, (hb.t, hb.tri), run)
    bounce_lost_hits("7a", pack, bounce_calls)
    n_diff, binned_wrong, strand_wrong = differ_vs_brute(
        pack, (hb.t, hb.tri), (hs.t, hs.tri), ro, rd, tmax, 0.001)
    print(f"phase 7a kernel: {len(calls)} launches in frame 2, "
          f"{sum(sizes)} rays (launch sizes: min {min(sizes)}, median "
          f"{int(np.median(sizes))}, max {max(sizes)}), kernel "
          f"{frame_dev_ms:.3f} ms of device time in all (queued back to back; "
          f"{sum(kernel_ms):.3f} ms by CUDA events around each launch, host "
          f"time included), summed bound "
          f"{sum(b['bound_ms'] for b in bounds):.4f} ms; largest launch "
          f"{max(sizes)} rays: binned_walk {ms:.4f} ms of device time "
          f"({event_ms:.3f} ms by CUDA events around it), plain "
          f"{plain_ms:.1f} ms, bit-equal; plain-walk work {bnd['boxes']} box "
          f"/ {bnd['tris']} triangle tests; primary wave {ro.shape[0]} rays: "
          f"{int(hb.valid.sum())} hits; vs brute on {idx.numel()} rays: "
          f"binned {binned_bad} mismatches, strand_walk {strand_bad}; "
          f"binned and strand_walk differ on {n_diff} rays of the wave, "
          f"wrong there: binned {binned_wrong}, strand_walk {strand_wrong}")
    if strand_bad or strand_wrong:
        fail("phase 7a: strand_walk disagrees with the brute sweep")
    if binned_bad or binned_wrong:
        fail(f"phase 7a: binned_walk disagrees with the brute sweep on "
             f"{binned_bad} sampled rays and on {binned_wrong} rays of the "
             "wave (ROADMAP fault 3.5)")
    return dict(launches=counts["binned"], ms=ms, plain_ms=plain_ms, **bnd)


class recorded_mixed:
    """Context manager: the inputs and results of every mixed query the
    engine makes inside it (the factory ``render.<factory>`` wrapped:
    ``make_binned_query`` or ``make_strand_mixed_query``), as a list of
    (ro, rd, tmax, smask, tmin, shadow_tmin, t, tri)."""

    def __init__(self, factory: str = "make_binned_query"):
        self.factory = factory

    def __enter__(self):
        from raytpu_torch.engine import render as render_mod

        self.mod = render_mod
        self.real = getattr(render_mod, self.factory)
        self.calls = []

        def make(pack):
            query = self.real(pack)

            def recorded(ro, rd, tmax, smask, *, tmin, shadow_tmin):
                args = [a.clone() for a in (ro, rd, tmax, smask)]
                t, tri = query(ro, rd, tmax, smask, tmin=tmin,
                               shadow_tmin=shadow_tmin)
                self.calls.append((*args, tmin, shadow_tmin, t, tri))
                return t, tri

            return recorded

        setattr(render_mod, self.factory, make)
        return self.calls

    def __exit__(self, *exc):
        setattr(self.mod, self.factory, self.real)


def mixed_vs_brute(label: str, pack, calls: list, seed: int) -> None:
    """Each recorded mixed query held to the brute sweep on a seeded
    SAMPLE of its closest lanes (t bits and the triangle's rows) and of
    its shadow lanes (the blocked bit); fails on any mismatch."""
    bad, notes = 0, []
    for i, (ro, rd, tmax, smask, tmin, shadow_tmin, t, tri) in enumerate(
            calls):
        for shadow in (False, True):
            lanes = ((smask == 1.0) == shadow).nonzero().squeeze(1)
            idx = lanes[sample_of(lanes.numel(), seed + 2 * i + shadow)]
            n_bad = int((~brute_agrees(
                pack, t, tri, ro, rd, tmax, shadow_tmin if shadow else tmin,
                shadow, idx)).sum())
            bad += n_bad
            notes.append(f"{'shadow' if shadow else 'closest'} {n_bad} of "
                         f"{idx.numel()}")
    print(f"phase {label} mixed queries vs brute on a {SAMPLE}-lane sample "
          f"of each lane kind of the frame's {len(calls)} queries: "
          + ", ".join(notes))
    if bad:
        fail(f"phase {label}: the mixed queries disagree with the brute "
             f"sweep on {bad} sampled lanes")


def phase_deferred(main_rec: dict) -> dict:
    """Phase 7b: phase 5's pack and configuration with
    intersector="packet", bounce_backend="binned" (strand primary and last
    shadow waves, deferred NEE in binned mixed bounces); its PNG against
    phase 5's within tests/imgdiff.py's bar; each of a frame's binned mixed
    queries held to the brute sweep on a seeded SAMPLE of its closest lanes
    (t bits and the triangle's rows) and of its shadow lanes (the blocked
    bit), and fault 3.5's lost rays counted on every closest-hit lane of
    each."""
    import torch

    from raytpu_torch.engine.render import render_frame
    from raytpu_torch.types import RenderConfig

    pack, cam = main_rec["pack"], main_rec["cam"]
    cfg = RenderConfig(**MAIN_ARGS, intersector="packet",
                       bounce_backend="binned")
    frame_s = []
    for _ in range(2):
        reset_launches()
        t0 = time.perf_counter()
        frame = render_frame(pack, cam, cfg)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        counts = read_launches()
        rounds = rounds_note()
    n_diff, frac, s = png_diff(frame, main_rec["frame"])
    lit = float((frame.max(-1) > 0).mean())
    print(f"phase 7b deferred NEE: {pack.n_triangles} slots "
          f"({pack.tl_nodes.shape[0]} treelets), 1920x1080 1spp 4 bounces, "
          f"intersector='packet' bounce_backend='binned': frame 1 "
          f"{frame_s[0]:.3f} s, frame 2 {frame_s[1]:.3f} s; "
          f"{counts['strand']} strand_walk / {counts['binned']} binned_walk / "
          f"{counts['packet']} packet_walk launches; {rounds}; vs phase 5's "
          f"frame: {n_diff} PNG pixels differ ({frac:.5f}), SSIM {s:.5f}; "
          f"{lit:.3f} non-black")
    if frac > 0.02 or s < 0.99:
        fail("phase 7b frame disagrees with phase 5's")
    if counts["strand"] == 0 or counts["binned"] == 0 or counts["packet"]:
        fail("phase 7b did not take strand primary waves and binned bounces")
    with recorded_mixed() as calls:
        render_frame(pack, cam, cfg)
        torch.cuda.synchronize()
    mixed_vs_brute("7b binned", pack, calls, 30)
    bounce_lost_hits("7b", pack, calls)
    return dict(frame=frame, frame_s=frame_s)


def mixed_same(t_a, tri_a, t_b, tri_b, smask, first=None) -> bool:
    """Two mixed results agree: closest lanes on t bits and tri (with
    ``first``, two walks of one scene: on the triangle's tie key, since
    each walk returns the first copy of a triangle it tests), shadow lanes
    on the blocked bit."""
    import torch

    if first is not None:
        tri_a, tri_b = (torch.where(x >= 0, first[x.clamp(min=0).long()], -1)
                        for x in (tri_a, tri_b))
    shad = smask == 1.0
    return not bool((~shad & ((tri_a != tri_b) | (t_a.view(torch.int32)
                                                  != t_b.view(torch.int32)))
                     | (shad & ((tri_a >= 0) != (tri_b >= 0)))).any())


def phase_mixed_route(main_rec: dict, deferred_rec: dict,
                      errs: dict) -> tuple:
    """Phase 10a: phase 5's pack and configuration with
    intersector="packet", bounce_backend="mixed" (strand primary and last
    shadow waves, deferred NEE in the strand walk's mixed queries), the
    counts set to 0 before each frame and read after. Its PNG must equal
    phase 7b's (the same schedule through binned_walk: 0 pixels may
    differ) and be within tests/imgdiff.py's bar of phase 5's; each mixed
    query of a frame is held to the brute sweep on a sample of each lane
    kind. The frame's largest mixed query then runs through both mixed
    kernels (the strand walk's, and the packet walk's on the pack's BVH8
    rows) and their plain versions: bit-equal, timed, bounded. Returns the
    two kernels' records."""
    import torch

    from raytpu_torch.engine.render import render_frame
    from raytpu_torch.types import RenderConfig

    pack, cam = main_rec["pack"], main_rec["cam"]
    cfg = RenderConfig(**MAIN_ARGS, intersector="packet",
                       bounce_backend="mixed")
    frame_s = []
    for _ in range(2):
        reset_launches()
        t0 = time.perf_counter()
        frame = render_frame(pack, cam, cfg)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
        counts = read_launches()
    n7 = png_pixels_differ(frame, deferred_rec["frame"])
    n5, frac, s = png_diff(frame, main_rec["frame"])
    lit = float((frame.max(-1) > 0).mean())
    print(f"phase 10a mixed backend: {MAIN_ARGS['width']}x"
          f"{MAIN_ARGS['height']} 1spp 4 bounces, "
          f"intersector='packet' bounce_backend='mixed': frame 1 "
          f"{frame_s[0]:.3f} s, frame 2 {frame_s[1]:.3f} s (phase 5 "
          f"{main_rec['frame_s'][0]:.3f} / {main_rec['frame_s'][1]:.3f} s, "
          f"phase 7b {deferred_rec['frame_s'][0]:.3f} / "
          f"{deferred_rec['frame_s'][1]:.3f} s); "
          + launched("10a", counts, ("strand", "strand_mixed"))
          + f"; vs phase 7b's frame: {n7} PNG pixels differ; vs phase 5's: "
          f"{n5} ({frac:.5f}), SSIM {s:.5f}; {lit:.3f} non-black")
    if n7:
        fail("phase 10a: the mixed backend's PNG is not phase 7b's")
    if frac > 0.02 or s < 0.99:
        fail("phase 10a frame disagrees with phase 5's")
    with recorded_mixed("make_strand_mixed_query") as calls:
        render_frame(pack, cam, cfg)
        torch.cuda.synchronize()
    mixed_vs_brute("10a strand", pack, calls, 50)
    ro, rd, tmax, smask, tmin, shadow_tmin, t_e, tri_e = max(
        calls, key=lambda c: c[0].shape[0])
    n = ro.shape[0]
    recs, notes = {}, []
    for which, tree in (("strand", pack.bvh.strand_rows),
                        ("packet", pack.bvh.node8_rows)):
        kernel, plain, _ = mixed_fns(which)
        args = (tree, pack.bvh.leaf_tris, pack.bvh.first_slots, ro, rd, tmax,
                smask, tmin, shadow_tmin)
        ms = cuda_ms(lambda: kernel(*args), reps=5)
        plain_ms = cuda_ms(lambda: plain(*args), reps=1)
        t_k, tri_k = kernel(*args)
        work = {}
        t_p, tri_p = plain(*args, counts=work)
        torch.cuda.synchronize()
        if not mixed_same(t_k, tri_k, t_p, tri_p, smask):
            fail(f"phase 10a: {which}_walk's mixed form != its plain version "
                 "on the largest mixed query")
        if not mixed_same(t_k, tri_k, t_e, tri_e, smask,
                          pack.bvh.first_slots):
            fail(f"phase 10a: {which}_walk's mixed form != the engine's "
                 "strand mixed query")
        shad = smask == 1.0
        errs[which + "_mixed"].append(t_err(t_k[~shad], t_p[~shad]))
        recs[which] = dict(ms=ms, plain_ms=plain_ms,
                           **walk_bound(work, n, 32))
        notes.append(f"{KERNELS[which + '_mixed']['name']} {ms:.3f} ms, "
                     f"plain {plain_ms:.1f} ms, bound "
                     f"{recs[which]['bound_ms']:.4f} ms "
                     f"({recs[which]['bound_by']})")
    print(f"phase 10a largest mixed query ({n} lanes, "
          f"{int((smask == 1.0).sum())} shadow): both mixed kernels "
          "bit-equal to their plain versions and to the engine's result; "
          + "; ".join(notes))
    recs["strand"].update(launches=counts["strand_mixed"], frame=frame,
                          query=(ro, rd, tmax, smask, tmin, shadow_tmin))
    return recs["strand"], recs["packet"]


def phase_sorted_arms(main_rec: dict) -> None:
    """Phases 10b and 10c: phase 5's frame with RAYTPU_WAVE_MODE=resort and
    compact (10b), and with RAYTPU_SORT_MODE=gather, seg (RAYTPU_SORT_SEG at
    its default, 131,072) and RAYTPU_COMPACT=1 (10c), each knob set just
    before and restored just after: each PNG must equal phase 5's, and
    only strand_walk may launch."""
    import torch

    from raytpu_torch.engine.render import WAVE_STATS, render_frame
    from raytpu_torch.types import RenderConfig

    pack, cam = main_rec["pack"], main_rec["cam"]
    cfg = RenderConfig(**MAIN_ARGS)
    arms = [("10b", dict(RAYTPU_WAVE_MODE="resort")),
            ("10b", dict(RAYTPU_WAVE_MODE="compact")),
            ("10c", dict(RAYTPU_SORT_MODE="gather")),
            ("10c", dict(RAYTPU_SORT_MODE="seg")),
            ("10c", dict(RAYTPU_COMPACT="1"))]
    for label, knobs in arms:
        with env(**knobs):
            reset_launches()
            secs = warm_s(lambda: render_frame(pack, cam, cfg))
            counts = read_launches()
            frame = render_frame(pack, cam, cfg)
            torch.cuda.synchronize()
            waves = dict(WAVE_STATS)
        n_diff = png_pixels_differ(frame, main_rec["frame"])
        n_f32 = int(np.any(frame != main_rec["frame"], -1).sum())
        name = " ".join(f"{k}={v}" for k, v in knobs.items())
        print(f"phase {label} {name}: mode '{waves['mode']}', work width per "
              f"bounce {waves['widths']}; frames {secs[0]:.3f} / "
              f"{secs[1]:.3f} s (phase 5 {main_rec['frame_s'][1]:.3f} s); "
              f"vs phase 5's frame: {n_diff} PNG pixels differ ({n_f32} f32 "
              "pixels); " + launched(label, counts, ("strand",)))
        if n_diff:
            fail(f"phase {label} {name}: the PNG is not phase 5's")


def in_turns(calls: dict, reps: int = 5) -> dict:
    """CUDA-event ms per launch of each call, timed in turns (a b ... b a):
    each call's mean of its two runs."""
    names = list(calls)
    order = names + names[::-1]
    times = {name: [] for name in names}
    for name in order:
        times[name].append(cuda_ms(calls[name], reps=reps))
    return {name: sum(v) / len(v) for name, v in times.items()}


def plain_run(fn) -> tuple:
    """One run of a plain walk with counts, timed by the host around it
    (it ends in a synchronise): (ms, its outputs, its counts)."""
    import torch

    work = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(work)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out, work


def phase_ribbon_route(main_rec: dict, mixed_rec: dict, errs: dict) -> dict:
    """Phase 11a: phase 5's pack and configuration with RAYTPU_RIBBON=1 and
    then =4 (each set just before, restored just after), the counts set to
    0 before the frames and read after: every strand query on strand_walk
    over the pack's ribbon rows, one record a step (K 1) or with the K-wide
    fetch (K 4), each PNG equal to phase 5's; then phase 10a's
    configuration (deferred NEE through the strand walk's mixed form) with
    the same knobs, each PNG equal to 10a's. On phase 5's 1080p primary
    wave and on 10a's largest mixed query: strand_walk over the strand
    rows and over ribbon rows at K 1, 4 and 8, each with and without
    stats=True, all in turns (CUDA events), so that each K-wide fetch is
    timed beside K 1 and each stats instance beside its twin; each of
    these instances bit-equal to its plain version (t, tri, with stats
    every counter; on the mixed query t and tri of the closest lanes, the
    blocked bit of the shadow lanes) and to the strand layout's instance
    (the K-wide fetch's [0], its windows, apart), the errors of the timed
    instances (without stats) going to ``errs``; and every walk_kernel
    instance's registers, spills and shared memory from ptxas's report.
    Every form is bound by the strand layout's plain walk on the same rays
    (the same visits). Returns the four forms' records."""
    import torch

    from raytpu_torch.engine.render import render_frame
    from raytpu_torch.kernels import _build
    from raytpu_torch.kernels.strand import (
        strand_mixed_query_cuda,
        strand_mixed_query_torch,
        strand_query_cuda,
        strand_query_torch,
    )
    from raytpu_torch.types import RenderConfig

    pack, cam = main_rec["pack"], main_rec["cam"]
    cfg = RenderConfig(**MAIN_ARGS)
    mcfg = RenderConfig(**MAIN_ARGS, intersector="packet",
                        bounce_backend="mixed")
    launches = {}
    for k, key in (("1", "ribbon"), ("4", "ribbon_wide")):
        with env(RAYTPU_RIBBON=k):
            reset_launches()
            secs = warm_s(lambda: render_frame(pack, cam, cfg))
            counts = read_launches()
            frame = render_frame(pack, cam, cfg)
            reset_launches()
            msecs = warm_s(lambda: render_frame(pack, cam, mcfg))
            mcounts = read_launches()
            mframe = render_frame(pack, cam, mcfg)
        n5 = png_pixels_differ(frame, main_rec["frame"])
        n10 = png_pixels_differ(mframe, mixed_rec["frame"])
        print(f"phase 11a RAYTPU_RIBBON={k}: frames {secs[0]:.3f} / "
              f"{secs[1]:.3f} s (phase 5 {main_rec['frame_s'][1]:.3f} s), "
              + launched(f"11a K={k}", counts, (f"strand_{key}",))
              + f"; vs phase 5's frame: {n5} PNG pixels differ "
              f"({int(np.any(frame != main_rec['frame'], -1).sum())} f32 "
              f"pixels); with bounce_backend='mixed': frames {msecs[0]:.3f} "
              f"/ {msecs[1]:.3f} s, "
              + launched(f"11a K={k} mixed", mcounts,
                         (f"strand_{key}", f"strand_mixed_{key}"))
              + f"; vs phase 10a's frame: {n10} PNG pixels differ")
        if n5 or n10:
            fail(f"phase 11a: the ribbon layout's PNG (K {k}) is not the "
                 "strand layout's")
        launches[f"strand_{key}"] = counts[f"strand_{key}"]
        launches[f"strand_mixed_{key}"] = mcounts[f"strand_mixed_{key}"]
    rib, strand_rows = pack.bvh.ribbon_rows, pack.bvh.strand_rows
    rpo = rib.shape[0] // 8
    leaf, first = pack.bvh.leaf_tris, pack.bvh.first_slots
    ro, rd = main_rec["ro"], main_rec["rd"]
    n = ro.shape[0]
    tmax = torch.full((n,), F32_MAX, device="cuda")
    wave = (leaf, first, ro, rd, tmax, 0.001, False)
    q = mixed_rec["query"]
    margs = (leaf, first, *q)
    forms = (("primary", strand_query_cuda, strand_query_torch, wave),
             ("mixed", strand_mixed_query_cuda, strand_mixed_query_torch,
              margs))
    # each layout and K with and without stats, in turns (a b ... b a)
    ms = {}
    for label, kernel, _, args in forms:
        calls = {}
        for st in (False, True):
            tag = "+stats" if st else ""
            calls["strand" + tag] = (lambda a=args, st=st: kernel(
                strand_rows, *a, stats=st))
            for k in (1, 4, 8):
                calls[f"ribbon K={k}{tag}"] = (lambda a=args, k=k, st=st:
                                               kernel(rib, *a, rpo=rpo,
                                                      ribbon_k=k, stats=st))
        ms[label] = in_turns(calls)
    recs, fetched = {}, {}
    for label, kernel, plain, args in forms:
        mixed = label == "mixed"

        def to_plain(a, b):
            return ((mixed_same(*a[:2], *b[:2], q[3]) if mixed else
                     same_walk(a[:2], b[:2]))
                    and all(torch.equal(x, y) for x, y in zip(a[2:], b[2:])))

        for st in (False, True):
            k0 = kernel(strand_rows, *args, stats=st)
            _, p0, work = plain_run(lambda c: plain(strand_rows, *args, c,
                                                    stats=st))
            if not to_plain(k0, p0):
                fail(f"phase 11a {label} stats={st}: the strand layout's "
                     f"kernel != its plain version (t, tri, stats "
                     f"{[x.tolist() for x in k0[2:]]} / "
                     f"{[x.tolist() for x in p0[2:]]})")
            for k in (1, 4, 8):
                got = kernel(rib, *args, rpo=rpo, ribbon_k=k, stats=st)
                plain_ms, p, _ = plain_run(lambda c: plain(
                    rib, *args, c, rpo=rpo, ribbon_k=k, stats=st))
                skip = 0 if k == 1 else 1  # the K-wide fetch's [0]: windows
                if not (to_plain(got, p) and same_walk(got, k0, skip)):
                    fail(f"phase 11a {label} stats={st}: the ribbon kernel "
                         f"(K {k}) != its plain version or the strand layout "
                         f"(t, tri, stats {[x.tolist() for x in got[2:]]} / "
                         f"{[x.tolist() for x in p[2:]]} / "
                         f"{[x.tolist() for x in k0[2:]]})")
                if st:
                    fetched[f"{label} K={k}"] = got[2].tolist()
                    continue
                key = ("strand_mixed_" if mixed else "strand_") + (
                    "ribbon" if k == 1 else "ribbon_wide")
                errs[key].append(t_err(got[0], p[0]))
                if k == 8:
                    continue
                recs[key] = dict(launches=launches[key],
                                 ms=ms[label][f"ribbon K={k}"],
                                 plain_ms=plain_ms,
                                 **walk_bound(work, args[2].shape[0],
                                              32 if mixed else 28))
    regs = {instance_name(name)[12:]: r for name, r in
            _build.kernel_resources("strand_walk").items()
            if "walk_kernel" in name}
    b = recs["strand_ribbon"], recs["strand_mixed_ribbon"]
    print(f"phase 11a in turns, ms a launch (each layout and K with and "
          f"without stats): primary wave ({n} rays) " + ", ".join(
              f"{k} {v:.4f}" for k, v in ms["primary"].items())
          + f"; 10a's largest mixed query ({q[0].shape[0]} lanes) "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms["mixed"].items())
          + "; stats/twin " + ", ".join(
              f"{label} {k} {ms[label][k + '+stats'] / ms[label][k]:.3f}"
              for label in ms for k in ("strand", "ribbon K=1", "ribbon K=4",
                                        "ribbon K=8"))
          + "; K-wide/K=1 " + ", ".join(
              f"{label} K={k} {ms[label][f'ribbon K={k}'] / ms[label]['ribbon K=1']:.3f}"
              for label in ms for k in (4, 8))
          + f"; stats {fetched}; each, without and with stats, bit-equal "
          "to its plain version (t, tri, stats) and to the strand layout (t, "
          "tri, stats but the K-wide fetch's [0]); plain K=1 {b[0]['plain_ms']:.1f} ms, K=4 "
          f"{recs['strand_ribbon_wide']['plain_ms']:.1f} ms; bound "
          f"{b[0]['bound_ms']:.4f} ms ({b[0]['bound_by']}), mixed "
          f"{b[1]['bound_ms']:.4f} ms ({b[1]['bound_by']}); walk_kernel "
          "registers / spill stores / spill loads / smem bytes: " + ", ".join(
              f"{k} {r['registers']}/{r['spill_stores']}/{r['spill_loads']}/"
              f"{r['smem']}" for k, r in sorted(regs.items())))
    return recs


def instance_name(mangled: str) -> str:
    """walk_kernel<128, kAny, kMixed, kRibbon, kStats>'s instance as
    "walk_kernel closest|any|mixed K<kRibbon>[ stats]" (K0: strand rows),
    block_kernel<128, kAny>'s as "block_kernel closest|any",
    packet_kernel<kAny, kMixed, kNearFirst, kStats>'s (and
    packet_option_kernel's, the instances with an option) as
    "packet_kernel closest|any|mixed[ near-first][ stats]", binned_kernel
    as itself and any other kernel by its mangled name."""
    import re

    def mode(any_, mixed):
        return "mixed" if mixed == "1" else "any" if any_ == "1" else "closest"

    m = re.search(r"walk_kernelILi128ELb(\d)ELb(\d)ELi(\d+)ELb(\d)E",
                  mangled)
    if m is not None:
        any_, mixed, k, st = m.groups()
        return (f"walk_kernel {mode(any_, mixed)} K{k}"
                + (" stats" if st == "1" else ""))
    m = re.search(r"packet_(?:option_)?kernelILb(\d)ELb(\d)ELb(\d)ELb(\d)E",
                  mangled)
    if m is not None:
        any_, mixed, near, st = m.groups()
        return (f"packet_kernel {mode(any_, mixed)}"
                + (" near-first" if near == "1" else "")
                + (" stats" if st == "1" else ""))
    m = re.search(r"block_kernelILi128ELb(\d)E", mangled)
    if m is not None:
        return "block_kernel " + ("any" if m.group(1) == "1" else "closest")
    return "binned_kernel" if "13binned_kernel" in mangled else mangled


# phase 11b's instances, each timed and held to its plain version: name ->
# (ordered, with_stats)
INSTANCES_11B = (("storage", False, False), ("near", True, False),
                 ("storage+stats", False, True), ("near+stats", True, True))


def plain_differs(out: dict, plain_near, plain_storage) -> str:
    """The first of phase 11b's instances (``out``: name -> its result)
    that is not bit for bit its plain version (with stats: ``plain_near``
    or ``plain_storage``; t bits, tri, which holds the blocked bit of a
    shadow lane, and every stats lane where the instance has stats), or
    ""."""
    import torch

    for name, ordered, st in INSTANCES_11B:
        k, p = out[name], plain_near if ordered else plain_storage
        if not (same_bits(k[0], p[0]) and torch.equal(k[1], p[1])
                and (not st or torch.equal(k[2], p[2]))):
            return name
    return ""


def phase_near_route(flat_rec: dict, mixed_rec: dict, mixed_launches: int,
                     errs: dict) -> tuple:
    """Phase 11b: phase 6c's pack and configuration (flat mode, 1080p)
    with RAYTPU_ORDER_MODE=all, set just before and restored just after,
    the counts set to 0 before the frames and read after: every query on
    packet_walk's near-first instance, the PNG equal to 6c's. On 6c's
    primary wave, near-first beside storage order (CUDA events, in turns)
    and each with stats (the counters' cost), each of the 4 timed
    instances then called again as timed and held bit for bit to its
    plain version with stats (``plain_differs``; the ``kernels`` line's
    error is the near-first instance's without stats), near-first to
    storage order on the contract, and the plain near-first walk's bound;
    on 10a's largest mixed query the mixed instances the same way (their
    launches are 3h's, through packet_query); the ratios near-first ÷
    storage order and stats ÷ twin
    of both; and on 6a's primary wave (its frame's largest closest-hit
    query: 65,536 lanes, one sample) both orders' device times
    (``device_times``), for the choice of the default order. Returns the
    two forms' records."""
    import torch

    from raytpu_torch.engine.render import render_frame
    from raytpu_torch.kernels.packet import (
        packet_query_cuda,
        packet_query_torch,
    )

    pack, cam, cfg = flat_rec["pack"], flat_rec["cam"], flat_rec["cfg"]
    with env(RAYTPU_ORDER_MODE="all"):
        reset_launches()
        secs = warm_s(lambda: render_frame(pack, cam, cfg))
        counts = read_launches()
        frame = render_frame(pack, cam, cfg)
    n6 = png_pixels_differ(frame, flat_rec["frame"])
    print(f"phase 11b RAYTPU_ORDER_MODE=all on 6c: frames {secs[0]:.4f} / "
          f"{secs[1]:.4f} s (6c {flat_rec['frame_s'][1]:.4f} s), "
          + launched("11b", counts, ("packet_near",))
          + f"; vs 6c's frame: {n6} PNG pixels differ "
          f"({int(np.any(frame != flat_rec['frame'], -1).sum())} f32 pixels)")
    if n6:
        fail("phase 11b: near-first order's PNG is not storage order's")
    rows8, leaf, first = (pack.bvh.node8_rows, pack.bvh.leaf_tris,
                          pack.bvh.first_slots)
    ro, rd = flat_rec["ro"], flat_rec["rd"]
    n = ro.shape[0]
    tmax = torch.full((n,), F32_MAX, device="cuda")
    wave = (rows8, leaf, first, ro, rd, tmax, 0.001, False)
    calls = {name: lambda o=o, st=st: packet_query_cuda(
        *wave, ordered=o, with_stats=st) for name, o, st in INSTANCES_11B}
    ms = in_turns(calls)
    out = {name: fn() for name, fn in calls.items()}
    plain_ms, p, work = plain_run(lambda c: packet_query_torch(
        *wave, c, ordered=True, with_stats=True))
    p0 = packet_query_torch(*wave, ordered=False, with_stats=True)
    near, store = out["near"], out["storage"]
    bad = plain_differs(out, p, p0)
    if bad or not (same_bits(near[0], store[0]) and torch.equal(
            tie_key(first, near[1]), tie_key(first, store[1]))):
        fail(f"phase 11b: {bad or 'near-first'} != its plain version, or "
             "near-first off storage order on t and the tie key, on 6c's "
             "primary wave")
    errs["packet_near"].append(t_err(near[0], p[0]))
    rec = dict(launches=counts["packet_near"], ms=ms["near"],
               plain_ms=plain_ms, **walk_bound(work, n, 28))
    q = mixed_rec["query"]
    margs = (rows8, leaf, first, *q[:3], q[4], False)
    mkw = dict(smask=q[3], shadow_tmin=q[5])
    mcalls = {name: lambda o=o, st=st: packet_query_cuda(
        *margs, **mkw, ordered=o, with_stats=st)
        for name, o, st in INSTANCES_11B}
    mms = in_turns(mcalls)
    mout = {name: fn() for name, fn in mcalls.items()}
    mplain_ms, mp, mwork = plain_run(lambda c: packet_query_torch(
        *margs, c, **mkw, ordered=True, with_stats=True))
    mp0 = packet_query_torch(*margs, **mkw, ordered=False, with_stats=True)
    mbad = plain_differs(mout, mp, mp0)
    if mbad or not mixed_same(*mout["near"], *mout["storage"], q[3], first):
        fail(f"phase 11b: the mixed {mbad or 'near-first'} kernel != its "
             "plain version, or near-first off storage order, on 10a's "
             "largest mixed query")
    errs["packet_mixed_near"].append(t_err(mout["near"][0], mp[0]))
    mrec = dict(launches=mixed_launches, ms=mms["near"], plain_ms=mplain_ms,
                **walk_bound(mwork, q[0].shape[0], 32))
    k, k0 = out["near+stats"][2], out["storage+stats"][2]
    pops = (int(k0[:, 0].sum()), int(k[:, 0].sum()))
    tests = (int(k0[:, 1].sum()), int(k[:, 1].sum()))
    # 6a's primary wave: the two orders queued behind one sleep, in turns
    a = flat_rec["a_primary"]
    order = [False, True, True, False] * 3
    times = device_times([lambda o=o: packet_query_cuda(*a, ordered=o)
                          for o in order])
    a_ms = {o: sum(t for t, p in zip(times, order) if p == o) / 6
            for o in (False, True)}

    def ratios(m):
        return (f"near ÷ storage {m['near'] / m['storage']:.3f}, stats ÷ "
                f"twin {m['storage+stats'] / m['storage']:.3f} (storage) / "
                f"{m['near+stats'] / m['near']:.3f} (near-first)")
    print(f"phase 11b 6c primary wave ({n} rays): packet_walk near-first "
          f"{ms['near']:.4f} ms, storage order {ms['storage']:.4f} ms; with "
          f"stats {ms['near+stats']:.4f} / {ms['storage+stats']:.4f} ms; "
          f"node pops storage/near-first {pops[0]}/{pops[1]}, leaf-row tests "
          f"{tests[0]}/{tests[1]}; plain {plain_ms:.1f} ms, each instance "
          f"bit-equal to its plain version (t, tri, stats); bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); "
          f"10a's largest mixed query: near-first {mms['near']:.4f} ms, "
          f"storage order {mms['storage']:.4f} ms, plain {mplain_ms:.1f} ms, "
          f"each instance bit-equal to its plain version (t, tri, stats), "
          f"bound {mrec['bound_ms']:.4f} ms ({mrec['bound_by']}); with "
          f"stats {mms['near+stats']:.4f} / {mms['storage+stats']:.4f} ms; "
          f"in turns, primary: {ratios(ms)}; mixed: {ratios(mms)}; 6a's "
          f"primary wave ({a[3].shape[0]} lanes, device times, 6 launches "
          f"each in turns): near-first {a_ms[True]:.4f} ms, storage order "
          f"{a_ms[False]:.4f} ms ({a_ms[True] / a_ms[False]:.3f})")
    return rec, mrec


# phase 12's forms: each one's keywords (phase 3i's sets) and the
# variables that reach it from a frame (none reach fetch_smem: raytpu's
# factories never pass it)
FORM_KW = {"load": SCHED_SETS["no pipe"], "pipe": RAYTPU_SCHED,
           "dual": SCHED_SETS["dual"], "smem": SCHED_SETS["fetch_smem"],
           "wide": SCHED_SETS["ribbon K=4"]}
RAYTPU_ENV = dict(RAYTPU_STRAND_WALKERS="128", RAYTPU_STRAND_SERVICE_K="16",
                  RAYTPU_STRAND_FLUSH="0.5", RAYTPU_STRAND_PIPE="1",
                  RAYTPU_STRAND_UNROLL="4", RAYTPU_STRAND_CTL="1",
                  RAYTPU_STRAND_POP="1", RAYTPU_STRAND_DUAL="0")
FORM_ENV = {"pipe": RAYTPU_ENV, "load": dict(RAYTPU_STRAND_PIPE="0"),
            "dual": dict(RAYTPU_STRAND_PIPE="1", RAYTPU_STRAND_DUAL="1"),
            "wide": dict(RAYTPU_RIBBON="4", RAYTPU_STRAND_WALKERS="128")}
BLOCK_ENV = dict(RAYTPU_STRAND_PERSISTENT="0", RAYTPU_STRAND_GROUPS="16",
                 RAYTPU_STRAND_SKIP_DONE="1")


def phase_schedule_route(main_rec: dict, block_rec: dict, mixed_rec: dict,
                         sched_launches: dict, errs: dict) -> dict:
    """Phase 12: cell 5's pack and 1080p configuration through the schedule
    forms, each variable set just before its frames and restored just
    after, the counts set to 0 before each frame and read after: (a)
    raytpu's defaults set explicitly (RAYTPU_ENV: the pipe form), its PNG
    equal to phase 5's; (b) the block route with RAYTPU_STRAND_GROUPS=16
    RAYTPU_STRAND_SKIP_DONE=1 (the deferral form), its PNG equal to phase
    5b's; (c) RAYTPU_STRAND_PIPE=0 (load), PIPE=1 DUAL=1 (dual) and
    RAYTPU_RIBBON=4 RAYTPU_STRAND_WALKERS=128 (the pool over ribbon rows,
    the K-wide fetch), each PNG equal to phase 5's;
    and (a) and (c) again with bounce_backend="mixed", each PNG equal to
    10a's. Then every form in turns with the default instance (CUDA
    events): the strand forms on phase 5's primary wave and on bounce 1's
    wave (5b's largest sorted closest-hit wave), the mixed forms on 10a's
    largest mixed query, the deferral form on bounce 1's wave; each
    against its plain version there (bit-equal, with its counters). Every
    form is bound by the default instance's plain walk on the same wave:
    the work the function needs, not the extra box tests, prefetches and
    windows its schedule spends. Returns each form's record; the smem
    forms' launches are phase 3i's through the dispatchers."""
    import torch

    from raytpu_torch.engine.render import render_frame
    from raytpu_torch.io.png import quantize_rgba32f
    from raytpu_torch.kernels import strand as S
    from raytpu_torch.types import RenderConfig

    pack, cam = main_rec["pack"], main_rec["cam"]
    cfg = RenderConfig(**MAIN_ARGS)
    mcfg = RenderConfig(**MAIN_ARGS, intersector="packet",
                        bounce_backend="mixed")
    block_png = read_png_rgb(block_rec["png"])
    launches, notes = {}, []

    def frame_of(label, values, config, want, ref):
        with env(**values):
            reset_launches()
            secs = warm_s(lambda: render_frame(pack, cam, config), reps=1)
            counts = read_launches()
            frame = render_frame(pack, cam, config)
        if ref.dtype == np.uint8:  # a decoded PNG
            n = int(np.any(quantize_rgba32f(frame) != ref, axis=-1).sum())
        else:
            n = png_pixels_differ(frame, ref)
        notes.append(f"{label} {secs[0]:.3f} s, "
                     + launched(f"12 {label}", counts, want)
                     + f", {n} PNG pixels differ")
        if n:
            fail(f"phase 12 {label}: the PNG is not its phase's")
        for k in want:
            launches[k] = launches.get(k, 0) + counts[k]

    frame_of("a raytpu defaults", RAYTPU_ENV, cfg, ("strand_pipe",),
             main_rec["frame"])
    frame_of("b block G=16 skip_done", BLOCK_ENV, cfg, ("block_defer",),
             block_png)
    for form in ("load", "dual", "wide"):
        frame_of(f"c {form}", FORM_ENV[form], cfg, (f"strand_{form}",),
                 main_rec["frame"])
    for form in ("pipe", "load", "dual", "wide"):
        frame_of(f"mixed {form}", FORM_ENV[form], mcfg,
                 (f"strand_{form}", f"strand_mixed_{form}"),
                 mixed_rec["frame"])
    launches["strand_smem"] = sched_launches["strand_smem"]
    launches["strand_mixed_smem"] = sched_launches["strand_mixed_smem"]
    print("phase 12 schedule frames (1080p, PNG against phase 5's, 5b's "
          "or 10a's): " + "; ".join(notes))

    leaf, first = pack.bvh.leaf_tris, pack.bvh.first_slots
    rows = {0: pack.bvh.strand_rows,
            pack.bvh.ribbon_rows.shape[0] // 8: pack.bvh.ribbon_rows}
    ro, rd = main_rec["ro"], main_rec["rd"]
    primary = (ro, rd, torch.full((ro.shape[0],), F32_MAX, device="cuda"),
               0.001, False)
    bounce = block_rec["wave"][3:]
    q = mixed_rec["query"]
    recs, lines = {}, []
    for label, kind, wave in (("primary", "strand", primary),
                              ("bounce 1", "strand", bounce),
                              ("mixed", "strand_mixed", q)):
        kernel = (S.strand_query_cuda if kind == "strand"
                  else S.strand_mixed_query_cuda)
        plain = (S.strand_query_torch if kind == "strand"
                 else S.strand_mixed_query_torch)
        calls = {"default": lambda: kernel(rows[0], leaf, first, *wave)}
        for form, kw in FORM_KW.items():
            tree, k = sched_rows(kw, rows)
            calls[form] = (lambda tree=tree, k=k:
                           kernel(tree, leaf, first, *wave, **k))
        if label == "bounce 1":
            calls["block"] = lambda: S.strand_block_query_cuda(
                rows[0], leaf, first, *wave)
            calls["defer"] = lambda: S.strand_block_query_cuda(
                rows[0], leaf, first, *wave,
                **DEFER_SETS["G=16 skip_done"])
        ms = in_turns(calls)
        lines.append(f"{label} ({wave[0].shape[0]} rays): " + ", ".join(
            f"{k} {v:.4f}" for k, v in ms.items()))
        recs[label] = ms
        if label == "bounce 1":
            continue
        base = calls["default"]()
        _, _, work = plain_run(lambda c: plain(rows[0], leaf, first, *wave,
                                               c))
        for form, kw in FORM_KW.items():
            tree, k = sched_rows(kw, rows)
            key = f"{kind}_{form}"
            got = kernel(tree, leaf, first, *wave, stats=True, **k)
            plain_ms, p, _ = plain_run(lambda c: plain(
                tree, leaf, first, *wave, c, stats=True, **k))
            if not (same_bits(got[0], p[0]) and torch.equal(got[1], p[1])
                    and torch.equal(got[2], p[2])):
                fail(f"phase 12 {label} {form}: kernel != plain")
            bad = agree("mixed" if kind == "strand_mixed" else "closest",
                        got, base, first, q[3] if kind == "strand_mixed"
                        else None)
            if bad:
                fail(f"phase 12 {label} {form}: {bad} lanes differ from "
                     "the default instance")
            errs[key].append(t_err(got[0], p[0]))
            recs[key] = dict(launches=launches[key], ms=ms[form],
                             plain_ms=plain_ms, stats=got[2].tolist(),
                             **walk_bound(work, wave[0].shape[0],
                                          32 if kind == "strand_mixed"
                                          else 28))
    # the deferral form on bounce 1's wave, held as phase 5b holds the
    # block walk: to its plain version, bound by the per-ray walk's work
    tree, leaf_b, first_b, bro, brd, btmax, btmin, bany = block_rec["wave"]
    kw = DEFER_SETS["G=16 skip_done"]
    got = S.strand_block_query_cuda(*block_rec["wave"], True, **kw)
    plain_ms, p, _ = plain_run(lambda c: S.strand_block_query_torch(
        *block_rec["wave"], True, **kw))
    torch.cuda.synchronize()
    if not (same_bits(got[0], p[0]) and torch.equal(got[1], p[1])
            and torch.equal(got[2], p[2])):
        fail("phase 12: strand_block's deferral form != its plain version "
             "on bounce 1's wave")
    errs["block_defer"].append(t_err(got[0], p[0]))
    recs["block_defer"] = dict(
        launches=launches["block_defer"], ms=recs["bounce 1"]["defer"],
        plain_ms=plain_ms, **{k: block_rec[k] for k in (
            "bound_ms", "bound_by", "n_bytes", "n_ops", "bytes_ms",
            "ops_ms")})
    print("phase 12 in turns with the default instances (ms a launch, CUDA "
          "events): " + " | ".join(lines))
    print("phase 12 forms vs plain (bit-equal with counters): " + "; ".join(
        f"{KERNELS[k]['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.1f} "
        f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
        + (f", counters {r['stats']}" if "stats" in r else "")
        for k, r in recs.items() if k in KERNELS)
        + f"; block deferral leaf rounds per block mean "
        f"{float(got[2][:, 2].double().mean()):.1f}")
    return recs


def phase_step_bench(errs: list) -> dict:
    """Phase 8: the per-step probe. Every arm on the card against its
    plain replay (the final scratch and the last carry bit-equal) at W =
    8, 40, 128 and 1024 and 1 and 16 iterations, each launch's grid
    printed; then ``measure`` over every arm at W = 128, 2000 iterations
    (raytpu's defaults), the table printed, and the full arm's plain
    replay at that size on the card, bit-equal and timed once."""
    import torch

    from raytpu_torch.tools import step_bench as sb

    tree = sb.make_tree("cuda")
    for walkers in (8, 40, 128, 1024):
        shapes = []
        for arm in sb.ARMS:
            geo = sb.launch_geometry(arm, walkers)
            shapes.append(f"{arm} {geo['grid']}x{geo['warps']}x"
                          f"{geo['rows']}")
            for iters in (1, 16):
                out_k, acc_k, cycles = sb.step_bench_cuda(tree, arm, iters,
                                                          walkers)
                out_p, acc_p = sb.step_bench_torch(tree, arm, iters, walkers)
                torch.cuda.synchronize()
                if not (same_bits(out_k, out_p) and same_bits(acc_k, acc_p)
                        and int(cycles) > 0):
                    fail(f"step_bench {arm}: kernel != plain replay at W "
                         f"{walkers}, {iters} iterations "
                         f"({int((out_k != out_p).sum())} scratch, "
                         f"{int((acc_k != acc_p).sum())} carry elements "
                         f"differ; {int(cycles)} cycles)")
                errs.append(max(t_err(out_k, out_p), t_err(acc_k, acc_p)))
        print(f"phase 8 step_bench W {walkers}: {len(sb.ARMS)} arms "
              "bit-equal to their plain replays at 1 and 16 iterations; "
              "blocks x warps x rows: " + ", ".join(shapes))
    walkers, iters = 128, 2000
    reset_launches()
    rows = sb.measure(sb.ARMS, walkers, iters, repeats=5)
    torch.cuda.synchronize()
    launches = read_launches()["step"]
    print(f"phase 8 step_bench: W {walkers}, {iters} iterations, "
          f"{launches} launches, launch floors "
          f"{min(r['floor_ms'] for r in rows):.4f}-"
          f"{max(r['floor_ms'] for r in rows):.4f} ms:")
    print(sb.format_table(rows))
    full = rows[0]
    plain_ms = cuda_ms(lambda: sb.step_bench_torch(tree, "full", iters,
                                                   walkers), reps=1)
    out_k, acc_k, _ = sb.step_bench_cuda(tree, "full", iters, walkers)
    out_p, acc_p = sb.step_bench_torch(tree, "full", iters, walkers)
    if not (same_bits(out_k, out_p) and same_bits(acc_k, acc_p)):
        fail("step_bench full: kernel != plain replay at W 128")
    errs.append(max(t_err(out_k, out_p), t_err(acc_k, acc_p)))
    print(f"phase 8 full arm: kernel {full['ms']:.4f} ms "
          f"({full['shape']}), plain replay {plain_ms:.1f} ms, bit-equal")
    return dict(launches=launches, ms=full["ms"], plain_ms=plain_ms,
                **bound(nbytes(tree, out_k, acc_k),
                        iters * walkers * 128 * STEP_FULL_OPS))


def write_multi_mesh(path: str):
    """tests/test_goldens.py's multi-mesh scene: a red box on a grey floor,
    an emissive lamp box, one light and a glTF camera; 26 triangles."""
    GlbBuilder, box, quad = _writer()
    b = GlbBuilder()
    red = b.add_material(color=(0.8, 0.2, 0.2, 1.0))
    grey = b.add_material(color=(0.7, 0.7, 0.7, 1.0))
    glow = b.add_material(color=(1.0, 0.9, 0.6, 1.0), emission=4.0)
    bpos, bnrm, buv, bidx = box(1.0)
    qpos, qnrm, quv, qidx = quad(6.0, z=-1.0)
    lpos, lnrm, luv, lidx = box(0.3)
    b.add_node(mesh=b.add_mesh([(bpos, bnrm, buv, bidx, red, np.uint16)]))
    b.add_node(mesh=b.add_mesh([(qpos, qnrm, quv, qidx, grey, np.uint16)]),
               rotation=(-0.7071068, 0.0, 0.0, 0.7071068))
    b.add_node(mesh=b.add_mesh([(lpos, lnrm, luv, lidx, glow, np.uint16)]),
               translation=(1.5, 1.5, -1.0))
    b.add_node(light=b.add_light(color=(1.0, 1.0, 1.0), intensity=50.0),
               translation=(0.0, 3.0, -3.0))
    b.add_node(camera=b.add_camera(aspect=1.0, yfov=0.6),
               translation=(0.0, 0.5, 6.0))
    b.write(path)


def warm_s(render, reps: int = 2) -> list:
    """Host seconds of each of ``reps`` calls of ``render``, each ending in
    a synchronise (the first is the warm-up)."""
    import torch

    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs


def launched(label: str, counts: dict, want: tuple) -> str:
    """Fail unless every kernel in ``want`` launched in the run and no
    other did; the counts as a note."""
    used = {k for k, n in counts.items() if n}
    if used != set(want):
        fail(f"phase {label}: launched {sorted(used)}, want {sorted(want)}")
    return (", ".join(f"{counts[k]} {KERNELS[k]['name']}" for k in want)
            or "no kernel launches")


def phase_bvh_route(tmp: str) -> tuple:
    """Phase 9a: the threaded-BVH route (plain torch ops, no kernel) on the
    card. One 128x128 primary wave of a 2.6k-triangle gallery (> 2048
    slots) through ``intersect_bvh`` on the card and on the CPU: tri and t
    bits equal, closest and any-hit. Then a 64x64 frame with
    ``intersector="bvh"``, card vs CPU within tests/imgdiff.py's bar, and
    its warm time. Returns the scene's path (for 9d, 9e and 9g) and the
    card's frame (for 9g)."""
    import torch

    from raytpu_torch.engine.render import render_frame
    from raytpu_torch.kernels.intersect import intersect_bvh
    from raytpu_torch.scene.camera import camera_from_lookat
    from raytpu_torch.scene.gltf import load_scene
    from raytpu_torch.scene.pack import pack_camera, pack_scene
    from raytpu_torch.types import RenderConfig

    glb = os.path.join(tmp, "gallery36.glb")
    write_gallery(glb, cells=36)
    scene = load_scene(glb)
    packs = {dev: pack_scene(scene, dev) for dev in ("cuda", "cpu")}
    slots = packs["cpu"].n_triangles
    if slots <= 2048:
        fail(f"phase 9a: {slots} slots, want > 2048")
    eye, at, fov = GALLERY_CAM["origin"], GALLERY_CAM["at"], GALLERY_CAM["fov"]
    ro, rd = primary_wave(pack_camera(camera_from_lookat(eye, at, fov, 128,
                                                         128), "cuda"),
                          128, 128, 16, 1)
    tmax = torch.full((ro.shape[0],), F32_MAX, device="cuda")
    shadow = torch.full((ro.shape[0],), 4.0, device="cuda")
    reset_launches()
    t0 = time.perf_counter()
    card = intersect_bvh(ro, rd, packs["cuda"].bvh, 0.001, tmax)
    blocked = intersect_bvh(ro, rd, packs["cuda"].bvh, 0.0, shadow,
                            any_hit=True)
    torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    wave_counts = read_launches()
    cpu = intersect_bvh(ro.cpu(), rd.cpu(), packs["cpu"].bvh, 0.001,
                        tmax.cpu())
    blocked_cpu = intersect_bvh(ro.cpu(), rd.cpu(), packs["cpu"].bvh, 0.0,
                                shadow.cpu(), any_hit=True)
    if not (torch.equal(card.tri.cpu(), cpu.tri)
            and same_bits(card.t.cpu(), cpu.t)
            and torch.equal(blocked.cpu(), blocked_cpu)):
        fail("phase 9a: intersect_bvh on the card != on the CPU")
    hits = float(cpu.valid.float().mean())
    cfg = RenderConfig(width=64, height=64, seed=3, samples=1, bounces=4,
                       chunk_size=16, intersector="bvh")
    cams = {dev: pack_camera(camera_from_lookat(eye, at, fov, 64, 64), dev)
            for dev in packs}
    reset_launches()
    secs = warm_s(lambda: render_frame(packs["cuda"], cams["cuda"], cfg))
    counts = read_launches()
    frame = render_frame(packs["cuda"], cams["cuda"], cfg)
    n_diff, frac, s = png_diff(frame, render_frame(packs["cpu"], cams["cpu"],
                                                   cfg))
    lit = float((frame[..., :3].max(-1) > 0).mean())
    print(f"phase 9a bvh route: {slots} slots; {ro.shape[0]}-ray primary "
          f"wave, closest and any-hit, {wave_s:.3f} s on the card, tri, t "
          f"bits and blocked bit equal to the CPU's ({hits:.3f} hit); 64x64 "
          f"1spp 4 bounces frame {secs[0]:.3f} s cold, {secs[1]:.3f} s warm, "
          f"{lit:.3f} non-black, card vs CPU {n_diff} PNG pixels differ "
          f"({frac:.4f}), SSIM {s:.5f}; "
          + launched("9a", {k: wave_counts[k] + counts[k] for k in counts},
                     ()))
    if frac > 0.02 or s < 0.99 or lit < 0.3:
        fail("phase 9a: the card's bvh frame is off the CPU's")
    return glb, frame


class interrupted:
    """Context manager: ``engine.progressive``'s tile generator stops with
    KeyboardInterrupt after ``n`` tiles, as a killed render stops."""

    def __init__(self, n: int):
        self.n = n

    def __enter__(self):
        from raytpu_torch.engine import progressive

        self.mod, self.real = progressive, progressive.render_frame_tiles

        def tiles(*args, **kwargs):
            for i, item in enumerate(self.real(*args, **kwargs)):
                if i == self.n:
                    raise KeyboardInterrupt
                yield item

        progressive.render_frame_tiles = tiles

    def __exit__(self, *exc):
        self.mod.render_frame_tiles = self.real


def phase_checkpoint(tmp: str, main_rec: dict) -> None:
    """Phase 9b: checkpoint/resume on phase 5's gallery at 640x360, 1 spp,
    4 bounces, ``tile_rows=90`` (4 tiles): interrupted after 2 tiles and
    resumed, bit-equal to the uninterrupted frame and to render_frame."""
    import torch

    from raytpu_torch.engine.progressive import render_with_checkpoint
    from raytpu_torch.engine.render import render_frame
    from raytpu_torch.scene.camera import load_camera_json
    from raytpu_torch.scene.pack import pack_camera
    from raytpu_torch.types import RenderConfig

    pack = main_rec["pack"]
    cam = pack_camera(load_camera_json(main_rec["cam_json"], 640, 360),
                      "cuda")
    cfg = RenderConfig(width=640, height=360, seed=1, samples=1, bounces=4,
                       chunk_size=8, tile_rows=90)
    plain_s = warm_s(lambda: render_frame(pack, cam, cfg))
    plain = render_frame(pack, cam, cfg)
    fresh = (os.path.join(tmp, f"whole{i}.npz") for i in range(3))
    reset_launches()
    whole_s = warm_s(lambda: render_with_checkpoint(pack, cam, cfg,
                                                    next(fresh)))
    whole = render_with_checkpoint(pack, cam, cfg, next(fresh))
    ck = os.path.join(tmp, "ck.npz")
    t0 = time.perf_counter()
    try:
        with interrupted(2):
            render_with_checkpoint(pack, cam, cfg, ck)
        fail("phase 9b: the interrupted render ran to its end")
    except KeyboardInterrupt:
        pass
    with np.load(ck) as saved:
        saved_y0 = int(saved["next_y0"])
    resumed = render_with_checkpoint(pack, cam, cfg, ck)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    counts = read_launches()
    lit = float((plain[..., :3].max(-1) > 0).mean())
    print(f"phase 9b checkpoint: 640x360 1spp 4 bounces in 4 tiles; "
          f"render_frame {plain_s[1]:.3f} s warm, render_with_checkpoint "
          f"{whole_s[1]:.3f} s warm; interrupted after 2 tiles (next_y0 "
          f"{saved_y0}) and resumed, {resume_s:.3f} s in all; resumed == "
          f"uninterrupted == render_frame bit for bit: "
          f"{np.array_equal(resumed, whole) and np.array_equal(whole, plain)}"
          f", {lit:.3f} non-black; " + launched("9b", counts, ("strand",)))
    if saved_y0 != 180 or not (np.array_equal(resumed, whole)
                               and np.array_equal(whole, plain)):
        fail("phase 9b: the resumed frame is not the uninterrupted one")


def phase_shards(main_rec: dict) -> None:
    """Phase 9c: ``render_frame_sharded`` on phase 5's gallery at 640x360,
    2 spp, 4 bounces: rows over ["cuda:0"] * 2 (raytpu's bar, rtol 2e-6,
    atol 1e-7, bit-equal count printed), rows x spp over 2 x 2 (mean within
    0.05), and all devices by default (``n_devices`` = device count)."""
    import torch

    from raytpu_torch.engine.render import render_frame
    from raytpu_torch.parallel.shard import render_frame_sharded
    from raytpu_torch.scene.camera import load_camera_json
    from raytpu_torch.scene.pack import pack_camera
    from raytpu_torch.types import RenderConfig

    pack = main_rec["pack"]
    cam = pack_camera(load_camera_json(main_rec["cam_json"], 640, 360),
                      "cuda")
    cfg = RenderConfig(width=640, height=360, seed=1, samples=2, bounces=4,
                       chunk_size=8)
    single_s = warm_s(lambda: render_frame(pack, cam, cfg))
    single = render_frame(pack, cam, cfg)
    runs = {"rows 2": dict(devices=["cuda:0"] * 2),
            "rows 2 x spp 2": dict(devices=["cuda:0"] * 4,
                                   n_sample_shards=2),
            f"n_devices {torch.cuda.device_count()}": dict(
                n_devices=torch.cuda.device_count())}
    notes = []
    for label, kw in runs.items():
        reset_launches()
        secs = warm_s(lambda: render_frame_sharded(pack, cam, cfg, **kw))
        counts = read_launches()
        out = render_frame_sharded(pack, cam, cfg, **kw)
        if "spp" in label:
            dmean = abs(float(out.mean()) - float(single.mean()))
            ok = out.shape == single.shape and dmean < 0.05
            note = f"mean off by {dmean:.5f}"
        else:
            ok = bool(np.allclose(out, single, rtol=2e-6, atol=1e-7))
            n_eq = int(np.all(out == single, -1).sum())
            note = (f"within rtol 2e-6/atol 1e-7: {ok}, {n_eq} of "
                    f"{out.shape[0] * out.shape[1]} pixels bit-equal")
        notes.append(f"{label}: {secs[1]:.3f} s warm, {note}, "
                     + launched("9c " + label, counts, ("strand",)))
        if not ok:
            fail(f"phase 9c {label}: off the single-device frame")
    print(f"phase 9c shards: 640x360 2spp 4 bounces, single device "
          f"{single_s[1]:.3f} s warm; " + "; ".join(notes)
          + ". One card: distinct-device threads are not exercised")


def phase_cli_flags(tmp: str, glb: str) -> None:
    """Phase 9d/9e: the CLI on 9a's 2.6k-triangle gallery at 640x360, 1
    spp, 4 bounces: plain, with ``--profile`` (the trace must exist and
    name strand_walk's kernel) and with ``--gui`` on a host without a
    display (DISPLAY unset, matplotlib on Agg): both PNGs equal the plain
    one."""
    cam_json = os.path.join(tmp, "camera9.json")
    with open(cam_json, "w") as f:
        json.dump(GALLERY_CAM, f)
    args = dict(width=640, height=360, seed=1, chunk_size=8, samples=1,
                bounces=4)
    pngs = {k: os.path.join(tmp, f"cli9_{k}.png")
            for k in ("plain", "profile", "gui")}
    plain_s, counts = run_cli(cli_argv(glb, pngs["plain"], args, cam_json))
    launched("9d plain", counts, ("strand",))
    prof = os.path.join(tmp, "prof")
    prof_s, counts = run_cli(cli_argv(glb, pngs["profile"], args, cam_json)
                             + ["--profile", prof])
    traces = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    if len(traces) != 1:
        fail(f"phase 9d: {len(traces)} trace files in --profile's directory")
    path = os.path.join(prof, traces[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    walks = sum("walk_kernel" in e.get("name", "") for e in kernels)
    same = read_png_rgb(pngs["profile"]).tobytes() == read_png_rgb(
        pngs["plain"]).tobytes()
    print(f"phase 9d --profile: rc 0 in {prof_s:.2f} s (plain {plain_s:.2f} "
          f"s); trace {traces[0]} {os.path.getsize(path) / 1e6:.1f} MB, "
          f"{len(events)} events, {len(kernels)} device kernels, {walks} "
          f"named walk_kernel (strand_walk); PNG equals the plain run's: "
          f"{same}; " + launched("9d", counts, ("strand",)))
    if not walks or not same:
        fail("phase 9d: the trace names no strand_walk launch, or the PNG "
             "differs")
    saved = {k: os.environ.pop(k, None) for k in ("DISPLAY",
                                                  "WAYLAND_DISPLAY")}
    try:
        with env(MPLBACKEND="Agg"):
            gui_s, counts = run_cli(cli_argv(glb, pngs["gui"], args,
                                             cam_json) + ["--gui"])
    finally:
        os.environ.update({k: v for k, v in saved.items() if v is not None})
    same = read_png_rgb(pngs["gui"]).tobytes() == read_png_rgb(
        pngs["plain"]).tobytes()
    print(f"phase 9e --gui, no display: rc 0 in {gui_s:.2f} s; PNG equals "
          f"the plain run's: {same}; " + launched("9e", counts, ("strand",)))
    if not same:
        fail("phase 9e: the --gui PNG differs from the plain run's")


def phase_oracle(tmp: str) -> None:
    """Phase 9f: a card frame of the multi-mesh scene at 32x32, 2 spp, 3
    bounces against the port's copy of raytpu's scalar oracle: SSIM >= 0.99
    on the PNG pixels, at most 4% of pixels beyond 1e-3."""
    import torch

    from raytpu_torch import render
    from raytpu_torch.oracle.reference import OracleRenderer
    from raytpu_torch.scene.gltf import load_scene
    from raytpu_torch.types import RenderConfig

    glb = os.path.join(tmp, "multi.glb")
    write_multi_mesh(glb)
    scene = load_scene(glb)
    cfg = RenderConfig(width=32, height=32, seed=3, samples=2, bounces=3,
                       chunk_size=16)
    reset_launches()
    frame = render(scene, scene.camera, cfg)
    torch.cuda.synchronize()
    counts = read_launches()
    t0 = time.perf_counter()
    ref = OracleRenderer(scene, scene.camera).render(32, 32, 3, 2, 3, 16)
    oracle_s = time.perf_counter() - t0
    _, frac, s = png_diff(frame, ref)
    beyond = float(np.mean(np.abs(frame - ref).max(-1) > 1e-3))
    lit = float((ref[..., :3].max(-1) > 0).mean())
    print(f"phase 9f oracle: multi-mesh 32x32 2spp 3 bounces, card vs the "
          f"oracle copy ({oracle_s:.1f} s on the host): SSIM {s:.5f}, "
          f"{beyond:.4f} of pixels beyond 1e-3, {frac:.4f} of PNG pixels "
          f"differ, {lit:.3f} non-black; " + launched("9f", counts,
                                                       ("packet",)))
    if s < 0.99 or beyond > 0.04 or lit < 0.1:
        fail("phase 9f: the card's frame is off the oracle")


def phase_pack_options(tmp: str, glb: str, bvh_frame) -> None:
    """Phase 9g: pack_scene's options on the card, on 9a's 4,096-slot
    gallery. (1) The ``bvh`` route needs the leaf rows, which a stream pack
    keeps for its strand tree: with RAYTPU_SORT_MIN_TRIS above the slot
    count no strand tree is built, a ``tables="stream"`` pack drops them
    and ``intersector="bvh"`` raises the advice to repack with
    ``tables="all"``, and the ``"all"`` pack renders 9a's frame. (2) An
    ``as_numpy`` pack, pickled and moved with ``.to("cuda")`` (and one
    left for ``render_frame`` to move), renders the PNG of
    ``pack_scene(scene, "cuda")`` at 256x256. (3) ``auto`` on a
    ``treelets="never"`` pack with the pack budget and the packet budget
    shrunk to 64 KiB: no stream, no strand tree, and raytpu's TPU branch
    ends at ``bvh`` (above 2048 slots): 9a's frame, no kernel launched.
    (4) The CLI at 9d's settings in a child process under
    ``RAYTPU_NO_NATIVE=1``: the pure-Python builder's pack on the card,
    its PNG within tests/imgdiff.py's bar of 9d's."""
    import pickle

    import torch

    from raytpu_torch.engine.render import render_frame
    from raytpu_torch.io.metrics import psnr, ssim
    from raytpu_torch.io.png import quantize_rgba32f
    from raytpu_torch.kernels import packet
    from raytpu_torch.scene import pack as pack_mod
    from raytpu_torch.scene.camera import camera_from_lookat
    from raytpu_torch.scene.gltf import load_scene
    from raytpu_torch.scene.pack import pack_camera, pack_scene
    from raytpu_torch.types import RenderConfig

    scene = load_scene(glb)
    eye, at, fov = GALLERY_CAM["origin"], GALLERY_CAM["at"], GALLERY_CAM["fov"]
    cam64 = pack_camera(camera_from_lookat(eye, at, fov, 64, 64), "cuda")
    bvh_cfg = RenderConfig(width=64, height=64, seed=3, samples=1,
                           bounces=4, chunk_size=16, intersector="bvh")
    with env(RAYTPU_SORT_MIN_TRIS="8192"):
        stream = pack_scene(scene, "cuda", tables="stream")
        full = pack_scene(scene, "cuda", tables="all")
        try:
            render_frame(stream, cam64, bvh_cfg)
            fail("phase 9g: the bvh route took a stream pack without leaf "
                 "rows")
        except ValueError as e:
            advice = str(e)
        if "tables='all'" not in advice:
            fail(f"phase 9g: the bvh route's error gives no advice: {advice}")
        reset_launches()
        all_frame = render_frame(full, cam64, bvh_cfg)
        torch.cuda.synchronize()
        launched("9g all", read_launches(), ())
    all_same = np.array_equal(all_frame, bvh_frame)
    print(f"phase 9g tables: stream pack (no strand tree) with "
          f"intersector='bvh' raises ({advice!r}); the tables='all' pack "
          f"renders 9a's bvh frame bit for bit: {all_same}")
    if not all_same:
        fail("phase 9g: the tables='all' pack's bvh frame is not 9a's")

    cfg = RenderConfig(width=256, height=256, seed=1, samples=1, bounces=4,
                       chunk_size=16)
    cam = pack_camera(camera_from_lookat(eye, at, fov, 256, 256), "cuda")
    t0 = time.perf_counter()
    blob = pickle.dumps(pack_scene(scene, as_numpy=True))
    host = pickle.loads(blob)
    host_s = time.perf_counter() - t0
    reset_launches()
    want = quantize_rgba32f(render_frame(pack_scene(scene, "cuda"), cam,
                                         cfg))
    direct = read_launches()
    t0 = time.perf_counter()
    moved = host.to("cuda")
    torch.cuda.synchronize()
    move_s = time.perf_counter() - t0
    reset_launches()
    got = [quantize_rgba32f(render_frame(p, cam, cfg)) for p in (moved,
                                                                   host)]
    torch.cuda.synchronize()
    counts = read_launches()
    same = [bool(np.array_equal(g, want)) for g in got]
    print(f"phase 9g as_numpy: pack + pickle round trip {host_s:.2f} s "
          f"({len(blob) / 2**20:.1f} MiB), .to('cuda') {move_s:.3f} s; "
          f"256x256 1spp 4 bounces: the moved pack's PNG equals the direct "
          f"pack's: {same[0]}, the numpy pack's through render_frame: "
          f"{same[1]}; " + launched("9g as_numpy", counts, ("strand",))
          + " (direct: " + launched("9g direct", direct, ("strand",)) + ")")
    if not all(same) or not host.on_host:
        fail("phase 9g: a numpy pack's frame differs from the direct pack's")

    saved = pack_mod.TABLE_BUDGET, packet.PACKET_TABLE_BUDGET
    pack_mod.TABLE_BUDGET = packet.PACKET_TABLE_BUDGET = 64 * 1024
    try:
        never = pack_scene(scene, "cuda", treelets="never")
        reset_launches()
        auto_frame = render_frame(never, cam64, dataclasses.replace(
            bvh_cfg, intersector="auto"))
        torch.cuda.synchronize()
        note = launched("9g never", read_launches(), ())
    finally:
        pack_mod.TABLE_BUDGET, packet.PACKET_TABLE_BUDGET = saved
    tables = {k: getattr(never.bvh, k) is not None
              for k in ("node8_rows", "strand_rows", "ribbon_rows")}
    auto_same = np.array_equal(auto_frame, bvh_frame)
    print(f"phase 9g budget: treelets='never' pack under a 64 KiB budget: "
          f"{tables}; auto renders 9a's bvh frame bit for bit: {auto_same} "
          f"({note})")
    if (not auto_same or tables != dict(node8_rows=True, strand_rows=False,
                                        ribbon_rows=False)):
        fail("phase 9g: auto did not take raytpu's TPU route (bvh) on an "
             "over-budget pack without treelets")

    cam_json = os.path.join(tmp, "camera9.json")
    png = os.path.join(tmp, "cli9_no_native.png")
    argv = cli_argv(glb, png, dict(width=640, height=360, seed=1,
                                   chunk_size=8, samples=1, bounces=4),
                    cam_json)
    code = ("import sys\n"
            "from raytpu_torch import cli, native\n"
            "assert not native.native_available()\n"
            "sys.exit(cli.main(sys.argv[1:]))\n")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code, *argv],
                       cwd=os.path.dirname(os.path.abspath(__file__)),
                       env=dict(os.environ, RAYTPU_NO_NATIVE="1"),
                       capture_output=True, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"phase 9g: the RAYTPU_NO_NATIVE=1 CLI run exited "
             f"{r.returncode}: {r.stderr[-2000:]}")
    a = read_png_rgb(png)
    b = read_png_rgb(os.path.join(tmp, "cli9_plain.png"))
    frac = float(np.any(a != b, axis=-1).mean())
    s, p = ssim(a, b), psnr(a, b)
    print(f"phase 9g RAYTPU_NO_NATIVE=1: the CLI in a child process (the "
          f"pure-Python builder) rc 0 in {child_s:.1f} s; vs 9d's PNG "
          f"{frac:.5f} of pixels differ, SSIM {s:.5f}, PSNR {p:.2f} dB")
    if frac > 0.02 or s < 0.99:
        fail("phase 9g: the pure-Python builder's frame is off 9d's")


# bench.py's configs 5 (:402-409) and 6 (:412-440) on raytpu's atrium
ATRIUM_TRIS = 250_000
STREAM_TRIS = 2_900_000
ATRIUM_ARGS = dict(width=1920, height=1080, seed=1, samples=1, bounces=4,
                   chunk_size=8)
STREAM_ARGS = dict(ATRIUM_ARGS, width=640, height=360)
# pack_scene's steps, timed apart (phase 13)
PACK_STEPS = ("flatten_world_triangles", "build_bvh", "bvh8_depth",
              "build_treelets", "build_strand_tree", "build_ribbon_tree",
              "first_slots")
# 13c's timing: launches queued together, and repeats of that
WAVE_INNER, WAVE_REPEATS = 32, 3


def pack_in_steps(scene, **kw) -> tuple:
    """``pack_scene(scene, "cuda", **kw)`` with each of PACK_STEPS timed:
    (pack, seconds, {step: seconds}, build_treelets's arguments)."""
    import torch

    from raytpu_torch.scene.pack import pack_scene

    tl_args = []
    with contextlib.ExitStack() as stack:
        steps = {n: stack.enter_context(timed_treelets(
            n, args=tl_args if n == "build_treelets" else None))
            for n in PACK_STEPS}
        t0 = time.perf_counter()
        pack = pack_scene(scene, "cuda", **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    return pack, secs, {n: sum(v) for n, v in steps.items()}, tl_args


def steps_note(steps: dict) -> str:
    return ", ".join(f"{k} {v:.2f} s" for k, v in steps.items() if v)


def bench_frames(label: str, pack, cam, cfg, want: tuple) -> dict:
    """bench.py's timing of one config: a cold frame, then two warm frames
    (its ``repeats=2``), through ``render_frame``, every launch count set
    to 0 just before and read just after (``want`` the kernels that must
    launch, and no other); ``count_rays`` and Mrays/s per warm frame, the
    PNG's non-black share. Prints one line; returns the figures."""
    import torch

    from raytpu_torch.engine.render import WAVE_STATS, count_rays, render_frame
    from raytpu_torch.io.png import quantize_rgba32f

    reset_launches()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        frame = render_frame(pack, cam, cfg)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    counts = read_launches()
    waves = dict(WAVE_STATS)
    note = launched(label, counts, want)
    rays = count_rays(pack, cam, cfg)
    lit = float((quantize_rgba32f(frame).max(-1) > 0).mean())
    mrays = [rays / s / 1e6 for s in secs[1:]]
    print(f"phase {label} frames: {cfg.width}x{cfg.height} {cfg.samples}spp "
          f"{cfg.bounces} bounces chunk {cfg.chunk_size} "
          f"intersector='{cfg.intersector}': cold {secs[0]:.3f} s, warm "
          f"{secs[1]:.4f} / {secs[2]:.4f} s; count_rays {rays}: "
          f"{mrays[0]:.2f} / {mrays[1]:.2f} Mrays/s; wave mode "
          f"'{waves['mode']}', work width per bounce {waves['widths']}; "
          f"{note} in the 3 frames; {lit:.3f} of PNG pixels non-black")
    if not np.isfinite(frame).all() or lit <= 0.10:
        fail(f"phase {label}: the frame is not finite or mostly black")
    return dict(frame=frame, secs=secs, rays=rays, mrays=mrays, counts=counts,
                waves=waves, lit=lit)


def strand_primary(label: str, pack, cam, cfg, errs: list) -> None:
    """The frame's primary wave through strand_walk and its plain version
    (bit-equal, ``wave_check``, with a SAMPLE held to the brute sweep), and
    fault 3.4's lost rays over the whole wave (``lost_hits``: the plain
    walk with the unrepaired box test and identity keys on every ray, the
    brute sweep wherever it differs)."""
    import torch

    from raytpu_torch.kernels.strand import strand_query_cuda, strand_query_torch

    tables = (pack.bvh.strand_rows, pack.bvh.leaf_tris, pack.bvh.first_slots)
    ro, rd = primary_wave(cam, cfg.width, cfg.height, cfg.chunk_size,
                          cfg.seed)
    ms, plain_ms, bad, bnd = wave_check("strand", tables, pack, ro, rd, errs)
    print(f"phase {label} primary wave {ro.shape[0]} rays: strand_walk "
          f"{ms:.4f} ms, plain {plain_ms:.1f} ms, bit-equal; vs brute on "
          f"{SAMPLE} rays: {bad} mismatches; plain-walk work {bnd['boxes']} "
          f"box / {bnd['tris']} triangle tests, bound {bnd['bound_ms']:.4f} "
          f"ms ({bnd['bound_by']})")
    if bad:
        fail(f"phase {label}: strand_walk disagrees with the brute sweep")
    tmax = torch.full((ro.shape[0],), F32_MAX, device="cuda")
    right = strand_query_cuda(*tables, ro, rd, tmax, 0.001, False)

    def run(idx, keys, box):
        with contextlib.nullcontext() if box else unrepaired_box_test():
            return strand_query_torch(tables[0], tables[1], keys, ro[idx],
                                      rd[idx], tmax[idx], 0.001, False)

    lost_hits(f"{label} primary wave", pack, ro, rd, right, run, fault="3.4")


def strand_bounce_lost_hits(label: str, pack, calls: list) -> dict:
    """Fault 3.4 (``lost_hits``) on every live lane of every recorded
    closest-hit strand query of a frame after the primary one
    (``recorded_queries``), as one wave: strand_walk's results against the
    plain walk with the unrepaired box test and identity keys."""
    import torch

    from raytpu_torch.kernels.strand import strand_query_cuda, strand_query_torch

    bounce = [a for a in calls[1:] if not a[7]]
    if {a[6] for a in bounce} != {0.001}:
        fail(f"phase {label}: a bounce query with another tmin")
    lanes = [(a[5] > 0.0).nonzero().squeeze(1) for a in bounce]
    ro, rd, tmax = (torch.cat([a[k][i] for a, i in zip(bounce, lanes)])
                    for k in (3, 4, 5))
    tree, leaf, first = pack.bvh.strand_rows, pack.bvh.leaf_tris, \
        pack.bvh.first_slots
    right = strand_query_cuda(tree, leaf, first, ro, rd, tmax, 0.001, False)

    def run(idx, keys, box):
        with contextlib.nullcontext() if box else unrepaired_box_test():
            return strand_query_torch(tree, leaf, keys, ro[idx], rd[idx],
                                      tmax[idx], 0.001, False)

    sizes = ", ".join(str(i.numel()) for i in lanes)
    return lost_hits(f"{label} bounce waves ({len(bounce)} closest-hit "
                     f"queries, live lanes {sizes})", pack, ro, rd, right,
                     run, tmax=tmax, fault="3.4")


def phase_atrium(errs: dict) -> dict:
    """Phase 13a: BASELINE config 5 as bench.py runs it (bench.py:402-409):
    raytpu's atrium, ``build_atrium(250_000)`` (``tools/scenes.py``, the
    port's copy), packed on the card with its own camera, 1920x1080, 1 spp,
    4 bounces, chunk 8, seed 1, ``intersector="auto"``: the strand route in
    fused wave mode. A cold and two warm frames (Mrays/s by count_rays),
    one profiled warm frame; every wave of a frame held to the brute sweep
    on a SAMPLE, the primary wave to strand_walk's plain version, fault
    3.4's lost rays counted on the primary wave and on every closest-hit
    lane of the bounces; the frame in query mode and on the block walk
    (``RAYTPU_STRAND_PERSISTENT=0``) must give the same PNG; the same host
    pack moved to the card and the CPU renders 64x36 within
    tests/imgdiff.py's bar."""
    import torch

    from raytpu_torch.engine.render import render_frame
    from raytpu_torch.kernels.strand import strand_query_cuda
    from raytpu_torch.scene.pack import pack_camera, pack_scene
    from raytpu_torch.tools.scenes import build_atrium
    from raytpu_torch.types import RenderConfig

    t0 = time.perf_counter()
    scene = build_atrium(ATRIUM_TRIS)
    build_s = time.perf_counter() - t0
    pack, pack_s, steps, _ = pack_in_steps(scene)
    n_tris = int(scene.indices.shape[0]) // 3
    cam = pack_camera(scene.camera, "cuda")
    cfg = RenderConfig(**ATRIUM_ARGS)
    print(f"phase 13a atrium: build_atrium({ATRIUM_TRIS}) {n_tris} "
          f"triangles ({pack.n_triangles} slots, {len(scene.prim_material)} "
          f"primitives, {len(scene.mat_color)} materials, "
          f"{len(scene.light_power)} lights) in {build_s:.2f} s; pack "
          f"{pack_s:.2f} s ({pack_s - steps['build_treelets']:.2f} s "
          f"treelets apart; {steps_note(steps)}); BVH8 rows kept: "
          f"{pack.bvh.node8_rows is not None}, strand rows: "
          f"{pack.bvh.strand_rows is not None}")
    rec = bench_frames("13a", pack, cam, cfg, ("strand",))
    if rec["waves"]["mode"] != "fused":
        fail("phase 13a: the 1080p frame did not run fused wave mode")
    print("phase 13a profile, warm frame: " + profile_frame(
        lambda: render_frame(pack, cam, cfg), top=5))
    with recorded_queries("strand_query") as calls:
        render_frame(pack, cam, cfg)
        torch.cuda.synchronize()
    bad, checked, notes = waves_vs_brute(pack, calls, strand_query_cuda, 130)
    print(f"phase 13a strand_walk vs brute on a {SAMPLE}-ray sample of each "
          f"of the frame's {len(calls)} waves ({checked} rays): mismatches "
          f"per wave {', '.join(notes)}")
    if bad:
        fail(f"phase 13a: strand_walk disagrees with the brute sweep on {bad} "
             "sampled rays")
    strand_primary("13a", pack, cam, cfg, errs["strand"])
    strand_bounce_lost_hits("13a", pack, calls)
    notes = []
    for arm, kw, want in (("query", dict(RAYTPU_WAVE_MODE="query"),
                           ("strand",)),
                          ("block walk", dict(RAYTPU_STRAND_PERSISTENT="0"),
                           ("block",))):
        with env(**kw):
            reset_launches()
            t0 = time.perf_counter()
            other = render_frame(pack, cam, cfg)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            note = launched(f"13a {arm}", read_launches(), want)
        n_diff = png_pixels_differ(rec["frame"], other)
        notes.append(f"{arm} ({', '.join(f'{k}={v}' for k, v in kw.items())}"
                     f"): {secs:.3f} s, {note}, {n_diff} PNG pixels differ")
        if n_diff:
            fail(f"phase 13a: the {arm} frame's PNG is not the fused frame's")
    print("phase 13a arms: " + "; ".join(notes))
    # card against CPU: the same host pack on both devices
    host = pack_scene(scene, as_numpy=True)
    small = RenderConfig(**dict(ATRIUM_ARGS, width=64, height=36))
    frames, counts = {}, {}
    for dev in ("cuda", "cpu"):
        reset_launches()
        frames[dev] = render_frame(host.to(dev), pack_camera(scene.camera,
                                                             dev), small)
        counts[dev] = read_launches()
    n_diff, frac, s = png_diff(frames["cuda"], frames["cpu"])
    lit = float((frames["cuda"][..., :3].max(-1) > 0).mean())
    print(f"phase 13a card vs cpu: one as_numpy pack on both, 64x36 1spp 4 "
          f"bounces chunk 8: {n_diff} PNG pixels differ ({frac:.4f}), SSIM "
          f"{s:.5f}, {lit:.3f} non-black; card {counts['cuda']['strand']} "
          f"strand_walk launches, cpu {counts['cpu']['strand']}")
    if frac > 0.02 or s < 0.99 or lit < 0.1 or not counts["cuda"]["strand"] \
            or counts["cpu"]["strand"]:
        fail("phase 13a: card and CPU atrium frames disagree")
    return dict(pack=pack, cam=cam, scene=scene)


def phase_atrium_stream(errs: dict) -> None:
    """Phase 13b: BASELINE config 6 as bench.py runs it (bench.py:412-440):
    ``build_atrium(2_900_000)`` packed ``tables="auto"``, which must stream
    (bench.py's check: no BVH8 rows, a strand tree); 640x360, 1 spp, 4
    bounces, chunk 8, ``intersector="auto"``: the strand route's
    while-while walk over tables past 100 MiB. A cold and two warm frames,
    one profiled warm frame; the primary wave against the plain version and
    the brute sweep, fault 3.4's lost rays; bench.py's own arm,
    ``RAYTPU_STREAM_BINNED`` (``intersector="binned"``), one cold and one
    warm frame, its PNG against auto's."""
    import dataclasses as dc

    import torch

    from raytpu_torch.engine.render import render_frame
    from raytpu_torch.scene.pack import ROW_BYTES, pack_camera
    from raytpu_torch.tools.scenes import build_atrium
    from raytpu_torch.types import RenderConfig

    t0 = time.perf_counter()
    scene = build_atrium(STREAM_TRIS)
    build_s = time.perf_counter() - t0
    pack, pack_s, steps, tl_args = pack_in_steps(scene, tables="auto")
    n_tris = int(scene.indices.shape[0]) // 3
    ((bvh8, _),) = tl_args
    mib = dict(bvh8=bvh8.node_rows.shape[0] * ROW_BYTES / 2**20,
               leaf=nbytes(pack.bvh.leaf_tris) / 2**20,
               strand=nbytes(pack.bvh.strand_rows) / 2**20)
    print(f"phase 13b atrium: build_atrium({STREAM_TRIS}) {n_tris} triangles "
          f"({pack.n_triangles} slots) in {build_s:.2f} s; pack_scene("
          f"tables='auto') {pack_s:.2f} s ({pack_s - steps['build_treelets']:.2f}"
          f" s treelets apart; {steps_note(steps)}); BVH8 rows "
          f"{mib['bvh8']:.1f} MiB (at 512 bytes a row), leaf rows "
          f"{mib['leaf']:.1f} MiB, strand rows {mib['strand']:.1f} MiB; "
          f"node8_rows is None: {pack.bvh.node8_rows is None}, strand_rows "
          f"is not None: {pack.bvh.strand_rows is not None} (bench.py "
          "config 6's check)")
    if pack.bvh.node8_rows is not None or pack.bvh.strand_rows is None:
        fail("phase 13b: the auto pack did not stream (bench.py config 6's "
             "check: node8_rows is None, strand_rows is not None)")
    cam = pack_camera(scene.camera, "cuda")
    cfg = RenderConfig(**STREAM_ARGS)
    rec = bench_frames("13b", pack, cam, cfg, ("strand",))
    print("phase 13b profile, warm frame: " + profile_frame(
        lambda: render_frame(pack, cam, cfg), top=5))
    strand_primary("13b", pack, cam, cfg, errs["strand"])
    # bench.py's RAYTPU_STREAM_BINNED arm
    binned = dc.replace(cfg, intersector="binned")
    reset_launches()
    secs = []
    for _ in range(2):
        t0 = time.perf_counter()
        frame = render_frame(pack, cam, binned)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    note = launched("13b binned", read_launches(), ("binned",))
    n_diff, frac, s = png_diff(rec["frame"], frame)
    print(f"phase 13b RAYTPU_STREAM_BINNED arm (intersector='binned'): cold "
          f"{secs[0]:.3f} s, warm {secs[1]:.4f} s ({rec['rays'] / secs[1] / 1e6:.2f}"
          f" Mrays/s), {note}; {n_diff} PNG pixels differ from auto's "
          f"({frac:.4f}), SSIM {s:.5f}")
    if frac > 0.02 or s < 0.99:
        fail("phase 13b: the binned arm's PNG is off auto's past the bar")


def phase_captured_waves(atrium: dict) -> None:
    """Phase 13c: raytpu's captured-wave A/Bs on 13a's pack, through the
    port's tools: the four committed waves (``benchmarks/waves/``, read
    as data) engine-sorted; on each, ``strand_ab --block --check``
    (strand_walk's default instance and strand_block, held to each other by
    raytpu's check), ``waves stats`` (packet_walk in both child orders,
    each order's launch and its stats launch at every packet size held to
    one plain replay) and ``waves ab`` (packet_walk, strand_walk,
    strand_block, raytpu's agreement rule; each one's timed launch and its
    stats launch held to one plain replay; strand_ab times the same two
    strand instances on the same waves and replays nothing), the launch
    counts set to 0 just before and read just after; one table. Then the port's own capture of raytpu's fixture
    tile (tile 0 at 1920x1080) against the committed bands: lanes, live
    masks and the largest f16 difference of ro and rd, printed."""
    from raytpu_torch.tools import strand_ab, waves

    pack = atrium["pack"]
    if pack.bvh.node8_rows is None:
        fail("phase 13c: 13a's pack has no BVH8 rows")
    sorted_ = waves.sorted_waves(pack, waves.COMMIT_WAVES, prefer_full=False)
    live = {k: float((w["tmax"] >= 0).float().mean())
            for k, w in sorted_.items()}
    reset_launches()
    try:
        rows = (strand_ab.measure(pack, sorted_, block=True, check=True,
                                  inner=WAVE_INNER, repeats=WAVE_REPEATS)
                + waves.stats(pack, sorted_, inner=WAVE_INNER,
                              repeats=WAVE_REPEATS, plain=True)
                + waves.ab(pack, sorted_, inner=WAVE_INNER,
                           repeats=WAVE_REPEATS, plain=True))
    except (AssertionError, RuntimeError) as e:
        fail(f"phase 13c: {e}")
    note = launched("13c", read_launches(),
                    ("strand", "packet", "packet_near", "block"))
    print(f"phase 13c captured waves ({', '.join(f'{k} {v:.3f} live' for k, v in live.items())}"
          f" of {sorted_['b1c']['ro'].shape[0]} rays each), ms per launch of "
          f"{WAVE_INNER} queued (median of {WAVE_REPEATS}), {note}:")
    waves.print_table(rows)
    if any(x["agree"] is False for x in rows):
        fail("phase 13c: a walk disagrees with the packet walk (raytpu's rule)")
    t0 = time.perf_counter()
    capture = waves.capture(pack, atrium["cam"])
    agree = waves.band_agreement(capture)
    print(f"phase 13c capture: tile 0 at 1920x1080 ({len(capture)} waves, "
          f"{time.perf_counter() - t0:.1f} s) against raytpu's bands: " +
          "; ".join(f"{a['name']} {a['rays']} lanes (full wave's lanes as "
                    f"raytpu's: {a['same_rays']}), live mask agrees on "
                    f"{a['live_agree']:.6f}, largest |d| ro {a['ro']:.6g} rd "
                    f"{a['rd']:.6g}" for a in agree))
    if not all(a["same_rays"] for a in agree):
        fail("phase 13c: the capture's tile is not raytpu's fixture tile")


@contextlib.contextmanager
def timed(secs: dict, label: str):
    """The block's host seconds into ``secs[label]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        secs[label] = time.perf_counter() - t0


def main() -> int:
    errs: dict = {k: [] for k in KERNELS}
    secs: dict = {}
    try:
        import raytpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"run from the repo root: {e}")
    phase_device()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sass = start_sass_check()
    try:
        with timed(secs, "2"):
            phase_build()
            phase_sass(sass)
    finally:
        if sass.poll() is None:
            os.killpg(sass.pid, 9)
            sass.wait()
    with timed(secs, "3-3f"):
        phase_kernel(errs["strand"], "strand", "3")
        phase_kernel(errs["packet"], "packet", "3b")
        phase_binned_kernel(errs["binned"])
        phase_block_kernel(errs["block"])
        phase_mixed_kernel(errs["strand_mixed"], "strand", "3e")
        packet_mixed_launches = phase_mixed_kernel(errs["packet_mixed"],
                                                   "packet", "3f")
    with timed(secs, "3g-3h"):
        phase_ribbon_kernel(errs)
        packet_mixed_near = phase_near_kernel(errs)
    with timed(secs, "3i"):
        sched_launches = phase_sched_kernel(errs)
        phase_sched_sweep(errs)
    with tempfile.TemporaryDirectory() as tmp:
        with timed(secs, "4-4b"):
            phase_card_vs_cpu(tmp)
            phase_binned_card_vs_cpu(tmp)
        with timed(secs, "5"):
            recs = {"strand": phase_main(tmp, errs["strand"])}
        with timed(secs, "5b"):
            recs["block"] = phase_block_route(recs["strand"], errs["block"])
        with timed(secs, "6"):
            recs["packet"] = phase_packet_route(tmp, recs["strand"],
                                                errs["packet"])
        with timed(secs, "7a"):
            recs["binned"] = phase_stream(tmp, errs["binned"])
        with timed(secs, "7b"):
            deferred = phase_deferred(recs["strand"])
        with timed(secs, "8"):
            recs["step"] = phase_step_bench(errs["step"])
        with timed(secs, "9"):
            glb, bvh_frame = phase_bvh_route(tmp)
            phase_checkpoint(tmp, recs["strand"])
            phase_shards(recs["strand"])
            phase_cli_flags(tmp, glb)
            phase_oracle(tmp)
        with timed(secs, "9g"):
            phase_pack_options(tmp, glb, bvh_frame)
        with timed(secs, "10a"):
            recs["strand_mixed"], recs["packet_mixed"] = phase_mixed_route(
                recs["strand"], deferred, errs)
        recs["packet_mixed"]["launches"] = packet_mixed_launches
        with timed(secs, "10b-10c"):
            phase_sorted_arms(recs["strand"])
        with timed(secs, "11a"):
            recs.update(phase_ribbon_route(recs["strand"],
                                           recs["strand_mixed"], errs))
        with timed(secs, "11b"):
            recs["packet_near"], recs["packet_mixed_near"] = phase_near_route(
                recs["packet"], recs["strand_mixed"], packet_mixed_near, errs)
        with timed(secs, "12"):
            forms = phase_schedule_route(recs["strand"], recs["block"],
                                         recs["strand_mixed"],
                                         sched_launches, errs)
            recs.update({k: v for k, v in forms.items() if k in KERNELS})
        with timed(secs, "13a"):
            atrium = phase_atrium(errs)
        with timed(secs, "13b"):
            phase_atrium_stream(errs)
        with timed(secs, "13c"):
            phase_captured_waves(atrium)
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in secs.items()))
    print("bounds: " + "; ".join(
        f"{KERNELS[k]['name']} {r['n_bytes'] / 1e6:.1f} MB -> "
        f"{r['bytes_ms']:.4f} ms, {r['n_ops'] / 1e9:.3f} G operations -> "
        f"{r['ops_ms']:.4f} ms" for k, r in recs.items()))
    # no single PyTorch call computes a BVH walk or the probe: library_ms
    # is null for every kernel
    print(json.dumps({"kernels": [dict(
        KERNELS[k], launches=recs[k]["launches"], max_abs_err=max(errs[k]),
        ms=recs[k]["ms"], plain_ms=recs[k]["plain_ms"],
        bound_ms=recs[k]["bound_ms"], bound_by=recs[k]["bound_by"],
        library_ms=None,
    ) for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
