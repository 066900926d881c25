"""Smoke test of raytpu_torch on one NVIDIA GPU (run from the repo root):

    python3 chip_smoke.py

Builds the CUDA kernels from source (strand walk and the packet route's
BVH8 walk, one nvcc each, in parallel), holds each bit for bit against its
plain torch version, renders small frames (path and flat mode) on the card
and on the CPU, then drives the entry point ``raytpu_torch.cli.main`` in
this process, so each kernel's launch count can be read:

* phase 5, the strand route: path mode at the repo's headline
  configuration (1920x1080, 1 spp, 4 bounces, a 259k-triangle gallery);
* phase 6, the packet route at bench.py's settings: (a) the pbr+nee scene,
  (b) a cube stand-in, (c) flat mode on the gallery at 1920x1080.

Every phase prints its result; a failed phase exits non-zero. The last
two lines are the per-kernel JSON record and ``{"ok": true, "device":
{...}}``.

Needs a CUDA device, nvcc and the repo checkout; imports nothing of JAX.
"""

from __future__ import annotations

import json
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
}
F32_MAX = float(np.float32(3.40282347e38))
MAIN_ARGS = dict(width=1920, height=1080, seed=1, chunk_size=64, samples=1,
                 bounces=4)
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


def tie_scene():
    """40 small triangles plus 11 exact copies of triangle 0 (12 copies
    over two leaves) and 500 rays aimed at it: (bvh, BVH8 rows,
    slot-ordered triangle rows [S, 10], slot -> triangle, ro, rd)."""
    from raytpu_torch.accel.bvh import build_bvh

    r = np.random.default_rng(7)
    p0 = (r.random((40, 3), np.float32) - 0.5) * 10
    e1 = (r.normal(size=(40, 3)) * 0.3).astype(np.float32)
    e2 = (r.normal(size=(40, 3)) * 0.3).astype(np.float32)
    p0, e1, e2 = (np.concatenate([a, np.repeat(a[:1], 11, 0)])
                  for a in (p0, e1, e2))
    bvh, bvh8 = build_bvh(p0, e1, e2)
    order = bvh.tri_order
    per = np.zeros((order.shape[0], 10), np.float32)
    v = order >= 0
    per[v, 0:3], per[v, 3:6], per[v, 6:9] = (
        p0[order[v]], e1[order[v]], e2[order[v]])
    c = p0[0] + (e1[0] + e2[0]) / 3
    ro = (r.random((500, 3), np.float32) - 0.5) * 12
    rd = c - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return bvh, bvh8.node_rows, per, order, ro, rd


def kernel_fns(which: str):
    """(tree of (bvh, BVH8 rows), kernel wrapper, plain version) of the
    strand walk or the packet route's BVH8 walk."""
    if which == "strand":
        from raytpu_torch.accel.strandtree import build_strand_tree
        from raytpu_torch.kernels.strand import (
            strand_query_cuda,
            strand_query_torch,
        )

        return (lambda bvh, rows8: build_strand_tree(bvh).rows,
                strand_query_cuda, strand_query_torch)
    from raytpu_torch.kernels.packet import (
        packet_query_cuda,
        packet_query_torch,
    )

    return lambda bvh, rows8: rows8, packet_query_cuda, packet_query_torch


def reset_launches() -> None:
    from raytpu_torch.kernels.packet import packet_query_cuda
    from raytpu_torch.kernels.strand import strand_query_cuda

    strand_query_cuda.launches = 0
    packet_query_cuda.launches = 0


def read_launches() -> dict:
    from raytpu_torch.kernels.packet import packet_query_cuda
    from raytpu_torch.kernels.strand import strand_query_cuda

    return dict(strand=strand_query_cuda.launches,
                packet=packet_query_cuda.launches)


def t_err(a, b) -> float:
    """Largest |a - b| over lanes whose t differ (equal infinities are 0)."""
    import torch

    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def same_bits(a, b) -> bool:
    import torch

    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


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


def phase_build():
    """Build every kernel, one nvcc per source, all started together."""
    from raytpu_torch.kernels import _build

    def build(which):
        name = KERNELS[which]["name"]
        t0 = time.perf_counter()
        _build.load_library(name)
        return name, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(build, KERNELS))
    notes = []
    for name, secs in built:
        ptxas = [line.strip() for line in _build.build_log(name).splitlines()
                 if "registers" in line or "spill" in line]
        notes.append(f"{name}.cu in {secs:.2f} s: " + " | ".join(ptxas))
    print(f"phase 2 build: ok — {len(built)} kernels in "
          f"{time.perf_counter() - t0:.2f} s; " + "; ".join(notes))


def phase_kernel(errs: list, which: str, label: str) -> None:
    """One kernel vs its plain version on CUDA tensors (closest t bits and
    tri, any-hit blocked bit) on 3 soups x 65536 rays with dead lanes,
    zero direction components, finite-tmax closest-hit and shadow lanes;
    vs the brute sweep on 4096 rays of each and on the tie scene. Any
    mismatch fails the phase."""
    import torch

    from raytpu_torch.accel.bvh import build_bvh
    from raytpu_torch.kernels.intersect import (
        intersect_any_bruteforce,
        intersect_bruteforce,
    )

    tree_of, kernel, plain = kernel_fns(which)
    name = KERNELS[which]["name"]
    dev = "cuda"
    total_bad = 0
    notes = []
    for ntri in (5, 300, 3000):
        p0, e1, e2 = soup(ntri)
        bvh, bvh8 = build_bvh(p0, e1, e2)
        order = bvh.tri_order
        per = np.zeros((order.shape[0], 10), np.float32)
        v = order >= 0
        per[v, 0:3], per[v, 3:6], per[v, 6:9] = (
            p0[order[v]], e1[order[v]], e2[order[v]])
        g = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for k, a in (
            ("tree", tree_of(bvh, bvh8.node_rows)),
            ("leaf", per.reshape(-1, 80)), ("order", order))}
        ro_np, rd_np = soup_rays(65536, seed=ntri)
        ro = torch.from_numpy(ro_np).to(dev)
        rd = torch.from_numpy(rd_np).to(dev)
        tmax_c = torch.full((65536,), F32_MAX, device=dev)
        tmax_c[3::10] = 5.0  # finite closest-hit bound (open)
        tmax_c[::7] = float("-inf")  # dead lanes
        tmax_s = torch.full((65536,), 6.0, device=dev)  # shadow rays
        tmax_s[::5] = float("-inf")
        args = (g["tree"], g["leaf"], ro, rd)
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
    bvh, rows8, per, order, ro_np, rd_np = tie_scene()
    cu = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        tree_of(bvh, rows8), per.reshape(-1, 80), ro_np, rd_np,
        np.full(ro_np.shape[0], F32_MAX, np.float32))]
    _, tie_k = kernel(*cu, 0.001, False)
    hb = intersect_bruteforce(cu[2], cu[3], cu[1].reshape(-1, 10)[:, 0:3],
                              cu[1].reshape(-1, 10)[:, 3:6],
                              cu[1].reshape(-1, 10)[:, 6:9], 0.001, cu[4],
                              chunk=8)
    tie_bad = int((tie_k != hb.tri).sum())
    total_bad += tie_bad
    notes.append(f"tie scene: {tie_bad} slot mismatches")
    print(f"phase {label} {name} vs plain: bit-equal on 3 soups x 65536 "
          "rays (closest t/tri, any-hit blocked); " + "; ".join(notes))
    if total_bad:
        fail(f"{name}: {total_bad} kernel-vs-brute mismatches")


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


def wave_check(which: str, tree, pack, ro, rd, errs: list):
    """A closest-hit wave through one kernel (CUDA events, 5 launches) and
    its plain version (1 run): (kernel ms, plain ms, mismatches against
    the brute sweep on 4096 of its rays). Fails unless bit-equal."""
    import torch

    from raytpu_torch.kernels.intersect import intersect_bruteforce

    _, kernel, plain = kernel_fns(which)
    leaves = pack.bvh.leaf_tris
    tmax = torch.full((ro.shape[0],), F32_MAX, device="cuda")
    ms = cuda_ms(lambda: kernel(tree, leaves, ro, rd, tmax, 0.001, False),
                 reps=5)
    plain_ms = cuda_ms(lambda: plain(tree, leaves, ro, rd, tmax, 0.001,
                                     False), reps=1)
    tk, trk = kernel(tree, leaves, ro, rd, tmax, 0.001, False)
    tp, trp = plain(tree, leaves, ro, rd, tmax, 0.001, False)
    if not (same_bits(tk, tp) and torch.equal(trk, trp)):
        fail(f"primary wave: {KERNELS[which]['name']} != its plain version")
    errs.append(t_err(tk, tp))
    sub = torch.arange(0, ro.shape[0], ro.shape[0] // 4096,
                       device="cuda")[:4096]
    hb = intersect_bruteforce(ro[sub], rd[sub], pack.tri_p0, pack.tri_e1,
                              pack.tri_e2, 0.001, tmax[sub])
    # duplicate slots carry identical rows: compare the triangles' rows
    same_tri = torch.equal(pack.tri_row[trk[sub].clamp(min=0).long(), :9],
                           pack.tri_row[hb.tri.clamp(min=0).long(), :9])
    bad = int(((trk[sub] >= 0) != hb.valid).sum()) + int(
        ((trk[sub] >= 0) & (tk[sub] != hb.t)).sum()) + (0 if same_tri else 1)
    return ms, plain_ms, bad


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
    at 1920x1080."""
    import torch

    from raytpu_torch.engine.render import render_frame
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
    pack = pack_scene(scene, "cuda")
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    n_tris = sum(int(scene.prim_index_count[p]) // 3
                 for p in range(len(scene.prim_index_count)))
    cam = pack_camera(load_camera_json(cam_json, w, h), "cuda")
    cfg = RenderConfig(**MAIN_ARGS)
    frame_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        render_frame(pack, cam, cfg)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)

    # the kernel and its plain version on the frame's primary wave
    ro, rd = primary_wave(cam, w, h, MAIN_ARGS["chunk_size"], 1)
    ms, plain_ms, bad = wave_check("strand", pack.bvh.strand_rows, pack, ro,
                                   rd, errs)
    print(f"phase 5 main path: {n_tris} triangles ({pack.n_triangles} slots), "
          f"pack {pack_s:.2f} s, frame 1 {frame_s[0]:.3f} s, frame 2 "
          f"{frame_s[1]:.3f} s at {w}x{h} 1spp 4 bounces; primary wave "
          f"{ro.shape[0]} rays: strand_walk {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms, bit-equal; vs brute on 4096 rays: {bad} "
          "mismatches")
    if bad:
        fail("primary wave: strand_walk disagrees with the brute sweep")

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
    if counts["strand"] == 0 or counts["packet"] != 0:
        fail("the path waves of a >256-slot scene did not all take strand_walk")
    return dict(launches=counts["strand"], ms=ms, plain_ms=plain_ms,
                glb=glb, cam_json=cam_json)


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
    and its plain version."""
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
        render_frame(pack, cam, cfg)
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
    if mode == "flat":
        ro, rd = primary_wave(cam, w, h, args["chunk_size"], args["seed"])
        ms, plain_ms, bad = wave_check("packet", pack.bvh.node8_rows, pack,
                                       ro, rd, errs)
        line += (f"; primary wave {ro.shape[0]} rays: packet_walk {ms:.3f} "
                 f"ms, plain {plain_ms:.1f} ms, bit-equal; vs brute on 4096 "
                 f"rays: {bad} mismatches")
        if bad:
            fail("primary wave: packet_walk disagrees with the brute sweep")
        rec.update(ms=ms, plain_ms=plain_ms)
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
    return dict(launches=sum(c["launches"] for c in cells),
                ms=cells[2]["ms"], plain_ms=cells[2]["plain_ms"])


def main() -> int:
    errs: dict = {"strand": [], "packet": []}
    try:
        import raytpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"run from the repo root: {e}")
    phase_device()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    phase_kernel(errs["strand"], "strand", "3")
    phase_kernel(errs["packet"], "packet", "3b")
    with tempfile.TemporaryDirectory() as tmp:
        phase_card_vs_cpu(tmp)
        recs = {"strand": phase_main(tmp, errs["strand"])}
        recs["packet"] = phase_packet_route(tmp, recs["strand"],
                                            errs["packet"])
    print(json.dumps({"kernels": [dict(
        KERNELS[k], launches=recs[k]["launches"], max_abs_err=max(errs[k]),
        ms=recs[k]["ms"], plain_ms=recs[k]["plain_ms"],
    ) for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
