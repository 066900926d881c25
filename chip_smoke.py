"""Smoke test of raytpu_torch on one NVIDIA GPU (run from the repo root):

    python3 chip_smoke.py

Builds the CUDA strand-walk kernel from source, holds it bit for bit
against its plain torch version, renders a small frame on the card and on
the CPU, then drives the path-mode main path through the CLI at the
repo's headline configuration (1920x1080, 1 spp, 4 bounces, a 259k-
triangle gallery scene) by calling ``raytpu_torch.cli.main`` in this
process, so the kernel's launch count can be read. Every phase prints its
result; a failed phase exits non-zero. The last two lines are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.

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

import numpy as np

KERNEL = dict(
    name="strand_walk",
    route="cuda",
    source="raytpu_torch/kernels/csrc/strand_walk.cu",
    replaces="raytpu/kernels/strand_persistent.py:52",
)
F32_MAX = float(np.float32(3.40282347e38))
MAIN_ARGS = dict(width=1920, height=1080, seed=1, chunk_size=64, samples=1,
                 bounces=4)


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
    over two leaves) and 500 rays aimed at it: (strand rows, slot-ordered
    triangle rows [S, 10], slot -> triangle, ro, rd)."""
    from raytpu_torch.accel.bvh import build_bvh
    from raytpu_torch.accel.strandtree import build_strand_tree

    r = np.random.default_rng(7)
    p0 = (r.random((40, 3), np.float32) - 0.5) * 10
    e1 = (r.normal(size=(40, 3)) * 0.3).astype(np.float32)
    e2 = (r.normal(size=(40, 3)) * 0.3).astype(np.float32)
    p0, e1, e2 = (np.concatenate([a, np.repeat(a[:1], 11, 0)])
                  for a in (p0, e1, e2))
    bvh, _ = build_bvh(p0, e1, e2)
    order = bvh.tri_order
    per = np.zeros((order.shape[0], 10), np.float32)
    v = order >= 0
    per[v, 0:3], per[v, 3:6], per[v, 6:9] = (
        p0[order[v]], e1[order[v]], e2[order[v]])
    c = p0[0] + (e1[0] + e2[0]) / 3
    ro = (r.random((500, 3), np.float32) - 0.5) * 12
    rd = c - ro
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return build_strand_tree(bvh).rows, per, order, ro, rd


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
    from raytpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.load_library("strand_walk")
    secs = time.perf_counter() - t0
    ptxas = [line.strip() for line in _build.build_log("strand_walk")
             .splitlines() if "registers" in line or "spill" in line]
    print(f"phase 2 build: ok — strand_walk.cu in {secs:.2f} s; "
          + " | ".join(ptxas))


def phase_kernel(errs: list) -> int:
    """Kernel vs plain version on CUDA tensors (bit-equal), and vs the
    brute sweep on 4096 rays (count of mismatches)."""
    import torch

    from raytpu_torch.accel.bvh import build_bvh
    from raytpu_torch.accel.strandtree import build_strand_tree
    from raytpu_torch.kernels.intersect import (
        intersect_any_bruteforce,
        intersect_bruteforce,
    )
    from raytpu_torch.kernels.strand import (
        strand_query_cuda,
        strand_query_torch,
    )

    dev = "cuda"
    total_bad = 0
    notes = []
    for ntri in (5, 300, 3000):
        p0, e1, e2 = soup(ntri)
        bvh, _ = build_bvh(p0, e1, e2)
        order = bvh.tri_order
        per = np.zeros((order.shape[0], 10), np.float32)
        v = order >= 0
        per[v, 0:3], per[v, 3:6], per[v, 6:9] = (
            p0[order[v]], e1[order[v]], e2[order[v]])
        g = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for k, a in (
            ("tree", build_strand_tree(bvh).rows), ("leaf", per.reshape(-1, 80)),
            ("order", order))}
        ro_np, rd_np = soup_rays(65536, seed=ntri)
        ro = torch.from_numpy(ro_np).to(dev)
        rd = torch.from_numpy(rd_np).to(dev)
        tmax_c = torch.full((65536,), F32_MAX, device=dev)
        tmax_c[::7] = float("-inf")  # dead lanes
        tmax_s = torch.full((65536,), 6.0, device=dev)  # shadow rays
        tmax_s[::5] = float("-inf")
        args = (g["tree"], g["leaf"], ro, rd)
        tk, trk = strand_query_cuda(*args, tmax_c, 0.001, False)
        tp, trp = strand_query_torch(*args, tmax_c, 0.001, False)
        torch.cuda.synchronize()
        if not (same_bits(tk, tp) and torch.equal(trk, trp)):
            fail(f"{ntri} tris closest: kernel != plain on "
                 f"{int((tk != tp).sum())} t, {int((trk != trp).sum())} tri")
        dead = tmax_c < 0
        if not (bool((trk[dead] == -1).all())
                and bool((tk[dead] == float("-inf")).all())):
            fail(f"{ntri} tris: a dead lane returned a hit")
        _, ark = strand_query_cuda(*args, tmax_s, 0.0, True)
        _, arp = strand_query_torch(*args, tmax_s, 0.0, True)
        torch.cuda.synchronize()
        if not torch.equal(ark >= 0, arp >= 0):
            fail(f"{ntri} tris any-hit: blocked differs on "
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
    rows, per, order, ro_np, rd_np = tie_scene()
    cu = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        rows, per.reshape(-1, 80), ro_np, rd_np,
        np.full(ro_np.shape[0], F32_MAX, np.float32))]
    _, tie_k = strand_query_cuda(*cu, 0.001, False)
    hb = intersect_bruteforce(cu[2], cu[3], cu[1].reshape(-1, 10)[:, 0:3],
                              cu[1].reshape(-1, 10)[:, 3:6],
                              cu[1].reshape(-1, 10)[:, 6:9], 0.001, cu[4],
                              chunk=8)
    tie_bad = int((tie_k != hb.tri).sum())
    total_bad += tie_bad
    notes.append(f"tie scene: {tie_bad} slot mismatches")
    print("phase 3 kernel vs plain: bit-equal on 3 soups x 65536 rays "
          "(closest t/tri, any-hit blocked); " + "; ".join(notes))
    if total_bad:
        fail(f"{total_bad} kernel-vs-brute mismatches on 4096-ray subsets")
    return total_bad


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
    cfg = RenderConfig(width=64, height=64, seed=3, samples=2, bounces=4,
                       chunk_size=16)
    frames = {}
    for dev in ("cuda", "cpu"):
        pack = pack_scene(scene, dev)
        frames[dev] = render_frame(pack, pack_camera(cam, dev), cfg)
    torch.cuda.synchronize()
    slots = pack.n_triangles
    if slots > 256:
        fail(f"small scene has {slots} slots (> 256)")
    qa, qb = quantize_rgba32f(frames["cuda"]), quantize_rgba32f(frames["cpu"])
    frac = float(np.any(qa != qb, axis=-1).mean())
    raw = float(np.any(frames["cuda"] != frames["cpu"], axis=-1).mean())
    s = ssim(qa, qb)
    lit = float((qa.max(-1) > 0).mean())
    print(f"phase 4 card vs cpu: {slots} slots, 64x64 2spp 4 bounces: "
          f"{frac:.4f} of PNG pixels differ ({raw:.4f} of f32 pixels), "
          f"SSIM {s:.5f}, {lit:.3f} non-black")
    if frac > 0.02 or s < 0.99 or lit < 0.1:
        fail("card and CPU frames disagree")


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


def phase_main(tmp: str, errs: list) -> dict:
    import torch

    from raytpu_torch import cli
    from raytpu_torch.engine.render import (
        _pixel_layout,
        cast_rays,
        render_frame,
    )
    from raytpu_torch.kernels import rng as rngk
    from raytpu_torch.kernels.intersect import intersect_bruteforce
    from raytpu_torch.kernels.strand import (
        strand_query_cuda,
        strand_query_torch,
    )
    from raytpu_torch.scene.camera import load_camera_json
    from raytpu_torch.scene.gltf import load_scene
    from raytpu_torch.scene.pack import pack_camera, pack_scene
    from raytpu_torch.types import RenderConfig

    glb = os.path.join(tmp, "gallery.glb")
    cam_json = os.path.join(tmp, "camera.json")
    png = os.path.join(tmp, "frame.png")
    write_gallery(glb, cells=360)
    with open(cam_json, "w") as f:
        json.dump({"origin": [0, 2.5, -9], "at": [0, -0.5, 0], "fov": 0.7}, f)
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
    px, py, _ = _pixel_layout(w, h, True, "cuda")
    state = rngk.seed_pixels(px, py, w, MAIN_ARGS["chunk_size"], 1)
    state, jx = rngk.rand(state)
    state, jy = rngk.rand(state)
    ro, rd = cast_rays(px.float() + jx, py.float() + jy, cam.world,
                       cam.projection, w, h)
    ro, rd = ro.contiguous(), rd.contiguous()
    tmax = torch.full((ro.shape[0],), F32_MAX, device="cuda")
    tree, leaves = pack.bvh.strand_rows, pack.bvh.leaf_tris
    ms = cuda_ms(lambda: strand_query_cuda(tree, leaves, ro, rd, tmax,
                                           0.001, False), reps=5)
    plain_ms = cuda_ms(lambda: strand_query_torch(tree, leaves, ro, rd, tmax,
                                                  0.001, False), reps=1)
    tk, trk = strand_query_cuda(tree, leaves, ro, rd, tmax, 0.001, False)
    tp, trp = strand_query_torch(tree, leaves, ro, rd, tmax, 0.001, False)
    if not (same_bits(tk, tp) and torch.equal(trk, trp)):
        fail("primary wave: kernel != plain version")
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
    print(f"phase 5 main path: {n_tris} triangles ({pack.n_triangles} slots), "
          f"pack {pack_s:.2f} s, frame 1 {frame_s[0]:.3f} s, frame 2 "
          f"{frame_s[1]:.3f} s at {w}x{h} 1spp 4 bounces; primary wave "
          f"{ro.shape[0]} rays: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
          f"bit-equal; vs brute on 4096 rays: {bad} mismatches")
    if bad:
        fail("primary wave: kernel disagrees with the brute sweep")

    strand_query_cuda.launches = 0
    argv = ["--scene", glb, "--camera", cam_json, "--output", png]
    for k, v in MAIN_ARGS.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = strand_query_cuda.launches
    if rc != 0:
        fail(f"cli.main returned {rc}")
    img = read_png_rgb(png)
    lit = float((img.max(-1) > 0).mean())
    print(f"phase 5 cli: raytpu_torch.cli.main({' '.join(argv)}) -> "
          f"rc 0 in {cli_s:.2f} s, {img.shape[1]}x{img.shape[0]} PNG, "
          f"{lit:.3f} non-black, {launches} strand_walk launches")
    if img.shape != (h, w, 3) or lit <= 0.10:
        fail("main-path PNG is wrong or mostly black")
    if launches == 0:
        fail("the main path never launched strand_walk")
    return dict(launches=launches, ms=ms, plain_ms=plain_ms)


def main() -> int:
    errs: list = []
    try:
        import raytpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"run from the repo root: {e}")
    phase_device()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    phase_kernel(errs)
    with tempfile.TemporaryDirectory() as tmp:
        phase_card_vs_cpu(tmp)
        main_rec = phase_main(tmp, errs)
    print(json.dumps({"kernels": [dict(
        KERNEL, launches=main_rec["launches"], max_abs_err=max(errs),
        ms=main_rec["ms"], plain_ms=main_rec["plain_ms"],
    )]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
