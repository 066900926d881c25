"""The per-step cost probe of the strand walks, on the card:

    python -m raytpu_torch.tools.step_bench [--walkers 128] [--iters 2000]
        [--repeats 5] [--arms full noroll ...]

Port of ``benchmarks/step_bench.py`` (``_kernel`` and ``main``). Each arm
runs ``iters`` iterations of one structural piece of a walk step (roll
chain, slab test, link select, queue roll, row fetches, the leaf pass,
the control reductions) on dummy ``(W, 128)`` f32 state that starts as the
first W rows of a fixed ``(1024, 128)`` tree
(``default_rng(0).standard_normal``), each iteration carried into the next
through ``scratch[0][0]``. The arms do not trace real rays: this is a cost
model.

``step_bench_cuda`` launches ``kernels/csrc/step_bench.cu`` (one thread
block, the scratch in shared memory); ``step_bench_torch`` is its plain
version, a replay of raytpu's arithmetic in torch ops; ``step_bench``
dispatches on the tree's device. Both return the final scratch ``(W,
128)`` and the last iteration's per-row carry ``acc`` ``(W,)``.

``main`` needs a CUDA device (it measures the card and nothing else). It
times every arm with CUDA events, subtracts the launch floor of an empty
kernel, and prints ms, ns per iteration and cycles per walker-step, the
cycles read from the SM's own cycle counter inside the kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import sys

import numpy as np
import torch

ARMS = ("full", "noroll", "roll2", "slab", "rollq", "ctl", "fetch",
        "fetchdep", "fetchmir", "mt", "install")
DEFAULT_ARMS = ("full", "noroll", "roll2", "slab", "rollq", "ctl", "fetch",
                "mt", "install")  # raytpu's default list
TREE_ROWS = 1024
LANES = 128
SMEM_LIMIT = 232448  # bytes of shared memory one block may use (sm_90)


def make_tree(device="cuda") -> torch.Tensor:
    """raytpu's tree: ``default_rng(0).standard_normal((1024, 128))``."""
    tree = np.random.default_rng(0).standard_normal((TREE_ROWS, LANES),
                                                    np.float32)
    return torch.from_numpy(tree).to(device)


def _f2i(x: torch.Tensor) -> torch.Tensor:
    """f32 -> i32 as XLA and the card convert: toward zero, saturating,
    NaN -> 0."""
    big = x >= 2147483648.0
    y = torch.where(torch.isnan(x) | big, 0.0, x).clamp(min=-2147483648.0)
    return torch.where(big, 2147483647, y.to(torch.int32))


def _roll_chain(s, amt, bits):
    """raytpu's conditional rolls: row i rotates left by 2^b where bit b of
    amt[i] is set (``pltpu.roll(x, 128 - 2^b, 1)``, jnp.roll semantics)."""
    for b in bits:
        s = torch.where((amt & (1 << b)) != 0,
                        torch.roll(s, LANES - (1 << b), 1), s)
    return s


def step_bench_torch(tree, arm: str, iters: int, walkers: int):
    """Plain torch replay of one arm: (scratch (W, 128), acc (W,))."""
    if arm not in ARMS:
        raise ValueError(f"unknown arm {arm!r}; arms: {' '.join(ARMS)}")
    w = walkers
    dev = tree.device
    scratch = tree[:w].clone()
    lane = torch.arange(LANES, device=dev)[None, :]
    rows = torch.arange(w, device=dev)
    acc = torch.zeros((w, 1), dtype=torch.float32, device=dev)
    for _ in range(iters):
        s0 = scratch.clone()
        cur = _f2i(s0[:, 0:1] * 1e6) & 1023
        amt = (cur & 15) * 8
        s = s0
        if arm in ("full", "rollq"):
            s = _roll_chain(s, amt, (3, 4, 5, 6))
        elif arm == "roll2":
            s = _roll_chain(s, amt, (3, 4))
        acc = s[:, 0:1] * 0.0
        if arm in ("full", "noroll", "roll2", "slab"):
            hitl = _f2i(s[:, 6:7])
            missl = _f2i(s[:, 7:8])
            idx = s0 + 1.0
            neg = idx < 0.5
            ro = s0 * 0.25
            lox = (torch.where(neg, s[:, 3:4], s[:, 0:1]) - ro) * idx
            hix = (torch.where(neg, s[:, 0:1], s[:, 3:4]) - ro) * idx
            loy = (torch.where(neg, s[:, 4:5], s[:, 1:2]) - ro) * idx
            hiy = (torch.where(neg, s[:, 1:2], s[:, 4:5]) - ro) * idx
            loz = (torch.where(neg, s[:, 5:6], s[:, 2:3]) - ro) * idx
            hiz = (torch.where(neg, s[:, 2:3], s[:, 5:6]) - ro) * idx
            near = torch.maximum(torch.maximum(lox, loy),
                                 torch.maximum(loz, torch.full_like(loz, 0.001)))
            far = torch.minimum(torch.minimum(hix, hiy),
                                torch.minimum(hiz, torch.full_like(hiz, 1e30)))
            hit_any = (near <= far).any(dim=1, keepdim=True)
            is_leaf = hitl < 0
            pend = torch.where(hit_any & is_leaf, ~hitl, -1)
            nxt = torch.where(hit_any & ~is_leaf, hitl, missl)
            acc = acc + nxt.to(torch.float32) * 1e-9
        else:
            pend = cur - 1
        if arm in ("full", "rollq"):
            enq = pend >= 0
            q = torch.where(enq, torch.roll(scratch, 1, 1), scratch)
            q = torch.where(enq & (lane == 0), pend.to(torch.float32), q)
            acc = acc + q[:, 0:1] * 1e-12
        cur00 = cur[0, 0]
        if arm == "fetch":
            scratch = tree[(cur00 + rows) & 1023]
            acc = acc + scratch[0:1, 0:1]
        if arm in ("fetchdep", "fetchmir"):
            scratch = tree[(cur[:, 0] & 1023).long()]
            acc = acc + scratch[0:1, 0:1]
        if arm == "mt":
            scratch = tree[(cur00 + rows) & 1023]
            leaf = scratch
            ro = s0 * 0.25
            rd = s0 + 1.0
            best_t = s0[:, 8:9] + 1e3
            best_tri = _f2i(s0[:, 9:10] * 10.0)
            for k in range(8):
                b = 10 * k
                p0 = leaf[:, b:b + 1]
                e1 = leaf[:, b + 3:b + 4]
                e2 = leaf[:, b + 6:b + 7]
                pvx = rd * e2 - rd * p0
                pvy = rd * e1 - rd * e2
                pvz = rd * p0 - rd * e1
                det = e1 * pvx + e2 * pvy + p0 * pvz
                inv = 1.0 / det
                tvx = ro - p0
                tvy = ro - e1
                tvz = ro - e2
                u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
                qx = tvy * e2 - tvz * e1
                qy = tvz * p0 - tvx * e2
                qz = tvx * e1 - tvy * p0
                v = (rd * qx + rd * qy + rd * qz) * inv
                t = (e2 * qx + e1 * qy + p0 * qz) * inv
                ok = ((det != 0.0) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                      & (t >= 0.001)
                      & ((t < best_t) | ((t == best_t) & (cur + k < best_tri))))
                best_t = torch.where(ok, t, best_t)
                best_tri = torch.where(ok, cur + k, best_tri)
            acc = acc + (best_t.amax(dim=1, keepdim=True)
                         + best_tri.to(torch.float32).amax(dim=1, keepdim=True)
                         ) * 1e-12
        if arm == "ctl":
            qn = _f2i(s0[:, 1:2] * 3.0) & 7
            nxt = cur - 512
            n_q = (qn > 0).sum()
            do_leaf = ((n_q >= 2 * w) | ((n_q > 0) & ~(nxt >= 0).any())
                       | (qn.max() >= 128))
            scratch[0, 0] = torch.where(do_leaf, scratch[0, 0] + 1.0,
                                        scratch[0, 0])
            n_need = ((nxt < -2048) & (qn == 0)).sum()
            busy = ((nxt >= 0) | (qn > 0)).any()
            do_service = (n_need >= 2 * w) | ((n_need > 0) & ~busy)
            scratch[0, 1] = torch.where(do_service, scratch[0, 1] + 1.0,
                                        scratch[0, 1])
            acc = acc + n_q.to(torch.float32) * 1e-12
        if arm == "install":
            scratch[0] = tree[(cur00 + 6) & 1023]  # the last of 7 copies
            row = scratch[0:1]
            safe = 1.0 / torch.where(
                row == 0.0, torch.where(1.0 / row < 0.0, -1e-36, 1e-36), row)
            scratch[0:1] = safe
            acc = acc + safe[0:1, 0:1] * 1e-20
        scratch[0:1, 0:1] = acc[0:1, :] * 1e-20 + scratch[0:1, 0:1]
    return scratch, acc[:, 0]


_LIB = None


def _library():
    """The built step_bench library with its C signatures declared."""
    global _LIB
    from ..kernels._build import LOCK, load_library

    with LOCK:
        if _LIB is None:
            lib = load_library("step_bench")
            lib.step_bench_launch.restype = ctypes.c_int
            lib.step_bench_launch.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])
            lib.step_bench_empty_launch.restype = ctypes.c_int
            lib.step_bench_empty_launch.argtypes = [ctypes.c_int,
                                                    ctypes.c_void_p]
            lib.step_bench_smem_bytes.restype = ctypes.c_int
            lib.step_bench_smem_bytes.argtypes = [ctypes.c_int]
            lib.step_bench_error_string.restype = ctypes.c_char_p
            lib.step_bench_error_string.argtypes = [ctypes.c_int]
            _LIB = lib
    return _LIB


def _check(lib, rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           + lib.step_bench_error_string(rc).decode())


def _check_walkers(walkers: int):
    if walkers % 8 or not 8 <= walkers <= TREE_ROWS:
        raise ValueError(f"walkers must be a multiple of 8 in [8, "
                         f"{TREE_ROWS}], got {walkers}")


def step_bench_cuda(tree, arm: str, iters: int, walkers: int):
    """Launch ``csrc/step_bench.cu`` for one arm on the current stream:
    (scratch (W, 128), acc (W,), SM cycles of the loop as a 1-element
    int64 tensor). Raises on bad inputs or a failed launch.
    ``step_bench_cuda.launches`` counts the launches."""
    if tree.device.type != "cuda":
        raise ValueError(f"step_bench_cuda needs a CUDA tensor, got "
                         f"{tree.device}")
    if (tree.dtype != torch.float32 or tree.shape != (TREE_ROWS, LANES)
            or not tree.is_contiguous()):
        raise ValueError(f"tree: want a contiguous float32 [{TREE_ROWS}, "
                         f"{LANES}] tensor, got {tree.dtype} "
                         f"{tuple(tree.shape)}")
    if arm not in ARMS:
        raise ValueError(f"unknown arm {arm!r}; arms: {' '.join(ARMS)}")
    _check_walkers(walkers)
    lib = _library()
    if lib.step_bench_smem_bytes(walkers) > SMEM_LIMIT:
        raise ValueError(f"walkers={walkers}: the scratch does not fit one "
                         "block's shared memory")
    dev = tree.device
    out = torch.empty((walkers, LANES), dtype=torch.float32, device=dev)
    acc = torch.empty(walkers, dtype=torch.float32, device=dev)
    idx = torch.empty(walkers, dtype=torch.int32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.step_bench_launch(tree.data_ptr(), out.data_ptr(),
                                   acc.data_ptr(), idx.data_ptr(),
                                   cycles.data_ptr(), ARMS.index(arm),
                                   iters, walkers, stream)
    _check(lib, rc, f"step_bench launch ({arm})")
    step_bench_cuda.launches += 1
    return out, acc, cycles


step_bench_cuda.launches = 0


def step_bench(tree, arm: str, iters: int, walkers: int):
    """The kernel for a CUDA tree, the plain version for a CPU tree:
    (scratch, acc)."""
    if tree.device.type == "cuda":
        return step_bench_cuda(tree, arm, iters, walkers)[:2]
    return step_bench_torch(tree, arm, iters, walkers)


def _event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def launch_floor_ms(walkers: int, repeats: int = 6) -> float:
    """The smallest event-timed span of one empty-kernel launch with the
    same block and shared memory."""
    lib = _library()
    stream = torch.cuda.current_stream().cuda_stream

    def empty():
        _check(lib, lib.step_bench_empty_launch(walkers, stream),
               "empty launch")

    empty()
    return min(_event_ms(empty) for _ in range(repeats))


def measure(arms, walkers: int, iters: int, repeats: int) -> list:
    """Every arm on the card: a list of dicts with the arm, ms (the
    fastest of ``repeats`` event-timed launches less the launch floor),
    ns per iteration, SM cycles per iteration and per walker-step (from
    the kernel's own cycle counter), the implied SM clock in MHz, and the
    launch floor."""
    tree = make_tree("cuda")
    floor = launch_floor_ms(walkers)
    rows = []
    for arm in arms:
        step_bench_cuda(tree, arm, iters, walkers)  # warm-up
        times, cycles = [], []
        for _ in range(repeats):
            box = []
            times.append(_event_ms(lambda: box.append(
                step_bench_cuda(tree, arm, iters, walkers)[2])))
            cycles.append(int(box[0]))
        best = int(np.argmin(times))
        ms = max(times[best] - floor, 1e-9)
        cyc_iter = cycles[best] / iters
        rows.append(dict(arm=arm, ms=ms, ns_per_iter=ms * 1e6 / iters,
                         cycles_per_iter=cyc_iter,
                         cycles_per_walker_step=cyc_iter / walkers,
                         sm_mhz=cycles[best] / (times[best] * 1e3),
                         floor_ms=floor))
    return rows


def format_table(rows) -> str:
    lines = ["| arm | ms | ns/iter | cycles/iter | cycles/walker-step | "
             "SM MHz |", "|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(f"| {r['arm']} | {r['ms']:.4f} | {r['ns_per_iter']:.1f} "
                     f"| {r['cycles_per_iter']:.1f} | "
                     f"{r['cycles_per_walker_step']:.3f} | {r['sm_mhz']:.0f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="step_bench", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--walkers", type=int, default=128)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--arms", nargs="*", default=list(DEFAULT_ARMS),
                    choices=ARMS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step_bench: needs a CUDA device", file=sys.stderr)
        return 1
    rows = measure(args.arms, args.walkers, args.iters, args.repeats)
    print(f"[step] {torch.cuda.get_device_name(0)}, W {args.walkers}, "
          f"{args.iters} iterations, launch floor {rows[0]['floor_ms']:.4f} "
          "ms", file=sys.stderr)
    print(format_table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
