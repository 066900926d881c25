"""The per-step cost probe of the strand walks, on the card:

    python -m raytpu_torch.tools.step_bench [--walkers 128] [--iters 2000]
        [--repeats 5] [--arms full noroll ...]
    python -m raytpu_torch.tools.step_bench --sass

Port of ``benchmarks/step_bench.py`` (``_kernel`` and ``main``). Each arm
runs ``iters`` iterations of one structural piece of a walk step (roll
chain, slab test, link select, queue roll, row fetches, the leaf pass,
the control reductions) on dummy ``(W, 128)`` f32 state that starts as the
first W rows of a fixed ``(1024, 128)`` tree
(``default_rng(0).standard_normal``), each iteration carried into the next
through ``scratch[0][0]``. The arms do not trace real rays: this is a cost
model.

``step_bench_cuda`` launches ``kernels/csrc/step_bench.cu``: the walker
rows spread over the card, W / 4 blocks of 4 warps, a warp holding its
row in registers (``ctl``, whose decision reads all W rows, one block
with a lane a row: ``launch_shape``);
``step_bench_torch`` is its plain version, a replay of raytpu's arithmetic
in torch ops; ``step_bench`` dispatches on the tree's device. Both return
the final scratch ``(W, 128)`` and the last iteration's per-row carry
``acc`` ``(W,)``.

``main`` needs a CUDA device (it measures the card and nothing else). It
times every arm with CUDA events, subtracts the launch floor of an empty
kernel of the same shape, and prints ms, ns per iteration and cycles per
walker-step: the slowest block's SM cycles of its loop (each block reads
its SM's cycle counter) an iteration, over W. ``--sass`` prints each
kernel instance's registers, loop instruction counts and dependent-chain
floor from ``cuobjdump -sass`` (nvcc only, no GPU).
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import sys
import tempfile

import numpy as np
import torch

ARMS = ("full", "noroll", "roll2", "slab", "rollq", "ctl", "fetch",
        "fetchdep", "fetchmir", "mt", "install")
DEFAULT_ARMS = ("full", "noroll", "roll2", "slab", "rollq", "ctl", "fetch",
                "mt", "install")  # raytpu's default list
TREE_ROWS = 1024
LANES = 128
ROW_WARPS = 4  # warps a block of the row arms, one row a warp
CTL_ROWS = (1, 2, 4)  # rows a lane ctl's kernel is built for
# the arms whose warps carry their own copy of row 0's chain
ROW0_ARMS = ("fetch", "fetchdep", "fetchmir", "mt", "install")


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
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                + [ctypes.c_void_p])
            lib.step_bench_empty_launch.restype = ctypes.c_int
            lib.step_bench_empty_launch.argtypes = (
                [ctypes.c_int] * 3 + [ctypes.c_void_p])
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


def _check_arm(arm: str):
    if arm not in ARMS:
        raise ValueError(f"unknown arm {arm!r}; arms: {' '.join(ARMS)}")


def launch_shape(arm: str, walkers: int) -> tuple:
    """The shape the kernel launches ``arm`` with at W = ``walkers``:
    (rows a warp, warps a block); for ``ctl``, (rows a lane, warps) of its
    one block."""
    _check_arm(arm)
    _check_walkers(walkers)
    if arm == "ctl":
        if walkers > 128:  # 4 rows a lane, as many warps as that takes
            return 4, -(-walkers // 128)
        return next(r for r in CTL_ROWS if 32 * r >= walkers), 1
    return 1, ROW_WARPS


def launch_geometry(arm: str, walkers: int) -> dict:
    """The launch of ``arm`` at W = ``walkers`` (``launch_shape``): blocks,
    threads a block, the dynamic shared memory a block needs in bytes
    (``smem``), and the int32 slots of fetchmir's index buffer (``idx``).
    """
    rows, warps = launch_shape(arm, walkers)
    slots = rows + (arm in ROW0_ARMS)
    grid = 1 if arm == "ctl" else walkers // warps
    mirror = (warps * slots + 3) // 4 * 4
    smem = {"fetchdep": warps * 2 * slots * 4, "fetchmir": mirror * 4,
            "ctl": 2 * warps * 5 * 4, "install": warps * LANES * 4,
            "mt": 2 * 4}.get(arm, 0)
    return dict(rows=rows, warps=warps, grid=grid,
                threads=32 * (warps + (arm == "mt")),
                smem=smem, idx=grid * mirror if arm == "fetchmir" else 1)


def step_bench_cuda(tree, arm: str, iters: int, walkers: int):
    """Launch ``csrc/step_bench.cu`` for one arm on the current stream:
    (scratch (W, 128), acc (W,), the slowest block's SM cycles of its loop
    as a 1-element int64 tensor). Raises on bad inputs or a failed launch.
    ``step_bench_cuda.launches`` counts the launches."""
    if tree.device.type != "cuda":
        raise ValueError(f"step_bench_cuda needs a CUDA tensor, got "
                         f"{tree.device}")
    if (tree.dtype != torch.float32 or tree.shape != (TREE_ROWS, LANES)
            or not tree.is_contiguous()):
        raise ValueError(f"tree: want a contiguous float32 [{TREE_ROWS}, "
                         f"{LANES}] tensor, got {tree.dtype} "
                         f"{tuple(tree.shape)}")
    geo = launch_geometry(arm, walkers)
    lib = _library()
    dev = tree.device
    out = torch.empty((walkers, LANES), dtype=torch.float32, device=dev)
    acc = torch.empty(walkers, dtype=torch.float32, device=dev)
    idx = torch.empty(geo["idx"], dtype=torch.int32, device=dev)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.step_bench_launch(tree.data_ptr(), out.data_ptr(),
                                   acc.data_ptr(), idx.data_ptr(),
                                   cycles.data_ptr(), ARMS.index(arm),
                                   iters, walkers, geo["rows"], geo["warps"],
                                   geo["grid"], geo["smem"], stream)
    _check(lib, rc, f"step_bench launch ({arm}, W {walkers})")
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


def launch_floor_ms(arm: str, walkers: int, repeats: int = 6) -> float:
    """The smallest event-timed span of one empty-kernel launch with the
    arm's grid, block and shared memory."""
    geo = launch_geometry(arm, walkers)
    lib = _library()
    stream = torch.cuda.current_stream().cuda_stream

    def empty():
        _check(lib, lib.step_bench_empty_launch(geo["grid"], geo["threads"],
                                                geo["smem"], stream),
               "empty launch")

    empty()
    return min(_event_ms(empty) for _ in range(repeats))


def measure(arms, walkers: int, iters: int, repeats: int) -> list:
    """Every arm on the card: a list of dicts with the arm, its launch
    shape, ms (the fastest of ``repeats`` event-timed launches less the
    launch floor of an empty kernel of the same shape), ns per iteration,
    SM cycles per iteration and per walker-step (the slowest block's, from
    the kernel's own cycle counter), the implied SM clock in MHz, and the
    launch floor."""
    tree = make_tree("cuda")
    rows = []
    for arm in arms:
        geo = launch_geometry(arm, walkers)
        floor = launch_floor_ms(arm, walkers)
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
        rows.append(dict(arm=arm, shape=f"{geo['grid']}x{geo['warps']}x"
                         f"{geo['rows']}", ms=ms,
                         ns_per_iter=ms * 1e6 / iters,
                         cycles_per_iter=cyc_iter,
                         cycles_per_walker_step=cyc_iter / walkers,
                         sm_mhz=cycles[best] / (times[best] * 1e3),
                         floor_ms=floor))
    return rows


def format_table(rows) -> str:
    lines = ["| arm | blocks x warps x rows | ms | ns/iter | cycles/iter | "
             "cycles/walker-step | SM MHz |", "|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(f"| {r['arm']} | {r['shape']} | {r['ms']:.4f} | "
                     f"{r['ns_per_iter']:.1f} | {r['cycles_per_iter']:.1f} | "
                     f"{r['cycles_per_walker_step']:.3f} | "
                     f"{r['sm_mhz']:.0f} |")
    return "\n".join(lines)


# Latencies in cycles assumed for the dependent-chain floor (not measured
# here): fixed-latency ALU 4, conversions 6, MUFU 16, shuffles and shared
# loads 24, warp reductions 30, loads that hit L1 33, barriers 20.
_LATENCY = {"F2I": 6, "I2F": 6, "F2F": 6, "MUFU": 16, "SHFL": 24,
            "LDS": 24, "REDUX": 30, "LDG": 33, "LD": 33, "BAR": 20,
            "DEPBAR": 33}
_NO_DEST = {"STG", "STS", "ST", "RED", "BAR", "BRA", "EXIT", "WARPSYNC",
            "NOP", "CALL", "RET", "BSSY", "BSYNC", "DEPBAR", "LDGDEPBAR",
            "LDGSTS", "YIELD"}
_COUNTED = ("SHFL", "VOTE", "REDUX", "FSETP", "FMNMX", "FSEL", "FMUL",
            "FADD", "FFMA", "MUFU", "F2I", "LOP3", "LDG", "LDS", "STS",
            "LDGSTS", "BAR", "LDL", "STL")


def _regs(token: str) -> list:
    """The registers a SASS operand names (``R4.64`` is R4 and R5)."""
    out = []
    for m in re.finditer(r"\b(U?R|U?P)(\d+)(\.64)?", token):
        n = int(m.group(2))
        out.append(f"{m.group(1)}{n}")
        if m.group(3):
            out.append(f"{m.group(1)}{n + 1}")
    return out


def loop_body(lines: list) -> list:
    """The instructions of the iteration loop: those from the earliest
    target of a backward branch to the last branch back to it (blocks the
    compiler moved past that branch, as a division's slow path, are not
    counted). ``lines`` are (address, instruction) pairs."""
    best = None
    for addr, ins in lines:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr:
            span = (int(m.group(1), 16), addr)
            if best is None or span[0] < best[0] or (
                    span[0] == best[0] and span[1] > best[1]):
                best = span
    if best is None:
        return []
    return [ins for addr, ins in lines if best[0] <= addr <= best[1]]


def chain_floor(body: list) -> int:
    """The longest dependent chain through one pass of ``body`` in cycles,
    each instruction taking ``_LATENCY`` (4 if absent) after the last of
    its sources is ready: a floor for one iteration that ignores issue."""
    ready, longest = {}, 0
    for ins in body:
        guard = re.match(r"@!?(U?P\d+)\s+", ins)
        text = ins[guard.end():] if guard else ins
        op, _, rest = text.rstrip(" ;").partition(" ")
        base = op.split(".")[0]
        ops = [o.strip() for o in rest.split(",")] if rest else []
        if base in _NO_DEST or not ops:
            dests, srcs = [], ops
        elif base.endswith("SETP") or base == "PLOP3":
            dests, srcs = ops[:2], ops[2:]
        elif re.match(r"U?P(\d|T)", ops[0]) and len(ops) > 1 and re.match(
                r"U?R", ops[1]):
            dests, srcs = ops[:2], ops[2:]
        else:
            dests, srcs = ops[:1], ops[1:]
        sources = [r for o in srcs for r in _regs(o)]
        if guard:
            sources.append(guard.group(1))
        start = max((ready.get(r, 0) for r in sources), default=0)
        done = start + _LATENCY.get(base, 4)
        width = 4 if ".128" in op else (2 if ".64" in op or "WIDE" in op
                                        else 1)
        for d in dests:
            regs = _regs(d)
            if regs and regs[0].startswith(("R", "UR")) and width > 1:
                pre = "UR" if regs[0].startswith("UR") else "R"
                n = int(regs[0][len(pre):])
                regs = [f"{pre}{n + i}" for i in range(width)]
            for r in regs:
                ready[r] = done
        longest = max(longest, done)
    return longest


def sass_counts() -> list:
    """Each kernel instance of ``csrc/step_bench.cu`` (built with the
    port's flags, then compiled to an sm_90a cubin and disassembled by
    ``tools/sass_diff.py:kernel_sass``): its arm, rows (a lane's, for
    ctl), registers (ptxas's report), the iteration loop's instruction
    count, the count of each opcode in ``_COUNTED`` there, and its
    dependent-chain floor (``chain_floor``). Needs nvcc and cuobjdump,
    not a GPU."""
    from ..kernels._build import kernel_resources
    from .sass_diff import canonical, kernel_sass

    _library()  # the build keeps ptxas's report
    registers = {canonical(k): r["registers"]
                 for k, r in kernel_resources("step_bench").items()}
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as tmp:
        kernels = kernel_sass(root, "step_bench",
                              os.path.join(tmp, "step_bench.cubin"),
                              addresses=True)
    out = []
    for name, lines in kernels.items():
        m = re.search(r"row_kernelILi(\d+)EE", name)
        c = re.search(r"ctl_kernelILi(\d+)EE", name)
        if not (m or c):
            continue
        body = loop_body(lines)
        ops = [re.sub(r"^@!?U?P\d+\s+", "", i).split(" ")[0].split(".")[0]
               for i in body]
        out.append(dict(arm=ARMS[int(m.group(1))] if m else "ctl",
                        rows=1 if m else int(c.group(1)),
                        registers=registers.get(name, 0), loop=len(body),
                        counts={k: ops.count(k) for k in _COUNTED},
                        chain=chain_floor(body)))
    return sorted(out, key=lambda r: (ARMS.index(r["arm"]), r["rows"]))


def format_sass(rows) -> str:
    lines = ["| arm | rows | registers | loop instructions | "
             + " | ".join(_COUNTED) + " | chain floor (cycles) |",
             "|---" * (len(_COUNTED) + 5) + "|"]
    for r in rows:
        lines.append(f"| {r['arm']} | {r['rows']} | {r['registers']} | "
                     f"{r['loop']} | "
                     + " | ".join(str(r["counts"][k]) for k in _COUNTED)
                     + f" | {r['chain']} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="step_bench", description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--walkers", type=int, default=128)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--arms", nargs="*", default=list(DEFAULT_ARMS),
                    choices=ARMS)
    ap.add_argument("--sass", action="store_true",
                    help="print each instance's loop instruction counts "
                         "(nvcc and cuobjdump; no GPU) and exit")
    args = ap.parse_args(argv)
    if args.sass:
        print(format_sass(sass_counts()))
        return 0
    if not torch.cuda.is_available():
        print("step_bench: needs a CUDA device", file=sys.stderr)
        return 1
    rows = measure(args.arms, args.walkers, args.iters, args.repeats)
    print(f"[step] {torch.cuda.get_device_name(0)}, W {args.walkers}, "
          f"{args.iters} iterations, launch floor "
          f"{min(r['floor_ms'] for r in rows):.4f} ms", file=sys.stderr)
    print(format_table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
