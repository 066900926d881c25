"""The per-step probe's plain replay (raytpu_torch.tools.step_bench)
against raytpu's Pallas kernel ``benchmarks/step_bench.py:_kernel`` run in
interpret mode, arm by arm, at W = 8 and 3 iterations (rtol 1e-5), and
on probe trees that make each arm's carried arithmetic visible in the
kernel's output, at 1 to 3 iterations; the property the kernel's row
split relies on (rows 0-7 the same at every W, in every arm but ctl);
the wrapper's launch shapes, refusals and SASS helpers.

Importing benchmarks/step_bench.py points JAX's persistent compilation
cache at RAYTPU_CACHE, so those cases run in a child process
(``@isolated``) with the cache in the test's temporary directory. The
CUDA kernel is held to the replay by the ``cuda``-marked test and by
chip_smoke.py (phase 8)."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from raytpu_torch.tools import step_bench as sb

from .conftest import isolated

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _raytpu_step_bench():
    spec = importlib.util.spec_from_file_location(
        "raytpu_step_bench", os.path.join(REPO, "benchmarks", "step_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _raytpu_kernel(arm: str, iters: int, w: int):
    """raytpu's ``_kernel`` for one arm as raytpu's ``main`` calls it, in
    interpret mode: a function of the tree (numpy) returning the scratch."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    rt = _raytpu_step_bench()
    fn = pl.pallas_call(
        functools.partial(rt._kernel, arm=arm, iters=iters, W=w),
        out_shape=jax.ShapeDtypeStruct((w, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((w, 128), jnp.float32),
                        pltpu.VMEM((w, 1), jnp.int32),
                        pltpu.SMEM((w, 1), jnp.int32),
                        pltpu.SemaphoreType.DMA],
        interpret=True,
    )
    return lambda tree: np.asarray(fn(jnp.asarray(tree.numpy())))


@isolated
def test_plain_arms_match_raytpu_kernel(monkeypatch, tmp_path):
    """Every arm, in one child process (each child pays JAX's start-up)."""
    monkeypatch.setenv("RAYTPU_CACHE", str(tmp_path / "jax_cache"))
    w, iters = 8, 3
    tree = sb.make_tree("cpu")
    for arm in sb.ARMS:
        want = _raytpu_kernel(arm, iters, w)(tree)
        got, acc = sb.step_bench_torch(tree, arm, iters, w)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   err_msg=arm)
        assert acc.shape == (w,) and bool(torch.isfinite(acc).all()), arm


def _carry_probes() -> dict:
    """Trees whose row 0 makes the carried element ``scratch[0, 0]`` show
    an arm's arithmetic. raytpu's kernel writes its state back only as
    ``acc[0] * 1e-20 + scratch[0, 0]``; on raytpu's tree that element is
    O(1) and the carry vanishes in f32. With ``tree[0, 0] = 0`` row 0's
    ``cur`` stays 0 (its rolls are no-ops, rows 0..W-1 are fetched) and the
    element is the sum of the carries themselves. Row 0 then picks the
    branch: its box (columns 0-5) holds lane 0 ("leaf", "inner") or no lane
    ("miss"); column 6 is the hit link (-5.5 a leaf, 12.3 an inner node),
    column 7 the miss link. For ``mt``, columns 8 and 9 start every lane at
    best t 10 and best slot -1000, so the carry is 10 plus the highest
    accepted slot of any lane."""
    tree = sb.make_tree("cpu")
    probes = {}
    for name in ("leaf", "inner", "miss"):
        p = tree.clone()
        if name == "miss":
            p[0] = -1.0
        p[0, 0] = 0.0
        if name != "miss":
            p[0, 1:6] = torch.tensor([-0.5, -0.5, 2.0, 2.0, 2.0])
        p[0, 6] = 12.3 if name == "inner" else -5.5
        p[0, 7] = 37.7
        probes[name] = p
    for name, seed in (("mt", None), ("mt2", 2)):
        p = tree.clone()
        if seed is not None:
            p[0] = torch.from_numpy(np.random.default_rng(seed).standard_normal(
                128, np.float32))
        p[0, 0], p[0, 8], p[0, 9] = 0.0, -990.0, -100.0
        probes[name] = p
    return probes


# the probes each arm's carry is held on; rollq's carry is 0 whenever
# cur = 0 (its pend is cur - 1), and the fetch arms' carry is the fetched
# element itself, so those arms are held by their scratch rows alone
CARRY_ARMS = {"full": ("leaf", "inner", "miss"),
              "noroll": ("leaf", "inner", "miss"),
              "roll2": ("leaf", "inner", "miss"),
              "slab": ("leaf", "inner", "miss"),
              "mt": ("mt", "mt2"), "ctl": ("leaf",)}


def test_carry_probes_take_each_branch():
    """The probes make the carry nonzero and drive it down different
    branches, so a wrong branch or a wrong term changes the compared
    element: the miss link on a miss, the hit link on an inner-node hit,
    the miss link plus the queued leaf at a leaf hit (the queue arms)."""
    probes = _carry_probes()
    w = 8
    for arm, names in CARRY_ARMS.items():
        for name in names:
            for iters in (1, 2, 3):
                got, _ = sb.step_bench_torch(probes[name], arm, iters, w)
                assert float(got[0, 0]) != 0.0, (arm, name, iters)

    def carry(arm, name):
        return float(sb.step_bench_torch(probes[name], arm, 1, w)[0][0, 0])

    for arm in ("full", "noroll", "roll2", "slab"):
        assert carry(arm, "miss") == pytest.approx(37e-29, rel=1e-6, abs=0.0)
        assert carry(arm, "inner") == pytest.approx(12e-29, rel=1e-6, abs=0.0)
    # the leaf's queued index ~(-5) = 4 rides the full arm's carry only
    assert carry("full", "leaf") == pytest.approx(
        (37e-9 + 4e-12) * 1e-20, rel=1e-6, abs=0.0)
    assert carry("slab", "leaf") == carry("slab", "miss")
    # best t 10 plus the highest accepted slot (7 and 5)
    assert carry("mt", "mt") == pytest.approx(17e-32, rel=1e-6, abs=0.0)
    assert carry("mt", "mt2") == pytest.approx(15e-32, rel=1e-6, abs=0.0)


@isolated
def test_plain_carry_matches_raytpu_kernel(monkeypatch, tmp_path):
    """The carried element of each arm that carries one, on the probes, at
    1, 2 and 3 iterations: the whole scratch at rtol 1e-5 with no absolute
    slack, so the tiny carry in ``scratch[0, 0]`` is held relatively."""
    monkeypatch.setenv("RAYTPU_CACHE", str(tmp_path / "jax_cache"))
    probes = _carry_probes()
    w = 8
    for arm, names in CARRY_ARMS.items():
        for iters in (1, 2, 3):
            kernel = _raytpu_kernel(arm, iters, w)
            for name in names:
                want = kernel(probes[name])
                got, _ = sb.step_bench_torch(probes[name], arm, iters, w)
                assert want[0, 0] != 0.0, (arm, name, iters)
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                           atol=0.0,
                                           err_msg=f"{arm} {name} {iters}")


@isolated
def test_roll_is_pallas_roll():
    """The replay's rolls (torch.roll) against ``pltpu.roll`` in interpret
    mode at every shift the arms use: the conditional chain's 128 - 2^b
    for b in 3..6 and the queue's 1. Row 0's rolls never reach raytpu's
    output (its carry needs cur = 0), so the primitive is held here."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    x = sb.make_tree("cpu")[:8]
    for shift in (120, 112, 96, 64, 1):
        def kernel(x_ref, o_ref, shift=shift):
            o_ref[...] = pltpu.roll(x_ref[...], shift, 1)

        want = pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
            interpret=True)(jnp.asarray(x.numpy()))
        np.testing.assert_array_equal(torch.roll(x, shift, 1).numpy(),
                                      np.asarray(want), err_msg=str(shift))
    amt = torch.tensor([[0], [8], [24], [120], [64], [16], [40], [96]])
    got = sb._roll_chain(x, amt, (3, 4, 5, 6))
    for i in range(8):
        # the chain rolls row i left by amt[i] lanes in all
        assert torch.equal(got[i], torch.roll(x[i], -int(amt[i]), 0)), i


def test_tree_is_raytpus():
    tree = sb.make_tree("cpu")
    assert tree.shape == (1024, 128) and tree.dtype == torch.float32
    want = np.random.default_rng(0).standard_normal((1024, 128), np.float32)
    np.testing.assert_array_equal(tree.numpy(), want)


def test_f2i_converts_like_xla():
    """Toward zero, saturating, NaN -> 0: XLA's f32 -> i32 conversion."""
    import jax.numpy as jnp

    x = np.array([0.0, -0.0, 1.9, -1.9, 2147483520.0, 2147483648.0, 1e10,
                  -2147483648.0, -1e10, np.inf, -np.inf, np.nan, 123456.7],
                 np.float32)
    got = sb._f2i(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.asarray(x).astype(jnp.int32))
    np.testing.assert_array_equal(got, want)


def test_replay_carries_state_through_iterations():
    """Arms that fetch rows change the scratch from one iteration to the
    next; zero iterations leave the tree's rows and a zero carry."""
    tree = sb.make_tree("cpu")
    out0, acc0 = sb.step_bench_torch(tree, "fetch", 0, 8)
    assert torch.equal(out0, tree[:8]) and bool((acc0 == 0).all())
    one, _ = sb.step_bench_torch(tree, "fetch", 1, 8)
    two, _ = sb.step_bench_torch(tree, "fetch", 2, 8)
    assert not torch.equal(one, two)
    with pytest.raises(ValueError, match="unknown arm"):
        sb.step_bench_torch(tree, "nope", 1, 8)


def test_dispatch_and_cuda_wrapper_refuses_cpu():
    tree = sb.make_tree("cpu")
    before = sb.step_bench_cuda.launches
    for x, y in zip(sb.step_bench(tree, "mt", 2, 8),
                    sb.step_bench_torch(tree, "mt", 2, 8)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        sb.step_bench_cuda(tree, "full", 2, 8)
    assert sb.step_bench_cuda.launches == before


def test_main_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("this checks the CPU-only refusal")
    assert sb.main(["--iters", "2", "--walkers", "8"]) == 1
    assert "needs a CUDA device" in capsys.readouterr().err


@pytest.mark.cuda
def test_kernel_bit_equal_replay_on_cuda():
    """step_bench.cu against the plain replay on the card, every arm, at W
    8, 40 and 1024: the row arms in 2, 10 and 256 blocks of 4 warps, ctl
    in one block with lanes past W at W 8 and 40 (1 and 2 rows a lane)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (chip_smoke.py runs this on one)")
    tree = sb.make_tree("cuda")
    for walkers in (8, 40, 1024):
        for arm in sb.ARMS:
            out_k, acc_k, cycles = sb.step_bench_cuda(tree, arm, 16, walkers)
            out_p, acc_p = sb.step_bench_torch(tree, arm, 16, walkers)
            torch.cuda.synchronize()
            assert torch.equal(out_k.view(torch.int32),
                               out_p.view(torch.int32)), (arm, walkers)
            assert torch.equal(acc_k.view(torch.int32),
                               acc_p.view(torch.int32)), (arm, walkers)
            assert int(cycles) > 0


def _same_bits(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


SPLIT_ARMS = [arm for arm in sb.ARMS if arm != "ctl"]


@pytest.mark.parametrize("arm", SPLIT_ARMS)
def test_rows_split_over_blocks(arm):
    """What the kernel's row split relies on: in every arm but ctl, a
    row's state and carry depend only on itself, the tree and row 0, so
    rows 0-7 come out the same whatever W is. Held at W 8 against W 64
    and 128, at 1 to 5 iterations, on raytpu's tree and on the probes."""
    trees = {"tree": sb.make_tree("cpu"), **_carry_probes()}
    for name, tree in trees.items():
        for iters in range(1, 6):
            out8, acc8 = sb.step_bench_torch(tree, arm, iters, 8)
            for walkers in (64, 128):
                out, acc = sb.step_bench_torch(tree, arm, iters, walkers)
                assert _same_bits(out[:8], out8), (name, iters, walkers)
                assert _same_bits(acc[:8], acc8), (name, iters, walkers)


def test_ctl_is_not_split():
    """ctl reduces over all W rows every iteration, so its result depends
    on W: the carry counts every row's queue (raytpu's tree), and a tree
    whose first 8 rows have no next link takes the leaf branch at W 8 but
    not at W 64, where later rows have one. Its kernel is one block."""
    tree = sb.make_tree("cpu")
    _, acc8 = sb.step_bench_torch(tree, "ctl", 1, 8)
    _, acc64 = sb.step_bench_torch(tree, "ctl", 1, 64)
    assert not _same_bits(acc64[:8], acc8)
    p = tree.clone()
    p[:8, 0], p[:8, 1] = 0.0, 1.0  # cur 0 (no next link), queue 3
    out8, _ = sb.step_bench_torch(p, "ctl", 1, 8)
    out64, _ = sb.step_bench_torch(p, "ctl", 1, 64)
    assert float(out8[0, 0]) == 1.0  # do_leaf: scratch[0, 0] + 1
    assert float(out64[0, 0]) != float(out8[0, 0])
    assert torch.equal(out64[1:8], out8[1:8])
    for walkers in (8, 128, 1024):
        assert sb.launch_geometry("ctl", walkers)["grid"] == 1


def test_launch_shape_defaults():
    """Rows a warp x warps a block for the row arms; ctl one block of 4
    rows a lane above W 128, one warp up to it."""
    for arm in SPLIT_ARMS:
        for walkers in (8, 40, 128, 1024):
            assert sb.launch_shape(arm, walkers) == (1, 4)
    assert [sb.launch_shape("ctl", w) for w in (8, 40, 64, 128, 136, 1024)] \
        == [(1, 1), (2, 1), (2, 1), (4, 1), (4, 2), (4, 8)]


@pytest.mark.parametrize("walkers", [8, 40, 128, 1000, 1024])
def test_launch_geometry_covers_w(walkers):
    """Every arm's launch covers rows 0..W-1 exactly once: the row arms in
    W / 4 full blocks of 4 warps, one row a warp, ctl in one block whose
    last warp holds at least one row."""
    for arm in sb.ARMS:
        geo = sb.launch_geometry(arm, walkers)
        per_block = geo["rows"] * geo["warps"] * (32 if arm == "ctl" else 1)
        assert (geo["grid"] - 1) * per_block < walkers
        assert geo["grid"] * per_block >= walkers
        extra = 32 if arm == "mt" else 0  # mt's row-0 warp
        assert geo["threads"] == 32 * geo["warps"] + extra
        if arm == "ctl":
            assert geo["grid"] == 1
            assert 32 * geo["rows"] * (geo["warps"] - 1) < walkers
        else:
            assert geo["grid"] * 4 == walkers and geo["rows"] == 1


def test_launch_geometry_shared_memory():
    """The dynamic shared memory a block needs: fetchdep a warp's slots
    twice (own rows and row 0's chain), fetchmir the block's index mirror
    rounded up to 16 bytes, ctl two buffers of five counts a warp, install
    a 128-float row a warp, mt row 0's cur twice; fetchmir's index buffer
    holds every block's mirror."""
    g = sb.launch_geometry
    assert g("full", 128)["smem"] == 0
    assert g("fetchdep", 128)["smem"] == 4 * 2 * 2 * 4
    assert g("fetchmir", 128)["smem"] == 8 * 4
    assert g("fetchmir", 128)["idx"] == 32 * 8
    assert g("fetchmir", 8)["idx"] == 2 * 8
    assert g("full", 128)["idx"] == 1
    assert g("ctl", 1024)["smem"] == 2 * 8 * 5 * 4
    assert g("ctl", 128)["smem"] == 2 * 1 * 5 * 4
    assert g("install", 128)["smem"] == 4 * 128 * 4
    assert g("mt", 128)["smem"] == 8


def test_launch_refusals():
    """W a multiple of 8 in [8, 1024] and a known arm, from the launch
    helpers and the wrapper alike."""
    for walkers in (0, 4, 12, 1025, 1032, 2048):
        with pytest.raises(ValueError, match="multiple of 8"):
            sb.launch_geometry("full", walkers)
        with pytest.raises(ValueError, match="multiple of 8"):
            sb.launch_shape("ctl", walkers)
    with pytest.raises(ValueError, match="unknown arm"):
        sb.launch_geometry("nope", 8)
    with pytest.raises(ValueError, match="unknown arm"):
        sb.launch_shape("nope", 8)
    tree = sb.make_tree("cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        sb.step_bench_cuda(tree, "full", 1, 1024)


SASS = [(0x10, "MOV R2, R9 ;"),
        (0x20, "SHFL.IDX PT, R3, R2, RZ, 0x1f ;"),
        (0x30, "FMUL R4, R3, 1000000 ;"),
        (0x40, "F2I.TRUNC.NTZ R5, R4 ;"),
        (0x50, "LDG.E.128.CONSTANT R12, desc[UR4][R6.64] ;"),
        (0x60, "FADD R8, R15, R5 ;"),
        (0x70, "FSETP.GEU.AND P0, PT, R8, 0.5, PT ;"),
        (0x80, "@P0 BRA 0xa0 ;"),
        (0x90, "BRA 0x10 ;"),
        (0xa0, "BRA 0x30 ;"),
        (0xb0, "EXIT ;")]


def test_sass_loop_body_and_chain_floor():
    """The iteration loop is the span back to the earliest target of a
    backward branch (0x10, from 0x90; the block at 0xa0 that branches back
    into it is not counted), and the chain floor follows registers through
    it: MOV 4, SHFL 24, FMUL 4, F2I 6, then the load into R12..R15 (R6
    and R7 not written before it: 33 from 0) joins at the FADD, 38 + 4,
    FSETP 4, the branch 4 on P0."""
    body = sb.loop_body(SASS)
    assert body == [ins for _, ins in SASS[:9]]
    assert sb.chain_floor(["MOV R2, R9 ;", "SHFL.IDX PT, R3, R2, RZ, 0x1f ;",
                           "FMUL R4, R3, 1000000 ;"]) == 4 + 24 + 4
    assert sb.chain_floor(body) == 4 + 24 + 4 + 6 + 4 + 4 + 4
    # the 128-bit load writes R4..R7: the FADD waits for it, and the load
    # has overwritten what the F2I put in R5
    assert sb.chain_floor(["LDG.E.128.CONSTANT R4, desc[UR4][R6.64] ;",
                           "FADD R8, R7, R1 ;"]) == 33 + 4
    assert sb.chain_floor(["F2I.TRUNC.NTZ R5, R4 ;",
                           "LDG.E.128.CONSTANT R4, desc[UR4][R6.64] ;",
                           "FADD R8, R5, R5 ;"]) == 33 + 4
    assert sb.loop_body([(0x10, "EXIT ;")]) == []
