"""raytpu's fused wave mode in the port's engine
(raytpu_torch.engine.render: ``_compact_tiers``, ``_bounce_work``,
``_fused_bounces``, the width switch ``_wave_mode``) against its query
schedule and against raytpu. RAYTPU_LARGE_WAVE forces either schedule
on the gallery's 2,048-lane tile: 1 fused, 2^30 query.

Fused mode sorts only the previous bounce's work tier, runs each bounce
on the smallest tier holding every live lane and unsorts once at path
exit. Per-lane math never depends on order or width, so the frame must
equal the query schedule's: 0 PNG pixels differ (f32 frames to atol 1e-6)
and ``count_rays`` is the same. The gallery tile here has 2048 lanes, so
``RAYTPU_COMPACT_DIV=8,2`` gives tiers of 256 and 1024 lanes."""

import functools

import numpy as np
import pytest

import raytpu
from raytpu.engine import render as rt_render
from raytpu.io.png import quantize_rgba32f
from raytpu_torch.engine import render
from raytpu_torch.types import RenderConfig

from .imgdiff import assert_images_equiv
from .test_torch_render import _packs

CFG = dict(width=64, height=32, seed=11, samples=1, bounces=3, chunk_size=16)


@pytest.mark.parametrize("r", [100, 2047, 2048, 5000, 65536, 2088960])
@pytest.mark.parametrize("div", [None, "16,4,2", "8,2", "3,1,5", "2"])
def test_compact_tiers_equal_raytpu(monkeypatch, r, div):
    if div is None:
        monkeypatch.delenv("RAYTPU_COMPACT_DIV", raising=False)
    else:
        monkeypatch.setenv("RAYTPU_COMPACT_DIV", div)
    got = render._compact_tiers(r)
    assert got == rt_render._compact_tiers(r)
    assert all(t % 256 == 0 and t < r for t in got)


# RAYTPU_LARGE_WAVE that forces each schedule on a 2,048-lane tile
LARGE_WAVE = {"fused": "1", "query": str(1 << 30), None: None}


def _render(monkeypatch, mode=None, persistent=None, cfg=CFG, **extra):
    """The gallery at 64x32 through the strand route, with
    RAYTPU_COMPACT_DIV=8,2 and the given wave mode (None: the width's):
    (frame, the last path's WAVE_STATS)."""
    monkeypatch.setenv("RAYTPU_COMPACT_DIV", "8,2")
    for name, value in (("RAYTPU_LARGE_WAVE", LARGE_WAVE[mode]),
                        ("RAYTPU_STRAND_PERSISTENT", persistent)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    for name, value in extra.items():
        monkeypatch.setenv(name, value)
    (pack, cam), _ = _packs("gallery", 64, 32)
    frame = render.render_frame(pack, cam, RenderConfig(**cfg))
    return frame, dict(render.WAVE_STATS)


def _png_diff(a, b) -> int:
    return int(np.any(quantize_rgba32f(a) != quantize_rgba32f(b),
                      axis=-1).sum())


def test_fused_frame_equals_query_frame(monkeypatch):
    fused, waves = _render(monkeypatch, "fused")
    query, waves_q = _render(monkeypatch, "query")
    assert waves["mode"] == "fused" and waves_q["mode"] == "query"
    assert waves_q["widths"] == [2048] * 3
    # bounce 0 at full width, then tiers; more than one width ran
    assert waves["widths"][0] == 2048 and len(set(waves["widths"])) > 1
    assert all(w in (256, 1024, 2048) for w in waves["widths"])
    assert _png_diff(fused, query) == 0
    np.testing.assert_allclose(fused, query, rtol=0, atol=1e-6)
    assert float((quantize_rgba32f(fused).max(-1) > 0).mean()) > 0.5


@functools.lru_cache(maxsize=None)
def _raytpu_frame():
    _, (rpack, rcam) = _packs("gallery", 64, 32)
    return rt_render.render_frame(rpack, rcam, raytpu.RenderConfig(**CFG))


def test_fused_frame_matches_raytpu(monkeypatch):
    """Against raytpu's default CPU route on the same scene and seed, with
    tests/imgdiff.py's bar on the PNG pixels."""
    fused, waves = _render(monkeypatch, "fused")
    assert waves["mode"] == "fused"
    ref = _raytpu_frame()
    assert_images_equiv(quantize_rgba32f(fused) / 255.0,
                        quantize_rgba32f(ref) / 255.0)


def test_count_rays_equal_in_both_modes(monkeypatch):
    (pack, cam), (rpack, rcam) = _packs("gallery", 64, 32)
    monkeypatch.setenv("RAYTPU_COMPACT_DIV", "8,2")
    counts = {}
    for mode in ("fused", "query"):
        monkeypatch.setenv("RAYTPU_LARGE_WAVE", LARGE_WAVE[mode])
        counts[mode] = render.count_rays(pack, cam, RenderConfig(**CFG))
        assert render.WAVE_STATS["mode"] == mode
    assert counts["fused"] == counts["query"]
    monkeypatch.delenv("RAYTPU_LARGE_WAVE")
    assert counts["query"] == rt_render.count_rays(
        rpack, rcam, raytpu.RenderConfig(**CFG))


@pytest.mark.parametrize("layout", [
    {}, {"tile_rows": 7}, {"samples": 2}],
    ids=["one_tile", "tile_rows7", "samples2"])
@pytest.mark.parametrize("mode", ["fused", "query"])
def test_count_rays_equals_raytpu(monkeypatch, mode, layout):
    """``count_rays`` counts the live lanes: raytpu's count in either
    schedule, on one tile, on 7-row tiles (each padded to 32 rows, whose
    padding lanes alias the next tile's pixels and are not counted) and
    over two samples."""
    (pack, cam), (rpack, rcam) = _packs("gallery", 64, 32)
    monkeypatch.setenv("RAYTPU_COMPACT_DIV", "8,2")
    monkeypatch.setenv("RAYTPU_LARGE_WAVE", LARGE_WAVE[mode])
    cfg = {**CFG, **layout}
    got = render.count_rays(pack, cam, RenderConfig(**cfg))
    assert render.WAVE_STATS["mode"] == mode
    monkeypatch.delenv("RAYTPU_LARGE_WAVE")
    assert got == rt_render.count_rays(rpack, rcam,
                                       raytpu.RenderConfig(**cfg)) > 64 * 32


def test_large_wave_threshold_selects_fused(monkeypatch):
    """The default mode is width-gated: query below RAYTPU_LARGE_WAVE
    (2^20 lanes), fused at or above it, with no other switch."""
    monkeypatch.delenv("RAYTPU_LARGE_WAVE", raising=False)
    default, waves = _render(monkeypatch)
    assert waves["mode"] == "query"
    lowered, waves = _render(monkeypatch, RAYTPU_LARGE_WAVE="2048")
    assert waves["mode"] == "fused"
    assert _png_diff(default, lowered) == 0
    _, waves = _render(monkeypatch, RAYTPU_LARGE_WAVE="2049")
    assert waves["mode"] == "query"


def test_fused_mode_needs_sorted_immediate_waves(monkeypatch):
    """Fused mode applies to sorted waves with immediate NEE; the brute
    route (unsorted) keeps the query schedule."""
    monkeypatch.setenv("RAYTPU_LARGE_WAVE", LARGE_WAVE["fused"])
    (pack, cam), _ = _packs("gallery", 64, 32)
    render.render_frame(pack, cam, RenderConfig(**CFG, intersector="brute"))
    assert render.WAVE_STATS["mode"] == "query"


def test_block_route_fused_equals_persistent_route(monkeypatch):
    """RAYTPU_STRAND_PERSISTENT=0 sends every strand query through the
    block walk; under fused mode its PNG equals the per-ray walk's."""
    persistent, _ = _render(monkeypatch, "fused")
    block, waves = _render(monkeypatch, "fused", persistent="0")
    assert waves["mode"] == "fused"
    assert _png_diff(block, persistent) == 0


@pytest.mark.parametrize("persistent", [None, "0"], ids=["per_ray", "block"])
@pytest.mark.parametrize("bounces", [1, 2, 4])
def test_fused_frame_bit_equal_query_frame(monkeypatch, bounces, persistent):
    """The fused frame is the query schedule's bit for bit, whatever the
    bounce count, on the per-ray walk and on the block walk
    (RAYTPU_STRAND_PERSISTENT=0)."""
    cfg = {**CFG, "bounces": bounces}
    fused, waves = _render(monkeypatch, "fused", persistent, cfg)
    query, waves_q = _render(monkeypatch, "query", persistent, cfg)
    assert waves["mode"] == "fused" and waves_q["mode"] == "query"
    assert waves_q["widths"] == [2048] * len(waves_q["widths"])
    assert np.array_equal(fused, query)
