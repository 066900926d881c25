"""``_pixel_layout`` (``raytpu_torch/engine/render.py``), the tile's pixel
order: the 32x32-block layout of packet mode and the row order of the
brute and bvh routes, held to raytpu's ``_pixel_layout`` element for
element (same order, same padding lanes, int32), and its ``unpermute``
to raytpu's. The layout is built on the tile's device with torch integer
ops: tracing it makes no ``.sync`` span, and on the card (``cuda``
marker) it runs under ``set_sync_debug_mode("error")`` and a small
frame's ``.sync`` spans are only the engine's and the readback's.

The CPU tests import raytpu (JAX) inside the test; the ``cuda`` tests do
not, so on a machine with the card:
``python -m pytest --noconftest tests/test_torch_layout.py -m cuda``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from raytpu_torch.engine.render import _pixel_layout, render_frame

from .test_torch_spans import _card, _config, _packed, _spans, _traced

SIZES = [(1, 1), (31, 33), (32, 32), (64, 36), (640, 360), (1920, 1080)]


def _rt_layout(w: int, tile_h: int, packet_mode: bool):
    from raytpu.engine.render import _pixel_layout as rt_pixel_layout

    return rt_pixel_layout(w, tile_h, packet_mode)


def _held(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w,tile_h", SIZES)
def test_packet_layout_is_raytpus(w, tile_h):
    px, py, _ = _pixel_layout(w, tile_h, True, "cpu")
    rt_px, rt_py, _ = _rt_layout(w, tile_h, True)
    _held(px, rt_px)
    _held(py, rt_py)


@pytest.mark.parametrize("w,tile_h", SIZES)
def test_unpermute_is_raytpus(w, tile_h):
    """A [R, 4] buffer of lane ids comes back as raytpu's [tile_h, w, 4]:
    every pixel holds the lane that rendered it, padding lanes drop."""
    import jax.numpy as jnp

    px, _, unpermute = _pixel_layout(w, tile_h, True, "cpu")
    _, _, rt_unpermute = _rt_layout(w, tile_h, True)
    lanes = np.arange(px.numel() * 4, dtype=np.int32).reshape(-1, 4)
    got = unpermute(torch.from_numpy(lanes))
    want = np.asarray(rt_unpermute(jnp.asarray(lanes)))
    assert tuple(got.shape) == want.shape == (tile_h, w, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_row_order_layout_is_raytpus():
    w, tile_h = 31, 33
    px, py, unpermute = _pixel_layout(w, tile_h, False, "cpu")
    rt_px, rt_py, _ = _rt_layout(w, tile_h, False)
    _held(px, rt_px)
    _held(py, rt_py)
    lanes = torch.arange(w * tile_h * 4, dtype=torch.int32).reshape(-1, 4)
    assert torch.equal(unpermute(lanes)[2, 5], lanes[2 * w + 5])


def test_layout_makes_no_sync_span():
    """Under the profiler the packet layout opens no program span: it
    copies nothing from the host and waits for nothing."""
    _, events = _traced(lambda: _pixel_layout(1920, 1080, True, "cpu"))
    assert [s[2] for s in _spans(events)] == []


@pytest.mark.cuda
def test_layout_on_card_never_syncs():
    dev = _card()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        px, py, _ = _pixel_layout(1920, 1080, True, dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert px.device.type == py.device.type == "cuda"
    cpu_px, cpu_py, _ = _pixel_layout(1920, 1080, True, "cpu")
    assert px.dtype == py.dtype == torch.int32
    assert torch.equal(px.cpu(), cpu_px) and torch.equal(py.cpu(), cpu_py)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,syncs", [("path", 6), ("flat", 2)])
def test_small_frame_sync_spans_on_card(mode, syncs):
    """A 64x36 frame, one tile: the path frame's syncs are the engine's
    attenuation copy, its four live-lane reads and the readback; the flat
    frame's the walk's tmax and the readback. None is the layout's."""
    dev = _card()
    pack, cam = _packed(dev)
    cfg = _config(mode, width=64, height=36, samples=1, tile_rows=None)
    render_frame(pack, cam, cfg)  # builds and warms everything
    _, events = _traced(lambda: render_frame(pack, cam, cfg), dev)
    marked = [s[2] for s in _spans(events) if ".sync" in s[2]]
    print(f"{mode} 64x36: {marked}")
    assert len(marked) == syncs
