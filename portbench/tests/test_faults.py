"""A whole run of a tiny cell on the CPU (the look for a card skipped),
with the timed path broken underneath: each fault a rendering cell can
have turns ``correct`` false, and the sound program keeps it true.

* ``stale``: each frame returns the frame before it (a state left
  unchanged);
* ``half``: the bottom half of every tile left out (black);
* ``altered``: every bounce's throughput off by one part in ten thousand
  where shading produces it, as a lower-precision step would leave it.

The cell is held to the limit of its full-size counterpart. One chip, so
no exchange between chips can be left out."""

import pytest
import torch

from portbench.harness import cell, port

from .conftest import last_line


def _stale(monkeypatch):
    prev = []
    real = port.render

    def render(p, cam, cfg):
        img = real(p, cam, cfg)
        out = prev[-1] if prev else img
        prev.append(img)
        return out

    monkeypatch.setattr(port, "render", render)


def _half(monkeypatch):
    import raytpu_torch.engine.render as r

    real = r.render_tile

    def render_tile(*a, **k):
        tile = real(*a, **k)
        tile[tile.shape[0] // 2:] = 0.0
        return tile

    monkeypatch.setattr(r, "render_tile", render_tile)


def _altered(monkeypatch):
    import raytpu_torch.engine.render as r

    real = r._shade_core

    def shade(*a, **k):
        out = real(*a, **k)
        out["att_mult"] = out["att_mult"] * torch.tensor(1.0001)
        return out

    monkeypatch.setattr(r, "_shade_core", shade)


@pytest.mark.parametrize("fault,correct", [
    (None, True), (_stale, False), (_half, False), (_altered, False)])
def test_fault_turns_correct_false(tiny_root, monkeypatch, capsys, fault,
                                   correct):
    if fault is not None:
        fault(monkeypatch)
    rc = cell.run(["--workload", "atrium5k.path64", "--seed", "4000000003",
                   "--seconds", "3", "--trace", "0"], root=tiny_root,
                  dev="cpu")
    assert rc == 0
    line = last_line(capsys)
    assert line["correct"] is correct
    assert line["attempted"] >= 2
    value = line["checks"]["diverged_pct"]["value"]
    if correct:
        assert value == 0.0
    else:
        assert value > 3 * line["checks"]["diverged_pct"]["limit"]
