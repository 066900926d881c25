"""The port's copy of raytpu's procedural bench scene
(``raytpu_torch/tools/scenes.py``) against ``benchmarks/scenes.py``: the
atrium's SceneData byte for byte at targets 5,000 and 20,000 (bench.py's
quick size), and ``cached_atrium``'s pickled host pack against a fresh
pack."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmarks.scenes import build_atrium as rt_build_atrium
from raytpu_torch.scene.pack import pack_scene
from raytpu_torch.tools import scenes
from raytpu_torch.types import BvhPack


def _same(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, name
    assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("tris", [5000, 20000])
def test_build_atrium_equals_raytpus(tris):
    got, want = scenes.build_atrium(tris), rt_build_atrium(tris)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "camera":
            for g in dataclasses.fields(b):
                _same(getattr(a, g.name), getattr(b, g.name),
                      f"camera.{g.name}")
        elif f.name == "textures":
            assert a == b == []
        else:
            _same(a, b, f.name)


def _tables(pack):
    """Every table of a pack, by name (the BvhPack's as bvh.<name>)."""
    out = {}
    for f in dataclasses.fields(pack):
        v = getattr(pack, f.name)
        if isinstance(v, BvhPack):
            out.update({f"bvh.{g.name}": getattr(v, g.name)
                        for g in dataclasses.fields(v)})
        else:
            out[f.name] = v
    return out


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("tables", ["auto", "stream"])
def test_cached_atrium_round_trip_equals_fresh_pack(tmp_path, monkeypatch,
                                                    tables):
    first = scenes.cached_atrium(5000, "cpu", tables=tables, cache=tmp_path)
    assert [p.name for p in tmp_path.iterdir()] == [
        f"atrium_torch_5000_{tables}_v{scenes.SCHEMA}.pkl"]

    def no_pack(*a, **k):
        raise AssertionError("the pickle was not read")

    monkeypatch.setattr(scenes, "pack_scene", no_pack)
    again = scenes.cached_atrium(5000, "cpu", tables=tables, cache=tmp_path)
    fresh = pack_scene(scenes.build_atrium(5000), as_numpy=True,
                       tables=tables)
    want = _tables(fresh)
    for pack in (first[1], again[1]):
        assert pack.device.type == "cpu" and not pack.on_host
        got = _tables(pack)
        assert got.keys() == want.keys()
        for k, v in want.items():
            if v is None or isinstance(v, bool):
                assert got[k] is v, k
            else:
                _same(_host(got[k]), v, k)
