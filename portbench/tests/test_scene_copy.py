"""The frozen atrium is byte-equal to the program's copy of raytpu's
``build_atrium`` (``raytpu_torch/tools/scenes.py``), which this test, and
never the harness, imports."""

import dataclasses

import numpy as np
import pytest

from portbench.scenes import atrium


def _same(a, b, name):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, name
    assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("tris", [5000, 20000])
def test_frozen_atrium_equals_the_programs(tris):
    from raytpu_torch.tools.scenes import build_atrium

    got, want = atrium.build_atrium(tris), build_atrium(tris)
    names = set()
    for f in dataclasses.fields(want):
        if f.name == "camera":
            _same(got["camera_world"], want.camera.world, "camera.world")
            _same(got["camera_projection"], want.camera.projection,
                  "camera.projection")
        elif f.name == "textures":
            assert want.textures == []
        else:
            _same(got[f.name], getattr(want, f.name), f.name)
            names.add(f.name)
    assert set(got) == names | {"camera_world", "camera_projection"}


def test_build_is_the_configurations_scene():
    a = atrium.build(target_tris=5000)
    b = atrium.build_atrium(5000)
    assert a.keys() == b.keys()
    for k in a:
        _same(a[k], b[k], k)
