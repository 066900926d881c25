"""raytpu_torch.engine.progressive: checkpoint/resume on the CPU.

A render interrupted after k of its tiles (the tile generator stopped
with an exception, as a killed process stops) and resumed from its
checkpoint must equal the uninterrupted render and ``render_frame`` bit
for bit, and must not render the saved tiles again. A checkpoint written
under another seed, camera or scene, one with no key, or one of another
shape restarts from row 0. The file is raytpu's ``.npz`` layout, and the
key is raytpu's on the same inputs: a checkpoint written by one package
and interrupted is resumed by the other (the brute sweep on both sides,
an XLA route on raytpu's), within ``tests/imgdiff.py``'s bar of raytpu's
uninterrupted frame."""

import dataclasses
import functools

import numpy as np
import pytest

import raytpu
from raytpu.engine import progressive as rt_progressive
from raytpu.engine import render as rt_render
from raytpu.io.png import quantize_rgba32f
from raytpu.scene.pack import pack_camera as rt_pack_camera
from raytpu.scene.pack import pack_scene as rt_pack_scene
from raytpu_torch.engine import progressive, render
from raytpu_torch.scene.camera import camera_from_lookat
from raytpu_torch.scene.gltf import load_scene
from raytpu_torch.scene.pack import pack_camera, pack_scene
from raytpu_torch.types import RenderConfig

from .imgdiff import assert_images_equiv
from .test_torch_host import AT, EYE, FOV, scene_path

# 4 tiles of 4 rows on the gallery (strand route, plain walk)
CFG = RenderConfig(width=32, height=16, seed=5, samples=1, bounces=2,
                   chunk_size=16, tile_rows=4)


@functools.lru_cache(maxsize=None)
def _scene(name="gallery"):
    return pack_scene(load_scene(scene_path(name)), "cpu")


@functools.lru_cache(maxsize=None)
def _camera(eye=tuple(EYE)):
    return pack_camera(camera_from_lookat(list(eye), AT, FOV, 32, 16), "cpu")


@functools.lru_cache(maxsize=None)
def _frame(name="gallery", eye=tuple(EYE), seed=CFG.seed):
    from dataclasses import replace

    return render.render_frame(_scene(name), _camera(eye),
                               replace(CFG, seed=seed))


class _Killed(Exception):
    pass


def _tile_spy(monkeypatch, stop_after=None, module=progressive):
    """Count the tiles ``module`` renders; raise after ``stop_after``."""
    seen = []
    real = module.render_frame_tiles

    def tiles(*args, **kwargs):
        for item in real(*args, **kwargs):
            if stop_after is not None and len(seen) == stop_after:
                raise _Killed
            seen.append(item[0])
            yield item

    monkeypatch.setattr(module, "render_frame_tiles", tiles)
    return seen


@pytest.mark.parametrize("k,save_every,resume_at", [(1, 1, 4), (3, 1, 12),
                                                    (3, 2, 8)])
def test_interrupted_render_resumes_bit_equal(tmp_path, monkeypatch, k,
                                              save_every, resume_at):
    path = str(tmp_path / "ck.npz")
    pack, cam = _scene(), _camera()
    with monkeypatch.context() as m:
        _tile_spy(m, stop_after=k)
        with pytest.raises(_Killed):
            progressive.render_with_checkpoint(pack, cam, CFG, path,
                                               save_every=save_every)
    with np.load(path) as ck:
        assert sorted(ck.files) == ["frame", "key", "next_y0"]
        assert int(ck["next_y0"]) == resume_at
        assert not ck["frame"][resume_at:].any()
    seen = _tile_spy(monkeypatch)
    resumed = progressive.render_with_checkpoint(pack, cam, CFG, path,
                                                 save_every=save_every)
    assert seen == list(range(resume_at, 16, 4))  # saved tiles not redone
    whole = progressive.render_with_checkpoint(pack, cam, CFG,
                                               str(tmp_path / "whole.npz"))
    np.testing.assert_array_equal(resumed, whole)
    np.testing.assert_array_equal(resumed, _frame())
    assert (resumed[..., :3].max(-1) > 0).mean() > 0.5
    with np.load(path) as ck:
        assert int(ck["next_y0"]) == 16
        np.testing.assert_array_equal(ck["frame"], resumed)


def _write_other(path, other):
    """A finished checkpoint that must not be resumed under CFG."""
    from dataclasses import replace

    pack, cam, cfg = _scene(), _camera(), CFG
    if other == "seed":
        cfg = replace(CFG, seed=6)
    elif other == "camera":
        cam = _camera((1.0, 2.5, -9.0))
    elif other == "scene":
        pack = _scene("small")
    if other in ("seed", "camera", "scene"):
        progressive.render_with_checkpoint(pack, cam, cfg, path)
        return
    key = progressive._ckpt_key(_scene(), _camera(), CFG)
    junk = np.full((16, 32, 4), 0.5, np.float32)
    if other == "no_key":  # a checkpoint of raytpu's legacy layout
        np.savez(path, frame=junk, next_y0=np.int64(16))
    else:  # "shape": the right key on a frame of another shape
        np.savez(path, frame=junk[:8], next_y0=np.int64(8), key=key)


@pytest.mark.parametrize("other", ["seed", "camera", "scene", "no_key",
                                   "shape"])
def test_foreign_checkpoint_restarts(tmp_path, monkeypatch, other):
    path = str(tmp_path / "ck.npz")
    _write_other(path, other)
    seen = _tile_spy(monkeypatch)
    got = progressive.render_with_checkpoint(_scene(), _camera(), CFG, path)
    assert seen == [0, 4, 8, 12]
    np.testing.assert_array_equal(got, _frame())


def test_key_reads_the_fingerprint_facts():
    from dataclasses import replace

    pack, cam = _scene(), _camera()
    key = progressive._ckpt_key(pack, cam, CFG)
    assert key == progressive._ckpt_key(pack, cam, CFG)
    assert len(key) == 64
    lights = pack.light_table.clone()
    lights[0, 0] += 1.0
    others = [
        (pack, cam, replace(CFG, bounces=3)),
        (pack, _camera((1.0, 2.5, -9.0)), CFG),
        (replace(pack, light_table=lights), cam, CFG),
        (replace(pack, mat_table=pack.mat_table * 2), cam, CFG),
        (replace(pack, scene_bmax=pack.scene_bmax + 1), cam, CFG),
    ]
    assert len({progressive._ckpt_key(*o) for o in others} | {key}) == 6


@functools.lru_cache(maxsize=None)
def _raytpu(name="small"):
    path = scene_path(name)
    return (rt_pack_scene(raytpu.load_scene(path)),
            rt_pack_camera(raytpu.camera_from_lookat(EYE, AT, FOV, 32, 16)))


def _rt_config(cfg):
    return raytpu.RenderConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("name,cfg", [
    ("gallery", CFG),
    ("small", dataclasses.replace(CFG, seed=9, intersector="brute")),
])
def test_key_equals_raytpus_key(name, cfg):
    """The same scene, camera and config give raytpu's key: the port's
    ``repr(config)`` and its host copies of the tables hash alike."""
    assert repr(cfg) == repr(_rt_config(cfg))
    rpack, rcam = _raytpu(name)
    assert (progressive._ckpt_key(_scene(name), _camera(), cfg)
            == rt_progressive._ckpt_key(rpack, rcam, _rt_config(cfg)))


@pytest.mark.parametrize("writer", ["raytpu", "port"])
def test_resumes_the_other_packages_checkpoint(tmp_path, monkeypatch,
                                               writer):
    """One package is interrupted after 2 of 4 tiles; the other resumes
    its file, keeps its rows and renders only the rest; the frame is
    within imgdiff's bar of raytpu's uninterrupted one."""
    cfg = dataclasses.replace(CFG, intersector="brute")
    rcfg = _rt_config(cfg)
    port = (_scene("small"), _camera(), cfg)
    ref = (*_raytpu("small"), rcfg)
    first, then = ((rt_progressive, ref), (progressive, port))[
        ::1 if writer == "raytpu" else -1]
    path = str(tmp_path / "ck.npz")
    with monkeypatch.context() as m:
        _tile_spy(m, stop_after=2, module=first[0])
        with pytest.raises(_Killed):
            first[0].render_with_checkpoint(*first[1], path)
    with np.load(path) as ck:
        assert int(ck["next_y0"]) == 8
        saved = ck["frame"].copy()
    seen = _tile_spy(monkeypatch, module=then[0])
    got = then[0].render_with_checkpoint(*then[1], path)
    # raytpu renders every tile and drops the saved ones; the port skips them
    assert seen == ([8, 12] if then[0] is progressive else [0, 4, 8, 12])
    np.testing.assert_array_equal(got[:8], saved[:8])
    want = np.asarray(rt_render.render_frame(*ref))
    assert (quantize_rgba32f(got).max(-1) > 0).mean() > 0.5
    assert_images_equiv(quantize_rgba32f(got) / 255.0,
                        quantize_rgba32f(want) / 255.0)
