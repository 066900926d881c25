"""Camera math, matching the reference's nalgebra constructions exactly.

Two camera sources exist in the reference:

* JSON look-at override (src/main.rs:376-421): ``world`` is the *view* matrix
  from ``nalgebra_glm::look_at(origin, at, +Y)`` used as-is (a quirk: the
  shader treats it as a camera-to-world transform, src/shader.wgsl:299-310),
  and ``projection`` is the inverse of ``Perspective3::new(aspect, fov,
  100.0, 0.001)`` — near/far deliberately reversed.
* glTF camera node (src/scene/gltf.rs:461-519): ``world`` is the node's local
  transform; ``projection`` is the inverse of ``Perspective3::new(aspect,
  yfov, znear, zfar)``.

Both feed the shader's ray generation (src/shader.wgsl:299-310):
    clip   = pixel / (w, h) * 2 - 1
    cam    = projection @ [clip.x, -clip.y, 0, 1]
    dir    = normalize((world @ [normalize4(cam).xyz, 0]).xyz)
    origin = (world @ [0, 0, 0, 1]).xyz
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np


@dataclass
class CameraData:
    """Exactly the reference's ``Camera`` (src/scene/mod.rs:54-57):
    ``world`` (named ``view`` in the shader uniforms) and an already-inverted
    perspective ``projection``."""

    world: np.ndarray  # [4,4] f32
    projection: np.ndarray  # [4,4] f32 (inverse perspective)


def perspective_matrix(aspect: float, fovy: float, znear: float, zfar: float) -> np.ndarray:
    """nalgebra ``Perspective3::new`` — right-handed, OpenGL NDC z in [-1,1]."""
    f = 1.0 / np.tan(fovy / 2.0)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = -(zfar + znear) / (zfar - znear)
    m[2, 3] = -(2.0 * zfar * znear) / (zfar - znear)
    m[3, 2] = -1.0
    return m.astype(np.float32)


def look_at(eye, center, up) -> np.ndarray:
    """``nalgebra_glm::look_at`` (right-handed view matrix)."""
    eye = np.asarray(eye, dtype=np.float64)
    center = np.asarray(center, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -s.dot(eye)
    m[1, 3] = -u.dot(eye)
    m[2, 3] = f.dot(eye)
    return m.astype(np.float32)


def camera_from_lookat(
    origin, at, fov: float, width: int, height: int
) -> CameraData:
    """The reference's camera-JSON path (src/main.rs:396-417): world = the
    look-at VIEW matrix (not its inverse — quirk), projection = inverse of
    Perspective(aspect, fov, near=100.0, far=0.001) (near/far reversed)."""
    world = look_at(origin, at, [0.0, 1.0, 0.0])
    proj = perspective_matrix(width / height, fov, 100.0, 0.001)
    projection = np.linalg.inv(proj.astype(np.float64)).astype(np.float32)
    return CameraData(world=world, projection=projection)


def load_camera_json(path: str, width: int, height: int) -> CameraData:
    """Parse the reference's camera.json {origin, at, fov} (src/main.rs:23-28)."""
    with open(path) as f:
        spec = json.load(f)
    return camera_from_lookat(
        spec["origin"], spec["at"], float(spec["fov"]), width, height
    )
