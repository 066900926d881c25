"""glTF 2.0 / GLB scene loader.

Hand-rolled parser (no external glTF dependency) that lowers a glTF document to
flat host-side numpy tables with the same logical content as the reference
renderer's GPU buffers (reference: src/scene/gltf.rs, src/scene/mod.rs):

* vertex table   (pos/normal/uv, SoA)            -- src/scene/mod.rs:5-12
* index table    (u32, primitive-relative)       -- src/scene/gltf.rs:230-244
* primitive table(vertex_start/index_start/mat)  -- src/scene/mod.rs:44-50
* mesh table     (primitive_start/count)         -- src/scene/mod.rs:37-40
* object table   (node transform + mesh index)   -- src/scene/gltf.rs:282-325
* material table (PBR metallic-roughness + KHR extensions)
                                                 -- src/scene/gltf.rs:249-280
* light table    (KHR_lights_punctual)           -- src/scene/gltf.rs:327-371
* decoded RGBA8 textures                         -- src/scene/gltf.rs:373-459
* optional perspective camera                    -- src/scene/gltf.rs:461-519

Reference behaviours deliberately reproduced (they affect image parity):

* Node hierarchy is IGNORED: each node contributes only its *local* transform;
  parent transforms are never accumulated (src/scene/gltf.rs:282-325 walks
  ``document.nodes()`` flat).
* Indices are stored primitive-relative; consumers add ``vertex_start`` back on
  (src/shader.wgsl:276-278).
* Missing TEXCOORD_0 yields zero UVs (src/scene/gltf.rs:213-220).
* Material defaults follow the glTF spec via the gltf crate: metallic=1,
  roughness=1, base_color=[1,1,1,1]; emissive_strength/ior default to 0.0 when
  their KHR extension is absent (src/scene/gltf.rs:255-256 ``unwrap_or(0.0)``).
* The camera is the FIRST node carrying a camera (src/scene/gltf.rs:462), and
  its projection is the INVERSE of Perspective(aspect, yfov, znear, zfar)
  (src/scene/gltf.rs:496-515). Orthographic cameras are unsupported, as in the
  reference (src/scene/gltf.rs:492-495).
"""

from __future__ import annotations

import base64
import io
import json
import os
import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .camera import CameraData, perspective_matrix

GLB_MAGIC = 0x46546C67

# glTF componentType enum -> numpy dtype
_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}

_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}


class GltfError(RuntimeError):
    """Raised when a scene file cannot be parsed."""


@dataclass
class SceneData:
    """Host-side (numpy) scene tables. Mirrors the reference's GPU buffer
    contents one-to-one; see module docstring for the source mapping."""

    # vertex SoA
    vertex_pos: np.ndarray  # [V,3] f32
    vertex_normal: np.ndarray  # [V,3] f32
    vertex_uv: np.ndarray  # [V,2] f32
    indices: np.ndarray  # [I] u32, primitive-relative
    # primitive table
    prim_vertex_start: np.ndarray  # [P] i64
    prim_vertex_count: np.ndarray  # [P] i64
    prim_index_start: np.ndarray  # [P] i64
    prim_index_count: np.ndarray  # [P] i64
    prim_material: np.ndarray  # [P] i64
    # mesh table
    mesh_primitive_start: np.ndarray  # [M] i64
    mesh_primitive_count: np.ndarray  # [M] i64
    # object table (one entry per mesh-bearing node, document node order)
    object_transform: np.ndarray  # [O,4,4] f32
    object_mesh: np.ndarray  # [O] i64
    # material table
    mat_metallic: np.ndarray  # [Mt] f32
    mat_roughness: np.ndarray  # [Mt] f32
    mat_emission: np.ndarray  # [Mt] f32
    mat_ior: np.ndarray  # [Mt] f32
    mat_texture: np.ndarray  # [Mt] i64
    mat_has_texture: np.ndarray  # [Mt] i64
    mat_color: np.ndarray  # [Mt,4] f32
    # light table
    light_transform: np.ndarray  # [L,4,4] f32
    light_color: np.ndarray  # [L,4] f32 (w = 0.0, src/scene/gltf.rs:358)
    light_power: np.ndarray  # [L] f32 (never read by the shader)
    # decoded textures, RGBA8 uint8 arrays [H,W,4]
    textures: list = field(default_factory=list)
    # optional glTF camera
    camera: Optional[CameraData] = None

    @property
    def n_objects(self) -> int:
        return int(self.object_mesh.shape[0])

    @property
    def n_lights(self) -> int:
        return int(self.light_power.shape[0])

    @property
    def n_triangles(self) -> int:
        # every 3 indices make one triangle; summed over primitives per object
        per_prim_tris = self.prim_index_count // 3
        return int(per_prim_tris[self.object_prim_ids()].sum())

    def object_prim_ids(self) -> np.ndarray:
        """Flat array of primitive ids instantiated by objects, in
        (object, primitive) order."""
        out = []
        for o in range(self.n_objects):
            m = int(self.object_mesh[o])
            start = int(self.mesh_primitive_start[m])
            count = int(self.mesh_primitive_count[m])
            out.extend(range(start, start + count))
        return np.asarray(out, dtype=np.int64)


def _parse_glb(data: bytes) -> tuple[dict, Optional[bytes]]:
    """Split a GLB container into (json document, BIN chunk)."""
    if len(data) < 12:
        raise GltfError("glb file too short")
    magic, version, length = struct.unpack_from("<III", data, 0)
    if magic != GLB_MAGIC:
        raise GltfError("bad glb magic")
    if version != 2:
        raise GltfError(f"unsupported glb version {version}")
    off = 12
    doc = None
    bin_chunk = None
    while off + 8 <= min(length, len(data)):
        (clen,) = struct.unpack_from("<I", data, off)
        ctype = data[off + 4 : off + 8]
        payload = data[off + 8 : off + 8 + clen]
        if ctype == b"JSON":
            doc = json.loads(payload)
        elif ctype == b"BIN\x00":
            bin_chunk = payload
        off += 8 + clen
    if doc is None:
        raise GltfError("glb file has no JSON chunk")
    return doc, bin_chunk


def _decode_data_uri(uri: str) -> bytes:
    header, b64 = uri.split(",", 1)
    return base64.b64decode(b64)


def node_local_matrix(node: dict) -> np.ndarray:
    """Local node transform as a conventional 4x4 (M @ column-vector).

    glTF stores ``matrix`` column-major; TRS composes as T*R*S. This matches
    ``node.transform().matrix()`` in the reference (the element-by-element
    transpose blocks at src/scene/gltf.rs:287-304 reconstruct the same
    conventional matrix)."""
    if "matrix" in node:
        m = np.asarray(node["matrix"], dtype=np.float32)
        return m.reshape(4, 4).T.astype(np.float32)
    t = np.asarray(node.get("translation", [0.0, 0.0, 0.0]), dtype=np.float32)
    q = np.asarray(node.get("rotation", [0.0, 0.0, 0.0, 1.0]), dtype=np.float32)
    s = np.asarray(node.get("scale", [1.0, 1.0, 1.0]), dtype=np.float32)
    x, y, z, w = (float(v) for v in q)
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float64,
    )
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = rot @ np.diag(s.astype(np.float64))
    m[:3, 3] = t
    return m.astype(np.float32)


class _Reader:
    """Accessor reader over the document's buffers."""

    def __init__(self, doc: dict, bin_chunk: Optional[bytes], scene_dir: str):
        self.doc = doc
        self.bin = bin_chunk
        self.scene_dir = scene_dir
        self._buffer_cache: dict[int, bytes] = {}

    def buffer_bytes(self, buffer_index: int) -> bytes:
        if buffer_index in self._buffer_cache:
            return self._buffer_cache[buffer_index]
        buf = self.doc["buffers"][buffer_index]
        uri = buf.get("uri")
        if uri is None:
            if self.bin is None:
                raise GltfError("buffer refers to BIN chunk but none present")
            data = self.bin
        elif uri.startswith("data:"):
            data = _decode_data_uri(uri)
        else:
            # The reference opens buffer URIs relative to the CWD
            # (src/scene/gltf.rs:68 File::open(uri)); we fall back to the
            # scene directory when the CWD-relative path does not exist.
            path = uri if os.path.exists(uri) else os.path.join(self.scene_dir, uri)
            with open(path, "rb") as f:
                data = f.read()
        self._buffer_cache[buffer_index] = data
        return data

    def view_bytes(self, view_index: int) -> bytes:
        view = self.doc["bufferViews"][view_index]
        data = self.buffer_bytes(view.get("buffer", 0))
        off = view.get("byteOffset", 0)
        return data[off : off + view["byteLength"]]

    def accessor(self, accessor_index: int) -> np.ndarray:
        """Read an accessor as an [count, n_components] (or [count]) array in
        its native dtype. Strided bufferViews are supported; sparse accessors
        are not (the reference's gltf crate would handle them; none of our
        target assets use them)."""
        acc = self.doc["accessors"][accessor_index]
        if "sparse" in acc:
            raise GltfError("sparse accessors are not supported")
        dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
        ncomp = _TYPE_COUNTS[acc["type"]]
        count = acc["count"]
        if "bufferView" not in acc:
            arr = np.zeros((count, ncomp), dtype=dtype)
            return arr[:, 0] if ncomp == 1 else arr
        view = self.doc["bufferViews"][acc["bufferView"]]
        raw = self.view_bytes(acc["bufferView"])
        acc_off = acc.get("byteOffset", 0)
        elem_size = dtype.itemsize * ncomp
        stride = view.get("byteStride") or elem_size
        if stride == elem_size:
            arr = np.frombuffer(
                raw, dtype=dtype, count=count * ncomp, offset=acc_off
            ).reshape(count, ncomp)
        else:
            arr = np.lib.stride_tricks.as_strided(
                np.frombuffer(raw, dtype=np.uint8, offset=acc_off),
                shape=(count, elem_size),
                strides=(stride, 1),
            ).copy().view(dtype).reshape(count, ncomp)
        return arr[:, 0].copy() if ncomp == 1 else arr.copy()

    def normalized_f32(self, accessor_index: int) -> np.ndarray:
        """Accessor as f32, applying KHR-normalized integer conversion
        (the gltf crate's into_f32 path for TEXCOORD)."""
        acc = self.doc["accessors"][accessor_index]
        arr = self.accessor(accessor_index)
        if arr.dtype == np.float32:
            return arr
        if acc.get("normalized", False):
            info = np.iinfo(arr.dtype)
            if info.min < 0:
                return np.maximum(
                    arr.astype(np.float32) / info.max, -1.0
                ).astype(np.float32)
            return (arr.astype(np.float32) / info.max).astype(np.float32)
        return arr.astype(np.float32)


def _decode_image(data: bytes) -> np.ndarray:
    """Decode an image byte-blob to RGBA8 [H,W,4]; mirrors
    image::load_from_memory(...).into_rgba8() (src/scene/gltf.rs:380-385)."""
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGBA")
    return np.asarray(img, dtype=np.uint8)


def _material_table(doc: dict) -> tuple[np.ndarray, ...]:
    mats = doc.get("materials", [])
    n = len(mats)
    metallic = np.ones(n, np.float32)
    roughness = np.ones(n, np.float32)
    emission = np.zeros(n, np.float32)
    ior = np.zeros(n, np.float32)
    texture = np.zeros(n, np.int64)
    has_texture = np.zeros(n, np.int64)
    color = np.ones((n, 4), np.float32)
    for i, m in enumerate(mats):
        pbr = m.get("pbrMetallicRoughness", {})
        metallic[i] = pbr.get("metallicFactor", 1.0)
        roughness[i] = pbr.get("roughnessFactor", 1.0)
        color[i] = np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)
        ext = m.get("extensions", {})
        # unwrap_or(0.0) semantics of the reference (src/scene/gltf.rs:255-256)
        if "KHR_materials_emissive_strength" in ext:
            emission[i] = ext["KHR_materials_emissive_strength"].get(
                "emissiveStrength", 1.0
            )
        if "KHR_materials_ior" in ext:
            ior[i] = ext["KHR_materials_ior"].get("ior", 1.5)
        bct = pbr.get("baseColorTexture")
        if bct is not None:
            texture[i] = bct.get("index", 0)
            has_texture[i] = 1
    return metallic, roughness, emission, ior, texture, has_texture, color


def _camera_from_doc(doc: dict) -> Optional[CameraData]:
    """First camera-bearing node -> CameraData (src/scene/gltf.rs:461-519)."""
    for node in doc.get("nodes", []):
        if "camera" not in node:
            continue
        cam = doc["cameras"][node["camera"]]
        if cam.get("type") != "perspective":
            raise GltfError("todo: support for orthographic projection")
        persp = cam["perspective"]
        if "aspectRatio" not in persp:
            raise GltfError("failed to load aspect ratio from camera")
        if "zfar" not in persp:
            raise GltfError("failed to load zfar from camera")
        proj = perspective_matrix(
            float(persp["aspectRatio"]),
            float(persp["yfov"]),
            float(persp["znear"]),
            float(persp["zfar"]),
        )
        projection = np.linalg.inv(proj.astype(np.float64)).astype(np.float32)
        world = node_local_matrix(node)
        return CameraData(world=world, projection=projection)
    return None


def load_scene(path: str) -> SceneData:
    """Load a .glb or .gltf(+.bin) file into SceneData.

    Format dispatch matches the reference CLI (src/main.rs:119-193): ``.glb``
    parses the container's BIN chunk; ``.gltf`` requires a sibling ``.bin``
    with the same stem."""
    scene_dir = os.path.dirname(os.path.abspath(path))
    ext = os.path.splitext(path)[1].lower()
    with open(path, "rb") as f:
        raw = f.read()
    if ext == ".glb":
        doc, bin_chunk = _parse_glb(raw)
        if bin_chunk is None:
            raise GltfError("no binary data found in glb file")
    elif ext == ".gltf":
        doc = json.loads(raw)
        bin_path = os.path.splitext(path)[0] + ".bin"
        if os.path.exists(bin_path):
            with open(bin_path, "rb") as f:
                bin_chunk = f.read()
        else:
            bin_chunk = None  # buffers may be data: URIs
    else:
        raise GltfError("failed to recognize file format")

    reader = _Reader(doc, bin_chunk, scene_dir)
    meshes = doc.get("meshes", [])
    nodes = doc.get("nodes", [])

    # --- meshes / primitives / vertices / indices (document order) ---
    positions, normals, uvs, all_indices = [], [], [], []
    prim_rows = []  # (vertex_start, vertex_count, index_start, index_count, material)
    mesh_rows = []  # (primitive_start, primitive_count)
    vertex_counter = 0
    index_counter = 0
    prim_counter = 0
    for mesh in meshes:
        prims = mesh.get("primitives", [])
        mesh_rows.append((prim_counter, len(prims)))
        prim_counter += len(prims)
        for prim in prims:
            if prim.get("mode", 4) != 4:
                raise GltfError("only triangle primitives are supported")
            attrs = prim["attributes"]
            if "POSITION" not in attrs:
                raise GltfError("failed to read positions")
            pos = reader.accessor(attrs["POSITION"]).astype(np.float32)
            if "NORMAL" not in attrs:
                raise GltfError("failed to read normals")
            nrm = reader.accessor(attrs["NORMAL"]).astype(np.float32)
            if "TEXCOORD_0" in attrs:
                uv = reader.normalized_f32(attrs["TEXCOORD_0"])
            else:
                # UVs default to zeros when absent (src/scene/gltf.rs:213-220)
                uv = np.zeros((pos.shape[0], 2), np.float32)
            if "indices" not in prim:
                raise GltfError("failed to read indices")
            idx = reader.accessor(prim["indices"]).astype(np.uint32)
            if "material" not in prim:
                raise GltfError("no material found for primitive")
            positions.append(pos)
            normals.append(nrm)
            uvs.append(uv)
            all_indices.append(idx)
            prim_rows.append(
                (vertex_counter, pos.shape[0], index_counter, idx.shape[0],
                 prim["material"])
            )
            vertex_counter += pos.shape[0]
            index_counter += idx.shape[0]

    def _cat(parts, width, dtype):
        if parts:
            return np.concatenate(parts, axis=0).astype(dtype)
        shape = (0,) if width == 1 else (0, width)
        return np.zeros(shape, dtype)

    prim_arr = np.asarray(prim_rows, dtype=np.int64).reshape(-1, 5)
    mesh_arr = np.asarray(mesh_rows, dtype=np.int64).reshape(-1, 2)

    # --- objects (mesh-bearing nodes) and lights (document node order) ---
    obj_transforms, obj_meshes = [], []
    light_transforms, light_colors, light_powers = [], [], []
    khr_lights = (
        doc.get("extensions", {}).get("KHR_lights_punctual", {}).get("lights", [])
    )
    for node in nodes:
        if "mesh" in node:
            obj_transforms.append(node_local_matrix(node))
            obj_meshes.append(node["mesh"])
        light_ref = node.get("extensions", {}).get("KHR_lights_punctual")
        if light_ref is not None:
            light = khr_lights[light_ref["light"]]
            c = light.get("color", [1.0, 1.0, 1.0])
            light_transforms.append(node_local_matrix(node))
            # color w component is 0.0 (src/scene/gltf.rs:358)
            light_colors.append([c[0], c[1], c[2], 0.0])
            light_powers.append(light.get("intensity", 1.0))

    # --- materials / textures / camera ---
    metallic, roughness, emission, ior, texture, has_texture, color = (
        _material_table(doc)
    )
    textures = []
    for tex in doc.get("textures", []):
        img = doc["images"][tex["source"]]
        if "bufferView" in img:
            blob = reader.view_bytes(img["bufferView"])
        elif "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                blob = _decode_data_uri(uri)
            else:
                # image URIs resolve against the scene directory
                # (src/scene/gltf.rs:411 self.path.join(uri))
                with open(os.path.join(scene_dir, uri), "rb") as f:
                    blob = f.read()
        else:
            raise GltfError("texture image has no source")
        textures.append(_decode_image(blob))

    return SceneData(
        vertex_pos=_cat(positions, 3, np.float32),
        vertex_normal=_cat(normals, 3, np.float32),
        vertex_uv=_cat(uvs, 2, np.float32),
        indices=_cat(all_indices, 1, np.uint32),
        prim_vertex_start=prim_arr[:, 0],
        prim_vertex_count=prim_arr[:, 1],
        prim_index_start=prim_arr[:, 2],
        prim_index_count=prim_arr[:, 3],
        prim_material=prim_arr[:, 4],
        mesh_primitive_start=mesh_arr[:, 0],
        mesh_primitive_count=mesh_arr[:, 1],
        object_transform=(
            np.stack(obj_transforms) if obj_transforms
            else np.zeros((0, 4, 4), np.float32)
        ),
        object_mesh=np.asarray(obj_meshes, dtype=np.int64),
        mat_metallic=metallic,
        mat_roughness=roughness,
        mat_emission=emission,
        mat_ior=ior,
        mat_texture=texture,
        mat_has_texture=has_texture,
        mat_color=color,
        light_transform=(
            np.stack(light_transforms) if light_transforms
            else np.zeros((0, 4, 4), np.float32)
        ),
        light_color=(
            np.asarray(light_colors, np.float32) if light_colors
            else np.zeros((0, 4), np.float32)
        ),
        light_power=np.asarray(light_powers, dtype=np.float32),
        textures=textures,
        camera=_camera_from_doc(doc),
    )
