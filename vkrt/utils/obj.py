"""Minimal Wavefront OBJ loader — parity with the reference's vestigial
``common/obj_loader.{h,cpp}`` (tinyobj -> interleaved VertexObj{pos,nrm,
color,uv} + per-face materials; only used by commented-out code paths,
main.cpp:219-224). Provided for the same completeness: OBJ in, the standard
SceneArrays out.

Supports: v / vn / vt / f (tri + fan-triangulated polygons, v//vn and
v/vt/vn forms, negative indices), usemtl/mtllib with newmtl/Kd/Ke/Ns
(diffuse color -> baseColorFactor, Ke -> emissive, Ns -> roughness via the
usual (2/(Ns+2))^0.25 glossiness mapping).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from vkrt.utils import gltf as gltf_mod


def _parse_mtl(path: str) -> Dict[str, gltf_mod.GltfMaterial]:
    mats: Dict[str, gltf_mod.GltfMaterial] = {}
    cur = None
    if not os.path.exists(path):
        return mats
    for line in open(path, "r", errors="replace"):
        parts = line.split()
        if not parts:
            continue
        key = parts[0]
        if key == "newmtl":
            cur = parts[1]
            mats[cur] = gltf_mod.GltfMaterial(
                base_color_factor=np.ones(4, np.float32), metallic_factor=0.0
            )
        elif cur is None:
            continue
        elif key == "Kd":
            mats[cur].base_color_factor = np.asarray(
                [float(parts[1]), float(parts[2]), float(parts[3]), 1.0], np.float32
            )
        elif key == "Ke":
            mats[cur].emissive_factor = np.asarray(
                [float(parts[1]), float(parts[2]), float(parts[3])], np.float32
            )
        elif key == "Ns":
            ns = float(parts[1])
            mats[cur].roughness_factor = float(
                np.clip((2.0 / (ns + 2.0)) ** 0.25, 0.0, 1.0)
            )
        elif key == "d":
            mats[cur].base_color_factor[3] = float(parts[1])
        elif key == "illum":
            # illum 4 = transparent material — the reference's any-hit gate
            # (raytrace_rahit_todo.glsl:32): stochastic punch-through with
            # probability 1 - dissolve
            if int(float(parts[1])) == 4:
                mats[cur].alpha_mode = 2
    return mats


def parse_obj(path: str) -> gltf_mod.GltfDocument:
    base = os.path.dirname(os.path.abspath(path))
    positions: List = []
    normals: List = []
    uvs: List = []
    mats: Dict[str, gltf_mod.GltfMaterial] = {}
    mat_names: List[str] = []
    cur_mat = -1

    # output soup (expanded per corner, like ObjLoader's interleaved verts)
    out_pos, out_nrm, out_uv, out_mat = [], [], [], []

    def vid(tok: str, n: int) -> int:
        i = int(tok)
        return i - 1 if i > 0 else n + i

    for line in open(path, "r", errors="replace"):
        parts = line.split()
        if not parts:
            continue
        key = parts[0]
        if key == "v":
            positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif key == "vn":
            normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
        elif key == "vt":
            uvs.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
        elif key == "mtllib":
            mats.update(_parse_mtl(os.path.join(base, parts[1])))
        elif key == "usemtl":
            name = parts[1]
            if name not in mat_names:
                mat_names.append(name)
            cur_mat = mat_names.index(name)
        elif key == "f":
            corners = []
            for tok in parts[1:]:
                sub = tok.split("/")
                pi = vid(sub[0], len(positions))
                ti = vid(sub[1], len(uvs)) if len(sub) > 1 and sub[1] else -1
                ni = vid(sub[2], len(normals)) if len(sub) > 2 and sub[2] else -1
                corners.append((pi, ti, ni))
            for k in range(1, len(corners) - 1):  # fan triangulation
                for (pi, ti, ni) in (corners[0], corners[k], corners[k + 1]):
                    out_pos.append(positions[pi])
                    out_uv.append(uvs[ti] if ti >= 0 else [0.0, 0.0])
                    out_nrm.append(normals[ni] if ni >= 0 else None)
                out_mat.append(max(cur_mat, 0))

    n_verts = len(out_pos)
    pos = np.asarray(out_pos, np.float32)
    has_all_normals = all(x is not None for x in out_nrm) and n_verts > 0
    nrm = (
        np.asarray(out_nrm, np.float32) if has_all_normals else None
    )
    uv = np.asarray(out_uv, np.float32) if n_verts else np.zeros((0, 2), np.float32)

    material_list = [
        mats.get(name, gltf_mod.GltfMaterial(np.ones(4, np.float32)))
        for name in mat_names
    ] or [gltf_mod.GltfMaterial(np.ones(4, np.float32))]

    prim = gltf_mod.GltfPrimitiveInstance(
        positions=pos,
        indices=np.arange(n_verts, dtype=np.uint32),
        normals=nrm,
        tangents=None,
        uvs=uv,
        material=-1,
        world_matrix=np.eye(4),
    )
    doc = gltf_mod.GltfDocument(
        primitives=[prim], materials=material_list, lights=[], images=[]
    )
    doc._obj_face_materials = np.asarray(out_mat, np.int32)  # type: ignore[attr-defined]
    return doc


def load_obj_scene(path: str):
    """OBJ file -> SceneArrays (per-face materials applied)."""
    import jax.numpy as jnp

    from vkrt.scene import build_scene

    doc = parse_obj(path)
    built = build_scene(doc)
    face_mats = getattr(doc, "_obj_face_materials", None)
    if face_mats is not None and len(face_mats):
        mat = np.zeros(built.tri_mat.shape[0], np.int32)
        mat[: len(face_mats)] = face_mats
        built = built._replace(tri_mat=jnp.asarray(mat))
    return built
