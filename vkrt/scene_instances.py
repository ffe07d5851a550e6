"""Instance layer: re-pose scene nodes by splicing re-baked triangles.

The reference keeps per-node instances in the TLAS: moving a node re-records
only the top-level structure while every BLAS persists
(createTopLevelAsGltf, hello_vulkan.cpp:1031-1047). Here world transforms
are baked into the flat triangle soup at load (scene.py design note) — great
for per-ray cost, but re-posing a node would naively force a full scene
rebuild + re-upload.

This module restores the capability for the flat soup:

* ``InstancedScene`` keeps the parsed document (object-space geometry) plus
  each primitive's triangle range inside the flat soup.
* ``repose`` re-bakes ONLY the moved node's primitives (scene._bake_primitive
  — the same math as load) and splices the slices into the device arrays
  with ``.at[range].set``; everything else is untouched.
* The trace structure is rebuilt from the spliced arrays (brute force just
  rebinds them; the LBVH is rebuilt on device). A bottom-up refit of the
  moved leaves would be the closer analog of the reference's TLAS-only
  update (ROADMAP).
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from vkrt import scene as scene_mod
from vkrt.utils import gltf as gltf_mod


class InstancedScene(NamedTuple):
    scene: scene_mod.SceneArrays
    doc: gltf_mod.GltfDocument            # object-space source of truth
    prim_ranges: Tuple[Tuple[int, int], ...]  # per-primitive [start, end) tris

    @property
    def num_nodes(self) -> int:
        return len(self.prim_ranges)


def build_instanced(doc: gltf_mod.GltfDocument) -> InstancedScene:
    scene = scene_mod.build_scene(doc)
    ranges = []
    start = 0
    for prim in doc.primitives:
        n = prim.indices.size // 3
        ranges.append((start, start + n))
        start += n
    return InstancedScene(scene=scene, doc=doc, prim_ranges=tuple(ranges))


@jax.jit
def _splice_device(arrs, ups, s):
    """ONE jitted dispatch for all per-node scene-array splices (each
    .at[s:e].set was a separate device round trip before)."""
    out = []
    for a, u in zip(arrs, ups):
        idx = (s,) + (0,) * (a.ndim - 1)
        out.append(jax.lax.dynamic_update_slice(a, u.astype(a.dtype), idx))
    return tuple(out)


def load_scene_instanced(path: str) -> InstancedScene:
    return build_instanced(gltf_mod.parse_gltf(path))


def repose(inst: InstancedScene, prim_idx: int,
           world_matrix: np.ndarray):
    """Move one primitive/node. Returns (new InstancedScene, moved_mask).

    ``moved_mask`` is (T,) bool over the triangle array (the moved subset a
    refit would touch; the current tracers rebuild from the arrays).
    """
    prim = copy.copy(inst.doc.primitives[prim_idx])
    prim.world_matrix = np.asarray(world_matrix, np.float64)
    new_prims = list(inst.doc.primitives)
    new_prims[prim_idx] = prim
    doc = copy.copy(inst.doc)
    doc.primitives = new_prims

    v0, v1, v2, cn, ctg, cuv, _ = scene_mod._bake_primitive(prim)
    s, e = inst.prim_ranges[prim_idx]
    assert e - s == len(v0)
    v0 = v0.astype(np.float32)
    e1 = (v1 - v0).astype(np.float32)
    e2 = (v2 - v0).astype(np.float32)
    density = scene_mod._uv_density(v0, v1, v2, cuv.astype(np.float32))

    sc = inst.scene
    names = ("tri_v0", "tri_e1", "tri_e2", "corner_normal",
             "corner_tangent", "tri_uv_density")
    fresh = (v0, e1, e2, cn, ctg, density)
    spliced = _splice_device(
        tuple(getattr(sc, k) for k in names),
        tuple(jnp.asarray(f) for f in fresh),
        jnp.int32(s),
    )
    sc = sc._replace(**dict(zip(names, spliced)))

    moved = np.zeros(sc.tri_v0.shape[0], bool)
    moved[s:e] = True
    return (
        InstancedScene(scene=sc, doc=doc, prim_ranges=inst.prim_ranges),
        moved,
    )


def repose_tracer(tracer, inst: InstancedScene, moved: np.ndarray):
    """Rebind a tracer to a re-posed scene: brute force takes the new
    triangle arrays, BVH-backed tracers rebuild the LBVH (and kernel
    tables) with the same backend."""
    from vkrt.ops.alpha import AlphaTracer
    from vkrt.ops.trace import Tracer, build_tracer

    sc = inst.scene
    if isinstance(tracer, AlphaTracer):
        return AlphaTracer(
            scene=sc,
            inner=repose_tracer(tracer.inner, inst, moved),
            rounds=tracer.rounds,
            seed=tracer.seed,
        )
    if isinstance(tracer, Tracer):
        if tracer.bvh is None:
            return tracer._replace(
                tri_v0=sc.tri_v0, tri_e1=sc.tri_e1, tri_e2=sc.tri_e2
            )
        backend = "kernel" if tracer.tables is not None else "bvh"
        return build_tracer(sc.tri_v0, sc.tri_e1, sc.tri_e2, backend,
                            interpret=tracer.interpret)
    raise TypeError(f"unknown tracer type {type(tracer)}")
