"""Checkpoint/resume for progressive renders.

The reference's only persistent state is the in-memory accumulation image +
frame counter, reset on any camera/setting change (hello_vulkan.cpp:1501-1521)
and lost on exit. SURVEY.md §5 calls out that in a functional renderer this state is
trivially checkpointable — so we add what the reference lacks: save/restore of the
accumulation buffers keyed by a validity fingerprint (scene, camera, settings,
resolution), letting a long converging render survive process restarts and
migrate across hosts. Plain .npz on purpose: the state is a handful of arrays,
and the fingerprint check replaces orbax's versioning.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import numpy as np
import jax.numpy as jnp


def _fingerprint(engine) -> str:
    """Hash everything that invalidates accumulation when changed."""
    parts = {
        # accum buffers live in tile order (engine._alloc_buffers); the tag
        # rejects checkpoints from layouts that ordered pixels differently
        "layout": "tile32",
        "settings": dataclasses.asdict(engine.settings),
        "camera": dataclasses.asdict(engine.camera),
        "clear": np.asarray(engine.clear_color).tolist(),
        "size": [engine.width, engine.height],
        "scene": [
            int(engine.scene.num_tris),
            int(engine.scene.num_lights),
            # hash the geometry bytes (a float sum collides trivially: any
            # permutation or compensating move of vertices preserves it)
            hashlib.sha256(
                np.ascontiguousarray(np.asarray(engine.scene.tri_v0)).tobytes()
            ).hexdigest(),
        ],
    }
    blob = json.dumps(parts, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()


def save(engine, path: str) -> None:
    """Persist accumulation state + frame counter."""
    state = {
        "fingerprint": _fingerprint(engine),
        "frame": engine.frame,
        "total_rays": engine.total_rays,
        "accum": np.asarray(engine.accum),
        "accum_rt": np.asarray(engine.accum_rt),
    }
    # the temporal denoiser's history (reprojection buffers + moments) IS
    # convergence state: dropping it from a resumed fly-through restarts
    # the filter from hist_len 0 (visible re-noising for ~a dozen frames)
    dn = {}
    if getattr(engine, "denoise_state", None) is not None:
        dn = {
            f"dn_{k}": np.asarray(v)
            for k, v in engine.denoise_state._asdict().items()
        }
    tmp = path + ".tmp.npz"
    np.savez_compressed(
        tmp,
        fingerprint=np.frombuffer(state["fingerprint"].encode(), np.uint8),
        frame=np.int64(state["frame"]),
        total_rays=np.float64(state["total_rays"]),
        accum=state["accum"],
        accum_rt=state["accum_rt"],
        **dn,
    )
    os.replace(tmp, path)


def restore(engine, path: str, strict: bool = True) -> bool:
    """Load accumulation state into the engine. Returns True on success.

    ``strict``: refuse state whose fingerprint (scene/camera/settings/size)
    doesn't match the engine — resuming mismatched state would silently blend
    incompatible images, the renderer equivalent of loading the wrong weights.
    """
    if not os.path.exists(path):
        return False
    data = np.load(path)
    fp = bytes(data["fingerprint"]).decode()
    if fp != _fingerprint(engine):
        if strict:
            return False
    engine.frame = int(data["frame"])
    engine.total_rays = float(data["total_rays"])
    engine.accum = jnp.asarray(data["accum"])
    engine.accum_rt = jnp.asarray(data["accum_rt"])
    if engine.denoise_state is not None and "dn_hist_rad" in data.files:
        engine.denoise_state = type(engine.denoise_state)(**{
            k: jnp.asarray(data[f"dn_{k}"])
            for k in engine.denoise_state._fields
        })
    # pin the camera reference so the next update_frame doesn't reset
    engine._ref_cam = engine.camera
    return True
