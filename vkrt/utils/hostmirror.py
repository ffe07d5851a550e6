"""Host-side numpy mirrors for device-resident scene arrays.

Host-side static gates (scene_is_textured, scene_has_alpha, texture-slot
gating) read scene arrays with np.asarray while the program is being
traced; each such read would otherwise be a device->host copy.

Every scene array is born from a host numpy buffer (scene.build_scene's
dev()); registering that buffer here lets asnumpy() hand it back without
touching the device at all. Mirrors are keyed by id() with a weakref
finalizer so an entry dies exactly when its device array does (CPython
runs finalizers during dealloc, before the id can be reused).
"""

from __future__ import annotations

import weakref

import numpy as np

_MIRROR: dict = {}


def register(dev_arr, host_arr: np.ndarray):
    """Attach ``host_arr`` as the known host copy of ``dev_arr``."""
    k = id(dev_arr)
    _MIRROR[k] = host_arr
    try:
        weakref.finalize(dev_arr, _MIRROR.pop, k, None)
    except TypeError:
        pass  # non-weakref-able (e.g. plain numpy passed through): skip
    return dev_arr


def asnumpy(x) -> np.ndarray:
    """np.asarray(x) that prefers a registered host mirror."""
    if isinstance(x, np.ndarray):
        return x
    h = _MIRROR.get(id(x))
    if h is not None:
        return h
    return np.asarray(x)
