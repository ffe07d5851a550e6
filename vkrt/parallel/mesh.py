"""Device-mesh construction for multi-chip rendering.

The reference is strictly single-GPU (SURVEY.md §2d: its only parallelism is
the implicit pixel grid of vkCmdTraceRaysKHR). The scaling story here is
SPMD over a ``jax.sharding.Mesh`` with two axes:

* ``tile`` — pixel-space data parallelism: the frame's flat pixel array is
  sharded along dim 0; the scene/BVH is replicated per chip (it is read-only
  and every ray needs all of it). Zero collectives in the hot loop — the
  output image simply stays sharded until the host gathers a PNG.
* ``spp`` — sample parallelism: independent sample groups of the same pixels,
  combined with one ``psum`` mean per frame. This is the axis to grow when a
  single frame must converge faster than pixel tiling alone allows (the
  renderer analog of gradient data-parallelism: one small all-reduce riding
  ICI).

Both axes scale embarrassingly; ICI traffic is one (N/tile, 3) psum on the
spp axis per frame and nothing on the tile axis.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_render_mesh(n_tile: int = None, n_spp: int = 1, devices=None) -> Mesh:
    """Create a (tile, spp) mesh. Defaults: all devices on the tile axis."""
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if n_tile is None:
        n_tile = n_dev // n_spp
    assert n_tile * n_spp <= n_dev, (n_tile, n_spp, n_dev)
    import numpy as np

    grid = np.array(devices[: n_tile * n_spp]).reshape(n_tile, n_spp)
    return Mesh(grid, axis_names=("tile", "spp"))


def factor_mesh(n_devices: int):
    """Split n devices into (tile, spp): prefer tiles, give spp the factor 2
    when available — exercises both axes and the psum path."""
    if n_devices % 2 == 0 and n_devices > 2:
        return n_devices // 2, 2
    return n_devices, 1


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def tile_sharded(mesh: Mesh) -> NamedSharding:
    """Shard dim 0 over the tile axis, replicate over spp."""
    return NamedSharding(mesh, P("tile"))
