"""vkrt — a real-time ray tracing framework in JAX.

A ground-up rebuild of the capabilities of the Vulkan engine
``CristianSimion5/vk-raytracing-engine``:

* the scene is a flat SoA pytree of device arrays (the analog of the
  reference's ``SceneDesc`` buffer-device-address table,
  ``shaders/host_device.h:107-117``),
* rays are traced in large batches through a brute-force intersector (ray x
  triangle blocks), an LBVH built on-device with ``jax.lax`` sort/scan
  primitives and walked in plain JAX, or a per-ray traversal kernel for the
  GPU (Pallas, Triton route),
* a frame is a pure function ``render(scene, camera, params, accum) ->
  (image, accum)`` under ``jax.jit`` — progressive accumulation
  (``shaders/raytrace.rgen:136-145``) is functional state, not a mutable
  framebuffer,
* multi-device scaling shards the pixel/sample space over a
  ``jax.sharding.Mesh`` with the scene/BVH replicated per device.

Subpackages
-----------
``vkrt.utils``     camera, glTF loader, PNG io, small math helpers
``vkrt.ops``       RNG, sampling, BRDFs, intersection, trace backends
``vkrt.bvh``       LBVH build (Morton + Karras) and threaded flattening
``vkrt.models``    path tracer, G-buffer, hybrid effects, denoiser, post
``vkrt.parallel``  device-mesh sharded rendering
"""

from vkrt.config import EngineConfig, RenderSettings, load_config

__version__ = "0.1.0"

__all__ = [
    "EngineConfig",
    "RenderSettings",
    "load_config",
    "__version__",
]
