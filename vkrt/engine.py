"""Engine: frame orchestration, progressive accumulation, invalidation.

The ``HelloVulkan`` + ``main()`` frame-loop equivalent (main.cpp:441-630):
owns the scene arrays, tracer, camera state, accumulation buffers and the
frame counter, and exposes ``render_frame()``. Functional core / imperative
shell: everything per-frame is a jitted pure function; this class only
threads state and implements the reset rules:

* ``update_frame``: bump the counter, reset when the camera matrix or fov
  changed (hello_vulkan.cpp:1506-1521);
* ``reset_frame``: frame = -1 (hello_vulkan.cpp:1501-1504), i.e. the next
  update makes it 0;
* any settings change resets accumulation (main.cpp:103-104, 463-464);
* max-frames early-out: when limiting is on and frame >= maxFrames the
  frame is not re-rendered (hello_vulkan.cpp:1426-1430).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp

from vkrt.config import DEFAULT_CLEAR_COLOR, RenderSettings
from vkrt.models import post as post_mod
from vkrt.models.hybrid import hybrid_frame
from vkrt.models.pathtracer import pathtrace_frame
from vkrt.ops.trace import make_tracer
from vkrt.ops.rng import tea
from vkrt.scene import SceneArrays
from vkrt.utils.camera import Camera, pixel_coords, tile_perm
from vkrt.utils.camera import untile as camera_untile


class Engine:
    def __init__(
        self,
        scene: SceneArrays,
        width: int,
        height: int,
        settings: RenderSettings = RenderSettings(),
        camera: Camera = Camera(),
        clear_color=DEFAULT_CLEAR_COLOR,
        tracer=None,
    ):
        """``tracer``: a prebuilt tracer in place of
        ``make_tracer(scene, settings.backend)`` (the tests pass the
        traversal kernel in interpret mode this way)."""
        # an InstancedScene keeps object-space geometry for cheap re-pose
        # (set_node_transform); a plain SceneArrays renders statically
        self.instances = None
        if type(scene).__name__ == "InstancedScene":
            self.instances = scene
            scene = scene.scene
        self.scene = scene
        self.width = width
        self.height = height
        self.settings = settings
        self.camera = camera
        self.clear_color = jnp.asarray(clear_color, jnp.float32)
        self.tracer = tracer if tracer is not None else make_tracer(
            scene, settings.backend, alpha=settings.alpha_test)
        self.frame = -1
        self._ref_cam: Optional[Camera] = None
        self._total_rays = jnp.zeros((), jnp.float32)
        self._alloc_buffers()
        self._build_jits()

    @property
    def total_rays(self) -> float:
        """Total rays traced. Reading syncs device->host: fetch once per run,
        not per frame (the reference has zero per-frame readbacks,
        main.cpp:441-630); render_frame accumulates on device."""
        return float(self._total_rays)

    @total_rays.setter
    def total_rays(self, value):
        self._total_rays = jnp.asarray(value, jnp.float32)

    # -- state management ---------------------------------------------------

    def _alloc_buffers(self):
        n = self.width * self.height
        # tile-ordered pixel layout: every per-pixel array in the frame
        # pipeline (accum, G-buffer, composites) lives in 32x32-tile order so
        # neighbouring lanes of a trace-kernel block share one compact
        # frustum instead of a scanline stripe (see utils.camera.tile_perm);
        # render_frame un-permutes its output back to image order
        perm, inv = tile_perm(self.width, self.height)
        self._perm = jnp.asarray(perm)
        self._inv_perm = jnp.asarray(inv)
        # display un-permute: structured reshape/transpose when the width is
        # tile-aligned (memcpy-speed), row-gather fallback otherwise
        if self.width % 32 == 0:
            self._untile = lambda out: camera_untile(
                out, self.width, self.height
            )
        else:
            self._untile = lambda out: jnp.take(out, self._inv_perm, axis=0)
        self._pix = jnp.take(pixel_coords(self.width, self.height), self._perm, axis=0)
        self._pid = jnp.asarray(perm.astype(np.uint32))
        self.accum = jnp.zeros((n, 3), jnp.float32)          # path accum image
        self.accum_rt = jnp.zeros((n, 4), jnp.float32)       # hybrid imageAccum
        self.gbuffer = None                                   # hybrid G-buffer
        s = self.settings
        if s.rt_mode == 0 and s.use_denoiser and s.use_gi and s.temporal_denoiser:
            from vkrt.models import denoiser as dn

            self.denoise_state = dn.init_state(self.width, self.height)
        else:
            self.denoise_state = None

    def _build_jits(self):
        s = self.settings
        pix, pid = self._pix, self._pid
        # Scene and tracer are closure-captured: XLA folds the material and
        # light staging into the step. A re-pose (set_node_transform)
        # rebuilds the tracer and re-traces the step.
        scene, tracer = self.scene, self.tracer

        # clamp_weights rides as TRACED (2,) [lo, hi] bounds (clamp_lohi —
        # models.shading.clamp_bounds): toggling the setting reuses the
        # compiled step, like the reference's per-frame push-constant
        # updates (main.cpp:67-105); it is NOT in update_settings'
        # needs_rejit list.
        if s.rt_mode == 1:
            def path_step(cam, frame, accum, clear_color, clamp_lohi):
                # per-pixel seeds by ORIGINAL pixel id: radiance per pixel is
                # bit-identical to scanline order (layout is a pure permute)
                seeds = tea(pid, jnp.uint32(frame))
                return pathtrace_frame(
                    scene, tracer, cam, frame, accum, clear_color,
                    width=self.width, height=self.height,
                    samples=s.samples, depth=s.depth,
                    clamp_weights=clamp_lohi, corr=s.corr_sampler,
                    pix=pix, seeds=seeds,
                )

            self._step = jax.jit(path_step)
        else:
            def hybrid_step(cam, frame, accum_rt, clear_color, denoise_state,
                            clamp_lohi):
                seeds = tea(pid, jnp.uint32(frame))
                return hybrid_frame(
                    scene, tracer, cam, frame, accum_rt, clear_color,
                    width=self.width, height=self.height, depth=s.depth,
                    use_shadows=s.use_shadows, use_ao=s.use_ao,
                    use_gi=s.use_gi, use_denoiser=s.use_denoiser,
                    clamp_weights=clamp_lohi, corr=s.corr_sampler,
                    pix=pix, seeds=seeds,
                    perm=self._perm, inv_perm=self._inv_perm,
                    denoise_state=denoise_state,
                )

            self._step = jax.jit(hybrid_step)

        # display path as ONE jitted dispatch (composite + tile->scanline):
        # unjitted it was 6-8 separate op dispatches per frame through the
        # device link (the post.frag-equivalent full-screen pass).
        # view_accumulated is a TRACED argument (read from settings at call
        # time): the reference flips it per frame via push constant
        # (main.cpp:90-96) with no pipeline rebuild, so toggling it here
        # must reuse the compiled step, not rejit (it is deliberately NOT
        # in update_settings' needs_rejit list).
        if s.rt_mode == 1:
            def display(accum, va):
                out = post_mod.composite(
                    None,
                    jnp.concatenate(
                        [accum, jnp.ones_like(accum[:, :1])], axis=1
                    ),
                    rt_mode=1, view_accumulated=va,
                    use_gi=s.use_gi,
                )
                return self._untile(out)
        else:
            def display(raster_rgb, accum_rt, va):
                out = post_mod.composite(
                    raster_rgb, accum_rt, rt_mode=0,
                    view_accumulated=va, use_gi=s.use_gi,
                )
                return self._untile(out)

        self._display = jax.jit(display)

    def _clamp_lohi(self):
        """Traced path-throughput clamp bounds from the current settings."""
        from vkrt.models.shading import clamp_bounds

        return clamp_bounds(bool(self.settings.clamp_weights))

    def reset_frame(self):
        """hello_vulkan.cpp:1501-1504."""
        self.frame = -1

    def update_frame(self):
        """Reset accumulation on camera change (hello_vulkan.cpp:1506-1521)."""
        if self._ref_cam != self.camera:
            self.reset_frame()
            self._ref_cam = self.camera
        self.frame += 1

    def update_settings(self, settings: RenderSettings):
        if settings != self.settings:
            needs_rejit = (
                settings.samples != self.settings.samples
                or settings.depth != self.settings.depth
                or settings.rt_mode != self.settings.rt_mode
                or settings.use_shadows != self.settings.use_shadows
                or settings.use_ao != self.settings.use_ao
                or settings.use_gi != self.settings.use_gi
                or settings.use_denoiser != self.settings.use_denoiser
                or settings.temporal_denoiser != self.settings.temporal_denoiser
                # clamp_weights deliberately absent: traced bounds, not a
                # static branch (see _build_jits)
                or settings.backend != self.settings.backend
                or settings.alpha_test != self.settings.alpha_test
                or settings.corr_sampler != self.settings.corr_sampler
            )
            if (settings.backend != self.settings.backend
                    or settings.alpha_test != self.settings.alpha_test):
                self.tracer = make_tracer(self.scene, settings.backend,
                                          alpha=settings.alpha_test)
            self.settings = settings
            if needs_rejit:
                self._alloc_buffers()  # resets denoiser history to match
                self._build_jits()
            self.reset_frame()  # any UI change calls resetFrame (main.cpp:103)

    def set_node_transform(self, prim_idx: int, world_matrix):
        """Re-pose one scene node (the reference's instance-transform update,
        createTopLevelAsGltf hello_vulkan.cpp:1031-1047): splice the re-baked
        primitive into the scene arrays and REFIT the trace structure (cost
        scales with the moved subset — no full SAH rebuild). Requires the
        engine to have been built from an InstancedScene.

        The tracer's LBVH is rebuilt and the step re-traced, so every
        re-pose recompiles (ROADMAP: an LBVH refit with pose-stable jit
        arguments would remove both costs).
        """
        if self.instances is None:
            raise ValueError(
                "engine was not built from an InstancedScene; load via "
                "scene_instances.load_scene_instanced to enable re-posing"
            )
        from vkrt import scene_instances as si

        self.instances, moved = si.repose(self.instances, prim_idx, world_matrix)
        self.scene = self.instances.scene
        self.tracer = si.repose_tracer(self.tracer, self.instances, moved)
        self._build_jits()  # closure-captured scene and tracer: re-trace
        self.reset_frame()  # geometry changed: restart accumulation

    def resize(self, width: int, height: int):
        """onResize (hello_vulkan.cpp:620-626)."""
        self.width, self.height = width, height
        self.reset_frame()
        self._alloc_buffers()
        self._build_jits()

    # -- rendering ----------------------------------------------------------

    def render_frame(self):
        """One main-loop iteration. Returns the linear composite (N,3)."""
        from vkrt.utils.profiling import pass_label

        self.update_frame()
        s = self.settings
        at_limit = s.stop_at_max_frames and self.frame >= s.max_frames
        if s.rt_mode == 0 and self.gbuffer is None:
            # restored checkpoints don't carry the G-buffer (it is re-derived
            # per frame): render once before honoring the max-frames early-out
            at_limit = False
        cam = self.camera.matrices(self.width, self.height)
        if s.rt_mode == 1:
            if not at_limit:  # early-out keeps the image (hello_vulkan.cpp:1426)
                # named region in device traces — the beginLabel/endLabel
                # equivalent (hello_vulkan.cpp:1432-1447)
                with pass_label("pathtrace"):
                    self.accum, rays = self._step(
                        cam, self.frame, self.accum, self.clear_color,
                        self._clamp_lohi(),
                    )
                self._total_rays = self._total_rays + rays
            return self._display(
                self.accum, jnp.asarray(s.view_accumulated)
            )
        if not at_limit:
            with pass_label("hybrid"):  # (hello_vulkan.cpp:587/1459 labels)
                self.gbuffer, self.accum_rt, rays, self.denoise_state = (
                    self._step(
                        cam, self.frame, self.accum_rt, self.clear_color,
                        self.denoise_state, self._clamp_lohi(),
                    )
                )
            self._total_rays = self._total_rays + rays
        return self._display(
            self.gbuffer.color[:, :3], self.accum_rt,
            jnp.asarray(s.view_accumulated),
        )

    def render(self, frames: int = 1) -> np.ndarray:
        """Render ``frames`` progressive frames, return (H,W,3) uint8."""
        out = None
        for _ in range(frames):
            out = self.render_frame()
        return post_mod.to_u8_image(out, self.width, self.height)
