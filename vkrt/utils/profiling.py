"""Profiling/observability: frame timing, Mrays/s, XLA profiler hooks.

The reference's observability is an ImGui ms/frame+FPS readout (main.cpp:459)
and debug-utils pass labels visible in Nsight (hello_vulkan.cpp:587-1472).
The equivalents here: a FrameStats aggregator (ms/frame, FPS, Mrays/s —
the numbers the panel showed, plus the ones BASELINE.json asks for), named
trace annotations via ``jax.profiler.TraceAnnotation`` (the XLA-trace analog
of beginLabel/endLabel), and an optional ``jax.profiler`` device trace for
TensorBoard.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import jax


@dataclass
class FrameStats:
    """Rolling frame statistics — the ImGui readout, headless."""

    times_s: List[float] = field(default_factory=list)
    rays: List[float] = field(default_factory=list)

    def record(self, seconds: float, rays: float = 0.0):
        self.times_s.append(seconds)
        self.rays.append(rays)

    @property
    def ms_per_frame(self) -> float:
        return 1e3 * sum(self.times_s) / max(len(self.times_s), 1)

    @property
    def fps(self) -> float:
        t = sum(self.times_s) / max(len(self.times_s), 1)
        return 1.0 / t if t > 0 else 0.0

    @property
    def mrays_per_s(self) -> float:
        t = sum(self.times_s)
        return sum(self.rays) / t / 1e6 if t > 0 else 0.0

    def summary(self) -> dict:
        return {
            "frames": len(self.times_s),
            "ms_per_frame": round(self.ms_per_frame, 3),
            "fps": round(self.fps, 2),
            "mrays_per_s": round(self.mrays_per_s, 2),
        }

    def log(self, stream=sys.stderr):
        print(json.dumps(self.summary()), file=stream)


@contextlib.contextmanager
def pass_label(name: str):
    """Named region in XLA device traces — beginLabel/endLabel equivalent."""
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def timed_frame(stats: FrameStats, rays: float = 0.0, *, block=None):
    """Time one frame; ``block``: array/pytree to block_until_ready on."""
    t0 = time.perf_counter()
    yield
    if block is not None:
        jax.block_until_ready(block)
    stats.record(time.perf_counter() - t0, rays)


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """jax.profiler trace for TensorBoard; no-op when logdir is None."""
    if logdir is None:
        yield
        return
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def nan_debug(enable: bool = True):
    """Opt-in NaN tripwire (SURVEY.md §5: the analog of Vulkan
    validation): any NaN produced under this scope raises immediately."""
    if not enable:
        yield
        return
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)
