"""Timing + observability — SURVEY.md §2 #21 / §5.

The reference's only observability is a Timer struct (precomp.h:162-182)
and a per-frame running-average `ms / fps / MRays/s` printf
(renderer.cpp:2208-2213).  Here: the same running-average frame reporter,
plus structured counters and a `jax.profiler` trace context for real
kernel-level profiling on the device."""

from __future__ import annotations

import contextlib
import json
import sys
import time


class Timer:
    """Drop-in analogue of the template Timer (precomp.h:162-182)."""

    def __init__(self):
        self._start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    def reset(self) -> None:
        self._start = time.perf_counter()


class FrameReport:
    """Running-average frame stats with the reference's alpha decay
    (renderer.cpp:2208-2213: avg = (1-alpha)*avg + alpha*ms; alpha *= 0.5
    down to 0.05)."""

    def __init__(self, width: int, height: int, stream=sys.stderr):
        self.avg_ms = 10.0
        self.alpha = 1.0
        self.rays_per_frame = width * height
        self.stream = stream
        self.times = []  # raw per-frame seconds (entry 0 includes compile)

    def frame(self, seconds: float) -> dict:
        self.times.append(seconds)
        ms = seconds * 1000.0
        self.avg_ms = (1 - self.alpha) * self.avg_ms + self.alpha * ms
        if self.alpha > 0.05:
            self.alpha *= 0.5
        fps = 1000.0 / self.avg_ms
        mrays = self.rays_per_frame / self.avg_ms / 1000.0
        stats = {"ms": round(self.avg_ms, 2), "fps": round(fps, 1),
                 "mrays_s": round(mrays, 2)}
        print(f"{self.avg_ms:5.2f}ms ({fps:.1f}fps) - {mrays:.1f}Mrays/s",
              file=self.stream)
        return stats


class Counters:
    """Structured counters the reference never had: emitted as JSON lines."""

    def __init__(self, stream=sys.stderr):
        self.data: dict = {}
        self.stream = stream

    def add(self, key: str, value: float = 1.0):
        self.data[key] = self.data.get(key, 0.0) + value

    def emit(self, **extra):
        print(json.dumps({**self.data, **extra}), file=self.stream)
        self.data.clear()


@contextlib.contextmanager
def device_trace(log_dir: str = "/tmp/voxtracer_trace"):
    """jax.profiler trace context — open with TensorBoard / xprof."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
