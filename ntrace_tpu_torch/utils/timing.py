"""Stage timing and CUDA-event kernel timing (counterpart of
ntrace_tpu/utils/timing.py).

On a CUDA device a stage ends with torch.cuda.synchronize(), so its wall
time covers the device work and not only the enqueue. `cuda_ms` times
device work with CUDA events.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch


class StageTimer:
    """Per-stage wall times (raygen/trace/shade) and plain counters.

    `ms()` scales only the times, so counters (ray counts, ...) pass through
    unchanged.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.stages: dict[str, float] = {}
        self.counts: dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.stages[name] = (self.stages.get(name, 0.0)
                             + time.perf_counter() - t0)

    def count(self, name: str, n: float):
        self.counts[name] = self.counts.get(name, 0.0) + n

    def ms(self) -> dict[str, float]:
        return {**{k: v * 1e3 for k, v in self.stages.items()},
                **self.counts}


def cuda_ms(fn, *, warmup: int = 1, iters: int = 10) -> list[float]:
    """Device milliseconds of each of `iters` calls of fn(), after `warmup`
    calls, each bracketed by CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times
