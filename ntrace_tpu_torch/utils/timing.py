"""The port's tracer: stage times, profiler ranges and copy counters
(counterpart of ntrace_tpu/utils/timing.py), and CUDA-event kernel timing.

Tracing is on while a torch profiler records, or inside `tracing()`; else
it is off and costs nothing on the hot path: a stage neither synchronises
nor opens a range, and `span` does nothing. On, a StageTimer stage ends
with torch.cuda.synchronize(), so its wall time covers the device work
and not only the enqueue, and records the host's part (the time to issue
the stage's work) under host_<stage>; every stage and span is a
`torch.profiler.record_function` range, on the clock of the profiler's
device trace. No span but a stage synchronises.

`upload`, `read` and `read_all` are the copies between host and device
that a frame makes: they count `copies` and `copy_bytes` into the
StageTimer whose `frame` is open, traced or not (on a CPU device the same
sites count, though nothing crosses a bus); `read_all` also counts
`pinned_reads`. A counter held on the device (`StageTimer.count_on_device`)
is read with the frame's last copies (`StageTimer.read_all`), never on
its own. `cuda_ms` times device work with CUDA events.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from contextvars import ContextVar

import numpy as np
import torch
from torch.profiler import record_function

_tracing = ContextVar("ntrace_tracing", default=False)
_frame = ContextVar("ntrace_frame", default=None)   # the counting StageTimer


def tracing_on() -> bool:
    """True while a torch profiler records or inside `tracing()`."""
    return _tracing.get() or torch._C._autograd._profiler_enabled()


@contextmanager
def tracing():
    """Tracing on inside, with no profiler needed: stage times and
    ranges."""
    token = _tracing.set(True)
    try:
        yield
    finally:
        _tracing.reset(token)


@contextmanager
def span(name: str, args: str | None = None):
    """The profiler range `name` (with `args`) around the body while
    tracing is on; nothing while it is off."""
    if not tracing_on():
        yield
        return
    with record_function(name, args):
        yield


class StageTimer:
    """Per-stage wall and host times (raygen/trace/shade), taken while
    tracing is on, and plain counters, always kept.

    `ms()` scales only the times, so counters (ray counts, copies, ...)
    pass through unchanged.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.stages: dict[str, float] = {}
        self.counts: dict[str, float] = {}
        self.on_device: dict[str, torch.Tensor] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def frame(self, name: str, args: str | None = None):
        """The root span `name` of one frame; `upload` and `read` inside
        count into this timer."""
        token = _frame.set(self)
        try:
            with span(name, args):
                yield
        finally:
            _frame.reset(token)

    @contextmanager
    def stage(self, name: str, span: str | None = None):
        """The stage `name` as the span `span` (ntrace.<name> when None),
        timed while tracing is on."""
        if not tracing_on():
            yield
            return
        self._sync()
        # The range's own cost stays out of the times.
        with record_function(span or f"ntrace.{name}"):
            t0 = time.perf_counter()
            yield
            t1 = time.perf_counter()
            self._sync()
            t2 = time.perf_counter()
        for key, s in ((name, t2 - t0), (f"host_{name}", t1 - t0)):
            self.stages[key] = self.stages.get(key, 0.0) + s

    def count(self, name: str, n: float):
        self.counts[name] = self.counts.get(name, 0.0) + n

    def count_on_device(self, name: str, n: torch.Tensor):
        """Hold the 0-d device tensor `n` as the counter `name`, unread:
        `read_all` brings it back and counts it."""
        self.on_device[name] = n

    def read_all(self, *ts: torch.Tensor) -> list[np.ndarray]:
        """`read_all` of `ts` and, behind the same wait, the counts of
        `count_on_device` stacked into one tensor (one copy more where
        there are any), which it then counts. Returns the arrays of
        `ts`."""
        names = list(self.on_device)
        if not names:
            return read_all(*ts)
        *outs, held = read_all(
            *ts, torch.stack([self.on_device.pop(k) for k in names]))
        for name, n in zip(names, held.tolist()):
            self.count(name, n)
        return outs

    def ms(self) -> dict[str, float]:
        return {**{k: v * 1e3 for k, v in self.stages.items()},
                **self.counts}


def _copied(nbytes: int, pinned: bool | None = None):
    """Count one copy of `nbytes`; `pinned` (read_all's reads) also counts
    whether it landed in page-locked memory."""
    timer = _frame.get()
    if timer is not None:
        timer.count("copies", 1)
        timer.count("copy_bytes", nbytes)
        if pinned is not None:
            timer.count("pinned_reads", int(pinned))


def upload(a: np.ndarray, device) -> torch.Tensor:
    """The host array `a` as a tensor on `device`: one copy of its bytes."""
    t = torch.as_tensor(a, device=device)
    _copied(t.numel() * t.element_size())
    return t


def read(t: torch.Tensor) -> np.ndarray:
    """The tensor `t` on the host, as numpy: one copy of its bytes."""
    a = t.cpu().numpy()
    _copied(a.nbytes)
    return a


def read_all(*ts: torch.Tensor) -> list[np.ndarray]:
    """The tensors `ts` on the host, as numpy: one copy of each's bytes.

    On a CUDA device each lands in a fresh page-locked block from torch's
    caching host allocator, every copy queued on the current stream behind
    the work before it, and the host waits once, after the last; a block
    goes back to the cache when its array is dropped. On the CPU each is
    `read`."""
    pinned = ts[0].device.type == "cuda"
    if pinned:
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in ts]
        for h, t in zip(host, ts):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(ts[0].device).synchronize()
        outs = [h.numpy() for h in host]
    else:
        outs = [t.cpu().numpy() for t in ts]
    for a in outs:
        _copied(a.nbytes, pinned)
    return outs


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
