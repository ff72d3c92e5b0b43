"""The port's tracer: stage times, profiler ranges and copy counters
(counterpart of ntrace_tpu/utils/timing.py), and CUDA-event kernel timing.

Tracing is on while a torch profiler records, or inside `tracing()`; else
it is off and costs nothing on the hot path: a stage takes no time and
opens no range. While a profiler records, every frame, stage and span is
a `torch.profiler.record_function` range, on the clock of the profiler's
device trace (inside `tracing()` alone no range opens: nothing would
record it). On, stages take times, and nothing of the tracer waits for
the device:
  - `<stage>` is the stage's device span. On a CUDA device a stage records
    a timing event on the current stream at its entry and one at its exit,
    and `<stage>` is the time from when the device reaches the first to
    when it reaches the second, so a gap in which the device waits for the
    host's issue falls inside the stage the host was in. A frame records
    an event at its entry, and a stage opened at the top of the frame
    takes the last event before it (the frame's, or the exit of the
    top-level stage before it) as its entry: the top-level stages tile the
    frame's device timeline. The frame's one `StageTimer.read_all` ends
    the device span of every stage open around it behind its copies. A
    timer that records events waits in this module's pending list until
    the device has passed them (`StageTimer.resolve`, a query and no
    wait), which is looked up after the waits the program already makes
    (`read`, `read_all`) and at the exit of a frame: a frame's own spans
    resolve after its wait, those of the calls before it (the build's, a
    rebuild's) after the next frame's. Resolved events go back to a
    spare pool of their device, which later stages record on again. On
    the CPU, and while the current stream captures a CUDA graph (no event
    may be recorded then), `<stage>` is the host's wall time of the
    stage.
  - `host_<stage>` is the host's time inside the stage: the time to issue
    its work, and any wait inside it.
  - `host_wait` is the host's time blocked in `read` and `read_all` (their
    wait for the device and the copies), and `host_frame` the host's time
    from the entry to the exit of the root span (`StageTimer.frame`); the
    difference is the host's own time to issue the frame.

`upload`, `read` and `read_all` are the copies between host and device
that a frame makes: they count `copies` and `copy_bytes` into the
StageTimer whose `frame` is open, traced or not (on a CPU device the same
sites count, though nothing crosses a bus). A counter held on the device
(`StageTimer.count_on_device`) is read with the frame's last copies
(`StageTimer.read_all`), never on its own. `cuda_ms` times device work
with CUDA events.
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
_spare: dict[int, list] = {}  # resolved timing events, by CUDA device index
_pending: list = []           # the timers holding events not yet resolved


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
    """The profiler range `name` (with `args`) around the body while a
    profiler records; nothing else."""
    if not torch._C._autograd._profiler_enabled():
        yield
        return
    with record_function(name, args):
        yield


class StageTimer:
    """Per-stage device spans and host times (raygen/trace/shade), taken
    while tracing is on, and plain counters, always kept.

    `ms()` scales only the times, so counters (ray counts, copies, ...)
    pass through unchanged. A stage whose events are still on the device
    when `ms()` is called enters the dict it returned once `resolve()`
    finds them passed.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.stages: dict[str, float] = {}
        self.counts: dict[str, float] = {}
        self.on_device: dict[str, torch.Tensor] = {}
        self._spans = []      # [name, entry event, exit event], unresolved
        self._open = []       # the open stages' entries, innermost last
        self._edge = None     # the event a top-level stage opens on
        self._last = None     # the event recorded last
        self._recorded = []   # the events recorded, each once
        self._out = None      # the dict ms() returned

    def _timed(self) -> bool:
        """Whether stages time by events now: on a CUDA device whose
        current stream is not capturing a graph."""
        return (self.device.type == "cuda"
                and not torch.cuda.is_current_stream_capturing())

    def _event(self) -> torch.cuda.Event:
        """A timing event, spare or new, recorded on the current stream;
        the first makes the timer pending."""
        spare = _spare.setdefault(torch.cuda.current_device(), [])
        self._last = (spare.pop() if spare
                      else torch.cuda.Event(enable_timing=True))
        self._last.record()
        if not self._recorded:
            _pending.append(self)
        self._recorded.append(self._last)
        return self._last

    def _add(self, key: str, s: float):
        self.stages[key] = self.stages.get(key, 0.0) + s
        if self._out is not None:
            self._out[key] = self.stages[key] * 1e3

    @contextmanager
    def frame(self, name: str, args: str | None = None):
        """The root span `name` of one frame; `upload` and `read` inside
        count into this timer, and while tracing is on its host time is
        `host_frame`."""
        token = _frame.set(self)
        try:
            if not tracing_on():
                yield
                return
            with span(name, args):
                t0 = time.perf_counter()
                if self._timed():
                    self._edge = self._event()
                yield
                self._add("host_frame", time.perf_counter() - t0)
        finally:
            _frame.reset(token)
        _settle()

    @contextmanager
    def stage(self, name: str, label: str | None = None):
        """The stage `name` as the span `label` (ntrace.<name> when None),
        timed while tracing is on."""
        if not tracing_on():
            yield
            return
        # The range's own cost stays out of the host times.
        with span(label or f"ntrace.{name}"):
            top = not self._open
            rec = [name, None, None]
            if self._timed():
                rec[1] = (self._edge if top and self._edge is not None
                          else self._event())
                self._spans.append(rec)
            self._open.append(rec)
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._open.pop()
            t1 = time.perf_counter()
            if rec[1] is not None and rec[2] is None:
                rec[2] = self._event()
            if top:
                self._edge = rec[2]
        self._add(f"host_{name}", t1 - t0)
        if rec[1] is None:
            self._add(name, t1 - t0)

    def resolve(self) -> bool:
        """Once the device has passed the event recorded last (one query,
        no wait), add the device span of every stage whose exit event is
        recorded, and with no stage or frame of it open and no span left
        give the events back to the spares of their device; True while
        the timer still holds events. A stage's events are on one stream,
        the current one at its entry and exit."""
        if self._last is None or not self._last.query():
            return bool(self._recorded)
        left = []
        for rec in self._spans:
            name, e0, e1 = rec
            if e1 is None:
                left.append(rec)
            else:
                self._add(name, e0.elapsed_time(e1) / 1e3)
        self._spans = left
        if not left and not self._open and _frame.get() is not self:
            _spare.setdefault(torch.cuda.current_device(), []).extend(
                self._recorded)
            self._recorded, self._edge, self._last = [], None, None
        return bool(self._recorded)

    def _end_open_stages(self):
        """Record here, behind the work queued so far, the device exit of
        every open stage: nothing the stages issue after it is device
        work."""
        if any(rec[1] is not None for rec in self._open):
            end = self._event()
            for rec in self._open:
                if rec[1] is not None:
                    rec[2] = end

    def count(self, name: str, n: float):
        self.counts[name] = self.counts.get(name, 0.0) + n

    def count_on_device(self, name: str, n: torch.Tensor):
        """Hold the 0-d device tensor `n` as the counter `name`, unread:
        `read_all` brings it back and counts it."""
        self.on_device[name] = n

    def read_all(self, *ts: torch.Tensor) -> list[np.ndarray]:
        """`read_all` of `ts` and, behind the same wait, the counts of
        `count_on_device` stacked into one tensor (one copy more where
        there are any), which it then counts; the frame's last device
        work: the open stages end on the device behind its copies.
        Returns the arrays of `ts`."""
        names = list(self.on_device)
        held = ([torch.stack([self.on_device.pop(k) for k in names])]
                if names else [])
        outs = read_all(*ts, *held)
        if names:
            for name, n in zip(names, outs.pop().tolist()):
                self.count(name, n)
        return outs

    def ms(self) -> dict[str, float]:
        self._out = {**{k: v * 1e3 for k, v in self.stages.items()},
                     **self.counts}
        return self._out


def _settle():
    """Resolve the pending timers, after a wait or at a frame's exit: those
    whose events the device has passed leave the list."""
    if _pending:
        _pending[:] = [t for t in _pending if t.resolve()]


def _copied(nbytes: int):
    """Count one copy of `nbytes` into the open frame's timer."""
    timer = _frame.get()
    if timer is not None:
        timer.count("copies", 1)
        timer.count("copy_bytes", nbytes)


@contextmanager
def _waiting():
    """The body, a wait for the device, timed as the open frame's
    host_wait while tracing is on."""
    timer = _frame.get()
    if timer is None or not tracing_on():
        yield
        return
    t0 = time.perf_counter()
    yield
    timer._add("host_wait", time.perf_counter() - t0)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """The host array `a` as a tensor on `device`: one copy of its bytes."""
    t = torch.as_tensor(a, device=device)
    _copied(t.numel() * t.element_size())
    return t


def read(t: torch.Tensor) -> np.ndarray:
    """The tensor `t` on the host, as numpy: one copy of its bytes."""
    with _waiting():
        a = t.cpu().numpy()
    _settle()
    _copied(a.nbytes)
    return a


def read_all(*ts: torch.Tensor) -> list[np.ndarray]:
    """The tensors `ts` on the host, as numpy: one copy of each's bytes.

    On a CUDA device each lands in a fresh page-locked block from torch's
    caching host allocator, every copy queued on the current stream behind
    the work before it, and the host waits once, after the last; a block
    goes back to the cache when its array is dropped; the stages open in
    the open frame end on the device behind the copies. On the CPU each is
    `read`."""
    if ts[0].device.type == "cuda":
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in ts]
        for h, t in zip(host, ts):
            h.copy_(t, non_blocking=True)
        timer = _frame.get()
        if timer is not None:
            timer._end_open_stages()
        with _waiting():
            torch.cuda.current_stream(ts[0].device).synchronize()
        _settle()
        outs = [h.numpy() for h in host]
    else:
        with _waiting():
            outs = [t.cpu().numpy() for t in ts]
    for a in outs:
        _copied(a.nbytes)
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
