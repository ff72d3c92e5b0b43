"""What the benchmark reads from a torch.profiler trace of its window.

`profiled(fn, device)` runs fn() under the profiler (CPU and CUDA
activities) and reduces the trace to:
  - busy_s: the union of the device's operation intervals (kernels,
    copies, sets), so overlapping work counts once;
  - by_name: each device operation's time, by name;
  - device_ops: the ten device operations with the most time, by name;
  - idle_gaps: the device's idle time between operations, by what the host
    was doing then (the innermost CPU event open at the gap's middle), the
    ten largest.
The harness's own `record_function` ranges (SPAN, around each pass call;
the frame's) name the host's time between operations; their copies on the
device timeline are not operations and are left out. The kernels the
program launches through ctypes carry no link to the range they were
launched in, so device time is split by the operations' names, not by
range. The device-time reduction follows chip_smoke.py:profile_once.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

SPAN = "benchmark.pass"
FRAME_SPAN = "benchmark.frame"
TOP = 10
NAME_CHARS = 160        # a device operation's name, cut to this length
# How far back among the CPU events started before a gap the search for an
# open one goes; a gap with none open is the host outside any operation.
LOOKBACK = 256


def profiled(fn, device):
    """(fn's result, reduction) of one call of fn() under the profiler."""
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return out, reduce_events(prof.events())


def _is_device(e) -> bool:
    return e.device_type in (DeviceType.CUDA, DeviceType.PrivateUse1)


def _is_range(e) -> bool:
    """A record_function range's copy on the device timeline."""
    return (getattr(e, "is_user_annotation", False)
            or e.name in (SPAN, FRAME_SPAN))


def reduce_events(events) -> dict:
    dev = [(e.time_range.start, e.time_range.end, e.name[:NAME_CHARS])
           for e in events if _is_device(e) and not _is_range(e)
           and e.time_range.end > e.time_range.start]
    cpu = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in events if not _is_device(e)),
                 key=lambda x: x[0])
    by_name = defaultdict(float)
    for s, t, name in dev:
        by_name[name] += t - s
    busy_us, gaps = 0.0, []
    dev.sort(key=lambda x: x[0])
    cur_s = cur_t = None
    for s, t, _ in dev:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy_us += cur_t - cur_s
                gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy_us += cur_t - cur_s
    starts = [c[0] for c in cpu]
    idle = defaultdict(float)
    for g0, g1 in gaps:
        idle[_open_at(cpu, starts, (g0 + g1) / 2)] += g1 - g0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us / 1e6,
            "by_name": {k: v / 1e6 for k, v in by_name.items()},
            "device_ops": [[k, v / 1e6] for k, v in top],
            "idle_gaps": [[k, v / 1e6] for k, v in top_idle]}


def _open_at(cpu, starts, t) -> str:
    """The name of the innermost CPU event open at time t: the latest
    started one that has not ended."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - LOOKBACK, -1), -1):
        if cpu[j][1] >= t:
            return cpu[j][2]
    return "host outside any operation"
