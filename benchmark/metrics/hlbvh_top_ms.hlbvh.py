"""hlbvh_top_ms.hlbvh: the HLBVH top tree built on the host, in ms a frame:
the stage wall time rebuild_top of update_positions' stats (span
ntrace.rebuild.top: the binned-SAH tree over the cluster boxes, after the
rebuild's one read), summed over the window's frames, over the frames
(rebuild cells). Part of rebuild_ms.hlbvh. None where the program records
no such stage."""


def read(r):
    if r.kind != "frame" or not r.stats:
        return None
    if not any("rebuild_top" in s for s in r.stats):
        return None
    return sum(s.get("rebuild_top", 0.0) for s in r.stats) / len(r.stats)
