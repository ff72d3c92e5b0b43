"""rebuild_ms.hlbvh: the per-frame HLBVH rebuild, in ms a frame: the stage
wall time rebuild of update_positions' stats (spans ntrace.rebuild and its
inputs, forest, read, top and splice), summed over the window's frames,
over the frames (rebuild cells). None where the program records no
rebuild stage."""


def read(r):
    if r.kind != "frame" or not r.stats:
        return None
    if not any("rebuild" in s for s in r.stats):
        return None
    return sum(s.get("rebuild", 0.0) for s in r.stats) / len(r.stats)
