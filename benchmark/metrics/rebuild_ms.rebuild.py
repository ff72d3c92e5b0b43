"""rebuild_ms.rebuild: the per-frame rebuild of the tree, in ms a frame:
the stage wall time rebuild of update_positions' stats (spans
ntrace.rebuild and its inputs, lbvh and node_count), summed over the
window's frames, over the frames (rebuild cells). None where the program
records no rebuild stage."""


def read(r):
    if r.kind != "frame" or not r.stats:
        return None
    if not any("rebuild" in s for s in r.stats):
        return None
    return sum(s.get("rebuild", 0.0) for s in r.stats) / len(r.stats)
