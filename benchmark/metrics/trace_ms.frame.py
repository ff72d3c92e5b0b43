"""trace_ms.frame: the traversal as the frame sees it, in ms a frame: the
stage wall times trace_primary and trace_<mode> of render()'s stats,
summed over the window's frames, over the frames (frame cells)."""


def read(r):
    if r.kind != "frame" or not r.stats:
        return None
    keys = [k.format(mode=r.mode) for k in ("trace_primary", "trace_{mode}")]
    return sum(s.get(k, 0.0) for s in r.stats for k in keys) / len(r.stats)
