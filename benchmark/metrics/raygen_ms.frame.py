"""raygen_ms.frame: ray generation, primary and secondary, in ms a frame:
the stage wall times raygen and raygen_<mode> of render()'s stats, summed
over the window's frames, over the frames (frame cells)."""


def read(r):
    if r.kind != "frame" or not r.stats:
        return None
    keys = [k.format(mode=r.mode) for k in ("raygen", "raygen_{mode}")]
    return sum(s.get(k, 0.0) for s in r.stats for k in keys) / len(r.stats)
