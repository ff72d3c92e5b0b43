"""shade_readback_ms.frame: shading and the image read back to the host,
in ms a frame: the stage wall times shade and readback of render()'s
stats, summed over the window's frames, over the frames (frame cells)."""


def read(r):
    if r.kind != "frame" or not r.stats:
        return None
    keys = [k.format(mode=r.mode) for k in ("shade", "readback")]
    return sum(s.get(k, 0.0) for s in r.stats for k in keys) / len(r.stats)
