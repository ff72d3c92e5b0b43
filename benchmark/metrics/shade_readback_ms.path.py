"""shade_readback_ms.path: a path frame's shading and read back, in ms a
frame: the stage wall times shade_bounce<b> (each bounce's unsort, sky
term and live mask; the last hit's emission), shade and readback of
render()'s stats, summed over the window's frames, over the frames (path
cells). None where the program records no shade_bounce stage."""

import re

STAGE = re.compile(r"shade_bounce\d+|shade|readback")


def read(r):
    if r.kind != "frame" or not r.stats:
        return None
    if not any(k.startswith("shade_bounce") for s in r.stats for k in s):
        return None
    return sum(v for s in r.stats for k, v in s.items()
               if STAGE.fullmatch(k)) / len(r.stats)
