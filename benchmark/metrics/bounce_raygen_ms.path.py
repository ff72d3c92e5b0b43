"""bounce_raygen_ms.path: the bounce rays' generation, in ms a frame: the
stage wall times raygen_bounce<b> of render()'s stats (the hit's
material gathers, emission and throughput, normals, origins, the key's
split and cosine directions, the Morton sort), summed over the window's
frames, over the frames (path cells). None where the program records no
such stage."""

import re

STAGE = re.compile(r"raygen_bounce\d+")


def read(r):
    if r.kind != "frame" or not r.stats:
        return None
    if not any(STAGE.fullmatch(k) for s in r.stats for k in s):
        return None
    return sum(v for s in r.stats for k, v in s.items()
               if STAGE.fullmatch(k)) / len(r.stats)
