"""raygen_host_ms.path: the host's part of the bounce rays' generation, in
ms a frame: the host times host_raygen_bounce<b> of render()'s stats (from
a stage's opening synchronise to just before its closing one: the time
the host took to issue the stage's work), summed over the window's frames,
over the frames (path cells). Beside bounce_raygen_ms.path, a reading
close to it says the stages are bound by their launches. None where the
program records no such host time."""

import re

STAGE = re.compile(r"host_raygen_bounce\d+")


def read(r):
    if r.kind != "frame" or not r.stats:
        return None
    if not any(STAGE.fullmatch(k) for s in r.stats for k in s):
        return None
    return sum(v for s in r.stats for k, v in s.items()
               if STAGE.fullmatch(k)) / len(r.stats)
