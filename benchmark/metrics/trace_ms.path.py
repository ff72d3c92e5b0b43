"""trace_ms.path: the traversal of a path frame, in ms a frame: the stage
wall times trace_primary and trace_bounce<b> of render()'s stats (spans
ntrace.trace_primary, ntrace.trace_bounce<b>: each pass's live-prefix
read and kernel), summed over the window's frames, over the frames (path
cells). None where the program records no bounce stage."""

import re

STAGE = re.compile(r"trace_primary|trace_bounce\d+")


def read(r):
    if r.kind != "frame" or not r.stats:
        return None
    if not any(k.startswith("trace_bounce") for s in r.stats for k in s):
        return None
    return sum(v for s in r.stats for k, v in s.items()
               if STAGE.fullmatch(k)) / len(r.stats)
