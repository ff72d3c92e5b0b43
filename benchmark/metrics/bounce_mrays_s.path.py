"""bounce_mrays_s.path: the bounce passes' rate, in Mrays/s: the counters
live_bounce<b> of render()'s stats (the live rays each bounce's
live-prefix read found), summed over the window's frames, over the stage
wall times trace_bounce<b> summed alike (path cells). None where the
program counts no live bounce rays."""

import re

LIVE = re.compile(r"live_bounce\d+")
STAGE = re.compile(r"trace_bounce\d+")


def read(r):
    if r.kind != "frame" or not r.stats:
        return None
    live = sum(v for s in r.stats for k, v in s.items() if LIVE.fullmatch(k))
    ms = sum(v for s in r.stats for k, v in s.items() if STAGE.fullmatch(k))
    if not live or not ms:
        return None
    return live / ms / 1e3
