"""frame_ms_p95: the 95th percentile of every frame's milliseconds in the
window, each frame timed from its render() call to its image on the host
(frame cells)."""

import statistics


def read(r):
    if r.kind != "frame" or not r.frame_s:
        return None
    ms = [s * 1e3 for s in r.frame_s]
    if len(ms) == 1:
        return ms[0]
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
