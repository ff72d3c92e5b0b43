"""raygen_host_ms.frame: the host's part of ray generation, in ms a frame:
the host times host_raygen and host_raygen_<mode> of render()'s stats
(from a stage's opening synchronise to just before its closing one: the
time the host took to issue the stage's work), summed over the window's
frames, over the frames (frame cells). Beside raygen_ms.frame, a reading
close to it says the stage is bound by its launches. None where the
program records no host times."""


def read(r):
    if r.kind != "frame" or not r.stats:
        return None
    keys = [k.format(mode=r.mode) for k in ("host_raygen",
                                            "host_raygen_{mode}")]
    if not any(k in s for s in r.stats for k in keys):
        return None
    return sum(s.get(k, 0.0) for s in r.stats for k in keys) / len(r.stats)
