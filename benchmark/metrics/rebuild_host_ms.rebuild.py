"""rebuild_host_ms.rebuild: the host's part of the per-frame rebuild, in
ms a frame: the host time host_rebuild of update_positions' stats (from
the stage's opening synchronise to just before its closing one: the time
the host took to issue the build, its one blocking read included), summed
over the window's frames, over the frames (rebuild cells). Beside
rebuild_ms.rebuild, a reading close to it says the build is bound by its
launches. None where the program records no rebuild stage."""


def read(r):
    if r.kind != "frame" or not r.stats:
        return None
    if not any("host_rebuild" in s for s in r.stats):
        return None
    return sum(s.get("host_rebuild", 0.0) for s in r.stats) / len(r.stats)
