"""host_wait_ms.<cells>: the host's wait for the device, in ms a frame: the
host time host_wait of each frame's stats (the blocking part of the
program's reads, timing.read and read_all: render()'s one wait for its
image, and in rebuild cells also update_positions' read), summed over the
window's frames, over the frames. One reader for both splits. None unless
every frame records its host wait."""


def read(r):
    if r.kind != "frame" or not r.stats:
        return None
    if not all("host_wait" in s for s in r.stats):
        return None
    return sum(s["host_wait"] for s in r.stats) / len(r.stats)
