"""copy_mb.frame: the bytes that render()'s copies between host and device
move, in MB (1e6 bytes) a frame: the counter copy_bytes of render()'s
stats, summed over the window's frames, over the frames (frame cells).
None where the program counts no copies."""


def read(r):
    if r.kind != "frame" or not r.stats or "copy_bytes" not in r.stats[0]:
        return None
    return sum(s["copy_bytes"] for s in r.stats) / len(r.stats) / 1e6
