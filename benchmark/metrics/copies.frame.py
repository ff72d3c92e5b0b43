"""copies.frame: the copies between host and device that render() makes,
a frame: the counter copies of render()'s stats, summed over the window's
frames, over the frames (frame cells). None where the program counts no
copies."""


def read(r):
    if r.kind != "frame" or not r.stats or "copies" not in r.stats[0]:
        return None
    return sum(s["copies"] for s in r.stats) / len(r.stats)
