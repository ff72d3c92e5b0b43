"""frame_ms: the window's milliseconds over the frames completed in it
(frame cells)."""


def read(r):
    if r.kind != "frame" or not r.frame_s:
        return None
    return r.window_s * 1e3 / len(r.frame_s)
