"""mrays_s: the live rays (tmax > tmin) of every batch traced in the
window, in millions, over the window's seconds (rays cells)."""


def read(r):
    if r.kind != "rays" or not r.window_s:
        return None
    return r.live_rays / r.window_s / 1e6
