"""host_issue_ms.<cells>: the host's own time to issue a frame, in ms a
frame: host_frame (the host's time from the entry to the exit of the
root span ntrace.render, and of ntrace.update_positions in rebuild cells)
less host_wait (its time blocked in the program's reads), from each
frame's stats, summed over the window's frames, over the frames. One
reader for both splits. Beside frame_ms, a reading near it says the host
paces the frame. None where the program records neither."""


def read(r):
    if r.kind != "frame" or not r.stats:
        return None
    if not all("host_frame" in s and "host_wait" in s for s in r.stats):
        return None
    return sum(s["host_frame"] - s["host_wait"]
               for s in r.stats) / len(r.stats)
