"""device_idle_pct.<cells>: the share of the traced window's wall time in
which no operation ran on the device, in %. One reader for every split of
the metric; BENCHMARK.json's `workloads` of each split names its cells."""


def read(r):
    if r.profile is None or not r.window_s:
        return None
    return 100.0 * (1.0 - r.profile["busy_s"] / r.window_s)
