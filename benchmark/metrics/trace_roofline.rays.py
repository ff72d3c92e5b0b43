"""trace_roofline.rays: the share of their roofline that the traversal
kernels reach in the rays cells' traced window, in %: the least time the
chip could take for every pass the window called (lib/bound.py, from
lib/count.py's work on each batch) over the device time of the kernels
whose names hold one of the configuration's `trace_kernels` (the
live-prefix compaction, copies and allocations of a pass left out). None
where no such kernel ran."""


def read(r):
    if r.profile is None or r.bound_s is None or not r.trace_kernels:
        return None
    kernel_s = sum(s for name, s in r.profile["by_name"].items()
                   if any(k in name for k in r.trace_kernels))
    if kernel_s <= 0:
        return None
    return 100.0 * r.bound_s / kernel_s
