"""The LBVH's child boxes: range minima over the Morton-sorted triangle
boxes.

Replaces no TPU kernel. The reference (ntrace_tpu/bvh/lbvh.py) answers the
same queries from a sparse range-min table of ceil(log2 n) + 1 levels of
(6, n) float32, built with jnp ops. `child_boxes` takes, for each compact
node q, its two child ranges [a[q], i[q]) and [i[q], b[q]) of sorted rows
and returns both boxes, (m, 12) float32 as [lo0, hi0, lo1, hi1] (three
lanes each); nodes at or past `count` (a 0-d int32 tensor on the device,
never read on the host) get zeros.

A CUDA tensor goes through the hand-written kernel (csrc/child_boxes.cu:
one pass builds a min tree of fan-out 32 over the rows, then one warp a
node reads the partial groups at both ends of each range, level by level);
a CPU tensor goes through the plain version `child_boxes_ref`, which keeps
the kernel's levels and decomposition. Nothing falls back from one to the
other: a failed build or launch raises.

Both compare floats as integer keys (`float_keys`): every float but NaN in
the order of its value, and -0.0 below +0.0. The minimum of a set of keys
is exact and does not depend on the order it is taken in, so any
decomposition gives the same bits, and a lane that holds both zeros gives
-0.0 to lo and +0.0 to hi, as lax.min does in the reference (a set that
holds a NaN is not ordered as lax.min would order it).
"""

from __future__ import annotations

import torch

from ntrace_tpu_torch.device import uses_kernel

FAN = 32                      # entries a group of the min tree holds
_IDENTITY = 0x7FFFFFFF        # the key above every float's


def float_keys(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of float32 values, in the order of the values, -0.0 just
    below +0.0; the map is its own inverse (`key_floats`)."""
    u = x.contiguous().view(torch.int32)
    return u ^ ((u >> 31) & 0x7FFFFFFF)


def key_floats(k: torch.Tensor) -> torch.Tensor:
    """float32 values of int32 keys (the inverse of `float_keys`)."""
    return (k ^ ((k >> 31) & 0x7FFFFFFF)).view(torch.float32)


def level_sizes(n: int) -> list[int]:
    """Entries of each level of the min tree over n rows, the rows first:
    levels of fan-out FAN up to one of at most FAN entries, and at least
    two above the rows; the rows alone for n <= FAN."""
    sizes = [n]
    while n > FAN and (len(sizes) < 3 or sizes[-1] > FAN):
        sizes.append(-(-sizes[-1] // FAN))
    return sizes


def _check(slo, shi, a, i, b, count):
    n = slo.shape[0]
    if slo.dim() != 2 or slo.shape[1] != 3 or shi.shape != slo.shape \
            or slo.dtype != torch.float32 or shi.dtype != torch.float32:
        raise ValueError(f"slo, shi must be (n, 3) float32, got "
                         f"{tuple(slo.shape)} {slo.dtype}, "
                         f"{tuple(shi.shape)} {shi.dtype}")
    if not 0 < n < 1 << 24:
        raise ValueError(f"{n} rows: the kernel takes 1 to 2**24 - 1")
    m = a.shape[0]
    for name, t in (("a", a), ("i", i), ("b", b)):
        if t.dim() != 1 or t.shape[0] != m or t.dtype != torch.int32:
            raise ValueError(f"{name} must be ({m},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if count.numel() != 1 or count.dtype != torch.int32:
        raise ValueError(f"count must be one int32, got {tuple(count.shape)}"
                         f" {count.dtype}")
    if any(t.device != slo.device for t in (shi, a, i, b, count)):
        raise ValueError("child_boxes: the tensors lie on different devices")


def box_levels_ref(slo: torch.Tensor, shi: torch.Tensor) -> list:
    """The min tree: the rows' keys (n, 6) as [lo, ~hi], then each level's
    (size, 6) group minima (`level_sizes`)."""
    levels = [torch.cat([float_keys(slo), ~float_keys(shi)], dim=1)]
    for size in level_sizes(slo.shape[0])[1:]:
        prev = levels[-1]
        pad = prev.new_full((size * FAN - prev.shape[0], 6), _IDENTITY)
        levels.append(torch.cat([prev, pad]).reshape(size, FAN, 6).amin(1))
    return levels


def _take(acc, level, p, c, live):
    """acc minimised with the entries [p, p + c) of `level` where live."""
    lane = torch.arange(FAN, device=p.device)
    idx = p[:, None] + lane
    ok = live[:, None] & (lane < c[:, None])
    got = level[torch.where(ok, idx, 0)]
    return torch.minimum(acc, torch.where(ok[..., None], got,
                                          _IDENTITY).amin(1))


def range_keys_ref(levels: list, l: torch.Tensor,
                   r: torch.Tensor) -> torch.Tensor:
    """(m, 6) key minima over rows [l, r) (the identity where empty), by
    the kernel's decomposition: at each level the partial groups at both
    ends, then the whole groups between them one level up, until the
    range fits in two groups or reaches the top."""
    l, r = l.long(), r.long()
    acc = torch.full((l.shape[0], 6), _IDENTITY, dtype=torch.int32,
                     device=l.device)
    live = l < r
    top = len(levels) - 1
    for h, level in enumerate(levels):
        if h == top:
            return _take(acc, level, l, r - l, live)
        lu, rd = (l + FAN - 1) // FAN, r // FAN
        last = lu >= rd
        acc = _take(acc, level, l,
                    torch.where(last, (r - l).clamp(max=FAN), lu * FAN - l),
                    live)
        p2 = torch.where(last, l + FAN, rd * FAN)
        acc = _take(acc, level, p2, r - p2, live)
        live = live & ~last
        l, r = lu, rd
    return acc


def _boxes(keys: torch.Tensor) -> torch.Tensor:
    return torch.cat([key_floats(keys[:, :3]), key_floats(~keys[:, 3:])],
                     dim=1)


def child_boxes_ref(slo, shi, a, i, b, count) -> torch.Tensor:
    """The plain version of `child_boxes`, in torch on any device."""
    _check(slo, shi, a, i, b, count)
    levels = box_levels_ref(slo, shi)
    valid = torch.arange(a.shape[0], device=a.device) < count
    l, mid, r = (torch.where(valid, t, 0) for t in (a, i, b))
    out = torch.cat([_boxes(range_keys_ref(levels, l, mid)),
                     _boxes(range_keys_ref(levels, mid, r))], dim=1)
    return torch.where(valid[:, None], out, 0.0)


def child_boxes(slo, shi, a, i, b, count) -> torch.Tensor:
    """Both child boxes of each node: (m, 12) float32 [lo0, hi0, lo1, hi1]
    over the sorted rows [a, i) and [i, b) of slo / shi (n, 3) float32;
    zeros from `count` (0-d int32) on. a, i, b: (m,) int32 with
    0 <= a <= i <= b <= n below count; an empty range gives the box of no
    row, NaN in every lane (the child ranges of a build are never empty)."""
    _check(slo, shi, a, i, b, count)
    if not uses_kernel(slo):
        return child_boxes_ref(slo, shi, a, i, b, count)
    from ntrace_tpu_torch.kernels.build import launch, library

    n, m = slo.shape[0], a.shape[0]
    ins = [t.contiguous() for t in (slo, shi, a, i, b, count)]
    out = torch.empty((m, 12), dtype=torch.float32, device=slo.device)
    scratch = torch.empty((library().ntrace_child_boxes_scratch(n),),
                          dtype=torch.int32, device=slo.device)
    with torch.cuda.device(slo.device):
        stream = torch.cuda.current_stream(slo.device).cuda_stream
        launch("ntrace_child_boxes", *(t.data_ptr() for t in ins),
               out.data_ptr(), scratch.data_ptr(), scratch.numel(), n, m,
               stream)
    child_boxes.launches += 1
    return out


child_boxes.launches = 0   # kernel entry calls since the last reset
