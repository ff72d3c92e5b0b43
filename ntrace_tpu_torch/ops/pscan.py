"""Row-wise int32 cummax / cummin: the LBVH builder's ANSV class scans.

Counterpart of ntrace_tpu/ops/pscan.py (`_make_kernel` 33, `_scan` 63,
`row_scan_i32` 101). `row_scan_i32` computes the inclusive row-wise cummax
or cummin of a 2-D int32 tensor along axis 1, forward or reverse,
bit-identical to `lax.cummax` / `lax.cummin(x, axis=1, reverse=...)`.

A CUDA tensor goes through the hand-written kernel (csrc/row_scan.cu, a
two-pass tile-aggregate scan); a CPU tensor goes through the plain version
`row_scan_i32_ref`. Nothing falls back from one to the other: a failed
build or launch raises.
"""

from __future__ import annotations

import torch

from ntrace_tpu_torch.device import uses_kernel

OPS = ("max", "min")


def _check(x: torch.Tensor, op: str):
    if op not in OPS:
        raise ValueError(f"op must be 'max' or 'min', got {op!r}")
    if x.dim() != 2:
        raise ValueError(f"row_scan_i32 takes a 2-D tensor, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.int32:
        raise TypeError(f"row_scan_i32 takes int32, got {x.dtype}")


def row_scan_i32_ref(x: torch.Tensor, *, op: str = "max",
                     reverse: bool = False) -> torch.Tensor:
    """The plain version: torch.cummax / cummin along axis 1, on a flipped
    copy for a reverse scan."""
    _check(x, op)
    if x.numel() == 0:
        return x.clone()
    fn = torch.cummax if op == "max" else torch.cummin
    if reverse:
        return fn(x.flip(1), dim=1).values.flip(1)
    return fn(x, dim=1).values


def row_scan_i32(x: torch.Tensor, *, op: str = "max",
                 reverse: bool = False) -> torch.Tensor:
    """Row-wise inclusive cummax (op="max") or cummin (op="min") of a 2-D
    int32 tensor along axis 1; from the right when reverse."""
    _check(x, op)
    if not uses_kernel(x):
        return row_scan_i32_ref(x, op=op, reverse=reverse)
    rows, n = x.shape
    if n >= 2 ** 31 or rows > 65535:
        raise ValueError(f"shape {(rows, n)}: the kernel takes at most "
                         "65,535 rows of fewer than 2**31 columns")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        _launch(x, out, op, reverse)
        row_scan_i32.launches += 1
    return out


row_scan_i32.launches = 0   # kernel launches since the last reset
_tile = 0                   # the kernel's elements per tile, read at load


def _launch(x, out, op, reverse):
    """One call of ntrace_row_scan_i32 (its two passes) on the current CUDA
    stream."""
    global _tile
    from ntrace_tpu_torch.kernels.build import launch, library

    if not _tile:
        _tile = library().ntrace_row_scan_tile()
    rows, n = x.shape
    tiles = -(-n // _tile)
    agg = torch.empty((rows * tiles,), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launch("ntrace_row_scan_i32", x.data_ptr(), out.data_ptr(),
               agg.data_ptr(), agg.numel(), rows, n, int(op == "max"),
               int(reverse), stream)
