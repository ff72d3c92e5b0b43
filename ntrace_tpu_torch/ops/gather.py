"""Exact row gather from a table split into int8 byte planes.

Counterpart of ntrace_tpu/ops/gather.py: `split_table_bytes` (38),
`paged_gather_bytes` (70, its pallas_call at 119 runs `_gather_kernel`, 45)
and `GatherTable` (132). The reference is the "texture fetch" of NTrace's
CUDA tracer (its fetch macros) rebuilt for a TPU: it sorts the requests by
page of the table and rebuilds each row with int8 one-hot matmuls over four
byte planes, which gives table[idx] bit for bit. On the TPU (a v5e) it took
about 111 ms per 1M rows against about 8 ms for XLA's own gather, and it
was kept as a recorded negative result; no engine calls it.

The port keeps the names and the contracts: the table is split once into
planes [b0 | b1 | b2 | b3], `paged_gather_bytes` returns the original
table[idx] bit for bit, Q must be a multiple of `tile`, and `GatherTable`
pads the table to a multiple of `page` and the indices to a multiple of
`tile`. The sort by page, the tile placement and the one-hot matmul are
the TPU's schedule and are not carried over; `page` and `tile` remain
only as the padding contract.

A CUDA tensor goes through the hand-written kernel (csrc/gather.cu, one
thread per output word); a CPU tensor goes through the plain version
`paged_gather_bytes_ref`. Nothing falls back from one to the other: a
failed build or launch raises. Both clamp an index outside [0, Np) for the
read, where the reference leaves the result unspecified.
"""

from __future__ import annotations

import torch

from ntrace_tpu_torch.device import uses_kernel


def split_table_bytes(table: torch.Tensor) -> torch.Tensor:
    """(N, C) f32 -> (N, 4C) int8 byte planes [b0 | b1 | b2 | b3], the
    little-endian bytes of each word."""
    if table.dim() != 2 or table.dtype != torch.float32:
        raise ValueError(f"split_table_bytes takes (N, C) float32, got "
                         f"{tuple(table.shape)} {table.dtype}")
    bits = table.contiguous().view(torch.int32)
    planes = []
    for k in range(4):
        b = (bits >> (8 * k)) & 0xFF
        planes.append(torch.where(b >= 128, b - 256, b).to(torch.int8))
    return torch.cat(planes, dim=1)


def _check(table_bytes: torch.Tensor, idx: torch.Tensor, c: int, tile: int):
    if table_bytes.dim() != 2 or table_bytes.dtype != torch.int8 \
            or table_bytes.shape[1] != 4 * c or table_bytes.shape[0] < 1:
        raise ValueError(f"table_bytes must be (Np, {4 * c}) int8, got "
                         f"{tuple(table_bytes.shape)} {table_bytes.dtype}")
    if idx.dim() != 1 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be (Q,) int32, got {tuple(idx.shape)} "
                         f"{idx.dtype}")
    if idx.device != table_bytes.device:
        raise ValueError("table_bytes and idx lie on different devices")
    if idx.shape[0] % tile:
        raise ValueError(f"pad idx to a multiple of tile={tile} (Q = "
                         f"{idx.shape[0]})")


def paged_gather_bytes_ref(table_bytes: torch.Tensor, idx: torch.Tensor, *,
                           n_rows: int, c: int, page: int = 512,
                           tile: int = 1024) -> torch.Tensor:
    """The plain version: index the planes, then reassemble each word from
    its four bytes with & 0xFF and shifts, and view it as f32. Takes
    paged_gather_bytes's arguments; `n_rows` and `page` are not read."""
    _check(table_bytes, idx, c, tile)
    r = idx.clamp(0, table_bytes.shape[0] - 1).long()
    b = table_bytes[r].to(torch.int32) & 0xFF
    bits = (b[:, :c] | (b[:, c:2 * c] << 8) | (b[:, 2 * c:3 * c] << 16)
            | (b[:, 3 * c:] << 24))
    return bits.contiguous().view(torch.float32)


def paged_gather_bytes(table_bytes: torch.Tensor, idx: torch.Tensor, *,
                       n_rows: int, c: int, page: int = 512,
                       tile: int = 1024) -> torch.Tensor:
    """table_bytes (Np, 4C) int8 (split, padded to a multiple of page), idx
    (Q,) int32 in [0, n_rows) -> (Q, C) f32 equal to the original
    table[idx] bit for bit. Q must be a multiple of tile. `n_rows` and
    `page` keep the reference's signature and are not read: the kernel
    needs no page layout and clamps each index to the table."""
    _check(table_bytes, idx, c, tile)
    if not uses_kernel(table_bytes):
        return paged_gather_bytes_ref(table_bytes, idx, n_rows=n_rows, c=c,
                                      page=page, tile=tile)
    table_bytes = table_bytes.contiguous()
    idx = idx.contiguous()
    out = torch.empty((idx.shape[0], c), dtype=torch.float32,
                      device=idx.device)
    _launch(table_bytes, idx, out, c)
    paged_gather_bytes.launches += 1
    return out


paged_gather_bytes.launches = 0   # kernel launches since the last reset


def _launch(table_bytes, idx, out, c):
    """One call of ntrace_gather_bytes on the current CUDA stream."""
    from ntrace_tpu_torch.kernels.build import launch

    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream(idx.device).cuda_stream
        launch("ntrace_gather_bytes", table_bytes.data_ptr(), idx.data_ptr(),
               out.data_ptr(), idx.shape[0], c, table_bytes.shape[0], stream)


class GatherTable:
    """A table split once into byte planes on `device`; gather many times."""

    def __init__(self, table, page: int = 512, tile: int = 1024, *,
                 device="cuda"):
        table = torch.as_tensor(table, dtype=torch.float32, device=device)
        self.n_rows, self.c = int(table.shape[0]), int(table.shape[1])
        self.page = page
        self.tile = tile
        n_pages = -(-self.n_rows // page)
        padded = torch.zeros((n_pages * page, self.c), dtype=torch.float32,
                             device=table.device)
        padded[:self.n_rows] = table
        self.bytes = split_table_bytes(padded)

    def __call__(self, idx: torch.Tensor) -> torch.Tensor:
        idx = torch.as_tensor(idx, dtype=torch.int32,
                              device=self.bytes.device)
        q = idx.shape[0]
        qp = -(-q // self.tile) * self.tile
        if qp != q:
            idx = torch.cat([idx, idx.new_zeros((qp - q,))])
        out = paged_gather_bytes(self.bytes, idx, n_rows=self.n_rows,
                                 c=self.c, page=self.page, tile=self.tile)
        return out[:q]
