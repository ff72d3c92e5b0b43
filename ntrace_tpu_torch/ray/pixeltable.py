"""Morton-order pixel permutation (counterpart of ntrace_tpu/ray/pixeltable.py).

Numpy, like the reference; it lives in the port only because importing
`ntrace_tpu.ray` loads jax. Consecutive ray slots are screen-coherent.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ntrace_tpu_torch.host import morton2d


@lru_cache(maxsize=8)
def pixel_table(width: int, height: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (index_to_pixel, pixel_to_index), both (W*H,) int32, read-only.

    index_to_pixel[i] = linear pixel id (y*W + x) of ray slot i, ordered by
    the 2D Morton code of (x, y); pixel_to_index is the inverse permutation.
    """
    x = np.arange(width, dtype=np.int64)
    y = np.arange(height, dtype=np.int64)
    xx, yy = np.meshgrid(x, y)  # (H, W)
    codes = morton2d(np, xx.ravel(), yy.ravel())
    order = np.argsort(codes, kind="stable").astype(np.int32)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.shape[0], dtype=np.int32)
    order.setflags(write=False)
    inv.setflags(write=False)
    return order, inv
