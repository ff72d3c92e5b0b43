"""The least time the chip could take for a traversal batch.

Peaks: NVIDIA's H100 SXM data sheet at its full 700 W power limit, 3.35
TB/s of HBM and 67 TFLOP/s of FP32 outside the tensor cores. FP32
operations of one test, min, max and compares counted, a division as one:
a node visit is two slab tests of 12 subtracts and multiplies, 12 min/max
and a compare each (50); a Moller-Trumbore test of one ray and one
triangle slot is 51. Bytes: the rays read once (origin, direction, tmin,
tmax), (tri, t, u, v) written once, and each node record (64 B) and
triangle row (tris a row x 40 B) the traversal reads, once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
NODE_VISIT_OPS = 50
SLOT_TEST_OPS = 51
RAY_BYTES = 32          # orig, dirn (3 floats each), tmin, tmax
HIT_BYTES = 16          # tri, t, u, v
NODE_BYTES = 64         # 16 float lanes
SLOT_BYTES = 40         # 10 float lanes


def bound_s(n_rays: int, work: dict, tris_per_row: int,
            scale: float = 1.0) -> tuple[float, str]:
    """(seconds, "bytes" or "operations") for `n_rays` rays whose traversal
    does `work` (lib/count.py's count on a sample, its visits and tests
    multiplied by `scale`; what the sample read is counted as read, no
    more than the whole batch reads)."""
    ops = (work["node_visits"] * NODE_VISIT_OPS
           + work["slot_tests"] * SLOT_TEST_OPS) * scale
    nbytes = (n_rays * (RAY_BYTES + HIT_BYTES)
              + work["nodes_read"] * NODE_BYTES
              + work["rows_read"] * tris_per_row * SLOT_BYTES)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
