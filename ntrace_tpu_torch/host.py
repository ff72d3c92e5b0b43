"""The reference's jax-free host layers, shared rather than copied.

This is the one module through which the port, and `chip_smoke.py`, reach
into `ntrace_tpu`: the scene and camera types, the procedural scenes, the
host BVH builders and packer, and the CPU oracles (`brute_force_mt`,
`trace_cpu_golden`). Each of these modules is pure numpy and loads no jax
when imported; `tests/test_torch_import.py` holds them to that. Sharing
them means the JAX reference and the port trace the very same trees and
packed tables.

`ntrace_tpu.ray` and `ntrace_tpu.utils` load jax in their `__init__`, so
nothing here comes from them; the port has its own `ray/` and `utils/`.
"""

from ntrace_tpu.bvh.flatten import FlatBVH, flatten_bvh
from ntrace_tpu.bvh.golden import brute_force_anyhit, brute_force_mt
from ntrace_tpu.bvh.median import build_median_bvh
from ntrace_tpu.bvh.packed import (NODE_LANES, TRI_LANES, PackedBVH,
                                   pack_bvh, pick_layout)
from ntrace_tpu.bvh.sbvh import build_sbvh
from ntrace_tpu.core import BuildConfig, Camera, RenderConfig, Scene
from ntrace_tpu.ops.morton import morton2d
from ntrace_tpu.scenes import default_camera, get_scene, make_random_soup
from ntrace_tpu.trace.cpu import golden_mismatches, trace_cpu_golden

__all__ = [
    "BuildConfig", "Camera", "FlatBVH", "NODE_LANES", "PackedBVH",
    "RenderConfig", "Scene", "TRI_LANES", "brute_force_anyhit",
    "brute_force_mt", "build_median_bvh", "build_sbvh", "default_camera",
    "flatten_bvh", "get_scene", "golden_mismatches", "make_random_soup",
    "morton2d", "pack_bvh", "pick_layout", "trace_cpu_golden",
]
