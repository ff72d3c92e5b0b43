"""The port's own copy of the reference's jax-free host layers.

The tree under `host/` mirrors `ntrace_tpu/`: the counterpart of
`ntrace_tpu/bvh/flatten.py` is `ntrace_tpu_torch/host/bvh/flatten.py`. The
copies are numpy code, as in the reference, and differ from it only where
they must:
  - their imports point at the copies, so the port imports nothing of
    `ntrace_tpu`;
  - `ops/woop.py:is_leaf_end` and `trace/common.py:_bitcast_i32` keep only
    their numpy branch (the jax one raises TypeError);
  - `native/sbvh_lib.py` builds `native/sbvh.cpp` into the git-ignored
    `ntrace_tpu_torch/_build/`, under a per-process temporary name;
  - they read no environment setting: `bvh/sbvh.py` leaves out the
    reference's `NTRACE_NATIVE_SBVH` override and `NTRACE_VERBOSE` prints,
    and its docstrings drop the reference's accel cache.
The native binned-SAH builder is chosen at 50,000 triangles and above
whenever its library loads (`bvh/sbvh.py`), the reference's default rule,
so both packages build the same tree on the same machine. `tests/test_torch_host.py` holds the copies to the
originals: scenes, trees, packed tables and oracle results equal.

`ntrace_tpu.ray` and `ntrace_tpu.utils` load jax in their `__init__`, so
they are not copied here; the port has its own `ray/` and `utils/`.
"""

from ntrace_tpu_torch.host.bvh.flatten import FlatBVH, flatten_bvh
from ntrace_tpu_torch.host.bvh.golden import brute_force_anyhit, brute_force_mt
from ntrace_tpu_torch.host.bvh.median import build_median_bvh
from ntrace_tpu_torch.host.bvh.packed import (NODE_LANES, TRI_LANES,
                                              PackedBVH, pack_bvh,
                                              pick_layout)
from ntrace_tpu_torch.host.bvh.sbvh import build_sbvh
from ntrace_tpu_torch.host.bvh.wide_packed import WidePackedBVH, pack_wide_bvh
from ntrace_tpu_torch.host.core import BuildConfig, Camera, RenderConfig, Scene
from ntrace_tpu_torch.host.ops.morton import morton2d
from ntrace_tpu_torch.host.scenes import (default_camera, get_scene,
                                          make_random_soup)
from ntrace_tpu_torch.host.trace.cpu import (golden_mismatches,
                                             trace_cpu_golden)

__all__ = [
    "BuildConfig", "Camera", "FlatBVH", "NODE_LANES", "PackedBVH",
    "RenderConfig", "Scene", "TRI_LANES", "WidePackedBVH",
    "brute_force_anyhit", "brute_force_mt", "build_median_bvh", "build_sbvh",
    "default_camera", "flatten_bvh", "get_scene", "golden_mismatches",
    "make_random_soup", "morton2d", "pack_bvh", "pack_wide_bvh",
    "pick_layout", "trace_cpu_golden",
]
