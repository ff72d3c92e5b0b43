"""ntrace_tpu_torch: the PyTorch/CUDA port of ntrace_tpu for NVIDIA Hopper.

`ntrace_tpu` (JAX/Pallas, TPU) stays the reference; this package computes
the same results with torch and hand-written CUDA kernels, and imports
neither jax nor anything of `ntrace_tpu`. It keeps its own copies of the
reference's jax-free host layers (core, scenes, the host BVH builders and
packer, the CPU oracles) under `host/`, a tree that mirrors `ntrace_tpu/`,
so both packages build identical trees and tables.

Layer map:
  host/                the port's copies of the reference's host layers
  render/renderer.py   build_accel, Renderer.render(mode="primary")
  ray/                 pixel table, RayBatch, camera_arrays, primary rays
  bvh/lbvh.py          the device LBVH build (packed and flat emission)
  ops/                 Morton codes, clz, the row scan (ops/pscan.py)
  tables.py            packed BVH tables on the device
  trace/packet.py      trace_packet: CUDA kernel on a CUDA device, torch
                       twin (trace_packet_ref) on the CPU
  trace/binraster*.py  the dense screen-space primary engine
  csrc/*.cu            hand-written CUDA kernels (sm_90a)
  kernels/build.py     nvcc build into _build/ + ctypes binding
  device.py            device policy, describe()
  utils/timing.py      stage timer, CUDA-event timing
"""

__version__ = "0.1.0"
