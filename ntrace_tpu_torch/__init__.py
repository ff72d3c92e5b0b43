"""ntrace_tpu_torch: the PyTorch/CUDA port of ntrace_tpu for NVIDIA Hopper.

`ntrace_tpu` (JAX/Pallas, TPU) stays the reference; this package computes
the same results with torch and hand-written CUDA kernels, and imports no
jax. It shares the reference's jax-free host layers (core, scenes, the BVH
builders and packer, the CPU golden tracer, ops.morton) instead of copying
them, so both packages build identical trees and tables; `host.py` is the
one module that imports them.

Layer map (primary-frame slice):
  host.py              the shared host layers of ntrace_tpu
  render/renderer.py   build_accel, Renderer.render(mode="primary")
  ray/                 pixel table, RayBatch, camera_arrays, primary rays
  tables.py            packed BVH tables on the device
  trace/packet.py      trace_packet: CUDA kernel on a CUDA device, torch
                       twin (trace_packet_ref) on the CPU
  csrc/*.cu            hand-written CUDA kernels (sm_90a)
  kernels/build.py     nvcc build into _build/ + ctypes binding
  device.py            device policy, describe()
  utils/timing.py      stage timer, CUDA-event timing
"""

__version__ = "0.1.0"
