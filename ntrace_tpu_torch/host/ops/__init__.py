"""Numeric building blocks shared by builders, engines, and the golden tracer.

Every intersection/test op is generated from ONE formulation parameterized by
the array namespace (numpy | jax.numpy), so the CPU golden tracer and the TPU
engines execute the identical operation order -- the precondition for the
image-exact acceptance gate (SURVEY.md SS8 hard part #5).
"""

from ntrace_tpu_torch.host.ops import aabb, intersect, morton, woop  # noqa: F401
