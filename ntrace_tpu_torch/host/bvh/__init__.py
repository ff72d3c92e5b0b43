from ntrace_tpu_torch.host.bvh.host_bvh import HostBVH  # noqa: F401
from ntrace_tpu_torch.host.bvh.flatten import FlatBVH, flatten_bvh  # noqa: F401
from ntrace_tpu_torch.host.bvh.median import build_median_bvh  # noqa: F401
