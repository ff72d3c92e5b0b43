from ntrace_tpu_torch.host.trace.common import SENTINEL, TraceState  # noqa: F401
from ntrace_tpu_torch.host.trace.cpu import trace_cpu_golden  # noqa: F401
