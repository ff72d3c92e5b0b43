"""Kernel registry: reference kernel names -> engines.

The port's copy of the name table of ntrace_tpu/trace/registry.py. The
reference selects a traversal kernel by compilation-unit name (~
rt/cuda/CudaTracer.cpp loading rt/kernels/<name>.cu); these names stay
aliases so reference benchmark scripts translate directly. Every name
resolves, whether or not its engine is ported; the port's Renderer takes
the resolved engine (RenderConfig(engine=resolve_kernel(name).engine)) and
raises NotImplementedError, naming the ROADMAP item, for an engine it does
not have yet. packet_ww and packet_ifif are the CUDA kernels of the
schedules their names stand for (csrc/packet_ww.cu, csrc/packet_ifif.cu).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class KernelSpec:
    engine: str


_REGISTRY = {name: KernelSpec(engine) for name, engine in {
    # Reference kernel names (aliases for script compatibility):
    "tesla_persistent_while_while": "packet_ww",
    "tesla_persistent_packet": "packet_wide",
    "tesla_persistent_speculative_while_while": "packet_ifif",
    "fermi_speculative_while_while": "packet",
    "kepler_dynamic_fetch": "packet",
    "fermi_kdtree_while_while": "auto",
    # Native names:
    "stack": "stack",
    "stack2": "stack2",
    "bvh8": "bvh8",
    "kdtree": "kdtree",
    "packet": "packet",
    "packet_ifif": "packet_ifif",
    "packet_ww": "packet_ww",
    "packet_pipe": "packet_pipe",
    "packet_wide": "packet_wide",
    "packet_bfs": "packet_bfs",
    "packet_dleaf": "packet_dleaf",
    "packet_bdl": "packet_bdl",
    "wavefront": "wavefront",
    "cpu_golden": "cpu_golden",
    "auto": "auto",
}.items()}


def resolve_kernel(name: str) -> KernelSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown kernel {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def kernel_names() -> list[str]:
    return sorted(_REGISTRY)
