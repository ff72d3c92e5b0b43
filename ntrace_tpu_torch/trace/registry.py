"""Kernel registry and the port's traversal engines.

The name table is the port's copy of ntrace_tpu/trace/registry.py: the
reference selects a kernel by compilation-unit name (~
rt/cuda/CudaTracer.cpp loading rt/kernels/<name>.cu), and every name
resolves, ported or not (RenderConfig(engine=resolve_kernel(name).engine)).
packet_ww, packet_ifif, packet_wide and packet_pipe are the CUDA kernels
of the schedules their names stand for (csrc/packet_ww.cu, ...: Aila and
Laine's packet kernel); packet_bfs, packet_dleaf and packet_bdl are
NTrace's node-batch, deferred-leaf and combined packet kernels (on
csrc/packet_batch.cuh).

The engines (the reference renderer's engine resolution, renderer.py:
404-440 and 597-698): `engine_name` resolves a RenderConfig.engine to the
BVH engine that serves it, `bind` gives that engine with its tables (in
the engine's layout, packed from a FlatBVH, or as the direct LBVH route
built them), and `screen_engine` the screen-space engine of "binraster"
and "binraster_dense". The binary engines trace pick_layout's rows (bfs
and bdl one node a row, as the reference packs them, renderer.py:622-626,
with `batch_knobs`); packet_wide its own 8-ary tables at 4 triangles a row
with the conservative frustum test (exact=False; the reference's TPU
knobs have no counterpart); cpu_golden the FlatBVH on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ntrace_tpu_torch.host import (FlatBVH, RenderConfig, pack_bvh,
                                   pack_wide_bvh, trace_cpu_golden)
from ntrace_tpu_torch.host import pick_layout as _pick_layout
from ntrace_tpu_torch.tables import tables_from_packed, tables_from_wide
from ntrace_tpu_torch.trace import binraster as br
from ntrace_tpu_torch.trace import binraster_dense as bd
from ntrace_tpu_torch.trace.packet import trace_packet
from ntrace_tpu_torch.trace.packet_bdl import trace_packet_bdl
from ntrace_tpu_torch.trace.packet_bfs import trace_packet_bfs
from ntrace_tpu_torch.trace.packet_dleaf import trace_packet_dleaf
from ntrace_tpu_torch.trace.packet_ifif import trace_packet_ifif
from ntrace_tpu_torch.trace.packet_pipe import trace_packet_pipe
from ntrace_tpu_torch.trace.packet_wide import trace_packet_wide
from ntrace_tpu_torch.trace.packet_ww import trace_packet_ww


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


TABLE_TRACERS = {"packet": trace_packet, "packet_ww": trace_packet_ww,
                 "packet_ifif": trace_packet_ifif,
                 "packet_pipe": trace_packet_pipe,
                 "packet_bfs": trace_packet_bfs,
                 "packet_dleaf": trace_packet_dleaf,
                 "packet_bdl": trace_packet_bdl}
ONE_NODE_A_ROW = ("packet_bfs", "packet_bdl")
WIDE_TRIS_PER_ROW = 4
PACKET_ALIASES = ("auto", "wavefront", "packet")
# Canonical primary rays go to these, every other ray to the packet kernel.
SCREEN_ENGINES = ("binraster", "binraster_dense")
# The reference's other engines, and the ROADMAP item that ports each.
UNPORTED_ENGINES = {
    "stack": "queue 1, item 2: the stack2 engine",
    "stack2": "queue 1, item 2: the stack2 engine",
    "bvh8": "queue 1, item 10: other engines",
    "kdtree": "queue 1, item 10: other engines",
}


def engine_name(name: str) -> str:
    """The BVH engine that serves RenderConfig.engine `name`: "packet" for
    PACKET_ALIASES and the screen-space engines; NotImplementedError for
    one not ported yet, ValueError for an unknown one."""
    if name in PACKET_ALIASES or name in SCREEN_ENGINES:
        return "packet"
    if name in TABLE_TRACERS or name in ("packet_wide", "cpu_golden"):
        return name
    if name in UNPORTED_ENGINES:
        raise NotImplementedError(
            f"engine {name!r} is not ported yet (ROADMAP "
            f"{UNPORTED_ENGINES[name]})")
    raise ValueError(f"unknown engine {name!r}")


def batch_knobs(engine: str, cfg: RenderConfig) -> dict:
    """The node-batch and deferred-leaf engines' knobs, as the reference's
    `_packet_family_tracer` (renderer.py:90-139) passes them: packet rows
    from cfg.packet_rows, clamped as there (bfs at least 8, dleaf 8 to 32,
    bdl 8 to 64) and then to 32, the port's most warps a packet (a ray row
    is a warp here, a block holds 1,024 threads); drain_min 0 (one per
    queue); bdl's cfg.merge_sibs and cfg.qgroup, qgroup 1 where it does not
    divide the rows. Empty for every other engine."""
    rows = max(cfg.packet_rows, 8)
    if engine == "packet_bfs":
        return {"rows": min(rows, 32)}
    if engine == "packet_dleaf":
        return {"rows": min(rows, 32), "drain_min": 0}
    if engine == "packet_bdl":
        rows = min(rows, 64, 32)
        qgroup = cfg.qgroup if rows % cfg.qgroup == 0 else 1
        return {"rows": rows, "drain_min": 0, "qgroup": qgroup,
                "merge_sibs": bool(cfg.merge_sibs)}
    return {}


def pick_layout(flat: FlatBVH):
    """(n_refs, avg_leaf, tris_per_row, nodes_per_row) of a FlatBVH, as the
    reference renderer's `_layout_of` picks them."""
    n_refs = int((flat.tri_index >= 0).sum())
    enc = np.ascontiguousarray(flat.nodes[:, 12:14]).view(np.int32)
    avg_leaf = n_refs / max(int((enc < 0).sum()), 1)
    tpr, npr = _pick_layout(flat.nodes.shape[0], n_refs, avg_leaf=avg_leaf)
    return n_refs, avg_leaf, tpr, npr


def table_layout(engine: str, flat: FlatBVH) -> tuple[int, int]:
    """(tris_per_row, nodes_per_row) of a table engine's packed tables."""
    _, _, tpr, npr = pick_layout(flat)
    return tpr, 1 if engine in ONE_NODE_A_ROW else npr


def trace_golden(flat: FlatBVH, o, d, tn, tx, *, any_hit: bool, device):
    """The host golden tracer on device tensors, over the live rays
    (tmax > tmin) alone: a dead ray is not walked and keeps the kernels'
    miss record (tri -1, t = tmax, u = v = 0)."""
    o, d, tn, tx = (a.cpu().numpy() for a in (o, d, tn, tx))
    live = tx > tn
    rec = trace_cpu_golden(flat, o[live], d[live], tn[live], tx[live],
                           any_hit=any_hit)
    out = [np.full(tx.shape, -1, np.int32), tx.astype(np.float32),
           np.zeros(tx.shape, np.float32), np.zeros(tx.shape, np.float32)]
    for a, got in zip(out, (rec.tri, rec.t, rec.u, rec.v)):
        a[live] = got
    return tuple(torch.from_numpy(a).to(device) for a in out)


@dataclass
class Engine:
    """A BVH engine bound to its tables; `trace(o, d, tn, tx, any_hit)`
    reads `tables` at every call, so a rebuild swaps them in place.
    cpu_golden's tables are the FlatBVH."""
    name: str
    packed: object
    tables: object
    fn: Callable
    knobs: dict = field(default_factory=dict)

    def trace(self, o, d, tn, tx, any_hit):
        return self.fn(self.tables, o, d, tn, tx, any_hit=any_hit,
                       **self.knobs)


def bind(engine: str, cfg: RenderConfig, scene, flat: FlatBVH | None,
         device, built=None) -> Engine:
    """Engine `engine` (from engine_name) with its tables on `device`:
    `built` (packed, tables) from the direct LBVH route, else packed on the
    host from `flat` in the engine's layout and uploaded."""
    if engine == "cpu_golden":
        return Engine(engine, None, flat, trace_golden, {"device": device})
    if engine == "packet_wide":
        packed = pack_wide_bvh(flat, scene.tri_verts(),
                               tris_per_row=WIDE_TRIS_PER_ROW)
        return Engine(engine, packed, tables_from_wide(packed, device),
                      trace_packet_wide, {"exact": False})
    if built is None:
        tpr, npr = table_layout(engine, flat)
        packed = pack_bvh(flat, scene.tri_verts(), tris_per_row=tpr,
                          nodes_per_row=npr)
        built = packed, tables_from_packed(packed, device)
    return Engine(engine, *built, TABLE_TRACERS[engine],
                  batch_knobs(engine, cfg))


def screen_engine(name: str, scene, device, kernel: str = "walk"):
    """The screen-space engine of RenderConfig.engine `name` over the
    scene's triangles on `device` (`kernel`: the dense engine's); None
    for a BVH engine or a scene over br.MAX_TRIS triangles."""
    if name not in SCREEN_ENGINES:
        return None
    if kernel not in bd.KERNELS:
        raise ValueError(f"dense_kernel must be one of {bd.KERNELS}, not "
                         f"{kernel!r}")
    if scene.num_tris > br.MAX_TRIS:
        return None
    verts = torch.from_numpy(np.ascontiguousarray(
        scene.tri_verts(), dtype=np.float32)).to(device)
    if name == "binraster":
        return br.V1Engine(verts)
    return bd.DenseEngine(verts, kernel=kernel)
