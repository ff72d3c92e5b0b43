"""Per-frame orchestration for primary rays: build -> raygen -> trace -> shade.

Counterpart of the primary-frame slice of ntrace_tpu/render/renderer.py:
`build_accel` (165-197), `normal_color` (200-210), `_trace_batched`
(337-364), the engine resolution of `Renderer.__init__` (440-515, 597-664,
689-698), `trace_primary` (1136-1188, the seed_primary="off" path),
`_cap` (1203-1208) and `render(mode="primary")` (1256-1394).

Every engine name that resolves to the packet BVH kernel ("auto",
"wavefront", "packet") traces through `trace/packet.py`: the CUDA kernel on
a CUDA device, its torch twin on the CPU. "cpu_golden" runs the host golden
tracer. The port reads no tuned.json (its entries were measured on a TPU)
and keeps one packed table on the device: there is no forest. Other modes,
engines, builders and seed_primary settings raise NotImplementedError and
name the ROADMAP item that ports them.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from ntrace_tpu_torch.host import (BuildConfig, Camera, FlatBVH, RenderConfig,
                                   Scene, build_median_bvh, build_sbvh,
                                   flatten_bvh, pack_bvh, trace_cpu_golden)
from ntrace_tpu_torch.host import pick_layout as _pick_layout
from ntrace_tpu_torch.ray import raygen
from ntrace_tpu_torch.ray.pixeltable import pixel_table
from ntrace_tpu_torch.ray.raybatch import RayBatch, unsort
from ntrace_tpu_torch.tables import tables_from_packed
from ntrace_tpu_torch.trace.packet import trace_packet
from ntrace_tpu_torch.utils.timing import StageTimer

PACKET_ENGINES = ("auto", "wavefront", "packet")


@dataclass
class RenderResult:
    image: np.ndarray        # (H, W, 3) float32 linear
    hit_tri: np.ndarray      # (H*W,) int32 primary hits (pixel order)
    hit_t: np.ndarray        # (H*W,) float32
    stats: dict = field(default_factory=dict)


def build_accel(scene: Scene, cfg: BuildConfig = BuildConfig()) -> FlatBVH:
    """Host BVH build with the reference's builders; no accel cache."""
    if cfg.builder in ("median", "golden"):
        return flatten_bvh(build_median_bvh(scene, cfg), scene)
    if cfg.builder in ("sbvh", "binned_sah"):
        return flatten_bvh(build_sbvh(scene, cfg), scene)
    if cfg.builder in ("lbvh", "hlbvh"):
        raise NotImplementedError(
            f"builder {cfg.builder!r} is not ported yet (ROADMAP queue 1, "
            "item 9: device builders)")
    if cfg.builder == "kdtree":
        raise NotImplementedError(
            "builder 'kdtree' is not ported yet (ROADMAP queue 1, item 10: "
            "other engines)")
    raise ValueError(f"unknown builder {cfg.builder!r}")


def pick_layout(flat: FlatBVH):
    """(n_refs, avg_leaf, tris_per_row, nodes_per_row) of a FlatBVH, as the
    reference renderer's `_layout_of` picks them."""
    n_refs = int((flat.tri_index >= 0).sum())
    enc = np.ascontiguousarray(flat.nodes[:, 12:14]).view(np.int32)
    avg_leaf = n_refs / max(int((enc < 0).sum()), 1)
    tpr, npr = _pick_layout(flat.nodes.shape[0], n_refs, avg_leaf=avg_leaf)
    return n_refs, avg_leaf, tpr, npr


def normal_color(geom_normals: torch.Tensor, hit_tri: torch.Tensor):
    """|unit geometric normal| debug shading; black on miss."""
    gn = geom_normals[hit_tri.clamp(min=0).long()]
    gn = gn / (raygen.norm3(gn) + 1e-30)
    return torch.where(hit_tri[:, None] >= 0, gn.abs(),
                       torch.zeros_like(gn))


def _trace_batched(tracer, batch: RayBatch, cap: int, any_hit: bool):
    """Loop the tracer over <= cap-ray chunks (the in-flight ray cap).

    A CUDA out-of-memory error retries with a halved cap down to a 4k
    floor; every other error propagates.
    """
    n = batch.num_rays
    while True:
        try:
            if n <= cap:
                return tracer(batch.orig, batch.dirn, batch.tmin, batch.tmax,
                              any_hit)
            outs = [tracer(batch.orig[s:s + cap], batch.dirn[s:s + cap],
                           batch.tmin[s:s + cap], batch.tmax[s:s + cap],
                           any_hit)
                    for s in range(0, n, cap)]
            return tuple(torch.cat([o[i] for o in outs]) for i in range(4))
        except torch.cuda.OutOfMemoryError:
            if cap <= 4096:
                raise
            cap //= 2
            print(f"[renderer] device OOM; retrying with ray cap {cap}",
                  file=sys.stderr)


class Renderer:
    def __init__(self, scene: Scene, build_cfg: BuildConfig = BuildConfig(),
                 cfg: RenderConfig = RenderConfig(),
                 flat: FlatBVH | None = None, *, device):
        self.scene = scene
        self.cfg = cfg
        self.device = torch.device(device)
        if cfg.seed_primary != "off":
            raise NotImplementedError(
                f"seed_primary={cfg.seed_primary!r} is not ported yet "
                "(ROADMAP queue 1, item 6: the seeded primary trace)")
        if cfg.engine in PACKET_ENGINES:
            self.engine = "packet"
        elif cfg.engine == "cpu_golden":
            self.engine = "cpu_golden"
        elif cfg.engine in ("binraster", "binraster_dense"):
            raise NotImplementedError(
                f"engine {cfg.engine!r} is not ported yet (ROADMAP queue 1, "
                "item 7: the dense primary engine)")
        else:
            raise NotImplementedError(
                f"engine {cfg.engine!r} is not ported yet (ROADMAP queue 1, "
                "items 2, 10, 11)")
        self.flat = flat if flat is not None else build_accel(
            scene, build_cfg)
        if self.engine == "packet":
            _, _, tpr, npr = pick_layout(self.flat)
            self.packed = pack_bvh(self.flat, scene.tri_verts(),
                                   tris_per_row=tpr, nodes_per_row=npr)
            self.tables = tables_from_packed(self.packed, self.device)

            def tracer(o, d, tn, tx, any_hit):
                return trace_packet(self.tables, o, d, tn, tx,
                                    any_hit=any_hit)
        else:
            def tracer(o, d, tn, tx, any_hit):
                rec = trace_cpu_golden(
                    self.flat, o.cpu().numpy(), d.cpu().numpy(),
                    tn.cpu().numpy(), tx.cpu().numpy(), any_hit=any_hit)
                return tuple(torch.from_numpy(a).to(self.device)
                             for a in (rec.tri, rec.t, rec.u, rec.v))
        self._tracer = tracer
        self.geom_normals = torch.from_numpy(
            scene.geometric_normals()).to(self.device)

    def trace_primary(self, orig, dirn, tmin, tmax):
        """Primary-ray closest-hit trace (the seed_primary="off" path)."""
        return _trace_batched(self._tracer, RayBatch(orig, dirn, tmin, tmax),
                              self._cap(), False)

    def _cap(self) -> int:
        """Per-dispatch ray cap."""
        return max(self.cfg.max_batch_rays, 1 << 22)

    def render(self, camera: Camera, mode: str | None = None) -> RenderResult:
        mode = mode or self.cfg.mode
        if mode != "primary":
            raise NotImplementedError(
                f"mode {mode!r} is not ported yet (ROADMAP queue 1, item 8: "
                "secondary modes)")
        W, H = self.cfg.width, self.cfg.height
        timer = StageTimer(self.device)
        order, _ = pixel_table(W, H)
        cam = raygen.camera_arrays(camera, W, H, self.device)
        with timer.stage("raygen"):
            batch = raygen.primary(
                cam, W, H, torch.from_numpy(order.copy()).to(self.device))
        with timer.stage("trace_primary"):
            tri, t, _, _ = self.trace_primary(batch.orig, batch.dirn,
                                              batch.tmin, batch.tmax)
        timer.count("rays_primary", batch.num_rays)
        with timer.stage("shade"):
            color = normal_color(self.geom_normals, tri)
            fb = torch.zeros((W * H, 3), dtype=torch.float32,
                             device=self.device)
            fb[batch.slot_to_id.long()] = color
            img = fb.cpu().numpy().reshape(H, W, 3)
        with timer.stage("readback"):
            hit_tri = unsort(tri, batch.slot_to_id).cpu().numpy()
            hit_t = unsort(t, batch.slot_to_id).cpu().numpy()
        stats = timer.ms()
        if stats.get("trace_primary", 0) > 0:
            # Mrays/s of the primary pass (trace stage wall time).
            stats["mrays_primary"] = (stats["rays_primary"] / 1e6
                                      / (stats["trace_primary"] / 1e3))
        return RenderResult(image=img, hit_tri=hit_tri, hit_t=hit_t,
                            stats=stats)
