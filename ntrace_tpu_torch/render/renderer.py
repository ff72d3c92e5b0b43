"""Per-frame orchestration: build -> raygen -> trace -> secondary -> shade.

Counterpart of ntrace_tpu/render/renderer.py: `build_accel` (165-197),
`normal_color` (200-210), `shadow_mix` (213), `_trace_batched`
(337-364), `_compact_trace` (367-401), the engine resolution of
`Renderer.__init__` (404-440, 597-698) with the packed-direct LBVH path
(404-433, 613-619) and the scene state (725-736), `trace_primary`
(1136-1188, the seed_primary="off" path), `_cap` (1203-1208),
`_unit_normals` (1212), `gen_secondary` (1221-1254), `render` (1256-1394)
for the modes primary, shadow, ao, diffuse and path, `_default_light`
(1396-1402), the plain-tracer branch of `_secondary_tracer` (1448-1492)
and `_path_trace` (1494-1548); and the dense screen-space primary engine:
`prepare_primary` (924-930, 966-1027), `_dense_prep`,
`freeze_primary_structure`, `_trace_binraster_dense` (1029-1109) and
`_binraster_contract_ok` (1190-1201).

Engines. "auto", "wavefront" and "packet" trace through
`trace/packet.py`; "packet_ww" and "packet_ifif" through
`trace/packet_ww.py` and `trace/packet_ifif.py` (the registry's
tesla_persistent_while_while and tesla_persistent_speculative_while_while,
`trace/registry.py`); each runs its CUDA kernel on a CUDA device and its
torch twin on the CPU, over one packed table on the device (no forest).
"cpu_golden" runs the host golden tracer. engine="binraster_dense" arms
the dense engine (`trace/binraster_dense.py`) for canonical primary frames
and keeps the packet kernel for every other ray. The port reads no
tuned.json (its entries were measured on a TPU): the dense engine's
settings are the reference renderer's code defaults (the DENSE_*
constants), "auto" means the packet kernel alone, and seed_secondary and
stage_secondary "auto" mean off. builder="lbvh" with engine "auto" or
"packet" and no `flat` takes the packed-direct path on every device: the
tables are built on the renderer's device (bvh/lbvh.py:build_lbvh_packed)
and traced in place, and `self.flat` is None; with packet_ww or
packet_ifif it takes the flat route (build_lbvh_flat, then the host pack),
as the reference does. Secondary rays draw their random numbers from
`ray/rng.py`, bit-equal to the reference's jax.random. Other modes,
engines, builders and options raise NotImplementedError and name the
ROADMAP item that ports them.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ntrace_tpu_torch.bvh.lbvh import build_lbvh_flat, build_lbvh_packed
from ntrace_tpu_torch.host import (BuildConfig, Camera, FlatBVH, RenderConfig,
                                   Scene, build_median_bvh, build_sbvh,
                                   flatten_bvh, pack_bvh, trace_cpu_golden)
from ntrace_tpu_torch.host import pick_layout as _pick_layout
from ntrace_tpu_torch.ray import raygen, rng
from ntrace_tpu_torch.ray.pixeltable import pixel_table
from ntrace_tpu_torch.ray.raybatch import RayBatch, morton_sort_rays, unsort
from ntrace_tpu_torch.tables import tables_from_device, tables_from_packed
from ntrace_tpu_torch.trace import binraster_dense as bd
from ntrace_tpu_torch.trace.packet import trace_packet
from ntrace_tpu_torch.trace.packet_ifif import trace_packet_ifif
from ntrace_tpu_torch.trace.packet_ww import trace_packet_ww
from ntrace_tpu_torch.utils.timing import StageTimer

PACKET_ENGINES = ("auto", "wavefront", "packet")
# Engines that trace the packed tables, by the name the renderer keeps.
TABLE_TRACERS = {"packet": trace_packet, "packet_ww": trace_packet_ww,
                 "packet_ifif": trace_packet_ifif}
# The reference's other engines, and the ROADMAP item that ports each.
UNPORTED_ENGINES = {
    "stack": "queue 1, item 2: the stack2 engine",
    "stack2": "queue 1, item 2: the stack2 engine",
    "bvh8": "queue 1, item 10: other engines",
    "kdtree": "queue 1, item 10: other engines",
    "binraster": "queue 2: the v1 screen-space engine, binraster_prep_fast "
                 "and its kernel",
    **{e: "queue 2: the rest of the packet family"
       for e in ("packet_pipe", "packet_wide", "packet_bfs", "packet_dleaf",
                 "packet_bdl")},
}
MODES = ("primary", "shadow", "ao", "diffuse", "path")
# The dense engine's settings: the reference renderer's code defaults for
# what it reads from tuned.json (br2_tile, br2_kcap, br2_ez,
# br2_max_pairs). The prep is always v5.
DENSE_TILE = 16              # bin edge in pixels
DENSE_K_CAP = 64             # a triangle over more bins: the global tier
DENSE_EZ_CHUNK = 0           # early-z off
DENSE_MAX_PAIRS = 2_000_000  # pair budget; above it the BVH path serves
# Scenes above this many triangles never arm the dense engine (the
# reference's NTRACE_BINRASTER_MAX_TRIS default): its sorts and tables
# scale with them.
DENSE_MAX_TRIS = 3_000_000


@dataclass
class RenderResult:
    image: np.ndarray        # (H, W, 3) float32 linear
    hit_tri: np.ndarray      # (H*W,) int32 primary hits (pixel order)
    hit_t: np.ndarray        # (H*W,) float32
    stats: dict = field(default_factory=dict)


def build_accel(scene: Scene, cfg: BuildConfig = BuildConfig(), *,
                device="cuda") -> FlatBVH:
    """BVH build with the reference's builders; no accel cache. The host
    builders ignore `device`; "lbvh" builds on it and returns a host
    FlatBVH."""
    if cfg.builder in ("median", "golden"):
        return flatten_bvh(build_median_bvh(scene, cfg), scene)
    if cfg.builder in ("sbvh", "binned_sah"):
        return flatten_bvh(build_sbvh(scene, cfg), scene)
    if cfg.builder == "lbvh":
        return build_lbvh_flat(scene, cfg, device=device)
    if cfg.builder == "hlbvh":
        raise NotImplementedError(
            "builder 'hlbvh' is not ported yet (ROADMAP queue 1, item 9: "
            "HLBVH, lbvh_device and build_hlbvh_flat)")
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


def shadow_mix(base_col: torch.Tensor, lit: torch.Tensor) -> torch.Tensor:
    """The reference's shadow-mode mix: 25% ambient + 75% direct."""
    return base_col * (0.25 + 0.75 * lit)[:, None]


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


def _compact_trace(tracer, batch: RayBatch, cap: int, any_hit: bool,
                   compact: str = "auto"):
    """Trace only the live prefix of a batch whose dead rays are at the end
    (after morton_sort_rays); the rest get the miss sentinel tri -1, t 0,
    u 0, v 0.

    The reference pads the prefix to a power of two to bound XLA
    recompiles; the port traces the slots up to the last live ray, which
    gives identical results (a dead ray traced is the same sentinel: its
    tmax is 0). compact: "on", "off", or "auto" (when at most 3/4 of the
    rays are live).
    """
    if compact not in ("on", "off", "auto"):
        raise ValueError(f"compact_rays must be on, off or auto, not "
                         f"{compact!r}")
    n = batch.num_rays
    if compact != "off" and n > 8192:
        live_mask = batch.tmax > batch.tmin
        slots = torch.arange(n, device=live_mask.device)
        live, last = torch.stack([live_mask.sum(), torch.where(
            live_mask, slots, -1).max()]).tolist()
        # Dead rays sort last, but a live ray may share their key, so the
        # prefix runs through the last live slot.
        prefix = last + 1
        if prefix < n and (compact == "on" or live <= (3 * n) // 4):
            sub = RayBatch(batch.orig[:prefix], batch.dirn[:prefix],
                           batch.tmin[:prefix], batch.tmax[:prefix])
            tri, t, u, v = _trace_batched(tracer, sub, cap, any_hit)
            pad = n - prefix
            return (torch.cat([tri, tri.new_full((pad,), -1)]),
                    *(torch.cat([a, a.new_zeros((pad,))]) for a in (t, u, v)))
    return _trace_batched(tracer, batch, cap, any_hit)


class Renderer:
    def __init__(self, scene: Scene, build_cfg: BuildConfig = BuildConfig(),
                 cfg: RenderConfig = RenderConfig(),
                 flat: FlatBVH | None = None, *, device,
                 dense_kernel: str = "walk"):
        """dense_kernel: "walk" or "dma", the dense engine's kernel (the
        reference's br2_kernel); both give bit-identical frames."""
        self.scene = scene
        self.cfg = cfg
        self.device = torch.device(device)
        self.dense_kernel = dense_kernel
        if cfg.seed_primary != "off":
            raise NotImplementedError(
                f"seed_primary={cfg.seed_primary!r} is not ported yet "
                "(ROADMAP queue 1, item 6: the seeded primary trace)")
        # The screen-space engine serves canonical primary rays only; the
        # main engine, the packet kernel, serves everything else.
        self.primary_engine = None
        self._br = None                   # armed by prepare_primary()
        engine = cfg.engine
        if engine == "binraster_dense":
            if dense_kernel not in bd.KERNELS:
                raise NotImplementedError(
                    f"dense kernel {dense_kernel!r} is not ported yet "
                    "(ROADMAP queue 2, item 12: the visit-list kernel)")
            self.primary_engine = engine
            engine = "auto"
        if engine in PACKET_ENGINES:
            self.engine = "packet"
        elif engine in TABLE_TRACERS or engine == "cpu_golden":
            self.engine = engine
        elif engine in UNPORTED_ENGINES:
            raise NotImplementedError(
                f"engine {engine!r} is not ported yet (ROADMAP "
                f"{UNPORTED_ENGINES[engine]})")
        else:
            raise ValueError(f"unknown engine {engine!r}")
        # Packed-direct: builder="lbvh" builds the packet kernel's tables
        # on the device (the reference's path on its accelerator).
        self.timer = StageTimer(self.device)
        direct = (flat is None and cfg.engine in ("auto", "packet")
                  and build_cfg.builder == "lbvh")
        with self.timer.stage("build"):
            if direct:
                self.flat = None
                self.packed = build_lbvh_packed(
                    scene, build_cfg, tris_per_row=12, nodes_per_row=1,
                    device=self.device)
                p = self.packed
                self.tables = tables_from_device(
                    p.nodes8, p.tris12, p.num_nodes, p.nodes_per_row,
                    p.tris_per_row)
            else:
                self.flat = flat if flat is not None else build_accel(
                    scene, build_cfg, device=self.device)
        if self.engine in TABLE_TRACERS:
            if not direct:
                _, _, tpr, npr = pick_layout(self.flat)
                self.packed = pack_bvh(self.flat, scene.tri_verts(),
                                       tris_per_row=tpr, nodes_per_row=npr)
                self.tables = tables_from_packed(self.packed, self.device)
            trace = TABLE_TRACERS[self.engine]

            def tracer(o, d, tn, tx, any_hit):
                return trace(self.tables, o, d, tn, tx, any_hit=any_hit)
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
        # Scene state of the secondary passes.
        def dev(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
                self.device)

        self.mat_diffuse = dev([m.diffuse for m in scene.materials])
        self.mat_emissive = dev([m.emissive for m in scene.materials])
        self.mat_ids = dev(scene.mat_ids, np.int64)
        self._bbox = lo, hi = scene.bbox()
        self.scene_lo, self.scene_hi = dev(lo), dev(hi)
        self.scene_scale = float(np.linalg.norm(hi - lo))
        self.eps = float(np.float32(self.scene_scale * 1e-4))
        if self.primary_engine is not None:
            if scene.num_tris > DENSE_MAX_TRIS:
                self.primary_engine = None   # sorts and tables blow up
            else:
                self._br_verts = torch.from_numpy(
                    np.ascontiguousarray(scene.tri_verts(),
                                         dtype=np.float32)).to(self.device)

    def prepare_primary(self, cam: dict, width: int, height: int) -> bool:
        """Arm the dense engine for (cam, W, H): one count pass picks the
        static sizes. Returns True when armed; False leaves the frame to
        the BVH path (no dense engine, a frame that does not tile, or a
        pair budget the camera would exceed)."""
        self._br = None
        if self.primary_engine != "binraster_dense":
            return False
        if width % DENSE_TILE or height % DENSE_TILE:
            return False
        txn, tyn = width // DENSE_TILE, height // DENSE_TILE
        try:
            mcodes = bd.bin_mcodes(txn, tyn, 31 - bd.Z_BITS)
        except ValueError:
            return False      # bin grid exceeds the fused key's bin bits
        kw = dict(width=width, height=height, tile=DENSE_TILE)
        total, n_mid, n_g = (int(x) for x in bd.count_pairs_dense(
            self._br_verts, cam, k_slots=DENSE_K_CAP, k2_slots=DENSE_K_CAP,
            **kw))
        if total + n_mid > DENSE_MAX_PAIRS:
            return False
        _, hist, _ = bd.count_hist_dense(self._br_verts, cam,
                                         k_cap=DENSE_K_CAP, **kw)
        n_ks = bd.pick_nks(hist.cpu().numpy())
        p_max = bd.pick_cap(sum(n_ks), 16 * bd.TPT)
        # The reference gates only on the exact count (ADVICE r5,
        # renderer.py:1009), but p_max, over the quantised slices, is what
        # every prep op and the tile table scale with.
        if p_max > DENSE_MAX_PAIRS:
            return False
        self._br = {
            "width": width, "height": height, "nb": txn * tyn,
            "ray_rows": DENSE_TILE * DENSE_TILE // 128, "p_max": p_max,
            "n_ks": n_ks,
            "g2_max": bd.pick_cap(n_g, bd.TPT, pad=bd.TPT) if n_g else 0,
            "mcodes": torch.from_numpy(mcodes).to(self.device),
            "cam_pos": cam["pos"].clone(),
        }
        return True

    def _dense_prep(self, cam):
        """The armed prep v5: (rows, row0, row1, g_r1, ok)."""
        c = self._br
        return bd.binraster_prep_dense5(
            self._br_verts, cam, c["mcodes"], width=c["width"],
            height=c["height"], tile=DENSE_TILE, k_cap=DENSE_K_CAP,
            p_max=c["p_max"], n_ks=c["n_ks"], g2_max=c["g2_max"],
            z_bits=bd.Z_BITS)

    def freeze_primary_structure(self, cam: dict) -> float:
        """Build the dense engine's screen-space structure once and keep it
        for later trace_primary calls with this very camera (the analogue
        of a prebuilt BVH). Needs a prior successful prepare_primary.
        Returns the build's wall seconds."""
        t0 = time.perf_counter()
        out = self._dense_prep(cam)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._br["frozen"] = out
        self._br["frozen_cam"] = {k: v.clone() for k, v in cam.items()}
        return time.perf_counter() - t0

    def _frozen_structure(self, cam):
        """The frozen structure when it was built for exactly `cam`, else
        None: a camera rotated in place passes the ray contract but would
        trace stale bins."""
        fc = self._br.get("frozen_cam")
        if fc is None or fc.keys() != cam.keys():
            return None
        if all(torch.equal(cam[k], fc[k]) for k in fc):
            return self._br["frozen"]
        return None

    def _trace_binraster_dense(self, dirn, tmin, tmax, cam):
        c = self._br
        frozen = self._frozen_structure(cam)
        rows, r0, r1, g1, ok = (frozen if frozen is not None
                                else self._dense_prep(cam))
        dirs, scalars = bd.dense_rays(dirn, cam["pos"], tmin[0], tmax[0],
                                      c["nb"], c["ray_rows"])
        kw = dict(n_bins=c["nb"], ray_rows=c["ray_rows"])
        if self.dense_kernel == "dma":
            tri, t, u, v = bd.trace_dense_rows_dma(rows, r0, r1, dirs,
                                                   scalars, g1, **kw)
        else:
            tri, t, u, v = bd.trace_dense_rows(rows, r0, r1, dirs, scalars,
                                               g1, ez_chunk=DENSE_EZ_CHUNK,
                                               **kw)
        # A static size that was too small poisons every hit: loud.
        return torch.where(ok, tri, -2), t, u, v

    def trace_primary(self, orig, dirn, tmin, tmax, cam=None,
                      canonical=None):
        """Primary-ray closest-hit trace (the seed_primary="off" path).

        cam: camera_arrays dict; with the dense engine armed, canonical
        primary rays (orig == cam pos, uniform tmin == znear, uniform
        tmax, the full W*H frame) go to it, everything else to the BVH
        path. canonical: None checks the contract; True asserts it and
        raises ValueError when the rays break it; False forces the BVH
        path."""
        armed = cam is not None and self._br is not None
        if canonical is True and armed and not self._binraster_contract_ok(
                orig, tmin, tmax, cam):
            raise ValueError(
                "trace_primary(canonical=True): rays violate the bin-raster "
                "contract (orig == cam pos, uniform tmin == znear, uniform "
                "tmax); rebuild the batch with raygen.primary(cam) or pass "
                "canonical=False")
        if (armed and canonical is not False
                and dirn.shape[0] == self._br["width"] * self._br["height"]
                and (canonical is True
                     or self._binraster_contract_ok(orig, tmin, tmax, cam))):
            return self._trace_binraster_dense(dirn, tmin, tmax, cam)
        return _trace_batched(self._tracer, RayBatch(orig, dirn, tmin, tmax),
                              self._cap(), False)

    def _binraster_contract_ok(self, orig, tmin, tmax, cam) -> bool:
        """Uniform tmin == znear, uniform tmax, every origin at the armed
        camera position."""
        return bool(((tmin == cam["znear"]) & (tmax == tmax[0])
                     & (orig == self._br["cam_pos"]).all(dim=-1)).all())

    def _cap(self) -> int:
        """Per-dispatch ray cap."""
        return max(self.cfg.max_batch_rays, 1 << 22)

    def _unit_normals(self, hit_tri: torch.Tensor, dirn: torch.Tensor):
        return raygen.surface_frame(hit_tri, dirn, self.geom_normals, 0.0)[0]

    def _default_light(self, camera: Camera) -> np.ndarray:
        if any(self.cfg.light):
            return np.asarray(self.cfg.light, np.float32)
        lo, hi = self._bbox   # scene.bbox(), taken once in __init__
        # High-center light slightly toward the camera.
        c = (lo + hi) / 2
        return (np.array([c[0], hi[1] * 0.95, c[2]], np.float32) * 0.7
                + camera.position * 0.3)

    def gen_secondary(self, camera: Camera, mode: str, batch: RayBatch,
                      tri: torch.Tensor, t: torch.Tensor, key=None):
        """The secondary RayBatch of `mode` as render() builds it: rays of
        missed pixels are dead (zero length), and AO and diffuse batches
        are Morton-sorted when cfg.sort_secondary (AO origin-major, diffuse
        direction-major). Returns (batch, any_hit)."""
        cfg = self.cfg
        key = rng.prng_key(cfg.seed, self.device) if key is None else key
        hit_mask = tri >= 0
        normals = self._unit_normals(tri, batch.dirn)
        hit_pos = batch.orig + torch.where(hit_mask, t, 0.0)[:, None] \
            * batch.dirn
        if mode == "shadow":
            light = torch.from_numpy(np.asarray(
                self._default_light(camera), np.float32)).to(self.device)
            sb = raygen.shadow(hit_pos, normals, light, self.eps)
            return RayBatch(sb.orig, sb.dirn, sb.tmin,
                            torch.where(hit_mask, sb.tmax, 0.0),
                            sb.slot_to_id), True
        if mode in ("ao", "diffuse"):
            S = cfg.samples
            gen = raygen.ao if mode == "ao" else raygen.diffuse
            arg = cfg.ao_radius if mode == "ao" else self.scene_scale * 10.0
            sec = gen(key, hit_pos, normals, S, arg, self.eps)
            live = torch.repeat_interleave(hit_mask, S)
            sec = RayBatch(sec.orig, sec.dirn, sec.tmin,
                           torch.where(live, sec.tmax, 0.0), sec.slot_to_id)
            if cfg.sort_secondary:
                sec = morton_sort_rays(sec, self.scene_lo, self.scene_hi,
                                       direction_major=(mode != "ao"))
            return sec, mode == "ao"
        raise ValueError(f"no secondary pass for mode {mode!r}")

    def _secondary_tracer(self):
        """The tracer of the secondary passes: the plain engine tracer.
        seed_secondary and stage_secondary "auto" resolve to off (the
        reference's auto needs tuned.json entries, and the port reads no
        tuned.json); "on" is not ported yet."""
        for name in ("seed_secondary", "stage_secondary"):
            value = getattr(self.cfg, name)
            if value == "on":
                raise NotImplementedError(
                    f"{name}='on' is not ported yet (ROADMAP queue 1, item "
                    "15: subset_seeded_trace and staged_closest_trace)")
            if value not in ("auto", "off"):
                raise ValueError(f"{name} must be on, off or auto, not "
                                 f"{value!r}")
        return self._tracer

    def _trace_secondary(self, batch: RayBatch, any_hit: bool):
        """One secondary pass: the live prefix of a sorted batch, or the
        whole batch."""
        tr = self._secondary_tracer()
        if self.cfg.sort_secondary:   # dead rays are at the end
            return _compact_trace(tr, batch, self._cap(), any_hit,
                                  compact=self.cfg.compact_rays)
        return _trace_batched(tr, batch, self._cap(), any_hit)

    def render(self, camera: Camera, mode: str | None = None) -> RenderResult:
        cfg = self.cfg
        mode = mode or cfg.mode
        if mode == "textured":
            raise NotImplementedError(
                "mode 'textured' is not ported yet (ROADMAP queue 1, item 8: "
                "render/texture.py)")
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        W, H = cfg.width, cfg.height
        timer = StageTimer(self.device)
        order, _ = pixel_table(W, H)
        cam = raygen.camera_arrays(camera, W, H, self.device)
        with timer.stage("raygen"):
            batch = raygen.primary(
                cam, W, H, torch.from_numpy(order.copy()).to(self.device))
        with timer.stage("prepare_primary"):
            self.prepare_primary(cam, W, H)
        with timer.stage("trace_primary"):
            # raygen.primary(cam) built the batch: canonical by
            # construction.
            tri, t, _, _ = self.trace_primary(batch.orig, batch.dirn,
                                              batch.tmin, batch.tmax,
                                              cam=cam, canonical=True)
        timer.count("rays_primary", batch.num_rays)
        base_col = normal_color(self.geom_normals, tri)
        key = rng.prng_key(cfg.seed, self.device)

        if mode == "primary":
            color = base_col
        elif mode == "shadow":
            with timer.stage("raygen_shadow"):
                sbatch, _ = self.gen_secondary(camera, mode, batch, tri, t,
                                               key=key)
            with timer.stage("trace_shadow"):
                stri = _trace_batched(self._tracer, sbatch, self._cap(),
                                      True)[0]
            timer.count("rays_shadow", sbatch.num_rays)
            color = shadow_mix(base_col, (stri < 0).to(torch.float32))
        elif mode in ("ao", "diffuse"):
            S = cfg.samples
            with timer.stage(f"raygen_{mode}"):
                sec, any_hit = self.gen_secondary(camera, mode, batch, tri, t,
                                                  key=key)
            with timer.stage(f"trace_{mode}"):
                stri = self._trace_secondary(sec, any_hit)[0]
            timer.count(f"rays_{mode}", sec.num_rays)
            if cfg.sort_secondary:
                stri = unsort(stri, sec.slot_to_id)
            if mode == "ao":
                vis = (stri < 0).to(torch.float32).reshape(-1, S).mean(dim=1)
                color = base_col * vis[:, None]
            else:
                bounce = normal_color(self.geom_normals, stri).reshape(
                    -1, S, 3).mean(dim=1)
                color = base_col * 0.5 + bounce * 0.5
        else:
            color = self._path_trace(key, batch, tri, t, timer)
        with timer.stage("shade"):
            fb = torch.zeros((W * H, 3), dtype=torch.float32,
                             device=self.device)
            fb[batch.slot_to_id.long()] = color
            img = fb.cpu().numpy().reshape(H, W, 3)
        with timer.stage("readback"):
            hit_tri = unsort(tri, batch.slot_to_id).cpu().numpy()
            hit_t = unsort(t, batch.slot_to_id).cpu().numpy()
        stats = timer.ms()
        # Mrays/s of each traced pass (its trace stage's wall time).
        for k in list(stats):
            if k.startswith("rays_"):
                name = k[5:]
                if stats.get(f"trace_{name}", 0) > 0:
                    stats[f"mrays_{name}"] = (stats[k] / 1e6
                                              / (stats[f"trace_{name}"] / 1e3))
        return RenderResult(image=img, hit_tri=hit_tri, hit_t=hit_t,
                            stats=stats)

    def _path_trace(self, key, batch: RayBatch, tri, t, timer: StageTimer):
        """`bounces`-bounce diffuse path tracing with emissive materials."""
        cfg = self.cfg
        R = batch.num_rays
        dev = self.device
        throughput = torch.ones((R, 3), dtype=torch.float32, device=dev)
        radiance = torch.zeros((R, 3), dtype=torch.float32, device=dev)
        cur_orig, cur_dirn = batch.orig, batch.dirn
        cur_tri, cur_t = tri, t
        alive = cur_tri >= 0
        # Sky term for primary misses.
        radiance = radiance + torch.where(alive[:, None], 0.0, 0.05)
        for b in range(cfg.bounces + 1):
            mat = self.mat_ids[cur_tri.clamp(min=0).long()]
            emis = self.mat_emissive[mat]
            diff = self.mat_diffuse[mat]
            radiance = radiance + torch.where(alive[:, None],
                                              throughput * emis, 0.0)
            throughput = throughput * torch.where(alive[:, None], diff, 0.0)
            if b == cfg.bounces:
                break
            normals = self._unit_normals(cur_tri, cur_dirn)
            hit_pos = cur_orig + torch.where(alive, cur_t, 0.0)[:, None] \
                * cur_dirn
            key, sub = rng.split(key)
            d = raygen.cosine_hemisphere(sub, normals, (R,))
            o = hit_pos + normals * self.eps
            nb = RayBatch(o, d, torch.zeros((R,), dtype=torch.float32,
                                            device=dev),
                          torch.where(alive, float(np.float32(
                              self.scene_scale * 10)), 0.0),
                          torch.arange(R, dtype=torch.int32, device=dev))
            if cfg.sort_secondary:
                nb = morton_sort_rays(nb, self.scene_lo, self.scene_hi)
            with timer.stage(f"trace_bounce{b}"):
                btri, bt, _, _ = self._trace_secondary(nb, False)
            timer.count(f"rays_bounce{b}", R)
            if cfg.sort_secondary:
                btri = unsort(btri, nb.slot_to_id)
                bt = unsort(bt, nb.slot_to_id)
            cur_orig, cur_dirn = o, d
            # Ambient sky for bounce misses.
            sky = (btri < 0) & alive
            radiance = radiance + torch.where(sky[:, None],
                                              throughput * 0.8, 0.0)
            alive = alive & (btri >= 0)
            cur_tri, cur_t = btri, bt
        return radiance
