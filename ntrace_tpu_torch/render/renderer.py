"""Per-frame orchestration: build -> raygen -> trace -> secondary -> shade.

Counterpart of ntrace_tpu/render/renderer.py: `build_accel` (165-197),
`normal_color` (200-210), `shadow_mix` (213), `_trace_batched`
(337-364), `_compact_trace` (367-401), `Renderer.__init__` (404-440,
597-698) with the packed-direct LBVH path (404-433, 613-619) and the scene
state (725-736), `trace_primary` (1136-1188, the seed_primary="off" path),
`_cap` (1203-1208), `_unit_normals` (1212), `gen_secondary` (1221-1254),
`render` (1256-1394) for the modes primary, shadow, ao, diffuse and path,
`_default_light` (1396-1402), the plain-tracer branch of
`_secondary_tracer` (1448-1492, in `_trace_secondary`) and `_path_trace`
(1494-1548).

The renderer runs frames; the engines live in trace/. The constructor
asks `trace/registry.py` once for the BVH engine of cfg.engine (tables and
trace call: `Renderer.tracer`) and for the screen-space engine of
"binraster" or "binraster_dense" (`Renderer.screen`), which serves
canonical primary frames once prepare_primary arms it. builder="lbvh"
or "hlbvh" with engine "auto" or "packet" and no `flat` builds the tables
on the renderer's device (`_rebuild`) and traces them in place
(`self.flat` is None; `update_positions` rebuilds them from moved
vertices); every other route builds a FlatBVH (`build_accel`) that the
engine packs on the host.
The port reads no tuned.json: "auto" means the packet kernel alone. What
is not ported raises NotImplementedError naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from ntrace_tpu_torch.bvh import hlbvh
from ntrace_tpu_torch.bvh.hlbvh import build_hlbvh_flat
from ntrace_tpu_torch.bvh.lbvh import (Graphed, build_lbvh_flat,
                                      build_lbvh_packed, build_packed_read,
                                      geometric_normals, inputs_from)
from ntrace_tpu_torch.host import (BuildConfig, Camera, FlatBVH, RenderConfig,
                                   Scene, build_median_bvh, build_sbvh,
                                   flatten_bvh)
from ntrace_tpu_torch.ops.boxes import child_boxes
from ntrace_tpu_torch.ops.pscan import row_scan_i32
from ntrace_tpu_torch.ray import raygen, rng
from ntrace_tpu_torch.ray.pixeltable import pixel_table
from ntrace_tpu_torch.ray.raybatch import RayBatch, sort_by_key, unsort
from ntrace_tpu_torch.tables import table_top, tables_from_device
from ntrace_tpu_torch.trace import registry
from ntrace_tpu_torch.utils import timing

MODES = ("primary", "shadow", "ao", "diffuse", "path")


@dataclass
class RenderResult:
    image: np.ndarray        # (H, W, 3) float32 linear
    hit_tri: np.ndarray      # (H*W,) int32 primary hits (pixel order)
    hit_t: np.ndarray        # (H*W,) float32
    stats: dict = field(default_factory=dict)
    # Path mode: each path's last hit, (H*W,) int32 on the device in the
    # frame's ray-slot order (pixel_table's), -1 where the path ended
    # before it; never read back by render(). None in the other modes.
    bounce_tri: torch.Tensor | None = None


def build_accel(scene: Scene, cfg: BuildConfig = BuildConfig(), *,
                device="cuda") -> FlatBVH:
    """BVH build with the reference's builders; no accel cache. The host
    builders ignore `device`; "lbvh" and "hlbvh" build on it and return a
    host FlatBVH."""
    if cfg.builder in ("median", "golden"):
        return flatten_bvh(build_median_bvh(scene, cfg), scene)
    if cfg.builder in ("sbvh", "binned_sah"):
        return flatten_bvh(build_sbvh(scene, cfg), scene)
    if cfg.builder == "lbvh":
        return build_lbvh_flat(scene, cfg, device=device)
    if cfg.builder == "hlbvh":
        return build_hlbvh_flat(scene, cfg, device=device)
    if cfg.builder == "kdtree":
        raise NotImplementedError(
            "builder 'kdtree' is not ported yet (ROADMAP queue 1, item 10: "
            "other engines)")
    raise ValueError(f"unknown builder {cfg.builder!r}")


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
    """The reference's live-prefix trace of a batch whose dead rays sort
    last: here the whole batch in one `_trace_batched`, with no host read.

    Every engine ends a dead ray (tmax <= tmin, or NaN) before it loads a
    node, and a packet with no live ray does not walk; a dead ray keeps the
    miss record tri -1, t = tmax, u = v = 0, the reference's pad wherever
    tmax is 0, as it is for every dead ray of a batch render() makes. So
    the whole batch gives the prefix trace's answer on every slot, a live
    ray sorted among the dead ones included. compact: "on", "off" or
    "auto", checked; it selects no route.
    """
    if compact not in ("on", "off", "auto"):
        raise ValueError(f"compact_rays must be on, off or auto, not "
                         f"{compact!r}")
    return _trace_batched(tracer, batch, cap, any_hit)


class Renderer:
    def __init__(self, scene: Scene, build_cfg: BuildConfig = BuildConfig(),
                 cfg: RenderConfig = RenderConfig(),
                 flat: FlatBVH | None = None, *, device,
                 dense_kernel: str = "walk"):
        """dense_kernel: "walk", "dma" or "visits", the dense engine's kernel
        (the reference's br2_kernel); all give bit-identical frames."""
        self.scene = scene
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # "cuda" names the current card; its tensors say cuda:<index>,
            # which update_positions compares with.
            self.device = torch.device("cuda", torch.cuda.current_device())
        if cfg.seed_primary != "off":
            raise NotImplementedError(
                f"seed_primary={cfg.seed_primary!r} is not ported yet "
                "(ROADMAP queue 1, item 6: the seeded primary trace)")
        self.engine = registry.engine_name(cfg.engine)
        self.timer = timing.StageTimer(self.device)
        self.frames = 0         # render() calls: the frame number of spans
        # pixel_table's order on the device, per (W, H): uploaded by the
        # first frame of a size. Read only: raygen.primary's slot_to_id is
        # this tensor.
        self._pixel_orders: dict[tuple[int, int], torch.Tensor] = {}
        self.updates = 0        # update_positions() calls
        self.build_cfg = build_cfg
        # Packed-direct: builder="lbvh" or "hlbvh" builds the packet
        # kernel's tables on the device (the reference's path on its
        # accelerator).
        direct = (flat is None and cfg.engine in ("auto", "packet")
                  and build_cfg.builder in ("lbvh", "hlbvh"))
        # The direct route's triangle indices, on the device: the topology
        # update_positions rebuilds over (None on every other route).
        self._indices = None
        built = None
        # Set-up, not the hot path: the build is always timed.
        with timing.tracing():
            if direct:
                self.flat = None
                self._indices = torch.from_numpy(scene.indices).to(
                    self.device)
                # On the card every build replays two CUDA graphs: the
                # inputs from the positions, then the tree's first try.
                launches = (row_scan_i32, child_boxes)
                self._graphs = (Graphed(launches, own_inputs=True),
                                Graphed(launches))
                built = self._rebuild(torch.from_numpy(scene.positions).to(
                    self.device), self.timer, "build")
            else:
                with self.timer.stage("build"):
                    self.flat = flat if flat is not None else build_accel(
                        scene, build_cfg, device=self.device)
        self.tracer = registry.bind(self.engine, cfg, scene, self.flat,
                                    self.device, built)
        # Scene state of the secondary passes (the direct route set the
        # normals and the box in its build).
        def dev(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(
                self.device)

        if not direct:
            self.geom_normals = dev(scene.geometric_normals())
            lo, hi = scene.bbox()
            self._set_box(lo, hi, dev(lo), dev(hi))
        self.mat_diffuse = dev([m.diffuse for m in scene.materials])
        self.mat_emissive = dev([m.emissive for m in scene.materials])
        self.mat_ids = dev(scene.mat_ids, np.int64)
        # The screen-space engine, where cfg.engine names one, serves
        # canonical primary rays once prepare_primary arms it.
        self.screen = registry.screen_engine(cfg.engine, scene, self.device,
                                             dense_kernel)

    @property
    def tables(self):
        """The tables the BVH engine traces (after update_positions, the
        rebuilt ones)."""
        return self.tracer.tables

    @property
    def packed(self):
        """The packed tree the tables were made from."""
        return self.tracer.packed

    def _set_box(self, lo: np.ndarray, hi: np.ndarray, lo_dev: torch.Tensor,
                 hi_dev: torch.Tensor):
        """The scene box, on the host (lo, hi) and on the device, and what
        derives from it: the diagonal and the self-intersection offset."""
        self._bbox = lo, hi
        self.scene_lo, self.scene_hi = lo_dev, hi_dev
        self.scene_scale = float(np.linalg.norm(hi - lo))
        self.eps = float(np.float32(self.scene_scale * 1e-4))

    def _rebuild(self, positions: torch.Tensor, timer: timing.StageTimer,
                 stage: str):
        """The direct route's build from vertex positions on the device, as
        the stage `stage`: the triangles gathered over the renderer's
        indices, their boxes, the scene box and the geometric normals on
        the device (span ntrace.<stage>.inputs), then the tree and its
        packed tables, with one host read that carries the scene box and
        the tables' check. On a CUDA device the inputs and the tree's
        first try are replays of the renderer's two CUDA graphs (lbvh.py:
        Graphed), recorded at the constructor's build; their tensors are
        rewritten by the next build, after the frames of this one.
          - builder "lbvh": the LBVH (spans .lbvh, .node_count);
          - builder "hlbvh": the HLBVH (bvh/hlbvh.py:build_packed_read,
            spans .forest, .read, .top, .splice, and the nested stage
            <stage>_top), then one upload of the top nodes; where the
            reference falls back to the plain LBVH, the LBVH build follows
            in the same call.
        A tree with no internal node, or fewer than 2 triangles, takes the
        median route on the host, as build_lbvh_packed does. Counters
        <stage>_tris, <stage>_nodes, <stage>_retries (the compact_cap
        retry), <stage>_scan_launches (row-scan kernel launches: 4 a try
        on a CUDA device, 0 on the CPU), <stage>_box_launches (child-box
        kernel launches: 1 a try on a CUDA device, 2 for the HLBVH forest,
        0 on the CPU); on the HLBVH route also <stage>_clusters,
        <stage>_top_nodes and <stage>_fallbacks (1 where the plain LBVH
        build served). Returns (packed, tables)."""
        tpr, npr = 12, 1
        n = self._indices.shape[0]
        scans, boxes = row_scan_i32.launches, child_boxes.launches
        hl = None
        with timer.stage(stage):
            with timing.span(f"ntrace.{stage}.inputs"):
                args, gn, box = self._graphs[0](self._inputs, positions)
            packed, retries = None, 0
            if n >= 2 and self.build_cfg.builder == "hlbvh":
                hl = hlbvh.build_packed_read(args, self.build_cfg, box,
                                             timer, stage, tris_per_row=tpr,
                                             graph=self._graphs[1])
                packed, retries = hl["packed"], hl["retries"]
                got, top = hl["box"], hl["top"]
            if packed is None and n >= 2:
                # HLBVH's fallback builds eagerly: the graph is the forest's.
                packed, carried, tries = build_packed_read(
                    args, self.build_cfg.max_leaf_size,
                    lambda nodes, tris: torch.cat(
                        [box, table_top(nodes, tris, npr, tpr)]),
                    stage=stage, tris_per_row=tpr, nodes_per_row=npr,
                    graph=None if hl else self._graphs[1])
                retries += tries
                got, top = carried[0:6], carried[6:8].tolist()
            if packed is None:
                scene = dataclasses.replace(self.scene,
                                            positions=timing.read(positions))
                packed = build_lbvh_packed(scene, self.build_cfg,
                                           tris_per_row=tpr,
                                           nodes_per_row=npr,
                                           device=self.device)
                (lo, hi), top = scene.bbox(), None
            else:
                lo, hi = got[0:3].copy(), got[3:6].copy()
            tables = tables_from_device(packed.nodes8, packed.tris12,
                                        packed.num_nodes, npr, tpr, top=top)
        self.geom_normals = gn
        self._set_box(lo, hi, args[3], args[4])
        timer.count(f"{stage}_tris", n)
        timer.count(f"{stage}_nodes", packed.num_nodes)
        timer.count(f"{stage}_retries", retries)
        timer.count(f"{stage}_scan_launches", row_scan_i32.launches - scans)
        timer.count(f"{stage}_box_launches", child_boxes.launches - boxes)
        if self.build_cfg.builder == "hlbvh":
            timer.count(f"{stage}_clusters", hl["clusters"] if hl else 0)
            timer.count(f"{stage}_top_nodes", hl["top_nodes"] if hl else 0)
            timer.count(f"{stage}_fallbacks",
                        int(hl is None or hl["packed"] is None))
        return packed, tables

    def _inputs(self, positions: torch.Tensor) -> tuple:
        """The build's inputs from vertex positions (lbvh.inputs_from), the
        geometric normals and the scene box (6,) on the device."""
        args = inputs_from(positions, self._indices)
        return args, geometric_normals(args[2]), torch.cat(args[3:])

    def update_positions(self, positions: torch.Tensor) -> dict:
        """Move the scene's vertices and rebuild the tree on the device:
        `positions` (V, 3) float32 on the renderer's device; the topology
        (indices, materials) stays, and `self.scene` keeps the positions it
        was built with. One call builds the tree and its packed tables
        from these positions alone (`_rebuild`: one host read, and for
        HLBVH one upload of the top nodes); render() then traces them. The
        direct route only (builder "lbvh" or "hlbvh", engine "auto" or
        "packet", no `flat`); any other raises NotImplementedError.
        Returns the call's stats: counters rebuild_tris, rebuild_nodes,
        rebuild_retries, rebuild_scan_launches, rebuild_box_launches,
        copies and copy_bytes (HLBVH adds rebuild_clusters,
        rebuild_top_nodes and rebuild_fallbacks), and while tracing is on
        the host times host_rebuild, host_wait (the read) and host_frame,
        and the stage's device span rebuild (HLBVH adds rebuild_top and
        host_rebuild_top, the top tree on the host). The call returns
        before the device has passed the rebuild's end: on a CUDA device
        the device spans enter the returned dict after the next wait of
        the program, by the time the next render() has returned
        (utils/timing.py)."""
        if self._indices is None:
            raise NotImplementedError(
                "update_positions rebuilds the direct route only (builder "
                "'lbvh' or 'hlbvh', engine 'auto' or 'packet', no `flat` "
                f"given); this renderer has builder "
                f"{self.build_cfg.builder!r}, engine {self.cfg.engine!r} "
                "(ROADMAP queue 6, item 45: update_positions for the host "
                "builders, the other engines and a given FlatBVH)")
        want = (self.scene.num_verts, 3)
        if tuple(positions.shape) != want:
            raise ValueError(f"positions: shape {tuple(positions.shape)}, "
                             f"want {want}")
        if positions.dtype != torch.float32:
            raise TypeError(f"positions: dtype {positions.dtype}, want "
                            "float32")
        if positions.device != self.device:
            raise ValueError(f"positions on {positions.device}, renderer "
                             f"on {self.device}")
        timer = timing.StageTimer(self.device)
        self.updates += 1
        with timer.frame("ntrace.update_positions", str(self.updates)):
            self.tracer.packed, self.tracer.tables = self._rebuild(
                positions.contiguous(), timer, "rebuild")
        return timer.ms()

    def prepare_primary(self, cam: dict, width: int, height: int) -> bool:
        """Arm the screen-space engine for (cam, W, H): one count pass picks
        the static sizes. Returns True when armed; False leaves the frame to
        the BVH path (no screen-space engine, a frame that does not tile, a
        bin grid too large for the sort key, or, for the dense engine, a
        pair budget the camera would exceed)."""
        return self.screen is not None and self.screen.arm(cam, width,
                                                           height)

    def freeze_primary_structure(self, cam: dict) -> float:
        """Build the screen-space structure once and keep it for later
        trace_primary calls with this very camera (the analogue of a
        prebuilt BVH). Needs a prior successful prepare_primary. Returns
        the build's wall seconds."""
        return self.screen.freeze(cam)

    def trace_primary(self, orig, dirn, tmin, tmax, cam=None,
                      canonical=None):
        """Primary-ray closest-hit trace (the seed_primary="off" path).

        cam: camera_arrays dict; with a screen-space engine armed, canonical
        primary rays (orig == cam pos, uniform tmin == znear, uniform
        tmax, the full W*H frame) go to it, everything else to the BVH
        path. canonical: None checks the contract; True asserts it and
        raises ValueError when the rays break it; False forces the BVH
        path."""
        screen = self.screen
        armed = cam is not None and screen is not None and screen.armed
        if canonical is True and armed and not screen.canonical(
                orig, tmin, tmax, cam):
            raise ValueError(
                "trace_primary(canonical=True): rays violate the bin-raster "
                "contract (orig == cam pos, uniform tmin == znear, uniform "
                "tmax); rebuild the batch with raygen.primary(cam) or pass "
                "canonical=False")
        if (armed and canonical is not False
                and dirn.shape[0] == screen.sizes["width"]
                * screen.sizes["height"]
                and (canonical is True
                     or screen.canonical(orig, tmin, tmax, cam))):
            return screen.trace(dirn, tmin[0], tmax[0], cam)
        return _trace_batched(self.tracer.trace,
                              RayBatch(orig, dirn, tmin, tmax), self._cap(),
                              False)

    def _cap(self) -> int:
        """Per-dispatch ray cap."""
        return max(self.cfg.max_batch_rays, 1 << 22)

    def _unit_normals(self, hit_tri: torch.Tensor, dirn: torch.Tensor):
        return raygen.surface_frame(hit_tri, dirn, self.geom_normals, 0.0)[0]

    def _default_light(self, camera: Camera) -> np.ndarray:
        if any(self.cfg.light):
            return np.asarray(self.cfg.light, np.float32)
        lo, hi = self._bbox   # the box of the current positions
        # High-center light slightly toward the camera.
        c = (lo + hi) / 2
        return (np.array([c[0], hi[1] * 0.95, c[2]], np.float32) * 0.7
                + camera.position * 0.3)

    def secondary_length(self, mode: str) -> float:
        """Every live AO or diffuse ray's tmax: the AO radius, or ten scene
        diagonals for a diffuse bounce."""
        return self.cfg.ao_radius if mode == "ao" else self.scene_scale * 10.0

    def gen_secondary(self, camera: Camera, mode: str, batch: RayBatch,
                      tri: torch.Tensor, t: torch.Tensor):
        """The secondary RayBatch of `mode` as render() builds it: rays of
        missed pixels are dead (zero length), and AO and diffuse batches
        are Morton-sorted when cfg.sort_secondary (AO origin-major, diffuse
        direction-major). AO and diffuse rays and their sort key come from
        raygen.secondary_rays (one kernel launch on a CUDA device) under
        the host key words of cfg.seed. Returns (batch, any_hit)."""
        cfg = self.cfg
        if mode == "shadow":
            hit_mask = tri >= 0
            normals = self._unit_normals(tri, batch.dirn)
            hit_pos = batch.orig + torch.where(hit_mask, t, 0.0)[:, None] \
                * batch.dirn
            light = timing.upload(np.asarray(self._default_light(camera),
                                             np.float32), self.device)
            sb = raygen.shadow(hit_pos, normals, light, self.eps)
            return RayBatch(sb.orig, sb.dirn, sb.tmin,
                            torch.where(hit_mask, sb.tmax, 0.0),
                            sb.slot_to_id), True
        if mode in ("ao", "diffuse"):
            sec, key = raygen.secondary_rays(
                rng.key_words(cfg.seed), batch, tri, t, self.geom_normals,
                cfg.samples, self.secondary_length(mode), self.eps,
                self.scene_lo, self.scene_hi, direction_major=(mode != "ao"))
            if cfg.sort_secondary:
                with timing.span("ntrace.sort"):
                    sec = sort_by_key(sec, key)
            else:
                sec.slot_to_id = torch.arange(sec.num_rays,
                                              dtype=torch.int32,
                                              device=self.device)
            return sec, mode == "ao"
        raise ValueError(f"no secondary pass for mode {mode!r}")

    def _trace_secondary(self, batch: RayBatch, any_hit: bool, live=None):
        """One secondary pass through the BVH engine (the reference's
        plain-tracer branch of `_secondary_tracer`): the whole batch, sorted
        or not, through _compact_trace, with no host read and no sync.
        seed_secondary and stage_secondary "auto" resolve to off (the
        reference's auto needs tuned.json entries); "on" is not ported yet.
        live, where given, is called with the pass's live rays, (tmax >
        tmin).sum() as a 0-d tensor on the batch's device, which it must
        not read (render() hands it to StageTimer.count_on_device)."""
        for name in ("seed_secondary", "stage_secondary"):
            value = getattr(self.cfg, name)
            if value == "on":
                raise NotImplementedError(
                    f"{name}='on' is not ported yet (ROADMAP queue 1, item "
                    "15: subset_seeded_trace and staged_closest_trace)")
            if value not in ("auto", "off"):
                raise ValueError(f"{name} must be on, off or auto, not "
                                 f"{value!r}")
        if live is not None:
            live((batch.tmax > batch.tmin).sum())
        return _compact_trace(self.tracer.trace, batch, self._cap(), any_hit,
                              compact=self.cfg.compact_rays)

    def render(self, camera: Camera, mode: str | None = None) -> RenderResult:
        """One frame, returned once its image and hits are on the host.
        Its stats hold the ray counts of each pass (rays_<pass>), the
        live rays of each AO, diffuse or path bounce pass (live_ao,
        live_diffuse, live_bounce<b>: counted on the device, read with
        the image) and the frame's copies between host and device
        (utils/timing.py: copies, copy_bytes); while tracing is on, also
        in milliseconds each stage's device span and host time (<stage>,
        host_<stage>; every op of the frame lies in a stage), the host's
        wait for the image (host_wait) and its time in the whole call
        (host_frame). The spans of the frame, and of the build and
        update_positions calls before it, resolve after its one wait."""
        mode = mode or self.cfg.mode
        if mode == "textured":
            raise NotImplementedError(
                "mode 'textured' is not ported yet (ROADMAP queue 1, item 8: "
                "render/texture.py)")
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}")
        timer = timing.StageTimer(self.device)
        self.frames += 1
        with timer.frame("ntrace.render", str(self.frames)):
            img, hit_tri, hit_t, bounce_tri = self._render(camera, mode,
                                                           timer)
        return RenderResult(image=img, hit_tri=hit_tri, hit_t=hit_t,
                            stats=timer.ms(), bounce_tri=bounce_tri)

    def _render(self, camera: Camera, mode: str, timer: timing.StageTimer):
        """One frame of render(): (image, hit_tri, hit_t) on the host and,
        in path mode, the last hits (RenderResult.bounce_tri). Every op
        lies in a stage: the camera's upload in raygen; the normal colour,
        the secondary hits' unsort and the colour's composition in
        shade."""
        cfg = self.cfg
        W, H = cfg.width, cfg.height
        with timer.stage("raygen"):
            cam = raygen.camera_arrays(camera, W, H, self.device)
            batch = raygen.primary(cam, W, H,
                                   self._pixel_order(W, H))
        with timer.stage("prepare_primary"):
            self.prepare_primary(cam, W, H)
        with timer.stage("trace_primary"):
            # raygen.primary(cam) built the batch: canonical by
            # construction.
            tri, t, _, _ = self.trace_primary(batch.orig, batch.dirn,
                                              batch.tmin, batch.tmax,
                                              cam=cam, canonical=True)
        timer.count("rays_primary", batch.num_rays)
        bounce_tri = None

        if mode == "shadow":
            with timer.stage("raygen_shadow"):
                sbatch, _ = self.gen_secondary(camera, mode, batch, tri, t)
            with timer.stage("trace_shadow"):
                stri = _trace_batched(self.tracer.trace, sbatch,
                                      self._cap(), True)[0]
            timer.count("rays_shadow", sbatch.num_rays)
        elif mode in ("ao", "diffuse"):
            with timer.stage(f"raygen_{mode}"):
                sec, any_hit = self.gen_secondary(camera, mode, batch, tri,
                                                  t)
            with timer.stage(f"trace_{mode}"):
                stri = self._trace_secondary(
                    sec, any_hit,
                    live=lambda n: timer.count_on_device(f"live_{mode}",
                                                         n))[0]
            timer.count(f"rays_{mode}", sec.num_rays)
        elif mode == "path":
            color, bounce_tri = self._path_trace(rng.key_words(cfg.seed),
                                                 batch, tri, t, timer)
        with timer.stage("shade"):
            if mode != "path":
                color = base_col = normal_color(self.geom_normals, tri)
            if mode == "shadow":
                color = shadow_mix(base_col, (stri < 0).to(torch.float32))
            elif mode in ("ao", "diffuse"):
                S = cfg.samples
                if cfg.sort_secondary:
                    stri = unsort(stri, sec.slot_to_id)
                if mode == "ao":
                    vis = (stri < 0).to(torch.float32).reshape(-1, S).mean(
                        dim=1)
                    color = base_col * vis[:, None]
                else:
                    bounce = normal_color(self.geom_normals, stri).reshape(
                        -1, S, 3).mean(dim=1)
                    color = base_col * 0.5 + bounce * 0.5
            fb = torch.zeros((W * H, 3), dtype=torch.float32,
                             device=self.device)
            fb[batch.slot_to_id.long()] = color
        with timer.stage("readback"):
            img, hit_tri, hit_t = timer.read_all(
                fb, unsort(tri, batch.slot_to_id),
                unsort(t, batch.slot_to_id))
        return img.reshape(H, W, 3), hit_tri, hit_t, bounce_tri

    def _pixel_order(self, W: int, H: int):
        """pixel_table(W, H)'s order, (W*H,) int32 on the device: uploaded
        on the first frame of the size (span ntrace.upload_pixels), the
        resident tensor after. Nothing may write into it."""
        order = self._pixel_orders.get((W, H))
        if order is None:
            with timing.span("ntrace.upload_pixels"):
                order = timing.upload(pixel_table(W, H)[0].copy(),
                                      self.device)
            self._pixel_orders[(W, H)] = order
        return order

    def _path_trace(self, words: tuple[int, int], batch: RayBatch, tri,
                    t, timer: timing.StageTimer):
        """`bounces`-bounce diffuse path tracing with emissive materials,
        from the host key words `words` of cfg.seed. Each bounce b is three
        stages: raygen_bounce<b> (the sky term of primary misses on the
        first; the hit's material, emission and throughput; the key split
        on the host and the bounce rays from raygen.secondary_rays at one
        sample, their normals, origins, cosine directions and sort key, one
        kernel launch on a CUDA device; the sort), trace_bounce<b>, and
        shade_bounce<b> (the unsort, the sky term of the bounce's misses,
        the live mask); shade_bounce<bounces> holds the last hit's
        emission. A bounce ray is live where the ray before it hit, which
        is where its path is alive. Counters rays_bounce<b> and
        live_bounce<b> (the bounce's live rays, counted on the device and
        read with the image). Returns (radiance, the last hit of each
        path), both in the batch's slot order."""
        cfg = self.cfg
        R = batch.num_rays
        dev = self.device
        cur, cur_tri, cur_t = batch, tri, t
        for b in range(cfg.bounces + 1):
            last = b == cfg.bounces
            with timer.stage(f"shade_bounce{b}" if last
                             else f"raygen_bounce{b}"):
                if b == 0:
                    throughput = torch.ones((R, 3), dtype=torch.float32,
                                            device=dev)
                    radiance = torch.zeros((R, 3), dtype=torch.float32,
                                           device=dev)
                    alive = cur_tri >= 0
                    # Sky term for primary misses.
                    radiance = radiance + torch.where(alive[:, None], 0.0,
                                                      0.05)
                mat = self.mat_ids[cur_tri.clamp(min=0).long()]
                emis = self.mat_emissive[mat]
                diff = self.mat_diffuse[mat]
                radiance = radiance + torch.where(alive[:, None],
                                                  throughput * emis, 0.0)
                throughput = throughput * torch.where(alive[:, None], diff,
                                                      0.0)
                if last:
                    break
                words, sub = rng.split_words(words)
                cur, key = raygen.secondary_rays(
                    sub, cur, cur_tri, cur_t, self.geom_normals, 1,
                    self.secondary_length("diffuse"), self.eps,
                    self.scene_lo, self.scene_hi, direction_major=True)
                nb = cur
                if cfg.sort_secondary:
                    with timing.span("ntrace.sort"):
                        nb = sort_by_key(cur, key)
            with timer.stage(f"trace_bounce{b}"):
                btri, bt, _, _ = self._trace_secondary(
                    nb, False,
                    live=lambda n: timer.count_on_device(f"live_bounce{b}",
                                                         n))
            timer.count(f"rays_bounce{b}", R)
            with timer.stage(f"shade_bounce{b}"):
                if cfg.sort_secondary:
                    btri = unsort(btri, nb.slot_to_id)
                    bt = unsort(bt, nb.slot_to_id)
                # Ambient sky for bounce misses.
                sky = (btri < 0) & alive
                radiance = radiance + torch.where(sky[:, None],
                                                  throughput * 0.8, 0.0)
                alive = alive & (btri >= 0)
                cur_tri, cur_t = btri, bt
        return radiance, cur_tri
