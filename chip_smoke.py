#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ntrace_tpu_torch) on one NVIDIA GPU.

Drives the port's main paths once, configured as bench.py configures the
JAX reference: the procedural conference scene (297,024 triangles), a
binned-SAH BVH (sah_tri_cost=0.02, max_leaf_size=48), and a 1024x768
frame through Renderer.render, primary and then each secondary mode at
the reference's RenderConfig defaults (samples=4, bounces=2). Phase 4
traces the primary frame with the hand-written CUDA traversal kernel
(ntrace_tpu_torch/csrc/packet_trace.cu); phase 6 with the dense
screen-space engine, as bench.py's tuned reference does: prep v5 in
torch, then the CUDA walk or dma kernel (ntrace_tpu_torch/csrc/
dense_trace.cu); phases 8 and 9 trace the secondary modes with the packet,
while-while and speculative while-while kernels.

Phases, each printed as it completes:
  1. versions, card name and power limit (nvidia-smi)
  2. build the CUDA kernels from ntrace_tpu_torch/csrc with nvcc
  3. kernel against its torch twin on the card: a 5,000-triangle random
     soup, 65,536 random rays, tables packed as (tris_per_row,
     nodes_per_row) = (12, 1) and (4, 8); closest-hit tri/t/u/v bit-equal
     on every ray, misses included; any-hit tri >= 0 equal; closest hits
     exact against brute_force_mt
  4. the main path: launch counter, image, 4,096 stride-sampled rays
     against trace_cpu_golden (0 tie-aware mismatches) and 256 rays against
     brute_force_mt (exact tri)
  5. the full frame: kernel (CUDA events, warm, median of 10) and twin
     times, kernel against twin bit for bit
  6. the dense engine on the same scene, BVH and camera: render() with
     kernel "walk" and again with "dma" (launch and prep counts, no -2
     poison); on the frozen full-frame structure both kernels (walk at
     ez_chunk 0 and 4) bit-equal to trace_dense_rows_ref on every ray; the
     golden and brute-force oracles; every ray where dense and packet
     differ decided by brute_force_mt for dense; times of the prep, the
     kernels, the twin, the render stages and the frame with and without
     the prep
  7. the device LBVH build (builder="lbvh", max_leaf_size=32): the row-scan
     kernel (csrc/row_scan.cu) bit-equal to row_scan_i32_ref on random
     (R, n) int32 at R in {1, 8, 31}, n in {1, 257, 8193, 297024}, both
     ops and directions, and on the hairball build's two ANSV inputs
     (31, 2,900,402); the conference build on the card bit-equal to the
     same build on the CPU; structural checks of the hairball build; the
     LBVH frame (render() through the row-scan and packet kernels) against
     the golden and brute-force oracles and against phase 4's frame on
     every ray; times of the build at both sizes, of each row-scan launch
     beside torch.cummax and the plain version, and of the frame's trace
  8. the secondary modes on phase 4's renderer (engine packet): render()
     for shadow, ao (3,145,728 rays at samples=4), diffuse and path
     (bounces=2), each pass recorded; any-hit passes tri >= 0 against
     brute_force_anyhit on 256 rays, closest-hit passes against
     trace_cpu_golden on 4,096 (0 tie-aware mismatches) and brute_force_mt
     on 256 (exact tri); images finite and not black
  9. the while-while and speculative while-while kernels
     (csrc/packet_ww.cu, csrc/packet_ifif.cu): the phase-3 soup check for
     each; all four modes rendered with engine packet_ww and packet_ifif,
     every pass on phase 8's rays, closest hits equal to the packet
     kernel's on tri/t/u/v on every ray, any hits on tri >= 0, images
     bit-equal to phase 8's; each kernel (packet too) bit-equal to its
     twin on a 65,536-ray stride sample of every batch; the times of
     packet, ww and ifif on the primary, shadow, AO and diffuse batches,
     beside one bound per batch: the least work any of the three twins
     counts on it (full counts on the primary frame, the sample scaled up
     on the others); the twins on the primary frame
 10. BASELINE config #4: the hairball (2,900,402 tris) with
     builder="lbvh", built on the card through the row-scan kernel, and
     render(mode="ao") through the packet kernel; 128 AO rays against
     brute_force_anyhit; the AO pass time
Then one JSON line of per-kernel results (with each kernel's bound from
this run's work), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises and the script
exits non-zero. Without a CUDA device it exits non-zero at once.

The script imports nothing of the JAX package: the scenes, host BVH
builders and CPU oracles are the port's own copies (ntrace_tpu_torch.host).

Run from the repository root: python3 chip_smoke.py
"""

import json
import statistics
import sys
import time
from contextlib import contextmanager

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ntrace_tpu_torch.bvh import lbvh
from ntrace_tpu_torch.device import describe
from ntrace_tpu_torch.host import (BuildConfig, RenderConfig,
                                   brute_force_anyhit, brute_force_mt,
                                   default_camera, get_scene,
                                   golden_mismatches, make_random_soup,
                                   pack_bvh, trace_cpu_golden)
from ntrace_tpu_torch.host.bvh.sbvh import sbvh_impl_tag
from ntrace_tpu_torch.kernels.build import build
from ntrace_tpu_torch.ops.pscan import OPS, row_scan_i32, row_scan_i32_ref
from ntrace_tpu_torch.ray import raygen
from ntrace_tpu_torch.ray.pixeltable import pixel_table
from ntrace_tpu_torch.render.renderer import Renderer, build_accel
from ntrace_tpu_torch.tables import tables_from_packed
from ntrace_tpu_torch.trace import binraster_dense as bd
from ntrace_tpu_torch.trace.packet import trace_packet, trace_packet_ref
from ntrace_tpu_torch.trace.packet_ifif import (trace_packet_ifif,
                                                trace_packet_ifif_ref)
from ntrace_tpu_torch.trace.packet_common import read_bytes, work_with_reads
from ntrace_tpu_torch.trace.packet_ww import (trace_packet_ww,
                                              trace_packet_ww_ref)
from ntrace_tpu_torch.utils.timing import cuda_ms

KERNEL_SOURCE = "ntrace_tpu_torch/csrc/packet_trace.cu"
KERNEL_REPLACES = "ntrace_tpu/trace/packet_pallas.py:99"
DENSE_SOURCE = "ntrace_tpu_torch/csrc/dense_trace.cu"
DENSE_REPLACES = {"walk": "ntrace_tpu/trace/binraster_dense.py:757",
                  "dma": "ntrace_tpu/trace/binraster_dense.py:1022"}
SCAN_SOURCE = "ntrace_tpu_torch/csrc/row_scan.cu"
SCAN_REPLACES = "ntrace_tpu/ops/pscan.py:33"
# The traversal engines of the secondary slice: kernel wrapper, twin,
# source and the TPU kernel each replaces.
ENGINES = {
    "packet": (trace_packet, trace_packet_ref, KERNEL_SOURCE,
               KERNEL_REPLACES),
    "packet_ww": (trace_packet_ww, trace_packet_ww_ref,
                  "ntrace_tpu_torch/csrc/packet_ww.cu",
                  "ntrace_tpu/trace/packet_ww.py:55"),
    "packet_ifif": (trace_packet_ifif, trace_packet_ifif_ref,
                    "ntrace_tpu_torch/csrc/packet_ifif.cu",
                    "ntrace_tpu/trace/packet_ifif.py:54"),
}
VARIANTS = ("packet_ww", "packet_ifif")
SECONDARY_MODES = ("shadow", "ao", "diffuse", "path")
SAMPLE_RAYS = 65_536          # stride sample of a batch for twin checks
ANYHIT_RAYS = 256             # rays of an any-hit pass vs brute_force_anyhit
HAIR_AO_RAYS = 128
SCENE_TRIS = 280_000          # get_scene("conference") -> 297,024 tris
HAIRBALL_TRIS = 2_900_000     # get_scene("hairball") -> 2,900,402 tris
LBVH_CFG = BuildConfig(builder="lbvh", max_leaf_size=32, sah_tri_cost=0.02)
WIDTH, HEIGHT = 1024, 768
GOLDEN_RAYS = 4096
BRUTE_RAYS = 256
# The bound of a kernel's row: NVIDIA's H100 SXM data sheet, full 700 W
# power limit: 3.35 TB/s of HBM, 67 TFLOP/s of FP32 outside the tensor
# cores. Per-test FP32 operations (min, max and compares counted, a
# division as one, the running-minimum fold not counted): a packet node
# visit is two slab tests of 12 subtracts and multiplies, 12 min/max and a
# compare each (trace/packet_common.py:slab_child); a Moller-Trumbore test
# of one ray and one triangle slot is 51 (mt_row_best, and
# csrc/dense_trace.cu:test_tile for the dense kernels).
HBM_BYTES_PER_MS = 3.35e9
FP32_OPS_PER_MS = 67e9
NODE_VISIT_OPS = 50
MT_OPS = 51


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the FP32 rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_MS, ops / FP32_OPS_PER_MS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def log(msg: str):
    print(msg, flush=True)


def random_rays(rng, n, extent=12.0):
    """Rays from a shell around the scene toward its middle (numpy)."""
    orig = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    d = rng.uniform(-extent / 3, extent / 3, size=(n, 3)) - orig
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return (orig, d, np.zeros((n,), np.float32),
            np.full((n,), 1e9, np.float32))


def compare(kern, twin, label):
    """Closest-hit (tri, t, u, v) of kernel and twin, bit-equal on every
    ray, hits and misses alike. Returns the max abs error, 0.0."""
    bad = [name for name, a, b in zip("tri t u v".split(), kern, twin)
           if not torch.equal(a, b)]
    if bad:
        n = int(torch.stack([a != b for a, b in zip(kern, twin)])
                .any(0).sum())
        raise AssertionError(f"{label}: {', '.join(bad)} differ on {n} rays")
    return 0.0


def phase_soup(device):
    """Phase 3: kernel against twin (and brute force) on a random soup."""
    soup = make_random_soup(n_tris=5000, seed=11)
    flat = build_accel(soup, BuildConfig(builder="binned_sah"))
    rays_np = random_rays(np.random.default_rng(2024), 65_536)
    rays = [torch.from_numpy(a).to(device) for a in rays_np]
    shadow = rays[:3] + [torch.full_like(rays[3], 14.0)]
    sub = np.arange(0, 65_536, 16)
    bf = brute_force_mt(soup, *(a[sub] for a in rays_np))
    for tpr, npr in ((12, 1), (4, 8)):
        tables = tables_from_packed(
            pack_bvh(flat, soup.tri_verts(), tris_per_row=tpr,
                     nodes_per_row=npr), device)
        label = f"soup tpr={tpr} npr={npr}"
        kern = trace_packet(tables, *rays)
        compare(kern, trace_packet_ref(tables, *rays), label)
        if not np.array_equal(kern[0].cpu().numpy()[sub], bf.tri):
            raise AssertionError(f"{label}: tri differs from brute_force_mt")
        ka = trace_packet(tables, *shadow, any_hit=True)
        ta = trace_packet_ref(tables, *shadow, any_hit=True)
        if not torch.equal(ka[0] >= 0, ta[0] >= 0):
            raise AssertionError(f"{label}: any-hit tri>=0 differs")
        log(f"[3] {label}: closest-hit tri/t/u/v bit-equal vs twin on "
            f"all 65536 rays, misses included (hit rate "
            f"{float((kern[0] >= 0).float().mean()):.3f}); tri exact vs "
            f"brute_force_mt on {len(sub)}; any-hit tri>=0 equal "
            f"(blocked {float((ka[0] >= 0).float().mean()):.3f}, tri "
            f"{'identical' if torch.equal(ka[0], ta[0]) else 'differs'})")


def phase_soup_variants(device):
    """Phase 9, first check: the phase-3 soup for packet_ww and
    packet_ifif. Closest hit and any hit bit-equal to the twin (any-hit tri
    included) at layouts (12, 1) and (4, 8); closest hits equal to the
    packet kernel's on every ray and exact against brute_force_mt; any-hit
    tri >= 0 against brute_force_anyhit."""
    soup = make_random_soup(n_tris=5000, seed=11)
    flat = build_accel(soup, BuildConfig(builder="binned_sah"))
    rays_np = random_rays(np.random.default_rng(2024), 65_536)
    rays = [torch.from_numpy(a).to(device) for a in rays_np]
    shadow = rays[:3] + [torch.full_like(rays[3], 14.0)]
    sub = np.arange(0, 65_536, 16)
    bf = brute_force_mt(soup, *(a[sub] for a in rays_np))
    blocked = brute_force_anyhit(soup, *(a[sub] for a in rays_np[:3]),
                                 np.full(len(sub), 14.0, np.float32))
    for tpr, npr in ((12, 1), (4, 8)):
        tables = tables_from_packed(
            pack_bvh(flat, soup.tri_verts(), tris_per_row=tpr,
                     nodes_per_row=npr), device)
        packet = trace_packet(tables, *rays)
        for name in VARIANTS:
            kernel, twin = ENGINES[name][:2]
            label = f"soup {name} tpr={tpr} npr={npr}"
            kern = kernel(tables, *rays)
            compare(kern, twin(tables, *rays), f"{label} vs twin")
            compare(kern, packet, f"{label} vs packet kernel")
            if not np.array_equal(kern[0].cpu().numpy()[sub], bf.tri):
                raise AssertionError(f"{label}: tri differs from "
                                     "brute_force_mt")
            ka = kernel(tables, *shadow, any_hit=True)
            compare(ka, twin(tables, *shadow, any_hit=True),
                    f"{label} any-hit vs twin")
            if not np.array_equal(ka[0].cpu().numpy()[sub] >= 0, blocked):
                raise AssertionError(f"{label}: any-hit tri>=0 differs from "
                                     "brute_force_anyhit")
            log(f"[9] {label}: closest hit bit-equal to the twin and to the "
                f"packet kernel on all 65536 rays; any hit bit-equal to the "
                f"twin (tri included, blocked "
                f"{float((ka[0] >= 0).float().mean()):.3f}); exact vs "
                f"brute_force_mt and brute_force_anyhit on {len(sub)}")


def phase_main_path(device, n_tris=SCENE_TRIS, width=WIDTH, height=HEIGHT):
    """Phase 4: the port's main path at full size, plus golden checks."""
    t0 = time.perf_counter()
    scene = get_scene("conference", n_tris=n_tris)
    build_cfg = BuildConfig(builder="binned_sah", sah_tri_cost=0.02,
                            max_leaf_size=48)
    impl = sbvh_impl_tag(scene.num_tris, build_cfg)
    if n_tris == SCENE_TRIS and impl != "native":
        raise AssertionError("the native binned-SAH builder "
                             "(host/native/sbvh.cpp) did not build or load")
    flat = build_accel(scene, build_cfg)
    cfg = RenderConfig(width=width, height=height, mode="primary")
    r = Renderer(scene, build_cfg, cfg, flat=flat, device=device)
    tb = r.tables
    log(f"[4] scene {scene.name} tris={scene.num_tris} nodes={tb.num_nodes} "
        f"{impl} binned-SAH engine={r.engine} layout tpr={tb.tris_per_row} "
        f"npr={tb.nodes_per_row} tables {tb.nbytes() / 1e6:.1f} MB "
        f"(nodes8 {tuple(tb.nodes8.shape)}, tris12 {tuple(tb.tris12.shape)})"
        f"; set-up {time.perf_counter() - t0:.1f} s")

    camera = default_camera("conference")
    trace_packet.launches = 0
    res = r.render(camera)
    launches = trace_packet.launches
    if launches < 1:
        raise AssertionError("the main path did not launch the kernel")
    img = res.image
    if img.shape != (height, width, 3) or not np.isfinite(img).all():
        raise AssertionError(f"bad image {img.shape}")
    if not img.max() > 0:
        raise AssertionError("image is all black")
    hit_rate = float((res.hit_tri >= 0).mean())
    log(f"[4] render: {launches} kernel launch(es), image {img.shape} "
        f"mean {img.mean():.4f}, hit rate {hit_rate:.4f}, stages "
        + json.dumps({k: round(v, 3) for k, v in res.stats.items()}))

    # The same rays again, to hold the frame against the host oracles.
    order, _ = pixel_table(width, height)
    batch = raygen.primary(raygen.camera_arrays(camera, width, height, device),
                           width, height, torch.from_numpy(order.copy()))
    check_oracles("[4]", scene, flat, res, batch, order)
    return r, batch, launches


def check_oracles(tag, scene, flat, res, batch, order):
    """A frame's hits (pixel order) against trace_cpu_golden on 4,096
    stride-sampled rays (0 tie-aware mismatches) and brute_force_mt on
    256 (exact tri)."""
    slot = order.astype(np.int64)
    tri_slot, t_slot = res.hit_tri[slot], res.hit_t[slot]
    host = [a.cpu().numpy() for a in (batch.orig, batch.dirn, batch.tmin,
                                      batch.tmax)]
    R = batch.num_rays
    sub = np.arange(0, R, max(R // GOLDEN_RAYS, 1))
    rec = trace_cpu_golden(flat, *(a[sub] for a in host))
    mism = golden_mismatches(tri_slot[sub], t_slot[sub], rec.tri, rec.t)
    raw = int((tri_slot[sub] != rec.tri).sum())
    if mism != 0:
        raise AssertionError(f"{mism} tie-aware golden mismatches")
    sub = np.arange(0, R, max(R // BRUTE_RAYS, 1))
    bf = brute_force_mt(scene, *(a[sub] for a in host))
    bf_diff = int((tri_slot[sub] != bf.tri).sum())
    if bf_diff:
        raise AssertionError(f"tri differs from brute_force_mt on {bf_diff}")
    log(f"{tag} golden: 0 tie-aware mismatches on {len(rec.tri)} rays vs "
        f"trace_cpu_golden ({raw} raw id differences); tri exact vs "
        f"brute_force_mt on {len(sub)} rays")


def phase_timing(r, batch, smi):
    """Phase 5: full-frame kernel and twin times; kernel vs twin."""
    rays = (batch.orig, batch.dirn, batch.tmin, batch.tmax)
    R = batch.num_rays
    kern_ms = cuda_ms(lambda: r.trace_primary(*rays), warmup=2, iters=10)
    ms = statistics.median(kern_ms)
    log(f"[5] kernel: Renderer.trace_primary full frame {R} rays: median "
        f"{ms:.3f} ms of 10 warm (min {min(kern_ms):.3f}, max "
        f"{max(kern_ms):.3f}) = {R / ms / 1e3:.2f} Mrays/s on {smi}")

    n_b2b = 20
    b2b = cuda_ms(lambda: [trace_packet(r.tables, *rays)
                           for _ in range(n_b2b)], warmup=1, iters=5)
    per_launch = statistics.median(b2b) / n_b2b
    log(f"[5] kernel alone: {n_b2b} back-to-back trace_packet launches: "
        f"{per_launch:.3f} ms per launch (median of 5 runs) = "
        f"{R / per_launch / 1e3:.2f} Mrays/s on {smi}")

    kern = r.trace_primary(*rays)
    twin_out = []
    twin_ms = cuda_ms(lambda: twin_out.append(
        trace_packet_ref(r.tables, *rays)), warmup=0, iters=3)
    plain_ms = statistics.median(twin_ms)
    err = compare(kern, twin_out[0], "full frame")
    log(f"[5] twin: trace_packet_ref full frame {R} rays: median "
        f"{plain_ms:.1f} ms of 3 (first cold; "
        + ", ".join(f"{t:.1f}" for t in twin_ms)
        + f") = {R / plain_ms / 1e3:.3f} Mrays/s on {smi}; kernel "
        f"tri/t/u/v bit-equal to the twin on every ray")
    profile_render(r, smi)
    torch.cuda.synchronize()
    return ms, plain_ms, err


def traversal_bound(tables, rays, works, scale=1.0):
    """The bound of one batch of rays, the same for every schedule that
    traces it: the least, over `works` (schedule -> its twin's work on
    these rays, from work_with_reads, counts to be multiplied by `scale`),
    of the larger of the bytes over the HBM rate and the FP32 operations
    over the FP32 rate. Bytes: the rays read and (tri, t, u, v) written
    once, and each node record and triangle row that the twin read, once
    (for a twin run on a sample, what the sample read: no more than the
    batch reads). Returns (bound_ms, bound_by, schedule)."""
    R = rays[0].shape[0]
    best = None
    for engine, w in works.items():
        ops = (w["node_visits"] * NODE_VISIT_OPS
               + w["tri_slot_tests"] * MT_OPS) * scale
        b = bound(nbytes(*rays) + 16 * R + read_bytes(tables, w), ops)
        if best is None or b[0] < best[0]:
            best = (*b, engine)
    return best


def profile_render(r, smi, tag="[5]"):
    """One warm render() under torch.profiler: device time by kernel and
    the device's busy share of the frame's wall time."""
    camera = default_camera("conference")
    warm = r.render(camera)
    log(f"{tag} warm render() stages without profiler (ms) on {smi}: "
        + json.dumps({k: round(v, 3) for k, v in warm.stats.items()}))
    profile_once(f"{tag} profile of one warm render()",
                 lambda: r.render(camera), smi)


def profile_once(label, fn, smi, top=8):
    """One call of fn() under torch.profiler: its wall time, the device's
    busy time and share of it, and the device time of the top kernels."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels, memcpys): a CPU op such as
    # aten::copy_ also carries its kernels' device time.
    dev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in dev)
    log(f"{label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%) on {smi}; top: "
        + "; ".join(f"{k[:60]} x{n} {ms:.3f} ms" for k, ms, n in dev[:top]))
    return dev


def dense_render(rd, kernel):
    """The dense main path with `kernel`: render() once, the launch and
    prep counts set to 0 just before it and read just after."""
    rd.dense_kernel = kernel
    trace_packet.launches = 0
    bd.trace_dense_rows.launches = 0
    bd.trace_dense_rows_dma.launches = 0
    bd.binraster_prep_dense5.calls = 0
    res = rd.render(default_camera("conference"))
    counts = {"walk": bd.trace_dense_rows.launches,
              "dma": bd.trace_dense_rows_dma.launches,
              "packet": trace_packet.launches,
              "prep": bd.binraster_prep_dense5.calls}
    if rd._br is None:
        raise AssertionError(f"render ({kernel}) did not arm the dense "
                             "engine")
    if counts["prep"] < 1 or counts["packet"]:
        raise AssertionError(f"render ({kernel}) ran no prep, or traced "
                             f"with the packet kernel: {counts}")
    img = res.image
    if img.shape != (rd.cfg.height, rd.cfg.width, 3) \
            or not np.isfinite(img).all() or not img.max() > 0:
        raise AssertionError(f"render ({kernel}): bad or black image")
    if (res.hit_tri == -2).any():
        raise AssertionError(f"render ({kernel}): -2 poison, the prep's "
                             "static sizes did not hold")
    log(f"[6] render ({kernel}): counts {json.dumps(counts)}, image mean "
        f"{img.mean():.4f}, hit rate {(res.hit_tri >= 0).mean():.4f}, "
        "stages " + json.dumps({k: round(v, 3) for k, v in res.stats.items()}))
    return res, counts[kernel]


def phase_dense(r, batch):
    """Phase 6 checks: the dense engine's main path (walk, then dma) on
    phase 4's scene, BVH and camera; both kernels against the twin on the
    frozen full-frame structure; the oracles; dense against packet.
    Returns the dense renderer, its camera, the frozen kernel operands and
    keywords, and launches and max abs errors by kernel."""
    W, H = r.cfg.width, r.cfg.height
    cfg = RenderConfig(width=W, height=H, mode="primary",
                       engine="binraster_dense")
    rd = Renderer(r.scene, BuildConfig(), cfg, flat=r.flat, device=r.device)
    camera = default_camera("conference")
    ca = raygen.camera_arrays(camera, W, H, r.device)
    if not rd.prepare_primary(ca, W, H):
        raise AssertionError("prepare_primary declined the conference frame")
    res, walk_launches = dense_render(rd, "walk")
    res_dma, dma_launches = dense_render(rd, "dma")
    if not (np.array_equal(res.hit_tri, res_dma.hit_tri)
            and np.array_equal(res.image, res_dma.image)):
        raise AssertionError("dense render: walk and dma frames differ")
    order, _ = pixel_table(W, H)
    check_oracles("[6]", r.scene, r.flat, res, batch, order)

    rd.dense_kernel = "walk"
    if not rd.prepare_primary(ca, W, H):
        raise AssertionError("prepare_primary declined the conference frame")
    rd.freeze_primary_structure(ca)
    c = rd._br
    rows, r0, r1, g1, ok = c["frozen"]
    if not bool(ok):
        raise AssertionError("prep v5: ok is False on the conference frame")
    g = 0 if g1 is None else int(g1[0])
    visits = int((r1 - r0).clamp_min(0).sum()) + c["nb"] * g
    log(f"[6] structure: p_max {c['p_max']}, g2_max {c['g2_max']}, "
        f"global tiles {g}, {rows.shape[0] // bd.GPT} tiles "
        f"({rows.numel() * 4 / 1e6:.1f} MB), {c['nb']} bins of "
        f"{c['ray_rows'] * 128} rays, {visits} (bin, tile) visits, "
        f"{len(c['n_ks'])} prefix slices")
    dirs, scalars = bd.dense_rays(batch.dirn, ca["pos"], batch.tmin[0],
                                  batch.tmax[0], c["nb"], c["ray_rows"])
    ops = (rows, r0, r1, dirs, scalars, g1)
    kw = dict(n_bins=c["nb"], ray_rows=c["ray_rows"])
    twin = bd.trace_dense_rows_ref(*ops, **kw)
    walk0 = bd.trace_dense_rows(*ops, ez_chunk=0, **kw)
    walk4 = bd.trace_dense_rows(*ops, ez_chunk=4, **kw)
    dma = bd.trace_dense_rows_dma(*ops, **kw)
    if rd.device.type == "cuda":
        torch.cuda.synchronize()   # a fault in a kernel surfaces here
    errs = {"walk": max(compare(walk0, twin, "dense walk ez_chunk=0 vs twin"),
                        compare(walk4, twin, "dense walk ez_chunk=4 vs twin")),
            "dma": compare(dma, twin, "dense dma vs twin")}
    compare(dma, walk0, "dense dma vs walk")
    R = batch.num_rays
    log(f"[6] kernels: walk (ez_chunk 0 and 4) and dma tri/t/u/v bit-equal "
        f"to trace_dense_rows_ref on all {R} rays, misses included (hit "
        f"rate {float((walk0[0] >= 0).float().mean()):.4f})")

    packet_tri = trace_packet(r.tables, batch.orig, batch.dirn, batch.tmin,
                              batch.tmax)[0]
    diff = torch.nonzero(packet_tri != walk0[0]).squeeze(1).cpu().numpy()
    if len(diff):
        host = [a.cpu().numpy()[diff] for a in (batch.orig, batch.dirn,
                                                batch.tmin, batch.tmax)]
        bf = brute_force_mt(r.scene, *host)
        lost = int((walk0[0].cpu().numpy()[diff] != bf.tri).sum())
        if lost:
            raise AssertionError(f"dense vs packet: brute_force_mt sides "
                                 f"with packet on {lost} of {len(diff)} rays")
    log(f"[6] dense vs packet kernel on all {R} rays: tri differs on "
        f"{len(diff)} rays" + (", each decided by brute_force_mt for the "
                               "dense engine" if len(diff) else ""))
    launches = {"walk": walk_launches, "dma": dma_launches}
    # The bound of either kernel (ez_chunk 0 walks every visit): each
    # visit tests its bin's rays against the tile's triangles.
    pairs = visits * c["ray_rows"] * 128 * bd.TPT
    bnd = bound(nbytes(*ops) + 16 * R, pairs * MT_OPS)
    log(f"[6] dense kernel work: {pairs} ray-triangle pair tests, "
        f"{pairs * MT_OPS:.4g} FP32 operations; bound {bnd[0]:.4f} ms by "
        f"{bnd[1]}")
    return rd, ca, ops, kw, launches, errs, bnd


def phase_dense_timing(rd, ca, batch, ops, kw, smi):
    """Phase 6 times, CUDA events, warm: kernels and twin on the frozen
    structure, the frame with the structure frozen, the prep (count passes
    plus prep v5), the frame with the prep, and the render stages."""
    W, H = rd.cfg.width, rd.cfg.height
    rays = (batch.orig, batch.dirn, batch.tmin, batch.tmax)
    R = batch.num_rays

    def med(name, fn, iters=10, warmup=2):
        times = cuda_ms(fn, warmup=warmup, iters=iters)
        ms = statistics.median(times)
        log(f"[6] {name}: median {ms:.3f} ms of {iters} (min "
            f"{min(times):.3f}, max {max(times):.3f}) on {smi}")
        return ms

    ms = {
        "walk": med("trace_dense_rows (walk, ez_chunk 0) frozen frame",
                    lambda: bd.trace_dense_rows(*ops, ez_chunk=0, **kw)),
        "walk_ez4": med("trace_dense_rows (walk, ez_chunk 4) frozen frame",
                        lambda: bd.trace_dense_rows(*ops, ez_chunk=4, **kw)),
        "dma": med("trace_dense_rows_dma frozen frame",
                   lambda: bd.trace_dense_rows_dma(*ops, **kw)),
        "twin": med("trace_dense_rows_ref (twin) frozen frame",
                    lambda: bd.trace_dense_rows_ref(*ops, **kw), iters=3,
                    warmup=0),
    }
    frozen = med("frame, structure frozen: trace_primary",
                 lambda: rd.trace_primary(*rays, cam=ca, canonical=True))

    def prep():
        rd.prepare_primary(ca, W, H)
        return rd._dense_prep(ca)

    ms["prep"] = med("prep: prepare_primary (count passes) + prep v5", prep)
    if not rd.prepare_primary(ca, W, H):
        raise AssertionError("prepare_primary declined the conference frame")
    med("prep v5 alone (the structure build)", lambda: rd._dense_prep(ca))
    full = med("frame with the prep: trace_primary",
               lambda: rd.trace_primary(*rays, cam=ca, canonical=True))
    log(f"[6] frame: {R / frozen / 1e3:.2f} Mrays/s with the structure "
        f"frozen, {R / full / 1e3:.2f} Mrays/s with the prep in the frame; "
        f"walk kernel {R / ms['walk'] / 1e3:.2f} Mrays/s, twin / walk "
        f"{ms['twin'] / ms['walk']:.1f}x")
    profile_render(rd, smi, tag="[6]")
    torch.cuda.synchronize()
    return ms


def phase_scan_kernel(device):
    """Phase 7: the row-scan kernel against its plain version on random
    (R, n) int32, uniform over the whole range and as random walks (whose
    extrema move across tiles), every op and direction. Returns the max
    abs error, 0.0."""
    rng = np.random.default_rng(77)
    cases = 0
    for R in (1, 8, 31):
        for n in (1, 257, 8193, 297_024):
            walk = (np.cumsum(rng.integers(-100, 101, size=(R, n)), axis=1)
                    + rng.integers(-2 ** 30, 2 ** 30, size=(R, 1)))
            uniform = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(R, n))
            for x in (walk, uniform):
                x = torch.from_numpy(x.astype(np.int32)).to(device)
                for op in OPS:
                    for rev in (False, True):
                        got = row_scan_i32(x, op=op, reverse=rev)
                        want = row_scan_i32_ref(x, op=op, reverse=rev)
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"row scan {op} reverse={rev} on {(R, n)}: "
                                f"{int((got != want).sum())} values differ")
                        cases += 1
    log(f"[7] row scan: kernel bit-equal to row_scan_i32_ref in {cases} "
        "cases: R in (1, 8, 31), n in (1, 257, 8193, 297024), uniform and "
        "random-walk rows, max and min, forward and reverse")
    return 0.0


def _bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def check_packed(p, n: int, tag: str):
    """Structure of a packed LBVH (one node per row): the internal links
    name every row but the root (row 0) once, every leaf's rows lie in the
    table, and every triangle id sits in exactly one slot."""
    nc, tpr = p.num_nodes, p.tris_per_row
    rec = p.nodes8[:nc, :16]
    links, cnts = rec[:, 12:14], rec[:, 14:16]
    inner = links >= 0
    kids = torch.sort(links[inner].long()).values
    if not torch.equal(kids, torch.arange(1, nc, device=kids.device)):
        raise AssertionError(f"{tag}: internal links do not name rows "
                             f"1..{nc - 1} once each")
    rows0 = (-links[~inner] - 1).long()
    rows = cnts[~inner].long()
    tr = -(-n // tpr)
    if int(rows0.min()) < 0 or int(rows.min()) < 1 \
            or int((rows0 + rows).max()) > tr:
        raise AssertionError(f"{tag}: a leaf's rows leave the {tr}-row "
                             "triangle table")
    ids = p.tris12[:, :tpr * 10].reshape(-1, 10)[:, 9]
    ids = torch.sort(ids[ids >= 0].long()).values
    if not torch.equal(ids, torch.arange(n, device=ids.device)):
        raise AssertionError(f"{tag}: triangle ids are not each in one slot")
    log(f"{tag} structure: {nc} nodes, root at row 0, {nc - 1} internal "
        f"links each naming one row, {int((~inner).sum())} leaf links "
        f"inside the {tr}-row table, all {n} triangle ids once each")


def phase_lbvh_builds(device, conf, hair_tris=HAIRBALL_TRIS):
    """Phase 7 checks of the build: the conference build on the card
    bit-equal to the same build on the CPU (through the plain scan), the
    hairball build's two ANSV scans through kernel and plain version, and
    the structure of the hairball build. Returns the inputs on the card
    of both scenes and the hairball scene."""
    ml = LBVH_CFG.max_leaf_size
    t0 = time.perf_counter()
    conf_dev = lbvh.device_inputs(conf, device)
    gpu = lbvh.lbvh_device_fast(*conf_dev, max_leaf=ml, emit="packed")
    cpu = lbvh.lbvh_device_fast(*lbvh.device_inputs(conf, "cpu"),
                                max_leaf=ml, emit="packed")
    keys = ("pnodes", "ptris", "node_count", "leaf_count", "order", "kept")
    bad = [k for k in keys if not _bit_equal(gpu[k], cpu[k])]
    if bad:
        raise AssertionError(f"conference LBVH: the card's build differs "
                             f"from the CPU's in {bad}")
    log(f"[7] conference LBVH ({conf.num_tris} tris, max_leaf {ml}): card "
        f"build bit-equal to the CPU build in {', '.join(keys)}; "
        f"{int(gpu['node_count'])} nodes (cap {gpu['cap']}), "
        f"{int(gpu['leaf_count'])} leaves; "
        f"{time.perf_counter() - t0:.1f} s with the CPU build")
    check_packed(lbvh.build_packed_from(conf_dev, ml), conf.num_tris, "[7]")

    t0 = time.perf_counter()
    hair = get_scene("hairball", n_tris=hair_tris)
    hair_dev = lbvh.device_inputs(hair, device)
    log(f"[7] hairball: {hair.num_tris} tris, scene and upload "
        f"{time.perf_counter() - t0:.1f} s")
    D = lbvh.split_levels(lbvh.morton_sort(*hair_dev)[0])
    got = lbvh.ansv_scans(D)
    want = lbvh.ansv_scans(D, row_scan_i32_ref)
    for name, a, b in zip(("forward cummax", "reverse cummin"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"hairball ANSV {name}: kernel differs from "
                                 f"the plain version on "
                                 f"{int((a != b).sum())} values")
    log(f"[7] hairball ANSV scans {tuple(got[0].shape)}: forward cummax and "
        "reverse cummin bit-equal to row_scan_i32_ref")
    del got, want, D
    check_packed(lbvh.build_packed_from(hair_dev, ml), hair.num_tris,
                 "[7] hairball")
    return conf_dev, hair_dev, hair


def phase_lbvh_frame(r, batch):
    """Phase 7, the LBVH main path: Renderer(builder="lbvh") builds the
    packet tables on the card and render() traces them; the row-scan and
    packet counts are set to 0 just before and read just after. Then the
    oracles, and phase 4's binned-SAH frame on every ray, brute_force_mt
    deciding any difference. Returns the renderer and the counts."""
    W, H = r.cfg.width, r.cfg.height
    camera = default_camera("conference")
    sah = r.render(camera)
    row_scan_i32.launches = 0
    trace_packet.launches = 0
    rl = Renderer(r.scene, LBVH_CFG, RenderConfig(width=W, height=H,
                                                  mode="primary",
                                                  engine="auto"),
                  device=r.device)
    res = rl.render(camera)
    counts = {"row_scan": row_scan_i32.launches,
              "packet": trace_packet.launches}
    if rl.flat is not None or rl.tables.device.type != r.device.type:
        raise AssertionError("builder='lbvh' did not build its tables on "
                             "the card")
    if counts["row_scan"] < 2 or counts["packet"] < 1:
        raise AssertionError(f"the LBVH path skipped a kernel: {counts}")
    img = res.image
    if img.shape != (H, W, 3) or not np.isfinite(img).all() \
            or not img.max() > 0:
        raise AssertionError("LBVH render: bad or black image")
    log(f"[7] LBVH render: counts {json.dumps(counts)}, "
        f"{rl.tables.num_nodes} nodes, tables {rl.tables.nbytes() / 1e6:.1f}"
        f" MB, image mean {img.mean():.4f}, hit rate "
        f"{(res.hit_tri >= 0).mean():.4f}, build {rl.timer.ms()['build']:.1f}"
        " ms, stages "
        + json.dumps({k: round(v, 3) for k, v in res.stats.items()}))
    order, _ = pixel_table(W, H)
    check_oracles("[7]", r.scene, r.flat, res, batch, order)

    slot = order.astype(np.int64)
    tri_l, tri_s = res.hit_tri[slot], sah.hit_tri[slot]
    diff = np.nonzero(tri_l != tri_s)[0]
    if len(diff):
        host = [a.cpu().numpy()[diff] for a in (batch.orig, batch.dirn,
                                                batch.tmin, batch.tmax)]
        bf = brute_force_mt(r.scene, *host)
        wrong = int((tri_l[diff] != bf.tri).sum())
        if wrong:
            raise AssertionError(f"LBVH vs binned-SAH frame: brute_force_mt "
                                 f"sides with SAH on {wrong} of {len(diff)} "
                                 "rays")
    log(f"[7] LBVH vs binned-SAH frame on all {len(slot)} rays: tri differs "
        f"on {len(diff)}" + (", each decided by brute_force_mt for LBVH"
                             if len(diff) else ""))
    return rl, counts


def phase_lbvh_timing(rl, batch, conf_dev, hair_dev, smi):
    """Phase 7 times, CUDA events, warm, medians of 10: the packed build at
    both sizes (with its node_count read), each row-scan launch on the
    build's real ANSV inputs beside torch.cummax and the plain version,
    and the LBVH frame's trace_primary."""
    ml = LBVH_CFG.max_leaf_size

    def med(name, fn, iters=10, warmup=2):
        times = cuda_ms(fn, warmup=warmup, iters=iters)
        ms = statistics.median(times)
        log(f"[7] {name}: median {ms:.4f} ms of {iters} (min "
            f"{min(times):.4f}, max {max(times):.4f}) on {smi}")
        return ms

    out = {}
    for size, args in (("conference", conf_dev), ("hairball", hair_dev)):
        n = args[0].shape[0]
        build_ms = med(f"{size} packed build, {n} tris",
                       lambda: lbvh.build_packed_from(args, ml))
        log(f"[7] {size} build: {build_ms / (n / 1e6):.3f} ms/Mtri")
        profile_once(f"[7] profile of one warm {size} build",
                     lambda: lbvh.build_packed_from(args, ml), smi, top=10)
        D = lbvh.split_levels(lbvh.morton_sort(*args)[0])
        xmax, xmin = lbvh.ansv_inputs(D)
        # One read and one write of R*n int32, one compare per element.
        t = {"build": build_ms, "n": n,
             "bound": bound(2 * nbytes(xmax), xmax.numel())}
        t["max"] = med(f"{size} row_scan_i32 max {tuple(xmax.shape)}",
                       lambda: row_scan_i32(xmax, op="max"))
        t["min_rev"] = med(f"{size} row_scan_i32 min reverse",
                           lambda: row_scan_i32(xmin, op="min", reverse=True))
        t["library"] = med(f"{size} torch.cummax(x, 1).values",
                           lambda: torch.cummax(xmax, 1).values)
        t["plain"] = med(f"{size} row_scan_i32_ref max",
                         lambda: row_scan_i32_ref(xmax, op="max"))
        t["plain_min_rev"] = med(
            f"{size} row_scan_i32_ref min reverse",
            lambda: row_scan_i32_ref(xmin, op="min", reverse=True))
        # The device time of the kernel's two passes alone, without the
        # wrapper's host work that the CUDA events above also hold.
        reps = 10
        dev = profile_once(f"[7] profile of {reps} {size} row_scan_i32 max "
                           "launches",
                           lambda: [row_scan_i32(xmax, op="max")
                                    for _ in range(reps)], smi, top=4)
        passes = {p: sum(ms for k, ms, _ in dev if p in k) / reps
                  for p in ("row_tile_reduce", "row_tile_scan")}
        t["device"] = sum(passes.values()) or None
        log(f"[7] {size} row scan max per launch: device "
            + (f"{t['device']:.4f} ms (reduce "
               f"{passes['row_tile_reduce']:.4f}, scan "
               f"{passes['row_tile_scan']:.4f}; profiler)"
               if t["device"] else "time not measured (no profiler events)")
            + f" beside {t['max']:.4f} ms by CUDA events around the wrapper")
        b, by = t["bound"]
        log(f"[7] {size} row scan bound {b:.4f} ms by {by} "
            f"({2 * nbytes(xmax) / 1e6:.1f} MB at 3.35 TB/s); the max scan "
            f"takes {t['max'] / b:.2f}x the bound")
        out[size] = t
        del D, xmax, xmin
    rays = (batch.orig, batch.dirn, batch.tmin, batch.tmax)
    out["trace"] = med("LBVH frame: Renderer.trace_primary",
                       lambda: rl.trace_primary(*rays))
    b2b = cuda_ms(lambda: [trace_packet(rl.tables, *rays)
                           for _ in range(20)], warmup=1, iters=5)
    log(f"[7] LBVH frame: 20 back-to-back trace_packet launches: "
        f"{statistics.median(b2b) / 20:.4f} ms per launch (median of 5 "
        f"runs) on {smi}")
    work = work_with_reads(rl.tables)
    trace_packet_ref(rl.tables, *rays, work=work)
    b, by, _ = traversal_bound(rl.tables, rays, {"packet": work})
    log(f"[7] LBVH frame: packet kernel work {work['node_visits']} node "
        f"visits, {work['tri_slot_tests']} triangle slot tests; bound "
        f"{b:.4f} ms by {by}")
    torch.cuda.synchronize()
    return out


# -- phases 8-10: the secondary passes -------------------------------------

PASSES = {"shadow": ("primary", "shadow"), "ao": ("primary", "ao"),
          "diffuse": ("primary", "diffuse"),
          "path": ("primary", "bounce0", "bounce1")}


def reset_counts():
    for kernel, *_ in ENGINES.values():
        kernel.launches = 0
    row_scan_i32.launches = 0


def launch_counts() -> dict:
    return {**{name: e[0].launches for name, e in ENGINES.items()},
            "row_scan": row_scan_i32.launches}


@contextmanager
def recorded(r):
    """Keep every pass the renderer traces, as (rays, any_hit, hits) in the
    order render() traces them. The tracer is the renderer's own; this
    only records its inputs and outputs."""
    passes = []
    base = r._tracer

    def tracer(o, d, tn, tx, any_hit):
        out = base(o, d, tn, tx, any_hit)
        passes.append(((o, d, tn, tx), any_hit, out))
        return out

    r._tracer = tracer
    try:
        yield passes
    finally:
        r._tracer = base


def check_image(tag, img, width, height):
    if img.shape != (height, width, 3) or not np.isfinite(img).all() \
            or not img.max() > 0:
        raise AssertionError(f"{tag}: bad or black image")


def check_pass(tag, scene, flat, rays, any_hit, hits):
    """One traced pass against the CPU oracles: any hit, tri >= 0 against
    brute_force_anyhit on ANYHIT_RAYS stride-sampled rays; closest hit, 0
    tie-aware mismatches against trace_cpu_golden on GOLDEN_RAYS and exact
    tri against brute_force_mt on BRUTE_RAYS."""
    host = [a.cpu().numpy() for a in rays]
    tri, t = hits[0].cpu().numpy(), hits[1].cpu().numpy()
    R = len(tri)
    if any_hit:
        sub = np.arange(0, R, max(R // ANYHIT_RAYS, 1))
        blocked = brute_force_anyhit(scene, *(a[sub] for a in host))
        if not np.array_equal(tri[sub] >= 0, blocked):
            raise AssertionError(f"{tag}: any-hit tri>=0 differs from "
                                 f"brute_force_anyhit on "
                                 f"{int(((tri[sub] >= 0) != blocked).sum())}")
        log(f"{tag}: {R} rays, any hit; tri>=0 equal to brute_force_anyhit "
            f"on {len(sub)} (blocked {blocked.mean():.4f})")
        return
    sub = np.arange(0, R, max(R // GOLDEN_RAYS, 1))
    rec = trace_cpu_golden(flat, *(a[sub] for a in host))
    mism = golden_mismatches(tri[sub], t[sub], rec.tri, rec.t)
    if mism:
        raise AssertionError(f"{tag}: {mism} tie-aware golden mismatches")
    sub2 = np.arange(0, R, max(R // BRUTE_RAYS, 1))
    bf = brute_force_mt(scene, *(a[sub2] for a in host))
    if not np.array_equal(tri[sub2], bf.tri):
        raise AssertionError(f"{tag}: tri differs from brute_force_mt on "
                             f"{int((tri[sub2] != bf.tri).sum())}")
    log(f"{tag}: {R} rays, closest hit (hit rate {(tri >= 0).mean():.4f}); "
        f"0 tie-aware mismatches vs trace_cpu_golden on {len(sub)}; tri "
        f"exact vs brute_force_mt on {len(sub2)}")


def render_recorded(r, mode, camera):
    """render(mode) with the launch counts set to 0 just before and read
    just after; returns the result, the counts and the passes by name."""
    reset_counts()
    with recorded(r) as passes:
        res = r.render(camera, mode)
    counts = launch_counts()
    names = PASSES[mode]
    if len(passes) != len(names):
        raise AssertionError(f"render({mode}) traced {len(passes)} passes, "
                             f"want {names}")
    return res, counts, dict(zip(names, passes))


def phase_secondary(r, smi):
    """Phase 8: render() of every secondary mode on phase 4's renderer
    (engine packet), every traced pass held to the oracles; then one warm
    AO and one warm diffuse frame under the profiler. Returns the results
    and passes by mode."""
    camera = default_camera("conference")
    out = {}
    for mode in SECONDARY_MODES:
        res, counts, passes = render_recorded(r, mode, camera)
        if counts["packet"] != len(passes) or counts["packet_ww"] \
                or counts["packet_ifif"]:
            raise AssertionError(f"render({mode}): launches {counts}, want "
                                 f"{len(passes)} packet launches")
        check_image(f"[8] render({mode})", res.image, r.cfg.width,
                    r.cfg.height)
        log(f"[8] render({mode}): launches "
            + json.dumps({k: v for k, v in counts.items() if v})
            + f", image mean {res.image.mean():.4f}, stages "
            + json.dumps({k: round(v, 3) for k, v in res.stats.items()}))
        for name, (rays, any_hit, hits) in list(passes.items())[1:]:
            check_pass(f"[8] {mode} pass {name}", r.scene, r.flat, rays,
                       any_hit, hits)
        out[mode] = (res, passes)
    for mode in ("ao", "diffuse"):
        profile_once(f"[8] profile of one warm render({mode})",
                     lambda: r.render(camera, mode), smi, top=10)
    return out


def same_rays(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_variant_renders(r, secondary):
    """Phase 9: every secondary mode rendered with engine packet_ww and
    packet_ifif on phase 4's scene and BVH. Each pass traces the same rays
    as phase 8's; closest-hit passes equal phase 8's on tri/t/u/v on every
    ray, any-hit passes on tri >= 0; images bit-equal. Returns the
    launches of each kernel over its four renders."""
    camera = default_camera("conference")
    launches = {}
    for name in VARIANTS:
        cfg = RenderConfig(width=r.cfg.width, height=r.cfg.height,
                           engine=name)
        rv = Renderer(r.scene, BuildConfig(), cfg, flat=r.flat,
                      device=r.device)
        if not (torch.equal(rv.tables.nodes8, r.tables.nodes8)
                and torch.equal(rv.tables.tris12, r.tables.tris12)):
            raise AssertionError(f"{name}: tables differ from phase 4's")
        launches[name] = 0
        for mode in SECONDARY_MODES:
            res, counts, passes = render_recorded(rv, mode, camera)
            others = sum(counts[k] for k in ENGINES if k != name)
            if counts[name] != len(passes) or others:
                raise AssertionError(f"{name} render({mode}): launches "
                                     f"{counts}")
            launches[name] += counts[name]
            ref_res, ref_passes = secondary[mode]
            for pname, (rays, any_hit, hits) in passes.items():
                rrays, rany, rhits = ref_passes[pname]
                tag = f"[9] {name} {mode} pass {pname}"
                if any_hit != rany or not same_rays(rays, rrays):
                    raise AssertionError(f"{tag}: not phase 8's rays")
                if any_hit:
                    if not torch.equal(hits[0] >= 0, rhits[0] >= 0):
                        raise AssertionError(f"{tag}: tri>=0 differs from "
                                             "the packet kernel's")
                else:
                    compare(hits, rhits, f"{tag} vs packet kernel")
            if not np.array_equal(res.image, ref_res.image):
                raise AssertionError(f"[9] {name} render({mode}): image "
                                     "differs from phase 8's")
            log(f"[9] {name} render({mode}): {counts[name]} launches; "
                f"{len(passes)} passes on phase 8's rays, closest hits "
                "tri/t/u/v equal to the packet kernel's on every ray, any "
                "hits tri>=0 equal; image bit-equal to phase 8's; stages "
                + json.dumps({k: round(v, 3) for k, v in res.stats.items()}))
    return launches


def stride_sample(rays, n=SAMPLE_RAYS):
    R = rays[0].shape[0]
    idx = torch.arange(0, R, max(R // n, 1), device=rays[0].device)[:n]
    return [a[idx] for a in rays], R / len(idx)


def phase_variant_twins(tables, secondary):
    """Phase 9: each kernel (packet, ww, ifif) bit-equal to its twin on a
    SAMPLE_RAYS stride sample of every traced batch (any-hit tri
    included), and each twin's work on that sample (work_with_reads) for
    the per-batch bounds. Returns, by batch, the factor that scales the
    sample's counts to the batch and the work by schedule."""
    works = {}
    batches = [("primary", secondary["shadow"][1]["primary"])] + [
        (p, secondary[m][1][p]) for m in SECONDARY_MODES
        for p in PASSES[m][1:]]
    for bname, (rays, any_hit, _) in batches:
        sample, scale = stride_sample(rays)
        works[bname] = (scale, {})
        for engine, (kernel, twin, *_) in ENGINES.items():
            work = work_with_reads(tables)
            t0 = time.perf_counter()
            tw = twin(tables, *sample, any_hit=any_hit, work=work)
            twin_s = time.perf_counter() - t0
            compare(kernel(tables, *sample, any_hit=any_hit), tw,
                    f"[9] {engine} on the {bname} sample vs twin")
            works[bname][1][engine] = work
            log(f"[9] {engine} {bname}: kernel bit-equal to twin on a "
                f"{len(sample[0])}-ray stride sample of {rays[0].shape[0]} "
                f"({'any' if any_hit else 'closest'} hit, tri included; "
                f"twin {twin_s:.2f} s); per ray "
                f"{work['node_visits'] / len(sample[0]):.2f} node visits, "
                f"{work['tri_slot_tests'] / len(sample[0]):.2f} slot tests")
    return works


def phase_variant_timing(tables, primary, secondary, works, smi):
    """Phase 9 times, CUDA events, warm, medians of 10: each of packet, ww
    and ifif on phase 5's primary frame and the shadow, AO and diffuse
    batches, beside the batch's bound (traversal_bound: the least work of
    any schedule). The primary frame's bound comes from each twin's full
    count, the others' from the sampled work. Then each new kernel's twin
    on the primary frame (median of 3). Returns the primary bound and the
    new kernels' rows for the kernels line."""
    full = {}
    for engine, (_, twin, *_) in ENGINES.items():
        full[engine] = work_with_reads(tables)
        twin(tables, *primary, work=full[engine])
        log(f"[9] {engine} primary frame, full count: "
            f"{full[engine]['node_visits']} node visits, "
            f"{full[engine]['tri_slot_tests']} slot tests")
    batches = {"primary": (primary, False, (1.0, full)),
               "shadow": secondary["shadow"][1]["shadow"][:2]
               + (works["shadow"],),
               "ao": secondary["ao"][1]["ao"][:2] + (works["ao"],),
               "diffuse": secondary["diffuse"][1]["diffuse"][:2]
               + (works["diffuse"],)}
    times, bounds = {}, {}
    for bname, (rays, any_hit, (scale, bw)) in batches.items():
        R = rays[0].shape[0]
        b, by, least = bounds[bname] = traversal_bound(tables, rays, bw,
                                                       scale)
        log(f"[9] {bname} batch, {R} rays, "
            f"{'any' if any_hit else 'closest'} hit: bound {b:.4f} ms by "
            f"{by} (the least work, {least}'s; "
            + ("full count" if bname == "primary" else "sampled work") + ")")
        for engine, (kernel, *_) in ENGINES.items():
            t = cuda_ms(lambda: kernel(tables, *rays, any_hit=any_hit),
                        warmup=2, iters=10)
            ms = statistics.median(t)
            times[bname, engine] = ms
            log(f"[9] {bname} batch: {engine} median {ms:.4f} ms of 10 (min "
                f"{min(t):.4f}, max {max(t):.4f}) = {R / ms / 1e3:.2f} "
                f"Mrays/s, {ms / b:.1f}x the batch's bound; on {smi}")
    rows = {}
    for engine in VARIANTS:
        twin = ENGINES[engine][1]
        t = cuda_ms(lambda: twin(tables, *primary), warmup=0, iters=3)
        rows[engine] = {"ms": times["primary", engine],
                        "plain_ms": statistics.median(t),
                        "bound": bounds["primary"][:2]}
        log(f"[9] {engine} primary frame: twin median "
            f"{rows[engine]['plain_ms']:.1f} ms of 3 ("
            + ", ".join(f"{x:.1f}" for x in t) + f"); kernel "
            f"{rows[engine]['ms']:.4f} ms on {smi}")
    torch.cuda.synchronize()
    return bounds["primary"][:2], rows


def phase_hairball_ao(device, hair, smi, width=WIDTH, height=HEIGHT):
    """Phase 10, BASELINE config #4: the hairball at 2,900,402 tris,
    builder="lbvh" (max_leaf_size 32) with engine "auto", so the renderer
    builds the tables on the card through the row-scan kernel, and
    render(mode="ao") traces through the packet kernel. The counts are set
    to 0 before the renderer is made and read after the frame. HAIR_AO_RAYS
    stride-sampled AO rays against brute_force_anyhit; the AO pass time."""
    camera = default_camera("hairball")
    reset_counts()
    rh = Renderer(hair, LBVH_CFG, RenderConfig(width=width, height=height,
                                               mode="ao", engine="auto"),
                  device=device)
    with recorded(rh) as passes:
        res = rh.render(camera)
    counts = launch_counts()
    if rh.flat is not None or counts["row_scan"] < 2 \
            or counts["packet"] != 2 or len(passes) != 2:
        raise AssertionError(f"hairball AO skipped a kernel: {counts}")
    check_image("[10] hairball AO", res.image, width, height)
    rays, any_hit, hits = passes[1]
    host = [a.cpu().numpy() for a in rays]
    R = len(host[0])
    sub = np.arange(0, R, max(R // HAIR_AO_RAYS, 1))[:HAIR_AO_RAYS]
    blocked = brute_force_anyhit(hair, *(a[sub] for a in host))
    tri = hits[0].cpu().numpy()[sub]
    if not any_hit or not np.array_equal(tri >= 0, blocked):
        raise AssertionError("[10] hairball AO: tri>=0 differs from "
                             "brute_force_anyhit")
    st = res.stats
    t = cuda_ms(lambda: trace_packet(rh.tables, *rays, any_hit=True),
                warmup=2, iters=10)
    ms = statistics.median(t)
    log(f"[10] hairball AO ({hair.num_tris} tris, {rh.tables.num_nodes} "
        f"nodes, build {rh.timer.ms()['build']:.1f} ms): launches "
        + json.dumps({k: v for k, v in counts.items() if v})
        + f"; AO pass {st['rays_ao']:.0f} rays ({R} live, traced), "
        f"trace_ao {st['trace_ao']:.3f} ms = {st['mrays_ao']:.2f} Mrays/s; "
        f"the kernel alone on the live rays median {ms:.4f} ms of 10 = "
        f"{R / ms / 1e3:.2f} Mrays/s; tri>=0 equal to brute_force_anyhit on "
        f"{len(sub)} (blocked {blocked.mean():.4f}); image mean "
        f"{res.image.mean():.4f}; stages "
        + json.dumps({k: round(v, 3) for k, v in st.items()}) + f" on {smi}")
    return counts


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA GPU")

    t_start = time.perf_counter()
    info = describe("cuda")
    smi = info["nvidia_smi"].splitlines()[0]
    log("[1] " + json.dumps(info))

    b = build()
    ptxas = [ln.strip() for ln in b.log.splitlines()
             if "registers" in ln or "stack frame" in ln]
    log(f"[2] built {b.path.name} in {b.seconds:.1f} s; " + " | ".join(ptxas))

    device = torch.device("cuda")
    phase_soup(device)
    r, batch, launches = phase_main_path(device)
    ms, plain_ms, err = phase_timing(r, batch, smi)
    rd, ca, ops, kw, dense_launches, dense_err, dense_bnd = phase_dense(
        r, batch)
    if min(dense_launches.values()) < 1:
        raise AssertionError(f"a dense main path launched no kernel: "
                             f"{dense_launches}")
    dense_ms = phase_dense_timing(rd, ca, batch, ops, kw, smi)
    del rd, ops
    scan_err = phase_scan_kernel(device)
    conf_dev, hair_dev, hair = phase_lbvh_builds(device, r.scene)
    rl, lbvh_counts = phase_lbvh_frame(r, batch)
    lbvh_ms = phase_lbvh_timing(rl, batch, conf_dev, hair_dev, smi)
    conf = lbvh_ms["conference"]
    del rl, conf_dev, hair_dev

    secondary = phase_secondary(r, smi)
    phase_soup_variants(device)
    variant_launches = phase_variant_renders(r, secondary)
    works = phase_variant_twins(r.tables, secondary)
    primary_bnd, variant_rows = phase_variant_timing(
        r.tables, (batch.orig, batch.dirn, batch.tmin, batch.tmax),
        secondary, works, smi)
    del secondary
    phase_hairball_ao(device, hair, smi)

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    kernels = [{
        "name": "packet_trace", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": primary_bnd[0], "bound_by": primary_bnd[1],
        "library_ms": None}]
    for k in ("walk", "dma"):
        kernels.append({
            "name": f"dense_{k}", "route": "cuda", "source": DENSE_SOURCE,
            "replaces": DENSE_REPLACES[k], "launches": dense_launches[k],
            "max_abs_err": dense_err[k], "ms": dense_ms[k],
            "plain_ms": dense_ms["twin"], "bound_ms": dense_bnd[0],
            "bound_by": dense_bnd[1], "library_ms": None})
    kernels.append({
        "name": "row_scan", "route": "cuda", "source": SCAN_SOURCE,
        "replaces": SCAN_REPLACES, "launches": lbvh_counts["row_scan"],
        "max_abs_err": scan_err, "ms": conf["max"],
        "plain_ms": conf["plain"], "bound_ms": conf["bound"][0],
        "bound_by": conf["bound"][1], "library_ms": conf["library"]})
    for name in VARIANTS:
        row = variant_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": ENGINES[name][2],
            "replaces": ENGINES[name][3], "launches": variant_launches[name],
            "max_abs_err": 0.0, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": None})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
