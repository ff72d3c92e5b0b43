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
while-while and speculative while-while kernels, phase 11 every mode with
the pipelined while-while and the 8-wide packet kernels, phase 12 the
primary frame with the v1 screen-space engine and the dense engine's
visit-list kernel, and phase 13 every mode with the node-batch,
deferred-leaf and combined packet kernels.

Phases, each printed as it completes:
  1. versions, card name and power limit (nvidia-smi)
  2. build the CUDA kernels from ntrace_tpu_torch/csrc with nvcc; ptxas's
     registers, stack frame and spills of packet_ww and packet_pipe, and
     of the packet kernel and packet_ifif
  3. kernel against its torch twin on the card: a 5,000-triangle random
     soup, 65,536 random rays, tables packed as (tris_per_row,
     nodes_per_row) = (12, 1) and (4, 8), and a 500-triangle soup whose
     median tree has leaves of more than 32 rows at (4, 1) (more than a
     leaf run holds), each table's max_leaf_rows logged; closest-hit and
     any-hit tri/t/u/v bit-equal on every ray, misses included; closest
     hits exact against brute_force_mt
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
     ops and directions, on the hairball build's two ANSV inputs
     (31, 2,900,402) and its kept neighbours (two (1, 2,900,402) scans,
     bit-equal to torch.cummax / cummin); the conference build on the card
     bit-equal to the same build on the CPU; structural checks of the
     hairball build; the LBVH frame (render() through the row-scan,
     child-box and packet kernels) against the golden and brute-force
     oracles and against phase 4's frame on every ray; times of the build
     at both sizes, of each row-scan launch (the (31, n) class scans and
     the (1, n) kept-neighbour scans) beside torch.cummax and the plain
     version, of the child-box kernel (csrc/child_boxes.cu) on the build's
     own queries, bit-equal to child_boxes_ref, beside the plain version,
     and of the frame's trace
  8. the secondary modes on phase 4's renderer (engine packet): render()
     for shadow, ao (3,145,728 rays at samples=4), diffuse and path
     (bounces=2), each pass recorded; any-hit passes tri >= 0 against
     brute_force_anyhit on 256 rays, closest-hit passes against
     trace_cpu_golden on 4,096 (0 tie-aware mismatches) and brute_force_mt
     on 256 (exact tri); images finite and not black; diffuse ray 411,517
     (a hit on the shared edge of two flat leaf boxes) bit-equal to
     brute_force_mt; csrc/secondary_rays.cu launched once by each AO and
     diffuse render() and once a bounce by each path render() (and by no
     other mode, here and in every recorded render after), and against
     its plain version on the AO frame's primary hits, AO and diffuse, and
     on the inputs of each bounce of a path render() (one sample a ray,
     the bounce before's rays and hits, dead rays among them): random
     words, origins, tmin, tmax and keys bit-equal (keys where the
     directions are), the direction components that differ counted (at
     most 2 ulps), the kernel's time beside its bound and the plain
     chain's time
  9. the while-while and speculative while-while kernels
     (csrc/packet_ww.cu, csrc/packet_ifif.cu): the phase-3 soup check for
     each; all four modes rendered with engine packet_ww and packet_ifif,
     every pass on phase 8's rays, closest hits equal to the packet
     kernel's on tri/t/u/v on every ray, any hits on tri >= 0, images
     bit-equal to phase 8's; each kernel (packet too) bit-equal to its
     twin on a
     65,536-ray stride sample of every batch, with each twin's work a ray
     (the packet and ifif twins' culled items too) and the packet and
     ifif twins' slot tests against ww's (at most 1.05x on any hits, the
     packet twin's at most 1x on closest hits); the times of packet, ww
     and ifif on the primary, shadow, AO and diffuse batches, beside one
     bound per batch:
     the least work any of the three twins counts on it (full counts on
     the primary frame, the sample scaled up on the others), and each
     twin's node visits and slot tests a ray; the twins on the primary
     frame
 10. BASELINE config #4: the hairball (2,900,402 tris) with
     builder="lbvh", built on the card through the row-scan kernel, and
     render(mode="ao") through the packet kernel; 128 AO rays against
     brute_force_anyhit; the kernel bit-equal to its twin on a stride
     sample of the live AO rays, whose work gives the bound; the AO pass
     time beside the bound; csrc/secondary_rays.cu on the frame's primary hits
     as in phase 8
 11. the pipelined while-while and 8-wide packet kernels
     (csrc/packet_pipe.cu, csrc/packet_wide.cu): the phase-3 soup check for
     each (wide at tris_per_row 4, exact False and True); render() of
     primary, shadow, ao, diffuse and path with engine packet_pipe and
     packet_wide, every pass on phase 8's rays and through check_pass,
     closest hits equal to the packet kernel's on every ray (for
     packet_wide: but rays brute_force_mt decides for it), any hits on
     tri >= 0, images bit-equal (but one pixel per decided ray); pipe
     bit-equal to its twin on the 65,536-ray samples (with the share of
     node steps whose early-issued record was the one taken), wide on a
     contiguous slice of whole packets sized by its twin's time (both
     exact modes, each mode's work logged); ww's and pipe's twins within
     2% of the packet twin's node visits and slot tests on the full
     primary frame; times of packet, pipe and wide (both exact modes) on
     the primary, shadow, AO and diffuse batches beside one bound per
     batch over the five twins, packet's and pipe's beside their twins'
     node visits and slot tests a ray; wide's registers and shared memory
     from ptxas; the hairball's wide tables refused (2**19 triangle rows);
     the count of rays decided by brute force (0 expected: the slab test
     is conservative)
 12. the v1 engine (engine="binraster", csrc/binraster_trace.cu) and the
     visit-list kernel (dense_kernel="visits", csrc/dense_visits.cu) on
     phase 4's scene, BVH and camera: render() through each with its
     launch counts (no packet launch, no -2), the oracles, both frames
     bit-equal to phase 6's walk frame (hits, t, image); on the frozen
     full-frame structures the v1 kernel at (ez_chunk 0, unroll 4) and
     (8, 4) and the visits kernel bit-equal to their plain versions on
     every ray; times of the kernels, the twins and the frames with and
     without the prep, beside the bounds (pair tests x MT_OPS; v1's
     early-z work counted by early_z_rows)
 13. the node-batch, deferred-leaf and combined packet kernels
     (csrc/packet_bfs.cu, packet_dleaf.cu, packet_bdl.cu on
     csrc/packet_batch.cuh): the phase-3 soup check for each (bfs and bdl
     at (12, 1); dleaf at (12, 1) and (4, 8) and at drain_min 1 and 64,
     on a 500-triangle soup; bdl at qgroup 1 and 4, with and without
     merge_sibs, and at drain_min 1 and 64, on a 1,000-triangle soup;
     any-hit tri bit-equal to the twin);
     render() of all five modes with engine packet_bfs, packet_dleaf and
     packet_bdl, every pass on phase 8's rays and through check_pass (at
     a quarter of its samples: the hits equal phase 8's),
     closest hits equal to the packet kernel's on every ray, any hits on
     tri >= 0, images bit-equal to phase 8's, one launch per pass; each
     kernel bit-equal to its twin on a contiguous slice of whole packets
     of every batch, with its twin's steps, drains and block barriers a
     packet (the serial-routing rule and the two-barrier step's) beside
     its slot tests a ray, and bfs's slot tests beside the whole-packet
     rule's (bdl's twin at qgroup = rows) on the AO and diffuse slices;
     the registers, shared memory and blocks an SM of each batch_kernel
     instantiation (ptxas and the CUDA runtime, at the renderer's knobs);
     phase 7's LBVH tables (built on the card, nodes_per_row 1) traced by
     each, equal to phase 7's frame; times of the three on the primary,
     shadow, AO and diffuse batches beside the bound over all eight twins,
     their own work and their steps, drains and barriers, and the twins
     on the primary frame
 14. the exact byte-plane gather (csrc/gather.cu): the reference's test
     cases (tests/test_gather.py shapes, skewed and repeated indices, a
     table holding inf, -inf, -0.0, NaN, 1e-38 and 255.5), the kernel
     bit-equal as int32 to its plain version and to table[idx]; then
     GatherTable at two real sizes, its launches counted: (a) the
     shading fetch, phase 4's Woop table at the Woop row of each of phase
     8's diffuse hits, and (b) phase 4's node table at 1,048,576 uniform
     random rows; each timed beside its bound (bytes: the indices, each
     table row touched once, the rows written), the plain version and
     the fastest of torch.index_select and tab[idx]
 15. BASELINE config #3 (scripts/benchmark_matrix.py:54-55): fairy at
     170,000 triangles, builder="hlbvh" (max_leaf_size 32, sah_tri_cost
     0.02, 9 top bits), 1024x768, engine auto. The forest sweep on the
     card (bvh/lbvh.py:lbvh_device, its cummins through csrc/row_scan.cu)
     bit-equal to the same sweep on the CPU (Woop rows within
     WOOP_ULPS), at least 2 clusters and the splice taken (no fallback),
     the tree checked (the host route's FlatBVH); Renderer(builder=
     "hlbvh") then builds on the card (the device route: forest in one
     pass, one read, native top tree, one upload, splice) with no
     fallback, its tables the host route's tree packed one node a row
     (tables.py:tree_form) and its triangle rows bit-equal; render() of
     diffuse and AO through it and through the host route's renderer,
     images and hits bit-equal, row-scan, child-box and packet launches
     counted, every pass through check_pass; the primary frame against
     the binned-SAH tree's, every difference decided by brute_force_mt;
     times of the build (device sweep, host top tree and splice, host
     pack and upload, build_accel, and update_positions with its traced
     parts), of each render's stages and of the packet kernel on each
     pass beside its bound
Then one JSON line of per-kernel results (with each kernel's bound from
this run's work), the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises and the script
exits non-zero. Without a CUDA device it exits non-zero at once.

The script imports nothing of the JAX package: the scenes, host BVH
builders and CPU oracles are the port's own copies (ntrace_tpu_torch.host).

Run from the repository root: python3 chip_smoke.py
"""

import json
import re
import statistics
import sys
import time
from contextlib import contextmanager
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ntrace_tpu_torch.bvh import hlbvh, lbvh
from ntrace_tpu_torch.device import describe
from ntrace_tpu_torch.host import (BuildConfig, RenderConfig,
                                   brute_force_anyhit, brute_force_mt,
                                   default_camera, get_scene,
                                   golden_mismatches, make_random_soup,
                                   pack_bvh, pack_wide_bvh, trace_cpu_golden)
from ntrace_tpu_torch.host.bvh.sbvh import sbvh_impl_tag
from ntrace_tpu_torch.kernels.build import build
from ntrace_tpu_torch.ops.boxes import child_boxes, child_boxes_ref
from ntrace_tpu_torch.ops.gather import (GatherTable, paged_gather_bytes,
                                         paged_gather_bytes_ref)
from ntrace_tpu_torch.ops.pscan import OPS, row_scan_i32, row_scan_i32_ref
from ntrace_tpu_torch.ray import raygen, rng
from ntrace_tpu_torch.ray.pixeltable import pixel_table
from ntrace_tpu_torch.ray.raybatch import DEAD_KEY, RayBatch, sort_by_key
from ntrace_tpu_torch.render.renderer import Renderer, build_accel
from ntrace_tpu_torch.tables import (WideTables, tables_from_packed,
                                     tables_from_wide, tree_form)
from ntrace_tpu_torch.trace import binraster as br
from ntrace_tpu_torch.trace import binraster_dense as bd
from ntrace_tpu_torch.trace import packet_batch, registry
from ntrace_tpu_torch.trace.packet import trace_packet, trace_packet_ref
from ntrace_tpu_torch.trace.packet_bdl import trace_packet_bdl_ref
from ntrace_tpu_torch.trace.packet_bfs import trace_packet_bfs_ref
from ntrace_tpu_torch.trace.packet_dleaf import trace_packet_dleaf_ref
from ntrace_tpu_torch.trace.packet_ifif import trace_packet_ifif_ref
from ntrace_tpu_torch.trace.packet_common import (STACK_DEPTH, read_bytes,
                                                  work_with_reads)
from ntrace_tpu_torch.trace.packet_pipe import (trace_packet_pipe,
                                                trace_packet_pipe_ref)
from ntrace_tpu_torch.trace.packet_wide import (WARP, trace_packet_wide,
                                                trace_packet_wide_ref)
from ntrace_tpu_torch.trace.packet_ww import trace_packet_ww_ref
from ntrace_tpu_torch.utils.timing import cuda_ms, tracing

KERNEL_SOURCE = "ntrace_tpu_torch/csrc/packet_trace.cu"
KERNEL_REPLACES = "ntrace_tpu/trace/packet_pallas.py:99"
DENSE_SOURCE = "ntrace_tpu_torch/csrc/dense_trace.cu"
DENSE_REPLACES = {"walk": "ntrace_tpu/trace/binraster_dense.py:757",
                  "dma": "ntrace_tpu/trace/binraster_dense.py:1022"}
V1_SOURCE = "ntrace_tpu_torch/csrc/binraster_trace.cu"
V1_REPLACES = "ntrace_tpu/trace/binraster.py:472"
VISITS_SOURCE = "ntrace_tpu_torch/csrc/dense_visits.cu"
VISITS_REPLACES = "ntrace_tpu/trace/binraster_dense.py:1270"
SCAN_SOURCE = "ntrace_tpu_torch/csrc/row_scan.cu"
SCAN_REPLACES = "ntrace_tpu/ops/pscan.py:33"
SECONDARY_SOURCE = "ntrace_tpu_torch/csrc/secondary_rays.cu"
BOXES_SOURCE = "ntrace_tpu_torch/csrc/child_boxes.cu"
# render() modes whose secondary rays come from csrc/secondary_rays.cu, one
# launch a frame (path mode's bounces too: one launch a bounce).
KERNEL_RAYGEN_MODES = ("ao", "diffuse")
# The traversal engines of the secondary slice: kernel wrapper (the one the
# registry binds, `TRACE`), twin, source and the TPU kernel each replaces.
TRACE = registry.TABLE_TRACERS
ENGINES = {
    "packet": (TRACE["packet"], trace_packet_ref, KERNEL_SOURCE,
               KERNEL_REPLACES),
    "packet_ww": (TRACE["packet_ww"], trace_packet_ww_ref,
                  "ntrace_tpu_torch/csrc/packet_ww.cu",
                  "ntrace_tpu/trace/packet_ww.py:55"),
    "packet_ifif": (TRACE["packet_ifif"], trace_packet_ifif_ref,
                    "ntrace_tpu_torch/csrc/packet_ifif.cu",
                    "ntrace_tpu/trace/packet_ifif.py:54"),
}
VARIANTS = ("packet_ww", "packet_ifif")
# Phase 11's engines: the pipelined while-while on the packed tables, and
# the 8-wide packet kernel on its own tables.
NEW_ENGINES = {
    "packet_pipe": (TRACE["packet_pipe"], trace_packet_pipe_ref,
                    "ntrace_tpu_torch/csrc/packet_pipe.cu",
                    "ntrace_tpu/trace/packet_pipe.py:51"),
    "packet_wide": (trace_packet_wide, trace_packet_wide_ref,
                    "ntrace_tpu_torch/csrc/packet_wide.cu",
                    "ntrace_tpu/trace/packet_wide.py:80"),
}
# Phase 13's engines: the node-batch, deferred-leaf and combined packet
# kernels on the packed tables.
BATCH_ENGINES = {
    "packet_bfs": (TRACE["packet_bfs"], trace_packet_bfs_ref,
                   "ntrace_tpu_torch/csrc/packet_bfs.cu",
                   "ntrace_tpu/trace/packet_bfs.py:52"),
    "packet_dleaf": (TRACE["packet_dleaf"], trace_packet_dleaf_ref,
                     "ntrace_tpu_torch/csrc/packet_dleaf.cu",
                     "ntrace_tpu/trace/packet_dleaf.py:122"),
    "packet_bdl": (TRACE["packet_bdl"], trace_packet_bdl_ref,
                   "ntrace_tpu_torch/csrc/packet_bdl.cu",
                   "ntrace_tpu/trace/packet_bdl.py:72"),
}
ALL_ENGINES = {**ENGINES, **NEW_ENGINES, **BATCH_ENGINES}
SECONDARY_MODES = ("shadow", "ao", "diffuse", "path")
ALL_MODES = ("primary",) + SECONDARY_MODES
SAMPLE_RAYS = 65_536          # stride sample of a batch for twin checks
ANYHIT_RAYS = 256             # rays of an any-hit pass vs brute_force_anyhit
HAIR_AO_RAYS = 128
SCENE_TRIS = 280_000          # get_scene("conference") -> 297,024 tris
HAIRBALL_TRIS = 2_900_000     # get_scene("hairball") -> 2,900,402 tris
LBVH_CFG = BuildConfig(builder="lbvh", max_leaf_size=32, sah_tri_cost=0.02)
WIDTH, HEIGHT = 1024, 768
GOLDEN_RAYS = 4096
# The conference diffuse ray whose closest hit lies on a shared edge of two
# flat leaf boxes (tests/test_torch_crack.py holds the same ray).
CRACK_RAY = 411_517
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
WIDE_VISIT_OPS = 8 * NODE_VISIT_OPS // 2
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
        diff = torch.nonzero(torch.stack([a != b for a, b in zip(kern, twin)])
                             .any(0)).squeeze(1)
        raise AssertionError(f"{label}: {', '.join(bad)} differ on "
                             f"{diff.numel()} rays, first "
                             f"{diff[:8].tolist()}")
    return 0.0


def phase_soup(device):
    """Phase 3: kernel against twin (and brute force) on a random soup, at
    layouts (12, 1) and (4, 8), and on a 500-triangle soup whose median
    tree has leaves of more than 32 rows (more than a leaf run holds):
    closest and any hits bit-equal to the twin, any-hit tri included."""
    soup = make_random_soup(n_tris=5000, seed=11)
    flat = build_accel(soup, BuildConfig(builder="binned_sah"))
    small = make_random_soup(n_tris=500, seed=7)
    fat = build_accel(small, BuildConfig(builder="median",
                                         max_leaf_size=600))
    rays_np = random_rays(np.random.default_rng(2024), 65_536)
    rays = [torch.from_numpy(a).to(device) for a in rays_np]
    shadow = rays[:3] + [torch.full_like(rays[3], 14.0)]
    sub = np.arange(0, 65_536, 16)
    for scene, tree, tpr, npr in ((soup, flat, 12, 1), (soup, flat, 4, 8),
                                  (small, fat, 4, 1)):
        tables = tables_from_packed(
            pack_bvh(tree, scene.tri_verts(), tris_per_row=tpr,
                     nodes_per_row=npr), device)
        label = (f"soup {scene.num_tris} tris tpr={tpr} npr={npr} "
                 f"max_leaf_rows {tables.max_leaf_rows}")
        kern = trace_packet(tables, *rays)
        compare(kern, trace_packet_ref(tables, *rays), label)
        bf = brute_force_mt(scene, *(a[sub] for a in rays_np))
        if not np.array_equal(kern[0].cpu().numpy()[sub], bf.tri):
            raise AssertionError(f"{label}: tri differs from brute_force_mt")
        ka = trace_packet(tables, *shadow, any_hit=True)
        compare(ka, trace_packet_ref(tables, *shadow, any_hit=True),
                f"{label} any hit")
        log(f"[3] {label}: closest-hit tri/t/u/v bit-equal vs twin on "
            f"all 65536 rays, misses included (hit rate "
            f"{float((kern[0] >= 0).float().mean()):.3f}); tri exact vs "
            f"brute_force_mt on {len(sub)}; any hit bit-equal vs twin, tri "
            f"included (blocked {float((ka[0] >= 0).float().mean()):.3f})")


def phase_soup_variants(device, names=VARIANTS, tag="[9]"):
    """Phase 9, first check: the phase-3 soup for packet_ww and
    packet_ifif (phase 11: packet_pipe). Closest hit and any hit bit-equal
    to the twin (any-hit tri included) at layouts (12, 1) and (4, 8);
    closest hits equal to the packet kernel's on every ray and exact
    against brute_force_mt; any-hit tri >= 0 against brute_force_anyhit."""
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
        for name in names:
            kernel, twin = ALL_ENGINES[name][:2]
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
            log(f"{tag} {label}: closest hit bit-equal to the twin and to the "
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
    with tracing():
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
    return batch_bound(rays, {e: (tables, w, scale)
                              for e, w in works.items()})


def batch_bound(rays, entries):
    """traversal_bound over schedules that may trace different tables and
    samples: entries maps a schedule to (tables, work, scale). A node visit
    of the packed tables is two child slab tests (NODE_VISIT_OPS); a
    packet's visit of a wide node is its 8 child tests (WIDE_VISIT_OPS),
    and a wide node row read is 512 bytes (read_bytes)."""
    R = rays[0].shape[0]
    best = None
    for engine, (tables, w, scale) in entries.items():
        per_visit = (WIDE_VISIT_OPS if isinstance(tables, WideTables)
                     else NODE_VISIT_OPS)
        ops = (w["node_visits"] * per_visit
               + w["tri_slot_tests"] * MT_OPS) * scale
        b = bound(nbytes(*rays) + 16 * R + read_bytes(tables, w), ops)
        if best is None or b[0] < best[0]:
            best = (*b, engine)
    return best


def profile_render(r, smi, tag="[5]"):
    """One warm render() under torch.profiler: device time by kernel and
    the device's busy share of the frame's wall time."""
    camera = default_camera("conference")
    with tracing():
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
    # aten::copy_ also carries its kernels' device time, and a profiler
    # range (the program's ntrace.* spans) its copy on the device timeline.
    dev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation
                  and e.self_device_time_total > 0), key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in dev)
    log(f"{label}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms "
        f"({100 * busy / wall_ms:.1f}%) on {smi}; top: "
        + "; ".join(f"{k[:60]} x{n} {ms:.3f} ms" for k, ms, n in dev[:top]))
    return dev


# The screen-space kernels by the name a render uses: the dense engine's
# dense_kernel values and the v1 engine.
SCREEN_KERNELS = {"walk": bd.trace_dense_rows, "dma": bd.trace_dense_rows_dma,
                  "visits": bd.trace_dense_visits,
                  "binraster": br.trace_binraster_rows}


def screen_render(rv, key, tag):
    """A screen-space main path: render() once through kernel `key` ("walk",
    "dma" or "visits" on a binraster_dense renderer, "binraster" on a v1
    renderer), the launch and prep counts set to 0 just before it and read
    just after. No packet launch, no other screen-space kernel, no -2
    (main() checks that the kernel itself launched: on the CPU the plain
    version runs)."""
    if key in bd.KERNELS:
        rv.screen.kernel_name = key
    for fn in SCREEN_KERNELS.values():
        fn.launches = 0
    trace_packet.launches = 0
    bd.binraster_prep_dense5.calls = 0
    with tracing():
        res = rv.render(default_camera("conference"))
    counts = {k: fn.launches for k, fn in SCREEN_KERNELS.items()}
    counts.update(packet=trace_packet.launches,
                  prep_v5=bd.binraster_prep_dense5.calls)
    if not rv.screen.armed:
        raise AssertionError(f"{tag} render ({key}) did not arm the "
                             "screen-space engine")
    others = sum(v for k, v in counts.items()
                 if k not in (key, "prep_v5"))
    if others or (counts["prep_v5"] >= 1) != (key != "binraster"):
        raise AssertionError(f"{tag} render ({key}): launches {counts}")
    img = res.image
    if img.shape != (rv.cfg.height, rv.cfg.width, 3) \
            or not np.isfinite(img).all() or not img.max() > 0:
        raise AssertionError(f"{tag} render ({key}): bad or black image")
    if (res.hit_tri == -2).any():
        raise AssertionError(f"{tag} render ({key}): -2 poison, the prep's "
                             "static sizes did not hold")
    log(f"{tag} render ({key}): counts "
        + json.dumps({k: v for k, v in counts.items() if v})
        + f", image mean {img.mean():.4f}, hit rate "
        f"{(res.hit_tri >= 0).mean():.4f}, stages "
        + json.dumps({k: round(v, 3) for k, v in res.stats.items()}))
    return res, counts[key]


def phase_dense(r, batch):
    """Phase 6 checks: the dense engine's main path (walk, then dma) on
    phase 4's scene, BVH and camera; both kernels against the twin on the
    frozen full-frame structure; the oracles; dense against packet.
    Returns the dense renderer, its camera, the frozen kernel operands and
    keywords, launches and max abs errors by kernel, the kernels' bound and
    the walk frame."""
    W, H = r.cfg.width, r.cfg.height
    cfg = RenderConfig(width=W, height=H, mode="primary",
                       engine="binraster_dense")
    rd = Renderer(r.scene, BuildConfig(), cfg, flat=r.flat, device=r.device)
    camera = default_camera("conference")
    ca = raygen.camera_arrays(camera, W, H, r.device)
    if not rd.prepare_primary(ca, W, H):
        raise AssertionError("prepare_primary declined the conference frame")
    res, walk_launches = screen_render(rd, "walk", "[6]")
    res_dma, dma_launches = screen_render(rd, "dma", "[6]")
    if not (np.array_equal(res.hit_tri, res_dma.hit_tri)
            and np.array_equal(res.image, res_dma.image)):
        raise AssertionError("dense render: walk and dma frames differ")
    order, _ = pixel_table(W, H)
    check_oracles("[6]", r.scene, r.flat, res, batch, order)

    rd.screen.kernel_name = "walk"
    if not rd.prepare_primary(ca, W, H):
        raise AssertionError("prepare_primary declined the conference frame")
    rd.freeze_primary_structure(ca)
    c, ray_rows = rd.screen.sizes, rd.screen.ray_rows
    rows, r0, r1, g1, ok = rd.screen.structure(ca)
    if not bool(ok):
        raise AssertionError("prep v5: ok is False on the conference frame")
    g = 0 if g1 is None else int(g1[0])
    visits = int((r1 - r0).clamp_min(0).sum()) + c["nb"] * g
    log(f"[6] structure: p_max {c['p_max']}, g2_max {c['g2_max']}, "
        f"global tiles {g}, {rows.shape[0] // bd.GPT} tiles "
        f"({rows.numel() * 4 / 1e6:.1f} MB), {c['nb']} bins of "
        f"{ray_rows * 128} rays, {visits} (bin, tile) visits, "
        f"{len(c['n_ks'])} prefix slices")
    dirs, scalars = br.dense_rays(batch.dirn, ca["pos"], batch.tmin[0],
                                  batch.tmax[0], c["nb"], ray_rows)
    ops = (rows, r0, r1, dirs, scalars, g1)
    kw = dict(n_bins=c["nb"], ray_rows=ray_rows)
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
    pairs = visits * ray_rows * 128 * bd.TPT
    bnd = bound(nbytes(*ops) + 16 * R, pairs * MT_OPS)
    log(f"[6] dense kernel work: {pairs} ray-triangle pair tests, "
        f"{pairs * MT_OPS:.4g} FP32 operations; bound {bnd[0]:.4f} ms by "
        f"{bnd[1]}")
    return rd, ca, ops, kw, launches, errs, bnd, res


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
        return rd.screen.prep(ca)

    ms["prep"] = med("prep: prepare_primary (count passes) + prep v5", prep)
    if not rd.prepare_primary(ca, W, H):
        raise AssertionError("prepare_primary declined the conference frame")
    med("prep v5 alone (the structure build)", lambda: rd.screen.prep(ca))
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
    hairball build's two ANSV scans through kernel and plain version, its
    kept neighbours through the kernel and torch's scan, and the structure
    of the hairball build. Returns the inputs on the card
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
    kept = lbvh.lbvh_device_fast(*hair_dev, max_leaf=ml, emit="packed")["kept"]
    got = lbvh.kept_neighbours(kept)
    want = lbvh.kept_neighbours(kept, row_scan_i32_ref)
    for name, a, b in zip(("previous", "next"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"hairball {name} kept rows: kernel differs "
                                 f"from torch's scan on "
                                 f"{int((a != b).sum())} rows")
    log(f"[7] hairball kept neighbours ({int(kept.sum())} of {kept.shape[0]} "
        "rows kept): the row scan's (1, n) forward max and reverse min "
        "bit-equal to torch.cummax / cummin")
    del kept, got, want
    check_packed(lbvh.build_packed_from(hair_dev, ml), hair.num_tris,
                 "[7] hairball")
    return conf_dev, hair_dev, hair


def phase_lbvh_frame(r, batch):
    """Phase 7, the LBVH main path: Renderer(builder="lbvh") builds the
    packet tables on the card and render() traces them; the row-scan and
    packet counts are set to 0 just before and read just after. Then the
    oracles, and phase 4's binned-SAH frame on every ray, brute_force_mt
    deciding any difference. Returns the renderer, the counts and the
    frame."""
    W, H = r.cfg.width, r.cfg.height
    camera = default_camera("conference")
    sah = r.render(camera)
    row_scan_i32.launches = 0
    child_boxes.launches = 0
    trace_packet.launches = 0
    rl = Renderer(r.scene, LBVH_CFG, RenderConfig(width=W, height=H,
                                                  mode="primary",
                                                  engine="auto"),
                  device=r.device)
    with tracing():
        res = rl.render(camera)
    counts = {"row_scan": row_scan_i32.launches,
              "child_boxes": child_boxes.launches,
              "packet": trace_packet.launches}
    if rl.flat is not None or rl.tables.device.type != r.device.type:
        raise AssertionError("builder='lbvh' did not build its tables on "
                             "the card")
    if counts["row_scan"] < 4 or counts["child_boxes"] != 1 \
            or counts["packet"] < 1:
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
    return rl, counts, res


def phase_lbvh_timing(rl, batch, conf_dev, hair_dev, smi):
    """Phase 7 times, CUDA events, warm, medians of 10: the packed build at
    both sizes (with its node_count read), each row-scan launch on the
    build's real ANSV inputs beside torch.cummax and the plain version,
    the two (1, n) kept-neighbour scans on the build's own mask beside the
    plain version (torch's one-block scan), the child boxes on the build's
    own queries beside the plain version, and the LBVH frame's
    trace_primary."""
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
        del D, xmax, xmin
        t["row"] = phase_kept_scans(size, args, ml, med, smi)
        t["boxes"] = phase_child_boxes(size, args, ml, med, smi)
        out[size] = t
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


def phase_kept_scans(size, args, ml, med, smi):
    """The build's two kept-neighbour scans, (1, n) int32 rows made from
    its own mask: each through the kernel and through the plain version
    (torch.cummax / cummin, one block a row), CUDA events around the
    wrapper and the profiler's device time of the kernel's passes, beside
    the bound (one read and one write of the row)."""
    kept = lbvh.lbvh_device_fast(*args, max_leaf=ml, emit="packed")["kept"]
    n = kept.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=kept.device)
    xmax = torch.where(kept, iota, -1).reshape(1, -1)
    xmin = torch.where(kept, iota, n).reshape(1, -1)
    t = {"bound": bound(2 * nbytes(xmax), xmax.numel())}
    for key, x, op, rev in (("max", xmax, "max", False),
                            ("min_rev", xmin, "min", True)):
        what = f"{size} (1, {n}) {op}" + (" reverse" if rev else "")
        t[key] = med(f"{what} row_scan_i32",
                     lambda: row_scan_i32(x, op=op, reverse=rev))
        t[f"plain_{key}"] = med(f"{what} row_scan_i32_ref",
                                lambda: row_scan_i32_ref(x, op=op,
                                                         reverse=rev))
        reps = 10
        dev = profile_once(f"[7] profile of {reps} {what} row_scan_i32 "
                           "launches",
                           lambda: [row_scan_i32(x, op=op, reverse=rev)
                                    for _ in range(reps)], smi, top=4)
        t[f"device_{key}"] = sum(
            ms for k, ms, _ in dev if "row_tile" in k) / reps or None
    b, by = t["bound"]
    log(f"[7] {size} kept-neighbour scans (1, {n}): kernel max "
        f"{t['max']:.4f} ms, min reverse {t['min_rev']:.4f} (device "
        + ", ".join("not measured" if t[k] is None else f"{t[k]:.4f}"
                    for k in ("device_max", "device_min_rev"))
        + f"); plain {t['plain_max']:.4f} and {t['plain_min_rev']:.4f}; "
        f"bound {b:.4f} ms by {by} ({2 * nbytes(xmax) / 1e6:.1f} MB)")
    return t


def phase_child_boxes(size, args, ml, med, smi):
    """The build's child boxes on its own queries (recorded from one
    build): the kernel bit-equal to the plain version on the card, then
    both timed (CUDA events around the wrapper, medians of 20) and the
    profiler's device time of the kernel's two passes, beside the bound
    (the sorted boxes read once, the range ends of the nodes below the
    count, the boxes written)."""
    with mock.patch.object(lbvh, "child_boxes", wraps=child_boxes) as spy:
        lbvh.lbvh_device_fast(*args, max_leaf=ml, emit="packed")
    q = spy.call_args.args
    slo, a, count = q[0], q[2], int(q[5])
    n, m = slo.shape[0], a.shape[0]
    got, want = child_boxes(*q), child_boxes_ref(*q)
    if not _bit_equal(got, want):
        raise AssertionError(f"{size} child boxes: the kernel differs from "
                             "the plain version on "
                             f"{int((got != want).any(1).sum())} nodes")
    t = {"bound": bound(24 * n + 12 * count + 48 * m, 0)}
    t["kernel"] = med(f"{size} child_boxes ({count} of {m} nodes, {n} "
                      "rows)", lambda: child_boxes(*q), iters=20)
    t["plain"] = med(f"{size} child_boxes_ref", lambda: child_boxes_ref(*q),
                     iters=20)
    reps = 20
    dev = profile_once(f"[7] profile of {reps} {size} child_boxes launches",
                       lambda: [child_boxes(*q) for _ in range(reps)], smi,
                       top=4)
    passes = {p: sum(ms for k, ms, _ in dev if p in k) / reps
              for p in ("box_levels", "box_query")}
    t["device"] = sum(passes.values()) or None
    b, by = t["bound"]
    log(f"[7] {size} child boxes bit-equal to child_boxes_ref; kernel "
        f"{t['kernel']:.4f} ms (device "
        + (f"{t['device']:.4f}: levels {passes['box_levels']:.4f}, query "
           f"{passes['box_query']:.4f}" if t["device"] else "not measured")
        + f"), plain {t['plain']:.4f}; bound {b:.4f} ms by {by} "
        f"({(24 * n + 12 * count + 48 * m) / 1e6:.1f} MB)")
    return t


# -- phases 8-10: the secondary passes -------------------------------------

PASSES = {"primary": ("primary",),
          "shadow": ("primary", "shadow"), "ao": ("primary", "ao"),
          "diffuse": ("primary", "diffuse"),
          "path": ("primary", "bounce0", "bounce1")}


def reset_counts():
    for kernel, *_ in ALL_ENGINES.values():
        kernel.launches = 0
    row_scan_i32.launches = 0
    child_boxes.launches = 0
    paged_gather_bytes.launches = 0
    raygen.secondary_rays.launches = 0


def launch_counts() -> dict:
    return {**{name: e[0].launches for name, e in ALL_ENGINES.items()},
            "row_scan": row_scan_i32.launches,
            "child_boxes": child_boxes.launches,
            "gather": paged_gather_bytes.launches,
            "secondary_rays": raygen.secondary_rays.launches}


def check_raygen_launches(tag, mode, counts, frames=1, bounces=2):
    """`frames` render()s of `mode` launched csrc/secondary_rays.cu once
    each for AO and diffuse, `bounces` times each for path, never for the
    other modes."""
    want = frames * (1 if mode in KERNEL_RAYGEN_MODES
                     else bounces if mode == "path" else 0)
    if counts["secondary_rays"] != want:
        raise AssertionError(f"{tag}: {counts['secondary_rays']} "
                             f"secondary_rays launches, want {want}")


@contextmanager
def recorded(r):
    """Keep every pass the renderer traces, as (rays, any_hit, hits) in the
    order render() traces them. The tracer is the renderer's own; this
    only records its inputs and outputs."""
    passes = []
    base = r.tracer.trace

    def tracer(o, d, tn, tx, any_hit):
        out = base(o, d, tn, tx, any_hit)
        passes.append(((o, d, tn, tx), any_hit, out))
        return out

    r.tracer.trace = tracer
    try:
        yield passes
    finally:
        del r.tracer.trace


def check_image(tag, img, width, height):
    if img.shape != (height, width, 3) or not np.isfinite(img).all() \
            or not img.max() > 0:
        raise AssertionError(f"{tag}: bad or black image")


def check_pass(tag, scene, flat, rays, any_hit, hits, cut=1):
    """One traced pass against the CPU oracles: any hit, tri >= 0 against
    brute_force_anyhit on ANYHIT_RAYS stride-sampled rays; closest hit, 0
    tie-aware mismatches against trace_cpu_golden on GOLDEN_RAYS and exact
    tri against brute_force_mt on BRUTE_RAYS; each count divided by
    `cut`."""
    host = [a.cpu().numpy() for a in rays]
    tri, t = hits[0].cpu().numpy(), hits[1].cpu().numpy()
    R = len(tri)
    if any_hit:
        sub = np.arange(0, R, max(R // (ANYHIT_RAYS // cut), 1))
        blocked = brute_force_anyhit(scene, *(a[sub] for a in host))
        if not np.array_equal(tri[sub] >= 0, blocked):
            raise AssertionError(f"{tag}: any-hit tri>=0 differs from "
                                 f"brute_force_anyhit on "
                                 f"{int(((tri[sub] >= 0) != blocked).sum())}")
        log(f"{tag}: {R} rays, any hit; tri>=0 equal to brute_force_anyhit "
            f"on {len(sub)} (blocked {blocked.mean():.4f})")
        return
    sub = np.arange(0, R, max(R // (GOLDEN_RAYS // cut), 1))
    rec = trace_cpu_golden(flat, *(a[sub] for a in host))
    mism = golden_mismatches(tri[sub], t[sub], rec.tri, rec.t)
    if mism:
        raise AssertionError(f"{tag}: {mism} tie-aware golden mismatches")
    sub2 = np.arange(0, R, max(R // (BRUTE_RAYS // cut), 1))
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
    with recorded(r) as passes, tracing():
        res = r.render(camera, mode)
    counts = launch_counts()
    check_raygen_launches(f"render({mode})", mode, counts,
                          bounces=r.cfg.bounces)
    names = PASSES[mode]
    if len(passes) != len(names):
        raise AssertionError(f"render({mode}) traced {len(passes)} passes, "
                             f"want {names}")
    return res, counts, dict(zip(names, passes))


def phase_secondary(r, smi):
    """Phase 8: render() of every secondary mode on phase 4's renderer
    (engine packet), every traced pass held to the oracles; then one warm
    AO and one warm diffuse frame under the profiler. Returns the results
    and passes by mode, and the csrc/secondary_rays.cu launches those
    render()s counted."""
    camera = default_camera("conference")
    out, raygen_launches = {}, 0
    for mode in SECONDARY_MODES:
        res, counts, passes = render_recorded(r, mode, camera)
        raygen_launches += counts["secondary_rays"]
        if counts["packet"] != len(passes) or any(
                counts[k] for k in ALL_ENGINES if k != "packet"):
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
        if mode == "diffuse":
            check_crack_ray(r.scene, *passes["diffuse"])
        out[mode] = (res, passes)
    for mode in ("ao", "diffuse"):
        profile_once(f"[8] profile of one warm render({mode})",
                     lambda: r.render(camera, mode), smi, top=10)
    return out, raygen_launches


def check_crack_ray(scene, rays, any_hit, hits, i=CRACK_RAY):
    """Phase 8: diffuse ray 411,517 (a hit on the shared edge of two flat
    leaf boxes) gives brute_force_mt's tri and t, bit for bit. Skipped on a
    batch too small to hold it (a rehearsal on the CPU)."""
    if any_hit or rays[0].shape[0] <= i:
        return
    bf = brute_force_mt(scene, *(a[i:i + 1].cpu().numpy() for a in rays))
    tri, t = int(hits[0][i]), hits[1][i:i + 1].cpu().numpy()
    if tri != int(bf.tri[0]) or t.view(np.int32)[0] != bf.t.view(np.int32)[0]:
        raise AssertionError(f"[8] diffuse ray {i}: tri {tri} t {t[0]}, "
                             f"brute_force_mt tri {bf.tri[0]} t {bf.t[0]}")
    log(f"[8] diffuse ray {i} (a shared edge of two flat leaf boxes): tri "
        f"{tri}, t {t[0]!r}, bit-equal to brute_force_mt")


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in ulps between float32 tensors (-0.0 and 0.0 are 0
    apart)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def path_raygen_calls(r, camera):
    """The arguments of each raygen.secondary_rays call that one path
    render() makes, as (words, the arguments after them with
    direction_major last): per bounce, one sample a ray from the rays
    before it and their hits (the primary pass, then the bounce before,
    whose dead rays hold tri -1 and t 0)."""
    calls, base = [], raygen.secondary_rays

    def rec(words, *args, direction_major):
        calls.append((words, args + (direction_major,)))
        return base(words, *args, direction_major=direction_major)

    # secondary_rays counts its launches on the module's name, rec here.
    rec.launches = base.launches
    raygen.secondary_rays = rec
    try:
        r.render(camera, "path")
    finally:
        raygen.secondary_rays = base
        base.launches = rec.launches
    if len(calls) != r.cfg.bounces:
        raise AssertionError(f"render(path) called secondary_rays "
                             f"{len(calls)} times, want {r.cfg.bounces}")
    return calls


def phase_secondary_rays(tag, r, prim, smi):
    """Phases 8 (conference) and 10 (hairball): csrc/secondary_rays.cu
    against its plain version on the card, on the primary pass `prim`
    (rays, any_hit, hits) that r.render() traced, at the renderer's
    samples and seed, AO and diffuse; then (phase 8) on the inputs of each
    bounce of one path render() (path_raygen_calls: one sample a ray,
    diffuse keys, the bounce before's rays and hits with its dead rays).
    Random words, origins, tmin and tmax bit-equal, keys wherever the
    directions are; directions within 2 ulps, the components that differ
    counted. The kernel's ms (CUDA events, warm, median of 20) beside its
    bound (bytes: the rays and hits before, each distinct normal row
    gathered once, the outputs) and the plain chain's ms, and the sort
    that follows it in render(). Returns the diffuse run's row."""
    (orig, dirn, tmin, tmax), _, hits = prim
    batch = RayBatch(orig, dirn, tmin, tmax)
    cfg = r.cfg
    words = rng.key_words(cfg.seed)
    cases = [(mode, words, (batch, hits[0], hits[1], r.geom_normals,
                            cfg.samples, r.secondary_length(mode), r.eps,
                            r.scene_lo, r.scene_hi, mode != "ao"))
             for mode in KERNEL_RAYGEN_MODES]
    if tag == "[8]":
        calls = path_raygen_calls(r, default_camera("conference"))
        cases += [(f"path bounce {b}", w, args)
                  for b, (w, args) in enumerate(calls)]
        # The conference is closed, so no path dies there: the last
        # bounce's inputs again, every fifth ray dead as a missed one is.
        w, args = calls[-1]
        tri, t = args[1].clone(), args[2].clone()
        tri[::5], t[::5] = -1, 0.0
        cases.append(("path bounce, a fifth dead", w,
                      (args[0], tri, t) + args[3:]))
    rows = {}
    for name, words, args in cases:
        rows[name] = _check_secondary_rays(f"{tag} secondary_rays {name}",
                                           words, args, smi)
    return rows["diffuse"]


def _check_secondary_rays(tag, words, args, smi):
    """One case of phase_secondary_rays: the kernel and its plain version
    on `args` (secondary_rays's arguments after the words)."""
    inp, tri, t, S = args[0], args[1], args[2], args[4]
    dev = tri.device
    n = inp.num_rays * S
    bits = torch.empty((n, 2), dtype=torch.int32, device=dev)
    got, key = raygen.secondary_rays(words, *args, bits=bits)
    want, want_key = raygen.secondary_rays_ref(words, *args)
    fails = [name for name, a, b in (
        ("random words", bits, rng.random_bits32(
            words, (n, 2), dev).to(torch.int32)),
        ("origins", got.orig, want.orig), ("tmin", got.tmin, want.tmin),
        ("tmax", got.tmax, want.tmax))
        if not _bit_equal(a, b)]
    du = ulps(got.dirn, want.dirn)
    same = (du == 0).all(dim=1)
    if not torch.equal(key[same], want_key[same]):
        fails.append("keys where the directions are equal")
    if int(du.max()) > 2:
        fails.append(f"directions ({int(du.max())} ulps apart)")
    if fails:
        raise AssertionError(f"{tag}: {', '.join(fails)} differ from "
                             "secondary_rays_ref")
    ms = statistics.median(cuda_ms(
        lambda: raygen.secondary_rays(words, *args), warmup=2, iters=20))
    plain = statistics.median(cuda_ms(
        lambda: raygen.secondary_rays_ref(words, *args), warmup=1, iters=5))
    sort_ms = statistics.median(cuda_ms(lambda: sort_by_key(got, key),
                                        warmup=2, iters=20))
    rows = torch.unique(tri.clamp(min=0)).numel()
    moved = nbytes(inp.orig, inp.dirn, tri, t) + rows * 12 + nbytes(
        got.orig, got.dirn, got.tmin, got.tmax, key)
    bnd = bound(moved, 0)
    log(f"{tag} ({inp.num_rays} rays before x {S}, {int((tri < 0).sum())} "
        f"of them missed, {int((key == DEAD_KEY).sum())} dead): random "
        f"words, origins, tmin, tmax bit-equal to secondary_rays_ref, keys "
        f"on the {int(same.sum())} rays whose directions are; direction "
        f"components differing {int((du > 0).sum())} of {3 * n} (max "
        f"{int(du.max())} ulps), keys differing "
        f"{int((key != want_key).sum())}; kernel median {ms:.4f} ms of 20, "
        f"bound {bnd[0]:.4f} ms by {bnd[1]} ({moved / 1e6:.1f} MB; "
        f"{ms / bnd[0]:.1f}x), plain chain {plain:.3f} ms, then sort_by_key "
        f"{sort_ms:.4f} ms, on {smi}")
    return {"ms": ms, "plain_ms": plain, "bound": bnd, "sort_ms": sort_ms,
            "max_abs_err": float((got.dirn - want.dirn).abs().max())}


def same_rays(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


# -- ptxas of the shipped traversal kernels (phase 2) and phase 9's checks --

# packet_ww's and packet_pipe's twins count the packet twin's node visits
# and slot tests on the full primary frame, within this share (phase 11).
WW_WORK_RTOL = 0.02
WW_KERNELS = "ww|pipe"
PACKET_KERNELS = "trace|ifif"
# The twins whose closest-hit pops cull (their work counts the culled
# items where asked).
CULLING = ("packet", "packet_ifif")


def ptxas_report(log: str, kernels: str) -> str:
    """ptxas's registers, stack frame and spill bytes of each instantiation
    of the kernels packet_<k>_kernel, k in the `kernels` alternatives, in a
    build log."""
    out = []
    for m in re.finditer(
            r"Compiling entry function '\w*?(packet_(?:" + kernels
            + r"))_kernel"
            r"ILb(\d)E\w*'.*?(\d+) bytes stack frame, (\d+) bytes spill "
            r"stores, (\d+) bytes spill loads.*?Used (\d+) registers", log,
            re.DOTALL):
        out.append(f"{m.group(1)} any_hit={m.group(2)}: {m.group(6)} "
                   f"registers, {m.group(3)} B stack frame, spills "
                   f"{m.group(4)}/{m.group(5)} B")
    return "; ".join(out) or "not in this build's log (library reused)"


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
            others = sum(counts[k] for k in ALL_ENGINES if k != name)
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


def phase_variant_twins(tables, secondary, engines=ENGINES, tag="[9]"):
    """Phase 9: each kernel (packet, ww, ifif; phase 11: pipe) bit-equal
    to its twin on a SAMPLE_RAYS stride sample of every traced batch
    (any-hit tri included), and each twin's work on that sample
    (work_with_reads) for the per-batch bounds. Returns, by batch, the
    factor that scales the sample's counts to the batch and the work by
    schedule."""
    works = {}
    batches = [("primary", secondary["shadow"][1]["primary"])] + [
        (p, secondary[m][1][p]) for m in SECONDARY_MODES
        for p in PASSES[m][1:]]
    for bname, (rays, any_hit, _) in batches:
        sample, scale = stride_sample(rays)
        works[bname] = (scale, {})
        for engine, (kernel, twin, *_) in engines.items():
            work = work_with_reads(tables)
            if engine == "packet_pipe":
                work.update(fetch_steps=0, fetch_predicted=0)
            if engine in CULLING and not any_hit:
                work.update(culled_node_visits=0, culled_slot_tests=0)
            t0 = time.perf_counter()
            tw = twin(tables, *sample, any_hit=any_hit, work=work)
            twin_s = time.perf_counter() - t0
            compare(kernel(tables, *sample, any_hit=any_hit), tw,
                    f"{tag} {engine} on the {bname} sample vs twin")
            works[bname][1][engine] = work
            log(f"{tag} {engine} {bname}: kernel bit-equal to twin on a "
                f"{len(sample[0])}-ray stride sample of {rays[0].shape[0]} "
                f"({'any' if any_hit else 'closest'} hit, tri included; "
                f"twin {twin_s:.2f} s); per ray "
                f"{work['node_visits'] / len(sample[0]):.2f} node visits, "
                f"{work['tri_slot_tests'] / len(sample[0]):.2f} slot tests"
                + early_fetch(work) + culled(work, len(sample[0])))
        if engines is ENGINES:
            against_ww(tag, bname, any_hit, works[bname][1])
    return works


def culled(work: dict, rays: int) -> str:
    """The packet or ifif twin's culled items a ray, where counted."""
    if "culled_node_visits" not in work:
        return ""
    return (f"; culled on pop {work['culled_node_visits'] / rays:.2f} node "
            f"visits, {work['culled_slot_tests'] / rays:.2f} slot tests a "
            "ray")


def against_ww(tag, bname, any_hit, works):
    """Phase 9: the packet and ifif twins' slot tests on a batch's sample
    against ww's, the redesign's bounds: on any-hit rays at most 1.05x, on
    closest-hit rays (the packet twin) at most 1x. Raises if one is
    missed."""
    ww = works["packet_ww"]["tri_slot_tests"]
    aims = ({"packet": 1.05, "packet_ifif": 1.05} if any_hit
            else {"packet": 1.0})
    held = {e: works[e]["tri_slot_tests"] <= a * ww for e, a in aims.items()}
    log(f"{tag} {bname} slot tests against packet_ww's: " + "; ".join(
        f"{e} {works[e]['tri_slot_tests'] / ww:.4f}x (aim <= {a}: "
        f"{'held' if held[e] else 'MISSED'})" for e, a in aims.items()))
    if not all(held.values()):
        raise AssertionError(f"{tag} {bname}: slot tests past packet_ww's "
                             "bound")


def early_fetch(work: dict) -> str:
    """The pipe twin's share of node steps whose next node was the record
    csrc/packet_pipe.cu fetched before the slab tests, where counted."""
    if "fetch_steps" not in work:
        return ""
    return (f"; the early-issued record taken on {work['fetch_predicted']} "
            f"of {work['fetch_steps']} node steps that go on to a node "
            f"({work['fetch_predicted'] / max(work['fetch_steps'], 1):.4f})")


def per_ray(w: dict, scale: float, rays: int) -> str:
    """A twin's node visits and slot tests a ray on a batch of `rays`, from
    its work on a sample (`scale` times fewer rays) or the whole batch."""
    return (f"its twin's {w['node_visits'] * scale / rays:.2f} node visits, "
            f"{w['tri_slot_tests'] * scale / rays:.2f} slot tests a ray")


def phase_variant_timing(tables, primary, secondary, works, smi):
    """Phase 9 times, CUDA events, warm, medians of 10: each of packet, ww
    and ifif on phase 5's primary frame and the shadow, AO and diffuse
    batches, beside the batch's bound (traversal_bound: the least work of
    any schedule). The primary frame's bound comes from each twin's full
    count, the others' from the sampled work. Then each new kernel's twin
    on the primary frame (median of 3). Returns the primary bound, the
    new kernels' rows for the kernels line and the full counts."""
    full = {}
    for engine, (_, twin, *_) in ENGINES.items():
        full[engine] = work_with_reads(tables)
        if engine in CULLING:
            full[engine].update(culled_node_visits=0, culled_slot_tests=0)
        twin(tables, *primary, work=full[engine])
        log(f"[9] {engine} primary frame, full count: "
            f"{full[engine]['node_visits']} node visits, "
            f"{full[engine]['tri_slot_tests']} slot tests"
            + culled(full[engine], primary[0].shape[0]))
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
                f"Mrays/s, {ms / b:.1f}x the batch's bound; "
                + per_ray(bw[engine], scale, R) + f"; on {smi}")
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
    return bounds["primary"][:2], rows, full


def phase_hairball_ao(device, hair, smi, width=WIDTH, height=HEIGHT):
    """Phase 10, BASELINE config #4: the hairball at 2,900,402 tris,
    builder="lbvh" (max_leaf_size 32) with engine "auto", so the renderer
    builds the tables on the card through the row-scan kernel, and
    render(mode="ao") traces through the packet kernel. The counts are set
    to 0 before the renderer is made and read after the frame. HAIR_AO_RAYS
    stride-sampled AO rays against brute_force_anyhit; the kernel bit-equal
    to its twin on a SAMPLE_RAYS stride sample of the live AO rays, whose
    work, scaled, gives the bound; the AO pass time beside the bound."""
    camera = default_camera("hairball")
    reset_counts()
    rh = Renderer(hair, LBVH_CFG, RenderConfig(width=width, height=height,
                                               mode="ao", engine="auto"),
                  device=device)
    with recorded(rh) as passes, tracing():
        res = rh.render(camera)
    counts = launch_counts()
    if rh.flat is not None or counts["row_scan"] < 4 \
            or counts["child_boxes"] != 1 or counts["packet"] != 2 \
            or len(passes) != 2:
        raise AssertionError(f"hairball AO skipped a kernel: {counts}")
    check_raygen_launches("[10] hairball AO", "ao", counts)
    check_image("[10] hairball AO", res.image, width, height)
    phase_secondary_rays("[10] hairball", rh, passes[0], smi)
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
    sample, scale = stride_sample(rays)
    work = work_with_reads(rh.tables)
    t0 = time.perf_counter()
    tw = trace_packet_ref(rh.tables, *sample, any_hit=True, work=work)
    twin_s = time.perf_counter() - t0
    compare(trace_packet(rh.tables, *sample, any_hit=True), tw,
            "[10] hairball AO sample vs twin")
    b, by, _ = batch_bound(rays, {"packet": (rh.tables, work, scale)})
    t = cuda_ms(lambda: trace_packet(rh.tables, *rays, any_hit=True),
                warmup=2, iters=10)
    ms = statistics.median(t)
    n = len(sample[0])
    log(f"[10] hairball AO ({hair.num_tris} tris, {rh.tables.num_nodes} "
        f"nodes, layout tpr={rh.tables.tris_per_row} "
        f"npr={rh.tables.nodes_per_row}, max_leaf_rows "
        f"{rh.tables.max_leaf_rows}, build {rh.timer.ms()['build']:.1f} "
        "ms): launches "
        + json.dumps({k: v for k, v in counts.items() if v})
        + f"; AO pass {st['rays_ao']:.0f} rays ({R} live, traced), "
        f"trace_ao {st['trace_ao']:.3f} ms = "
        f"{st['rays_ao'] / st['trace_ao'] / 1e3:.2f} Mrays/s; "
        f"the kernel alone on the live rays median {ms:.4f} ms of 10 (min "
        f"{min(t):.4f}, max {max(t):.4f}) = {R / ms / 1e3:.2f} Mrays/s, "
        f"bound {b:.4f} ms by {by} ({ms / b:.1f}x; the twin's work on a "
        f"{n}-ray stride sample, bit-equal to the kernel, tri included, "
        f"twin {twin_s:.1f} s: {work['node_visits'] / n:.2f} node visits, "
        f"{work['tri_slot_tests'] / n:.2f} slot tests a ray); "
        f"tri>=0 equal to brute_force_anyhit on "
        f"{len(sub)} (blocked {blocked.mean():.4f}); image mean "
        f"{res.image.mean():.4f}; stages "
        + json.dumps({k: round(v, 3) for k, v in st.items()}) + f" on {smi}")
    return counts


# -- phase 11: the pipelined while-while and the 8-wide packet kernel -------

WIDE_TWIN_S = 6.0     # twin seconds a wide slice may grow to, per batch
WIDE_SLICE0 = 64 * WARP


def wide_ptxas(log: str) -> str:
    """ptxas's registers and shared memory of each packet_wide_kernel
    instantiation, from the build log ([2])."""
    out = []
    for m in re.finditer(r"Compiling entry function '\w*packet_wide_kernel"
                         r"ILb(\d)ELb(\d)E\w*'.*?Used (\d+) registers"
                         r"[^\n]*?(\d+) bytes smem", log, re.DOTALL):
        out.append(f"any_hit={m.group(1)} exact={m.group(2)}: "
                   f"{m.group(3)} registers, {m.group(4)} bytes smem")
    return "; ".join(out) or "not in this build's log (library reused)"


def phase_soup_wide(device):
    """Phase 11, first check: the phase-3 soup through the wide kernel at
    tris_per_row 4, in both exact modes. Closest hit and any hit bit-equal
    to the twin on all 65,536 rays (any-hit tri included); closest hits
    equal to the packet kernel's on every ray and exact against
    brute_force_mt; any-hit tri >= 0 against brute_force_anyhit."""
    soup = make_random_soup(n_tris=5000, seed=11)
    flat = build_accel(soup, BuildConfig(builder="binned_sah"))
    rays_np = random_rays(np.random.default_rng(2024), 65_536)
    rays = [torch.from_numpy(a).to(device) for a in rays_np]
    shadow = rays[:3] + [torch.full_like(rays[3], 14.0)]
    sub = np.arange(0, 65_536, 16)
    bf = brute_force_mt(soup, *(a[sub] for a in rays_np))
    blocked = brute_force_anyhit(soup, *(a[sub] for a in rays_np[:3]),
                                 np.full(len(sub), 14.0, np.float32))
    packet = trace_packet(tables_from_packed(
        pack_bvh(flat, soup.tri_verts(), tris_per_row=4, nodes_per_row=1),
        device), *rays)
    wt = tables_from_wide(pack_wide_bvh(flat, soup.tri_verts(),
                                        tris_per_row=4), device)
    for exact in (False, True):
        label = f"soup packet_wide exact={exact}"
        kern = trace_packet_wide(wt, *rays, exact=exact)
        compare(kern, trace_packet_wide_ref(wt, *rays, exact=exact),
                f"{label} vs twin")
        compare(kern, packet, f"{label} vs packet kernel")
        if not np.array_equal(kern[0].cpu().numpy()[sub], bf.tri):
            raise AssertionError(f"{label}: tri differs from brute_force_mt")
        ka = trace_packet_wide(wt, *shadow, any_hit=True, exact=exact)
        compare(ka, trace_packet_wide_ref(wt, *shadow, any_hit=True,
                                          exact=exact),
                f"{label} any-hit vs twin")
        if not np.array_equal(ka[0].cpu().numpy()[sub] >= 0, blocked):
            raise AssertionError(f"{label}: any-hit tri>=0 differs from "
                                 "brute_force_anyhit")
        log(f"[11] {label}: closest hit bit-equal to the twin and to the "
            f"packet kernel on all 65536 rays; any hit bit-equal to the twin "
            f"(tri included, blocked {float((ka[0] >= 0).float().mean()):.3f}"
            f"); exact vs brute_force_mt and brute_force_anyhit on "
            f"{len(sub)}")


def decided_by_brute_force(tag, scene, rays, hits, rhits):
    """The rays of a closest-hit pass where `hits` differ from the packet
    kernel's `rhits`: brute_force_mt must side with `hits` on every one
    (tri). Returns how many there are."""
    diff = torch.nonzero(torch.stack([a != b for a, b in zip(hits, rhits)])
                         .any(0)).squeeze(1)
    if diff.numel():
        bf = brute_force_mt(scene, *(a[diff].cpu().numpy() for a in rays))
        wrong = int((hits[0][diff].cpu().numpy() != bf.tri).sum())
        if wrong:
            raise AssertionError(f"{tag}: brute_force_mt sides with the "
                                 f"packet kernel on {wrong} of "
                                 f"{diff.numel()} rays")
    return diff.numel()


def phase_new_renders(r, secondary, names=tuple(NEW_ENGINES),
                      tag="[11]", cut=1):
    """Phase 11: render() of every mode with engine packet_pipe and
    packet_wide on phase 4's scene and BVH (phase 13: packet_bfs,
    packet_dleaf and packet_bdl). Each pass traces phase 8's
    rays (phase 4's for primary); any-hit passes equal the packet kernel's
    tri >= 0; closest-hit passes equal its tri/t/u/v on every ray, except,
    for packet_wide (other tables, other culling), rays that brute_force_mt
    decides for packet_wide (after such a ray, a later path pass has other
    rays: it meets the oracles, and phase 8's rays of it are traced again
    and compared); every traced pass passes check_pass; images bit-equal
    to the packet engine's but for at most one pixel per decided ray
    (check_pass's samples divided by `cut`: phase 13 runs them at a
    quarter of phase 8's, whose oracles held the same hits).
    Returns the launches of each kernel over its five renders, the
    renderers and the rays decided for packet_wide."""
    camera = default_camera("conference")
    ref = {m: (res, passes) for m, (res, passes) in secondary.items()}
    res, counts, passes = render_recorded(r, "primary", camera)
    if counts["packet"] != 1:
        raise AssertionError(f"render(primary): launches {counts}")
    ref["primary"] = (res, passes)
    launches, renderers, decided = {}, {}, 0
    for name in names:
        cfg = RenderConfig(width=r.cfg.width, height=r.cfg.height,
                           engine=name)
        t0 = time.perf_counter()
        rv = Renderer(r.scene, BuildConfig(), cfg, flat=r.flat,
                      device=r.device)
        tb = rv.tables
        if name != "packet_wide" and not (
                torch.equal(tb.tris12, r.tables.tris12)
                and (tb.nodes_per_row != r.tables.nodes_per_row
                     or torch.equal(tb.nodes8, r.tables.nodes8))):
            raise AssertionError(f"{name}: tables differ from phase 4's")
        if name == "packet_wide":
            log(f"{tag} packet_wide tables: {tb.num_nodes} 8-ary nodes, "
                f"nodes_w {tuple(tb.nodes_w.shape)}, tris12 "
                f"{tuple(tb.tris12.shape)} at tpr {tb.tris_per_row}, "
                f"{tb.nbytes() / 1e6:.1f} MB, max_leaf_rows "
                f"{tb.max_leaf_rows}; pack {time.perf_counter() - t0:.1f} s")
        renderers[name] = rv
        launches[name] = 0
        for mode in ALL_MODES:
            res, counts, passes = render_recorded(rv, mode, camera)
            others = sum(counts[k] for k in ALL_ENGINES if k != name)
            if counts[name] != len(passes) or others:
                raise AssertionError(f"{name} render({mode}): launches "
                                     f"{counts}")
            launches[name] += counts[name]
            ref_res, ref_passes = ref[mode]
            n_dec = 0
            for pname, (rays, any_hit, hits) in passes.items():
                rrays, rany, rhits = ref_passes[pname]
                ptag = f"{tag} {name} {mode} pass {pname}"
                if any_hit != rany:
                    raise AssertionError(f"{ptag}: not phase 8's pass")
                if not same_rays(rays, rrays):
                    if name != "packet_wide" or not n_dec:
                        raise AssertionError(f"{ptag}: not phase 8's rays")
                    # A hit an earlier pass took where the packet kernel
                    # missed it sends that path on with other rays: the
                    # render's own pass meets the oracles, and phase 8's
                    # rays of this pass are traced again by the engine.
                    check_pass(ptag, r.scene, r.flat, rays, any_hit, hits,
                               cut)
                    rays, hits = rrays, rv.tracer.trace(*rrays, any_hit)
                    ptag += " (phase 8's rays, traced again)"
                if any_hit:
                    if not torch.equal(hits[0] >= 0, rhits[0] >= 0):
                        raise AssertionError(f"{ptag}: tri>=0 differs from "
                                             "the packet kernel's")
                elif name != "packet_wide":
                    compare(hits, rhits, f"{ptag} vs packet kernel")
                else:
                    n = decided_by_brute_force(ptag, r.scene, rays, hits,
                                               rhits)
                    if n:
                        log(f"{ptag}: differs from the packet kernel on {n} "
                            "rays, each decided by brute_force_mt for "
                            "packet_wide")
                    n_dec += n
                if pname != "primary" or mode == "primary":
                    check_pass(ptag, r.scene, r.flat, rays, any_hit, hits,
                               cut)
            px = int((res.image != ref_res.image).any(axis=2).sum())
            if px > n_dec:
                raise AssertionError(f"{tag} {name} render({mode}): {px} "
                                     "pixels differ from the packet "
                                     f"engine's image, {n_dec} rays decided")
            decided += n_dec
            log(f"{tag} {name} render({mode}): {counts[name]} launches; "
                f"{len(passes)} passes on phase 8's rays, closest hits "
                f"tri/t/u/v equal to the packet kernel's on every ray but "
                f"{n_dec} decided by brute force, any hits tri>=0 equal; "
                f"image bit-equal to the packet engine's but {px} pixels; "
                "stages "
                + json.dumps({k: round(v, 3) for k, v in res.stats.items()}))
    return launches, renderers, decided


def grow_slice(run_twin, rays, packet, n0, budget_s):
    """A contiguous slice of whole packets of `packet` rays from the middle
    of the batch, doubled from n0 rays while the twin's time on it,
    run_twin(slice) -> (result, work), stays within budget_s (its step
    count sets the time: a packet that walks much of the tree is slow).
    Returns the slice, the twin's result and work on it, the twin's
    seconds and the slice's first ray."""
    R = rays[0].shape[0]
    start = (R // 2) // packet * packet
    n = n0
    while True:
        n = min(n, R - start)
        sl = [a[start:start + n] for a in rays]
        t0 = time.perf_counter()
        tw, work = run_twin(sl)
        secs = time.perf_counter() - t0
        if secs * 2.5 > budget_s or start + n >= R or n >= SAMPLE_RAYS:
            return sl, tw, work, secs, start
        n *= 2


def wide_slice(wt, rays, any_hit, exact):
    """grow_slice for the wide twin: 32-ray packets, from WIDE_SLICE0 rays,
    within WIDE_TWIN_S."""
    def run(sl):
        work = work_with_reads(wt)
        return trace_packet_wide_ref(wt, *sl, any_hit=any_hit, exact=exact,
                                     work=work), work

    return grow_slice(run, rays, WARP, WIDE_SLICE0, WIDE_TWIN_S)[:4]


def phase_wide_twins(wt, secondary, entries):
    """Phase 11: packet_wide (exact False and True) bit-equal to its twin
    on a contiguous slice of whole packets of every batch (wide_slice),
    any-hit tri included. Adds the exact=False twin's work, its tables and
    its scale to `entries` (batch -> schedule -> (tables, work, scale))."""
    batches = [("primary", secondary["shadow"][1]["primary"])] + [
        (p, secondary[m][1][p]) for m in SECONDARY_MODES
        for p in PASSES[m][1:]]
    for bname, (rays, any_hit, _) in batches:
        R = rays[0].shape[0]
        for exact in (False, True):
            sl, tw, work, secs = wide_slice(wt, rays, any_hit, exact)
            n = sl[0].shape[0]
            compare(trace_packet_wide(wt, *sl, any_hit=any_hit, exact=exact),
                    tw, f"[11] packet_wide exact={exact} on the {bname} "
                    "slice vs twin")
            if not exact:
                entries[bname]["packet_wide"] = (wt, work, R / n)
            log(f"[11] packet_wide exact={exact} {bname}: kernel bit-equal "
                f"to twin on rays {R // 2 // WARP * WARP}..+{n} of {R} "
                f"({n // WARP} packets, {'any' if any_hit else 'closest'} "
                f"hit, tri included; twin {secs:.2f} s); per packet "
                f"{work['node_visits'] / (n / WARP):.1f} node visits, per "
                f"ray {work['tri_slot_tests'] / n:.2f} slot tests")


def phase_new_timing(tables, wt, primary, secondary, entries, full, smi):
    """Phase 11 times, CUDA events, warm, medians of 10 calls: packet,
    packet_pipe and packet_wide (exact False and True) on phase 5's
    primary frame and the shadow, AO and diffuse batches, beside the
    batch's bound (batch_bound over the five twins'
    work: full counts on the primary frame, phase 9's for packet, ww and
    ifif; sampled elsewhere). Then the new kernels' twins on the primary
    frame. Returns the primary bound, the new kernels' rows for the
    kernels line and the five twins' full counts on the primary frame."""
    full = {e: (tables, w, 1.0) for e, w in full.items()}
    for engine in NEW_ENGINES:
        tb = wt if engine == "packet_wide" else tables
        w = work_with_reads(tb)
        if engine == "packet_pipe":
            w.update(fetch_steps=0, fetch_predicted=0)
        ALL_ENGINES[engine][1](tb, *primary, work=w)
        full[engine] = (tb, w, 1.0)
    log("[11] primary frame, full counts: " + "; ".join(
        f"{e} {w['node_visits']} node visits, {w['tri_slot_tests']} slot "
        f"tests" for e, (_, w, _) in full.items())
        + "; packet_pipe" + early_fetch(full["packet_pipe"][1]))
    # The packet twin's walk without its cull on pop: its work plus the
    # culled items' (a culled node one visit, a culled leaf its slots).
    packet = full["packet"][1]
    uncut = {"node_visits": packet["node_visits"]
             + packet["culled_node_visits"],
             "tri_slot_tests": packet["tri_slot_tests"]
             + packet["culled_slot_tests"]}
    for engine in ("packet_ww", "packet_pipe"):
        w = full[engine][1]
        ratio = [w[k] / uncut[k] for k in uncut]
        if max(abs(x - 1) for x in ratio) > WW_WORK_RTOL:
            raise AssertionError(f"[11] {engine} primary frame: node visits "
                                 f"and slot tests {ratio} x the packet "
                                 "twin's walk without the cull, beyond 2%")
        log(f"[11] {engine} primary frame: node visits {ratio[0]:.4f}x, "
            f"slot tests {ratio[1]:.4f}x the packet twin's walk without "
            f"its cull on pop (within 2%); "
            f"{w['tri_slot_tests'] / packet['tri_slot_tests']:.4f}x its "
            "slot tests with the cull")
    batches = {"primary": (primary, False, full),
               "shadow": secondary["shadow"][1]["shadow"][:2]
               + (entries["shadow"],),
               "ao": secondary["ao"][1]["ao"][:2] + (entries["ao"],),
               "diffuse": secondary["diffuse"][1]["diffuse"][:2]
               + (entries["diffuse"],)}

    def wide(exact):
        return lambda r, a: trace_packet_wide(wt, *r, any_hit=a, exact=exact)

    runs = {"packet": lambda r, a: trace_packet(tables, *r, any_hit=a),
            "packet_pipe": lambda r, a: trace_packet_pipe(tables, *r,
                                                          any_hit=a),
            "packet_wide": wide(False), "packet_wide_exact": wide(True)}
    times, bounds = {}, {}
    for bname, (rays, any_hit, ent) in batches.items():
        R = rays[0].shape[0]
        b, by, least = bounds[bname] = batch_bound(rays, ent)
        log(f"[11] {bname} batch, {R} rays, "
            f"{'any' if any_hit else 'closest'} hit: bound {b:.4f} ms by "
            f"{by} (the least of the five twins' work, {least}'s; "
            + ("full count" if bname == "primary" else "sampled work") + ")")
        for name, run in runs.items():
            t = cuda_ms(lambda: run(rays, any_hit), warmup=2, iters=10)
            ms = statistics.median(t)
            times[bname, name] = ms
            own = ("; " + per_ray(ent[name][1], ent[name][2], R)
                   if name in ("packet", "packet_pipe") else "")
            log(f"[11] {bname} batch: {name} median {ms:.4f} ms of {len(t)} "
                f"(min {min(t):.4f}, max {max(t):.4f}) = "
                f"{R / ms / 1e3:.2f} Mrays/s, {ms / b:.1f}x the batch's "
                f"bound{own}; on {smi}")
    rows = {}
    for engine in NEW_ENGINES:
        twin = ALL_ENGINES[engine][1]
        tb = wt if engine == "packet_wide" else tables
        t = cuda_ms(lambda: twin(tb, *primary), warmup=0, iters=3)
        rows[engine] = {"ms": times["primary", engine],
                        "plain_ms": statistics.median(t),
                        "bound": bounds["primary"][:2]}
        log(f"[11] {engine} primary frame: twin median "
            f"{rows[engine]['plain_ms']:.1f} ms of 3 ("
            + ", ".join(f"{x:.1f}" for x in t) + f"); kernel "
            f"{rows[engine]['ms']:.4f} ms on {smi}")
    torch.cuda.synchronize()
    return bounds["primary"][:2], rows, full


def phase_hairball_wide_refused(hair, device):
    """Phase 11, last check: the hairball's wide tables exceed the float
    leaf item's 2**19 triangle rows at tris_per_row 4, and tables_from_wide
    must refuse them (a limit kept from the reference)."""
    t0 = time.perf_counter()
    flat = build_accel(hair, LBVH_CFG, device=device)
    wp = pack_wide_bvh(flat, hair.tri_verts(), tris_per_row=4)
    try:
        tables_from_wide(wp, device)
    except ValueError as e:
        log(f"[11] hairball packet_wide: {wp.tris12.shape[0]} triangle rows;"
            f" tables_from_wide refused them as it must: {e} "
            f"({time.perf_counter() - t0:.1f} s)")
        return
    raise AssertionError("the hairball's wide tables were not refused")


# -- phase 12: the rest of the screen-space family ---------------------------


def early_z_rows(rows, r0, r1, dirs, scalars, g1, nb, chunk):
    """The (bin, row) visits the v1 kernel makes with early-z every `chunk`
    rows, on these inputs: the global prefix, then each bin's range, in
    chunks, a bin stopping when the next row's zmin exceeds the largest hit
    t of its rays. Simulated in lockstep over the bins with the plain
    version's fold (binraster.fold_visits)."""
    dev = rows.device
    tris = rows[:, :br.TPB * 10].reshape(-1, br.TPB, 10)
    zl = rows[:, br.ZLANE]
    rpb = br.TILE * br.TILE
    t = torch.full((nb * rpb,), float(scalars[4]), device=dev)
    tid = torch.full((nb * rpb,), -1, dtype=torch.int32, device=dev)
    g = 0 if g1 is None else int(g1[0])
    zero = torch.zeros(nb, dtype=torch.int64, device=dev)
    visited = 0
    for w0, w1 in ((zero, zero + g), (r0.long(), r1.long())):
        pos, live = w0.clone(), w0 < w1
        while bool(live.any()):
            b = torch.nonzero(live).squeeze(1)
            cnt = (w1[b] - pos[b]).clamp(max=chunk)
            vbin = torch.repeat_interleave(b, cnt)
            first = torch.cumsum(cnt, 0) - cnt
            vrow = (torch.repeat_interleave(pos[b] - first, cnt)
                    + torch.arange(vbin.numel(), device=dev))
            visited += vbin.numel()
            tri_c, t_c, _, _ = br.fold_visits(tris, vbin, vrow, dirs,
                                              scalars, nb, rpb)
            better = (t_c < t) | ((t_c == t) & (tri_c >= 0) & (tri_c < tid))
            t, tid = torch.where(better, t_c, t), torch.where(better, tri_c,
                                                              tid)
            pos[b] += cnt
            more = pos[b] < w1[b]
            znext = zl[pos[b].clamp(max=rows.shape[0] - 1)]
            mt = t.view(nb, rpb).amax(dim=1)[b]
            live[b] = more & (znext <= mt)
    return visited


def phase_screen(r, rd, batch, walk_res, ops, kw, dense_bnd, smi):
    """Phase 12: the v1 engine (engine="binraster", csrc/binraster_trace.cu)
    and the dense engine's visit-list kernel (dense_kernel="visits",
    csrc/dense_visits.cu) on phase 4's scene, BVH and camera: each main
    path rendered once with its launch counts (no packet launch, no -2),
    both frames against the oracles and bit-equal to phase 6's walk frame
    (hits, t and image); on the frozen full-frame structures the v1 kernel
    at (ez_chunk 0, unroll 4) and (8, 4) and the visits kernel bit-equal to
    their plain versions on every ray; times and bounds. Returns the
    kernels line's rows of both kernels."""
    W, H = r.cfg.width, r.cfg.height
    R = batch.num_rays
    camera = default_camera("conference")
    ca = raygen.camera_arrays(camera, W, H, r.device)
    rv = Renderer(r.scene, BuildConfig(), RenderConfig(
        width=W, height=H, mode="primary", engine="binraster"),
        flat=r.flat, device=r.device)
    if not (rv.prepare_primary(ca, W, H) and rd.prepare_primary(ca, W, H)):
        raise AssertionError("prepare_primary declined the conference frame")
    frames = {"binraster": screen_render(rv, "binraster", "[12]"),
              "visits": screen_render(rd, "visits", "[12]")}
    order, _ = pixel_table(W, H)
    for name, (res, _) in frames.items():
        check_oracles(f"[12] {name}", r.scene, r.flat, res, batch, order)
        if not (np.array_equal(res.hit_tri, walk_res.hit_tri)
                and np.array_equal(res.hit_t.view(np.int32),
                                   walk_res.hit_t.view(np.int32))
                and np.array_equal(res.image, walk_res.image)):
            raise AssertionError(f"[12] {name}: the frame differs from "
                                 "phase 6's walk frame")
    log("[12] binraster and visits frames: hit ids, t and image bit-equal "
        "to phase 6's walk frame")

    rv.freeze_primary_structure(ca)
    c = rv.screen.sizes
    rows, r0, r1, g1, ok = rv.screen.structure(ca)
    if not bool(ok):
        raise AssertionError("fast prep: ok is False on the conference frame")
    nb = c["nb"]
    dirs, scalars = br.dense_rays(batch.dirn, ca["pos"], batch.tmin[0],
                                  batch.tmax[0], nb, br.RAY_ROWS)
    v1_ops = (rows, r0, r1, dirs, scalars, g1)
    twin = br.trace_binraster_rows_ref(*v1_ops, n_bins=nb)
    runs = {ez: br.trace_binraster_rows(*v1_ops, n_bins=nb, unroll=4,
                                        ez_chunk=ez) for ez in (0, 8)}
    drows, dr0, dr1, ddirs, dscalars, dg1 = ops
    vt, vb = bd.build_visit_list(dr0, dr1, dg1, v_cap=rd.screen.sizes["v_cap"],
                                 nb=kw["n_bins"])
    vis_args = (drows, vt, vb, ddirs, dscalars)
    vis_twin = bd.trace_dense_visits_ref(*vis_args, **kw)
    vis = bd.trace_dense_visits(*vis_args, **kw)
    torch.cuda.synchronize()   # a fault in a kernel surfaces here
    for ez, out in runs.items():
        compare(out, twin, f"[12] v1 kernel ez_chunk={ez} unroll=4 vs twin")
    compare(vis, vis_twin, "[12] visits kernel vs twin")
    compare(vis, bd.trace_dense_rows(*ops, ez_chunk=0, **kw),
            "[12] visits kernel vs walk kernel")
    g = 0 if g1 is None else int(g1[0])
    per_bin = (r1 - r0).clamp_min(0) + g
    row_visits = int(per_bin.sum())
    ez_visits = early_z_rows(*v1_ops, nb, 8)
    log(f"[12] kernels: v1 (ez_chunk 0 and 8, unroll 4) bit-equal to "
        f"trace_binraster_rows_ref and visits bit-equal to "
        f"trace_dense_visits_ref and to the walk kernel, on all {R} rays; "
        f"v1 structure: p_max {c['p_max']}, g_max {c['g_max']}, g2_max "
        f"{c['g2_max']}, {rows.shape[0]} rows ({rows.numel() * 4 / 1e6:.1f}"
        f" MB), {g} global rows, {nb} bins, {row_visits} (bin, row) visits "
        f"(per bin: mean {row_visits / nb:.1f}, max {int(per_bin.max())}), "
        f"{ez_visits} with early-z 8; visit list {vt.numel()} entries")
    # Bounds: the pair tests each walk needs (MT_OPS each), or the bytes of
    # its inputs read once and the hits written once.
    out_bytes = 16 * R
    b0 = bound(nbytes(*v1_ops) + out_bytes,
               row_visits * 1024 * br.TPB * MT_OPS)
    b8 = bound(ez_visits * 512 + nbytes(dirs, scalars, r0, r1) + out_bytes,
               ez_visits * 1024 * br.TPB * MT_OPS)
    log(f"[12] v1 work: {row_visits * 1024 * br.TPB} pair tests without "
        f"early-z (bound {b0[0]:.4f} ms by {b0[1]}), "
        f"{ez_visits * 1024 * br.TPB} with early-z 8 (bound {b8[0]:.4f} ms "
        f"by {b8[1]}); visits: the walk's bound {dense_bnd[0]:.4f} ms")

    def med(name, fn, iters=10, warmup=2):
        times = cuda_ms(fn, warmup=warmup, iters=iters)
        ms = statistics.median(times)
        log(f"[12] {name}: median {ms:.4f} ms of {iters} (min "
            f"{min(times):.4f}, max {max(times):.4f}) on {smi}")
        return ms

    rays = (batch.orig, batch.dirn, batch.tmin, batch.tmax)
    ms = {
        "v1_ez0": med("trace_binraster_rows (ez_chunk 0, unroll 4) frozen "
                      "frame", lambda: br.trace_binraster_rows(
                          *v1_ops, n_bins=nb, unroll=4, ez_chunk=0)),
        "v1_ez8": med("trace_binraster_rows (ez_chunk 8, unroll 4) frozen "
                      "frame", lambda: br.trace_binraster_rows(
                          *v1_ops, n_bins=nb, unroll=4, ez_chunk=8)),
        "v1_twin": med("trace_binraster_rows_ref (twin) frozen frame",
                       lambda: br.trace_binraster_rows_ref(*v1_ops,
                                                           n_bins=nb),
                       iters=3, warmup=0),
        "visits": med("trace_dense_visits frozen frame",
                      lambda: bd.trace_dense_visits(*vis_args, **kw)),
        "visits_twin": med("trace_dense_visits_ref (twin) frozen frame",
                           lambda: bd.trace_dense_visits_ref(*vis_args,
                                                             **kw),
                           iters=3, warmup=0),
        "v1_frozen": med("v1 frame, structure frozen: trace_primary",
                         lambda: rv.trace_primary(*rays, cam=ca,
                                                  canonical=True)),
    }
    rd.screen.kernel_name = "visits"
    rd.freeze_primary_structure(ca)
    ms["visits_frozen"] = med("visits frame, structure frozen: "
                              "trace_primary", lambda: rd.trace_primary(
                                  *rays, cam=ca, canonical=True))
    for eng in (rv, rd):
        if not eng.prepare_primary(ca, W, H):
            raise AssertionError("prepare_primary declined the frame")
    ms["v1_prep"] = med("v1 frame with the prep: trace_primary",
                        lambda: rv.trace_primary(*rays, cam=ca,
                                                 canonical=True))
    ms["visits_prep"] = med("visits frame with the prep: trace_primary",
                            lambda: rd.trace_primary(*rays, cam=ca,
                                                     canonical=True))
    rd.screen.kernel_name = "walk"
    log(f"[12] v1 kernel {ms['v1_ez8']:.4f} ms at early-z 8 = "
        f"{ms['v1_ez8'] / b8[0]:.1f}x its bound, {ms['v1_ez0']:.4f} ms "
        f"without = {ms['v1_ez0'] / b0[0]:.1f}x; visits kernel "
        f"{ms['visits']:.4f} ms = {ms['visits'] / dense_bnd[0]:.1f}x the "
        f"walk's bound; frames {R / ms['v1_frozen'] / 1e3:.2f} (v1) and "
        f"{R / ms['visits_frozen'] / 1e3:.2f} (visits) Mrays/s frozen, "
        f"{R / ms['v1_prep'] / 1e3:.2f} and "
        f"{R / ms['visits_prep'] / 1e3:.2f} with the prep; on {smi}")
    torch.cuda.synchronize()
    return [
        {"name": "binraster_v1", "route": "cuda", "source": V1_SOURCE,
         "replaces": V1_REPLACES, "launches": frames["binraster"][1],
         "max_abs_err": 0.0, "ms": ms["v1_ez8"], "plain_ms": ms["v1_twin"],
         "bound_ms": b8[0], "bound_by": b8[1], "library_ms": None},
        {"name": "dense_visits", "route": "cuda", "source": VISITS_SOURCE,
         "replaces": VISITS_REPLACES, "launches": frames["visits"][1],
         "max_abs_err": 0.0, "ms": ms["visits"],
         "plain_ms": ms["visits_twin"], "bound_ms": dense_bnd[0],
         "bound_by": dense_bnd[1], "library_ms": None}]


# -- phase 13: the node-batch and deferred-leaf packet kernels -------------

# The soup checks: (engine, knobs, (tris_per_row, nodes_per_row),
# triangles), all on the same 65,536 random rays. A twin's time goes with
# the steps of the packet that walks longest, and a packet of random rays
# walks nearly the whole soup: dleaf's twin (one node a step) took 35 s a
# call on phase 3's 5,000 triangles (NVIDIA H100 80GB HBM3, 700 W), so
# dleaf runs on a 500-triangle soup and bdl's knob variants on a
# 1,000-triangle one.
BATCH_SOUP = (
    ("packet_bfs", {}, (12, 1), 5000),
    ("packet_bdl", {}, (12, 1), 5000),
    ("packet_dleaf", {}, (12, 1), 500),
    ("packet_dleaf", {}, (4, 8), 500),
    ("packet_dleaf", {"drain_min": 1}, (12, 1), 500),
    ("packet_dleaf", {"drain_min": 64}, (12, 1), 500),
    ("packet_bdl", {"merge_sibs": True}, (12, 1), 1000),
    ("packet_bdl", {"qgroup": 4}, (12, 1), 1000),
    ("packet_bdl", {"qgroup": 4, "merge_sibs": True}, (12, 1), 1000),
    ("packet_bdl", {"drain_min": 1}, (12, 1), 1000),
    ("packet_bdl", {"drain_min": 64}, (12, 1), 1000),
)
# The renderer's packet of the node-batch engines, in rays.
BATCH_PACKET = WARP * registry.batch_knobs("packet_bfs",
                                           RenderConfig())["rows"]
BATCH_TWIN_S = 1.0        # twin seconds a phase-13 slice may grow to
BATCH_SCHEDULES = {"packet_bfs": packet_batch.BFS,
                   "packet_dleaf": packet_batch.DLEAF,
                   "packet_bdl": packet_batch.BDL}


def batch_steps(name: str, work: dict, n: int, any_hit: bool) -> str:
    """A node-batch twin's work on n rays, per packet: steps, drains, rows
    tested in drains (summed over groups) and block barriers by the rule
    of the template that routed by one thread (one to start, then 3 a
    step for bfs and 4 for dleaf and bdl, one more with any hit, 2 a
    drain) and by the two-barrier step's (one to start, 2 a step); per
    ray: slot tests."""
    packets = -(-n // BATCH_PACKET)
    steps = work["packet_steps"] / packets
    drains = work["packet_drains"] / packets
    old = 1 + steps * (3 + (name != "packet_bfs") + any_hit) + 2 * drains
    return (f"per packet {steps:.1f} steps, {drains:.1f} drains of "
            f"{work['drain_rows'] / packets:.1f} rows, block barriers "
            f"{old:.1f} by the serial-routing rule and "
            f"{1 + 2 * steps:.1f} by two a "
            f"step; per ray {work['tri_slot_tests'] / n:.2f} slot tests")


def batch_ptxas(log: str, max_depth: int) -> str:
    """ptxas's registers and shared memory of each batch_kernel
    instantiation, from the build log ([2]), with the registers, shared
    memory a block and resident blocks an SM that the CUDA runtime gives
    a launch at the renderer's knobs (8 warps a packet, qgroup 1) on
    tables of depth max_depth."""
    found = {}
    for m in re.finditer(r"Compiling entry function '\w*batch_kernel"
                         r"ILi(\d)ELb(\d)ELx\d+ELb(\d)E\w*'"
                         r"(?:(?!Compiling entry).)*?Used (\d+) registers"
                         r"(?:[^\n]*?(\d+) bytes smem)?", log, re.DOTALL):
        found[m.group(1), m.group(2), m.group(3)] = (m.group(4),
                                                     m.group(5) or "0")
    out = []
    for name, sched in BATCH_SCHEDULES.items():
        for any_hit in (False, True):
            key = (str(sched.batch), str(int(sched.queued)),
                   str(int(any_hit)))
            regs, smem, blocks = packet_batch.occupancy(
                sched, max_depth, any_hit, BATCH_PACKET // WARP)
            ptx = (f"ptxas {found[key][0]} registers, {found[key][1]} B "
                   "static smem; " if key in found else "")
            out.append(f"{name} any_hit={int(any_hit)}: {ptx}{regs} "
                       f"registers, {smem} B shared memory a block, "
                       f"{blocks} blocks an SM")
    return "; ".join(out)


def phase_soup_batch(device):
    """Phase 13, first check: the phase-3 soup check through each new
    kernel (65,536 random rays; smaller soups where BATCH_SOUP says why):
    bfs and bdl at (tris_per_row, nodes_per_row) = (12, 1) on phase 3's
    5,000 triangles; dleaf at (12, 1) and (4, 8), and at drain_min 1 and
    64, on 500; bdl at qgroup 1 and 4, each with and without merge_sibs,
    and at drain_min 1 and 64, on 1,000. Closest hit bit-equal to the
    twin and to the packet kernel on every ray, misses included; any hit
    bit-equal to the twin (tri included); closest hits exact against
    brute_force_mt, any-hit tri >= 0 against brute_force_anyhit."""
    rays_np = random_rays(np.random.default_rng(2024), 65_536)
    rays = [torch.from_numpy(a).to(device) for a in rays_np]
    shadow = rays[:3] + [torch.full_like(rays[3], 14.0)]
    sub = np.arange(0, 65_536, 16)
    soups = {}
    for n_tris in sorted({c[3] for c in BATCH_SOUP}):
        soup = make_random_soup(n_tris=n_tris, seed=11)
        soups[n_tris] = (
            soup, build_accel(soup, BuildConfig(builder="binned_sah")),
            brute_force_mt(soup, *(a[sub] for a in rays_np)),
            brute_force_anyhit(soup, *(a[sub] for a in rays_np[:3]),
                               np.full(len(sub), 14.0, np.float32)), {})
    for name, kw, (tpr, npr), n_tris in BATCH_SOUP:
        soup, flat, bf, blocked, tables = soups[n_tris]
        if (tpr, npr) not in tables:
            tb = tables_from_packed(
                pack_bvh(flat, soup.tri_verts(), tris_per_row=tpr,
                         nodes_per_row=npr), device)
            tables[tpr, npr] = tb, trace_packet(tb, *rays)
        tb, packet = tables[tpr, npr]
        kernel, twin = BATCH_ENGINES[name][:2]
        label = (f"soup {n_tris} {name} "
                 f"{json.dumps(kw) if kw else 'defaults'} tpr={tpr} npr={npr}")
        t0 = time.perf_counter()
        kern = kernel(tb, *rays, **kw)
        compare(kern, twin(tb, *rays, **kw), f"{label} vs twin")
        compare(kern, packet, f"{label} vs packet kernel")
        if not np.array_equal(kern[0].cpu().numpy()[sub], bf.tri):
            raise AssertionError(f"{label}: tri differs from brute_force_mt")
        ka = kernel(tb, *shadow, any_hit=True, **kw)
        compare(ka, twin(tb, *shadow, any_hit=True, **kw),
                f"{label} any-hit vs twin")
        if not np.array_equal(ka[0].cpu().numpy()[sub] >= 0, blocked):
            raise AssertionError(f"{label}: any-hit tri>=0 differs from "
                                 "brute_force_anyhit")
        log(f"[13] {label}: closest hit bit-equal to the twin and to the "
            f"packet kernel on all 65536 rays; any hit bit-equal to the twin "
            f"(tri included, blocked {float((ka[0] >= 0).float().mean()):.3f}"
            f"); exact vs brute_force_mt and brute_force_anyhit on "
            f"{len(sub)} ({time.perf_counter() - t0:.1f} s with the twins)")


def phase_batch_twins(tables, secondary, entries):
    """Phase 13: each new kernel bit-equal to its twin on a contiguous slice
    of whole packets of every batch (grow_slice within BATCH_TWIN_S), any
    hit tri included. Adds each twin's work, tables and scale to `entries`
    (batch -> schedule -> (tables, work, scale))."""
    batches = [("primary", secondary["shadow"][1]["primary"])] + [
        (p, secondary[m][1][p]) for m in SECONDARY_MODES
        for p in PASSES[m][1:]]
    for bname, (rays, any_hit, _) in batches:
        R = rays[0].shape[0]
        for name, (kernel, twin, *_) in BATCH_ENGINES.items():
            tb = tables[name]

            def run(sl):
                work = work_with_reads(tb)
                return twin(tb, *sl, any_hit=any_hit, work=work), work

            sl, tw, work, secs, start = grow_slice(
                run, rays, BATCH_PACKET, 8 * BATCH_PACKET, BATCH_TWIN_S)
            n = sl[0].shape[0]
            compare(kernel(tb, *sl, any_hit=any_hit), tw,
                    f"[13] {name} on the {bname} slice vs twin")
            entries[bname][name] = (tb, work, R / n)
            whole = ""
            if name == "packet_bfs" and bname in ("ao", "diffuse"):
                # The whole-packet rule bfs followed before: one queue for
                # the packet (bdl at qgroup = rows), every warp testing
                # every run the packet wants.
                wq = {}
                trace_packet_bdl_ref(tb, *sl, any_hit=any_hit,
                                     qgroup=BATCH_PACKET // WARP, work=wq)
                whole = (f" (the whole-packet rule, bdl's twin at qgroup = "
                         f"rows: {wq['tri_slot_tests'] / n:.2f})")
            log(f"[13] {name} {bname}: kernel bit-equal to twin on rays "
                f"{start}..+{n} of {R} ({-(-n // BATCH_PACKET)} packets, "
                f"{'any' if any_hit else 'closest'} hit, tri included; twin "
                f"{secs:.2f} s); per ray {work['node_visits'] / n:.2f} node "
                f"visits; " + batch_steps(name, work, n, any_hit) + whole)


def phase_batch_lbvh(lbvh_tables, lbvh_res, batch, width, height):
    """Phase 13: phase 7's LBVH tables, built on the card at nodes_per_row
    1, traced by each new kernel on phase 7's primary batch: tri/t/u/v
    bit-equal to the packet kernel on the same tables, and tri and t equal
    to phase 7's frame on every ray."""
    rays = (batch.orig, batch.dirn, batch.tmin, batch.tmax)
    order, _ = pixel_table(width, height)
    slot = order.astype(np.int64)
    frame_tri = torch.from_numpy(lbvh_res.hit_tri[slot]).to(rays[0].device)
    frame_t = torch.from_numpy(lbvh_res.hit_t[slot]).to(rays[0].device)
    want = trace_packet(lbvh_tables, *rays)
    for name, (kernel, *_) in BATCH_ENGINES.items():
        got = kernel(lbvh_tables, *rays)
        compare(got, want, f"[13] {name} on the LBVH tables vs packet kernel")
        if not (torch.equal(got[0], frame_tri)
                and torch.equal(got[1], frame_t)):
            raise AssertionError(f"[13] {name} on the LBVH tables: differs "
                                 "from phase 7's frame")
    log(f"[13] LBVH tables (built on the card, nodes_per_row "
        f"{lbvh_tables.nodes_per_row}, {lbvh_tables.num_nodes} nodes, depth "
        f"{lbvh_tables.max_depth}): packet_bfs, packet_dleaf and packet_bdl "
        f"each traced phase 7's {rays[0].shape[0]} primary rays bit-equal to "
        f"the packet kernel on the same tables and to phase 7's frame (tri "
        f"and t)")


def phase_batch_timing(tables, primary, secondary, entries, full, smi):
    """Phase 13 times, CUDA events, warm, medians of 10 (3 where one call
    takes over 2 s): each new kernel on phase 5's primary frame and the
    shadow, AO and diffuse batches, beside the batch's bound (batch_bound
    over all eight twins: full counts on the primary frame, slices and
    samples elsewhere) and its own work; the new twins on the primary
    frame (their full counts; median of 3, or one run where it takes over
    3 s). Returns the primary bound and the rows for the kernels line."""
    full = dict(full)
    plain = {}
    for name, (_, twin, *_) in BATCH_ENGINES.items():
        tb = tables[name]
        w = work_with_reads(tb)
        t = cuda_ms(lambda: twin(tb, *primary, work=w), warmup=0, iters=1)
        if t[0] <= 3_000:
            t += cuda_ms(lambda: twin(tb, *primary), warmup=0, iters=2)
        plain[name] = statistics.median(t)
        full[name] = (tb, w, 1.0)
        log(f"[13] {name} primary frame: twin "
            + ", ".join(f"{x:.1f}" for x in t) + f" ms (median "
            f"{plain[name]:.1f}); full count {w['node_visits']} ray node "
            f"visits, {w['tri_slot_tests']} slot tests on {smi}")
    batches = {"primary": (primary, False, full),
               "shadow": secondary["shadow"][1]["shadow"][:2]
               + (entries["shadow"],),
               "ao": secondary["ao"][1]["ao"][:2] + (entries["ao"],),
               "diffuse": secondary["diffuse"][1]["diffuse"][:2]
               + (entries["diffuse"],)}
    times, bounds = {}, {}
    for bname, (rays, any_hit, ent) in batches.items():
        R = rays[0].shape[0]
        b, by, least = bounds[bname] = batch_bound(rays, ent)
        log(f"[13] {bname} batch, {R} rays, "
            f"{'any' if any_hit else 'closest'} hit: bound {b:.4f} ms by "
            f"{by} (the least of the {len(ent)} twins' work, {least}'s; "
            + ("full counts" if bname == "primary" else "sampled work")
            + ")")
        for name, (kernel, *_) in BATCH_ENGINES.items():
            tb, w, scale = ent[name]
            once = cuda_ms(lambda: kernel(tb, *rays, any_hit=any_hit),
                           warmup=1, iters=1)[0]
            iters = 10 if once <= 2000 else 3
            t = cuda_ms(lambda: kernel(tb, *rays, any_hit=any_hit),
                        warmup=0, iters=iters)
            ms = statistics.median(t)
            times[bname, name] = ms
            own, _ = bound(0, (w["node_visits"] * NODE_VISIT_OPS
                               + w["tri_slot_tests"] * MT_OPS) * scale)
            log(f"[13] {bname} batch: {name} median {ms:.4f} ms of {iters} "
                f"(min {min(t):.4f}, max {max(t):.4f}) = "
                f"{R / ms / 1e3:.2f} Mrays/s, {ms / b:.1f}x the batch's "
                f"bound; its own work {w['node_visits'] * scale:.0f} ray "
                f"node visits, {w['tri_slot_tests'] * scale:.0f} slot tests "
                f"({own:.4f} ms of FP32 operations); twin's "
                + batch_steps(name, w, round(R / scale), any_hit)
                + f"; on {smi}")
    rows = {name: {"ms": times["primary", name], "plain_ms": plain[name],
                   "bound": bounds["primary"][:2]}
            for name in BATCH_ENGINES}
    torch.cuda.synchronize()
    return bounds["primary"][:2], rows


# -- phase 14: the exact byte-plane gather ----------------------------------

GATHER_SOURCE = "ntrace_tpu_torch/csrc/gather.cu"
GATHER_REPLACES = "ntrace_tpu/ops/gather.py:45"
# The reference's test cases, tests/test_gather.py:30-34: (rows, columns,
# requests, page, tile).
GATHER_CASES = ((1000, 16, 2048, 256, 256), (100, 12, 513, 128, 128),
                (65536, 16, 4096, 512, 512))
GATHER_SPECIAL = (np.inf, -np.inf, -0.0, np.nan, 1e-38, 255.5)
GATHER_RANDOM_ROWS = 1 << 20     # gather (b): uniform random requests


def gather_table(rng, n, c):
    """A standard-normal (n, c) f32 table whose first and last words hold
    GATHER_SPECIAL, and one NaN with a payload of its own."""
    t = rng.standard_normal((n, c)).astype(np.float32)
    flat = t.reshape(-1)
    flat[:len(GATHER_SPECIAL)] = GATHER_SPECIAL
    flat[-len(GATHER_SPECIAL):] = GATHER_SPECIAL
    flat[len(GATHER_SPECIAL)] = np.array([0x7FC01234],
                                         np.int32).view(np.float32)[0]
    return t


def phase_gather_cases(device):
    """Phase 14, first check: the reference's test cases (its three shapes,
    then skewed and repeated indices on a 512 x 8 table at page and tile
    128) through GatherTable on the card, bit-equal as int32 to the plain
    version on the same padded inputs and to table[idx]. Returns the max
    abs error, 0.0."""
    rng = np.random.default_rng(14)
    skew = np.concatenate([np.zeros(200, np.int32),
                           np.full(200, 511, np.int32),
                           rng.integers(0, 128, 112).astype(np.int32)])
    cases = [(n, c, page, tile, rng.integers(0, n, q).astype(np.int32))
             for n, c, q, page, tile in GATHER_CASES]
    cases.append((512, 8, 128, 128, skew))
    for n, c, page, tile, idx in cases:
        table = gather_table(rng, n, c)
        idx[:2] = [0, n - 1]     # the rows that hold the special values
        gt = GatherTable(table, page=page, tile=tile, device=device)
        got = gt(torch.from_numpy(idx).to(device))
        want = table[idx].view(np.int32)
        if not np.array_equal(got.cpu().numpy().view(np.int32), want):
            raise AssertionError(f"gather {(n, c, len(idx), page, tile)}: "
                                 "differs from table[idx]")
        qp = -(-len(idx) // tile) * tile
        pidx = torch.zeros(qp, dtype=torch.int32, device=device)
        pidx[:len(idx)] = torch.from_numpy(idx).to(device)
        kw = dict(n_rows=n, c=c, page=page, tile=tile)
        if not _bit_equal(paged_gather_bytes(gt.bytes, pidx, **kw),
                          paged_gather_bytes_ref(gt.bytes, pidx, **kw)):
            raise AssertionError(f"gather {(n, c, qp, page, tile)}: kernel "
                                 "differs from its plain version")
    log(f"[14] gather: kernel bit-equal (int32) to paged_gather_bytes_ref "
        f"and to table[idx] in {len(cases)} cases: {GATHER_CASES} and "
        "skewed/repeated indices (512, 8, 512, 128, 128); tables holding "
        "inf, -inf, -0.0, NaN (two payloads), 1e-38 and 255.5")
    return 0.0


def gather_inputs(flat, diffuse_hits, device):
    """The two real gathers' (table, idx) on the card: (a) the Woop table
    at the Woop row of each diffuse ray's hit triangle (the inverse of
    flat.tri_index; a miss takes row 0), (b) the node table at
    GATHER_RANDOM_ROWS uniform random rows."""
    ti = torch.from_numpy(flat.tri_index).to(device)
    rows = torch.arange(ti.shape[0], dtype=torch.int32, device=device)
    inv = torch.zeros(flat.num_tris, dtype=torch.int32, device=device)
    inv[ti[ti >= 0].long()] = rows[ti >= 0]
    tri = diffuse_hits[0]
    idx_a = torch.where(tri >= 0, inv[tri.clamp(min=0).long()], 0)
    nodes = torch.from_numpy(flat.nodes).to(device)
    idx_b = torch.from_numpy(np.random.default_rng(15).integers(
        0, nodes.shape[0], GATHER_RANDOM_ROWS).astype(np.int32)).to(device)
    woop = torch.from_numpy(np.ascontiguousarray(flat.woop)).to(device)
    return {"a": (woop, idx_a.to(torch.int32).contiguous()),
            "b": (nodes, idx_b)}


def phase_gather(inputs):
    """Phase 14, the gather's main path: GatherTable built and called on
    each real gather, the launch count set to 0 just before and read just
    after; each result bit-equal to table[idx] (torch indexing on the
    card). Returns the launches and the GatherTables."""
    paged_gather_bytes.launches = 0
    tables = {k: GatherTable(tab, device=tab.device)
              for k, (tab, _) in inputs.items()}
    outs = {k: tables[k](idx) for k, (_, idx) in inputs.items()}
    launches = paged_gather_bytes.launches
    if launches != len(inputs):
        raise AssertionError(f"the gathers launched {launches} kernels, "
                             f"want {len(inputs)}")
    for k, (tab, idx) in inputs.items():
        if not _bit_equal(outs[k], tab[idx.long()]):
            raise AssertionError(f"gather ({k}) differs from table[idx]")
        log(f"[14] gather ({k}): {idx.shape[0]} rows of a "
            f"{tuple(tab.shape)} table, bit-equal to table[idx]")
    return launches, tables


def gather_bytes(idx: torch.Tensor, c: int):
    """(bytes, rows): the least bytes one gather of idx from a C-column
    f32 table moves through HBM: the indices (4Q), each table row that idx
    touches once (the `rows` unique rows of this run's idx, 4C bytes each,
    no more than the 4CQ a row a request would read) and the rows written
    (4CQ)."""
    q = idx.shape[0]
    rows = int(torch.unique(idx).numel())
    return 4 * q + min(4 * c * q, 4 * c * rows) + 4 * c * q, rows


def phase_gather_timing(inputs, tables, smi):
    """Phase 14 times, CUDA events, warm, medians of 10: GatherTable's call,
    the plain version and four single PyTorch calls of the same function
    (index_select and indexing, each with the int32 indices and with
    int64 copies made before the clock starts), beside the bound of
    gather_bytes over the HBM rate. library_ms is the fastest of the four.
    """
    rows = {}
    for k, (tab, idx) in inputs.items():
        gt = tables[k]
        q, c = idx.shape[0], gt.c
        kw = dict(n_rows=gt.n_rows, c=c, page=gt.page, tile=gt.tile)
        qp = -(-q // gt.tile) * gt.tile
        pidx = torch.cat([idx, idx.new_zeros((qp - q,))])
        idx64 = idx.long()
        library = {
            "index_select i32": lambda: torch.index_select(tab, 0, idx),
            "index_select i64": lambda: torch.index_select(tab, 0, idx64),
            "tab[idx] i32": lambda: tab[idx],
            "tab[idx] i64": lambda: tab[idx64]}
        t = {}
        for name, fn in (
                ("kernel", lambda: gt(idx)),
                ("plain", lambda: paged_gather_bytes_ref(gt.bytes, pidx,
                                                         **kw)),
                *library.items()):
            times = cuda_ms(fn, warmup=2, iters=10)
            t[name] = statistics.median(times)
            log(f"[14] gather ({k}) {name}: median {t[name]:.4f} ms of 10 "
                f"(min {min(times):.4f}, max {max(times):.4f}) on {smi}")
        lib = min(library, key=t.get)
        nb, touched = gather_bytes(idx, c)
        b, by = bound(nb, 0)
        log(f"[14] gather ({k}): Q {q}, C {c}, {touched} unique rows: "
            f"bound {b:.4f} ms by {by} ({nb / 1e6:.1f} MB at 3.35 TB/s); "
            f"kernel "
            f"{t['kernel'] / b:.2f}x the bound, {t['kernel'] / t[lib]:.2f}x "
            f"the fastest library call ({lib}, {t[lib]:.4f} ms)")
        rows[k] = {"ms": t["kernel"], "plain_ms": t["plain"],
                   "library_ms": t[lib], "bound": (b, by)}
    torch.cuda.synchronize()
    return rows


# -- phase 15: BASELINE config #3, fairy with the HLBVH build ----------------

FAIRY_TRIS = 170_000          # get_scene("fairy") -> 169,808 tris
HLBVH_CFG = BuildConfig(builder="hlbvh", max_leaf_size=32, sah_tri_cost=0.02)
FAIRY_SAH_CFG = BuildConfig(builder="binned_sah", max_leaf_size=32,
                            sah_tri_cost=0.02)
WOOP_ULPS = 64                # as tests/test_torch_lbvh.py
FOREST_KEYS = ("order", "cluster_ids", "cluster_roots", "node_count",
               "leaf_count", "n_clusters", "tri_index", "nodes")


def woop_ulps(ref: torch.Tensor, got: torch.Tensor) -> float:
    """The largest |ref - got| in ulp of each row's largest |ref|."""
    ref, got = ref.cpu().double(), got.cpu().double()
    scale = ref.abs().amax(dim=1, keepdim=True).clamp(min=1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(scale)) - 23)
    return float(((ref - got).abs() / ulp).max()) if ref.numel() else 0.0


def check_flat_tree(tag, flat, n):
    """A FlatBVH is a tree rooted at node 0 (every other node named once
    by an internal link) and its leaves hold every triangle once."""
    enc = np.ascontiguousarray(flat.nodes[:, 12:14]).view(np.int32)
    nn = flat.nodes.shape[0]
    inner = enc[enc >= 0]
    counts = np.bincount(inner, minlength=nn)
    if inner.max(initial=0) >= nn or counts[0] or (counts[1:] != 1).any():
        raise AssertionError(f"{tag}: the links do not form a tree")
    ids = np.sort(flat.tri_index[flat.tri_index >= 0])
    if not np.array_equal(ids, np.arange(n)):
        raise AssertionError(f"{tag}: triangle ids are not each in one leaf")
    log(f"{tag} structure: {nn} nodes, root 0, every other node named "
        f"once; all {n} triangle ids once each")


def phase_hlbvh_build(device, scene):
    """Phase 15, the build: the forest sweep on the card, bit-equal to the
    same sweep on the CPU (the Woop rows within WOOP_ULPS); the forest
    path taken (at least 2 clusters, internal nodes, and the splice: every
    top leaf holds one box); the spliced tree checked. Returns the sweep's
    row-scan launches and the FlatBVH."""
    reset_counts()
    out = hlbvh.forest_sweep(scene, HLBVH_CFG, device)
    scans = row_scan_i32.launches
    ncl, nc = int(out["n_clusters"]), int(out["node_count"])
    if ncl < 2 or nc == 0:
        raise AssertionError(f"HLBVH: {ncl} clusters, {nc} forest nodes: the "
                             "build fell back to the plain LBVH")
    t0 = time.perf_counter()
    cpu = hlbvh.forest_sweep(scene, HLBVH_CFG, "cpu")
    cpu_s = time.perf_counter() - t0
    bad = [k for k in FOREST_KEYS if not _bit_equal(out[k], cpu[k])]
    if bad:
        raise AssertionError(f"HLBVH forest: the card's sweep differs from "
                             f"the CPU's in {bad}")
    ulps = woop_ulps(cpu["woop"], out["woop"])
    if ulps > WOOP_ULPS:
        raise AssertionError(f"HLBVH forest: Woop rows {ulps} ulp apart")
    log(f"[15] forest sweep ({scene.num_tris} tris, cluster_shift "
        f"{hlbvh.cluster_shift(HLBVH_CFG)}): {ncl} clusters, {nc} forest "
        f"nodes, {int(out['leaf_count'])} leaves, {scans} row_scan launches; "
        f"card bit-equal to the CPU sweep ({cpu_s:.1f} s) in "
        f"{', '.join(FOREST_KEYS)}; Woop rows "
        + ("bit-equal" if _bit_equal(out["woop"], cpu["woop"])
           else f"within {ulps:.1f} ulp"))
    flat = hlbvh.splice_forest(scene, HLBVH_CFG, out)
    if flat is None:
        raise AssertionError("HLBVH: a top leaf holds more than one box; "
                             "the build fell back to the plain LBVH")
    log(f"[15] splice: {flat.nodes.shape[0] - nc} top nodes over {ncl} "
        "cluster leaves of one box each, then the forest's")
    check_flat_tree("[15]", flat, scene.num_tris)
    return scans, flat


def phase_fairy(device, n_tris=FAIRY_TRIS, width=WIDTH, height=HEIGHT):
    """Phase 15: BASELINE config #3. The build checks, then the main path
    with every count set to 0 just before and read just after:
    Renderer(builder="hlbvh", engine "auto") builds on the card (the
    device route), render(diffuse) and render(ao) trace through the
    packet kernel; its tables hold the host route's tree, and its frames
    equal the host route renderer's; every pass through check_pass; the
    primary frame against the binned-SAH tree's. Returns the renderer,
    the host route's FlatBVH and the passes by mode."""
    t0 = time.perf_counter()
    scene = get_scene("fairy", n_tris=n_tris)
    log(f"[15] scene fairy: {scene.num_tris} tris in "
        f"{time.perf_counter() - t0:.1f} s")
    _, flat = phase_hlbvh_build(device, scene)
    camera = default_camera("fairy")
    rc = RenderConfig(width=width, height=height, engine="auto")

    reset_counts()
    rh = Renderer(scene, HLBVH_CFG, rc, device=device)
    passes = {}
    for mode in ("diffuse", "ao"):
        with recorded(rh) as got, tracing():
            res = rh.render(camera, mode)
        passes[mode] = (res, got)
    counts = launch_counts()
    check_raygen_launches("[15] diffuse and AO", "ao", counts, frames=2)
    if counts["row_scan"] != 4 or counts["child_boxes"] != 2 \
            or counts["packet"] != 4 or any(
                counts[k] for k in ALL_ENGINES if k != "packet"):
        raise AssertionError(f"config #3 launches {counts}: want one "
                             "device build's 4 row-scan and 2 child-box "
                             "launches and 4 packet launches")
    built = rh.timer.counts
    if rh.flat is not None or built["build_fallbacks"] \
            or built["build_clusters"] < 2:
        raise AssertionError(f"Renderer(builder='hlbvh'): not the device "
                             f"route's HLBVH ({built})")
    packed = pack_bvh(flat, scene.tri_verts(), tris_per_row=12,
                      nodes_per_row=1)
    if tree_form(rh.tables.nodes8) != tree_form(packed.nodes8) or \
            not np.array_equal(rh.tables.tris12.cpu().numpy(),
                               packed.tris12):
        raise AssertionError("the device route's HLBVH tables differ from "
                             "the host route's tree")
    rf = Renderer(scene, HLBVH_CFG, rc, flat=flat, device=device)
    for mode, (res, _) in passes.items():
        want = rf.render(camera, mode)
        bad = [a for a in ("image", "hit_tri", "hit_t")
               if not np.array_equal(getattr(res, a), getattr(want, a))]
        if bad:
            raise AssertionError(f"[15] render({mode}): the device route "
                                 f"differs from the host route in {bad}")
    log(f"[15] device route: {int(built['build_clusters'])} clusters, "
        f"{int(built['build_top_nodes'])} top nodes, "
        f"{rh.tables.num_nodes} nodes; the host route's tree one node a "
        "row, triangle rows bit-equal; diffuse and AO frames (image, "
        "hit_tri, hit_t) bit-equal to the host route renderer's")
    del rf
    depth = rh.tables.max_depth
    if depth >= STACK_DEPTH:
        raise AssertionError(f"HLBVH tables {depth} deep; the packet stack "
                             f"holds {STACK_DEPTH}")
    log(f"[15] Renderer(builder='hlbvh'): counts "
        + json.dumps({k: v for k, v in counts.items() if v})
        + f", tables {rh.tables.num_nodes} nodes, max_depth {depth} (stack "
        f"{STACK_DEPTH}), layout tpr={rh.tables.tris_per_row} "
        f"npr={rh.tables.nodes_per_row}, build {rh.timer.ms()['build']:.1f}"
        " ms")
    for mode, (res, got) in passes.items():
        check_image(f"[15] render({mode})", res.image, width, height)
        if len(got) != 2:
            raise AssertionError(f"render({mode}) traced {len(got)} passes")
        log(f"[15] render({mode}): image mean {res.image.mean():.4f}, "
            "stages " + json.dumps({k: round(v, 3)
                                    for k, v in res.stats.items()}))
        names = ("primary", mode)
        for name, (rays, any_hit, hits) in zip(names, got):
            if name == "primary" and mode == "ao":
                continue   # the same primary rays as diffuse's
            check_pass(f"[15] {mode} pass {name}", scene, flat, rays,
                       any_hit, hits)
    phase_fairy_builders(rh, scene, camera, width, height)
    return rh, flat, {m: dict(zip(("primary", m), got))
                      for m, (_, got) in passes.items()}


def phase_fairy_builders(rh, scene, camera, width, height):
    """Phase 15: the fairy primary frame through the HLBVH tree and through
    the binned-SAH tree (the matrix's supplementary row,
    scripts/benchmark_matrix.py:65), tri compared on every ray;
    brute_force_mt decides each difference, and must side with HLBVH."""
    rs = Renderer(scene, FAIRY_SAH_CFG, RenderConfig(width=width,
                                                    height=height),
                  flat=build_accel(scene, FAIRY_SAH_CFG), device=rh.device)
    hl, sah = rh.render(camera), rs.render(camera)
    order, _ = pixel_table(width, height)
    slot = order.astype(np.int64)
    tri_h, tri_s = hl.hit_tri[slot], sah.hit_tri[slot]
    diff = np.nonzero(tri_h != tri_s)[0]
    if len(diff):
        batch = raygen.primary(raygen.camera_arrays(camera, width, height,
                                                    rh.device),
                               width, height, torch.from_numpy(order.copy()))
        host = [a.cpu().numpy()[diff] for a in (batch.orig, batch.dirn,
                                                batch.tmin, batch.tmax)]
        bf = brute_force_mt(scene, *host)
        wrong = int((tri_h[diff] != bf.tri).sum())
        if wrong:
            raise AssertionError(f"HLBVH vs binned-SAH fairy frame: "
                                 f"brute_force_mt sides against HLBVH on "
                                 f"{wrong} of {len(diff)} rays")
    log(f"[15] HLBVH vs binned-SAH fairy frame on all {len(slot)} rays: tri "
        f"differs on {len(diff)}"
        + (", each decided by brute_force_mt for HLBVH" if len(diff) else "")
        + f"; hit rate {(tri_h >= 0).mean():.4f}")


def phase_fairy_timing(rh, flat, passes, smi):
    """Phase 15 times: the host route's build in its parts (inputs to the
    card; the forest sweep, CUDA events, median of 10; the host top tree
    and splice, the host pack and upload and build_accel, host clock,
    median of 5 or 3), the device route's update_positions (host clock,
    synchronised, median of 10, and one traced call's stages), and the
    packet kernel on each pass's batch (CUDA events, warm, median of 10),
    bit-equal to its twin on a stride sample whose work gives the
    bound."""
    scene, dev, n = rh.scene, rh.device, rh.scene.num_tris

    def host_ms(fn, iters=5):
        times = []
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    args = lbvh.device_inputs(scene, dev)
    parts = {"inputs": host_ms(lambda: lbvh.device_inputs(scene, dev))}
    sweep = cuda_ms(lambda: lbvh.lbvh_device(
        *args, max_leaf=HLBVH_CFG.max_leaf_size,
        cluster_shift=hlbvh.cluster_shift(HLBVH_CFG)), warmup=1, iters=10)
    parts["sweep"] = statistics.median(sweep)
    out = hlbvh.forest_sweep(scene, HLBVH_CFG, dev)
    parts["splice"] = host_ms(lambda: hlbvh.splice_forest(scene, HLBVH_CFG,
                                                          out))
    _, _, tpr, npr = registry.pick_layout(flat)
    parts["pack"] = host_ms(lambda: tables_from_packed(pack_bvh(
        flat, scene.tri_verts(), tris_per_row=tpr, nodes_per_row=npr),
        dev))
    parts["build_accel"] = host_ms(lambda: build_accel(scene, HLBVH_CFG,
                                                       device=dev), iters=3)
    rest = torch.from_numpy(scene.positions).to(dev)
    parts["update_positions"] = host_ms(lambda: rh.update_positions(rest),
                                        iters=10)
    with tracing():
        st = rh.update_positions(rest)
    log("[15] update_positions traced: " + json.dumps(
        {k: round(v, 3) for k, v in st.items()}))
    log("[15] HLBVH build (ms, ms/Mtri): " + "; ".join(
        f"{k} {v:.3f} ({v / (n / 1e6):.3f})" for k, v in parts.items())
        + f" (sweep min {min(sweep):.3f}, max {max(sweep):.3f}); on {smi}")
    profile_once("[15] profile of one warm forest sweep",
                 lambda: lbvh.lbvh_device(
                     *args, max_leaf=HLBVH_CFG.max_leaf_size,
                     cluster_shift=hlbvh.cluster_shift(HLBVH_CFG)), smi,
                 top=6)

    times = {}
    batches = [("primary", passes["diffuse"]["primary"])] + [
        (m, passes[m][m]) for m in ("diffuse", "ao")]
    for bname, (rays, any_hit, _) in batches:
        R = rays[0].shape[0]
        sample, scale = stride_sample(rays)
        work = work_with_reads(rh.tables)
        tw = trace_packet_ref(rh.tables, *sample, any_hit=any_hit,
                              work=work)
        compare(trace_packet(rh.tables, *sample, any_hit=any_hit), tw,
                f"[15] packet on the {bname} sample vs twin")
        b, by, _ = batch_bound(rays, {"packet": (rh.tables, work, scale)})
        t = cuda_ms(lambda: trace_packet(rh.tables, *rays, any_hit=any_hit),
                    warmup=2, iters=10)
        ms = times[bname] = statistics.median(t)
        log(f"[15] {bname} batch, {R} rays, "
            f"{'any' if any_hit else 'closest'} hit: packet kernel median "
            f"{ms:.4f} ms of 10 (min {min(t):.4f}, max {max(t):.4f}) = "
            f"{R / ms / 1e3:.2f} Mrays/s; bound {b:.4f} ms by {by} (the "
            f"twin's work on a {len(sample[0])}-ray stride sample, bit-equal "
            f"to the kernel: {work['node_visits'] / len(sample[0]):.2f} node "
            f"visits, {work['tri_slot_tests'] / len(sample[0]):.2f} slot "
            f"tests a ray), {ms / b:.1f}x; on {smi}")
    torch.cuda.synchronize()
    return parts, times


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this "
                 "script needs an NVIDIA GPU")

    t_start = time.perf_counter()
    marks = {}   # seconds since the start at the end of each phase

    def mark(phase):
        marks[phase] = round(time.perf_counter() - t_start, 1)

    info = describe("cuda")
    smi = info["nvidia_smi"].splitlines()[0]
    log("[1] " + json.dumps(info))

    b = build()
    ptxas = [ln.strip() for ln in b.log.splitlines()
             if "registers" in ln or "stack frame" in ln]
    log(f"[2] built {b.path.name} in {b.seconds:.1f} s; " + " | ".join(ptxas))
    log(f"[2] while-while ptxas: {ptxas_report(b.log, WW_KERNELS)}")
    log(f"[2] packet and packet_ifif ptxas: "
        f"{ptxas_report(b.log, PACKET_KERNELS)}")

    device = torch.device("cuda")
    phase_soup(device)
    r, batch, launches = phase_main_path(device)
    ms, plain_ms, err = phase_timing(r, batch, smi)
    mark("1-5")
    rd, ca, ops, kw, dense_launches, dense_err, dense_bnd, walk_res = \
        phase_dense(r, batch)
    if min(dense_launches.values()) < 1:
        raise AssertionError(f"a dense main path launched no kernel: "
                             f"{dense_launches}")
    dense_ms = phase_dense_timing(rd, ca, batch, ops, kw, smi)
    mark("6")
    scan_err = phase_scan_kernel(device)
    conf_dev, hair_dev, hair = phase_lbvh_builds(device, r.scene)
    rl, lbvh_counts, lbvh_res = phase_lbvh_frame(r, batch)
    lbvh_ms = phase_lbvh_timing(rl, batch, conf_dev, hair_dev, smi)
    conf = lbvh_ms["conference"]
    lbvh_tables = rl.tables   # phase 13 traces them again
    del rl, conf_dev, hair_dev
    mark("7")

    secondary, raygen_launches = phase_secondary(r, smi)
    raygen_row = phase_secondary_rays("[8]", r, secondary["ao"][1]["primary"],
                                      smi)
    phase_soup_variants(device)
    variant_launches = phase_variant_renders(r, secondary)
    works = phase_variant_twins(r.tables, secondary)
    _, variant_rows, full_counts = phase_variant_timing(
        r.tables, (batch.orig, batch.dirn, batch.tmin, batch.tmax),
        secondary, works, smi)
    phase_hairball_ao(device, hair, smi)
    mark("8-10")

    phase_soup_variants(device, ("packet_pipe",), "[11]")
    phase_soup_wide(device)
    mark("11 soup")
    new_launches, new_r, decided = phase_new_renders(r, secondary)
    mark("11 renders")
    log(f"[11] rays decided by brute_force_mt over every packet_wide pass: "
        f"{decided}")
    wt = new_r["packet_wide"].tables
    pipe = {"packet_pipe": NEW_ENGINES["packet_pipe"]}
    pipe_works = phase_variant_twins(r.tables, secondary, pipe, "[11]")
    entries = {b: {e: (r.tables, w, scale)
                   for e, w in {**bw, **pipe_works[b][1]}.items()}
               for b, (scale, bw) in works.items()}
    phase_wide_twins(wt, secondary, entries)
    mark("11 slices")
    log(f"[11] packet_wide ptxas: {wide_ptxas(b.log)}")
    primary_bnd, new_rows, full_counts = phase_new_timing(
        r.tables, wt, (batch.orig, batch.dirn, batch.tmin, batch.tmax),
        secondary, entries, full_counts, smi)
    del new_r
    phase_hairball_wide_refused(hair, device)
    mark("11")
    screen_rows = phase_screen(r, rd, batch, walk_res, ops, kw, dense_bnd,
                               smi)
    del rd, ops
    if min(row["launches"] for row in screen_rows) < 1:
        raise AssertionError("a screen-space main path launched no kernel: "
                             + json.dumps(screen_rows))
    mark("12")

    phase_soup_batch(device)
    mark("13 soup")
    batch_launches, batch_r, _ = phase_new_renders(
        r, secondary, tuple(BATCH_ENGINES), "[13]", cut=4)
    if min(batch_launches.values()) < 1:
        raise AssertionError(f"a batch engine launched no kernel: "
                             f"{batch_launches}")
    mark("13 renders")
    btables = {name: rv.tables for name, rv in batch_r.items()}
    log("[13] batch_kernel: " + batch_ptxas(
        b.log, btables["packet_bdl"].max_depth))
    phase_batch_twins(btables, secondary, entries)
    mark("13 slices")
    phase_batch_lbvh(lbvh_tables, lbvh_res, batch, WIDTH, HEIGHT)
    _, batch_rows = phase_batch_timing(
        btables, (batch.orig, batch.dirn, batch.tmin, batch.tmax), secondary,
        entries, full_counts, smi)
    mark("13 lbvh, times")
    del batch_r, lbvh_tables

    gather_err = phase_gather_cases(device)
    ginputs = gather_inputs(r.flat, secondary["diffuse"][1]["diffuse"][2],
                            device)
    gather_launches, gtables = phase_gather(ginputs)
    gather_rows = phase_gather_timing(ginputs, gtables, smi)
    del secondary, ginputs, gtables
    mark("14")

    rh, fairy_flat, fairy_passes = phase_fairy(device)
    mark("15 checks")
    phase_fairy_timing(rh, fairy_flat, fairy_passes, smi)
    del rh, fairy_flat, fairy_passes
    mark("15 times")

    log(f"[done] {time.perf_counter() - t_start:.1f} s; seconds since the "
        f"start at the end of each phase: {json.dumps(marks)}")
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
    variant_launches.update(new_launches)
    variant_rows.update(new_rows)
    for name in VARIANTS + tuple(NEW_ENGINES):
        row = variant_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": ALL_ENGINES[name][2],
            "replaces": ALL_ENGINES[name][3],
            "launches": variant_launches[name],
            "max_abs_err": 0.0, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": primary_bnd[0], "bound_by": primary_bnd[1],
            "library_ms": None})
    kernels += screen_rows
    for name, row in batch_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": ALL_ENGINES[name][2],
            "replaces": ALL_ENGINES[name][3],
            "launches": batch_launches[name], "max_abs_err": 0.0,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": None})
    boxes = lbvh_ms["hairball"]["boxes"]
    kernels.append({
        "name": "child_boxes", "route": "cuda", "source": BOXES_SOURCE,
        "replaces": None, "launches": lbvh_counts["child_boxes"],
        "max_abs_err": 0.0, "ms": boxes["kernel"],
        "plain_ms": boxes["plain"], "bound_ms": boxes["bound"][0],
        "bound_by": boxes["bound"][1], "library_ms": None})
    kernels.append({
        "name": "secondary_rays", "route": "cuda",
        "source": SECONDARY_SOURCE, "replaces": None,
        "launches": raygen_launches,
        "max_abs_err": raygen_row["max_abs_err"], "ms": raygen_row["ms"],
        "plain_ms": raygen_row["plain_ms"],
        "bound_ms": raygen_row["bound"][0],
        "bound_by": raygen_row["bound"][1], "library_ms": None})
    ga = gather_rows["a"]
    kernels.append({
        "name": "paged_gather", "route": "cuda", "source": GATHER_SOURCE,
        "replaces": GATHER_REPLACES, "launches": gather_launches,
        "max_abs_err": gather_err, "ms": ga["ms"],
        "plain_ms": ga["plain_ms"], "bound_ms": ga["bound"][0],
        "bound_by": ga["bound"][1], "library_ms": ga["library_ms"]})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
