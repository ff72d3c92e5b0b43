#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ntrace_tpu_torch) on one NVIDIA GPU.

Drives the port's main path once, configured as bench.py configures the
JAX reference: the procedural conference scene (297,024 triangles), a
binned-SAH BVH (sah_tri_cost=0.02, max_leaf_size=48), and a 1024x768
primary frame through Renderer.render, whose rays go through the
hand-written CUDA traversal kernel (ntrace_tpu_torch/csrc/packet_trace.cu).

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
Then one JSON line of per-kernel results, the nvidia-smi line, and as the
last line {"ok": true, "device": {...}}. Any failed check raises and the
script exits non-zero. Without a CUDA device it exits non-zero at once.

The script imports no module of the JAX package itself: the reference's
jax-free host layers (scenes, BVH builders, CPU oracles) come through
ntrace_tpu_torch.host, as they do for the port.

Run from the repository root: python3 chip_smoke.py
"""

import json
import statistics
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ntrace_tpu_torch.device import describe
from ntrace_tpu_torch.host import (BuildConfig, RenderConfig, brute_force_mt,
                                   default_camera, get_scene,
                                   golden_mismatches, make_random_soup,
                                   pack_bvh, trace_cpu_golden)
from ntrace_tpu_torch.kernels.build import build
from ntrace_tpu_torch.ray import raygen
from ntrace_tpu_torch.ray.pixeltable import pixel_table
from ntrace_tpu_torch.render.renderer import Renderer, build_accel
from ntrace_tpu_torch.tables import tables_from_packed
from ntrace_tpu_torch.trace.packet import trace_packet, trace_packet_ref
from ntrace_tpu_torch.utils.timing import cuda_ms

KERNEL_SOURCE = "ntrace_tpu_torch/csrc/packet_trace.cu"
KERNEL_REPLACES = "ntrace_tpu/trace/packet_pallas.py:99"
SCENE_TRIS = 280_000          # get_scene("conference") -> 297,024 tris
WIDTH, HEIGHT = 1024, 768
GOLDEN_RAYS = 4096
BRUTE_RAYS = 256


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


def phase_main_path(device, n_tris=SCENE_TRIS, width=WIDTH, height=HEIGHT):
    """Phase 4: the port's main path at full size, plus golden checks."""
    t0 = time.perf_counter()
    scene = get_scene("conference", n_tris=n_tris)
    build_cfg = BuildConfig(builder="binned_sah", sah_tri_cost=0.02,
                            max_leaf_size=48)
    flat = build_accel(scene, build_cfg)
    cfg = RenderConfig(width=width, height=height, mode="primary")
    r = Renderer(scene, build_cfg, cfg, flat=flat, device=device)
    tb = r.tables
    log(f"[4] scene {scene.name} tris={scene.num_tris} nodes={tb.num_nodes} "
        f"engine={r.engine} layout tpr={tb.tris_per_row} "
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
    log(f"[4] golden: 0 tie-aware mismatches on {len(rec.tri)} rays vs "
        f"trace_cpu_golden ({raw} raw id differences); tri exact vs "
        f"brute_force_mt on {len(sub)} rays")
    return r, batch, launches


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


def profile_render(r, smi):
    """One warm render() under torch.profiler: device time by kernel and
    the device's busy share of the frame's wall time."""
    camera = default_camera("conference")
    warm = r.render(camera)
    log("[5] warm render() stages without profiler (ms): "
        + json.dumps({k: round(v, 3) for k, v in warm.stats.items()}))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.render(camera)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only (kernels, memcpys): a CPU op such as
    # aten::copy_ also carries its kernels' device time.
    dev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in dev)
    log(f"[5] profile of one warm render(): wall {wall_ms:.3f} ms, device "
        f"busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%) on {smi}; top: "
        + "; ".join(f"{k[:60]} x{n} {ms:.3f} ms" for k, ms, n in dev[:8]))


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

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "packet_trace", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
