#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ntrace_tpu_torch) on one NVIDIA GPU.

Drives the port's main paths once, configured as bench.py configures the
JAX reference: the procedural conference scene (297,024 triangles), a
binned-SAH BVH (sah_tri_cost=0.02, max_leaf_size=48), and a 1024x768
primary frame through Renderer.render. Phase 4 traces it with the
hand-written CUDA traversal kernel (ntrace_tpu_torch/csrc/packet_trace.cu);
phase 6 with the dense screen-space engine, as bench.py's tuned reference
does: prep v5 in torch, then the CUDA walk or dma kernel
(ntrace_tpu_torch/csrc/dense_trace.cu).

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
from ntrace_tpu_torch.trace import binraster_dense as bd
from ntrace_tpu_torch.trace.packet import trace_packet, trace_packet_ref
from ntrace_tpu_torch.utils.timing import cuda_ms

KERNEL_SOURCE = "ntrace_tpu_torch/csrc/packet_trace.cu"
KERNEL_REPLACES = "ntrace_tpu/trace/packet_pallas.py:99"
DENSE_SOURCE = "ntrace_tpu_torch/csrc/dense_trace.cu"
DENSE_REPLACES = {"walk": "ntrace_tpu/trace/binraster_dense.py:757",
                  "dma": "ntrace_tpu/trace/binraster_dense.py:1022"}
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


def profile_render(r, smi, tag="[5]"):
    """One warm render() under torch.profiler: device time by kernel and
    the device's busy share of the frame's wall time."""
    camera = default_camera("conference")
    warm = r.render(camera)
    log(f"{tag} warm render() stages without profiler (ms) on {smi}: "
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
    log(f"{tag} profile of one warm render(): wall {wall_ms:.3f} ms, device "
        f"busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%) on {smi}; top: "
        + "; ".join(f"{k[:60]} x{n} {ms:.3f} ms" for k, ms, n in dev[:8]))


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
    return rd, ca, ops, kw, launches, errs


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
    rd, ca, ops, kw, dense_launches, dense_err = phase_dense(r, batch)
    if min(dense_launches.values()) < 1:
        raise AssertionError(f"a dense main path launched no kernel: "
                             f"{dense_launches}")
    dense_ms = phase_dense_timing(rd, ca, batch, ops, kw, smi)

    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    kernels = [{
        "name": "packet_trace", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}]
    for k in ("walk", "dma"):
        kernels.append({
            "name": f"dense_{k}", "route": "cuda", "source": DENSE_SOURCE,
            "replaces": DENSE_REPLACES[k], "launches": dense_launches[k],
            "max_abs_err": dense_err[k], "ms": dense_ms[k],
            "plain_ms": dense_ms["twin"]})
    log(json.dumps({"kernels": kernels}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
