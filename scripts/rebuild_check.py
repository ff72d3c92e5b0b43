"""Check Renderer.update_positions at a moving configuration's full size.

    python3 scripts/rebuild_check.py [--poses 16] [--pixels 256] \
        [--config hairball_dynamic|fairy] [--device cuda:0] [--out FILE]

The configuration's scene, renderer and poses come from the benchmark
(benchmark/lib/program.py, lib/motion.py), its cameras from the walk of
its rebuild cell (BENCHMARK.json's cell of the configuration whose kind
is rebuild_frame). For each pose k, with camera k:
  - one renderer, built once, takes the pose through update_positions;
    a second is built fresh from a host Scene of the pose. Their tables
    (nodes8, tris12) and the AO frame's image, hit_tri and hit_t must be
    bit-equal;
  - HLBVH (builder "hlbvh"): a third renderer takes the host route from
    the same Scene (render/renderer.py:build_accel, then the host pack):
    its image, hit_tri and hit_t must be bit-equal too (`host_route`),
    and the rebuilt tables must hold the tree of build_hlbvh_flat packed
    one node a row, with bit-equal triangle rows (`flat_tree`,
    tables.py:tree_form);
  - `--pixels` pixels of the image, drawn from a fixed seed, against the
    benchmark's plain reference (brute force over the pose's triangles):
    pixel_mismatch and pixel_gap_mean must be 0;
  - the build's kept neighbours of the pose (bvh/lbvh.py:kept_neighbours)
    through the row scan must be bit-equal to its plain version's,
    torch.cummax / cummin (`kept_scans`), and its child boxes through the
    kernel (ops/boxes.py:child_boxes) to the plain version's on the
    build's own queries, the HLBVH forest's cluster boxes among them
    (`child_boxes`).
One JSON line a pose, with the rebuild's stats and times (update_positions
alone and the fresh constructor, host clock, synchronised); the last line
is {"ok": ...}. Exits 1 when a pose fails. A CPU device runs the same
checks at the configuration's size, which takes hours: use the CPU tests
(tests/test_torch_rebuild.py) there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from time import perf_counter
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.lib import checks, program, spec  # noqa: E402
from benchmark.lib.cell import Cell  # noqa: E402
from benchmark.traffic import rebuild_frame as kind  # noqa: E402
from ntrace_tpu_torch.bvh import hlbvh, lbvh  # noqa: E402
from ntrace_tpu_torch.host import Scene, pack_bvh  # noqa: E402
from ntrace_tpu_torch.ops.boxes import (child_boxes,  # noqa: E402
                                        child_boxes_ref)
from ntrace_tpu_torch.ops.pscan import row_scan_i32_ref  # noqa: E402
from ntrace_tpu_torch.render.renderer import (Renderer,  # noqa: E402
                                              build_accel)
from ntrace_tpu_torch.tables import tree_form  # noqa: E402


def synced(device, fn):
    """(fn(), its host seconds, the device synchronised at both ends)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, perf_counter() - t0


def kernels_equal(positions, indices, bc) -> dict:
    """One build of the pose (the HLBVH's forest where bc builds one): its
    kept neighbours through the row scan, bit-equal to those of the plain
    version (torch.cummax / cummin), and its child boxes through the
    kernel, bit-equal to the plain version's on each query the build
    made."""
    shift = hlbvh.cluster_shift(bc) if bc.builder == "hlbvh" else 0
    with mock.patch.object(lbvh, "child_boxes", wraps=child_boxes) as spy:
        kept = lbvh.lbvh_device_fast(*lbvh.inputs_from(positions, indices),
                                     max_leaf=bc.max_leaf_size,
                                     emit="packed",
                                     cluster_shift=shift)["kept"]
    got = lbvh.kept_neighbours(kept)
    want = lbvh.kept_neighbours(kept, row_scan_i32_ref)
    return {"kept_scans": all(torch.equal(a, b) for a, b in zip(got, want)),
            "child_boxes": all(torch.equal(
                child_boxes(*c.args).view(torch.int32),
                child_boxes_ref(*c.args).view(torch.int32))
                for c in spy.call_args_list)}


def host_route(r, posed, cam, got) -> dict:
    """HLBVH: the host route's renderer from the posed Scene, with r's
    settings, its AO frame against `got` (bit-equal image and primary
    hits), and the rebuilt tables against build_hlbvh_flat packed one node
    a row."""
    host = Renderer(posed, r.build_cfg, r.cfg, flat=build_accel(
        posed, r.build_cfg, device=r.device), device=r.device)
    want = host.render(cam, "ao")
    packed = pack_bvh(host.flat, posed.tri_verts(), tris_per_row=12,
                      nodes_per_row=1)
    return {"host_route": all(np.array_equal(getattr(got, a),
                                             getattr(want, a))
                              for a in ("image", "hit_tri", "hit_t")),
            "flat_tree": (tree_form(r.tables.nodes8) == tree_form(
                packed.nodes8) and np.array_equal(
                r.tables.tris12.cpu().numpy(), packed.tris12))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="hairball_dynamic")
    ap.add_argument("--poses", type=int, default=16)
    ap.add_argument("--pixels", type=int, default=256)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--seed", type=int, default=3_200_000_001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    name = next(w["name"] for w in spec.benchmark()["workloads"]
                if w["config"] == args.config
                and spec.workload(w["name"])["kind"] == "rebuild_frame")
    wl = dict(spec.workload(name), check_pixels=args.pixels)
    cfg = spec.config(wl["config"])
    cell = Cell(name, wl, cfg, args.seed, args.device)
    if cell.device.type == "cuda":
        program.load_kernels(cfg)
    kind.build(cell)
    kind.traffic(cell)
    r, s = cell.renderer, cell.scene
    indices = torch.from_numpy(s.indices).to(cell.device)
    n = len(cell.cameras)
    cell.images = [None] * n
    rows, ok = [], True
    for k in range(min(args.poses, n)):
        cell.buf.copy_(cell.poses[k])
        st, upd_s = synced(cell.device, lambda: r.update_positions(cell.buf))
        got = r.render(cell.cameras[k], "ao")
        posed = Scene(cell.host_poses[k], s.indices, mat_ids=s.mat_ids,
                      materials=s.materials)
        fresh, new_s = synced(cell.device, lambda: program.renderer(
            cfg, posed, "ao", cell.seed32, cell.device))
        want = fresh.render(cell.cameras[k], "ao")
        same = {
            "nodes8": torch.equal(r.tables.nodes8, fresh.tables.nodes8),
            "tris12": torch.equal(r.tables.tris12, fresh.tables.tris12),
            "image": bool(np.array_equal(got.image, want.image)),
            "hit_tri": bool(np.array_equal(got.hit_tri, want.hit_tri)),
            "hit_t": bool(np.array_equal(got.hit_t, want.hit_t)),
            **kernels_equal(cell.buf, indices, r.build_cfg)}
        del fresh
        if r.build_cfg.builder == "hlbvh":
            same.update(host_route(r, posed, cell.cameras[k], got))
        cell.images = [None] * n
        cell.images[k] = got.image
        samples = kind.sample(cell)
        nums = checks.pixel_numbers(list(zip(
            [x["colours"] for x in samples],
            kind.reference(cell, samples, torch.float32))))
        good = all(same.values()) and all(v == 0 for v in nums.values())
        ok &= good
        row = {"pose": k, "ok": good, "bit_equal": same, **nums,
               "update_positions_s": upd_s, "fresh_renderer_s": new_s,
               "stats": st}
        rows.append(row)
        print(json.dumps(row), flush=True)
    dev = cell.device
    tail = {"ok": ok, "poses": len(rows), "pixels_a_pose": args.pixels,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else 0)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, **tail}, f)
    print(json.dumps(tail), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
