"""Check Renderer.update_positions at a moving configuration's full size.

    python3 scripts/rebuild_check.py [--poses 16] [--pixels 256] \
        [--config hairball_dynamic] [--device cuda:0] [--out FILE]

The configuration's scene, renderer and poses come from the benchmark
(benchmark/lib/program.py, lib/motion.py), its cameras from the walk of
the cell `<config>.ao_rebuild`. For each pose k, with camera k:
  - one renderer, built once, takes the pose through update_positions;
    a second is built fresh from a host Scene of the pose. Their tables
    (nodes8, tris12) and the AO frame's image, hit_tri and hit_t must be
    bit-equal;
  - `--pixels` pixels of the image, drawn from a fixed seed, against the
    benchmark's plain reference (brute force over the pose's triangles):
    pixel_mismatch and pixel_gap_mean must be 0;
  - the build's kept neighbours of the pose (bvh/lbvh.py:kept_neighbours)
    through the row scan must be bit-equal to its plain version's,
    torch.cummax / cummin (`kept_scans`), and its child boxes through the
    kernel (ops/boxes.py:child_boxes) to the plain version's on the
    build's own queries (`child_boxes`).
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
from ntrace_tpu_torch.bvh import lbvh  # noqa: E402
from ntrace_tpu_torch.host import Scene  # noqa: E402
from ntrace_tpu_torch.ops.boxes import (child_boxes,  # noqa: E402
                                        child_boxes_ref)
from ntrace_tpu_torch.ops.pscan import row_scan_i32_ref  # noqa: E402


def synced(device, fn):
    """(fn(), its host seconds, the device synchronised at both ends)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, perf_counter() - t0


def kernels_equal(positions, indices, max_leaf) -> dict:
    """One build of the pose: its kept neighbours through the row scan,
    bit-equal to those of the plain version (torch.cummax / cummin), and
    its child boxes through the kernel, bit-equal to the plain version's
    on the queries the build made."""
    with mock.patch.object(lbvh, "child_boxes", wraps=child_boxes) as spy:
        kept = lbvh.lbvh_device_fast(*lbvh.inputs_from(positions, indices),
                                     max_leaf=max_leaf,
                                     emit="packed")["kept"]
    got = lbvh.kept_neighbours(kept)
    want = lbvh.kept_neighbours(kept, row_scan_i32_ref)
    q = spy.call_args.args
    return {"kept_scans": all(torch.equal(a, b) for a, b in zip(got, want)),
            "child_boxes": torch.equal(
                child_boxes(*q).view(torch.int32),
                child_boxes_ref(*q).view(torch.int32))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="hairball_dynamic")
    ap.add_argument("--poses", type=int, default=16)
    ap.add_argument("--pixels", type=int, default=256)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--seed", type=int, default=3_200_000_001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    wl = dict(spec.workload(f"{args.config}.ao_rebuild"),
              check_pixels=args.pixels)
    cfg = spec.config(wl["config"])
    cell = Cell(f"{args.config}.ao_rebuild", wl, cfg, args.seed, args.device)
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
            **kernels_equal(cell.buf, indices, r.build_cfg.max_leaf_size)}
        del fresh
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
