"""Readings that the check's limits are set from, for one cell.

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> \
        --first-seed <s> --seconds <w> [--control <k>]

Sets the cell up once, then for each of `n` seeds from `s` on: the seed's
traffic, a window of `w` seconds at the cell's own load, and the check's
numbers of the program against the reference (the lower readings). On the
first `k` seeds it also puts the control in the program's place: the
reference computed in bfloat16, one precision below the float32 the
configurations state, against the float32 reference (the upper readings).
One JSON line a seed on standard output; the run's own end-to-end numbers
beside them.
"""

from time import perf_counter

T0 = perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.lib import program, spec  # noqa: E402
from benchmark.lib.cell import Cell, Readings  # noqa: E402


def readings_of(cell, kind, seed: int, seconds: float,
                control: bool) -> dict:
    cell.set_seed(seed)
    kind.traffic(cell)
    win, _, _, fields, samples = run.measure(cell, kind, seconds, False)
    r = Readings(**fields)
    e2e = {m: spec.reader(m)(r) for m in ("mrays_s", "frame_ms",
                                          "frame_ms_p95")}
    t0 = perf_counter()
    answers = kind.reference(cell, samples, torch.float32)
    ref_s = perf_counter() - t0
    row = {"seed": seed, "attempted": win["attempted"],
           "failed": win["failed"], "reference_s": ref_s,
           "program": kind.numbers(samples, answers),
           **{k: v for k, v in e2e.items() if v is not None}}
    if control:
        low = kind.reference(cell, samples, torch.bfloat16)
        row["control"] = kind.numbers(samples, answers,
                                      kind.control_hits(low))
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    wl = spec.workload(args.workload)
    cfg = spec.config(wl["config"])
    kind = spec.traffic(wl["kind"])
    cell = Cell(args.workload, wl, cfg, args.first_seed, "cuda:0")
    program.load_kernels(cfg)
    kind.build(cell)
    print(json.dumps({"workload": args.workload,
                      "build_s": perf_counter() - T0,
                      "scene_sha256": program.scene_digest(cell.scene),
                      "tris": cell.scene.num_tris}), flush=True)
    for k in range(args.seeds):
        row = readings_of(cell, kind, args.first_seed + k, args.seconds,
                          k < args.control)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
