"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`; its traffic file is
benchmark/workloads/<cell>.json, its configuration
benchmark/configs/<config>.json, its traffic kind benchmark/traffic/<kind>.py
and each metric's reader benchmark/metrics/<metric>.py. A run: set-up (the
scene, the program's BVH and renderer, the traffic, one warm-up call of
each pass or frame), the window of `--seconds`, then the check of what the
window produced against the plain reference, once the program's state is
freed. With --trace 0 the result carries the cell's end-to-end metrics;
with --trace 1 the window runs under torch.profiler and the result
carries its per-layer metrics, the device's busy time and a breakdown
(reading the trace of a 10-s frame window takes about 100 s). The last
line of standard output is the result, one JSON object. Its
`setup_parts` split `setup_s`: imports; cuda, the context's start;
kernels, the library's load, and its build by nvcc where the checkout
has none (`nvcc_s` of it); scene; bvh; traffic; warm-up. The numbers
the check compared, each beside its limit, are the last lines of
standard error and the last key of the result. Without a CUDA device
the run fails and prints no result.
"""

from time import perf_counter

T0 = perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.lib import checks, prof, program, spec  # noqa: E402
from benchmark.lib.cell import Cell, Readings  # noqa: E402


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             config: dict = None, workload: dict = None) -> dict:
    """One run of cell `name` on `device`; returns the result object.
    `config` and `workload` replace the files' (the CPU rehearsal runs
    small sizes through the same path)."""
    bench = spec.benchmark()
    wl = workload if workload is not None else spec.workload(name)
    cfg = config if config is not None else spec.config(wl["config"])
    kind = spec.traffic(wl["kind"])
    cell = Cell(name, wl, cfg, seed, device, t0=T0)
    cell.mark("imports")
    nvcc_s = 0.0
    if cell.device.type == "cuda":
        torch.zeros(1, device=cell.device)
        cell.mark("cuda")
        nvcc_s = program.load_kernels(cfg)
    cell.mark("kernels")
    kind.build(cell)
    kind.traffic(cell)
    setup_s = perf_counter() - T0
    t1 = perf_counter()
    win, profile, peak, fields, samples = measure(cell, kind, seconds,
                                                  traced)
    t2 = perf_counter()
    readings = Readings(setup_s=setup_s, profile=profile, **fields)
    kind.release(cell)
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    t3 = perf_counter()
    answers = kind.reference(cell, samples, torch.float32)
    ok, rows = checks.judged(kind.numbers(samples, answers), wl["limits"])
    parts = {f"{k}_s": v for k, v in cell.setup_parts.items()}
    parts["nvcc_s"] = nvcc_s
    print(f"{name}: set-up {setup_s:.2f} s ("
          + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
          + f"), window and trace reading {t2 - t1:.2f} s, readings and "
          f"samples {t3 - t2:.2f} s, reference {perf_counter() - t3:.2f} s",
          file=sys.stderr)
    metrics = {}
    for m in spec.metrics_of(bench, name, traced):
        value = spec.reader(m["name"])(readings)
        if value is None:
            print(f"{m['name']}: nothing to read in this run",
                  file=sys.stderr)
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": ok and win["failed"] == 0,
              "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": describe(cell.device, peak)}
    if traced:
        result["device"].update(busy_s=profile["busy_s"],
                                window_s=win["window_s"])
        result["breakdown"] = {"device_ops": profile["device_ops"],
                               "idle_gaps": profile["idle_gaps"]}
    if win["error"]:
        print(win["error"], file=sys.stderr)
    result["setup_parts"] = parts
    result["checks"] = rows
    return result


def measure(cell, kind, seconds: float, traced: bool) -> tuple:
    """The window of the cell's traffic as set up, and what the check
    takes from it: (window, profile or None, the device's memory peak,
    the readings' fields, the samples of what the window produced)."""
    if cell.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(cell.device)
    profile = None
    if traced:
        win, profile = prof.profiled(lambda: kind.window(cell, seconds, True),
                                     cell.device)
    else:
        win = kind.window(cell, seconds, False)
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    return (win, profile, peak, kind.readings(cell, win, traced),
            kind.sample(cell))


def describe(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cells = {w["name"]: w for w in spec.benchmark()["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0")
    for k, row in result["checks"].items():
        print(f"check {k}: {row['value']} (limit {row['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
