"""CPU rehearsal of the benchmark: its files load by name, both kinds of
traffic run through the harness at a tiny size, the metric arithmetic
holds, and a run with no card fails instead of falling back to the CPU.

    python3 -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import json
import math
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from small import ROOT, cells, small  # noqa: E402  (puts ROOT on sys.path)

from benchmark import run  # noqa: E402
from benchmark.lib import bound, count, gen, program, prof, spec  # noqa: E402
from benchmark.lib.cell import Readings  # noqa: E402

BENCH = Path(ROOT) / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_every_part_loads_by_name():
    b = spec.benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for c in b["configs"]:
        assert NAME.match(c["name"])
        assert spec.config(c["name"])["name"] == c["name"]
        assert Path(ROOT, c["file"]).is_file()
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        wl = spec.workload(w["name"])
        assert wl["config"] == w["config"]
        assert hasattr(spec.traffic(wl["kind"]), "window")
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and callable(spec.reader(m["name"]))
        assert m.get("moves", "setup_s") in e2e
    for w in b["workloads"]:
        names = [m["name"] for m in spec.metrics_of(b, w["name"], False)]
        assert "setup_s" in names and len(names) >= 2
        assert spec.metrics_of(b, w["name"], True)


def test_nothing_imports_jax_or_the_reference_package():
    """No file of the benchmark imports jax or ntrace_tpu; of the harness
    only lib/program.py imports the port itself (tests may, to break it)."""
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "ntrace_tpu"), path
                if top == "ntrace_tpu_torch" and path.parent.name != "tests":
                    assert path.name == "program.py", path


@pytest.mark.parametrize("cell", cells())
def test_cell_runs_correct_on_the_cpu(cell):
    cfg, wl = small(cell)
    res = run.run_cell(cell, 2 ** 31 + 12345, 0.2, False, "cpu",
                       config=cfg, workload=wl)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    want = {m["name"] for m in spec.metrics_of(spec.benchmark(), cell,
                                               False)}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"
    json.dumps(res)


def test_traced_run_reads_the_per_layer_metrics():
    """A traced run on the CPU: no device time, so the device metrics are
    left out and the frame stages are read."""
    cell = "conference.diffuse_frame"
    cfg, wl = small(cell)
    res = run.run_cell(cell, 7, 0.2, True, "cpu", config=cfg, workload=wl)
    assert res["correct"]
    assert {"trace_ms.frame", "raygen_ms.frame",
            "shade_readback_ms.frame"} <= set(res["metrics"])
    assert res["device"]["busy_s"] == 0.0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_traffic():
    from benchmark.lib.cell import Cell
    cfg, wl = small("conference.rays")
    kind = spec.traffic("rays")
    rays = []
    for _ in range(2):
        c = Cell("conference.rays", wl, cfg, 2 ** 33 + 5, "cpu")
        kind.build(c)
        kind.traffic(c)
        rays.append([b["rays"].dirn for b in c.batches])
    assert all(torch.equal(a, b) for a, b in zip(*rays))


def test_rng_matches_known_threefry_values():
    """uniform_at against jax.random.uniform(PRNGKey(0), (4,)) under
    jax_threefry_partitionable, the values ray/rng.py is held to."""
    got = gen.uniform_at(gen.prng_key(0), torch.arange(4, dtype=torch.int64))
    from ntrace_tpu_torch.ray import rng
    want = rng.uniform(rng.prng_key(0, "cpu"), (4,))
    assert torch.equal(got, want)


def _frozen_tables():
    """frozen_tables.npz: the host binned SAH of soup@400 (leaves of at
    most 4, 4 triangle slots and 2 node records a row), packed when the
    benchmark was defined."""
    z = np.load(Path(__file__).with_name("frozen_tables.npz"))
    num_nodes, npr, tpr = (int(v) for v in z["shape"])
    return SimpleNamespace(nodes8=torch.from_numpy(z["nodes8"]),
                           tris12=torch.from_numpy(z["tris12"]),
                           num_nodes=num_nodes, nodes_per_row=npr,
                           tris_per_row=tpr)


# The count on the frozen tables and rays, as the packet twin counted them
# when the benchmark was defined (its node visits, slot tests and bytes).
FROZEN_WORK = {
    False: {"node_visits": 20321, "slot_tests": 20472, "nodes_read": 135,
            "rows_read": 100},
    True: {"node_visits": 20200, "slot_tests": 20156, "nodes_read": 135,
           "rows_read": 100},
}


@pytest.mark.parametrize("any_hit", [False, True])
def test_count_matches_the_program_twin(any_hit):
    """The frozen count still counts what it counted when it was copied:
    recorded numbers on recorded tables, not the program's live twin."""
    tables = _frozen_tables()
    rng = np.random.default_rng(2009)
    n = 1024
    o = ((rng.random((n, 3)) - 0.5) * 40).astype(np.float32)
    d = (-o + rng.standard_normal((n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tx = torch.where(torch.arange(n) % 7 == 0, 0.0, 1e9)
    work = count.count_work(tables, torch.from_numpy(o), torch.from_numpy(d),
                            torch.zeros(n), tx, any_hit)
    assert work == FROZEN_WORK[any_hit]


def test_count_refuses_another_layout():
    """Tables in another layout stop the count: another class or field,
    other lanes, or links that do not decode."""
    from ntrace_tpu_torch.tables import PackedTables
    f = _frozen_tables()
    tables = PackedTables(f.nodes8, f.tris12, f.nodes_per_row,
                          f.tris_per_row, f.num_nodes)
    layout = program.table_layout(tables)
    count.check_layout(layout, tables)
    for key, other in (("class", "QuantizedTables"), ("node_lanes", 8),
                       ("fields", layout["fields"] + ["scale"]),
                       ("dtypes", ["float16", "float32"])):
        with pytest.raises(ValueError):
            count.check_layout(dict(layout, **{key: other}), tables)
    nodes = f.nodes8.clone()
    nodes[0, 12] = 0.5
    with pytest.raises(ValueError):
        count.check_layout(layout, SimpleNamespace(**dict(vars(f),
                                                          nodes8=nodes)))


def test_another_layout_silences_the_roofline(monkeypatch):
    """A traced rays run over tables in another layout reads no bound, so
    the roofline is left out of its line, and the run goes on."""
    from benchmark.lib.cell import Cell
    cfg, wl = small("conference.rays")
    kind = spec.traffic("rays")
    c = Cell("conference.rays", wl, cfg, 2 ** 31 + 3, "cpu")
    kind.build(c)
    kind.traffic(c)
    win = kind.window(c, 0.05, False)
    assert kind.readings(c, win, True)["bound_s"] > 0
    layout = program.table_layout
    monkeypatch.setattr(program, "table_layout",
                        lambda t: dict(layout(t), node_lanes=8))
    assert "bound_s" not in kind.readings(c, win, True)


def test_bound_and_readers_arithmetic():
    w = {"node_visits": 1000, "slot_tests": 2000, "nodes_read": 10,
         "rows_read": 5}
    s, by = bound.bound_s(100, w, 12, scale=2.0)
    ops = (1000 * 50 + 2000 * 51) * 2.0 / 67e12
    nbytes = (100 * 48 + 10 * 64 + 5 * 12 * 40) / 3.35e12
    assert math.isclose(s, max(ops, nbytes)) and by == "operations"
    ops = {"void (anonymous namespace)::packet_trace_kernel<true>(": 0.6,
           "void (anonymous namespace)::packet_trace_kernel<false>(": 0.4,
           "void at::native::index_elementwise_kernel<128, 4>": 0.5}
    r = Readings(kind="rays", window_s=2.0, live_rays=4e9, bound_s=0.5,
                 trace_kernels=["packet_trace_kernel"], setup_s=3.0,
                 profile={"busy_s": 1.5, "by_name": ops})
    assert spec.reader("mrays_s")(r) == 2000.0
    assert spec.reader("trace_roofline.rays")(r) == 50.0
    assert spec.reader("device_idle_pct.rays")(r) == 25.0
    assert spec.reader("device_idle_pct.frame")(r) == 25.0
    assert spec.reader("setup_s")(r) == 3.0
    r.trace_kernels = ["packet_ww_kernel"]
    assert spec.reader("trace_roofline.rays")(r) is None
    stats = [{"raygen": 1.0, "raygen_ao": 9.0, "trace_primary": 0.5,
              "trace_ao": 4.5, "shade": 1.0, "readback": 2.0}] * 4
    f = Readings(kind="frame", mode="ao", window_s=2.0,
                 frame_s=[0.01 * (k + 1) for k in range(100)], stats=stats)
    assert spec.reader("frame_ms")(f) == 20.0
    assert math.isclose(spec.reader("frame_ms_p95")(f), 950.5)
    assert spec.reader("raygen_ms.frame")(f) == 10.0
    assert spec.reader("trace_ms.frame")(f) == 5.0
    assert spec.reader("shade_readback_ms.frame")(f) == 3.0
    assert spec.reader("mrays_s")(f) is None


def _event(name, start, end, device=False, annotation=False):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=annotation)


def test_profile_reduction():
    """Busy time is the union of device intervals, device time their sum;
    the ranges' copies on the device timeline are no operations; gaps are
    named by the innermost open CPU event."""
    events = [_event(prof.SPAN, 10, 40), _event("aten::cat", 12, 14),
              _event("host_op", 41, 60),
              _event(prof.SPAN, 10, 60, device=True, annotation=True),
              _event("k1", 20, 40, device=True),
              _event("k2", 30, 45, device=True),
              _event("k3", 50, 52, device=True)]
    r = prof.reduce_events(events)
    assert r["busy_s"] == 27e-6
    assert r["by_name"] == {"k1": 20e-6, "k2": 15e-6, "k3": 2e-6}
    assert r["device_ops"][0] == ["k1", 20e-6]
    assert r["idle_gaps"] == [["host_op", 5e-6]]


def test_no_card_no_result():
    """Where torch finds no CUDA device the run exits non-zero and prints
    nothing on standard output."""
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "conference.rays", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": "/nonexistent"})
    assert proc.returncode != 0
    assert proc.stdout == ""
