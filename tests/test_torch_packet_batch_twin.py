"""The node-batch, deferred-leaf and combined packet traversals (packet_bfs,
packet_dleaf, packet_bdl) against the port's packet twin and the
brute-force oracles, at every knob; the stack bound and the refusals; the
device policy; render() through each engine; and, on a card, each CUDA
kernel against its twin.

Tolerances: none. Closest hits (tri/t/u/v) are bit-equal to the packet
twin's on every ray, misses included: the schedules differ, the slab and
Moller-Trumbore op order and the (t, id) fold do not. Any hit: tri >= 0
equal to brute_force_anyhit (which triangle blocks depends on the
packet). Kernel against twin on a card: bit-equal, any-hit tri included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ntrace_tpu.bvh.flatten import flatten_bvh
from ntrace_tpu.bvh.golden import brute_force_anyhit, brute_force_mt
from ntrace_tpu.bvh.packed import pack_bvh
from ntrace_tpu.bvh.sbvh import build_sbvh
from ntrace_tpu.core import BuildConfig, RenderConfig
from ntrace_tpu.scenes import default_camera, make_random_soup
from ntrace_tpu_torch.render import renderer as port
from ntrace_tpu_torch.render.renderer import Renderer
from ntrace_tpu_torch.tables import PackedTables, tables_from_packed
from ntrace_tpu_torch.trace import packet_batch, registry
from ntrace_tpu_torch.trace.packet import trace_packet_ref
from ntrace_tpu_torch.trace.packet_bdl import (trace_packet_bdl,
                                               trace_packet_bdl_ref)
from ntrace_tpu_torch.trace.packet_bfs import (trace_packet_bfs,
                                               trace_packet_bfs_ref)
from ntrace_tpu_torch.trace.packet_common import read_bytes, work_with_reads
from ntrace_tpu_torch.trace.packet_dleaf import (trace_packet_dleaf,
                                                 trace_packet_dleaf_ref)

from conftest import random_rays

KERNELS = {
    "bfs": (trace_packet_bfs, trace_packet_bfs_ref, packet_batch.BFS),
    "dleaf": (trace_packet_dleaf, trace_packet_dleaf_ref,
              packet_batch.DLEAF),
    "bdl": (trace_packet_bdl, trace_packet_bdl_ref, packet_batch.BDL),
}
# (kernel, knobs, tables (tris_per_row, nodes_per_row))
CASES = [
    ("bfs", dict(rows=8), (12, 1)),
    ("bfs", dict(rows=16), (4, 1)),
    ("bfs", dict(rows=32), (12, 1)),
    ("dleaf", dict(rows=8), (12, 1)),
    ("dleaf", dict(rows=16), (4, 8)),
    ("dleaf", dict(rows=32), (12, 8)),
    ("dleaf", dict(rows=8, drain_min=1), (12, 1)),
    ("dleaf", dict(rows=8, drain_min=64), (4, 1)),
    ("bdl", dict(rows=8), (12, 1)),
    ("bdl", dict(rows=16), (4, 1)),
    ("bdl", dict(rows=32), (12, 1)),
    ("bdl", dict(rows=8, drain_min=1), (12, 1)),
    ("bdl", dict(rows=8, drain_min=64), (4, 1)),
    ("bdl", dict(rows=8, qgroup=2), (12, 1)),
    ("bdl", dict(rows=8, qgroup=4), (12, 1)),
    ("bdl", dict(rows=8, qgroup=8), (12, 1)),
    ("bdl", dict(rows=8, qgroup=2, merge_sibs=True), (12, 1)),
    ("bdl", dict(rows=8, qgroup=4, merge_sibs=True), (4, 1)),
    ("bdl", dict(rows=16, qgroup=8, merge_sibs=True), (12, 1)),
]
ENGINES = ("packet_bfs", "packet_dleaf", "packet_bdl")


def _case_id(case):
    kernel, kw, (tpr, npr) = case
    return "-".join([kernel] + [f"{k}{int(v)}" for k, v in kw.items()]
                    + [f"t{tpr}n{npr}"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins run many small torch ops; with the suite's test workers
    sharing the cores, one intra-op thread per worker avoids
    oversubscribing them. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(scene, **kw):
    return flatten_bvh(build_sbvh(scene, BuildConfig(builder="binned_sah",
                                                     **kw)), scene)


@pytest.fixture(scope="module")
def flat_small(soup_small):
    return _flat(soup_small)


def _torch(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _tables(scene, flat, tpr=12, npr=1, device="cpu"):
    return tables_from_packed(pack_bvh(flat, scene.tri_verts(),
                                       tris_per_row=tpr, nodes_per_row=npr),
                              device)


def _assert_bit_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_knobs_match_packet_twin_and_oracles(soup_small, flat_small, rng,
                                             case):
    """Every knob: closest hits bit-equal to the packet twin on every ray
    and exact against brute_force_mt; any hit tri >= 0 equal to
    brute_force_anyhit."""
    kernel, kw, (tpr, npr) = case
    wrapper = KERNELS[kernel][0]
    tables = _tables(soup_small, flat_small, tpr, npr)
    orig, dirn, tmin, tmax = random_rays(rng, 700)
    rays = _torch(orig, dirn, tmin, tmax)
    got = wrapper(tables, *rays, **kw)
    _assert_bit_equal(got, trace_packet_ref(tables, *rays))
    np.testing.assert_array_equal(
        got[0].numpy(), brute_force_mt(soup_small, orig, dirn, tmin,
                                       tmax).tri)
    short = np.full_like(tmax, 14.0)
    any_tri = wrapper(tables, *_torch(orig, dirn, tmin, short), any_hit=True,
                      **kw)[0].numpy()
    np.testing.assert_array_equal(
        any_tri >= 0, brute_force_anyhit(soup_small, orig, dirn, tmin,
                                         short))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_dead_rays_stay_dead(soup_small, flat_small, rng, kernel):
    wrapper = KERNELS[kernel][0]
    tables = _tables(soup_small, flat_small)
    orig, dirn, tmin, tmax = random_rays(rng, 96)
    tmax[::2] = tmin[::2]           # dead: tmax <= tmin
    tmax[1::4] = -1.0
    dead = tmax <= tmin
    for any_hit in (False, True):
        tri, t, u, v = wrapper(tables, *_torch(orig, dirn, tmin, tmax),
                               any_hit=any_hit)
        assert (tri.numpy()[dead] == -1).all()
        np.testing.assert_array_equal(t.numpy()[dead], tmax[dead])
        assert not u.numpy()[dead].any() and not v.numpy()[dead].any()
        assert (tri.numpy()[~dead] >= 0).any()


def test_leaf_dense_queues_drop_nothing(rng):
    """Leaf-dense stress (tests/test_packet.py:383): fat multi-row leaves
    crossed by every ray, drained only at drain_min 64, so the per-warp
    queues run deep; no leaf run is dropped (closest hits exact against
    brute force) and the twin's queues (QCAP entries) never overflow."""
    scene = make_random_soup(n_tris=6400, seed=7, extent=1.0)
    flat = _flat(scene, max_leaf_size=32, sah_tri_cost=0.005)
    tables = _tables(scene, flat, 4, 8)
    n = 1024
    orig = rng.normal(size=(n, 3)).astype(np.float32)
    orig *= (4.0 / np.linalg.norm(orig, axis=1, keepdims=True))
    target = rng.uniform(-0.4, 0.4, size=(n, 3)).astype(np.float32)
    dirn = target - orig
    dirn /= np.linalg.norm(dirn, axis=1, keepdims=True)
    tmin = np.zeros((n,), np.float32)
    tmax = np.full((n,), 1e9, np.float32)
    tri = trace_packet_dleaf(tables, *_torch(orig, dirn, tmin, tmax),
                             drain_min=64)[0]
    np.testing.assert_array_equal(
        tri.numpy(), brute_force_mt(scene, orig, dirn, tmin, tmax).tri)


def test_bdl_largest_packet(soup_small, flat_small, rng):
    """The reference's rows-64 case (tests/test_packet.py:455): a packet of
    the port is at most 32 warps (1,024 rays, one block), so rows 64 is
    refused, the renderer clamps packet_rows 64 to 32, and rows 32 equals
    the packet twin and brute force."""
    tables = _tables(soup_small, flat_small)
    orig, dirn, tmin, tmax = random_rays(rng, 700)
    rays = _torch(orig, dirn, tmin, tmax)
    with pytest.raises(ValueError, match="rows"):
        trace_packet_bdl(tables, *rays, rows=64)
    assert registry.batch_knobs("packet_bdl", RenderConfig(
        packet_rows=64))["rows"] == 32
    got = trace_packet_bdl(tables, *rays, rows=32)
    _assert_bit_equal(got, trace_packet_ref(tables, *rays))
    np.testing.assert_array_equal(
        got[0].numpy(), brute_force_mt(soup_small, orig, dirn, tmin,
                                       tmax).tri)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_twin_counts_and_marks_its_work(soup_small, flat_small, rng,
                                        kernel):
    """work= counts ray node visits and slot tests and marks what the twin
    reads, without changing a result; a ray pointing away from the scene
    visits the root alone and tests nothing."""
    _, twin, _ = KERNELS[kernel]
    tables = _tables(soup_small, flat_small, 4, 1)
    rays = _torch(*random_rays(rng, 300))
    plain, reads = {}, work_with_reads(tables)
    _assert_bit_equal(twin(tables, *rays, work=plain), twin(tables, *rays))
    twin(tables, *rays, work=reads)
    assert {k: reads[k] for k in plain} == plain
    assert plain["node_visits"] > 300 and plain["tri_slot_tests"] > 0
    assert plain["tri_slot_tests"] % tables.tris_per_row == 0
    n_nodes = int(reads["nodes_read"].sum())
    n_rows = int(reads["rows_read"].sum())
    assert 1 < n_nodes <= min(plain["node_visits"], tables.num_nodes)
    assert 0 < n_rows * tables.tris_per_row <= plain["tri_slot_tests"]
    assert read_bytes(tables, reads) == 4 * (16 * n_nodes + 40 * n_rows)
    away = work_with_reads(tables)
    twin(tables, *_torch(np.array([[0, 0, 50]], np.float32),
                         np.array([[0, 0, 1]], np.float32),
                         np.zeros(1, np.float32),
                         np.full(1, 1e9, np.float32)), work=away)
    assert (away["node_visits"], away["tri_slot_tests"]) == (1, 0)
    assert away["nodes_read"].nonzero().tolist() == [[0]]
    assert not away["rows_read"].any()


def _host_max_depth(tables: PackedTables) -> int:
    """The deepest internal node, by a walk from the root on the host."""
    npr = tables.nodes_per_row
    rec = tables.nodes8[:, :16 * npr].reshape(-1, 16)[:tables.num_nodes]
    enc = rec[:, 12:14].to(torch.int64).numpy()
    depth, level, frontier = 0, 0, [0]
    while frontier:
        depth = level
        frontier = [int(c) for n in frontier for c in enc[n] if c >= 0]
        level += 1
    return depth


def _chain(depth: int) -> PackedTables:
    """A tree of depth `depth`: internal node i has child 0 the internal
    node i + 1 and child 1 a one-row leaf; the last has two leaves. Every
    box is the unit cube, and the leaf row holds one triangle in it."""
    n = depth + 1
    nodes = torch.zeros((n, 128), dtype=torch.float32)
    box = torch.tensor([0.0, 1.0, 0.0, 1.0, 0.0, 1.0])
    nodes[:, 0:6], nodes[:, 6:12] = box, box
    nodes[:, 12] = torch.arange(1, n + 1, dtype=torch.float32)
    nodes[-1, 12] = -1.0
    nodes[:, 13] = -1.0
    nodes[:, 14] = torch.where(nodes[:, 12] < 0, 1.0, 0.0)
    nodes[:, 15] = 1.0
    tris = torch.zeros((8, 128), dtype=torch.float32)
    tris[:, 9:120:10] = -1.0
    tris[0, :10] = torch.tensor([0.0, 0.0, 0.5, 1.0, 0.0, 0.0, 0.0, 1.0,
                                 0.0, 7.0])
    return PackedTables(nodes8=nodes, tris12=tris, nodes_per_row=1,
                        tris_per_row=12, num_nodes=n)


def test_max_depth_and_the_stack_bound(soup_small, flat_small, rng):
    """max_depth equals a host walk's on real trees, and the stack bound
    holds on them: each twin traces with a stack of exactly
    stack_need(max_depth) entries (an overflow would index past it) and
    still equals the packet twin. Chains: bfs and bdl take depth 255 and
    refuse 256, dleaf takes 126 and refuses 127, naming the limit; a
    chain at the limit traces to its one triangle."""
    medium = make_random_soup(n_tris=5000, seed=11)
    for scene, flat in ((soup_small, flat_small), (medium, _flat(medium))):
        for npr in (1, 8):
            tables = _tables(scene, flat, 12, npr)
            assert tables.max_depth == _host_max_depth(tables) > 3
    tables = _tables(soup_small, flat_small)
    rays = _torch(*random_rays(rng, 700))
    want = trace_packet_ref(tables, *rays)
    for kernel, (_, _, sched) in KERNELS.items():
        tight = dataclasses.replace(sched,
                                    stack=sched.stack_need(tables.max_depth))
        for any_hit in (False, True):
            got = packet_batch.trace_batch_ref(tight, tables, *rays,
                                               any_hit=any_hit)
            if not any_hit:
                _assert_bit_equal(got, want)
    ray = _torch(np.array([[0.25, 0.25, 5.0]], np.float32),
                 np.array([[0.0, 0.0, -1.0]], np.float32),
                 np.zeros(1, np.float32), np.full(1, 1e9, np.float32))
    for kernel, limit in (("bfs", 255), ("bdl", 255), ("dleaf", 126)):
        wrapper = KERNELS[kernel][0]
        ok = _chain(limit)
        assert ok.max_depth == limit
        tri, t, _, _ = wrapper(ok, *ray)
        assert int(tri[0]) == 7 and float(t[0]) == 4.5
        with pytest.raises(ValueError, match=f"depth {limit} at most"):
            wrapper(_chain(limit + 1), *ray)


@pytest.mark.parametrize("kernel", ["bfs", "bdl"])
def test_one_node_a_row_required(soup_small, flat_small, kernel):
    wrapper = KERNELS[kernel][0]
    rays = _torch(*random_rays(np.random.default_rng(0), 4))
    with pytest.raises(ValueError, match="nodes_per_row == 1"):
        wrapper(_tables(soup_small, flat_small, 12, 8), *rays)


def test_knob_refusals(soup_small, flat_small):
    tables = _tables(soup_small, flat_small)
    rays = _torch(*random_rays(np.random.default_rng(0), 4))
    for kw in (dict(qgroup=3), dict(rows=8, qgroup=16),
               dict(drain_min=65), dict(rows=0)):
        with pytest.raises(ValueError):
            trace_packet_bdl(tables, *rays, **kw)
    with pytest.raises(ValueError, match="drain_min"):
        trace_packet_dleaf(tables, *rays, drain_min=65)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_cuda_input_never_reaches_twin(soup_small, flat_small, rng,
                                       monkeypatch, kernel):
    """A tensor the device policy routes to the kernel launches it (or
    raises): the twin is never called. CUDA is mocked where absent."""
    wrapper, _, sched = KERNELS[kernel]
    tables = _tables(soup_small, flat_small)
    rays = _torch(*random_rays(rng, 16))
    launched = []

    def no_twin(*a, **k):
        raise AssertionError("a kernel-routed tensor reached the twin")

    monkeypatch.setattr(packet_batch, "trace_batch_ref", no_twin)
    monkeypatch.setattr(packet_batch, "uses_kernel", lambda t: True)
    monkeypatch.setattr(packet_batch, "launch_batch",
                        lambda s, *a: launched.append((s.entry, a[5])))
    before = wrapper.launches
    out = wrapper(tables, *rays, any_hit=True)
    assert launched == [(f"ntrace_packet_{kernel}", True)]
    assert wrapper.launches == before + 1
    assert [o.shape for o in out] == [(16,)] * 4

    def failing(*a):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(packet_batch, "launch_batch", failing)
    with pytest.raises(RuntimeError):
        wrapper(tables, *rays)
    assert wrapper.launches == before + 1


@pytest.mark.parametrize("engine", ENGINES)
def test_engines_render_every_mode(soup_small, flat_small, monkeypatch,
                                   engine):
    """render() of all five modes through each engine: every pass goes
    through the engine's twin on the CPU, and hits and images equal the
    packet engine's bit for bit. bfs and bdl pack one node a row."""
    calls = []
    twin = packet_batch.trace_batch_ref

    def counted(sched, *a, **k):
        calls.append(sched.entry)
        return twin(sched, *a, **k)

    monkeypatch.setattr(packet_batch, "trace_batch_ref", counted)
    assert registry.resolve_kernel(engine).engine == engine
    cam = default_camera("soup")
    for mode in port.MODES:
        out = {}
        for e in (engine, "packet"):
            cfg = RenderConfig(width=16, height=12, mode=mode, samples=2,
                               engine=e)
            r = Renderer(soup_small, BuildConfig(builder="binned_sah"), cfg,
                         flat=flat_small, device="cpu")
            calls.clear()
            out[e] = r.render(cam)
            if e == engine:
                assert r.engine == engine and calls
                assert set(calls) == {f"ntrace_{engine}"}
                assert r.tables.nodes_per_row == 1 or engine == "packet_dleaf"
        np.testing.assert_array_equal(out[engine].hit_tri,
                                      out["packet"].hit_tri)
        np.testing.assert_array_equal(out[engine].hit_t, out["packet"].hit_t)
        np.testing.assert_array_equal(out[engine].image, out["packet"].image)


def test_batch_knobs_follow_the_reference_clamps():
    cfg = RenderConfig(packet_rows=4, qgroup=4, merge_sibs=True)
    assert registry.batch_knobs("packet_bfs", cfg) == {"rows": 8}
    assert registry.batch_knobs("packet_dleaf", RenderConfig(
        packet_rows=48)) == {"rows": 32, "drain_min": 0}
    assert registry.batch_knobs("packet_bdl", cfg) == {
        "rows": 8, "drain_min": 0, "qgroup": 4, "merge_sibs": True}
    assert registry.batch_knobs("packet_bdl", RenderConfig(
        packet_rows=12, qgroup=8))["qgroup"] == 1
    assert registry.batch_knobs("packet", cfg) == {}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_kernel_matches_twin_on_cuda(soup_medium, rng, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    kernel, kw, (tpr, npr) = case
    wrapper, twin, _ = KERNELS[kernel]
    tables = _tables(soup_medium, _flat(soup_medium), tpr, npr,
                     device="cuda")
    orig, dirn, tmin, tmax = random_rays(rng, 4099)
    rays = _torch(orig, dirn, tmin, tmax, device="cuda")
    before = wrapper.launches
    kern = wrapper(tables, *rays, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _assert_bit_equal(kern, twin(tables, *rays, **kw))
    ref = brute_force_mt(soup_medium, orig, dirn, tmin, tmax)
    np.testing.assert_array_equal(kern[0].cpu().numpy(), ref.tri)
    shadow = rays[:3] + [torch.full_like(rays[3], 14.0)]
    _assert_bit_equal(wrapper(tables, *shadow, any_hit=True, **kw),
                      twin(tables, *shadow, any_hit=True, **kw))
