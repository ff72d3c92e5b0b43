"""The HLBVH rebuilt on the device (bvh/hlbvh.py:build_packed_read, through
Renderer._rebuild and update_positions), on the CPU.

  - lbvh_device_fast in forest mode against lbvh_device's forest (the
    30-level sweep, the oracle): per cluster the same treelet, its node
    boxes bit for bit, its child structure and its leaf triangle sets;
    the same cluster count, node count and leaf count; clusters of at
    most max_leaf rows stay leaves of their own;
  - the cluster boxes (range minima, ops/boxes.py) bit-equal to the host
    half's reduceat boxes;
  - the native top tree bit-equal to build_sah_over_boxes, and the Python
    builder serving where the library does not load;
  - update_positions over the fairy configuration's wind poses: primary,
    AO and diffuse frames bit-equal to a renderer built on the host route
    (build_accel and the host pack) from the same pose, the tables the
    tree of build_hlbvh_flat packed one node a row; closest hits and
    occlusion against brute_force_mt and brute_force_anyhit;
  - the reference's three fallbacks take the direct LBVH build, counted
    by rebuild_fallbacks; one read and one upload a rebuild;
  - the spans and stages while tracing, nothing untraced.
The fairy stand-in at 4,922 triangles, a soup and a soup of repeated
triangles.
"""

import dataclasses
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.lib import program, spec
from benchmark.lib.motion import Wind
from benchmark.traffic import frame
from ntrace_tpu_torch.bvh import hlbvh, lbvh
from ntrace_tpu_torch.host import (BuildConfig, RenderConfig, Scene,
                                   brute_force_anyhit, brute_force_mt,
                                   get_scene, pack_bvh)
from ntrace_tpu_torch.host.bvh import sbvh
from ntrace_tpu_torch.host.scenes import make_single_triangle
from ntrace_tpu_torch.render.renderer import Renderer, build_accel
from ntrace_tpu_torch.tables import tree_form
from ntrace_tpu_torch.utils import timing

from conftest import random_rays
from torch_waits import counted_waits

W, H, SAMPLES = 64, 48, 4
FAIRY = spec.config("fairy")
HLBVH = BuildConfig(builder="hlbvh", max_leaf_size=FAIRY["max_leaf_size"],
                    sah_tri_cost=FAIRY["sah_tri_cost"])
CAMERA = program.camera(FAIRY["camera"])
POSES = (2, 9, 2)
REBUILD_KEYS = {"rebuild_tris", "rebuild_nodes", "rebuild_retries",
                "rebuild_scan_launches", "rebuild_box_launches",
                "rebuild_clusters", "rebuild_top_nodes", "rebuild_fallbacks",
                "copies", "copy_bytes"}
SPANS = ["ntrace.update_positions", "ntrace.rebuild", "ntrace.rebuild.inputs",
         "ntrace.rebuild.forest", "ntrace.rebuild.read", "ntrace.rebuild.top",
         "ntrace.rebuild.splice"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dup_soup():
    """600 triangles in five runs of 120 copies of one triangle: clusters
    whose codes all repeat (one fat leaf each, never split)."""
    tv = get_scene("soup", n_tris=600, seed=9).tri_verts().copy()
    for k in range(5):
        tv[k * 120:(k + 1) * 120] = tv[k * 120]
    return Scene(tv.reshape(-1, 3),
                 np.arange(1800, dtype=np.int32).reshape(-1, 3))


SCENES = {
    "fairy": lambda: get_scene("fairy", n_tris=5000, seed=3),
    "soup": lambda: get_scene("soup", n_tris=3000, seed=4),
    "dupes": dup_soup,
}


@pytest.fixture(scope="module")
def scenes():
    return {k: f() for k, f in SCENES.items()}


@pytest.fixture(scope="module")
def fairy(scenes):
    s = scenes["fairy"]
    return s, Wind(FAIRY["motion"], s.positions, s.indices, s.mat_ids)


def _posed(scene, positions):
    return dataclasses.replace(scene, positions=positions)


def _cfg(mode, engine="auto"):
    return RenderConfig(width=W, height=H, samples=SAMPLES, mode=mode,
                        engine=engine, seed=20261018)


# -- the forest --------------------------------------------------------------

def flat_tree(out, root):
    """The treelet under cluster root `root` of a flat forest: a node is
    (its 12 box lanes' bits, child 0, child 1), a leaf the sorted triangle
    ids of its Woop run."""
    nodes, ti = out["nodes"].numpy(), out["tri_index"].numpy()
    enc = np.ascontiguousarray(nodes[:, 12:14]).view(np.int32)
    bits = np.ascontiguousarray(nodes[:, :12]).view(np.int32)

    def form(e):
        if e < 0:
            end = ~e + np.argmax(ti[~e:] < 0)
            return tuple(sorted(ti[~e:end].tolist()))
        return (tuple(bits[e]), form(enc[e, 0]), form(enc[e, 1]))
    return form(int(root))


def _forests(scene, max_leaf, top_bits):
    shift = 30 - top_bits
    args = lbvh.device_inputs(scene, "cpu")
    sweep = lbvh.lbvh_device(*args, max_leaf=max_leaf, cluster_shift=shift)
    fast = lbvh.lbvh_device_fast(*args, max_leaf=max_leaf, emit="flat",
                                 cluster_shift=shift,
                                 compact_cap=scene.num_tris)
    return sweep, fast


@pytest.mark.parametrize("name,max_leaf,top_bits", [
    ("fairy", 8, 9), ("fairy", 32, 9), ("fairy", 2, 12), ("fairy", 4, 6),
    ("soup", 4, 9), ("soup", 8, 3), ("dupes", 8, 9), ("dupes", 2, 4)])
def test_forest_equals_the_sweep(scenes, name, max_leaf, top_bits):
    sweep, fast = _forests(scenes[name], max_leaf, top_bits)
    ncl = int(sweep["n_clusters"])
    assert ncl >= 2 and ncl == int(fast["n_clusters"])
    for k in ("node_count", "leaf_count"):
        assert int(fast[k]) == int(sweep[k]), k
    assert fast["root"] is None
    for c in range(ncl):
        assert flat_tree(fast, fast["cluster_roots"][c]) == flat_tree(
            sweep, sweep["cluster_roots"][c]), c


def test_small_clusters_stay_leaves_of_their_own(scenes):
    """Top bits 12 on the fairy: many clusters of at most max_leaf rows
    side by side, which a plain LBVH would merge into shared leaves. In
    the forest each is its own leaf, and no leaf spans two clusters."""
    scene, max_leaf = scenes["fairy"], 8
    sweep, fast = _forests(scene, max_leaf, 12)
    cid = sweep["cluster_ids"].numpy()
    sizes = np.bincount(cid)
    small = np.flatnonzero(sizes <= max_leaf)
    runs = np.flatnonzero(np.diff((sizes <= max_leaf).astype(int)) == 0)
    assert len(small) > 100 and len(runs) > 50
    rank = np.empty(scene.num_tris, np.int64)
    rank[sweep["order"].numpy()] = np.arange(scene.num_tris)
    for c in small:
        leaf = flat_tree(fast, fast["cluster_roots"][c])
        assert isinstance(leaf[0], int)   # a leaf: its triangle ids
        assert len(leaf) == sizes[c]
        assert (cid[rank[list(leaf)]] == c).all()
    plain = lbvh.lbvh_device_fast(*lbvh.device_inputs(scene, "cpu"),
                                  max_leaf=max_leaf, emit="flat")
    assert int(plain["leaf_count"]) < int(fast["leaf_count"])


@pytest.mark.parametrize("tpr", [12, 4])
def test_packed_forest_reports_the_flat_roots(scenes, tpr):
    """The packed emission's cluster roots: the flat emission's compact
    ids, and for a cluster that is one leaf its first triangle row and
    the rows its run touches."""
    scene = scenes["fairy"]
    args = lbvh.device_inputs(scene, "cpu")
    kw = dict(max_leaf=32, cluster_shift=21, compact_cap=scene.num_tris)
    flat = lbvh.lbvh_device_fast(*args, emit="flat", **kw)
    packed = lbvh.lbvh_device_fast(*args, emit="packed", tpr=tpr, **kw)
    ncl = int(flat["n_clusters"])
    fr = flat["cluster_roots"][:ncl].numpy()
    pr = packed["cluster_roots"][:ncl].numpy()
    rows = packed["cluster_rows"][:ncl].numpy()
    assert (fr >= 0).any() and (fr < 0).any()
    node = fr >= 0
    np.testing.assert_array_equal(pr[node], fr[node])
    assert (rows[node] == 0).all()
    cid = lbvh.lbvh_device(*args, max_leaf=32, cluster_shift=21)[
        "cluster_ids"].numpy()
    start = np.searchsorted(cid, np.arange(ncl))
    end = np.searchsorted(cid, np.arange(ncl), side="right")
    leaf = ~node
    np.testing.assert_array_equal(pr[leaf], -(start[leaf] // tpr) - 1)
    np.testing.assert_array_equal(
        rows[leaf], (end[leaf] - 1) // tpr - start[leaf] // tpr + 1)
    np.testing.assert_array_equal(
        packed["cluster_boxes"][:ncl].numpy().view(np.int32),
        flat["cluster_boxes"][:ncl].numpy().view(np.int32))


@pytest.mark.parametrize("name,top_bits", [("fairy", 9), ("fairy", 12),
                                           ("soup", 9), ("dupes", 9)])
def test_cluster_boxes_equal_reduceat(scenes, name, top_bits):
    """The device's cluster boxes, range minima over the sorted boxes,
    bit-equal to splice_forest's np.minimum/maximum.reduceat (no lane of
    these scenes holds both zeros: there the device takes -0.0 in lo and
    +0.0 in hi)."""
    scene = scenes[name]
    sweep, fast = _forests(scene, 8, top_bits)
    ncl = int(sweep["n_clusters"])
    tv = scene.tri_verts()
    order, cid = sweep["order"].numpy(), sweep["cluster_ids"].numpy()
    starts = np.flatnonzero(np.diff(np.concatenate([[-1], cid])))
    lo = np.minimum.reduceat(tv.min(axis=1)[order], starts, axis=0)
    hi = np.maximum.reduceat(tv.max(axis=1)[order], starts, axis=0)
    boxes = fast["cluster_boxes"][:ncl].numpy()
    np.testing.assert_array_equal(boxes[:, :3].view(np.int32),
                                  lo.view(np.int32))
    np.testing.assert_array_equal(boxes[:, 3:].view(np.int32),
                                  hi.view(np.int32))


# -- the top tree ------------------------------------------------------------

def _boxes(k, seed):
    g = np.random.default_rng(seed)
    lo = g.uniform(-5, 5, (k, 3)).astype(np.float32)
    return lo, lo + g.uniform(0, 2, (k, 3)).astype(np.float32)


TOP_CASES = [(2, {}), (17, {}), (413, {"sah_tri_cost": 0.02}),
             (512, {}), (60, {"max_depth": 3}), (40, {"max_depth": 1})]


@pytest.mark.parametrize("k,kw", TOP_CASES)
def test_native_top_tree_equals_python(k, kw):
    if not sbvh.sbvh_impl_tag(10 ** 6, BuildConfig(builder="binned_sah")) \
            == "native":
        pytest.skip("the native builder does not load here")
    lo, hi = _boxes(k, k)
    cfg = BuildConfig(builder="hlbvh", **kw)
    got = hlbvh.top_tree(lo, hi, cfg)
    want = sbvh.build_sah_over_boxes(lo, hi, cfg)
    for f in ("child", "child_lo", "child_hi", "leaf_first", "leaf_count",
              "tri_order"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_python_top_tree_without_the_library(monkeypatch):
    calls = []
    real = hlbvh.build_sah_over_boxes
    monkeypatch.setattr(hlbvh, "native_sbvh_available", lambda: False)
    monkeypatch.setattr(hlbvh, "build_sah_over_boxes",
                        lambda *a: calls.append(1) or real(*a))
    lo, hi = _boxes(30, 1)
    top = hlbvh.top_tree(lo, hi, BuildConfig(builder="hlbvh"))
    assert calls == [1] and top.num_inner == 29


# -- the renderer's route ----------------------------------------------------

@pytest.mark.parametrize("mode", ["primary", "ao", "diffuse"])
def test_rebuild_equals_the_host_route(fairy, mode):
    scene, wind = fairy
    r = Renderer(scene, HLBVH, _cfg(mode), device="cpu")
    assert r.flat is None
    for key, want in (("build_clusters", 231), ("build_fallbacks", 0),
                      ("build_scan_launches", 0), ("build_box_launches", 0)):
        assert r.timer.counts[key] == want, key
    assert r.timer.counts["build_top_nodes"] == 230
    assert r.timer.counts["build_nodes"] > 230
    for k in POSES:
        pose = wind.pose(k)
        st = r.update_positions(torch.from_numpy(pose))
        assert set(st) == REBUILD_KEYS
        assert st["rebuild_fallbacks"] == 0 and st["rebuild_retries"] == 0
        assert st["rebuild_top_nodes"] == st["rebuild_clusters"] - 1
        posed = _posed(scene, pose)
        flat = build_accel(posed, HLBVH, device="cpu")
        host = Renderer(posed, HLBVH, _cfg(mode), flat=flat, device="cpu")
        got, want = r.render(CAMERA, mode), host.render(CAMERA, mode)
        for a in ("image", "hit_tri", "hit_t"):
            assert np.array_equal(getattr(got, a), getattr(want, a)), a
        # The tree of build_hlbvh_flat, packed one node a row.
        p = pack_bvh(flat, posed.tri_verts(), tris_per_row=12,
                     nodes_per_row=1)
        assert r.tables.num_nodes == p.num_nodes == st["rebuild_nodes"]
        assert np.array_equal(r.tables.tris12.numpy(), p.tris12)
        assert tree_form(r.tables.nodes8) == tree_form(p.nodes8)
        assert (r.geom_normals.numpy() == posed.geometric_normals()).all()
        assert r._bbox[0].tolist() == posed.bbox()[0].tolist()


@pytest.fixture(scope="module")
def moved(fairy):
    """A renderer rebuilt to wind pose 5, and that pose's Scene."""
    scene, wind = fairy
    r = Renderer(scene, HLBVH, _cfg("primary"), device="cpu")
    pose = wind.pose(5)
    r.update_positions(torch.from_numpy(pose))
    return r, _posed(scene, pose)


@pytest.mark.parametrize("any_hit", [False, True])
def test_rebuilt_hits_equal_brute_force(moved, any_hit):
    r, posed = moved
    lo, hi = posed.bbox()
    o, d, tn, tx = random_rays(np.random.default_rng(11), 2048,
                               extent=float(np.abs([lo, hi]).max()) * 1.2)
    tri, t, _, _ = r.tracer.trace(*(torch.from_numpy(a) for a in
                                    (o, d, tn, tx)), any_hit)
    tri = tri.numpy()
    if any_hit:
        blocked = brute_force_anyhit(posed, o, d, tn, tx)
        assert 0.1 < blocked.mean() < 0.9
        np.testing.assert_array_equal(tri >= 0, blocked)
        return
    bf = brute_force_mt(posed, o, d, tn, tx)
    np.testing.assert_array_equal(tri, bf.tri)
    hit = bf.tri >= 0
    np.testing.assert_array_equal(t.numpy()[hit], bf.t[hit])


def test_rebuilt_ao_frame_equals_the_reference(moved):
    """AO of the moved pose: every third pixel as the benchmark's
    reference re-derives it from the pose alone."""
    r, posed = moved
    img = r.render(CAMERA, "ao").image
    pix = np.arange(0, W * H, 3)
    cell = SimpleNamespace(
        config={"render": {"width": W, "height": H, "samples": SAMPLES,
                           "ao_radius": r.cfg.ao_radius}},
        workload={"mode": "ao"}, device=torch.device("cpu"),
        seed32=r.cfg.seed, scene=posed)
    want = frame.reference(cell, [{"view": FAIRY["camera"], "pixels": pix}],
                           torch.float32)
    nums = frame.numbers([{"colours": img.reshape(-1, 3)[pix]}], want)
    assert nums == {"pixel_mismatch": 0.0, "pixel_gap_mean": 0.0}
    assert 0 < (img.reshape(-1, 3).sum(axis=1) > 0).mean() < 1


def one_cluster_soup():
    """300 small triangles in [0.5, 2]^3 and two loose vertices at -10 and
    +10 that set the scene box: one cluster."""
    g = np.random.default_rng(5)
    tv = g.uniform(0.5, 2.0, (300, 3, 3)).astype(np.float32)
    pos = np.concatenate([tv.reshape(-1, 3),
                          np.array([[-10] * 3, [10] * 3], np.float32)])
    return Scene(pos, np.arange(900, dtype=np.int32).reshape(-1, 3))


FALLBACKS = {
    # name: (scene, BuildConfig keywords)
    "one-triangle": (make_single_triangle, {}),
    "one-cluster": (one_cluster_soup, {}),
    "no-internal-node": (lambda: get_scene("soup", n_tris=50, seed=2), {}),
    "multi-box-top-leaf": (lambda: get_scene("soup", n_tris=2000, seed=23),
                           {"max_depth": 1}),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallbacks_take_the_lbvh_build(case):
    """Each of the reference's three fallbacks: the direct LBVH build in
    the same call, counted by rebuild_fallbacks, its tables those of the
    LBVH renderer, its frame that of the host route."""
    make, kw = FALLBACKS[case]
    scene = make()
    # Leaves of up to 64: the 50-triangle soup has no internal node.
    bc = BuildConfig(builder="hlbvh", max_leaf_size=64, **kw)
    r = Renderer(scene, bc, _cfg("primary"), device="cpu")
    assert r.timer.counts["build_fallbacks"] == 1
    st = r.update_positions(torch.from_numpy(scene.positions))
    assert st["rebuild_fallbacks"] == 1 and st["rebuild_top_nodes"] == 0
    plain = Renderer(scene, dataclasses.replace(bc, builder="lbvh"),
                     _cfg("primary"), device="cpu")
    assert torch.equal(r.tables.nodes8, plain.tables.nodes8)
    assert torch.equal(r.tables.tris12, plain.tables.tris12)
    host = Renderer(scene, bc, _cfg("primary"),
                    flat=build_accel(scene, bc, device="cpu"), device="cpu")
    lo, hi = scene.bbox()
    o, d, tn, tx = random_rays(np.random.default_rng(3), 512,
                               extent=float(np.abs([lo, hi]).max()) * 1.5)
    rays = [torch.from_numpy(a) for a in (o, d, tn, tx)]
    got, want = r.tracer.trace(*rays, False), host.tracer.trace(*rays, False)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_one_read_and_one_upload(fairy):
    """A rebuild copies twice: the read (node_count, the box, the check,
    the cluster count and each cluster's root, rows and box, 512 clusters
    of room) and the upload of the T top nodes."""
    scene, wind = fairy
    r = Renderer(scene, HLBVH, _cfg("primary"), device="cpu")
    st = r.update_positions(torch.from_numpy(wind.pose(3)))
    T = st["rebuild_top_nodes"]
    assert st["copies"] == 2
    assert st["copy_bytes"] == 4 * (1 + 6 + 2 + 1 + 512 * 8) + 64 * T


def _counted(monkeypatch):
    """Count the host's waits for the device (torch_waits.counted_waits) and
    the profiler ranges the tracer opens."""
    calls = counted_waits(monkeypatch, {"ranges": []})
    real = timing.record_function

    def counted_range(name, args=None):
        calls["ranges"].append(name)
        return real(name, args)

    monkeypatch.setattr(timing, "record_function", counted_range)
    return calls


def test_untraced_rebuild_neither_syncs_nor_opens_ranges(fairy, monkeypatch):
    scene, wind = fairy
    r = Renderer(scene, HLBVH, _cfg("primary"), device="cpu")
    calls = _counted(monkeypatch)
    st = r.update_positions(torch.from_numpy(wind.pose(1)))
    assert calls == {"sync": 0, "ranges": []}
    assert set(st) == REBUILD_KEYS


def test_traced_rebuild_times_its_stages(fairy, monkeypatch):
    scene, wind = fairy
    r = Renderer(scene, HLBVH, _cfg("primary"), device="cpu")
    assert {"build", "build_top"} <= set(r.timer.stages)
    calls = _counted(monkeypatch)
    with timing.tracing():
        st = r.update_positions(torch.from_numpy(wind.pose(1)))
    assert set(st) == REBUILD_KEYS | {"rebuild", "host_rebuild",
                                      "rebuild_top", "host_rebuild_top",
                                      "host_wait", "host_frame"}
    assert 0 < st["rebuild_top"] <= st["rebuild"] <= st["host_frame"]
    assert 0 <= st["host_rebuild_top"] == st["rebuild_top"]
    assert 0 <= st["host_wait"] <= st["host_rebuild"] == st["rebuild"]
    # Inside tracing() alone no range opens; under a profiler they do.
    assert calls == {"sync": 0, "ranges": []}
    with profile(activities=[ProfilerActivity.CPU]):
        r.update_positions(torch.from_numpy(wind.pose(1)))
    assert calls["sync"] == 0
    assert calls["ranges"] == SPANS


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_traced_rebuild_waits_as_untraced(fairy, device, monkeypatch):
    """A traced update_positions and render() wait for the device exactly
    as often as untraced ones; the spans rebuild and rebuild_top, on the
    card still pending when update_positions returns, are in its stats
    once the next render() has returned, and the constructor's build and
    build_top once the first has."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    scene, wind = fairy
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        "cpu")
    r = Renderer(scene, HLBVH, _cfg("ao"), device=dev)
    r.render(CAMERA)
    assert 0 <= r.timer.stages["build_top"] <= r.timer.stages["build"]
    pose = torch.from_numpy(wind.pose(9)).to(dev)
    waits = {}
    for traced in (False, True):
        calls = {}
        with monkeypatch.context() as m:
            counted_waits(m, calls)
            with timing.tracing() if traced else nullcontext():
                st = r.update_positions(pose)
                r.render(CAMERA)
        waits[traced] = calls["sync"]
    assert waits[True] == waits[False]
    assert 0 <= st["rebuild_top"] <= st["rebuild"]
    assert st["host_wait"] <= st["host_frame"]


def test_rebuild_spans_nest_under_the_profiler(fairy):
    scene, wind = fairy
    r = Renderer(scene, HLBVH, _cfg("primary"), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as p:
        r.update_positions(torch.from_numpy(wind.pose(1)))
    parent = {e.name: e.cpu_parent.name if e.cpu_parent else None
              for e in p.events() if e.name.startswith("ntrace.")}
    assert parent == {"ntrace.update_positions": None,
                      "ntrace.rebuild": "ntrace.update_positions",
                      **{s: "ntrace.rebuild" for s in SPANS[2:]}}


def test_wind_moves_the_canopies_only(fairy):
    scene, wind = fairy
    canopy = np.zeros(scene.num_verts, bool)
    canopy[scene.indices[scene.mat_ids == 2].ravel()] = True
    assert (wind.moving == canopy).all() and 0 < canopy.mean() < 1
    amp = np.asarray(FAIRY["motion"]["amplitude"], np.float32)
    for k in (0, 7, 15):
        p = wind.pose(k)
        assert np.array_equal(p[~canopy], scene.positions[~canopy])
        room = amp + np.spacing(np.abs(scene.positions[canopy]) + amp)
        assert (np.abs(p[canopy] - scene.positions[canopy]) <= room).all()


@pytest.mark.cuda
def test_rebuild_on_cuda_replays_its_graphs(fairy):
    """On the card each build replays the renderer's two CUDA graphs: the
    tables of every pose bit-equal to the CPU build's (the kernels are
    bit-equal to their plain versions), the same rays traced through both
    bit-equal in closest hits, the row scan launched 4 times and the
    child-box kernel twice a build, as the eager build does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    scene, wind = fairy
    dev = torch.device("cuda")     # the current card: poses say cuda:0
    r = Renderer(scene, HLBVH, _cfg("ao"), device=dev)
    cpu = Renderer(scene, HLBVH, _cfg("ao"), device="cpu")
    assert (r.timer.counts["build_scan_launches"],
            r.timer.counts["build_box_launches"]) == (4, 2)
    lo, hi = scene.bbox()
    rays = [torch.from_numpy(a) for a in random_rays(
        np.random.default_rng(12), 4096,
        extent=float(np.abs([lo, hi]).max()) * 1.2)]
    for k in POSES:
        pose = torch.from_numpy(wind.pose(k))
        st = r.update_positions(pose.to(dev))
        cpu.update_positions(pose)
        assert (st["rebuild_scan_launches"], st["rebuild_box_launches"],
                st["rebuild_fallbacks"]) == (4, 2, 0)
        assert torch.equal(r.tables.nodes8.cpu(), cpu.tables.nodes8)
        assert torch.equal(r.tables.tris12.cpu(), cpu.tables.tris12)
        assert torch.equal(r.geom_normals.cpu(), cpu.geom_normals)
        got = r.tracer.trace(*(a.to(dev) for a in rays), False)
        want = cpu.tracer.trace(*rays, False)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])
