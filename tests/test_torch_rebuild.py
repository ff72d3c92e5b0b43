"""Renderer.update_positions on the CPU: the per-frame LBVH rebuild from
moved vertices (render/renderer.py), and the benchmark's wind motion that
moves them (benchmark/lib/motion.py).

The hairball stand-in at 8,450 triangles, 64 x 48 pixels, 4 AO samples,
its poses from the hairball_dynamic configuration's wind field. After
update_positions(p) the tables, the image, hit_tri and hit_t are bit-equal
to those of a Renderer built fresh from a host Scene of p, in the primary,
AO and diffuse modes, over three poses and back to the first; primary and
AO hits of a moved pose equal the plain brute-force reference
(benchmark/lib/reference.py); a pose that overflows the compact cap
retries and still matches; bad inputs and the other routes are refused;
the tracer's spans nest under ntrace.rebuild, and untraced the call opens
no range.
"""

import dataclasses
from contextlib import nullcontext
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.lib import gen, program, spec
from benchmark.lib.motion import Wind
from benchmark.lib.reference import Triangles, closest_hits
from benchmark.traffic import frame
from ntrace_tpu_torch.host import (BuildConfig, RenderConfig, Scene,
                                   get_scene)
from ntrace_tpu_torch.render.renderer import Renderer
from ntrace_tpu_torch.utils import timing

from torch_waits import counted_waits

W, H, SAMPLES = 64, 48, 4
LBVH = BuildConfig(builder="lbvh", max_leaf_size=32)
MOTION = spec.config("hairball_dynamic")["motion"]
VIEW = spec.config("hairball")["camera"]
CAMERA = program.camera(VIEW)
# Three poses and back to the first: no state of one pose may leak into
# the next.
POSES = (1, 6, 11, 1)
REBUILD_KEYS = {"rebuild_tris", "rebuild_nodes", "rebuild_retries",
                "rebuild_scan_launches", "rebuild_box_launches", "copies",
                "copy_bytes"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hair():
    scene = get_scene("hairball", n_tris=8000, seed=4)
    return scene, Wind(MOTION, scene.positions, scene.indices,
                       scene.mat_ids)


def _cfg(mode, engine="auto"):
    return RenderConfig(width=W, height=H, samples=SAMPLES, mode=mode,
                        engine=engine, seed=20261018)


def _posed(scene, positions):
    return dataclasses.replace(scene, positions=positions)


@pytest.fixture(scope="module")
def fresh(hair):
    """Renderers built fresh from a host Scene of each pose, by mode."""
    scene, wind = hair
    return {(k, mode): Renderer(_posed(scene, wind.pose(k)), LBVH,
                                _cfg(mode), device="cpu")
            for k in set(POSES) for mode in ("primary", "ao", "diffuse")}


@pytest.mark.parametrize("mode", ["primary", "ao", "diffuse"])
def test_rebuild_equals_a_fresh_build(hair, fresh, mode):
    scene, wind = hair
    r = Renderer(scene, LBVH, _cfg(mode), device="cpu")
    assert r.timer.counts["build_scan_launches"] == 0
    assert r.timer.counts["build_box_launches"] == 0
    nodes = []
    for k in POSES:
        st = r.update_positions(torch.from_numpy(wind.pose(k)))
        assert set(st) == REBUILD_KEYS
        # The CPU takes the row scan's and the child boxes' plain
        # versions: no kernel launch.
        assert (st["rebuild_tris"], st["rebuild_retries"],
                st["rebuild_scan_launches"],
                st["rebuild_box_launches"]) == (scene.num_tris, 0, 0, 0)
        f = fresh[k, mode]
        assert st["rebuild_nodes"] == f.tables.num_nodes
        assert torch.equal(r.tables.nodes8, f.tables.nodes8)
        assert torch.equal(r.tables.tris12, f.tables.tris12)
        assert torch.equal(r.geom_normals, f.geom_normals)
        assert (r.scene_scale, r.eps) == (f.scene_scale, f.eps)
        got, want = r.render(CAMERA, mode), f.render(CAMERA, mode)
        for a in ("image", "hit_tri", "hit_t"):
            assert np.array_equal(getattr(got, a), getattr(want, a)), a
        nodes.append(r.tables.nodes8.clone())
    # The poses move the tree, and the last pose is the first again.
    assert not torch.equal(nodes[0], nodes[1])
    assert torch.equal(nodes[0], nodes[-1])


@pytest.fixture(scope="module")
def tied(hair):
    """The hairball with a copy, appended, of every triangle the rest pose's
    primary frame hits (the ground's stay put, the hair's move with it):
    each hit on one is a tie in t that the lowest id wins."""
    scene, _ = hair
    r = Renderer(scene, LBVH, _cfg("primary"), device="cpu")
    hits = np.unique(r.render(CAMERA, "primary").hit_tri)
    dup = hits[hits >= 0]
    s = Scene(scene.positions,
              np.concatenate([scene.indices, scene.indices[dup]]),
              mat_ids=np.concatenate([scene.mat_ids, scene.mat_ids[dup]]),
              materials=scene.materials)
    return s, Wind(MOTION, s.positions, s.indices, s.mat_ids), dup


def test_primary_hits_equal_the_reference(tied):
    """Closest hits of a moved pose: the reference's triangle (the lowest
    id on a tie) on every pixel, and its t, bit for bit, on every hit (a
    miss keeps the ray's tmax, the reference's 0)."""
    scene, wind, dup = tied
    r = Renderer(scene, LBVH, _cfg("primary"), device="cpu")
    pose = wind.pose(5)
    r.update_positions(torch.from_numpy(pose))
    got = r.render(CAMERA, "primary")
    cam = gen.camera_arrays(VIEW["position"], VIEW["forward"], VIEW["up"],
                            VIEW["fov_deg"], VIEW["znear"], VIEW["zfar"], W,
                            H, "cpu")
    prim = gen.primary(cam, W, H, torch.arange(W * H, dtype=torch.int32))
    tri, t, _, _ = closest_hits(
        Triangles(torch.from_numpy(pose[scene.indices])), prim.orig,
        prim.dirn, prim.tmin, prim.tmax)
    hit = tri.numpy() >= 0
    assert np.array_equal(got.hit_tri, tri.numpy())
    assert np.array_equal(got.hit_t[hit], t.numpy()[hit])
    assert (got.hit_t[~hit] == VIEW["zfar"]).all() and 0 < hit.mean() < 1
    # Ties were taken, and taken by the lower id.
    assert np.isin(got.hit_tri, dup).any()
    assert (got.hit_tri < scene.num_tris - dup.size).all()


def test_ao_frame_equals_the_reference(hair):
    """AO of a moved pose: every third pixel's colour as the benchmark's
    reference re-derives it (primary closest hit, the secondary rays,
    their any hits, the shading) from the pose alone."""
    scene, wind = hair
    cfg = _cfg("ao")
    r = Renderer(scene, LBVH, cfg, device="cpu")
    pose = wind.pose(9)
    r.update_positions(torch.from_numpy(pose))
    img = r.render(CAMERA, "ao").image
    pix = np.arange(0, W * H, 3)
    cell = SimpleNamespace(
        config={"render": {"width": W, "height": H, "samples": SAMPLES,
                           "ao_radius": cfg.ao_radius}},
        workload={"mode": "ao"}, device=torch.device("cpu"),
        seed32=cfg.seed, scene=_posed(scene, pose))
    want = frame.reference(cell, [{"view": VIEW, "pixels": pix}],
                           torch.float32)
    nums = frame.numbers([{"colours": img.reshape(-1, 3)[pix]}], want)
    assert nums == {"pixel_mismatch": 0.0, "pixel_gap_mean": 0.0}
    assert 0 < (img.reshape(-1, 3).sum(axis=1) > 0).mean() < 1


def test_compact_cap_retry(hair):
    """Leaves of at most 2: the rest pose's tree overflows the compact
    cap and is rebuilt at the cap n (rebuild_retries 1, a second read);
    the pose snapped to a 0.1 grid fits the cap."""
    scene, _ = hair
    bc = BuildConfig(builder="lbvh", max_leaf_size=2)
    snapped = (np.round(scene.positions / 0.1) * 0.1).astype(np.float32)
    r = Renderer(_posed(scene, snapped), bc, _cfg("primary"), device="cpu")
    assert r.timer.counts["build_retries"] == 0
    for pose, retries in ((scene.positions, 1), (snapped, 0)):
        st = r.update_positions(torch.from_numpy(pose))
        assert st["rebuild_retries"] == retries
        assert (st["copies"], st["copy_bytes"]) == (1 + retries,
                                                    36 * (1 + retries))
        f = Renderer(_posed(scene, pose), bc, _cfg("primary"), device="cpu")
        assert torch.equal(r.tables.nodes8, f.tables.nodes8)
        assert torch.equal(r.tables.tris12, f.tables.tris12)
        got, want = r.render(CAMERA), f.render(CAMERA)
        assert np.array_equal(got.hit_tri, want.hit_tri)
        assert np.array_equal(got.hit_t, want.hit_t)


@pytest.mark.cuda
def test_rebuild_counts_its_scan_launches_on_cuda(hair):
    """On the card each try of the build launches the row scan 4 times
    (the two class scans and the two kept-neighbour scans) and the
    child-box kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    scene, wind = hair
    dev = torch.device("cuda", 0)
    r = Renderer(scene, LBVH, _cfg("ao"), device=dev)
    assert r.timer.counts["build_scan_launches"] == 4
    assert r.timer.counts["build_box_launches"] == 1
    for k in POSES:
        st = r.update_positions(torch.from_numpy(wind.pose(k)).to(dev))
        assert st["rebuild_retries"] == 0
        assert st["rebuild_scan_launches"] == 4
        assert st["rebuild_box_launches"] == 1


@pytest.fixture(scope="module")
def soup():
    return get_scene("soup", n_tris=600, seed=0)


@pytest.mark.parametrize("bad,err", [
    (lambda v: torch.zeros((v + 1, 3)), ValueError),
    (lambda v: torch.zeros((v, 4)), ValueError),
    (lambda v: torch.zeros((v, 3), dtype=torch.float64), TypeError),
    (lambda v: torch.zeros((v, 3), device="meta"), ValueError),
], ids=["vertices", "lanes", "dtype", "device"])
def test_bad_positions_are_refused(soup, bad, err):
    r = Renderer(soup, LBVH, _cfg("primary"), device="cpu")
    with pytest.raises(err, match="positions"):
        r.update_positions(bad(soup.num_verts))


@pytest.mark.parametrize("builder,engine,given_flat", [
    ("binned_sah", "auto", False),
    ("lbvh", "binraster_dense", False),
    ("lbvh", "packet_wide", False),
    ("lbvh", "packet_ww", False),
    ("lbvh", "auto", True),
])
def test_other_routes_are_refused(soup, builder, engine, given_flat):
    from ntrace_tpu_torch.render.renderer import build_accel
    bc = BuildConfig(builder=builder, max_leaf_size=8, sah_tri_cost=0.02)
    flat = build_accel(soup, bc, device="cpu") if given_flat else None
    r = Renderer(soup, bc, _cfg("primary", engine), flat=flat, device="cpu")
    with pytest.raises(NotImplementedError, match="item 45"):
        r.update_positions(torch.from_numpy(soup.positions))


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


def test_untraced_rebuild_neither_syncs_nor_opens_ranges(soup,
                                                         monkeypatch):
    r = Renderer(soup, LBVH, _cfg("primary"), device="cpu")
    calls = _counted(monkeypatch)
    st = r.update_positions(torch.from_numpy(soup.positions))
    assert calls == {"sync": 0, "ranges": []}
    assert set(st) == REBUILD_KEYS
    assert (st["copies"], st["copy_bytes"]) == (1, 36)


def test_traced_rebuild_times_its_stage(soup, monkeypatch):
    r = Renderer(soup, LBVH, _cfg("primary"), device="cpu")
    calls = _counted(monkeypatch)
    with timing.tracing():
        st = r.update_positions(torch.from_numpy(soup.positions))
    assert set(st) == REBUILD_KEYS | {"rebuild", "host_rebuild",
                                      "host_wait", "host_frame"}
    assert 0 <= st["host_wait"] <= st["host_rebuild"] == st["rebuild"]
    assert st["rebuild"] <= st["host_frame"]
    # Inside tracing() alone no range opens; under a profiler they do.
    assert calls == {"sync": 0, "ranges": []}
    with profile(activities=[ProfilerActivity.CPU]):
        r.update_positions(torch.from_numpy(soup.positions))
    assert calls["sync"] == 0
    assert calls["ranges"] == [
        "ntrace.update_positions", "ntrace.rebuild", "ntrace.rebuild.inputs",
        "ntrace.rebuild.lbvh", "ntrace.rebuild.node_count"]


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_traced_rebuild_waits_as_untraced(hair, device, monkeypatch):
    """A traced update_positions and render() wait for the device exactly
    as often as untraced ones; the rebuild's span, on the card still
    pending when update_positions returns, is in its stats once the next
    render() has returned, and the constructor's build once the first
    has."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    scene, wind = hair
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        "cpu")
    r = Renderer(scene, LBVH, _cfg("ao"), device=dev)
    r.render(CAMERA)
    assert r.timer.stages["build"] >= 0
    pose = torch.from_numpy(wind.pose(6)).to(dev)
    waits = {}
    for traced in (False, True):
        calls = {}
        with monkeypatch.context() as m:
            counted_waits(m, calls)
            with timing.tracing() if traced else nullcontext():
                st = r.update_positions(pose)
                res = r.render(CAMERA)
        waits[traced] = calls["sync"]
    assert waits[True] == waits[False]
    assert st["rebuild"] >= 0 and st["host_wait"] <= st["host_frame"]
    assert res.stats["host_wait"] <= res.stats["host_frame"]


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_rebuilds_without_frames_leave_nothing_pending(soup, device):
    """100 untraced update_positions calls with no render() between add
    no timer to the tracer's pending list; 10 traced ones keep it at one
    more at most, each call's read resolving the calls before it."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        "cpu")
    r = Renderer(soup, LBVH, _cfg("primary"), device=dev)
    pose = torch.from_numpy(soup.positions).to(dev)
    r.update_positions(pose)
    before = len(timing._pending)
    for _ in range(100):
        r.update_positions(pose)
    assert len(timing._pending) == before
    with timing.tracing():
        for _ in range(10):
            r.update_positions(pose)
            assert len(timing._pending) <= before + 1


def test_rebuild_spans_nest_under_the_profiler(soup):
    r = Renderer(soup, LBVH, _cfg("primary"), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as p:
        r.update_positions(torch.from_numpy(soup.positions))
    parent = {e.name: e.cpu_parent.name if e.cpu_parent else None
              for e in p.events() if e.name.startswith("ntrace.")}
    assert parent == {"ntrace.update_positions": None,
                      "ntrace.rebuild": "ntrace.update_positions",
                      "ntrace.rebuild.inputs": "ntrace.rebuild",
                      "ntrace.rebuild.lbvh": "ntrace.rebuild",
                      "ntrace.rebuild.node_count": "ntrace.rebuild"}


# -- the benchmark's motion --------------------------------------------------

def test_same_seed_same_poses(hair):
    scene, wind = hair
    again = Wind(MOTION, scene.positions, scene.indices, scene.mat_ids)
    for k in (0, 7, 15, 16):
        assert np.array_equal(wind.pose(k), again.pose(k))
    other = Wind(dict(MOTION, motion_seed=13), scene.positions,
                 scene.indices, scene.mat_ids)
    assert not np.array_equal(wind.pose(3), other.pose(3))
    assert np.array_equal(wind.pose(16), wind.pose(0))


def test_ground_stays_and_hair_moves_within_the_amplitude(hair):
    scene, wind = hair
    ground = np.zeros(scene.num_verts, bool)
    ground[scene.indices[scene.mat_ids == 1].ravel()] = True
    assert ground.sum() == 289 and (wind.moving == ~ground).all()
    amp = np.asarray(MOTION["amplitude"], np.float32)
    rest = scene.positions
    for k in range(MOTION["poses"]):
        p = wind.pose(k)
        assert p.dtype == np.float32 and p.shape == rest.shape
        assert np.array_equal(p[ground], rest[ground])
        # Within A, and the rounding to float32 of the moved coordinate.
        room = amp + np.spacing(np.abs(rest[~ground]) + amp)
        assert (np.abs(p[~ground] - rest[~ground]) <= room).all()
        assert (np.abs(p - rest).max(axis=0) > amp / 2).all()
