"""The port's tracer (ntrace_tpu_torch/utils/timing.py) on the CPU: off, a
render() synchronises nothing, opens no profiler range and keeps only its
counters; on, every stage has its wall and host time; under torch.profiler
the program's ranges nest as render() opens them; the copies between host
and device of a frame equal the figures derived from its size; the
kernel-launch helper opens its range; and the benchmark's readers of the
new spans and counters, and its reduction of a trace, read them right.
The pixel order is uploaded once a size and stays read-only on the
device; on a CUDA device the image and hits come back in page-locked
memory (the `cuda`-marked tests, which skip without a card).
"""

import dataclasses

import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from benchmark.lib import prof, spec
from benchmark.lib.cell import Readings
from ntrace_tpu_torch.host import (BuildConfig, RenderConfig, default_camera,
                                   get_scene)
from ntrace_tpu_torch.kernels import build as kbuild
from ntrace_tpu_torch.ray.pixeltable import pixel_table
from ntrace_tpu_torch.render.renderer import Renderer, build_accel
from ntrace_tpu_torch.utils import timing
from ntrace_tpu_torch.utils.timing import StageTimer

# 64 x 48 pixels at 4 samples: 12,288 secondary rays, more than the 8,192
# under which _compact_trace traces a batch whole, so the live-prefix read
# runs.
W, H, SAMPLES = 64, 48, 4
BUILD = BuildConfig(builder="binned_sah", sah_tri_cost=0.02, max_leaf_size=48)
STAGES = {
    "primary": ["raygen", "prepare_primary", "trace_primary", "shade",
                "readback"],
    "shadow": ["raygen", "prepare_primary", "trace_primary", "raygen_shadow",
               "trace_shadow", "shade", "readback"],
    "ao": ["raygen", "prepare_primary", "trace_primary", "raygen_ao",
           "trace_ao", "shade", "readback"],
    "diffuse": ["raygen", "prepare_primary", "trace_primary",
                "raygen_diffuse", "trace_diffuse", "shade", "readback"],
    "path": ["raygen", "prepare_primary", "trace_primary", "raygen_bounce0",
             "trace_bounce0", "shade_bounce0", "raygen_bounce1",
             "trace_bounce1", "shade_bounce1", "shade_bounce2", "shade",
             "readback"],
}
PASSES = {"primary": [], "shadow": ["shadow"], "ao": ["ao"],
          "diffuse": ["diffuse"], "path": ["bounce0", "bounce1"]}
COUNTERS = {"copies", "copy_bytes", "pinned_reads", "pixel_order_resident"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (the twins run many small
    ops); restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def conference():
    scene = get_scene("conference", n_tris=2000)
    return scene, build_accel(scene, BUILD)


def _renderer(conference, mode, width=W, height=H, device="cpu"):
    scene, flat = conference
    return Renderer(scene, BUILD, RenderConfig(width=width, height=height,
                                               mode=mode, samples=SAMPLES),
                    flat=flat, device=device)


def _counted(monkeypatch):
    """Count StageTimer's synchronisations and the profiler ranges the
    tracer opens."""
    calls = {"sync": 0, "ranges": []}
    sync = StageTimer._sync
    real = timing.record_function

    def counted_sync(self):
        calls["sync"] += 1
        sync(self)

    def counted_range(name, args=None):
        calls["ranges"].append((name, args))
        return real(name, args)

    monkeypatch.setattr(StageTimer, "_sync", counted_sync)
    monkeypatch.setattr(timing, "record_function", counted_range)
    return calls


@pytest.mark.parametrize("mode", ["ao", "diffuse"])
def test_untraced_render_neither_syncs_nor_opens_ranges(conference, mode,
                                                        monkeypatch):
    r = _renderer(conference, mode)
    calls = _counted(monkeypatch)
    assert not timing.tracing_on()
    res = r.render(default_camera("conference"))
    assert calls == {"sync": 0, "ranges": []}
    assert set(res.stats) == {"rays_primary", f"rays_{mode}"} | COUNTERS


@pytest.mark.parametrize("mode", sorted(STAGES))
def test_traced_render_times_every_stage(conference, mode, monkeypatch):
    r = _renderer(conference, mode)
    calls = _counted(monkeypatch)
    with timing.tracing():
        assert timing.tracing_on()
        st = r.render(default_camera("conference")).stats
    assert not timing.tracing_on()
    stages = STAGES[mode]
    times = {k for k in st
             if not k.startswith(("rays_", "live_"))} - COUNTERS
    assert times == set(stages) | {f"host_{s}" for s in stages}
    for s in stages:
        assert 0 <= st[f"host_{s}"] <= st[s]
    assert not any(k.startswith("mrays_") for k in st)
    assert calls["sync"] == 2 * len(stages)
    for p in ["primary"] + PASSES[mode]:
        assert st[f"rays_{p}"] > 0
    # Path mode alone counts each bounce's live rays: here W x H, under
    # the 8,192 rays from which _compact_trace reads them, so the batch's.
    lives = {k: v for k, v in st.items() if k.startswith("live_")}
    assert lives == ({f"live_{p}": W * H for p in PASSES[mode]}
                     if mode == "path" else {})


def test_untraced_path_frame_neither_syncs_nor_reads_more(conference,
                                                          monkeypatch):
    """Tracing off, a path frame big enough to compact its bounces (128 x
    96: 12,288 rays) synchronises nothing, opens no range, and makes the
    copies its size gives (its one read a bounce is the live prefix's):
    the counters live_bounce<b> take the live rays _compact_trace reads
    already. The first bounce's live rays are the primary hits; a bounce
    never has more live rays than the one before."""
    r = _renderer(conference, "path", width=2 * W, height=2 * H)
    calls = _counted(monkeypatch)
    res = r.render(default_camera("conference"))
    assert calls == {"sync": 0, "ranges": []}
    st = res.stats
    passes = PASSES["path"]
    assert set(st) == ({"rays_primary"} | {f"rays_{p}" for p in passes}
                       | {f"live_{p}" for p in passes} | COUNTERS)
    assert (st["copies"], st["copy_bytes"]) == _frame_copies(
        "path", 2 * W, 2 * H, SAMPLES, r.cfg.bounces)
    assert st["live_bounce0"] == int((res.hit_tri >= 0).sum())
    assert 0 < st["live_bounce1"] <= st["live_bounce0"] <= 4 * W * H


def test_path_ranges_nest_under_the_profiler(conference):
    """A compacted path frame under torch.profiler: each bounce's stages
    under ntrace.render, its Morton sort inside raygen_bounce<b> and its
    compaction inside trace_bounce<b>."""
    r = _renderer(conference, "path", width=2 * W, height=2 * H)
    r.render(default_camera("conference"))
    with profile(activities=[ProfilerActivity.CPU]) as p:
        r.render(default_camera("conference"))
    parents = {}
    for e in p.events():
        if e.name.startswith("ntrace."):
            parents.setdefault(e.name, set()).add(
                e.cpu_parent.name if e.cpu_parent else None)
    want = {"ntrace.render": {None},
            **{f"ntrace.{s}": {"ntrace.render"} for s in STAGES["path"]},
            "ntrace.sort": {"ntrace.raygen_bounce0",
                            "ntrace.raygen_bounce1"},
            "ntrace.compact": {"ntrace.trace_bounce0",
                               "ntrace.trace_bounce1"},
            "ntrace.compact.live_read": {"ntrace.compact"}}
    assert parents == want


def test_ranges_nest_under_the_profiler(conference, monkeypatch):
    """The ranges of an AO frame under torch.profiler on the CPU: the root
    ntrace.render with the frame number as its args, a range per stage
    under it, and the spans inside stages under their stage. The second
    frame of a size uploads no pixel order: ntrace.upload_pixels is the
    first frame's alone."""
    r = _renderer(conference, "ao")
    r.render(default_camera("conference"))
    calls = _counted(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        r.render(default_camera("conference"))
    assert ("ntrace.render", "2") in calls["ranges"] and r.frames == 2
    parent = {e.name: e.cpu_parent.name if e.cpu_parent else None
              for e in p.events() if e.name.startswith("ntrace.")}
    want = {"ntrace.render": None,
            **{f"ntrace.{s}": "ntrace.render" for s in STAGES["ao"]},
            "ntrace.sort": "ntrace.raygen_ao",
            "ntrace.compact": "ntrace.trace_ao",
            "ntrace.compact.live_read": "ntrace.compact"}
    assert parent == want


def test_pixel_order_is_uploaded_once_a_size(conference):
    """The first frame of a renderer uploads the pixel order (13 copies,
    pixel_order_resident 0, the span ntrace.upload_pixels under
    ntrace.raygen); the second takes the resident one (12 copies, 4 bytes
    a pixel fewer). A renderer of another size uploads its own."""
    r = _renderer(conference, "ao")
    cam = default_camera("conference")
    with profile(activities=[ProfilerActivity.CPU]) as p:
        first = r.render(cam).stats
    parent = {e.name: e.cpu_parent.name for e in p.events()
              if e.name == "ntrace.upload_pixels"}
    assert parent == {"ntrace.upload_pixels": "ntrace.raygen"}
    second = r.render(cam).stats
    assert (first["copies"], first["pixel_order_resident"]) == (13, 0)
    assert (second["copies"], second["pixel_order_resident"]) == (12, 1)
    assert first["copy_bytes"] - second["copy_bytes"] == 4 * W * H
    assert first["pinned_reads"] == second["pinned_reads"] == 0
    assert list(r._pixel_orders) == [(W, H)]
    other = _renderer(conference, "ao", width=32, height=24)
    st = other.render(cam).stats
    assert st["pixel_order_resident"] == 0
    assert (st["copies"], st["copy_bytes"]) == _frame_copies("ao", 32, 24,
                                                             SAMPLES)
    assert list(other._pixel_orders) == [(32, 24)]


@pytest.mark.parametrize("mode", sorted(STAGES))
def test_resident_order_stays_the_pixel_table(conference, mode):
    """No mode writes into the resident order through a batch's
    slot_to_id: after each of two frames it still equals pixel_table's."""
    r = _renderer(conference, mode)
    for _ in range(2):
        r.render(default_camera("conference"))
        order = r._pixel_orders[(W, H)]
        assert order.dtype == torch.int32
        assert np.array_equal(order.numpy(), pixel_table(W, H)[0])


@pytest.mark.parametrize("mode", sorted(STAGES))
def test_later_frames_equal_a_fresh_renderers_first(conference, mode):
    """Two consecutive frames of one renderer, the second on the resident
    order, give images and hits bit-equal to a fresh renderer's first."""
    cam = default_camera("conference")
    r = _renderer(conference, mode)
    frames = [r.render(cam) for _ in range(2)]
    fresh = _renderer(conference, mode).render(cam)
    for res in frames:
        for name in ("image", "hit_tri", "hit_t"):
            got, want = getattr(res, name), getattr(fresh, name)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes(), name


def _frame_copies(mode, W, H, samples, bounces=2, resident=False):
    """(copies, bytes) of one frame, from its size: uploads of the 8 camera
    fields (4 vectors of 3 float32, 4 scalars), the pixel order (int32 a
    pixel; on the first frame of a size only, not where `resident`) and,
    for shadow rays, the light (3 float32); reads of the image (3 float32
    a pixel), the two hit arrays (int32, float32) and the live-prefix
    read (2 int64) of each compacted pass. AO, diffuse and path rays draw
    from the seed's host key words: no copy."""
    n = W * H
    copies, nbytes = 8 + 1 + 3, 4 * 12 + 4 * 4 + 4 * n + 20 * n
    if resident:
        copies, nbytes = copies - 1, nbytes - 4 * n
    if mode == "shadow":
        copies, nbytes = copies + 1, nbytes + 12
    if mode in ("ao", "diffuse"):
        compacted = n * samples > 8192
    else:
        compacted = mode == "path" and n > 8192
    reads = len(PASSES[mode]) if compacted else 0
    return copies + reads, nbytes + 16 * reads


@pytest.mark.parametrize("mode", sorted(STAGES))
def test_copies_of_a_frame(conference, mode):
    r = _renderer(conference, mode)
    st = r.render(default_camera("conference")).stats
    want = _frame_copies(mode, W, H, SAMPLES, r.cfg.bounces)
    assert (st["copies"], st["copy_bytes"]) == want
    if mode in ("ao", "diffuse"):
        assert want == (13, 20 * W * H + 4 * W * H + 64 + 16)


@pytest.mark.parametrize("cell", ["conference.diffuse_frame",
                                  "hairball.ao_frame"])
def test_copies_of_a_benchmark_frame(cell):
    """The figures of a frame in the frame cells at 1024 x 768, 4 samples:
    the first frame of the renderer 13 copies of 18,874,448 bytes, and
    every later one, which copies.frame and copy_mb.frame read in the
    window, 12 copies of 15,728,720 bytes (the pixel order resident)."""
    wl = spec.workload(cell)
    rc = spec.config(wl["config"])["render"]
    size = (wl["mode"], rc["width"], rc["height"], rc["samples"])
    assert _frame_copies(*size) == (13, 18_874_448)
    assert _frame_copies(*size, resident=True) == (12, 15_728_720)


def test_copies_count_only_inside_a_frame():
    t = timing.upload(np.arange(4, dtype=np.int32), "cpu")
    assert timing.read(t).tolist() == [0, 1, 2, 3]
    timer = StageTimer("cpu")
    with timer.frame("ntrace.test"):
        timing.read(timing.upload(np.zeros(3, np.float32), "cpu"))
    assert timer.ms() == {"copies": 2, "copy_bytes": 24}


def test_read_all_on_the_cpu_is_read():
    """On the CPU read_all reads as read does, each array one copy, and
    counts no read as pinned."""
    ts = [torch.arange(6, dtype=torch.float32).reshape(2, 3),
          torch.tensor([-1, 7], dtype=torch.int32)]
    timer = StageTimer("cpu")
    with timer.frame("ntrace.test"):
        got = timing.read_all(*ts)
    for a, t in zip(got, ts):
        assert a.dtype == timing.read(t).dtype
        assert np.array_equal(a, t.numpy())
    assert timer.ms() == {"copies": 2, "copy_bytes": 32, "pinned_reads": 0}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (pinned reads and the packet "
                    "kernel)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_read_all_lands_in_pinned_memory_on_cuda():
    """On the card each array lands in page-locked memory, bit-equal to
    .cpu().numpy() (NaN, infinities and -0.0 included)."""
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(5)
    img = torch.randn((768, 1024, 3), device=dev, generator=g)
    img[0, 0] = torch.tensor([float("nan"), float("-inf"), -0.0])
    tri = torch.randint(-1, 2**31 - 1, (786_432,), dtype=torch.int32,
                        device=dev, generator=g)
    t = torch.rand((786_432,), device=dev, generator=g)
    timer = StageTimer(dev)
    with timer.frame("ntrace.test"):
        got = timing.read_all(img, tri, t)
    for a, src in zip(got, (img, tri, t)):
        want = src.cpu().numpy()
        assert a.dtype == want.dtype and a.shape == want.shape
        assert a.tobytes() == want.tobytes()
        assert torch.from_numpy(a).is_pinned()
    assert timer.ms() == {"copies": 3, "copy_bytes": 20 * 786_432,
                          "pinned_reads": 3}


@pytest.mark.cuda
def test_kept_image_survives_later_frames_on_cuda(conference):
    """An image kept from frame 1 is unchanged after 20 frames of other
    cameras: each frame reads into blocks of its own. Every frame makes 3
    pinned reads; the first uploads the pixel order, the rest take it
    resident. The card's frames equal the CPU renderer's hits."""
    dev = _cuda()
    r = _renderer(conference, "diffuse", device=dev)
    base = default_camera("conference")
    cams = [dataclasses.replace(base, position=base.position
                                + np.float32(0.05 * k) * base.forward)
            for k in range(21)]
    first = r.render(cams[0])
    kept = first.image.copy()
    assert (first.stats["pinned_reads"],
            first.stats["pixel_order_resident"]) == (3, 0)
    for cam in cams[1:]:
        st = r.render(cam).stats
        assert (st["pinned_reads"], st["pixel_order_resident"]) == (3, 1)
        assert st["copies"] == 12
    assert first.image.tobytes() == kept.tobytes()
    assert torch.from_numpy(first.image).is_pinned()
    cpu = _renderer(conference, "diffuse").render(cams[0])
    assert np.array_equal(first.hit_tri, cpu.hit_tri)


def test_launch_helper_opens_its_range(monkeypatch):
    got = []
    lib = SimpleNamespace(ntrace_fake=lambda *a: got.append(a) or 0,
                          ntrace_fails=lambda *a: 700)
    monkeypatch.setattr(kbuild, "library", lambda: lib)
    kbuild.launch("ntrace_fake", 1, 2)
    assert got == [(1, 2)]
    with profile(activities=[ProfilerActivity.CPU]) as p:
        kbuild.launch("ntrace_fake", 3)
    assert "ntrace.launch.ntrace_fake" in {e.name for e in p.events()}
    with pytest.raises(RuntimeError, match="ntrace_fails failed: CUDA "
                                           "error 700"):
        kbuild.launch("ntrace_fails")


def test_readers_of_the_new_metrics():
    stats = [{"raygen": 2.0, "host_raygen": 1.5, "raygen_ao": 9.0,
              "host_raygen_ao": 6.5, "trace_ao": 4.0, "host_trace_ao": 1.0,
              "copies": 15, "copy_bytes": 18_874_480}] * 3
    f = Readings(kind="frame", mode="ao", window_s=1.0, stats=stats)
    assert spec.reader("raygen_host_ms.frame")(f) == 8.0
    assert spec.reader("raygen_ms.frame")(f) == 11.0
    assert spec.reader("copies.frame")(f) == 15
    assert math.isclose(spec.reader("copy_mb.frame")(f), 18.87448)
    # A program that records neither (the parent's): nothing to read.
    old = Readings(kind="frame", mode="ao", window_s=1.0,
                   stats=[{"raygen": 2.0, "raygen_ao": 9.0,
                           "rays_ao": 4.0}])
    rays = Readings(kind="rays", window_s=1.0, live_rays=1e6)
    for name in ("raygen_host_ms.frame", "copies.frame", "copy_mb.frame"):
        assert spec.reader(name)(old) is None
        assert spec.reader(name)(rays) is None


def _event(name, start, end, device=False, annotation=False):
    return SimpleNamespace(
        name=name, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=annotation)


def test_reduction_leaves_program_spans_out_of_busy_time():
    """A program span's copy on the device timeline is no operation; the
    device's idle gaps go to the innermost program span open then."""
    events = [_event(prof.FRAME_SPAN, 0, 100),
              _event("ntrace.render", 1, 99),
              _event("ntrace.trace_ao", 10, 50),
              _event("ntrace.compact.live_read", 12, 20),
              _event("ntrace.render", 1, 99, device=True, annotation=True),
              _event("ntrace.trace_ao", 10, 50, device=True,
                     annotation=True),
              _event("k1", 5, 15, device=True),
              _event("k2", 19, 30, device=True),
              _event("k3", 40, 90, device=True)]
    r = prof.reduce_events(events)
    assert r["busy_s"] == pytest.approx((10 + 11 + 50) * 1e-6)
    assert set(r["by_name"]) == {"k1", "k2", "k3"}
    assert dict(r["idle_gaps"]) == pytest.approx(
        {"ntrace.compact.live_read": 4e-6, "ntrace.trace_ao": 10e-6})
