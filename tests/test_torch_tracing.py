"""The port's tracer (ntrace_tpu_torch/utils/timing.py) on the CPU: off, a
render() synchronises nothing, opens no profiler range and keeps only its
counters; on, it still synchronises nothing, and every stage has its span
and host time, the frame its host wait and host time; under
torch.profiler the program's ranges nest as render() opens them and every
aten op of a frame lies in a stage; the copies between host and device of
a frame equal the figures derived from its size; the kernel-launch helper
opens its range; and the benchmark's readers of the spans and counters,
and its reduction of a trace, read them right. The pixel order is
uploaded once a size and stays read-only on the device. The `cuda`-marked
tests, which skip without a card: the image and hits come back in
page-locked memory; a traced frame waits for the device no more often than
an untraced one, its stages' device spans are sound, and a stage inside a
CUDA graph capture records no event.
"""

import dataclasses

import math
from contextlib import nullcontext
from time import perf_counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from benchmark.lib import prof, spec
from benchmark.lib.cell import Readings
from ntrace_tpu_torch.bvh.lbvh import Graphed
from ntrace_tpu_torch.host import (BuildConfig, RenderConfig, default_camera,
                                   get_scene)
from ntrace_tpu_torch.kernels import build as kbuild
from ntrace_tpu_torch.ray.pixeltable import pixel_table
from ntrace_tpu_torch.render.renderer import Renderer, build_accel
from ntrace_tpu_torch.utils import timing
from ntrace_tpu_torch.utils.timing import StageTimer

from torch_waits import counted_waits

# 64 x 48 pixels at 4 samples: 12,288 secondary rays a pass, each pass
# traced whole with nothing read back.
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
# The passes through _trace_secondary, which count live_<pass>.
LIVE = {"primary": [], "shadow": [], "ao": ["ao"], "diffuse": ["diffuse"],
        "path": ["bounce0", "bounce1"]}
COUNTERS = {"copies", "copy_bytes"}
# The frame's host times while tracing is on (utils/timing.py).
FRAME_TIMES = {"host_wait", "host_frame"}


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
    """Count the host's waits for the device (torch_waits.counted_waits) and
    the profiler ranges the tracer opens."""
    calls = counted_waits(monkeypatch, {"ranges": []})
    real = timing.record_function

    def counted_range(name, args=None):
        calls["ranges"].append((name, args))
        return real(name, args)

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
    assert set(res.stats) == ({"rays_primary", f"rays_{mode}",
                               f"live_{mode}"} | COUNTERS)
    assert not torch.from_numpy(res.image).is_pinned()


@pytest.mark.parametrize("mode", sorted(STAGES))
def test_traced_render_times_every_stage(conference, mode, monkeypatch):
    r = _renderer(conference, mode)
    calls = _counted(monkeypatch)
    with timing.tracing():
        assert timing.tracing_on()
        res = r.render(default_camera("conference"))
    assert not timing.tracing_on()
    st = res.stats
    stages = STAGES[mode]
    times = {k for k in st
             if not k.startswith(("rays_", "live_"))} - COUNTERS
    assert times == (set(stages) | {f"host_{s}" for s in stages}
                     | FRAME_TIMES)
    for s in stages:
        # On the CPU a stage's span is its host time.
        assert 0 <= st[f"host_{s}"] == st[s]
    assert 0 <= st["host_wait"] <= st["host_readback"]
    assert sum(st[s] for s in stages) <= st["host_frame"]
    assert not any(k.startswith("mrays_") for k in st)
    # Inside tracing() alone no profiler range opens: none would record.
    assert calls == {"sync": 0, "ranges": []}
    for p in ["primary"] + PASSES[mode]:
        assert st[f"rays_{p}"] > 0
    # Each pass through _trace_secondary counts its live rays on the
    # device: AO and diffuse rays of the pixels that hit, and each bounce's
    # rays whose path is alive.
    lives = {k: v for k, v in st.items() if k.startswith("live_")}
    assert set(lives) == {f"live_{p}" for p in LIVE[mode]}
    hits = int((res.hit_tri >= 0).sum())
    if mode in ("ao", "diffuse"):
        assert lives[f"live_{mode}"] == SAMPLES * hits
    if mode == "path":
        assert lives["live_bounce0"] == hits
        assert 0 < lives["live_bounce1"] <= hits


def test_untraced_path_frame_neither_syncs_nor_reads_more(conference,
                                                          monkeypatch):
    """Tracing off, a path frame of 128 x 96 (12,288 rays a bounce)
    synchronises nothing, opens no range, and makes the copies its size
    gives: the counters live_bounce<b>, counted on the device, come back
    in one copy with the image. The first bounce's live rays are the primary hits; a bounce
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
    """A path frame under torch.profiler: each bounce's stages under
    ntrace.render and its Morton sort inside raygen_bounce<b>; no span
    inside trace_bounce<b> (the pass reads nothing back)."""
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
                            "ntrace.raygen_bounce1"}}
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
            "ntrace.sort": "ntrace.raygen_ao"}
    assert parent == want


def _profiled_render(r, cam):
    """(render(cam) of `r` under the profiler, whether it opened the span
    ntrace.upload_pixels, under ntrace.raygen where it did)."""
    with profile(activities=[ProfilerActivity.CPU]) as p:
        res = r.render(cam)
    parents = [e.cpu_parent.name for e in p.events()
               if e.name == "ntrace.upload_pixels"]
    assert parents in ([], ["ntrace.raygen"])
    return res, bool(parents)


@pytest.mark.parametrize("mode", sorted(STAGES))
def test_every_op_of_a_frame_lies_in_a_stage(conference, mode):
    """Under torch.profiler every aten op inside ntrace.render lies inside
    one of the frame's stage ranges: the camera's upload, the normal
    colour, the unsort and the colour's composition included."""
    r = _renderer(conference, mode)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        r.render(default_camera("conference"))
    stages = {f"ntrace.{s}" for s in STAGES[mode]}
    inside, outside = 0, []
    for e in p.events():
        if not e.name.startswith("aten::"):
            continue
        above, q = set(), e.cpu_parent
        while q is not None:
            above.add(q.name)
            q = q.cpu_parent
        if "ntrace.render" in above:
            if above & stages:
                inside += 1
            else:
                outside.append(e.name)
    assert outside == [] and inside > 0


def test_pixel_order_is_uploaded_once_a_size(conference):
    """The first frame of a renderer uploads the pixel order (13 copies,
    the span ntrace.upload_pixels under ntrace.raygen); the second takes
    the resident one, the same tensor (12 copies, 4 bytes a pixel fewer,
    no upload span). A renderer of another size uploads its own. On the
    CPU the image comes back in pageable memory."""
    r = _renderer(conference, "ao")
    cam = default_camera("conference")
    first, uploaded = _profiled_render(r, cam)
    assert uploaded
    order = r._pixel_orders[(W, H)]
    second, uploaded = _profiled_render(r, cam)
    assert not uploaded and r._pixel_orders[(W, H)] is order
    assert first.stats["copies"] == 13 and second.stats["copies"] == 12
    assert (first.stats["copy_bytes"] - second.stats["copy_bytes"]
            == 4 * W * H)
    for res in (first, second):
        assert not torch.from_numpy(res.image).is_pinned()
    assert list(r._pixel_orders) == [(W, H)]
    other = _renderer(conference, "ao", width=32, height=24)
    res, uploaded = _profiled_render(other, cam)
    assert uploaded
    assert (res.stats["copies"], res.stats["copy_bytes"]) == _frame_copies(
        "ao", 32, 24, SAMPLES)
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
    a pixel), the two hit arrays (int32, float32) and, where the frame
    has AO, diffuse or bounce passes, their live counts in one read (an
    int64 a pass). AO, diffuse and path rays draw from the seed's host key
    words: no copy."""
    n = W * H
    copies, nbytes = 8 + 1 + 3, 4 * 12 + 4 * 4 + 4 * n + 20 * n
    if resident:
        copies, nbytes = copies - 1, nbytes - 4 * n
    if mode == "shadow":
        copies, nbytes = copies + 1, nbytes + 12
    passes = len(LIVE[mode])
    return copies + int(passes > 0), nbytes + 8 * passes


@pytest.mark.parametrize("mode", sorted(STAGES))
def test_copies_of_a_frame(conference, mode):
    r = _renderer(conference, mode)
    st = r.render(default_camera("conference")).stats
    want = _frame_copies(mode, W, H, SAMPLES, r.cfg.bounces)
    assert (st["copies"], st["copy_bytes"]) == want
    if mode in ("ao", "diffuse"):
        assert want == (13, 20 * W * H + 4 * W * H + 64 + 8)


@pytest.mark.parametrize("cell", ["conference.diffuse_frame",
                                  "hairball.ao_frame"])
def test_copies_of_a_benchmark_frame(cell):
    """The figures of a frame in the frame cells at 1024 x 768, 4 samples:
    the first frame of the renderer 13 copies of 18,874,440 bytes, and
    every later one, which copies.frame and copy_mb.frame read in the
    window, 12 copies of 15,728,712 bytes (the pixel order resident)."""
    wl = spec.workload(cell)
    rc = spec.config(wl["config"])["render"]
    size = (wl["mode"], rc["width"], rc["height"], rc["samples"])
    assert _frame_copies(*size) == (13, 18_874_440)
    assert _frame_copies(*size, resident=True) == (12, 15_728_712)


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
        assert not torch.from_numpy(a).is_pinned()
    assert timer.ms() == {"copies": 2, "copy_bytes": 32}


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
    assert timer.ms() == {"copies": 3, "copy_bytes": 20 * 786_432}


@pytest.mark.cuda
def test_kept_image_survives_later_frames_on_cuda(conference):
    """An image kept from frame 1 is unchanged after 20 frames of other
    cameras: each frame reads into blocks of its own. Every frame's image
    and hits land in page-locked memory; the first uploads the pixel
    order (13 copies), the rest take the same tensor resident (12). The
    card's frames equal the CPU renderer's hits."""
    dev = _cuda()
    r = _renderer(conference, "diffuse", device=dev)
    base = default_camera("conference")
    cams = [dataclasses.replace(base, position=base.position
                                + np.float32(0.05 * k) * base.forward)
            for k in range(21)]
    first = r.render(cams[0])
    kept = first.image.copy()
    order = r._pixel_orders[(W, H)]
    assert first.stats["copies"] == 13
    for cam in cams[1:]:
        res = r.render(cam)
        assert res.stats["copies"] == 12
        assert r._pixel_orders[(W, H)] is order
        for a in (res.image, res.hit_tri, res.hit_t):
            assert torch.from_numpy(a).is_pinned()
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


def test_readers_of_the_host_split():
    """host_wait_ms and host_issue_ms (both splits) read the mean
    host_wait and host_frame - host_wait a frame, and nothing unless every
    frame of the window records what they read, where the program records
    neither (the parent's stats) or in a rays cell."""
    stats = [{"host_frame": 5.0, "host_wait": 1.5, "raygen": 1.0,
              "copies": 12},
             {"host_frame": 7.0, "host_wait": 2.5, "raygen": 1.0,
              "copies": 12}]
    f = Readings(kind="frame", mode="ao", window_s=1.0, stats=stats)
    old = Readings(kind="frame", mode="ao", window_s=1.0,
                   stats=[{"raygen": 2.0, "host_raygen": 1.0,
                           "copies": 12}])
    half = Readings(kind="frame", mode="ao", window_s=1.0,
                    stats=[stats[0], {"host_wait": 1.0}])
    some = Readings(kind="frame", mode="ao", window_s=1.0,
                    stats=[stats[0], {"raygen": 1.0}])
    rays = Readings(kind="rays", window_s=1.0, live_rays=1e6)
    for split in ("frame", "rebuild"):
        wait = spec.reader(f"host_wait_ms.{split}")
        issue = spec.reader(f"host_issue_ms.{split}")
        assert wait(f) == 2.0 and issue(f) == 4.0
        assert wait(half) == 1.25 and issue(half) is None
        for r in (old, some, rays):
            assert wait(r) is None and issue(r) is None


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
              _event("ntrace.launch.ntrace_packet_trace", 12, 20),
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
        {"ntrace.launch.ntrace_packet_trace": 4e-6,
         "ntrace.trace_ao": 10e-6})


# A case on the CPU and one on the card (which skips without one).
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name):
    return _cuda() if name == "cuda" else torch.device("cpu")


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("mode", sorted(STAGES))
def test_traced_frame_waits_as_untraced(conference, mode, device,
                                        monkeypatch):
    """A traced frame calls torch.cuda.synchronize, a stream's and an
    event's synchronize exactly as often as an untraced one."""
    dev = _device(device)
    r = _renderer(conference, mode, device=dev)
    cam = default_camera("conference")
    r.render(cam)          # the size's first frame uploads the pixel order
    waits = {}
    for traced in (False, True):
        calls = {}
        with monkeypatch.context() as m:
            counted_waits(m, calls)
            with timing.tracing() if traced else nullcontext():
                st = r.render(cam).stats
        waits[traced] = calls["sync"]
        assert ("host_frame" in st) == traced
    assert waits[True] == waits[False]


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("mode", sorted(STAGES))
def test_stage_spans_fit_the_frame(conference, mode, device):
    """Every stage's span is at least 0, and a traced frame's top-level
    stages (on the card device spans, which tile its device timeline) sum
    to no more than its wall; its host wait lies within its host time."""
    dev = _device(device)
    r = _renderer(conference, mode, device=dev)
    cam = default_camera("conference")
    r.render(cam)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = perf_counter()
    with timing.tracing():
        st = r.render(cam).stats
    wall = (perf_counter() - t0) * 1e3
    spans = [st[s] for s in STAGES[mode]]
    assert min(spans) >= 0
    assert sum(spans) <= wall
    assert 0 <= st["host_wait"] <= st["host_frame"] <= wall
    # After the frame's wait no timer stays pending. Its events, resolved
    # at its exit, are spares that the next frame records on: one at the
    # frame's entry and one at each stage's exit.
    assert not timing._pending
    if dev.type == "cuda":
        pool = timing._spare[torch.cuda.current_device()]
        spare = len(pool)
        assert spare >= len(spans) + 1
        with timing.tracing():
            r.render(cam)
        assert len(pool) == spare


@pytest.mark.cuda
def test_stage_in_a_graph_capture_records_no_event(monkeypatch):
    """A stage opened while the current stream captures a CUDA graph
    records no event (its span is its host time), and the capture replays
    bit-equal to the eager call; the warm-up calls before the capture,
    on a side stream, time by events that resolve."""
    dev = _cuda()
    recorded = []
    real = torch.cuda.Event.record

    def record(self, stream=None):
        recorded.append(torch.cuda.is_current_stream_capturing())
        return real(self, stream)

    monkeypatch.setattr(torch.cuda.Event, "record", record)
    timer = StageTimer(dev)

    def fn(x):
        with timer.stage("captured"):
            return (x * 3 + 1).sqrt()

    graph = Graphed(own_inputs=True)
    x = torch.linspace(0, 7, 4096, device=dev)
    with timing.tracing():
        first = graph(fn, x).clone()
    assert recorded and not any(recorded)
    y = torch.linspace(1, 9, 4096, device=dev)
    with timing.tracing():
        again = graph(fn, y)
    for got, src in ((first, x), (again, y)):
        assert torch.equal(got, (src * 3 + 1).sqrt())
    torch.cuda.synchronize(dev)
    assert not timer.resolve()
    assert timer.stages["captured"] >= 0 and "host_captured" in timer.stages
