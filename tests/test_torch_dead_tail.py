"""A secondary pass traces its whole sorted batch (CPU; one `cuda` case).

The reference's `_compact_trace` traces the live prefix of a Morton-sorted
batch and pads the dead tail with the miss sentinel tri -1, t 0, u 0,
v 0. The port's traces the whole batch, and each engine's own exit for a
dead ray (tmax <= tmin) gives that sentinel. Held here:

  - every engine of trace/registry.py, through its CPU twin (cpu_golden
    through the host tracer), on a sorted AO and a sorted diffuse batch
    with a dead tail and one live ray among the dead, gives the prefix
    trace and pad bit for bit;
  - `_trace_secondary` reads nothing back and synchronises nothing, and
    hands its live count to `live` as a tensor;
  - on a CUDA device (skips without one), the packet kernel gives the
    prefix trace and pad bit for bit on render()'s batches.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ntrace_tpu_torch.host import (BuildConfig, RenderConfig, default_camera,
                                   get_scene)
from ntrace_tpu_torch.ray import raygen
from ntrace_tpu_torch.ray.pixeltable import pixel_table
from ntrace_tpu_torch.ray.raybatch import RayBatch
from ntrace_tpu_torch.render.renderer import Renderer, build_accel
from ntrace_tpu_torch.trace import registry
from ntrace_tpu_torch.utils import timing

from torch_waits import counted_waits

W, H, SAMPLES = 16, 12, 4     # 768 secondary rays a pass
BUILD = BuildConfig(builder="binned_sah", sah_tri_cost=0.02, max_leaf_size=48)


def _engines() -> list[str]:
    """Every BVH engine a registry name resolves to."""
    out = set()
    for name in registry.kernel_names():
        try:
            out.add(registry.engine_name(registry.resolve_kernel(name).engine))
        except NotImplementedError:
            pass
    return sorted(out)


ENGINES = _engines()


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


def _renderer(conference, mode, engine="packet", device="cpu", width=W,
              height=H, **kw):
    scene, flat = conference
    return Renderer(scene, BUILD,
                    RenderConfig(width=width, height=height, mode=mode,
                                 samples=SAMPLES, engine=engine, **kw),
                    flat=flat, device=device)


def _sorted_batch(r, mode):
    """The sorted secondary batch of `mode` as render() makes it, its last
    third made dead (tmax 0, as a missed pixel's rays are) but for one
    live ray in the middle of that tail, where a live ray that shares the
    dead rays' sort key lands. Returns (batch, any_hit)."""
    cfg = r.cfg
    cam = raygen.camera_arrays(default_camera("conference"), cfg.width,
                               cfg.height, r.device)
    order = torch.from_numpy(pixel_table(cfg.width, cfg.height)[0].copy())
    batch = raygen.primary(cam, cfg.width, cfg.height, order.to(r.device))
    tri, t, _, _ = r.trace_primary(batch.orig, batch.dirn, batch.tmin,
                                   batch.tmax, cam=cam, canonical=True)
    sec, any_hit = r.gen_secondary(default_camera("conference"), mode, batch,
                                   tri, t)
    n = sec.num_rays
    tail = 2 * n // 3
    tmax = sec.tmax.clone()
    keep = tail + (n - tail) // 2
    tmax[tail:keep] = 0.0
    tmax[keep + 1:] = 0.0
    assert bool((sec.tmax[:keep + 1] > sec.tmin[:keep + 1]).all())
    return RayBatch(sec.orig, sec.dirn, sec.tmin, tmax,
                    sec.slot_to_id), any_hit


def _prefix_and_pad(trace, batch, any_hit):
    """The live-prefix answer: the slots up to the last live one traced,
    the rest the miss sentinel tri -1, t 0, u 0, v 0."""
    live = torch.nonzero(batch.tmax > batch.tmin).squeeze(1)
    prefix = int(live.max()) + 1
    tri, t, u, v = trace(batch.orig[:prefix], batch.dirn[:prefix],
                         batch.tmin[:prefix], batch.tmax[:prefix], any_hit)
    pad = batch.num_rays - prefix
    return (torch.cat([tri, tri.new_full((pad,), -1)]),
            *(torch.cat([a, a.new_zeros((pad,))]) for a in (t, u, v)))


def _bit_equal(got, want):
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def test_engines_are_every_bvh_engine():
    assert ENGINES == sorted([*registry.TABLE_TRACERS, "packet_wide",
                              "cpu_golden"])


@pytest.mark.parametrize("mode", ["ao", "diffuse"])
@pytest.mark.parametrize("engine", ENGINES)
def test_whole_batch_is_the_prefix_and_pad(conference, engine, mode):
    r = _renderer(conference, mode, engine=engine)
    batch, any_hit = _sorted_batch(r, mode)
    got = r._trace_secondary(batch, any_hit)
    want = _prefix_and_pad(r.tracer.trace, batch, any_hit)
    _bit_equal(got, want)
    n = batch.num_rays
    dead = batch.tmax <= batch.tmin
    assert int(dead.sum()) == n - 2 * n // 3 - 1
    assert (got[0][dead] == -1).all() and (got[1][dead] == 0).all()
    assert bool((got[0] >= 0).any())


def test_trace_secondary_reads_nothing_and_syncs_nothing(monkeypatch):
    """With timing.read, read_all, tensor reads and every synchronise
    counted: none in a pass of 20,000 rays, 30% live, for every
    compact_rays value; the tracer gets the whole batch once, and `live`
    a 0-d tensor of the live rays."""
    calls = {"read": 0, "sync": 0}

    def counted(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    for mod, name in ((timing, "read"), (timing, "read_all"),
                      (torch.Tensor, "tolist"), (torch.Tensor, "item")):
        monkeypatch.setattr(mod, name, counted("read", getattr(mod, name)))
    counted_waits(monkeypatch, calls)
    rs = np.random.default_rng(3)
    n, live = 20000, 6000
    tmax = torch.zeros(n)
    tmax[:live] = torch.from_numpy(rs.uniform(0.5, 3, live).astype(
        np.float32))
    batch = RayBatch(torch.from_numpy(rs.normal(size=(n, 3)).astype(
        np.float32)), torch.ones(n, 3), torch.zeros(n), tmax)
    traced, counts = [], []

    def trace(o, d, tn, tx, any_hit):
        traced.append(o.shape[0])
        hit = tx > tn
        return (torch.where(hit, 7, -1).to(torch.int32), tx,
                torch.where(hit, 0.5, 0.0), torch.where(hit, 0.25, 0.0))

    for compact in ("on", "off", "auto"):
        r = SimpleNamespace(cfg=RenderConfig(compact_rays=compact),
                            tracer=SimpleNamespace(trace=trace),
                            _cap=lambda: 1 << 22)
        tri, t, _, _ = Renderer._trace_secondary(r, batch, True,
                                                 live=counts.append)
        assert bool((tri[:live] == 7).all()) and bool((tri[live:] == -1).all())
    assert calls == {"read": 0, "sync": 0}
    assert traced == [n] * 3
    assert all(isinstance(c, torch.Tensor) and c.dim() == 0 and
               int(c) == live for c in counts)
    r.cfg = RenderConfig(compact_rays="sometimes")
    with pytest.raises(ValueError, match="compact_rays"):
        Renderer._trace_secondary(r, batch, True)


@pytest.mark.cuda
def test_packet_kernel_whole_batch_is_the_prefix_and_pad_on_cuda(conference):
    """On the card, 64 x 48 pixels at 4 samples (12,288 rays a pass): the
    packet kernel on the whole sorted AO and diffuse batch, dead tail and a
    live ray among the dead, gives the prefix trace and pad bit for bit,
    and its CPU twin the same. render() counts each pass's live rays and
    reads them with the image, which lands in page-locked memory with the
    hits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the packet kernel)")
    dev = torch.device("cuda", 0)
    for mode in ("ao", "diffuse"):
        r = _renderer(conference, mode, device=dev, width=64, height=48)
        batch, any_hit = _sorted_batch(r, mode)
        got = r._trace_secondary(batch, any_hit)
        _bit_equal(got, _prefix_and_pad(r.tracer.trace, batch, any_hit))
        cpu = _renderer(conference, mode, width=64, height=48)
        host = RayBatch(*(a.cpu() for a in (batch.orig, batch.dirn,
                                            batch.tmin, batch.tmax)))
        _bit_equal(got, cpu._trace_secondary(host, any_hit))
        res = r.render(default_camera("conference"))
        hits = int((res.hit_tri >= 0).sum())
        assert res.stats[f"live_{mode}"] == SAMPLES * hits
        assert all(torch.from_numpy(a).is_pinned()
                   for a in (res.image, res.hit_tri, res.hit_t))
