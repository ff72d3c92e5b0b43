"""The port's primary-frame slice against the JAX renderer (CPU).

One FlatBVH feeds both sides. The JAX renderer runs its Pallas packet
kernel in interpret mode; the port runs the kernel's torch twin. Hit ids
must be exactly equal, the image within atol 1e-6 (the shading normalises
normals in float32 in two frameworks), and the frame must show 0
tie-aware mismatches against trace_cpu_golden.
"""

import numpy as np
import pytest
import torch

from ntrace_tpu.core import BuildConfig, RenderConfig
from ntrace_tpu.render.renderer import Renderer as JaxRenderer
from ntrace_tpu.scenes import default_camera, get_scene, make_random_soup
from ntrace_tpu.trace.cpu import golden_mismatches, trace_cpu_golden
from ntrace_tpu_torch.ray import raygen
from ntrace_tpu_torch.ray.pixeltable import pixel_table
from ntrace_tpu_torch.ray.raybatch import RayBatch
from ntrace_tpu_torch.render import renderer as port
from ntrace_tpu_torch.render.renderer import Renderer, build_accel

from conftest import random_rays

W, H = 64, 48
BENCH_BUILD = BuildConfig(builder="binned_sah", sah_tri_cost=0.02,
                          max_leaf_size=48)


@pytest.fixture(scope="module")
def conference():
    scene = get_scene("conference", n_tris=5000)   # 10,320 triangles
    return scene, build_accel(scene, BENCH_BUILD)


def test_render_primary_matches_jax(conference):
    scene, flat = conference
    cam = default_camera("conference")
    cfg = RenderConfig(width=W, height=H, mode="primary", engine="packet")
    r = Renderer(scene, BENCH_BUILD, cfg, flat=flat, device="cpu")
    got = r.render(cam)
    jr = JaxRenderer(scene, BENCH_BUILD, cfg, flat=flat)
    ref = jr.render(cam)
    # the very same tables on both sides
    assert (r.tables.tris_per_row, r.tables.nodes_per_row) == (
        jr.packed.tris_per_row, jr.packed.nodes_per_row)
    np.testing.assert_array_equal(r.tables.nodes8.numpy(),
                                  jr.packed.nodes8)
    np.testing.assert_array_equal(r.tables.tris12.numpy(),
                                  jr.packed.tris12)
    assert got.image.shape == (H, W, 3) and got.image.dtype == np.float32
    np.testing.assert_array_equal(got.hit_tri, ref.hit_tri)
    np.testing.assert_allclose(got.image, ref.image, rtol=0, atol=1e-6)
    assert got.image.max() > 0 and (got.hit_tri >= 0).mean() > 0.5
    assert got.stats["rays_primary"] == W * H

    order, _ = pixel_table(W, H)
    batch = raygen.primary(raygen.camera_arrays(cam, W, H, "cpu"), W, H,
                           torch.from_numpy(order.copy()))
    rec = trace_cpu_golden(flat, batch.orig.numpy(), batch.dirn.numpy(),
                           batch.tmin.numpy(), batch.tmax.numpy())
    slot = order.astype(np.int64)
    assert golden_mismatches(got.hit_tri[slot], got.hit_t[slot], rec.tri,
                             rec.t) == 0


@pytest.mark.parametrize("engine", ["auto", "wavefront", "packet"])
def test_packet_engine_names_resolve(conference, engine):
    scene, flat = conference
    r = Renderer(scene, BENCH_BUILD, RenderConfig(engine=engine), flat=flat,
                 device="cpu")
    assert r.engine == "packet"
    assert r.tables.tris_per_row == r.packed.tris_per_row
    assert r.tables.nodes_per_row == r.packed.nodes_per_row


@pytest.mark.parametrize("engine", ["packet_ww", "packet_ifif"])
def test_variant_engines_trace_host_packed_tables(engine):
    """packet_ww and packet_ifif trace host-packed tables; builder="lbvh"
    with them takes the flat route (build_lbvh_flat, then the host pack),
    as in the reference."""
    soup = make_random_soup(n_tris=300, seed=2)
    r = Renderer(soup, BuildConfig(builder="lbvh", max_leaf_size=8),
                 RenderConfig(engine=engine), device="cpu")
    assert r.engine == engine and r.flat is not None
    assert r.tables.tris_per_row == r.packed.tris_per_row
    assert r.tables.nodes_per_row == r.packed.nodes_per_row
    with pytest.raises(ValueError, match="unknown engine"):
        Renderer(soup, BuildConfig(builder="median"),
                 RenderConfig(engine="no_such_engine"), device="cpu")


def test_renderer_needs_an_explicit_device(soup_small):
    with pytest.raises(TypeError, match="device"):
        Renderer(soup_small, BuildConfig(builder="median"), RenderConfig())


def test_pick_layout_matches_reference(conference):
    scene, flat = conference
    n_refs, avg_leaf, tpr, npr = port.pick_layout(flat)
    assert n_refs == scene.num_tris and avg_leaf >= 6.0
    assert (tpr, npr) == (12, 1)   # fat leaves, small node table


def test_cpu_golden_engine(soup_small, rng):
    flat = build_accel(soup_small, BuildConfig(builder="median"))
    r = Renderer(soup_small, BuildConfig(builder="median"),
                 RenderConfig(engine="cpu_golden"), flat=flat, device="cpu")
    orig, dirn, tmin, tmax = (torch.from_numpy(a)
                              for a in random_rays(rng, 300))
    tri, t, _, _ = r.trace_primary(orig, dirn, tmin, tmax)
    rec = trace_cpu_golden(flat, orig.numpy(), dirn.numpy(), tmin.numpy(),
                           tmax.numpy())
    np.testing.assert_array_equal(tri.numpy(), rec.tri)


def test_trace_batched_chunks_equal_one_batch(soup_small, rng):
    r = Renderer(soup_small, BuildConfig(builder="binned_sah"),
                 RenderConfig(), device="cpu")
    batch = RayBatch(*(torch.from_numpy(a) for a in random_rays(rng, 500)))
    whole = port._trace_batched(r._tracer, batch, 1 << 20, False)
    chunked = port._trace_batched(r._tracer, batch, 128, False)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_trace_batched_retries_only_on_oom():
    calls = []

    def tracer(o, d, tn, tx, any_hit):
        calls.append(o.shape[0])
        if o.shape[0] > 8192:
            raise torch.cuda.OutOfMemoryError("out of memory")
        z = torch.zeros(o.shape[0])
        return z.int(), z, z, z

    batch = RayBatch(torch.zeros(20000, 3), torch.ones(20000, 3),
                     torch.zeros(20000), torch.ones(20000))
    out = port._trace_batched(tracer, batch, 16384, False)
    assert out[0].shape == (20000,) and max(calls[1:]) <= 8192

    def broken(o, d, tn, tx, any_hit):
        raise ValueError("not an OOM")

    with pytest.raises(ValueError):
        port._trace_batched(broken, batch, 16384, False)


@pytest.mark.parametrize("kw,match", [
    (dict(mode="textured"), "texture"),
    (dict(engine="stack2"), "not ported"),
    (dict(engine="binraster"), "v1 screen-space engine"),
    (dict(seed_primary="on"), "seeded primary"),
    (dict(engine="packet_pipe"), "packet family"),
    (dict(mode="diffuse", seed_secondary="on"), "item 15"),
])
def test_unported_paths_raise(soup_small, kw, match):
    flat = build_accel(soup_small, BuildConfig(builder="median"))
    cfg = RenderConfig(width=8, height=8, **kw)
    with pytest.raises(NotImplementedError, match=match):
        Renderer(soup_small, BuildConfig(builder="median"), cfg, flat=flat,
                 device="cpu").render(default_camera("soup"))


@pytest.mark.parametrize("builder", ["hlbvh", "kdtree"])
def test_unported_builders_raise(builder):
    """A builder not ported yet raises and names its ROADMAP item."""
    soup = make_random_soup(n_tris=50, seed=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_accel(soup, BuildConfig(builder=builder))
