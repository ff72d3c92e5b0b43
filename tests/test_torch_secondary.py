"""The port's secondary-ray slice against the JAX reference (CPU): the
threefry generator, the secondary ray generators, the Morton re-sort,
gen_secondary, _compact_trace, and render() for shadow, ao, diffuse and
path; `raygen.secondary_rays` on the CPU as its plain version
`secondary_rays_ref`, and (on a CUDA device only) the kernel
csrc/secondary_rays.cu against that plain version.

Tolerances, with their reasons:
  - rng: bit-exact (integer arithmetic, and one exact float conversion).
  - ray generators: atol 2e-6 on unit directions and 1e-6 relative on
    origins and lengths. torch and XLA on the CPU may differ in the last bit
    of cos, sin and sqrt, and XLA contracts a*b + c into FMAs (the port does
    not), so directions agree within a few ulps, not bit for bit.
  - Morton sort: identical keys and permutation (integer keys, stable
    sort), on rays generated on the numpy side and fed to both.
  - render(): hit ids exactly equal; images within atol 1e-5 on all but at
    most 1% of the pixels, the bound on pixels whose secondary ray may
    meet another triangle because its direction differs by an ulp (0 such
    pixels at the time of writing).
  - The reference's own secondary batch, fed as numpy to the port's tracer,
    gives the reference tracer's hit ids exactly (closest hit), and the
    same blocked set (any hit).
  - secondary_rays kernel against its plain version on the card: random
    words, origins, tmin, tmax bit-equal, and keys wherever the directions
    are; directions within 2 ulps (CUDA's cosf and sinf against torch's
    cos and sin on the card; their last bit may differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntrace_tpu.core import BuildConfig, RenderConfig
from ntrace_tpu.ray import raygen as jax_raygen
from ntrace_tpu.ray.raybatch import RayBatch as JaxRayBatch
from ntrace_tpu.ray.raybatch import morton_sort_rays as jax_morton_sort_rays
from ntrace_tpu.render import renderer as jax_renderer
from ntrace_tpu.render.renderer import Renderer as JaxRenderer
from ntrace_tpu.scenes import default_camera, get_scene
from ntrace_tpu_torch.ray import raygen, rng
from ntrace_tpu_torch.ray.raybatch import (DEAD_KEY, RayBatch,
                                           morton_sort_key, morton_sort_rays,
                                           sort_by_key, unsort)
from ntrace_tpu_torch.render import renderer as port
from ntrace_tpu_torch.render.renderer import Renderer, build_accel
from ntrace_tpu_torch.utils import timing

W, H, SAMPLES = 64, 48, 2
BENCH_BUILD = BuildConfig(builder="binned_sah", sah_tri_cost=0.02,
                          max_leaf_size=48)
MODES = ("shadow", "ao", "diffuse", "path")
# The JAX renderer's engine for the reference frames: the if-if Pallas
# kernel in interpret mode (the packet kernel gives the same frames and
# takes 3-4x as long interpreted).
JAX_ENGINE = "packet_ifif"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins run many small torch ops; with the suite's test workers
    sharing the cores, one intra-op thread per worker avoids
    oversubscribing them. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _u32(a):
    return np.asarray(a).astype(np.int64)


def _unit(rs, n):
    v = rs.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_jax_threefry_is_partitionable():
    """ray/rng.py repeats the partitionable threefry; a jax that flips the
    flag changes the reference's numbers, so it must fail here, loudly."""
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", [0, 7, 123456789, -5])
def test_rng_bit_exact_against_jax(seed):
    assert jax.config.jax_threefry_partitionable is True
    key, tkey = jax.random.PRNGKey(seed), rng.prng_key(seed, "cpu")
    np.testing.assert_array_equal(_u32(key), tkey.numpy())
    for num in (2, 3):
        np.testing.assert_array_equal(_u32(jax.random.split(key, num)),
                                      rng.split(tkey, num).numpy())
    sub, tsub = jax.random.split(key)[1], rng.split(tkey)[1]
    for shape in ((5,), (4, 3, 2), (1000, 2)):
        want = np.asarray(jax.random.uniform(sub, shape, dtype=jnp.float32))
        got = rng.uniform(tsub, shape).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("seed", [-2 ** 31, -2 ** 31 + 1, -1, 0, 1,
                                  2 ** 31 - 2, 2 ** 31 - 1])
def test_key_words_equal_the_uploaded_key(seed):
    words = rng.key_words(seed)
    assert words == tuple(int(w) for w in timing.read(rng.prng_key(seed,
                                                                   "cpu")))
    assert all(0 <= w < 2 ** 32 for w in words)
    bits = rng.random_bits32(rng.prng_key(seed, "cpu"), (5, 2))
    assert torch.equal(rng.random_bits32(words, (5, 2), "cpu"), bits)
    for bad in (-2 ** 31 - 1, 2 ** 31):
        with pytest.raises(ValueError, match="int32 range"):
            rng.key_words(bad)


def test_cosine_hemisphere_matches_jax():
    rs = np.random.default_rng(5)
    n = _unit(rs, 300)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_raygen.cosine_hemisphere(key, jnp.asarray(n),
                                                   (300,)))
    got = raygen.cosine_hemisphere(rng.prng_key(3, "cpu"),
                                   torch.from_numpy(n), (300,)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    # unit length, in the normal's hemisphere
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1, atol=1e-5)
    assert ((got * n).sum(axis=1) >= -1e-6).all()


def test_shadow_and_ao_match_jax():
    rs = np.random.default_rng(6)
    r = 257
    hit_pos = rs.uniform(-5, 5, size=(r, 3)).astype(np.float32)
    normal = _unit(rs, r)
    light = np.array([0.5, 4.0, -1.0], np.float32)
    eps = np.float32(2.5e-3)
    j = jax_raygen.shadow(jnp.asarray(hit_pos), jnp.asarray(normal),
                          jnp.asarray(light), eps)
    g = raygen.shadow(torch.from_numpy(hit_pos), torch.from_numpy(normal),
                      torch.from_numpy(light), float(eps))
    _close_batches(g, j)
    key = jax.random.PRNGKey(11)
    for gen, jgen, arg in ((raygen.ao, jax_raygen.ao, 1.0),
                           (raygen.diffuse, jax_raygen.diffuse, 123.4)):
        j = jgen(key, jnp.asarray(hit_pos), jnp.asarray(normal), 3,
                 jnp.float32(arg), eps)
        g = gen(rng.prng_key(11, "cpu"), torch.from_numpy(hit_pos),
                torch.from_numpy(normal), 3, arg, float(eps))
        assert g.num_rays == 3 * r
        _close_batches(g, j)


def _close_batches(g: RayBatch, j):
    np.testing.assert_allclose(g.orig.numpy(), np.asarray(j.orig), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(g.dirn.numpy(), np.asarray(j.dirn), rtol=0,
                               atol=2e-6)
    np.testing.assert_array_equal(g.tmin.numpy(), np.asarray(j.tmin))
    np.testing.assert_allclose(g.tmax.numpy(), np.asarray(j.tmax), rtol=1e-6)
    np.testing.assert_array_equal(g.slot_to_id.numpy(),
                                  np.asarray(j.slot_to_id))


def _sort_by_key(batch, lo, hi, direction_major):
    """morton_sort_rays's key, then raybatch.sort_by_key."""
    key = morton_sort_key(batch.orig, batch.dirn, lo, hi,
                          direction_major=direction_major)
    return sort_by_key(batch, torch.where(batch.tmax <= batch.tmin, DEAD_KEY,
                                          key))


@pytest.mark.parametrize("direction_major,sort", [
    pytest.param(True, morton_sort_rays, id="True"),
    pytest.param(False, morton_sort_rays, id="False"),
    pytest.param(True, _sort_by_key, id="True-sort_by_key"),
    pytest.param(False, _sort_by_key, id="False-sort_by_key")])
def test_morton_sort_rays_identical_permutation(direction_major, sort):
    rs = np.random.default_rng(8)
    n = 3000
    orig = rs.uniform(-3, 7, size=(n, 3)).astype(np.float32)
    dirn = _unit(rs, n)
    tmin = np.zeros(n, np.float32)
    tmax = rs.uniform(0, 2, size=n).astype(np.float32)
    tmax[rs.random(n) < 0.3] = 0.0            # dead rays
    lo, hi = np.full(3, -3, np.float32), np.full(3, 7, np.float32)
    want = jax_morton_sort_rays(
        JaxRayBatch(*(jnp.asarray(a) for a in (orig, dirn, tmin, tmax)),
                    jnp.arange(n, dtype=jnp.int32)),
        jnp.asarray(lo), jnp.asarray(hi), direction_major=direction_major)
    got = sort(
        RayBatch(*(torch.from_numpy(a) for a in (orig, dirn, tmin, tmax))),
        torch.from_numpy(lo), torch.from_numpy(hi),
        direction_major=direction_major)
    np.testing.assert_array_equal(got.slot_to_id.numpy(),
                                  np.asarray(want.slot_to_id))
    for a, b in ((got.orig, want.orig), (got.dirn, want.dirn),
                 (got.tmax, want.tmax)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    live = int((tmax > tmin).sum())
    assert (got.tmax[:live] > 0).all() and (got.tmax[live:] == 0).all()


def test_unsort_restores_rows():
    ids = torch.randperm(50, generator=torch.Generator().manual_seed(1))
    vals = torch.arange(150, dtype=torch.float32).reshape(50, 3)
    back = unsort(vals, ids.to(torch.int32))
    assert torch.equal(back[ids], vals)
    assert torch.equal(unsort(vals[:, 0], ids), back[:, 0])


def _fake_tracer(ns):
    """A tracer whose outputs are functions of the rays alone, for
    _compact_trace on both sides."""
    def tr(o, d, tn, tx, any_hit):
        tri = (tx * 1000).astype("int32") if ns is jnp else (
            tx * 1000).to(torch.int32)
        return tri, tx + 1.0, o[:, 0] + any_hit, d[:, 1]
    return tr


@pytest.mark.parametrize("compact", ["on", "off", "auto"])
@pytest.mark.parametrize("live_frac", [0.3, 0.9])
def test_compact_trace_matches_reference(compact, live_frac):
    rs = np.random.default_rng(9)
    n = 20000
    live = int(n * live_frac)
    orig = rs.normal(size=(n, 3)).astype(np.float32)
    dirn = _unit(rs, n)
    tmin = np.zeros(n, np.float32)
    tmax = np.zeros(n, np.float32)
    tmax[:live] = rs.uniform(0.5, 3, size=live).astype(np.float32)
    want = jax_renderer._compact_trace(
        _fake_tracer(jnp),
        JaxRayBatch(*(jnp.asarray(a) for a in (orig, dirn, tmin, tmax))),
        1 << 22, True, compact=compact)
    batch = RayBatch(*(torch.from_numpy(a) for a in (orig, dirn, tmin, tmax)))
    got = port._compact_trace(_fake_tracer(torch), batch, 1 << 22, True,
                              compact=compact)
    # Slots the reference traced are equal; the reference also traces the
    # dead slots of its power-of-two pad, where the port writes the
    # sentinel a trace of a dead ray (tmax 0) would give.
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy()[:live], np.asarray(w)[:live])
    np.testing.assert_array_equal(got[0].numpy()[live:], 0 if compact ==
                                  "off" or (compact == "auto"
                                            and live_frac > 0.75) else -1)


def test_compact_trace_keeps_a_live_ray_behind_dead_ones():
    """A live ray can share the dead rays' sort key (0x7FFFFFFF) and then
    sort among them: the traced prefix runs through the last live slot."""
    n = 10000
    tmax = torch.zeros(n)
    tmax[:1000] = 1.0
    tmax[5000] = 2.0                   # a live ray among the dead ones
    batch = RayBatch(torch.zeros(n, 3), torch.ones(n, 3), torch.zeros(n),
                     tmax)
    calls = []

    def tr(o, d, tn, tx, any_hit):
        calls.append(o.shape[0])
        return (tx * 10).to(torch.int32), tx, tx, tx

    tri, t, _, _ = port._compact_trace(tr, batch, 1 << 22, False)
    assert calls == [5001]
    assert int(tri[5000]) == 20 and float(t[5000]) == 2.0
    assert (tri[5001:] == -1).all() and (t[5001:] == 0).all()


@pytest.fixture(scope="module")
def conference():
    scene = get_scene("conference", n_tris=5000)   # 10,320 triangles
    return scene, build_accel(scene, BENCH_BUILD)


def _cfg(mode, engine):
    return RenderConfig(width=W, height=H, mode=mode, engine=engine,
                        samples=SAMPLES)


@pytest.fixture(scope="module")
def jax_frames(conference):
    """The JAX renderer's frame of each secondary mode (computed once)."""
    scene, flat = conference
    cam = default_camera("conference")
    return {m: JaxRenderer(scene, BENCH_BUILD, _cfg(m, JAX_ENGINE),
                           flat=flat).render(cam) for m in MODES}


@pytest.mark.parametrize("engine", ["auto", "packet_ww", "packet_ifif"])
@pytest.mark.parametrize("mode", MODES)
def test_render_secondary_matches_jax(conference, jax_frames, mode, engine):
    scene, flat = conference
    r = Renderer(scene, BENCH_BUILD, _cfg(mode, engine), flat=flat,
                 device="cpu")
    with timing.tracing():
        got = r.render(default_camera("conference"))
    ref = jax_frames[mode]
    assert got.image.shape == (H, W, 3) and got.image.dtype == np.float32
    np.testing.assert_array_equal(got.hit_tri, ref.hit_tri)
    bad = (np.abs(got.image - ref.image) > 1e-5).any(axis=2)
    assert bad.sum() <= W * H // 100, int(bad.sum())
    assert np.isfinite(got.image).all() and got.image.max() > 0
    passes = {"shadow": ["shadow"], "ao": ["ao"], "diffuse": ["diffuse"],
              "path": ["bounce0", "bounce1"]}[mode]
    for p in passes:
        want = W * H * (SAMPLES if mode in ("ao", "diffuse") else 1)
        assert got.stats[f"rays_{p}"] == ref.stats[f"rays_{p}"] == want
        assert f"trace_{p}" in got.stats and f"host_trace_{p}" in got.stats
        assert f"mrays_{p}" not in got.stats


@pytest.mark.parametrize("mode,misses", [
    pytest.param("shadow", False, id="shadow"),
    pytest.param("ao", False, id="ao"),
    pytest.param("diffuse", False, id="diffuse"),
    pytest.param("ao", True, id="ao-misses"),
    pytest.param("diffuse", True, id="diffuse-misses")])
def test_gen_secondary_matches_reference(conference, mode, misses):
    """The same primary hits give the reference's secondary batch: the same
    permutation and dead rays, origins and directions within tolerance.
    With `misses`, every seventh primary ray is made a miss (the conference
    room is closed, so the frame has almost none of its own)."""
    scene, flat = conference
    cam = default_camera("conference")
    jr = JaxRenderer(scene, BENCH_BUILD, _cfg(mode, JAX_ENGINE), flat=flat)
    r = Renderer(scene, BENCH_BUILD, _cfg(mode, "packet"), flat=flat,
                 device="cpu")
    batch, tri, t = _primary(r, cam)
    if misses:
        tri, t = _plant_misses(tri, t)
    jb = JaxRayBatch(*(jnp.asarray(a.numpy()) for a in (
        batch.orig, batch.dirn, batch.tmin, batch.tmax, batch.slot_to_id)))
    want, want_any = jr.gen_secondary(cam, mode, jb, jnp.asarray(tri.numpy()),
                                      jnp.asarray(t.numpy()))
    got, got_any = r.gen_secondary(cam, mode, batch, tri, t)
    assert got_any == want_any
    np.testing.assert_array_equal(got.slot_to_id.numpy(),
                                  np.asarray(want.slot_to_id))
    np.testing.assert_array_equal(got.tmax.numpy() > got.tmin.numpy(),
                                  np.asarray(want.tmax > want.tmin))
    if misses:
        dead = int((got.tmax <= got.tmin).sum())
        assert dead == SAMPLES * int((tri < 0).sum()) > 0
    _close_batches(got, want)


def _plant_misses(tri, t):
    """The primary hits with every seventh ray made a miss."""
    tri, t = tri.clone(), t.clone()
    tri[::7], t[::7] = -1, float("nan")
    return tri, t


def _primary(r, cam):
    from ntrace_tpu_torch.ray.pixeltable import pixel_table

    order, _ = pixel_table(W, H)
    batch = raygen.primary(raygen.camera_arrays(cam, W, H, "cpu"), W, H,
                           torch.from_numpy(order.copy()))
    tri, t, _, _ = r.trace_primary(batch.orig, batch.dirn, batch.tmin,
                                   batch.tmax)
    return batch, tri, t


@pytest.mark.parametrize("mode", ["shadow", "ao", "diffuse"])
def test_reference_batch_gives_reference_hits(conference, mode):
    """The JAX renderer's own secondary batch, as numpy, through the port's
    tracer: the hit ids of the JAX tracer exactly (closest hit), the same
    blocked rays (any hit)."""
    scene, flat = conference
    cam = default_camera("conference")
    jr = JaxRenderer(scene, BENCH_BUILD, _cfg(mode, JAX_ENGINE), flat=flat)
    r = Renderer(scene, BENCH_BUILD, _cfg(mode, "packet"), flat=flat,
                 device="cpu")
    order = jnp.asarray(jax_renderer.pixel_table(W, H)[0])
    jb = jax_raygen.primary(jax_raygen.camera_arrays(cam, W, H), W, H, order)
    tri, t, _, _ = jr.trace_primary(jb.orig, jb.dirn, jb.tmin, jb.tmax)
    sec, any_hit = jr.gen_secondary(cam, mode, jb, tri, t)
    want = np.asarray(jr._tracer(sec.orig, sec.dirn, sec.tmin, sec.tmax,
                                 any_hit)[0])
    rays = [torch.from_numpy(np.array(a)) for a in (sec.orig, sec.dirn,
                                                    sec.tmin, sec.tmax)]
    got = r.tracer.trace(*rays, any_hit)[0].numpy()
    if any_hit:
        np.testing.assert_array_equal(got >= 0, want >= 0)
        assert 0 < (want >= 0).mean() < 1
    else:
        np.testing.assert_array_equal(got, want)
        assert (want >= 0).mean() > 0.5   # the conference room is closed


def _secondary_inputs(conference, mode):
    """A CPU renderer of `mode`, its primary batch and hits with every
    seventh primary ray made a miss, and secondary_rays' arguments after
    the key words."""
    scene, flat = conference
    r = Renderer(scene, BENCH_BUILD, _cfg(mode, "packet"), flat=flat,
                 device="cpu")
    batch, tri, t = _primary(r, default_camera("conference"))
    tri, t = _plant_misses(tri, t)
    return r, (batch, tri, t, r.geom_normals, SAMPLES,
               r.secondary_length(mode), r.eps, r.scene_lo, r.scene_hi,
               mode != "ao")


@pytest.mark.parametrize("mode", ["ao", "diffuse"])
def test_secondary_rays_on_the_cpu_runs_the_plain_version(conference, mode):
    """On the CPU secondary_rays is secondary_rays_ref, bit for bit, and
    launches nothing: unsorted rays (no slot_to_id), the rays of missed
    primary rays dead under DEAD_KEY. It refuses bits=, which only the
    kernel fills. (That the plain version gives the reference's batch is
    test_gen_secondary_matches_reference's.)"""
    _, args = _secondary_inputs(conference, mode)
    tri = args[1]
    words = rng.key_words(2 ** 31 - 1)
    launches = raygen.secondary_rays.launches
    got, key = raygen.secondary_rays(words, *args)
    want, want_key = raygen.secondary_rays_ref(words, *args)
    assert raygen.secondary_rays.launches == launches
    assert got.slot_to_id is None
    for a, b in ((got.orig, want.orig), (got.dirn, want.dirn),
                 (got.tmin, want.tmin), (got.tmax, want.tmax)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert key.dtype == torch.int32 and torch.equal(key, want_key)
    dead = key == DEAD_KEY
    assert torch.equal(dead, got.tmax <= got.tmin)
    assert int(dead.sum()) == SAMPLES * int((tri < 0).sum()) > 0
    bits = torch.empty((got.num_rays, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="bits="):
        raygen.secondary_rays(words, *args, bits=bits)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ao", "diffuse"])
def test_secondary_rays_kernel_on_cuda(conference, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from chip_smoke import ulps

    _, (batch, *rest) = _secondary_inputs(conference, mode)
    dev = torch.device("cuda")
    args = (RayBatch(batch.orig.to(dev), batch.dirn.to(dev),
                     batch.tmin.to(dev), batch.tmax.to(dev)),
            *(a.to(dev) if isinstance(a, torch.Tensor) else a for a in rest))
    n = batch.num_rays * SAMPLES
    for seed in (-2 ** 31, 0, 2 ** 31 - 1):
        words = rng.key_words(seed)
        bits = torch.empty((n, 2), dtype=torch.int32, device=dev)
        launches = raygen.secondary_rays.launches
        got, key = raygen.secondary_rays(words, *args, bits=bits)
        torch.cuda.synchronize()
        assert raygen.secondary_rays.launches == launches + 1
        want, want_key = raygen.secondary_rays_ref(words, *args)
        assert torch.equal(bits, rng.random_bits32(words, (n, 2), dev).to(
            torch.int32))
        for a, b in ((got.orig, want.orig), (got.tmin, want.tmin),
                     (got.tmax, want.tmax)):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        du = ulps(got.dirn, want.dirn)
        assert int(du.max()) <= 2
        same = (du == 0).all(dim=1)
        assert torch.equal(key[same], want_key[same])
        assert (key == DEAD_KEY).sum() == (want_key == DEAD_KEY).sum() > 0
