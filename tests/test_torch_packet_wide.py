"""The 8-wide packet traversal of the port (torch twin on the CPU, CUDA
kernel on a card) and the packet_wide and packet_pipe engines in render(),
against the JAX package (Pallas kernels in interpret mode), the
brute-force oracles and the port's packet twin.

Tolerances: hit ids exactly equal everywhere. Against the JAX kernel t/u/v
within the reference's own packet-test tolerances (tests/test_packet.py:
92-96: t rtol 1e-5 atol 1e-6, u/v rtol 1e-4 atol 1e-5; XLA may contract
float ops into FMAs, the port never does). Against the port's packet twin
closest-hit tri/t/u/v are bit-equal (culling is conservative, the (t, id)
fold order-free). Any hit: tri >= 0 equal to brute_force_anyhit (which
triangle blocks depends on the packet). Rendered frames: hit ids exactly
equal to the JAX renderer's, images within atol 1e-6. Kernel against twin
on a card: bit-equal, any-hit tri too.
"""

import numpy as np
import pytest
import torch

from ntrace_tpu.bvh.flatten import flatten_bvh
from ntrace_tpu.bvh.golden import brute_force_anyhit, brute_force_mt
from ntrace_tpu.bvh.median import build_median_bvh
from ntrace_tpu.bvh.packed import pack_bvh
from ntrace_tpu.bvh.sbvh import build_sbvh
from ntrace_tpu.bvh.wide_packed import pack_wide_bvh
from ntrace_tpu.core import BuildConfig, RenderConfig
from ntrace_tpu.render.renderer import Renderer as JaxRenderer
from ntrace_tpu.scenes import default_camera
from ntrace_tpu.trace.packet_wide import trace_packet_wide as jax_wide
from ntrace_tpu_torch.render.renderer import Renderer
from ntrace_tpu_torch.tables import (WideTables, tables_from_packed,
                                     tables_from_wide)
from ntrace_tpu_torch.trace import packet_wide
from ntrace_tpu_torch.trace.packet import trace_packet_ref
from ntrace_tpu_torch.trace.packet_pipe import trace_packet_pipe
from ntrace_tpu_torch.trace.packet_wide import (trace_packet_wide,
                                                trace_packet_wide_ref)

from conftest import random_rays

CONFIGS = {"small-median": ("soup_small", "median"),
           "medium-sah": ("soup_medium", "binned_sah")}
EXACT = [False, True]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins run many small torch ops; with the suite's test workers
    sharing the cores, one intra-op thread per worker avoids
    oversubscribing them. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(scene, builder, **kw):
    cfg = BuildConfig(builder=builder, **kw)
    build = build_median_bvh if builder == "median" else build_sbvh
    return flatten_bvh(build(scene, cfg), scene)


def _torch(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _assert_bit_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.fixture(scope="module")
def setups(request):
    """Per configuration: scene, flat tree, the JAX wide pack, the port's
    wide and packed tables, 700 rays (not a packet multiple) and the JAX
    kernel's closest hits in both exact modes (one interpret-mode call
    each: they dominate this file's time)."""
    out = {}
    for name, (fixture, builder) in CONFIGS.items():
        scene = request.getfixturevalue(fixture)
        flat = _flat(scene, builder)
        wp = pack_wide_bvh(flat, scene.tri_verts(), tris_per_row=4)
        rays = random_rays(np.random.default_rng(1234), 700)
        jax_out = {exact: [np.asarray(a) for a in jax_wide(
            wp.nodes_w, wp.tris12, *rays, rows=8, interleave=2,
            interpret=True, tris_per_row=4, exact=exact)]
            for exact in EXACT}
        packed = tables_from_packed(pack_bvh(flat, scene.tri_verts(),
                                             tris_per_row=4,
                                             nodes_per_row=1), "cpu")
        out[name] = (scene, flat, tables_from_wide(wp, "cpu"), packed, rays,
                     jax_out)
    return out


@pytest.mark.parametrize("exact", EXACT)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_twin_matches_jax_and_oracles(setups, config, exact):
    scene, _, tables, packed, rays, jax_out = setups[config][:6]
    orig, dirn, tmin, tmax = rays
    got = trace_packet_wide(tables, *_torch(*rays), exact=exact)
    _assert_bit_equal(got, trace_packet_ref(packed, *_torch(*rays)))
    ref = brute_force_mt(scene, orig, dirn, tmin, tmax)
    np.testing.assert_array_equal(got[0].numpy(), ref.tri)
    hit = ref.tri >= 0
    assert 0.1 < hit.mean() and (~hit).any()
    want = jax_out[exact]
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    for a, b, rtol, atol in zip(got[1:], want[1:], (1e-5, 1e-4, 1e-4),
                                (1e-6, 1e-5, 1e-5)):
        np.testing.assert_allclose(a.numpy()[hit], b[hit], rtol=rtol,
                                   atol=atol)
    # The miss record: t = tmax (below the 1e36 clamp here), u = v = 0.
    np.testing.assert_array_equal(got[1].numpy()[~hit], tmax[~hit])
    assert not got[2].numpy()[~hit].any() and not got[3].numpy()[~hit].any()


@pytest.mark.parametrize("exact", EXACT)
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_any_hit_matches_brute_force(setups, config, exact):
    scene, _, tables, _, rays, _ = setups[config]
    orig, dirn, tmin, _ = rays
    short = np.full_like(tmin, 14.0)       # finite segments: some blocked
    tri = trace_packet_wide(tables, *_torch(orig, dirn, tmin, short),
                            any_hit=True, exact=exact)[0].numpy()
    blocked = brute_force_anyhit(scene, orig, dirn, tmin, short)
    assert 0.1 < blocked.mean() < 0.95
    np.testing.assert_array_equal(tri >= 0, blocked)


@pytest.mark.parametrize("exact", EXACT)
def test_dead_rays_stay_dead(setups, exact):
    _, _, tables, _, rays, _ = setups["small-median"]
    orig, dirn, tmin, tmax = (a[:96].copy() for a in rays)
    tmax[::2] = tmin[::2]           # dead: tmax <= tmin
    tmax[1::4] = -1.0
    dead = tmax <= tmin
    for any_hit in (False, True):
        tri, t, u, v = trace_packet_wide(
            tables, *_torch(orig, dirn, tmin, tmax), any_hit=any_hit,
            exact=exact)
        assert (tri.numpy()[dead] == -1).all()
        np.testing.assert_array_equal(t.numpy()[dead], tmax[dead])
        assert not u.numpy()[dead].any() and not v.numpy()[dead].any()
        assert (tri.numpy()[~dead] >= 0).any()


def test_tmax_is_clamped_at_1e36(setups):
    """tmax is clamped to 1e36 at entry (packet_wide.py:407): a miss with
    an infinite tmax reports t = 1e36, and a hit beyond 1e36 is a miss."""
    scene, _, tables, _, rays, _ = setups["small-median"]
    orig, dirn, tmin, _ = (a[:64] for a in rays)
    inf = np.full_like(tmin, np.inf)
    tri, t, _, _ = trace_packet_wide(tables, *_torch(orig, dirn, tmin, inf))
    miss = tri.numpy() < 0
    assert miss.any() and (~miss).any()
    np.testing.assert_array_equal(t.numpy()[miss], np.float32(1e36))
    # Rays along +z from z = -2e36 at a triangle's centroid: brute force
    # finds the hit at t ~ 2e36, the wide engine reports a miss.
    cent = scene.tri_verts()[:32].mean(axis=1)
    far = cent.astype(np.float32).copy()
    far[:, 2] = np.float32(-2e36)
    d = np.tile(np.float32([0, 0, 1]), (32, 1))
    tn, tx = np.zeros(32, np.float32), np.full(32, np.inf, np.float32)
    bf = brute_force_mt(scene, far, d, tn, tx)
    assert (bf.tri >= 0).all() and (bf.t > 1e36).all()
    tri, t, _, _ = trace_packet_wide(tables, *_torch(far, d, tn, tx))
    assert (tri.numpy() == -1).all()
    np.testing.assert_array_equal(t.numpy(), np.float32(1e36))


def test_any_hit_depends_only_on_its_packet(setups):
    """A packet is 32 consecutive rays: moving whole packets around leaves
    every ray's any-hit result as it was."""
    _, _, tables, _, rays, _ = setups["small-median"]
    orig, dirn, tmin, _ = (a[:32 * 12] for a in rays)
    rays_t = _torch(orig, dirn, tmin, np.full_like(tmin, 14.0))
    base = trace_packet_wide_ref(tables, *rays_t, any_hit=True)
    perm = torch.randperm(12, generator=torch.Generator().manual_seed(3))
    order = (perm[:, None] * 32 + torch.arange(32)).reshape(-1)
    moved = trace_packet_wide_ref(tables, *(a[order] for a in rays_t),
                                  any_hit=True)
    _assert_bit_equal(moved, [a[order] for a in base])


def test_twin_counts_its_work(setups):
    """work= counts packet node visits and slot tests without changing a
    result; a packet pointing away from the scene visits the root alone."""
    _, _, tables, _, rays, _ = setups["small-median"]
    rays_t = _torch(*(a[:300] for a in rays))
    work = {}
    _assert_bit_equal(trace_packet_wide_ref(tables, *rays_t, work=work),
                      trace_packet_wide_ref(tables, *rays_t))
    assert work["node_visits"] >= 10 and work["tri_slot_tests"] > 0
    assert work["tri_slot_tests"] % tables.tris_per_row == 0
    away = {}
    trace_packet_wide_ref(tables, *_torch(
        np.tile(np.float32([0, 0, 50]), (32, 1)),
        np.tile(np.float32([0, 0, 1]), (32, 1)), np.zeros(32, np.float32),
        np.full(32, 1e9, np.float32)), work=away)
    assert away == {"node_visits": 1, "tri_slot_tests": 0}


def _hemisphere_packets(scene, n_packets, seed, spread=0.5):
    """AO-like packets from a seeded numpy generator: per packet, 32 rays
    from origins spread +-`spread` around a random triangle's centroid,
    with cosine-weighted directions about that triangle's normal (a
    hemisphere spans both signs on every axis but at most one, so most
    packets have no sign-consistent axis). Returns orig, dirn (R, 3)."""
    g = np.random.default_rng(seed)
    tv = scene.tri_verts().astype(np.float64)
    pick = g.integers(0, tv.shape[0], n_packets)
    cen = tv[pick].mean(axis=1)
    nrm = np.cross(tv[pick, 1] - tv[pick, 0], tv[pick, 2] - tv[pick, 0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    orig = (cen[:, None] + g.uniform(-spread, spread, (n_packets, 32, 3))
            + 1e-3 * nrm[:, None])
    u1, u2 = g.uniform(size=(2, n_packets, 32))
    r, phi = np.sqrt(u1), 2.0 * np.pi * u2
    helper = np.where(np.abs(nrm[:, :1]) > 0.9, [[0.0, 1.0, 0.0]],
                      [[1.0, 0.0, 0.0]])
    b1 = np.cross(nrm, helper)
    b1 /= np.linalg.norm(b1, axis=1, keepdims=True)
    b2 = np.cross(nrm, b1)
    d = ((r * np.cos(phi))[..., None] * b1[:, None]
         + (r * np.sin(phi))[..., None] * b2[:, None]
         + np.sqrt(1.0 - u1)[..., None] * nrm[:, None])
    d /= np.linalg.norm(d, axis=2, keepdims=True)
    return (orig.reshape(-1, 3).astype(np.float32),
            d.reshape(-1, 3).astype(np.float32))


@pytest.mark.parametrize("any_hit", [False, True])
def test_node_verdict_is_frustum_and_vote(setups, any_hit):
    """The node step's verdict on random packets against random node rows
    of soup_medium's wide tables: exact=False's is frustum_hits & the
    per-ray vote, and a subset of exact=True's (which is the vote alone).
    Both are conservative: a child that a live ray truly enters before its
    running hit (float64, with a margin for rounding) is always visited.
    Half the packets are coherent (a narrow cone from a small origin
    box), half hemispheres, most of which have no sign-consistent axis
    (degenerate)."""
    scene, _, tables, _, _, _ = setups["medium-sah"]
    g = np.random.default_rng(77)
    base = g.uniform(-12.0, 12.0, (16, 1, 3))
    aim = g.uniform(-4.0, 4.0, (16, 1, 3)) - base
    aim /= np.linalg.norm(aim, axis=2, keepdims=True)
    co = base + g.uniform(-0.2, 0.2, (16, 32, 3))
    cd = aim + g.normal(scale=0.02, size=(16, 32, 3))
    cd /= np.linalg.norm(cd, axis=2, keepdims=True)
    ho, hd = _hemisphere_packets(scene, 16, seed=5)
    orig = np.concatenate([co.reshape(-1, 3), ho]).astype(np.float32)
    dirn = np.concatenate([cd.reshape(-1, 3), hd]).astype(np.float32)
    n = orig.shape[0]
    tmin = np.zeros(n, np.float32)
    tmax = g.uniform(0.5, 30.0, n).astype(np.float32)
    tmax[g.uniform(size=n) < 0.1] = 0.0            # dead rays
    s = packet_wide._Packets(*_torch(orig, dirn, tmin, tmax))
    F = packet_wide.packet_frustum(s.o, s.d, s.tn, s.present)
    degen = F["degen"].numpy()
    assert degen[16:].mean() > 0.25 and not degen[:16].any()
    p = torch.arange(s.P)
    s.refresh_ptmax(p)
    nodes = tables.nodes_w[:tables.num_nodes]
    for _ in range(8):
        row = nodes[torch.from_numpy(g.integers(0, nodes.shape[0], s.P))]
        loose = packet_wide.node_hits(s, F, p, row, False, any_hit)
        tight = packet_wide.node_hits(s, F, p, row, True, any_hit)
        vote = packet_wide.ray_votes(s, p, row, any_hit)
        assert torch.equal(tight, vote)
        assert torch.equal(loose, packet_wide.frustum_hits(F, p, row,
                                                           s.ptmax) & vote)
        assert not (loose & ~tight).any()
        # Conservative: exact entry/exit in float64 of every live ray.
        b = row.view(-1, 8, 16)[..., :6].double().numpy()
        o = s.o.double().numpy()[:, :, None]
        inv = 1.0 / s.d.double().numpy()[:, :, None]
        t_lo = (b[:, None, :, 0::2] - o) * inv
        t_hi = (b[:, None, :, 1::2] - o) * inv
        enter = np.maximum(np.minimum(t_lo, t_hi).max(-1), 0.0)
        leave = np.minimum(np.maximum(t_lo, t_hi).min(-1),
                           s.ht.double().numpy()[:, :, None])
        live = s.live.numpy()[:, :, None]
        truly = (live & (leave - enter > 1e-3 * (1.0 + np.abs(leave)))
                 ).any(1)
        assert truly.any() and (~truly).any()
        assert not (truly & ~loose.numpy()).any()
        # On a degenerate packet the frustum's planes pass every child.
        assert torch.equal(loose[F["degen"]], tight[F["degen"]])


def test_ao_packet_work_at_most_exact(soup_medium):
    """On AO-like packets (spread origins, cosine-hemisphere directions)
    exact=False, the renderer's choice, does no more work than exact=True:
    the frustum alone culls nothing there, and the per-ray vote under it
    is exact=True's test. Hits are exact either way."""
    flat = _flat(soup_medium, "binned_sah")
    tables = tables_from_wide(pack_wide_bvh(flat, soup_medium.tri_verts(),
                                            tris_per_row=4), "cpu")
    orig, dirn = _hemisphere_packets(soup_medium, 48, seed=9)
    n = orig.shape[0]
    tmin = np.full(n, 1e-4, np.float32)
    for any_hit, t1 in ((True, 2.0), (False, 1e9)):
        tmax = np.full(n, t1, np.float32)
        work, out = {}, {}
        for exact in EXACT:
            work[exact] = {}
            out[exact] = trace_packet_wide_ref(
                tables, *_torch(orig, dirn, tmin, tmax), any_hit=any_hit,
                exact=exact, work=work[exact])
        for key in ("node_visits", "tri_slot_tests"):
            assert work[False][key] <= work[True][key], (any_hit, key, work)
        if any_hit:
            blocked = brute_force_anyhit(soup_medium, orig, dirn, tmin, tmax)
            assert 0.05 < blocked.mean() < 0.95
            for exact in EXACT:
                np.testing.assert_array_equal(out[exact][0].numpy() >= 0,
                                              blocked)
        else:
            _assert_bit_equal(out[False], out[True])
            np.testing.assert_array_equal(
                out[False][0].numpy(),
                brute_force_mt(soup_medium, orig, dirn, tmin, tmax).tri)


def test_wide_tables_refuse_their_limits(soup_small):
    """The float leaf item is exact below 2**19 triangle rows and holds at
    most 32 rows of a leaf: tables past either are refused."""
    fat = _flat(soup_small, "median", max_leaf_size=600)
    wp = pack_wide_bvh(fat, soup_small.tri_verts(), tris_per_row=4)
    with pytest.raises(ValueError, match="at most 32"):
        tables_from_wide(wp, "cpu")
    ok = tables_from_wide(pack_wide_bvh(_flat(soup_small, "median"),
                                        soup_small.tri_verts(),
                                        tris_per_row=4), "cpu")
    assert 0 < ok.max_leaf_rows <= 32
    with pytest.raises(ValueError, match=r"2\*\*19"):
        WideTables(nodes_w=ok.nodes_w,
                   tris12=torch.zeros(1, 128).expand(2 ** 19, 128),
                   tris_per_row=4, num_nodes=ok.num_nodes)


def test_cuda_input_never_reaches_twin(setups, monkeypatch):
    """A tensor the device policy routes to the kernel launches it (or
    raises): the twin is never called. CUDA is mocked where absent."""
    _, _, tables, _, rays, _ = setups["small-median"]
    rays_t = _torch(*(a[:16] for a in rays))
    launched = []

    def no_twin(*a, **k):
        raise AssertionError("a kernel-routed tensor reached the twin")

    monkeypatch.setattr(packet_wide, "trace_packet_wide_ref", no_twin)
    monkeypatch.setattr(packet_wide, "uses_kernel", lambda t: True)
    monkeypatch.setattr(packet_wide, "_launch",
                        lambda *a: launched.append(a[5:7]))
    before = trace_packet_wide.launches
    out = trace_packet_wide(tables, *rays_t, any_hit=True, exact=True)
    assert launched == [(True, True)]
    assert trace_packet_wide.launches == before + 1
    assert [o.shape for o in out] == [(16,)] * 4

    def failing(*a):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(packet_wide, "_launch", failing)
    with pytest.raises(RuntimeError):
        trace_packet_wide(tables, *rays_t)
    assert trace_packet_wide.launches == before + 1


@pytest.fixture(scope="module")
def soup_frames(soup_small):
    """The JAX renderer's frames of soup_small at 32x24, samples=1, one per
    engine and mode (the Pallas kernels interpreted)."""
    flat = _flat(soup_small, "binned_sah")
    cam = default_camera("soup")
    out = {}
    for engine in ("packet_wide", "packet_pipe"):
        for mode in ("shadow", "diffuse"):
            cfg = RenderConfig(width=32, height=24, mode=mode, samples=1,
                               engine=engine)
            out[engine, mode] = JaxRenderer(
                soup_small, BuildConfig(builder="binned_sah"), cfg,
                flat=flat).render(cam)
    return flat, cam, out


@pytest.mark.parametrize("mode", ["shadow", "diffuse"])
@pytest.mark.parametrize("engine", ["packet_wide", "packet_pipe"])
def test_render_matches_jax(soup_small, soup_frames, engine, mode):
    """render() through either engine: the primary hits and the frame of a
    mode with an any-hit pass (shadow) and one with a closest-hit pass
    (diffuse) equal the JAX renderer's on the same scene, tree and camera."""
    flat, cam, frames = soup_frames
    cfg = RenderConfig(width=32, height=24, mode=mode, samples=1,
                       engine=engine)
    r = Renderer(soup_small, BuildConfig(builder="binned_sah"), cfg,
                 flat=flat, device="cpu")
    assert r.engine == engine
    got, ref = r.render(cam), frames[engine, mode]
    np.testing.assert_array_equal(got.hit_tri, ref.hit_tri)
    assert (got.hit_tri >= 0).mean() > 0.1
    np.testing.assert_allclose(got.image, ref.image, rtol=0, atol=1e-6)
    assert np.isfinite(got.image).all() and got.image.max() > 0


@pytest.mark.parametrize("engine", ["packet_wide", "packet_pipe"])
def test_engines_render_every_mode(soup_small, engine):
    """Every mode render() has goes through both engines, each pass one
    twin call on the CPU, with images equal to the packet engine's."""
    flat = _flat(soup_small, "binned_sah")
    cam = default_camera("soup")
    for mode in ("primary", "ao", "path"):
        imgs = {}
        for e in (engine, "packet"):
            cfg = RenderConfig(width=16, height=12, mode=mode, samples=2,
                               engine=e)
            imgs[e] = Renderer(soup_small, BuildConfig(builder="binned_sah"),
                               cfg, flat=flat, device="cpu").render(cam)
        np.testing.assert_array_equal(imgs[engine].hit_tri,
                                      imgs["packet"].hit_tri)
        # AO shades by tri >= 0 alone, and that is exact in any engine.
        np.testing.assert_array_equal(imgs[engine].image,
                                      imgs["packet"].image)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", EXACT)
def test_kernel_matches_twin_on_cuda(soup_medium, rng, exact):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    flat = _flat(soup_medium, "binned_sah")
    wp = pack_wide_bvh(flat, soup_medium.tri_verts(), tris_per_row=4)
    tables = tables_from_wide(wp, "cuda")
    orig, dirn, tmin, tmax = random_rays(rng, 4099)
    rays = _torch(orig, dirn, tmin, tmax, device="cuda")
    before = trace_packet_wide.launches
    kern = trace_packet_wide(tables, *rays, exact=exact)
    torch.cuda.synchronize()
    assert trace_packet_wide.launches == before + 1
    _assert_bit_equal(kern, trace_packet_wide_ref(tables, *rays,
                                                  exact=exact))
    ref = brute_force_mt(soup_medium, orig, dirn, tmin, tmax)
    np.testing.assert_array_equal(kern[0].cpu().numpy(), ref.tri)
    shadow = rays[:3] + [torch.full_like(rays[3], 14.0)]
    _assert_bit_equal(
        trace_packet_wide(tables, *shadow, any_hit=True, exact=exact),
        trace_packet_wide_ref(tables, *shadow, any_hit=True, exact=exact))
    pipe = trace_packet_pipe(tables_from_packed(
        pack_bvh(flat, soup_medium.tri_verts(), tris_per_row=4,
                 nodes_per_row=1), "cuda"), *rays)
    _assert_bit_equal(kern, pipe)
