"""The packet kernel and packet_ifif as redesigned for Hopper (csrc/
packet_trace.cu, csrc/packet_ifif.cu), through their torch twins on the
CPU and their kernels on a card: an any-hit ray stops at the first leaf
row that accepts a hit; a closest-hit pop skips every entry whose box the
slab test would now fail, by the entry distance pushed with it. The
packet kernel still traces tables whose leaves span more than 32 rows.

Scene: get_scene("conference", n_tris=5000) (10,320 triangles), binned
SAH (sah_tri_cost 0.02, max_leaf_size 48); rays: the primary, diffuse,
AO and shadow passes of render() at 32x32, one sample a pixel (1,024 rays
a pass), as in tests/test_torch_while_while.py.

Tolerances: hit ids exactly equal everywhere. Against the JAX kernels
(interpret mode) t/u/v within tests/test_torch_packet_variants.py's
tolerances (the reference's tests/test_packet.py:92-96: t rtol 1e-5 atol
1e-6, u/v rtol 1e-4 atol 1e-5; XLA may contract float ops into FMAs, the
port never does) on primary rays; on diffuse rays the ids, and tri/t/u/v
bit-equal to brute_force_mt. Closest hits bit-equal to trace_packet_ref's.
Any hit: tri >= 0 equal (which triangle blocks follows the schedule).
Work: the twins' any-hit slot tests at most 1.05x packet_ww's twin's,
the packet twin's closest-hit slot tests at most packet_ww's. Kernel
against twin on a card: bit-equal, any-hit tri included.
"""

import numpy as np
import pytest
import torch

from ntrace_tpu_torch.host import (BuildConfig, RenderConfig,
                                   brute_force_anyhit, brute_force_mt,
                                   build_median_bvh, build_sbvh,
                                   default_camera, flatten_bvh, get_scene,
                                   make_random_soup, pack_bvh)
from ntrace_tpu_torch.render.renderer import Renderer
from ntrace_tpu_torch.tables import tables_from_packed
from ntrace_tpu_torch.trace.packet import trace_packet, trace_packet_ref
from ntrace_tpu_torch.trace.packet_ifif import (trace_packet_ifif,
                                                trace_packet_ifif_ref)
from ntrace_tpu_torch.trace.packet_ww import trace_packet_ww_ref

from conftest import random_rays

TWINS = {"packet": (trace_packet, trace_packet_ref),
         "ifif": (trace_packet_ifif, trace_packet_ifif_ref)}
CLOSEST = ("primary", "diffuse")
ANY = ("ao", "shadow")
ANY_HIT_WORK = 1.05     # any-hit slot tests, at most this times ww's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a test worker (the twins run many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def conference():
    """(scene, flat, passes): passes maps primary, diffuse, ao and shadow
    to (rays, any_hit) of the last pass render() traced in that mode."""
    scene = get_scene("conference", n_tris=5000)
    bc = BuildConfig(builder="binned_sah", sah_tri_cost=0.02,
                     max_leaf_size=48)
    flat = flatten_bvh(build_sbvh(scene, bc), scene)
    r = Renderer(scene, bc, RenderConfig(width=32, height=32, samples=1),
                 flat=flat, device="cpu")
    calls, passes = [], {}
    base = r.tracer.trace

    def tracer(o, d, tn, tx, any_hit):
        calls.append(((o, d, tn, tx), any_hit))
        return base(o, d, tn, tx, any_hit)

    r.tracer.trace = tracer
    for mode in ("diffuse", "ao", "shadow"):
        calls.clear()
        r.render(default_camera("conference"), mode)
        passes["primary"], passes[mode] = calls
    return scene, flat, passes


@pytest.fixture(scope="module")
def long_leaves():
    """(scene, flat): a 500-triangle soup whose median tree has leaves of
    up to 600 triangles, more than 32 rows at 4 triangles a row."""
    soup = make_random_soup(n_tris=500, seed=7)
    flat = flatten_bvh(build_median_bvh(
        soup, BuildConfig(builder="median", max_leaf_size=600)), soup)
    return soup, flat


def _tables(scene, flat, tpr=12, npr=1, device="cpu"):
    packed = pack_bvh(flat, scene.tri_verts(), tris_per_row=tpr,
                      nodes_per_row=npr)
    return packed, tables_from_packed(packed, device)


def _bit_equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("batch", ANY)
@pytest.mark.parametrize("kernel", sorted(TWINS))
@pytest.mark.parametrize("tpr,npr", [(12, 1), (4, 8)])
def test_any_hit_work_is_ww_s(conference, kernel, batch, tpr, npr):
    """Stopping at the first row that accepts a hit, the packet and ifif
    twins test at most 5% more any-hit slots than the ww twin, which stops
    so too (whole leaves made 1.09x and 1.11x here on shadow), and hold
    tri >= 0 equal to it and to brute_force_anyhit."""
    scene, flat, passes = conference
    _, tables = _tables(scene, flat, tpr, npr)
    rays, any_hit = passes[batch]
    assert any_hit
    ww_work, work = {}, {}
    ww = trace_packet_ww_ref(tables, *rays, any_hit=True, work=ww_work)
    got = TWINS[kernel][1](tables, *rays, any_hit=True, work=work)
    assert torch.equal(got[0] >= 0, ww[0] >= 0)
    host = [a.numpy() for a in rays]
    np.testing.assert_array_equal(got[0].numpy() >= 0,
                                  brute_force_anyhit(scene, *host))
    assert 0 < work["tri_slot_tests"] <= (ANY_HIT_WORK
                                          * ww_work["tri_slot_tests"])


@pytest.mark.parametrize("batch", CLOSEST)
@pytest.mark.parametrize("tpr,npr", [(12, 1), (4, 8)])
def test_packet_closest_hit_work_at_most_ww_s(conference, batch, tpr, npr):
    """Culling stale entries on pop, the packet twin tests no more
    closest-hit slots and visits no more nodes than the ww twin, and its
    count plus what the cull saved is the walk without it: within 2% of
    ww's (test_torch_while_while.py)."""
    scene, flat, passes = conference
    _, tables = _tables(scene, flat, tpr, npr)
    rays, _ = passes[batch]
    ww_work = {}
    work = {"culled_node_visits": 0, "culled_slot_tests": 0}
    ww = trace_packet_ww_ref(tables, *rays, work=ww_work)
    got = trace_packet_ref(tables, *rays, work=work)
    assert _bit_equal(got, ww)
    assert work["culled_node_visits"] > 0 and work["culled_slot_tests"] > 0
    assert work["tri_slot_tests"] <= ww_work["tri_slot_tests"]
    assert work["node_visits"] <= ww_work["node_visits"]


@pytest.mark.parametrize("batch", CLOSEST)
@pytest.mark.parametrize("kernel", sorted(TWINS))
def test_closest_hits_exact(conference, kernel, batch):
    """The cull drops only boxes the slab test would drop: closest hits
    stay bit-equal to the packet twin's and to brute_force_mt on every
    ray (tri, t, u, v)."""
    scene, flat, passes = conference
    _, tables = _tables(scene, flat)
    rays, _ = passes[batch]
    got = TWINS[kernel][1](tables, *rays)
    assert _bit_equal(got, trace_packet_ref(tables, *rays))
    bf = brute_force_mt(scene, *(a.numpy() for a in rays))
    assert (bf.tri >= 0).mean() > 0.5
    np.testing.assert_array_equal(got[0].numpy(), bf.tri)
    hit = bf.tri >= 0
    for a, b in zip(got[1:], (bf.t, bf.u, bf.v)):
        np.testing.assert_array_equal(a.numpy()[hit], b[hit])


@pytest.mark.parametrize("kernel", sorted(TWINS))
def test_twins_match_jax_on_conference(conference, kernel):
    """Against the JAX kernels in interpret mode: closest-hit ids exact on
    the primary and diffuse passes, t/u/v within tolerance on the primary
    pass; any hits of the AO and shadow passes tri >= 0 equal."""
    from ntrace_tpu.trace.packet_ifif import trace_packet_ifif as jax_ifif
    from ntrace_tpu.trace.packet_pallas import trace_packet as jax_packet

    jax_fn = {"packet": jax_packet, "ifif": jax_ifif}[kernel]
    scene, flat, passes = conference
    packed, tables = _tables(scene, flat, 12, 8)
    for batch in CLOSEST + ANY:
        rays, any_hit = passes[batch]
        host = [a.numpy() for a in rays]
        got = TWINS[kernel][0](tables, *rays, any_hit=any_hit)
        ref = [np.asarray(a) for a in jax_fn(
            packed.nodes8, packed.tris12, *host, any_hit=any_hit,
            interpret=True, tris_per_row=12, nodes_per_row=8)]
        if any_hit:
            np.testing.assert_array_equal(got[0].numpy() >= 0, ref[0] >= 0)
            assert 0.0 < (ref[0] >= 0).mean() < 1.0, batch
            continue
        np.testing.assert_array_equal(got[0].numpy(), ref[0])
        if batch == "primary":
            hit = ref[0] >= 0
            for a, b, rtol, atol in zip(got[1:], ref[1:], (1e-5, 1e-4, 1e-4),
                                        (1e-6, 1e-5, 1e-5)):
                np.testing.assert_allclose(a.numpy()[hit], b[hit], rtol=rtol,
                                           atol=atol)


@pytest.mark.parametrize("any_hit", [False, True])
def test_long_leaves_trace_exactly(long_leaves, rng, any_hit):
    """A leaf of more than 32 rows does not fit a leaf run: the
    packet twin still traces such tables exactly (closest hits bit-equal
    to brute_force_mt, any hits tri >= 0 to brute_force_anyhit), where
    ww, ifif and pipe refuse them."""
    soup, flat = long_leaves
    _, tables = _tables(soup, flat, 4, 1)
    assert tables.max_leaf_rows > 32
    orig, dirn, tmin, tmax = random_rays(rng, 700)
    if any_hit:
        tmax = np.full_like(tmax, 14.0)
    rays = [torch.from_numpy(a) for a in (orig, dirn, tmin, tmax)]
    tri, t, u, v = trace_packet(tables, *rays, any_hit=any_hit)
    if any_hit:
        blocked = brute_force_anyhit(soup, orig, dirn, tmin, tmax)
        assert 0.1 < blocked.mean() < 0.95
        np.testing.assert_array_equal(tri.numpy() >= 0, blocked)
        return
    bf = brute_force_mt(soup, orig, dirn, tmin, tmax)
    assert 0.1 < (bf.tri >= 0).mean() < 0.9
    np.testing.assert_array_equal(tri.numpy(), bf.tri)
    hit = bf.tri >= 0
    for a, b in zip((t, u, v), (bf.t, bf.u, bf.v)):
        np.testing.assert_array_equal(a.numpy()[hit], b[hit])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(TWINS))
@pytest.mark.parametrize("tpr,npr", [(12, 1), (4, 8)])
def test_kernel_matches_twin_on_cuda(conference, long_leaves, kernel, tpr,
                                     npr):
    """On a card, each kernel bit-equal to its twin on every pass of the
    conference, any-hit tri included; the packet kernel also on the
    long-leaf tables with random rays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    wrapper, twin = TWINS[kernel]
    scene, flat, passes = conference
    _, tables = _tables(scene, flat, tpr, npr, device="cuda")
    cases = [(tables, [a.cuda() for a in rays], any_hit)
             for rays, any_hit in passes.values()]
    if kernel == "packet":
        soup, fat = long_leaves
        _, long_tables = _tables(soup, fat, 4, 1, device="cuda")
        o, d, tn, tx = (torch.from_numpy(a).cuda() for a in random_rays(
            np.random.default_rng(5), 4099))
        cases += [(long_tables, [o, d, tn, tx], False),
                  (long_tables, [o, d, tn, torch.full_like(tx, 14.0)], True)]
    for tb, rays, any_hit in cases:
        before = wrapper.launches
        kern = wrapper(tb, *rays, any_hit=any_hit)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert _bit_equal(kern, twin(tb, *rays, any_hit=any_hit)), any_hit
