"""The while-while, speculative while-while and pipelined while-while
traversals of the port (torch twins on the CPU, CUDA kernels on a card)
against the JAX Pallas kernels (interpret mode), the brute-force oracles
and the packet twin.

Tolerances: hit ids exactly equal everywhere. Against the JAX kernels t/u/v
within the reference's own packet-test tolerances (tests/test_packet.py:
92-96: t rtol 1e-5 atol 1e-6, u/v rtol 1e-4 atol 1e-5; XLA may contract
float ops into FMAs, the port never does). Against the port's packet twin,
closest-hit tri/t/u/v are bit-equal: the schedules differ, the slab and
Moller-Trumbore op order and the (t, id) fold do not. Any-hit: tri >= 0
equal to brute_force_anyhit (which triangle blocks depends on the
schedule). Kernel against twin on a card: bit-equal, any-hit tri too.
"""

import numpy as np
import pytest
import torch

from ntrace_tpu.bvh.flatten import flatten_bvh
from ntrace_tpu.bvh.golden import brute_force_anyhit, brute_force_mt
from ntrace_tpu.bvh.median import build_median_bvh
from ntrace_tpu.bvh.packed import pack_bvh
from ntrace_tpu.bvh.sbvh import build_sbvh
from ntrace_tpu.core import BuildConfig, RenderConfig
from ntrace_tpu.scenes import default_camera
from ntrace_tpu.trace.packet_ifif import trace_packet_ifif as jax_ifif
from ntrace_tpu.trace.packet_pipe import trace_packet_pipe as jax_pipe
from ntrace_tpu.trace.packet_ww import trace_packet_ww as jax_ww
from ntrace_tpu_torch.render.renderer import Renderer
from ntrace_tpu_torch.tables import tables_from_packed
from ntrace_tpu_torch.trace import (packet_ifif, packet_pipe, packet_ww,
                                    registry)
from ntrace_tpu_torch.trace.packet import trace_packet_ref
from ntrace_tpu_torch.trace.packet_common import read_bytes, work_with_reads
from ntrace_tpu_torch.trace.packet_ifif import (trace_packet_ifif,
                                                trace_packet_ifif_ref)
from ntrace_tpu_torch.trace.packet_pipe import (trace_packet_pipe,
                                                trace_packet_pipe_ref)
from ntrace_tpu_torch.trace.packet_ww import (trace_packet_ww,
                                              trace_packet_ww_ref)

from conftest import random_rays

LAYOUTS = [(12, 8), (4, 1), (4, 8)]
KERNELS = {
    "ww": (packet_ww, trace_packet_ww, trace_packet_ww_ref, jax_ww),
    "ifif": (packet_ifif, trace_packet_ifif, trace_packet_ifif_ref,
             jax_ifif),
    "pipe": (packet_pipe, trace_packet_pipe, trace_packet_pipe_ref,
             jax_pipe),
}



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
    packed = pack_bvh(flat, scene.tri_verts(), tris_per_row=tpr,
                      nodes_per_row=npr)
    return packed, tables_from_packed(packed, device)


def _assert_bit_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("tpr,npr", LAYOUTS)
def test_twin_matches_jax_and_oracles(soup_small, flat_small, rng, kernel,
                                      tpr, npr):
    _, wrapper, twin, jax_fn = KERNELS[kernel]
    packed, tables = _tables(soup_small, flat_small, tpr, npr)
    orig, dirn, tmin, tmax = random_rays(rng, 700)  # not a warp multiple
    rays = _torch(orig, dirn, tmin, tmax)
    got = wrapper(tables, *rays)
    _assert_bit_equal(got, trace_packet_ref(tables, *rays))
    ref = brute_force_mt(soup_small, orig, dirn, tmin, tmax)
    np.testing.assert_array_equal(got[0].numpy(), ref.tri)
    hit = ref.tri >= 0
    assert 0.1 < hit.mean() < 0.9
    jax_out = [np.asarray(a) for a in jax_fn(
        packed.nodes8, packed.tris12, orig, dirn, tmin, tmax, interpret=True,
        tris_per_row=tpr, nodes_per_row=npr)]
    np.testing.assert_array_equal(got[0].numpy(), jax_out[0])
    for a, b, rtol, atol in zip(got[1:], jax_out[1:], (1e-5, 1e-4, 1e-4),
                                (1e-6, 1e-5, 1e-5)):
        np.testing.assert_allclose(a.numpy()[hit], b[hit], rtol=rtol,
                                   atol=atol)
    # The miss convention of the reference: t = tmax, u = v = 0.
    np.testing.assert_array_equal(got[1].numpy()[~hit], tmax[~hit])
    assert not got[2].numpy()[~hit].any() and not got[3].numpy()[~hit].any()

    short = np.full_like(tmax, 14.0)   # finite segments: some blocked
    any_tri = wrapper(tables, *_torch(orig, dirn, tmin, short),
                      any_hit=True)[0].numpy()
    blocked = brute_force_anyhit(soup_small, orig, dirn, tmin, short)
    assert 0.1 < blocked.mean() < 0.95
    np.testing.assert_array_equal(any_tri >= 0, blocked)
    jax_any = np.asarray(jax_fn(packed.nodes8, packed.tris12, orig, dirn,
                                tmin, short, any_hit=True, interpret=True,
                                tris_per_row=tpr, nodes_per_row=npr)[0])
    np.testing.assert_array_equal(any_tri >= 0, jax_any >= 0)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_dead_rays_stay_dead(soup_small, flat_small, rng, kernel):
    _, wrapper, _, _ = KERNELS[kernel]
    _, tables = _tables(soup_small, flat_small)
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


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_twin_counts_its_work(soup_small, flat_small, rng, kernel):
    """work= counts node visits and slot tests without changing a result; a
    ray pointing away from the scene visits the root alone."""
    _, _, twin, _ = KERNELS[kernel]
    _, tables = _tables(soup_small, flat_small, 4, 1)
    rays = _torch(*random_rays(rng, 300))
    work = {}
    _assert_bit_equal(twin(tables, *rays, work=work),
                      twin(tables, *rays))
    assert work["node_visits"] > 300 and work["tri_slot_tests"] > 0
    assert work["tri_slot_tests"] % tables.tris_per_row == 0
    away = {}
    twin(tables, *_torch(np.array([[0, 0, 50]], np.float32),
                         np.array([[0, 0, 1]], np.float32),
                         np.zeros(1, np.float32),
                         np.full(1, 1e9, np.float32)), work=away)
    assert away == {"node_visits": 1, "tri_slot_tests": 0}


@pytest.mark.parametrize("twin", [trace_packet_ref, trace_packet_ww_ref,
                                  trace_packet_ifif_ref,
                                  trace_packet_pipe_ref])
def test_twin_marks_what_it_reads(soup_small, flat_small, rng, twin):
    """work_with_reads marks the node records and triangle rows a twin
    reads, beside the same counts as a plain work dict; a ray pointing away
    from the scene reads the root record alone."""
    _, tables = _tables(soup_small, flat_small, 4, 8)
    rays = _torch(*random_rays(rng, 300))
    plain, reads = {}, work_with_reads(tables)
    _assert_bit_equal(twin(tables, *rays, work=reads),
                      twin(tables, *rays, work=plain))
    assert {k: reads[k] for k in plain} == plain
    n_nodes, n_rows = int(reads["nodes_read"].sum()), int(
        reads["rows_read"].sum())
    assert 1 < n_nodes <= min(plain["node_visits"], tables.num_nodes)
    assert 0 < n_rows * tables.tris_per_row <= plain["tri_slot_tests"]
    assert read_bytes(tables, reads) == 4 * (16 * n_nodes + 40 * n_rows)
    away = work_with_reads(tables)
    twin(tables, *_torch(np.array([[0, 0, 50]], np.float32),
                         np.array([[0, 0, 1]], np.float32),
                         np.zeros(1, np.float32),
                         np.full(1, 1e9, np.float32)), work=away)
    assert away["nodes_read"].nonzero().tolist() == [[0]]
    assert not away["rows_read"].any()


def test_ifif_any_hit_depends_only_on_its_warp(soup_medium, rng):
    """The speculative schedule is voted per warp of 32 consecutive rays:
    moving whole warps around leaves every ray's any-hit result as it
    was, and the twin runs each warp alike whatever else is in the batch."""
    _, tables = _tables(soup_medium, _flat(soup_medium), 4, 1)
    orig, dirn, tmin, _ = random_rays(rng, 32 * 24)
    rays = _torch(orig, dirn, tmin, np.full_like(tmin, 14.0))
    base = trace_packet_ifif_ref(tables, *rays, any_hit=True)
    perm = torch.randperm(24, generator=torch.Generator().manual_seed(3))
    order = (perm[:, None] * 32 + torch.arange(32)).reshape(-1)
    moved = trace_packet_ifif_ref(tables, *(a[order] for a in rays),
                                  any_hit=True)
    _assert_bit_equal(moved, [a[order] for a in base])


def test_leaf_runs_longer_than_32_rows_are_refused(soup_small, flat_small):
    """A leaf run holds at most 32 rows (5 bits): tables with a longer leaf
    are refused rather than traced in part."""
    fat = flatten_bvh(build_median_bvh(
        soup_small, BuildConfig(builder="median", max_leaf_size=600)),
        soup_small)
    _, tables = _tables(soup_small, fat, 4, 1)
    assert tables.max_leaf_rows > 32
    rays = _torch(*random_rays(np.random.default_rng(0), 4))
    for wrapper in (trace_packet_ww, trace_packet_ifif, trace_packet_pipe):
        with pytest.raises(ValueError, match="32"):
            wrapper(tables, *rays)
    _, ok = _tables(soup_small, flat_small, 4, 1)
    assert 0 < ok.max_leaf_rows <= 32


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_cuda_input_never_reaches_twin(soup_small, flat_small, rng,
                                       monkeypatch, kernel):
    """A tensor the device policy routes to the kernel launches it (or
    raises): the twin is never called. CUDA is mocked where absent."""
    module, wrapper, twin, _ = KERNELS[kernel]
    _, tables = _tables(soup_small, flat_small)
    rays = _torch(*random_rays(rng, 16))
    launched = []

    def no_twin(*a, **k):
        raise AssertionError("a kernel-routed tensor reached the twin")

    monkeypatch.setattr(module, twin.__name__, no_twin)
    monkeypatch.setattr(module, "uses_kernel", lambda t: True)
    monkeypatch.setattr(module, "launch_traversal",
                        lambda name, *a: launched.append((name, a[5])))
    before = wrapper.launches
    out = wrapper(tables, *rays, any_hit=True)
    assert launched == [(f"ntrace_packet_{kernel}", True)]
    assert wrapper.launches == before + 1
    assert [o.shape for o in out] == [(16,)] * 4

    def failing(*a):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(module, "launch_traversal", failing)
    with pytest.raises(RuntimeError):
        wrapper(tables, *rays)
    assert wrapper.launches == before + 1


@pytest.mark.parametrize("name,engine", [
    ("tesla_persistent_while_while", "packet_ww"),
    ("tesla_persistent_speculative_while_while", "packet_ifif"),
    ("tesla_persistent_packet", "packet_wide"),
    ("kepler_dynamic_fetch", "packet"),
])
def test_registry_resolves_reference_names(soup_small, name, engine):
    """Each reference name resolves to its engine, and render() runs
    through it (the twins on the CPU)."""
    assert registry.resolve_kernel(name).engine == engine
    assert name in registry.kernel_names()
    with pytest.raises(ValueError):
        registry.resolve_kernel("no_such_kernel")
    cfg = RenderConfig(width=8, height=8,
                       engine=registry.resolve_kernel(name).engine)
    res = Renderer(soup_small, BuildConfig(builder="binned_sah"), cfg,
                   flat=_flat(soup_small), device="cpu").render(
                       default_camera("soup"))
    assert res.image.shape == (8, 8, 3) and (res.hit_tri >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("tpr,npr", [(12, 1), (4, 8)])
def test_kernel_matches_twin_on_cuda(soup_medium, rng, kernel, tpr, npr):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    _, wrapper, twin, _ = KERNELS[kernel]
    _, tables = _tables(soup_medium, _flat(soup_medium), tpr, npr,
                        device="cuda")
    orig, dirn, tmin, tmax = random_rays(rng, 4099)
    rays = _torch(orig, dirn, tmin, tmax, device="cuda")
    before = wrapper.launches
    kern = wrapper(tables, *rays)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _assert_bit_equal(kern, twin(tables, *rays))
    ref = brute_force_mt(soup_medium, orig, dirn, tmin, tmax)
    np.testing.assert_array_equal(kern[0].cpu().numpy(), ref.tri)
    shadow = rays[:3] + [torch.full_like(rays[3], 14.0)]
    _assert_bit_equal(wrapper(tables, *shadow, any_hit=True),
                      twin(tables, *shadow, any_hit=True))
