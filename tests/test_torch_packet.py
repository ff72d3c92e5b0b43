"""Port packet traversal (torch twin on the CPU, CUDA kernel on a card)
against the JAX Pallas kernel (interpret mode) and the brute-force oracle.

Tolerances: hit ids exactly equal everywhere. Against brute_force_mt (the
same Moller-Trumbore op order) t/u/v are compared with the reference's own
packet-test tolerances (tests/test_packet.py:92-96: t rtol 1e-5 atol 1e-6,
u/v rtol 1e-4 atol 1e-5), and against the JAX kernel likewise (XLA may
contract or reorder float ops). Kernel against twin on a card: tri exact,
t/u/v bit-equal (same op order, nvcc --fmad=false).
"""

import numpy as np
import pytest
import torch

from ntrace_tpu.bvh.flatten import flatten_bvh
from ntrace_tpu.bvh.golden import brute_force_anyhit, brute_force_mt
from ntrace_tpu.bvh.packed import pack_bvh
from ntrace_tpu.bvh.sbvh import build_sbvh
from ntrace_tpu.core import BuildConfig
from ntrace_tpu.trace.packet_pallas import trace_packet as jax_trace_packet
from ntrace_tpu_torch import device as port_device
from ntrace_tpu_torch.kernels import build as kbuild
from ntrace_tpu_torch.tables import tables_from_packed
from ntrace_tpu_torch.trace import packet
from ntrace_tpu_torch.trace.packet import trace_packet, trace_packet_ref

from conftest import random_rays

LAYOUTS = [(12, 8), (12, 1), (4, 8), (4, 1)]


def _flat(scene):
    return flatten_bvh(build_sbvh(scene, BuildConfig(builder="binned_sah")),
                       scene)


def _torch(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _assert_close(got, ref, hit):
    t, u, v = (np.asarray(a) for a in got[1:])
    np.testing.assert_allclose(t[hit], ref.t[hit], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(u[hit], ref.u[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v[hit], ref.v[hit], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("tpr,npr", LAYOUTS)
def test_twin_matches_jax_and_brute_force(soup_small, rng, tpr, npr):
    flat = _flat(soup_small)
    packed = pack_bvh(flat, soup_small.tri_verts(), tris_per_row=tpr,
                      nodes_per_row=npr)
    orig, dirn, tmin, tmax = random_rays(rng, 700)  # not a packet multiple
    tables = tables_from_packed(packed, "cpu")
    got = [a.numpy() for a in trace_packet(tables, *_torch(orig, dirn, tmin,
                                                           tmax))]
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    ref = brute_force_mt(soup_small, orig, dirn, tmin, tmax)
    np.testing.assert_array_equal(got[0], ref.tri)
    hit = ref.tri >= 0
    assert 0.1 < hit.mean() < 0.9
    _assert_close(got, ref, hit)
    jax_out = jax_trace_packet(packed.nodes8, packed.tris12, orig, dirn,
                               tmin, tmax, interpret=True, tris_per_row=tpr,
                               nodes_per_row=npr)
    np.testing.assert_array_equal(got[0], np.asarray(jax_out[0]))
    jax_rec = type(ref)(*(np.asarray(a) for a in jax_out))
    _assert_close(got, jax_rec, hit)
    # The miss convention of the reference: t = tmax, u = v = 0.
    np.testing.assert_array_equal(got[1][~hit], tmax[~hit])
    assert not got[2][~hit].any() and not got[3][~hit].any()


@pytest.mark.parametrize("tpr,npr", [(12, 8), (4, 1)])
def test_twin_anyhit_matches_brute_force(soup_medium, rng, tpr, npr):
    flat = _flat(soup_medium)
    packed = pack_bvh(flat, soup_medium.tri_verts(), tris_per_row=tpr,
                      nodes_per_row=npr)
    orig, dirn, tmin, tmax = random_rays(rng, 1024)
    tmax = np.full_like(tmax, 14.0)  # finite segments: some blocked
    tri, *_ = trace_packet(tables_from_packed(packed, "cpu"),
                           *_torch(orig, dirn, tmin, tmax), any_hit=True)
    blocked = brute_force_anyhit(soup_medium, orig, dirn, tmin, tmax)
    assert 0.1 < blocked.mean() < 0.95
    np.testing.assert_array_equal(tri.numpy() >= 0, blocked)


def test_twin_counts_its_work(soup_small, rng):
    """work= counts node visits and slot tests without changing a result:
    the counts add up over disjoint ray sets, and a ray pointing away from
    the scene visits the root alone."""
    tables = tables_from_packed(pack_bvh(_flat(soup_small),
                                         soup_small.tri_verts()), "cpu")
    rays = _torch(*random_rays(rng, 300))
    plain = trace_packet_ref(tables, *rays)
    work, halves = {}, [{}, {}]
    counted = trace_packet_ref(tables, *rays, work=work)
    for a, b in zip(plain, counted):
        assert torch.equal(a, b)
    for w, sl in zip(halves, (slice(0, 120), slice(120, 300))):
        trace_packet_ref(tables, *(a[sl] for a in rays), work=w)
    assert work == {k: halves[0][k] + halves[1][k] for k in work}
    assert work["node_visits"] > 300 and work["tri_slot_tests"] > 0
    assert work["tri_slot_tests"] % tables.tris_per_row == 0
    away = {}
    trace_packet_ref(tables, *_torch(np.array([[0, 0, 50]], np.float32),
                                     np.array([[0, 0, 1]], np.float32),
                                     np.zeros(1, np.float32),
                                     np.full(1, 1e9, np.float32)), work=away)
    assert away == {"node_visits": 1, "tri_slot_tests": 0}


def test_twin_dead_rays_keep_miss_record(soup_small, rng):
    packed = pack_bvh(_flat(soup_small), soup_small.tri_verts())
    orig, dirn, tmin, tmax = random_rays(rng, 64)
    tmax[::2] = tmin[::2]          # dead: tmax <= tmin
    tri, t, u, v = trace_packet(tables_from_packed(packed, "cpu"),
                                *_torch(orig, dirn, tmin, tmax))
    assert (tri.numpy()[::2] == -1).all()
    np.testing.assert_array_equal(t.numpy()[::2], tmax[::2])


@pytest.mark.parametrize("tpr,npr", LAYOUTS)
def test_tables_from_packed_keeps_layout(soup_small, tpr, npr):
    packed = pack_bvh(_flat(soup_small), soup_small.tri_verts(),
                      tris_per_row=tpr, nodes_per_row=npr)
    tables = tables_from_packed(packed, "cpu")
    assert (tables.tris_per_row, tables.nodes_per_row) == (tpr, npr)
    assert tables.num_nodes == packed.num_nodes
    for t, a in ((tables.nodes8, packed.nodes8),
                 (tables.tris12, packed.tris12)):
        assert t.dtype == torch.float32 and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), a)
    assert tables.nbytes() == packed.nbytes()


@pytest.mark.parametrize("what", ["node count", "child link", "leaf row",
                                  "triangle id"])
def test_tables_refuse_float_ids_past_2_24(soup_small, what):
    """Child links, leaf first rows and triangle ids are stored as floats,
    exact below 2**24: a small pack faked past that limit is refused, and
    the same pack one below it is taken."""
    from ntrace_tpu_torch.host.bvh.packed import PackedBVH

    packed = pack_bvh(_flat(soup_small), soup_small.tri_verts(),
                      tris_per_row=12, nodes_per_row=1)

    def faked(v):
        nodes, tris = packed.nodes8.copy(), packed.tris12.copy()
        num_nodes = packed.num_nodes
        if what == "node count":     # claimed, not stored
            num_nodes = v
        elif what == "child link":
            nodes[0, 12] = v                     # an internal child
        elif what == "leaf row":
            nodes[0, 13] = -v - 1                # a leaf's first row
        else:
            tris[0, 9] = v
        return PackedBVH(nodes, tris, num_nodes, packed.num_tris, 1, 12)

    limit = 2 ** 24
    if what == "node count":    # 2**24 - 1 stored nodes would take 8 GB
        with pytest.raises(ValueError, match="2\\*\\*24"):
            tables_from_packed(faked(limit), "cpu")
        return
    # A leaf row r is stored as -(r + 1): r = 2**24 - 1 already needs
    # 2**24 in the float.
    top = limit - 1 if what == "leaf row" else limit
    tables_from_packed(faked(top - 1), "cpu")
    with pytest.raises(ValueError, match="2\\*\\*24"):
        tables_from_packed(faked(top), "cpu")


def test_wrapper_rejects_bad_inputs(soup_small, rng):
    tables = tables_from_packed(
        pack_bvh(_flat(soup_small), soup_small.tri_verts()), "cpu")
    orig, dirn, tmin, tmax = _torch(*random_rays(rng, 8))
    with pytest.raises(TypeError):
        trace_packet(tables, orig.double(), dirn, tmin, tmax)
    with pytest.raises(ValueError):
        trace_packet(tables, orig[:, :2], dirn, tmin, tmax)
    with pytest.raises(ValueError):
        trace_packet(tables, orig, dirn, tmin[:4], tmax)


def test_no_third_device_path():
    with pytest.raises(ValueError):
        port_device.uses_kernel(torch.empty(3, device="meta"))
    assert port_device.uses_kernel(torch.empty(3)) is False


def test_cuda_input_never_reaches_twin(soup_small, rng, monkeypatch):
    """A tensor the device policy routes to the kernel must launch it (or
    raise): the twin is never called. CUDA is mocked where absent."""
    tables = tables_from_packed(
        pack_bvh(_flat(soup_small), soup_small.tri_verts()), "cpu")
    rays = _torch(*random_rays(rng, 16))
    launched = []

    def twin(*a, **k):
        raise AssertionError("a kernel-routed tensor reached the twin")

    monkeypatch.setattr(packet, "trace_packet_ref", twin)
    monkeypatch.setattr(packet, "uses_kernel", lambda t: True)
    monkeypatch.setattr(packet, "_launch",
                        lambda *a: launched.append(a[5]))
    before = trace_packet.launches
    out = trace_packet(tables, *rays, any_hit=True)
    assert launched == [True] and trace_packet.launches == before + 1
    assert [o.shape for o in out] == [(16,)] * 4

    def failing_launch(*a):
        raise RuntimeError("ntrace_packet_trace launch failed")

    monkeypatch.setattr(packet, "_launch", failing_launch)
    with pytest.raises(RuntimeError):
        trace_packet(tables, *rays)
    assert trace_packet.launches == before + 1


def test_library_path_keyed_by_sources():
    path = kbuild.library_path()
    assert path.parent == kbuild.BUILD_DIR
    assert path == kbuild.library_path()
    assert [p.name for p in kbuild.sources()] == ["binraster_trace.cu",
                                                  "child_boxes.cu",
                                                  "dense_trace.cu",
                                                  "dense_visits.cu",
                                                  "gather.cu",
                                                  "packet_bdl.cu",
                                                  "packet_bfs.cu",
                                                  "packet_dleaf.cu",
                                                  "packet_ifif.cu",
                                                  "packet_pipe.cu",
                                                  "packet_trace.cu",
                                                  "packet_wide.cu",
                                                  "packet_ww.cu",
                                                  "row_scan.cu",
                                                  "secondary_rays.cu"]
    assert "--fmad=false" in kbuild.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in kbuild.NVCC_FLAGS
    assert "--use_fast_math" not in kbuild.NVCC_FLAGS


@pytest.mark.cuda
@pytest.mark.parametrize("tpr,npr", [(12, 1), (4, 8)])
def test_kernel_matches_twin_on_cuda(soup_medium, rng, tpr, npr):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    packed = pack_bvh(_flat(soup_medium), soup_medium.tri_verts(),
                      tris_per_row=tpr, nodes_per_row=npr)
    tables = tables_from_packed(packed, "cuda")
    orig, dirn, tmin, tmax = random_rays(rng, 4099)
    rays = _torch(orig, dirn, tmin, tmax, device="cuda")
    before = trace_packet.launches
    kern = trace_packet(tables, *rays)
    torch.cuda.synchronize()
    assert trace_packet.launches == before + 1
    twin = trace_packet_ref(tables, *rays)
    assert torch.equal(kern[0], twin[0])
    for a, b in zip(kern[1:], twin[1:]):
        assert torch.equal(a, b)
    ref = brute_force_mt(soup_medium, orig, dirn, tmin, tmax)
    np.testing.assert_array_equal(kern[0].cpu().numpy(), ref.tri)
    shadow = rays[:3] + [torch.full_like(rays[3], 14.0)]
    ka = trace_packet(tables, *shadow, any_hit=True)
    ta = trace_packet_ref(tables, *shadow, any_hit=True)
    assert torch.equal(ka[0] >= 0, ta[0] >= 0)
