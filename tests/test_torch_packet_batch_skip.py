"""packet_bfs's leaf rule: a warp tests the rows of the step's runs that
its own rays want, where the reference tests every run on the whole
packet; and the twin's step and drain counts.

Tolerances: none. Closest hits (tri/t/u/v) are bit-equal to the packet
twin's and tri exact against brute_force_mt; any hit tri >= 0 equal to
brute_force_anyhit. The slot tests are exact counts.
"""

import numpy as np
import pytest
import torch

from ntrace_tpu_torch.host import (BuildConfig, RenderConfig, Scene,
                                   brute_force_anyhit, brute_force_mt,
                                   build_sbvh, default_camera, flatten_bvh,
                                   get_scene, pack_bvh)
from ntrace_tpu_torch.render.renderer import Renderer
from ntrace_tpu_torch.tables import tables_from_packed
from ntrace_tpu_torch.trace import packet_batch
from ntrace_tpu_torch.trace.packet import trace_packet_ref

TWINS = {"bfs": packet_batch.BFS, "dleaf": packet_batch.DLEAF,
         "bdl": packet_batch.BDL}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a test worker (the twins run many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _bit_equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def _two_clusters():
    """Four stacked triangles at x = -5 and four at x = +5 (z 0 to 0.3):
    the binned-SAH tree is a root over two leaves of one row each at
    tris_per_row 4."""
    base = np.array([[-1.0, -1.0], [1.0, -1.0], [0.0, 1.0]], np.float32)
    pos = []
    for cx in (-5.0, 5.0):
        for k in range(4):
            pos += [[cx + x, y, 0.1 * k] for x, y in base]
    pos = np.array(pos, np.float32)
    return Scene(positions=pos, indices=np.arange(24).reshape(8, 3),
                 name="two_clusters")


def test_bfs_warp_tests_only_the_runs_it_wants():
    """(a) A packet of two warps whose rays want disjoint leaves: warp 0
    looks down onto the cluster at x = -5, warp 1 onto the one at x = +5.
    Each warp tests only its own leaf's row: the bfs twin counts 32 rays x
    1 row x 4 slots a warp, half of the whole-packet rule's count, which
    bdl at qgroup = rows (one queue for the packet) still makes. Hits
    equal brute_force_mt's and the packet twin's."""
    scene = _two_clusters()
    flat = flatten_bvh(build_sbvh(scene, BuildConfig(
        builder="binned_sah", max_leaf_size=8)), scene)
    tables = tables_from_packed(pack_bvh(flat, scene.tri_verts(),
                                         tris_per_row=4, nodes_per_row=1),
                                "cpu")
    root = tables.nodes8[0, :16].tolist()
    assert tables.num_nodes == 1 and root[12] < 0 and root[13] < 0
    assert root[14] == root[15] == 1   # one row a leaf
    rng = np.random.default_rng(3)
    xy = rng.uniform(-0.3, 0.3, size=(64, 2)).astype(np.float32)
    xy[:32, 0] -= 5.0
    xy[32:, 0] += 5.0
    orig = np.concatenate([xy, np.full((64, 1), 4.0, np.float32)], 1)
    dirn = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (64, 1))
    tmin = np.zeros(64, np.float32)
    tmax = np.full(64, 1e9, np.float32)
    rays = _torch(orig, dirn, tmin, tmax)
    work = {}
    got = packet_batch.trace_batch_ref(packet_batch.BFS, tables, *rays,
                                       rows=2, work=work)
    assert work["tri_slot_tests"] == 2 * 32 * 1 * 4
    assert work["packet_steps"] == 1 and work["drain_rows"] == 0
    whole = {}
    packet_batch.trace_batch_ref(packet_batch.BDL, tables, *rays, rows=2,
                                 qgroup=2, work=whole)
    assert whole["tri_slot_tests"] == 64 * 2 * 4
    assert _bit_equal(got, trace_packet_ref(tables, *rays))
    bf = brute_force_mt(scene, orig, dirn, tmin, tmax)
    np.testing.assert_array_equal(got[0].numpy(), bf.tri)
    assert (got[0] >= 0).all()


@pytest.fixture(scope="module")
def conference_passes():
    """The diffuse and AO passes of render() at 32x24 on a 5,000-triangle
    conference (engine packet, on the CPU), with the bfs and bdl tables
    (one node a row)."""
    scene = get_scene("conference", n_tris=5000)
    bc = BuildConfig(builder="binned_sah", sah_tri_cost=0.02,
                     max_leaf_size=48)
    flat = flatten_bvh(build_sbvh(scene, bc), scene)
    r = Renderer(scene, bc, RenderConfig(width=32, height=24), flat=flat,
                 device="cpu")
    passes = {}
    base = r.tracer.trace

    def tracer(o, d, tn, tx, any_hit):
        out = base(o, d, tn, tx, any_hit)
        passes[mode] = ((o, d, tn, tx), any_hit)
        return out

    r.tracer.trace = tracer
    for mode in ("diffuse", "ao"):
        r.render(default_camera("conference"), mode)
    tables = tables_from_packed(pack_bvh(flat, scene.tri_verts(),
                                         tris_per_row=r.tables.tris_per_row,
                                         nodes_per_row=1), "cpu")
    return scene, tables, passes


@pytest.mark.parametrize("mode", ["diffuse", "ao"])
def test_bfs_rule_keeps_hits_and_cuts_slot_tests(conference_passes, mode):
    """(b) On conference diffuse and AO rays the bfs twin's closest hits
    equal the packet twin's bit for bit and brute_force_mt's tri, and its
    any-hit tri >= 0 equals the packet twin's and brute_force_anyhit's;
    its slot tests are fewer than bdl's at qgroup = rows (one queue for
    the packet, so every warp tests every run the packet wants: the
    whole-packet rule bfs followed before)."""
    scene, tables, passes = conference_passes
    rays, any_hit = passes[mode]
    assert any_hit == (mode == "ao") and rays[0].shape[0] >= 2048
    work, whole = {}, {}
    got = packet_batch.trace_batch_ref(packet_batch.BFS, tables, *rays,
                                       any_hit=any_hit, rows=8, work=work)
    packet_batch.trace_batch_ref(packet_batch.BDL, tables, *rays,
                                 any_hit=any_hit, rows=8, qgroup=8,
                                 work=whole)
    assert 0 < work["tri_slot_tests"] < whole["tri_slot_tests"]
    host = [a.numpy() for a in rays]
    want = trace_packet_ref(tables, *rays, any_hit=any_hit)
    if any_hit:
        assert torch.equal(got[0] >= 0, want[0] >= 0)
        np.testing.assert_array_equal(got[0].numpy() >= 0,
                                      brute_force_anyhit(scene, *host))
    else:
        assert _bit_equal(got, want)
        np.testing.assert_array_equal(got[0].numpy(),
                                      brute_force_mt(scene, *host).tri)


@pytest.mark.parametrize("kernel", sorted(TWINS))
def test_ray_pointing_away_takes_one_step(kernel):
    """(c) A ray pointing away from the scene: one step (the root's), no
    drain, no row tested."""
    scene = _two_clusters()
    flat = flatten_bvh(build_sbvh(scene, BuildConfig(builder="binned_sah")),
                       scene)
    tables = tables_from_packed(pack_bvh(flat, scene.tri_verts(),
                                         tris_per_row=4, nodes_per_row=1),
                                "cpu")
    work = {}
    tri = packet_batch.trace_batch_ref(
        TWINS[kernel], tables, *_torch(np.array([[0, 0, 50]], np.float32),
                                       np.array([[0, 0, 1]], np.float32),
                                       np.zeros(1, np.float32),
                                       np.full(1, 1e9, np.float32)),
        work=work)[0]
    assert int(tri[0]) == -1
    assert (work["packet_steps"], work["drain_rows"],
            work["packet_drains"], work["tri_slot_tests"]) == (1, 0, 0, 0)
