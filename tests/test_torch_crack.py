"""The conservative slab test: no BVH engine of the port loses a hit on a
shared edge of two leaf boxes.

A box that is flat in one axis (an axis-aligned quad split in two, a wall
panel of the conference scene) holds its triangles' hits only up to the
rounding of the slab distances; Moller-Trumbore accepts a hit on the
shared edge that may round outside both boxes of the edge. The port's slab
test takes a relative slack (csrc/trace_common.cuh:slab says how much and
why), so every twin keeps such hits. The reference has the crack: on the
recorded conference ray below, its packet kernel reports a hit distance
with triangle id -1 (ROADMAP, known faults in the reference).

Every twin (packet, ww, ifif, pipe, and the wide packet twin with exact
True and False) is held to `brute_force_mt` exactly: tri equal on every
ray, t/u/v bit-equal on hits (the port's Moller-Trumbore op order is
brute_force_mt's; neither contracts FMAs).
"""

import numpy as np
import pytest
import torch

from ntrace_tpu_torch.host import (BuildConfig, Scene, brute_force_mt,
                                   get_scene, pack_bvh, pack_wide_bvh)
from ntrace_tpu_torch.render.renderer import build_accel
from ntrace_tpu_torch.tables import tables_from_packed, tables_from_wide
from ntrace_tpu_torch.trace.packet import trace_packet_ref
from ntrace_tpu_torch.trace.packet_ifif import trace_packet_ifif_ref
from ntrace_tpu_torch.trace.packet_pipe import trace_packet_pipe_ref
from ntrace_tpu_torch.trace.packet_wide import trace_packet_wide_ref
from ntrace_tpu_torch.trace.packet_ww import trace_packet_ww_ref
from ntrace_tpu_torch.trace.registry import pick_layout

TWINS = {
    "packet": trace_packet_ref, "ww": trace_packet_ww_ref,
    "ifif": trace_packet_ifif_ref, "pipe": trace_packet_pipe_ref,
    "wide": lambda tb, *r: trace_packet_wide_ref(tb, *r, exact=False),
    "wide_exact": lambda tb, *r: trace_packet_wide_ref(tb, *r, exact=True),
}
# Diffuse ray 411,517 of the conference frame (1024 x 768, samples 4,
# seed 0, binned SAH with sah_tri_cost 0.02 and max_leaf_size 48), as
# render(mode="diffuse") traces it; origin, direction, tmin, tmax.
CONF_RAY = (
    ("0x1.3fe18ap+3", "0x1.df1d0ap+2", "0x1.6d0aep-1"),
    ("-0x1.76f2aap-1", "-0x1.519a7p-2", "0x1.311064p-1"),
    "0x0p+0", "0x1.73dccap+8")
CONF_HIT = (209658, "0x1.40daa6p+4")       # brute_force_mt: tri, t
CONF_BUILD = BuildConfig(builder="binned_sah", sah_tri_cost=0.02,
                         max_leaf_size=48)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test worker (the twins run many small
    ops). Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(h: str) -> np.float32:
    return np.float32(float.fromhex(h))


def quad_sheets(n: int = 6, seed: int = 5) -> Scene:
    """Three sheets of n x n axis-aligned quads, flat in x, y and z, each
    quad split in two along alternating diagonals. Vertex coordinates are
    irregular floats, and neighbouring quads share their edge and corner
    vertices exactly."""
    rng = np.random.default_rng(seed)
    pos, idx = [], []
    for axis, level in ((1, 0.87473464), (0, 7.31), (2, -6.77)):
        u = np.cumsum(rng.uniform(0.6, 1.7, n + 1)) - 5.0
        v = np.cumsum(rng.uniform(0.6, 1.7, n + 1)) - 5.0
        uu, vv = np.meshgrid(u, v, indexing="ij")
        p = np.zeros((n + 1, n + 1, 3))
        a, b = [c for c in range(3) if c != axis]
        p[..., axis], p[..., a], p[..., b] = level, uu, vv
        base = sum(len(q) for q in pos)
        pos.append(p.reshape(-1, 3))
        for i in range(n):
            for j in range(n):
                c00, c01 = i * (n + 1) + j, i * (n + 1) + j + 1
                c10, c11 = c00 + n + 1, c01 + n + 1
                if (i + j) % 2:
                    tris = ((c00, c10, c11), (c00, c11, c01))
                else:
                    tris = ((c00, c10, c01), (c10, c11, c01))
                idx += [[base + k for k in t] for t in tris]
    return Scene(np.concatenate(pos), np.array(idx), name="quad_sheets")


def edge_rays(scene: Scene, n: int, seed: int = 9):
    """Rays aimed at points of shared edges and at shared vertices, from
    origins 4-20 units away on either side of the sheets."""
    rng = np.random.default_rng(seed)
    tv = scene.tri_verts().astype(np.float64)
    tri = rng.integers(0, scene.num_tris, n)
    k = rng.integers(0, 3, n)
    a, b = tv[tri, k], tv[tri, (k + 1) % 3]
    s = rng.uniform(0.0, 1.0, (n, 1))
    s[: n // 4] = 0.0                              # a quarter at vertices
    target = (a + s * (b - a)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    orig = (target - d * rng.uniform(4.0, 20.0, (n, 1))).astype(np.float32)
    dirn = (target - orig).astype(np.float64)
    dirn = (dirn / np.linalg.norm(dirn, axis=1, keepdims=True)).astype(
        np.float32)
    return (orig, dirn, np.zeros(n, np.float32), np.full(n, 1e9, np.float32))


def _tables(scene, flat):
    _, _, tpr, npr = pick_layout(flat)
    packed = tables_from_packed(pack_bvh(flat, scene.tri_verts(),
                                         tris_per_row=tpr,
                                         nodes_per_row=npr), "cpu")
    wide = tables_from_wide(pack_wide_bvh(flat, scene.tri_verts(),
                                          tris_per_row=4), "cpu")
    return packed, wide


def _assert_exact(name, got, bf):
    tri, t, u, v = (a.numpy() for a in got)
    bad = np.nonzero(tri != bf.tri)[0]
    assert not len(bad), (f"{name}: tri differs from brute_force_mt on "
                          f"{len(bad)} rays, first {bad[:8]}: "
                          f"{tri[bad[:4]]} vs {bf.tri[bad[:4]]}")
    hit = bf.tri >= 0
    for a, b in zip((t, u, v), (bf.t, bf.u, bf.v)):
        np.testing.assert_array_equal(a[hit].view(np.int32),
                                      b[hit].view(np.int32), err_msg=name)


@pytest.fixture(scope="module")
def sheets():
    scene = quad_sheets()
    rays = edge_rays(scene, 3000)
    return scene, rays, brute_force_mt(scene, *rays)


@pytest.mark.parametrize("builder,leaf", [("binned_sah", 2), ("median", 1),
                                          ("median", 4)])
@pytest.mark.parametrize("twin", list(TWINS))
def test_shared_edges_are_exact(sheets, builder, leaf, twin):
    scene, rays, bf = sheets
    assert (bf.tri >= 0).mean() > 0.9
    flat = build_accel(scene, BuildConfig(builder=builder,
                                          max_leaf_size=leaf))
    packed, wide = _tables(scene, flat)
    tables = wide if twin.startswith("wide") else packed
    got = TWINS[twin](tables, *(torch.from_numpy(a) for a in rays))
    _assert_exact(f"{twin} {builder}/{leaf}", got, bf)


@pytest.fixture(scope="module")
def conference():
    scene = get_scene("conference", n_tris=280_000)
    return scene, _tables(scene, build_accel(scene, CONF_BUILD))


def test_conference_ray_hex_literals_are_brute_forces_hit(conference):
    scene, _ = conference
    o, d, tn, tx = CONF_RAY
    rays = (np.array([[_f32(h) for h in o]]), np.array([[_f32(h) for h in d]]),
            np.array([_f32(tn)]), np.array([_f32(tx)]))
    bf = brute_force_mt(scene, *rays)
    assert int(bf.tri[0]) == CONF_HIT[0]
    assert bf.t[0] == _f32(CONF_HIT[1])


@pytest.mark.parametrize("twin", list(TWINS))
def test_conference_diffuse_ray_411517(conference, twin):
    scene, (packed, wide) = conference
    o, d, tn, tx = CONF_RAY
    rays = (torch.tensor([[float.fromhex(h) for h in o]]),
            torch.tensor([[float.fromhex(h) for h in d]]),
            torch.tensor([float.fromhex(tn)]),
            torch.tensor([float.fromhex(tx)]))
    tables = wide if twin.startswith("wide") else packed
    tri, t, _, _ = TWINS[twin](tables, *rays)
    assert int(tri[0]) == CONF_HIT[0]
    assert t.numpy()[0] == _f32(CONF_HIT[1])


@pytest.mark.cuda
def test_kernels_keep_shared_edge_hits_on_cuda(sheets, conference):
    """Each CUDA kernel of the binary and wide engines against
    brute_force_mt on the sheets' edge rays and the recorded conference
    ray: the kernels share their twins' slab test, so they keep the same
    hits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from ntrace_tpu_torch.trace.packet import trace_packet
    from ntrace_tpu_torch.trace.packet_ifif import trace_packet_ifif
    from ntrace_tpu_torch.trace.packet_pipe import trace_packet_pipe
    from ntrace_tpu_torch.trace.packet_wide import trace_packet_wide
    from ntrace_tpu_torch.trace.packet_ww import trace_packet_ww

    kernels = {
        "packet": trace_packet, "ww": trace_packet_ww,
        "ifif": trace_packet_ifif, "pipe": trace_packet_pipe,
        "wide": lambda tb, *r: trace_packet_wide(tb, *r, exact=False),
        "wide_exact": lambda tb, *r: trace_packet_wide(tb, *r, exact=True)}
    scene, rays, bf = sheets
    o, d, tn, tx = CONF_RAY
    conf_rays = [torch.tensor([[float.fromhex(h) for h in o]]),
                 torch.tensor([[float.fromhex(h) for h in d]]),
                 torch.tensor([float.fromhex(tn)]),
                 torch.tensor([float.fromhex(tx)])]
    flat = build_accel(scene, BuildConfig(builder="median", max_leaf_size=1))
    sheet_tables = _tables(scene, flat)
    for name, fn in kernels.items():
        k = 1 if name.startswith("wide") else 0
        got = fn(_to_cuda(sheet_tables[k]),
                 *(torch.from_numpy(a).cuda() for a in rays))
        _assert_exact(f"{name} kernel", [a.cpu() for a in got], bf)
        tri, t, _, _ = fn(_to_cuda(conference[1][k]),
                          *(a.cuda() for a in conf_rays))
        assert int(tri[0]) == CONF_HIT[0], name
        assert t.cpu().numpy()[0] == _f32(CONF_HIT[1]), name


def _to_cuda(tables):
    import dataclasses

    return dataclasses.replace(tables, **{
        f.name: getattr(tables, f.name).cuda()
        for f in dataclasses.fields(tables)
        if isinstance(getattr(tables, f.name), torch.Tensor)})
