"""The port's HLBVH build (bvh/hlbvh.py) and its forest sweep
(bvh/lbvh.py:lbvh_device) against the JAX package, on the CPU.

The JAX side runs on the CPU backend (its lax path; lbvh_device has no
Pallas kernel). The port runs the plain version of the row-scan kernel.
Tolerances:
  - lbvh_device: every integer output and `nodes` bit-equal; the Woop rows
    within WOOP_ULPS (64) ulp of each row's largest magnitude. The rows are
    f32 cross products, which XLA on the CPU contracts into fused
    multiply-adds and the port does not (tests/test_torch_lbvh.py holds the
    LBVH build to the same bound);
  - build_hlbvh_flat: `nodes` and `tri_index` bit-equal, the Woop rows
    within the same bound;
  - traced hits: tri exact against brute_force_mt, 0 tie-aware mismatches
    against trace_cpu_golden;
  - render(): hit ids exact against the JAX renderer, the image within
    1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntrace_tpu.bvh import hlbvh as ref_hlbvh
from ntrace_tpu.bvh import lbvh as ref_lbvh
from ntrace_tpu.core import BuildConfig as RefBuildConfig
from ntrace_tpu.core import RenderConfig as RefRenderConfig
from ntrace_tpu.core import Scene as RefScene
from ntrace_tpu.render.renderer import Renderer as JaxRenderer
from ntrace_tpu.scenes import default_camera, get_scene, make_random_soup
from ntrace_tpu_torch import host
from ntrace_tpu_torch.bvh import hlbvh, lbvh
from ntrace_tpu_torch.host.scenes import make_single_triangle
from ntrace_tpu_torch.render.renderer import Renderer, build_accel
from ntrace_tpu_torch.tables import tables_from_packed
from ntrace_tpu_torch.trace.registry import pick_layout
from ntrace_tpu_torch.trace.packet import trace_packet

from conftest import random_rays
from test_torch_lbvh import _args, _bits, assert_bit_equal, assert_woop_close

SCENES = {
    "soup2000": lambda: make_random_soup(n_tris=2000, seed=23),
    "soup8000": lambda: make_random_soup(n_tris=8000, seed=23),
    "fairy5000": lambda: get_scene("fairy", n_tris=5000),
}
SWEEP_KEYS = ("nodes", "tri_index", "node_count", "leaf_count",
              "cluster_roots", "cluster_ids", "order", "n_clusters")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops: one intra-op thread a test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    return {k: f() for k, f in SCENES.items()}


def _sweep_pair(scene, max_leaf, shift):
    args = _args(scene)
    ref = ref_lbvh.lbvh_device(*(jnp.asarray(a) for a in args),
                               max_leaf=max_leaf, cluster_shift=shift)
    got = lbvh.lbvh_device(*(torch.from_numpy(np.ascontiguousarray(
        a, np.float32)) for a in args), max_leaf=max_leaf,
        cluster_shift=shift)
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in got.items()})


@pytest.mark.parametrize("shift", [0, 21])
@pytest.mark.parametrize("name,max_leaf", [("soup2000", 4), ("soup8000", 8),
                                           ("fairy5000", 4),
                                           ("fairy5000", 8)])
def test_lbvh_device_matches_jax(scenes, name, max_leaf, shift):
    ref, got = _sweep_pair(scenes[name], max_leaf, shift)
    assert_bit_equal(ref, got, SWEEP_KEYS)
    assert ref["woop"].shape == got["woop"].shape
    assert_woop_close(ref["woop"], got["woop"])
    assert int(got["node_count"]) > 0
    assert (int(got["n_clusters"]) > 1) == (shift > 0)


@pytest.mark.parametrize("shift,calls", [(0, 61), (21, 62)])
def test_sweep_scans_go_through_row_scan(monkeypatch, scenes, shift, calls):
    """Each level's two reverse cummins, and the forest's first and the
    residual one, are row_scan_i32 calls on (1, n) rows."""
    seen = []
    real = lbvh.row_scan_i32

    def counting(x, **kw):
        seen.append((tuple(x.shape), kw["op"], kw["reverse"]))
        return real(x, **kw)

    monkeypatch.setattr(lbvh, "row_scan_i32", counting)
    scene = scenes["soup2000"]
    lbvh.lbvh_device(*lbvh.device_inputs(scene, "cpu"), max_leaf=4,
                     cluster_shift=shift)
    assert seen == [((1, scene.num_tris), "min", True)] * calls


@pytest.mark.parametrize("name,max_leaf", [("soup2000", 4), ("soup8000", 8),
                                           ("fairy5000", 32)])
def test_build_hlbvh_flat_matches_jax(scenes, name, max_leaf):
    scene = scenes[name]
    flat = build_accel(scene, host.BuildConfig(builder="hlbvh",
                                               max_leaf_size=max_leaf),
                       device="cpu")
    ref = ref_hlbvh.build_hlbvh_flat(
        scene, RefBuildConfig(builder="hlbvh", max_leaf_size=max_leaf))
    assert type(flat) is host.FlatBVH and flat.num_tris == scene.num_tris
    np.testing.assert_array_equal(_bits(flat.nodes), _bits(ref.nodes))
    np.testing.assert_array_equal(flat.tri_index, ref.tri_index)
    assert flat.woop.shape == ref.woop.shape
    assert_woop_close(ref.woop, flat.woop)
    # The spliced tree, not a fallback: more nodes than the forest alone.
    cfg = host.BuildConfig(builder="hlbvh", max_leaf_size=max_leaf)
    out = hlbvh.forest_sweep(scene, cfg, "cpu")
    assert int(out["n_clusters"]) >= 2
    assert flat.nodes.shape[0] > int(out["node_count"])


def one_cluster_soup():
    """300 small triangles in [0.5, 2]^3, and two vertices no triangle uses
    at -10 and +10 that set the scene box: every box centre lies in the
    top Morton cell [0.5, 0.625) of each axis, so the forest has one
    cluster (and internal nodes: 300 triangles)."""
    rng = np.random.default_rng(5)
    tv = rng.uniform(0.5, 2.0, (300, 3, 3)).astype(np.float32)
    pos = np.concatenate([tv.reshape(-1, 3),
                          np.array([[-10] * 3, [10] * 3], np.float32)])
    return RefScene(positions=pos,
                    indices=np.arange(900, dtype=np.int32).reshape(-1, 3),
                    name="one-cluster")


FALLBACKS = {
    # name: (scene, BuildConfig keywords, what the forest sweep shows)
    "one-triangle": (make_single_triangle, {}, None),
    "one-cluster": (one_cluster_soup, {}, "n_clusters"),
    "no-internal-node": (lambda: make_random_soup(n_tris=50, seed=2,
                                                  extent=0.001), {},
                         "node_count"),
    "multi-box-top-leaf": (lambda: make_random_soup(n_tris=2000, seed=23),
                           {"max_depth": 1}, "top_leaf"),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_fallbacks_take_plain_lbvh(case):
    """Each of the reference's three fallbacks to the plain LBVH build is
    reached, and gives the JAX build's tree."""
    make, kw, why = FALLBACKS[case]
    scene = make()
    cfg = host.BuildConfig(builder="hlbvh", **kw)
    if why is None:
        assert scene.num_tris < 2
    else:
        out = hlbvh.forest_sweep(scene, cfg, "cpu")
        ncl, nc = int(out["n_clusters"]), int(out["node_count"])
        assert {"n_clusters": ncl < 2, "node_count": ncl >= 2 and nc == 0,
                "top_leaf": ncl >= 2 and nc > 0}[why], (ncl, nc)
        assert hlbvh.splice_forest(scene, cfg, out) is None
    flat = hlbvh.build_hlbvh_flat(scene, cfg, device="cpu")
    plain = lbvh.build_lbvh_flat(scene, cfg, device="cpu")
    ref = ref_hlbvh.build_hlbvh_flat(scene, RefBuildConfig(builder="hlbvh",
                                                           **kw))
    for other in (plain, ref):
        np.testing.assert_array_equal(_bits(flat.nodes), _bits(other.nodes))
        np.testing.assert_array_equal(flat.tri_index, other.tri_index)
    ids = np.unique(flat.tri_index[flat.tri_index >= 0])
    np.testing.assert_array_equal(ids, np.arange(scene.num_tris))


def test_structure_and_coverage(scenes):
    """A tree (every node but the root named once), every triangle in one
    leaf once."""
    scene = scenes["fairy5000"]
    flat = hlbvh.build_hlbvh_flat(scene, host.BuildConfig(builder="hlbvh"),
                                  device="cpu")
    enc = np.ascontiguousarray(flat.nodes[:, 12:14]).view(np.int32)
    inner = enc[enc >= 0]
    counts = np.bincount(inner, minlength=flat.nodes.shape[0])
    assert counts[0] == 0 and (counts[1:] == 1).all()
    ids = flat.tri_index[flat.tri_index >= 0]
    np.testing.assert_array_equal(np.sort(ids), np.arange(scene.num_tris))


@pytest.mark.parametrize("name,max_leaf", [("soup2000", 4), ("fairy5000",
                                                             32)])
@pytest.mark.parametrize("any_hit", [False, True])
def test_hits_through_the_packet_twin(scenes, name, max_leaf, any_hit):
    scene = scenes[name]
    flat = hlbvh.build_hlbvh_flat(
        scene, host.BuildConfig(builder="hlbvh", max_leaf_size=max_leaf),
        device="cpu")
    _, _, tpr, npr = pick_layout(flat)
    tables = tables_from_packed(host.pack_bvh(flat, scene.tri_verts(),
                                              tris_per_row=tpr,
                                              nodes_per_row=npr), "cpu")
    lo, hi = scene.bbox()
    o, d, tn, tx = random_rays(np.random.default_rng(9), 1024,
                               extent=float(np.abs([lo, hi]).max()) * 1.2)
    tri, t, _, _ = trace_packet(tables, *(torch.from_numpy(a) for a in
                                          (o, d, tn, tx)), any_hit=any_hit)
    tri, t = tri.numpy(), t.numpy()
    if any_hit:
        blocked = host.brute_force_anyhit(scene, o, d, tn, tx)
        np.testing.assert_array_equal(tri >= 0, blocked)
        return
    bf = host.brute_force_mt(scene, o, d, tn, tx)
    assert (bf.tri >= 0).mean() > 0.1
    np.testing.assert_array_equal(tri, bf.tri)
    rec = host.trace_cpu_golden(flat, o, d, tn, tx)
    assert host.golden_mismatches(tri, t, rec.tri, rec.t) == 0


@pytest.fixture(scope="module")
def fairy_frames(scenes):
    """The JAX renderer's hlbvh frames of fairy@5000 at 32 x 24."""
    scene = scenes["fairy5000"]
    cam = default_camera("fairy")
    bc = RefBuildConfig(builder="hlbvh")
    return {m: JaxRenderer(scene, bc, RefRenderConfig(
        width=32, height=24, mode=m)).render(cam)
        for m in ("primary", "ao", "diffuse")}


@pytest.mark.parametrize("mode", ["primary", "ao", "diffuse"])
def test_render_hlbvh_matches_jax(scenes, fairy_frames, mode):
    scene = scenes["fairy5000"]
    r = Renderer(scene, host.BuildConfig(builder="hlbvh"),
                 host.RenderConfig(width=32, height=24, mode=mode),
                 device="cpu")
    assert r.flat is not None and r.engine == "packet"
    got = r.render(default_camera("fairy"))
    ref = fairy_frames[mode]
    np.testing.assert_array_equal(got.hit_tri, ref.hit_tri)
    np.testing.assert_allclose(got.image, ref.image, rtol=0, atol=1e-6)
    assert (got.hit_tri >= 0).mean() > 0.3 and got.image.max() > 0
