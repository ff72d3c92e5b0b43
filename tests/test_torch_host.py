"""The port's copies of the host layers (ntrace_tpu_torch/host/) against the
JAX package's originals, on the CPU.

Scenes are compared byte for byte; trees, packed tables and oracle results
(brute_force_mt, brute_force_anyhit, trace_cpu_golden, golden_mismatches)
must be equal. The binned-SAH tree is built on both of its paths: the
Python builder below 50,000 triangles and the native g++ builder
(host/native/sbvh.cpp, built into ntrace_tpu_torch/_build/) at 50,000 and
above, as the reference chooses.
"""

import dataclasses

import numpy as np
import pytest

from ntrace_tpu.bvh import golden as ref_golden
from ntrace_tpu.bvh.flatten import flatten_bvh as ref_flatten
from ntrace_tpu.bvh.median import build_median_bvh as ref_median
from ntrace_tpu.bvh.packed import pack_bvh as ref_pack
from ntrace_tpu.bvh.packed import pick_layout as ref_pick_layout
from ntrace_tpu.bvh.sbvh import build_sbvh as ref_sbvh
from ntrace_tpu.bvh.sbvh import sbvh_impl_tag as ref_impl_tag
from ntrace_tpu.bvh.wide_packed import pack_wide_bvh as ref_pack_wide
from ntrace_tpu.core import BuildConfig as RefBuildConfig
from ntrace_tpu.scenes import default_camera as ref_camera
from ntrace_tpu.scenes import get_scene as ref_get_scene
from ntrace_tpu.scenes import make_random_soup as ref_soup
from ntrace_tpu.trace import cpu as ref_cpu
from ntrace_tpu_torch import host
from ntrace_tpu_torch.host.bvh.sbvh import sbvh_impl_tag

from conftest import random_rays

SCENES = {
    "conference@4000": (lambda m: m.get_scene("conference@4000")),
    "hairball@20000": (lambda m: m.get_scene("hairball@20000")),
    "soup": (lambda m: m.make_random_soup(n_tris=3000, seed=5)),
}


class _Ref:
    get_scene = staticmethod(ref_get_scene)
    make_random_soup = staticmethod(ref_soup)


def _scene_pair(name):
    return SCENES[name](_Ref), SCENES[name](host)


def _equal(a, b):
    """Equal values, dtypes and bytes (floats by bit pattern)."""
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    if dataclasses.is_dataclass(a):
        return all(_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_equal, a, b))
    return a == b


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_byte_equal(name):
    ref, got = _scene_pair(name)
    assert type(got) is host.Scene
    for f in dataclasses.fields(ref):
        assert _equal(getattr(ref, f.name), getattr(got, f.name)), f.name
    assert _equal(ref.tri_verts(), got.tri_verts())
    assert all(_equal(x, y) for x, y in zip(ref.bbox(), got.bbox()))


@pytest.mark.parametrize("name", ["conference", "hairball"])
def test_camera_equal(name):
    assert _equal(ref_camera(name), host.default_camera(name))


def _flat_pair(scene_ref, scene_got, builder, **kw):
    rcfg = RefBuildConfig(builder=builder, **kw)
    cfg = host.BuildConfig(builder=builder, **kw)
    if builder == "median":
        ref = ref_flatten(ref_median(scene_ref, rcfg), scene_ref)
        got = host.flatten_bvh(host.build_median_bvh(scene_got, cfg),
                               scene_got)
    else:
        ref = ref_flatten(ref_sbvh(scene_ref, rcfg), scene_ref)
        got = host.flatten_bvh(host.build_sbvh(scene_got, cfg), scene_got)
    return ref, got


@pytest.mark.parametrize("builder,name,impl", [
    ("median", "conference@4000", "py"),
    ("median", "hairball@20000", "py"),
    ("binned_sah", "conference@4000", "py"),
    ("binned_sah", "soup", "py"),
    ("sbvh", "soup", "py"),
    ("binned_sah", "soup@50000", "native"),
])
def test_flat_equal(builder, name, impl):
    if name == "soup@50000":
        scene_ref = ref_soup(n_tris=50_000, seed=3)
        scene_got = host.make_random_soup(n_tris=50_000, seed=3)
    else:
        scene_ref, scene_got = _scene_pair(name)
    n = scene_got.num_tris
    if builder != "median":
        assert sbvh_impl_tag(n, host.BuildConfig(builder=builder)) == impl
        assert ref_impl_tag(n, RefBuildConfig(builder=builder)) == impl
    ref, got = _flat_pair(scene_ref, scene_got, builder)
    assert type(got) is host.FlatBVH
    assert _equal(ref, got)


@pytest.mark.parametrize("tpr,npr", [(12, 1), (4, 8)])
def test_pack_equal(tpr, npr):
    scene_ref, scene_got = _scene_pair("conference@4000")
    ref, got = _flat_pair(scene_ref, scene_got, "binned_sah",
                          sah_tri_cost=0.02, max_leaf_size=48)
    pr = ref_pack(ref, scene_ref.tri_verts(), tris_per_row=tpr,
                  nodes_per_row=npr)
    pg = host.pack_bvh(got, scene_got.tri_verts(), tris_per_row=tpr,
                       nodes_per_row=npr)
    assert type(pg) is host.PackedBVH
    assert _equal(pr, pg)
    assert (host.pick_layout(got.nodes.shape[0], 4000, avg_leaf=5.0)
            == ref_pick_layout(got.nodes.shape[0], 4000, avg_leaf=5.0))


@pytest.mark.parametrize("builder,kw", [
    ("binned_sah", dict(sah_tri_cost=0.02, max_leaf_size=48)),
    ("median", {}),
])
def test_pack_wide_equal(builder, kw):
    """host/bvh/wide_packed.py packs the same nodes_w and tris12 bytes as
    the reference's, on two trees."""
    scene_ref, scene_got = _scene_pair("conference@4000")
    ref, got = _flat_pair(scene_ref, scene_got, builder, **kw)
    pr = ref_pack_wide(ref, scene_ref.tri_verts(), tris_per_row=4)
    pg = host.pack_wide_bvh(got, scene_got.tri_verts(), tris_per_row=4)
    assert type(pg) is host.WidePackedBVH
    assert _equal(pr, pg)


@pytest.fixture(scope="module")
def soup_and_rays():
    scene_ref, scene_got = _scene_pair("soup")
    rays = random_rays(np.random.default_rng(31), 2000)
    ref, got = _flat_pair(scene_ref, scene_got, "binned_sah")
    return scene_ref, scene_got, rays, ref, got


@pytest.mark.parametrize("oracle", ["brute_force_mt", "brute_force_anyhit"])
def test_brute_force_equal(soup_and_rays, oracle):
    scene_ref, scene_got, rays, _, _ = soup_and_rays
    o, d, tn, tx = rays
    if oracle == "brute_force_anyhit":
        tx = np.full_like(tx, 6.0)
    ref = getattr(ref_golden, oracle)(scene_ref, o, d, tn, tx)
    got = getattr(host, oracle)(scene_got, o, d, tn, tx)
    assert _equal(ref, got)
    if oracle == "brute_force_mt":
        assert (got.tri >= 0).any()


@pytest.mark.parametrize("any_hit", [False, True])
def test_trace_cpu_golden_equal(soup_and_rays, any_hit):
    scene_ref, scene_got, rays, flat_ref, flat_got = soup_and_rays
    ref = ref_cpu.trace_cpu_golden(flat_ref, *rays, any_hit=any_hit)
    got = host.trace_cpu_golden(flat_got, *rays, any_hit=any_hit)
    assert _equal(ref, got)
    bf = host.brute_force_mt(scene_got, *rays)
    # A perturbed copy: some ids and distances differ from the golden.
    tri = got.tri.copy()
    t = got.t.copy()
    tri[::7] = np.where(tri[::7] >= 0, tri[::7] + 1, -1)
    t[::5] = t[::5] * np.float32(1.0000005)
    for args in ((bf.tri, bf.t, got.tri, got.t), (tri, t, got.tri, got.t)):
        assert (ref_cpu.golden_mismatches(*args)
                == host.golden_mismatches(*args))
    assert host.golden_mismatches(tri, t, got.tri, got.t) > 0
