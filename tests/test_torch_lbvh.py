"""The port's device LBVH build (bvh/lbvh.py) and row scan (ops/pscan.py)
against the JAX package, on the CPU.

The JAX side runs as its own tests run it here: `lbvh_device_fast` on the
CPU backend (its lax path), `row_scan_i32` in Pallas interpret mode. The
port runs the plain version of the row-scan kernel. Tolerances:
  - row scans, Morton codes, clz, and every output of the packed emission
    (pnodes, ptris, node_count, leaf_count, kept, order): bit-equal. The
    packed path has only min, max, subtraction and integer operations;
  - the flat emission's nodes and tri_index: bit-equal; its Woop rows
    within WOOP_ULPS ulp of each row's largest magnitude. The rows are f32
    cross products, which XLA on the CPU contracts into fused multiply-
    adds and the port does not; near a cancellation the element-wise ulp
    gap is unbounded, so the bound is scaled by the row;
  - the frame: hit_tri exact against the JAX renderer and brute_force_mt,
    the image within 1e-6.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntrace_tpu.bvh import lbvh as ref_lbvh
from ntrace_tpu.core import BuildConfig as RefBuildConfig
from ntrace_tpu.core import RenderConfig as RefRenderConfig
from ntrace_tpu.core import Scene as RefScene
from ntrace_tpu.ops import morton as ref_morton
from ntrace_tpu.ops.pscan import row_scan_i32 as ref_row_scan
from ntrace_tpu.render.renderer import Renderer as JaxRenderer
from ntrace_tpu.scenes import default_camera, get_scene, make_random_soup
from ntrace_tpu_torch import host
from ntrace_tpu_torch.bvh import lbvh
from ntrace_tpu_torch.host.scenes import make_single_triangle
from ntrace_tpu_torch.ops import morton, pscan
from ntrace_tpu_torch.ops.boxes import child_boxes
from ntrace_tpu_torch.render.renderer import Renderer, build_accel
from ntrace_tpu_torch.tables import tables_from_device

from conftest import random_rays

WOOP_ULPS = 64
SCAN_SHAPES = [(31, 1000), (8, 8192), (3, 257), (31, 20000)]


def dup_soup():
    """A soup with five clusters of 120 identical triangles: their Morton
    codes repeat, so D == 30 boundaries (never split) are on the path."""
    tv = make_random_soup(n_tris=1000, seed=9).tri_verts().copy()
    for k in range(5):
        tv[k * 120:(k + 1) * 120] = tv[k * 120]
    idx = np.arange(3000, dtype=np.int32).reshape(-1, 3)
    return RefScene(positions=tv.reshape(-1, 3), indices=idx, name="dupes")


def signed_zero_soup():
    """2,000 triangles whose box lo.x and hi.y are each +0.0 or -0.0 (one
    vertex a triangle on them, the others off): most child boxes hold both
    zeros in those lanes."""
    g = np.random.default_rng(6)
    tv = g.uniform(-1, 1, size=(2000, 3, 3)).astype(np.float32)
    tv[:, 1:, 0] = g.uniform(0.01, 1, size=(2000, 2))
    tv[:, 1:, 1] = g.uniform(-1, -0.01, size=(2000, 2))
    tv[:, 0, :2] = np.where(g.random((2000, 2)) < 0.5, np.float32(0.0),
                            np.float32(-0.0))
    idx = np.arange(6000, dtype=np.int32).reshape(-1, 3)
    return RefScene(positions=tv.reshape(-1, 3), indices=idx, name="zeros")


SCENES = {
    "conference@4000": lambda: get_scene("conference@4000"),
    "hairball@20000": lambda: get_scene("hairball@20000"),
    "dupes": dup_soup,
}


def _args(scene):
    tv = scene.tri_verts()
    lo, hi = scene.bbox()
    return (tv.min(axis=1), tv.max(axis=1), tv, lo, hi)


def _jax(args, **kw):
    out = ref_lbvh.lbvh_device_fast(*(jnp.asarray(a) for a in args), **kw)
    return {k: np.asarray(v) for k, v in out.items()}


def _port(args, **kw):
    out = lbvh.lbvh_device_fast(
        *(torch.from_numpy(np.ascontiguousarray(a, np.float32))
          for a in args), **kw)
    return {k: v.numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in out.items()}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bit_equal(ref, got, keys):
    for k in keys:
        assert ref[k].shape == got[k].shape, k
        np.testing.assert_array_equal(_bits(ref[k]), _bits(got[k]),
                                      err_msg=k)


def assert_woop_close(ref, got):
    """|ref - got| <= WOOP_ULPS ulp of each row's largest |ref|."""
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max(axis=1, keepdims=True)
    ulp = np.exp2(np.floor(np.log2(np.maximum(scale, 1e-30))) - 23)
    assert (np.abs(ref - got) <= WOOP_ULPS * ulp).all()


# --- the row scan ----------------------------------------------------------

@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("reverse", [False, True])
def test_row_scan_ref_matches_pallas_and_lax(shape, op, reverse):
    rng = np.random.default_rng(7)
    x = rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int32)
    got = pscan.row_scan_i32_ref(torch.from_numpy(x), op=op,
                                 reverse=reverse).numpy()
    pallas = np.asarray(ref_row_scan(jnp.asarray(x), op=op, reverse=reverse,
                                     block=2048, interpret=True))
    lax_fn = jax.lax.cummax if op == "max" else jax.lax.cummin
    lax = np.asarray(lax_fn(jnp.asarray(x), axis=1, reverse=reverse))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, lax)


def test_row_scan_on_cpu_takes_the_plain_version():
    x = torch.from_numpy(np.random.default_rng(1).integers(
        -50, 50, size=(4, 300), dtype=np.int32))
    before = pscan.row_scan_i32.launches
    for op in pscan.OPS:
        for rev in (False, True):
            assert torch.equal(pscan.row_scan_i32(x, op=op, reverse=rev),
                               pscan.row_scan_i32_ref(x, op=op, reverse=rev))
    assert pscan.row_scan_i32.launches == before
    with pytest.raises(TypeError):
        pscan.row_scan_i32(x.long())
    with pytest.raises(ValueError):
        pscan.row_scan_i32(x, op="sum")
    with pytest.raises(ValueError):
        pscan.row_scan_i32(x[0])


def test_cuda_input_never_reaches_the_plain_version(monkeypatch):
    """A CUDA tensor goes to the kernel or raises; here the launch is
    replaced by one that fails, and the call must raise."""
    x = torch.zeros((2, 5), dtype=torch.int32)
    monkeypatch.setattr(pscan, "uses_kernel", lambda t: True)

    def failing_launch(*a):
        raise RuntimeError("ntrace_row_scan_i32 launch failed")

    def no_plain(*a, **k):
        raise AssertionError("the plain version ran for a kernel tensor")

    monkeypatch.setattr(pscan, "_launch", failing_launch)
    monkeypatch.setattr(pscan, "row_scan_i32_ref", no_plain)
    with pytest.raises(RuntimeError):
        pscan.row_scan_i32(x)


# --- Morton codes and clz --------------------------------------------------

def test_clz32_matches_lax_clz():
    vals = [0, 2**32 - 1] + [v for k in range(33)
                             for v in (2**k - 1, 2**k, 2**k + 1)]
    x = np.array([v % 2**32 for v in vals], np.uint64).astype(
        np.uint32).view(np.int32)
    x = np.concatenate([x, np.random.default_rng(3).integers(
        -2**31, 2**31 - 1, size=5000, dtype=np.int32)])
    got = morton.clz32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.lax.clz(
        jnp.asarray(x))))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_morton_codes_match_numpy_and_jnp(name):
    scene = SCENES[name]()
    tlo, thi, _, lo, hi = _args(scene)
    cent = (tlo + thi) * np.float32(0.5)
    got = morton.morton_codes_3d(*(torch.from_numpy(a) for a in
                                   (cent, lo, hi))).numpy()
    np.testing.assert_array_equal(
        got, ref_morton.morton_codes_3d(np, cent, lo, hi))
    np.testing.assert_array_equal(got, np.asarray(ref_morton.morton_codes_3d(
        jnp, jnp.asarray(cent), jnp.asarray(lo), jnp.asarray(hi))))


# --- the build -------------------------------------------------------------

PACKED_KEYS = ("pnodes", "ptris", "node_count", "leaf_count", "kept",
               "order", "root")


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("max_leaf", [4, 8, 32])
def test_packed_emission_bit_equal(name, max_leaf):
    args = _args(SCENES[name]())
    kw = dict(max_leaf=max_leaf, emit="packed")
    ref, got = _jax(args, **kw), _port(args, **kw)
    assert int(ref["cap"]) == int(got["cap"])
    assert int(got["node_count"]) > 0
    assert_bit_equal(ref, got, PACKED_KEYS)


@pytest.mark.parametrize("max_leaf", [4, 32])
def test_signed_zero_boxes_bit_equal(max_leaf):
    """Child boxes whose lanes hold both zeros take lax.min's signs, -0.0
    for lo and +0.0 for hi: the packed and flat emissions bit-equal to the
    JAX build's."""
    args = _args(signed_zero_soup())
    assert (np.signbit(args[0][:, 0]).mean(), np.signbit(args[1][:, 1])
            .mean()) != (0, 0)
    kw = dict(max_leaf=max_leaf, emit="packed")
    ref, got = _jax(args, **kw), _port(args, **kw)
    assert_bit_equal(ref, got, PACKED_KEYS)
    kw["emit"] = "flat"
    assert_bit_equal(_jax(args, **kw), _port(args, **kw),
                     ("nodes", "tri_index", "node_count", "leaf_count",
                      "root"))


def test_ansv_scans_through_either_scan():
    args = _args(get_scene("conference@4000"))
    t = [torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in args]
    codes = lbvh.morton_sort(*t)[0]
    D = lbvh.split_levels(codes)
    assert int(D[0]) == -1 and int(D.max()) <= 30
    P, Q = lbvh.ansv_scans(D)
    P2, Q2 = lbvh.ansv_scans(D, pscan.row_scan_i32_ref)
    assert P.shape == (lbvh.CLASSES, D.shape[0])
    assert torch.equal(P, P2) and torch.equal(Q, Q2)


def _kept_loop(kept):
    """kept_neighbours by a plain loop: the last kept row before each row
    (-1 when none) and the next kept row after it (n when none)."""
    n = len(kept)
    pks, nks = [0] * n, [0] * n
    last = -1
    for i in range(n):
        pks[i] = last
        if kept[i]:
            last = i
    nxt = n
    for i in reversed(range(n)):
        nks[i] = nxt
        if kept[i]:
            nxt = i
    return pks, nks


def _kept_mask(case, n):
    kept = np.zeros(n, bool)
    if case == "every":
        kept[1:] = True
    elif case == "row1":
        kept[1] = True
    elif case == "last":
        kept[n - 1] = True
    elif case.startswith("random"):
        kept = np.random.default_rng(5).random(n) < float(case[6:])
    return torch.from_numpy(kept)


@pytest.mark.parametrize("case", ["none", "every", "row1", "last",
                                  "random0.01", "random0.3"])
def test_kept_neighbours_match_a_loop(case):
    kept = _kept_mask(case, 1000)
    pks, nks = lbvh.kept_neighbours(kept)
    assert pks.dtype == nks.dtype == torch.int32
    want = _kept_loop(kept.tolist())
    assert (pks.tolist(), nks.tolist()) == want


def test_kept_neighbour_scans_go_through_row_scan(monkeypatch):
    """lbvh_device_fast's two 1-D scans are row_scan_i32 calls on (1, n)
    rows, a forward max and a reverse min, and the build is bit-equal
    with them recorded. The class scans do not show here: ansv's `scan`
    default is bound when it is defined."""
    args = _args(get_scene("conference@4000"))
    kw = dict(max_leaf=32, emit="packed")
    want = _port(args, **kw)
    seen = []

    def recorder(x, **k):
        seen.append((tuple(x.shape), k["op"], k.get("reverse", False)))
        return pscan.row_scan_i32_ref(x, **k)

    monkeypatch.setattr(lbvh, "row_scan_i32", recorder)
    got = _port(args, **kw)
    n = args[0].shape[0]
    assert seen == [((1, n), "max", False), ((1, n), "min", True)]
    assert int(got["cap"]) == int(want["cap"])
    assert_bit_equal(want, got, PACKED_KEYS)


def test_compact_cap_retry():
    """max_leaf 1 keeps nearly every boundary, past the default cap of
    ~0.64 n: the first build overflows, and the wrappers rebuild with the
    cap at n, as the reference's do. (The reference's own retry raises:
    `compact_cap` is not a static argument of its jit. The JAX function is
    held here with the cap made static.)"""
    soup = make_random_soup(n_tris=2000, seed=4)
    n = soup.num_tris
    args = _args(soup)
    first = _port(args, max_leaf=1, emit="packed")
    assert int(first["node_count"]) > int(first["cap"])
    assert_bit_equal(_jax(args, max_leaf=1, emit="packed"), first,
                     ("node_count", "kept", "order"))
    ref_fn = jax.jit(ref_lbvh.lbvh_device_fast.__wrapped__,
                     static_argnames=("max_leaf", "emit", "tpr", "npr",
                                      "compact_cap"))
    jargs = [jnp.asarray(a) for a in args]
    for emit, keys in (("packed", PACKED_KEYS),
                       ("flat", ("nodes", "tri_index", "node_count",
                                 "leaf_count", "root"))):
        ref = {k: np.asarray(v) for k, v in ref_fn(
            *jargs, max_leaf=1, emit=emit, compact_cap=n).items()}
        got = _port(args, max_leaf=1, emit=emit, compact_cap=n)
        assert int(got["node_count"]) <= got["nodes" if emit == "flat"
                                             else "pnodes"].shape[0]
        assert_bit_equal(ref, got, keys)
    cfg = host.BuildConfig(builder="lbvh", max_leaf_size=1)
    pk = lbvh.build_lbvh_packed(soup, cfg, device="cpu")
    assert pk.num_nodes == int(first["node_count"])
    np.testing.assert_array_equal(
        _bits(pk.nodes8.numpy()),
        _bits(_port(args, max_leaf=1, emit="packed", compact_cap=n)["pnodes"]))
    flat = lbvh.build_lbvh_flat(soup, cfg, device="cpu")
    assert flat.nodes.shape[0] == pk.num_nodes
    o, d, tn, tx = random_rays(np.random.default_rng(8), 256)
    rec = host.trace_cpu_golden(flat, o, d, tn, tx)
    bf = host.brute_force_mt(soup, o, d, tn, tx)
    assert host.golden_mismatches(rec.tri, rec.t, bf.tri, bf.t) == 0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_lbvh_flat_matches_jax(name):
    scene = SCENES[name]()
    cfg = host.BuildConfig(builder="lbvh", max_leaf_size=8)
    flat = build_accel(scene, cfg, device="cpu")
    ref = ref_lbvh.build_lbvh_flat(scene, RefBuildConfig(builder="lbvh",
                                                         max_leaf_size=8))
    assert type(flat) is host.FlatBVH
    np.testing.assert_array_equal(_bits(flat.nodes), _bits(ref.nodes))
    np.testing.assert_array_equal(flat.tri_index, ref.tri_index)
    assert flat.woop.shape == ref.woop.shape
    assert_woop_close(ref.woop, flat.woop)
    o, d, tn, tx = random_rays(np.random.default_rng(5), 512)
    rec = host.trace_cpu_golden(flat, o, d, tn, tx)
    bf = host.brute_force_mt(scene, o, d, tn, tx)
    assert host.golden_mismatches(rec.tri, rec.t, bf.tri, bf.t) == 0


def test_build_accel_builds_lbvh():
    """build_accel(builder="lbvh") builds on the device it is given: a
    50-triangle soup on the CPU, its tree bit-equal to the JAX build's."""
    soup = make_random_soup(n_tris=50, seed=1)
    flat = build_accel(soup, host.BuildConfig(builder="lbvh"), device="cpu")
    ref = ref_lbvh.build_lbvh_flat(soup, RefBuildConfig(builder="lbvh"))
    assert flat.num_tris == 50 and flat.nodes.shape[0] > 1
    np.testing.assert_array_equal(_bits(flat.nodes), _bits(ref.nodes))
    np.testing.assert_array_equal(flat.tri_index, ref.tri_index)


def test_small_scenes_take_the_median_route():
    """n < 2 and n <= max_leaf build no internal node on the device: both
    wrappers take the median builder, as the reference's do."""
    one = make_single_triangle()
    few = make_random_soup(n_tris=6, seed=1)
    cfg = host.BuildConfig(builder="lbvh", max_leaf_size=8)
    rcfg = RefBuildConfig(builder="lbvh", max_leaf_size=8)
    for scene in (one, few):
        flat = lbvh.build_lbvh_flat(scene, cfg, device="cpu")
        ref = ref_lbvh.build_lbvh_flat(scene, rcfg)
        np.testing.assert_array_equal(_bits(flat.nodes), _bits(ref.nodes))
        np.testing.assert_array_equal(_bits(flat.woop), _bits(ref.woop))
        pk = lbvh.build_lbvh_packed(scene, cfg, device="cpu")
        rpk = ref_lbvh.build_lbvh_packed(scene, rcfg)
        assert torch.is_tensor(pk.nodes8) and pk.num_nodes == rpk.num_nodes
        np.testing.assert_array_equal(_bits(pk.nodes8.numpy()),
                                      _bits(np.asarray(rpk.nodes8)))
        np.testing.assert_array_equal(_bits(pk.tris12.numpy()),
                                      _bits(np.asarray(rpk.tris12)))


def test_too_many_triangles_raise():
    """Tri ids ride float32 values: 2**24 triangles and more raise, in the
    builder and in both wrappers (before any array is made)."""
    n = 1 << 24
    lo = torch.zeros((1, 3)).expand(n, 3)
    with pytest.raises(ValueError):
        lbvh.lbvh_device_fast(lo, lo, torch.zeros((1, 3, 3)).expand(n, 3, 3),
                              torch.zeros(3), torch.ones(3))
    big = types.SimpleNamespace(num_tris=n)
    cfg = host.BuildConfig(builder="lbvh")
    for build in (lbvh.build_lbvh_packed, lbvh.build_lbvh_flat):
        with pytest.raises(ValueError):
            build(big, cfg, device="cpu")


def test_tables_from_device_checks():
    t = torch.zeros((8, 128))
    tb = tables_from_device(t, t, 3, 1, 12)
    assert tb.nodes8 is t and tb.num_nodes == 3 and tb.device == t.device
    with pytest.raises(ValueError):
        tables_from_device(torch.zeros((8, 64)), t, 3, 1, 12)
    with pytest.raises(ValueError):
        tables_from_device(t, t, 3, 1, 13)


# --- the frame ---------------------------------------------------------------

def test_lbvh_frame_matches_jax_renderer(monkeypatch):
    """Renderer(builder="lbvh") on the packed-direct path: the port builds
    the tables on its device and traces them with the packet kernel's
    plain version; the JAX renderer on its direct path (NTRACE_DIRECT=1)
    runs the Pallas kernel interpreted."""
    W, H = 64, 48
    scene = get_scene("conference@4000")
    cam = default_camera("conference")
    monkeypatch.setenv("NTRACE_DIRECT", "1")
    jr = JaxRenderer(scene, RefBuildConfig(builder="lbvh", max_leaf_size=32),
                     RefRenderConfig(width=W, height=H, mode="primary",
                                     engine="auto"))
    assert jr._direct
    ref = jr.render(cam)
    r = Renderer(scene, host.BuildConfig(builder="lbvh", max_leaf_size=32),
                 host.RenderConfig(width=W, height=H, mode="primary",
                                   engine="auto"), device="cpu")
    assert r.flat is None and r.timer.ms()["build"] > 0
    np.testing.assert_array_equal(_bits(r.tables.nodes8.numpy()),
                                  _bits(np.asarray(jr.packed.nodes8)))
    np.testing.assert_array_equal(_bits(r.tables.tris12.numpy()),
                                  _bits(np.asarray(jr.packed.tris12)))
    res = r.render(cam)
    np.testing.assert_array_equal(res.hit_tri, np.asarray(ref.hit_tri))
    np.testing.assert_allclose(res.image, np.asarray(ref.image), atol=1e-6,
                               rtol=0)
    assert (res.hit_tri >= 0).mean() > 0.5
    # Hits exact against brute force on every 7th pixel.
    from ntrace_tpu_torch.ray import raygen
    ca = raygen.camera_arrays(cam, W, H, "cpu")
    ids = torch.arange(W * H, dtype=torch.int32)
    batch = raygen.primary(ca, W, H, ids)
    sub = np.arange(0, W * H, 7)
    rays = [a.numpy()[sub] for a in (batch.orig, batch.dirn, batch.tmin,
                                     batch.tmax)]
    bf = host.brute_force_mt(scene, *rays)
    np.testing.assert_array_equal(res.hit_tri[sub], bf.tri)


def test_other_engines_take_the_flat_route():
    scene = get_scene("conference@4000")
    bc = host.BuildConfig(builder="lbvh", max_leaf_size=32)
    r = Renderer(scene, bc, host.RenderConfig(width=16, height=16,
                                              engine="wavefront"),
                 device="cpu")
    assert r.flat is not None and r.engine == "packet"
    with pytest.raises(NotImplementedError, match="kdtree"):
        build_accel(scene, host.BuildConfig(builder="kdtree"), device="cpu")


# --- on the card ----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (8, 257), (31, 8193)])
def test_row_scan_kernel_on_cuda(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    x = torch.from_numpy(np.random.default_rng(2).integers(
        -2**31, 2**31 - 1, size=shape, dtype=np.int32)).cuda()
    for op in pscan.OPS:
        for rev in (False, True):
            before = pscan.row_scan_i32.launches
            got = pscan.row_scan_i32(x, op=op, reverse=rev)
            torch.cuda.synchronize()
            assert pscan.row_scan_i32.launches == before + 1
            assert torch.equal(got, pscan.row_scan_i32_ref(
                x, op=op, reverse=rev))


@pytest.mark.cuda
def test_lbvh_build_on_cuda_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    args = _args(get_scene("conference@4000"))
    cpu = _port(args, max_leaf=32, emit="packed")
    t = [torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda()
         for a in args]
    before = pscan.row_scan_i32.launches
    boxes_before = child_boxes.launches
    out = lbvh.lbvh_device_fast(*t, max_leaf=32, emit="packed")
    assert pscan.row_scan_i32.launches == before + 4
    assert child_boxes.launches == boxes_before + 1
    gpu = {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
           for k, v in out.items()}
    assert_bit_equal(cpu, gpu, PACKED_KEYS)


@pytest.mark.cuda
def test_kept_neighbours_on_cuda_at_hairball_size():
    """At the hairball's 2,900,402 rows the kernel's kept neighbours are
    bit-equal to the plain version's (torch.cummax / cummin), on the
    build's own mask and on random ones; a build launches the row scan 4
    times."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    n = 2_900_402
    masks = [_kept_mask(c, n).cuda() for c in ("none", "every", "row1",
                                               "last", "random0.01",
                                               "random0.3")]
    t = lbvh.device_inputs(host.get_scene("hairball"), "cuda")
    assert t[0].shape[0] == n
    before = pscan.row_scan_i32.launches
    out = lbvh.lbvh_device_fast(*t, max_leaf=32, emit="packed")
    assert pscan.row_scan_i32.launches == before + 4
    for kept in [out["kept"]] + masks:
        before = pscan.row_scan_i32.launches
        got = lbvh.kept_neighbours(kept)
        assert pscan.row_scan_i32.launches == before + 2
        want = lbvh.kept_neighbours(kept, pscan.row_scan_i32_ref)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_the_port_reads_no_ntrace_direct(monkeypatch):
    """The port's direct path needs no test hook: with NTRACE_DIRECT unset
    the renderer still builds on its device."""
    monkeypatch.delenv("NTRACE_DIRECT", raising=False)
    r = Renderer(get_scene("conference@4000"),
                 host.BuildConfig(builder="lbvh", max_leaf_size=32),
                 host.RenderConfig(width=16, height=16, engine="packet"),
                 device="cpu")
    assert r.flat is None and r.tables.num_nodes > 0
