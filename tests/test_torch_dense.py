"""The port's dense screen-space primary engine against the JAX reference.

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs its Pallas kernels in interpret mode on the CPU; the port runs
`trace_dense_rows_ref`, the plain version of its CUDA kernels.

Tolerances, and why:
- Integer results (bin rectangles, pair counts, tile ranges, hit ids,
  the `ok` flag) and the prep's tiles are bit-equal to the reference.
- XLA on the CPU contracts a*b + c into fused multiply-adds; the port,
  like `brute_force_mt` and the CUDA kernels (nvcc --fmad=false), does not.
  So float results that go through such sums are compared with tolerances
  against JAX: `_counts`' zmin within 4 ulp (rtol 5e-7), while the 12 z
  bits the prep keeps of it are exact; hit t/u/v with the reference's own
  dense-test tolerances (tests/test_binraster_dense.py:53-55). On hits the
  port's t/u/v are bit-equal to `brute_force_mt`, and misses carry the
  exact miss record (t = tmax, u = v = 0).
- The renderer's image within atol 1e-6, as tests/test_torch_render.py.
- The visit list (`visit_cap`, `build_visit_list`) is integer and equal to
  the reference's; the visit-list twin is bit-equal to the walk twin.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntrace_tpu.bvh.golden import brute_force_mt
from ntrace_tpu.core import BuildConfig, Camera, RenderConfig
from ntrace_tpu.ops.morton import _part1by1
from ntrace_tpu.ray import raygen as jax_raygen
from ntrace_tpu.ray.pixeltable import pixel_table
from ntrace_tpu.render import renderer as jax_renderer
from ntrace_tpu.scenes import default_camera, get_scene, make_random_soup
from ntrace_tpu.trace import binraster as jax_br
from ntrace_tpu.trace import binraster_dense as jax_bd
from ntrace_tpu_torch.kernels import build as kbuild
from ntrace_tpu_torch.ops.morton import part1by1
from ntrace_tpu_torch.ray import raygen
from ntrace_tpu_torch.render import renderer as port
from ntrace_tpu_torch.render.renderer import Renderer
from ntrace_tpu_torch.trace import binraster as br
from ntrace_tpu_torch.trace import binraster_dense as bd

# (width, height, camera position, forward, soup triangles, seed)
FRONT = (64, 64, (0.0, 0.0, 4.0), (0.0, 0.0, -1.0), 300, 7)
OBLIQUE = (64, 48, (2.5, 1.5, 3.0), (-0.6, -0.35, -1.0), 500, 23)
INSIDE = (64, 64, (0.0, 0.0, 0.0), (0.3, -0.2, -1.0), 400, 37)
# k_cap 2 sends every triangle that covers more than 2 of the 16 bins to
# the walked global tier; at the default 64 a 64 x 64 frame has none.
GLOBAL_K_CAP = 2


class Frame:
    """One soup and camera, as numpy-made inputs for both packages."""

    def __init__(self, W, H, pos, fwd, n_tris, seed):
        self.W, self.H = W, H
        self.scene = make_random_soup(n_tris=n_tris, seed=seed)
        cam = Camera(position=pos, forward=fwd, up=(0.0, 1.0, 0.0),
                     fov_deg=70.0, znear=1e-3, zfar=1e4)
        self.jcam = jax_raygen.camera_arrays(cam, W, H)
        self.cam = raygen.camera_arrays(cam, W, H, "cpu")
        order, _ = pixel_table(W, H)
        rb = jax_raygen.primary(self.jcam, W, H, order)
        self.rays = [np.array(a) for a in (rb.orig, rb.dirn, rb.tmin,
                                           rb.tmax)]
        self.verts = np.ascontiguousarray(self.scene.tri_verts())

    def port_verts(self):
        return torch.from_numpy(self.verts.copy())

    def jax_dense(self, **kw):
        out = jax_bd.trace_dense_primary(
            jnp.asarray(self.verts), self.jcam, jnp.asarray(self.rays[1]),
            width=self.W, height=self.H, interpret=True, sort_mode="v5",
            **kw)
        return [np.asarray(a) for a in out]

    def port_dense(self, **kw):
        out = bd.trace_dense_primary(
            self.port_verts(), self.cam, torch.from_numpy(self.rays[1]),
            width=self.W, height=self.H, **kw)
        return [a.numpy() for a in out]

    def brute(self):
        return brute_force_mt(self.scene, *self.rays)


_FRAMES = {}


def frame(spec) -> Frame:
    if spec not in _FRAMES:
        _FRAMES[spec] = Frame(*spec)
    return _FRAMES[spec]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_hits_match(got, ref_jax, bf, tmax):
    tri, t, u, v = got
    np.testing.assert_array_equal(tri, ref_jax[0])
    np.testing.assert_array_equal(tri, bf.tri)
    hit = bf.tri >= 0
    assert hit.sum() > 100
    for a, b in zip((t, u, v), (bf.t, bf.u, bf.v)):
        np.testing.assert_array_equal(_bits(a[hit]), _bits(b[hit]))
    np.testing.assert_allclose(t[hit], ref_jax[1][hit], rtol=1e-5, atol=1e-6)
    for a, b in zip((u, v), ref_jax[2:]):
        np.testing.assert_allclose(a[hit], b[hit], rtol=1e-3, atol=2e-4)
    np.testing.assert_array_equal(_bits(t[~hit]), _bits(tmax[~hit]))
    assert not u[~hit].any() and not v[~hit].any()
    for a, b in zip(got[1:], ref_jax[1:]):
        np.testing.assert_array_equal(_bits(a[~hit]), _bits(b[~hit]))


# -- host helpers and the shared projection stage --------------------------


def test_part1by1_matches_reference():
    v = np.random.default_rng(3).integers(0, 1 << 16, size=4096,
                                          dtype=np.int64)
    v[:3] = (0, 1, (1 << 16) - 1)
    ref = _part1by1(np, v.astype(np.int32))
    got = part1by1(torch.from_numpy(v.astype(np.int32))).numpy()
    np.testing.assert_array_equal(got, ref.astype(np.int64))


@pytest.mark.parametrize("txn,tyn", [(4, 4), (4, 3), (64, 48)])
def test_arming_helpers_match_reference(txn, tyn):
    np.testing.assert_array_equal(bd.bin_mcodes(txn, tyn, 19),
                                  jax_bd.bin_mcodes(txn, tyn, 19))
    hist = np.array([5000, 3100, 900, 88, 3, 0, 0], np.int64) * txn
    assert bd.pick_nks(hist) == jax_bd.pick_nks(hist)
    for total in (0, 1, 87, 462_000):
        assert (bd.pick_cap(total, 16 * bd.TPT)
                == jax_bd.pick_cap(total, 16 * jax_bd.TPT))
    assert (bd.GPT, bd.GROUPS, bd.TPT, bd.CPL) == (
        jax_bd.GPT, jax_bd.GROUPS, jax_bd.TPT, jax_bd.CPL)
    assert br.INF == jax_br.INF and br.Z_MARGIN == jax_br.Z_MARGIN


@pytest.mark.parametrize("spec", [FRONT, OBLIQUE, INSIDE],
                         ids=["front", "oblique", "inside"])
def test_counts_match_reference(spec):
    f = frame(spec)
    kw = dict(width=f.W, height=f.H, tile=16)
    ref = [np.asarray(a) for a in jax_br._counts(jnp.asarray(f.verts),
                                                  f.jcam, **kw)]
    got = [a.numpy() for a in br._counts(f.port_verts(), f.cam, **kw)]
    names = "tx0 tx1 ty0 ty1 cnt".split()
    for name, a, b in zip(names, got, ref):
        assert a.dtype == np.int32
        bad = np.nonzero(a != b)[0]
        assert not len(bad), f"{name} differs on triangles {bad[:10]}"
    zmin, zref = got[5], ref[5]
    np.testing.assert_allclose(zmin, zref, rtol=5e-7, atol=0)

    def zbits(z):   # the truncated z the prep keys on (z_bits 12)
        zs = np.maximum(z * (np.float32(1.0) - br.Z_MARGIN), np.float32(0))
        return (zs.view(np.int32) >> 20) & 0xFFF

    bad = np.nonzero(zbits(zmin) != zbits(zref))[0]
    assert not len(bad), f"prep z key differs on triangles {bad[:10]}"
    assert (got[4] > 0).sum() > 50


# -- prep v5 ---------------------------------------------------------------


def _prep_args(f, k_cap):
    kw = dict(width=f.W, height=f.H, tile=16)
    _, hist, _ = jax_bd.count_hist_dense(jnp.asarray(f.verts), f.jcam,
                                         k_cap=k_cap, **kw)
    _, n_mid, n_g = (int(x) for x in jax_bd.count_pairs_dense(
        jnp.asarray(f.verts), f.jcam, k_slots=k_cap, k2_slots=k_cap, **kw))
    n_ks = jax_bd.pick_nks(np.asarray(hist))
    return dict(kw, k_cap=k_cap, n_ks=n_ks, z_bits=12,
                p_max=jax_bd.pick_cap(sum(n_ks), 16 * jax_bd.TPT),
                g2_max=jax_bd.pick_cap(n_g, jax_bd.TPT, pad=jax_bd.TPT)
                if n_g else 0), np.asarray(hist), n_g


@pytest.mark.parametrize("spec,k_cap", [
    (FRONT, 64), (OBLIQUE, 64), (INSIDE, 64), (INSIDE, GLOBAL_K_CAP),
    (OBLIQUE, GLOBAL_K_CAP)],
    ids=["front", "oblique", "inside", "inside-global", "oblique-global"])
def test_prep_v5_matches_reference(spec, k_cap):
    f = frame(spec)
    args, hist, n_g = _prep_args(f, k_cap)
    kw = dict(width=f.W, height=f.H, tile=16)
    ptotal, phist, png = bd.count_hist_dense(f.port_verts(), f.cam,
                                             k_cap=k_cap, **kw)
    np.testing.assert_array_equal(phist.numpy(), hist)
    counts = bd.count_pairs_dense(f.port_verts(), f.cam, k_slots=k_cap,
                                  k2_slots=k_cap, **kw)
    assert int(counts[2]) == int(png) == n_g
    assert (n_g > 0) == (k_cap == GLOBAL_K_CAP)
    mcodes = jax_bd.bin_mcodes(f.W // 16, f.H // 16, 19)
    ref = jax_bd.binraster_prep_dense5(jnp.asarray(f.verts), f.jcam,
                                       jnp.asarray(mcodes), **args)
    got = bd.binraster_prep_dense5(f.port_verts(), f.cam,
                                   torch.from_numpy(mcodes), **args)
    for name, a, b in zip("rows row0 row1 g_r1 ok".split(), got, ref):
        if b is None:
            assert a is None, name
            continue
        a = a.numpy()
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    assert bool(got[4])
    if n_g:
        assert int(got[3][0]) >= 1


def test_prep_overflow_poisons():
    # p_max 88 < one pair per triangle: ok is False, every hit is -2.
    f = frame(FRONT)
    tri, *_ = f.port_dense(tile=16, p_max=88)
    assert (tri == -2).all()


# -- the whole engine (prep + kernel twin) ---------------------------------


_JAX_HITS = {}


def jax_hits(spec, k_cap):
    """The reference's trace_dense_primary (v5 prep, walk kernel, early-z
    off, interpret mode) of a frame, computed once. Its own tests hold it
    to brute_force_mt at every kernel and ez_chunk, and interpret mode
    costs seconds per call, so every port variant is held to this one."""
    if (spec, k_cap) not in _JAX_HITS:
        _JAX_HITS[spec, k_cap] = frame(spec).jax_dense(
            tile=16, k_cap=k_cap, kernel="walk", ez_chunk=0)
    return _JAX_HITS[spec, k_cap]


@pytest.mark.parametrize("spec,kernel,ez_chunk,k_cap", [
    (FRONT, "walk", 0, 64), (FRONT, "walk", 4, 64), (FRONT, "dma", 0, 64),
    (INSIDE, "walk", 4, GLOBAL_K_CAP), (INSIDE, "dma", 0, GLOBAL_K_CAP),
    (FRONT, "visits", 0, 64), (INSIDE, "visits", 0, GLOBAL_K_CAP)],
    ids=["front-walk-ez0", "front-walk-ez4", "front-dma",
         "inside-global-walk-ez4", "inside-global-dma", "front-visits",
         "inside-global-visits"])
def test_trace_dense_primary_matches_reference(spec, kernel, ez_chunk,
                                               k_cap):
    f = frame(spec)
    got = f.port_dense(tile=16, k_cap=k_cap, kernel=kernel,
                       ez_chunk=ez_chunk)
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    _assert_hits_match(got, jax_hits(spec, k_cap), f.brute(), f.rays[3])


def test_twin_is_visit_order_invariant():
    # The plain version reduces in chunks of visits; one visit per chunk
    # must give the same bits as all visits in one chunk.
    f = frame(INSIDE)
    args, _, _ = _prep_args(f, GLOBAL_K_CAP)
    mcodes = torch.from_numpy(jax_bd.bin_mcodes(f.W // 16, f.H // 16, 19))
    rows, r0, r1, g1, ok = bd.binraster_prep_dense5(
        f.port_verts(), f.cam, mcodes, **args)
    dirs, scalars = br.dense_rays(torch.from_numpy(f.rays[1]),
                                  f.cam["pos"], f.cam["znear"],
                                  f.cam["zfar"], 16, 2)
    ops = (rows, r0, r1, dirs, scalars, g1)
    whole = bd.trace_dense_rows_ref(*ops, n_bins=16, ray_rows=2)
    old = br.REF_CHUNK
    try:
        br.REF_CHUNK = 1
        one = bd.trace_dense_rows_ref(*ops, n_bins=16, ray_rows=2)
    finally:
        br.REF_CHUNK = old
    for a, b in zip(whole, one):
        assert torch.equal(a, b)


def test_unported_options_raise():
    f = frame(FRONT)
    with pytest.raises(NotImplementedError, match="v5"):
        f.port_dense(sort_mode="s11")


# -- the visit list --------------------------------------------------------


def _structure(f, k_cap):
    """Prep v5 of a frame (port), with its static sizes."""
    args, _, _ = _prep_args(f, k_cap)
    mcodes = torch.from_numpy(jax_bd.bin_mcodes(f.W // 16, f.H // 16, 19))
    out = bd.binraster_prep_dense5(f.port_verts(), f.cam, mcodes, **args)
    return out, args


@pytest.mark.parametrize("spec,k_cap", [(FRONT, 64), (INSIDE, GLOBAL_K_CAP),
                                        (OBLIQUE, 64)],
                         ids=["front", "inside-global", "oblique"])
def test_visit_list_matches_reference(spec, k_cap):
    f = frame(spec)
    (rows, r0, r1, g1, _), args = _structure(f, k_cap)
    nb = (f.W // 16) * (f.H // 16)
    for p_max, g2 in ((args["p_max"], args["g2_max"]), (88, 0),
                      (10 * 88, 88)):
        assert bd.visit_cap(p_max, nb, g2) == jax_bd.visit_cap(p_max, nb, g2)
    v_cap = bd.visit_cap(args["p_max"], nb, args["g2_max"])
    got = bd.build_visit_list(r0, r1, g1, v_cap=v_cap, nb=nb)
    ref = jax_bd.build_visit_list(
        jnp.asarray(r0.numpy()), jnp.asarray(r1.numpy()),
        None if g1 is None else jnp.asarray(g1.numpy()), v_cap=v_cap, nb=nb)
    for a, b in zip(got, ref):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert (got[1].numpy() == np.arange(nb)[:, None]).any(1).all()


@pytest.mark.parametrize("v_cap", [16, 24, 40])
def test_visit_list_edge_cases_match_reference(v_cap):
    """Empty bins (floor visits), an empty trailing bin whose row0 is the
    tile count (its floor visit points one past the table), a global
    prefix, and a list longer or shorter than the visits."""
    row0 = torch.tensor([0, 2, 2, 5, 6], dtype=torch.int32)
    row1 = torch.tensor([2, 2, 5, 6, 6], dtype=torch.int32)
    for g1 in (None, torch.tensor([1], dtype=torch.int32)):
        got = bd.build_visit_list(row0, row1, g1, v_cap=v_cap, nb=5)
        ref = jax_bd.build_visit_list(
            jnp.asarray(row0.numpy()), jnp.asarray(row1.numpy()),
            None if g1 is None else jnp.asarray(g1.numpy()), v_cap=v_cap,
            nb=5)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("spec,k_cap", [(FRONT, 64), (INSIDE, GLOBAL_K_CAP)],
                         ids=["front", "inside-global"])
def test_visits_twin_matches_walk_twin(spec, k_cap):
    f = frame(spec)
    ops, kw = _frozen_ops(f, k_cap)
    rows, r0, r1, dirs, scalars, g1 = ops
    args, _, _ = _prep_args(f, k_cap)
    v_cap = bd.visit_cap(args["p_max"], kw["n_bins"], args["g2_max"])
    vt, vb = bd.build_visit_list(r0, r1, g1, v_cap=v_cap, nb=kw["n_bins"])
    walk = bd.trace_dense_rows_ref(*ops, **kw)
    got = bd.trace_dense_visits(rows, vt, vb, dirs, scalars, **kw)
    for a, b in zip(got, walk):
        assert torch.equal(a, b)
    # A visit past the table is clamped to its last tile, as the kernel
    # does: the same result as a visit of that tile.
    nt = rows.shape[0] // bd.GPT
    past = bd.trace_dense_visits_ref(rows, torch.full_like(vt, nt), vb,
                                     dirs, scalars, **kw)
    last = bd.trace_dense_visits_ref(rows, torch.full_like(vt, nt - 1), vb,
                                     dirs, scalars, **kw)
    for a, b in zip(past, last):
        assert torch.equal(a, b)


def test_visits_match_jax_kernel():
    # One interpret-mode run of the reference's visit-list kernel on the
    # frozen structure: the same hit ids.
    f = frame(FRONT)
    ops, kw = _frozen_ops(f)
    rows, r0, r1, dirs, scalars, g1 = ops
    args, _, _ = _prep_args(f, 64)
    v_cap = bd.visit_cap(args["p_max"], kw["n_bins"], args["g2_max"])
    vt, vb = bd.build_visit_list(r0, r1, g1, v_cap=v_cap, nb=kw["n_bins"])
    got = bd.trace_dense_visits(rows, vt, vb, dirs, scalars, **kw)
    ref = jax_bd.trace_dense_visits(
        *(jnp.asarray(a.numpy()) for a in (rows, vt, vb, dirs, scalars)),
        interpret=True, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    assert (got[0] >= 0).sum() > 100


# -- kernel wrappers: routing, binding, and the card ------------------------


def _frozen_ops(f, k_cap=64):
    args, _, _ = _prep_args(f, k_cap)
    mcodes = torch.from_numpy(jax_bd.bin_mcodes(f.W // 16, f.H // 16, 19))
    rows, r0, r1, g1, _ = bd.binraster_prep_dense5(
        f.port_verts(), f.cam, mcodes, **args)
    nb = (f.W // 16) * (f.H // 16)
    dirs, scalars = br.dense_rays(torch.from_numpy(f.rays[1]),
                                  f.cam["pos"], f.cam["znear"],
                                  f.cam["zfar"], nb, 2)
    return (rows, r0, r1, dirs, scalars, g1), dict(n_bins=nb, ray_rows=2)


@pytest.mark.parametrize("wrapper,entry", [
    ("trace_dense_rows", "ntrace_dense_walk"),
    ("trace_dense_rows_dma", "ntrace_dense_dma")])
def test_cuda_input_never_reaches_twin(monkeypatch, wrapper, entry):
    """A tensor the device policy routes to the kernel launches it (or
    raises); the twin is never called. CUDA is mocked where absent."""
    ops, kw = _frozen_ops(frame(OBLIQUE))
    launched = []

    def twin(*a, **k):
        raise AssertionError("a kernel-routed tensor reached the twin")

    def fake_run(name, *a):
        launched.append(name)
        return ()

    monkeypatch.setattr(bd, "trace_dense_rows_ref", twin)
    monkeypatch.setattr(bd, "uses_kernel", lambda t: True)
    monkeypatch.setattr(bd, "_run", fake_run)
    fn = getattr(bd, wrapper)
    before = fn.launches
    fn(*ops, **kw)
    assert launched == [entry] and fn.launches == before + 1

    def failing_run(*a):
        raise RuntimeError(f"{entry} launch failed")

    monkeypatch.setattr(bd, "_run", failing_run)
    with pytest.raises(RuntimeError):
        fn(*ops, **kw)
    assert fn.launches == before + 1


def test_visits_input_never_reaches_twin(monkeypatch):
    ops, kw = _frozen_ops(frame(OBLIQUE))
    rows, r0, r1, dirs, scalars, g1 = ops
    vt, vb = bd.build_visit_list(r0, r1, g1, v_cap=64, nb=kw["n_bins"])
    launched = []

    def twin(*a, **k):
        raise AssertionError("a kernel-routed tensor reached the twin")

    def fake_launch(name, ints, tensors, n, dev):
        launched.append((name, ints, len(tensors)))
        return ()

    monkeypatch.setattr(bd, "trace_dense_visits_ref", twin)
    monkeypatch.setattr(bd, "uses_kernel", lambda t: True)
    monkeypatch.setattr(bd, "launch", fake_launch)
    before = bd.trace_dense_visits.launches
    bd.trace_dense_visits(rows, vt, vb, dirs, scalars, **kw)
    assert launched == [("ntrace_dense_visits",
                         (64, kw["n_bins"], 2, rows.shape[0] // bd.GPT), 6)]
    assert bd.trace_dense_visits.launches == before + 1
    bad = scalars.clone()
    bad[3] = -1.0
    with pytest.raises(ValueError, match="tmin"):
        bd.trace_dense_visits(rows, vt, vb, dirs, bad, **kw)
    with pytest.raises(TypeError):
        bd.trace_dense_visits(rows, vt.long(), vb, dirs, scalars, **kw)
    with pytest.raises(ValueError):
        bd.trace_dense_visits(rows, vt, vb[:-1], dirs, scalars, **kw)
    assert bd.trace_dense_visits.launches == before + 1


def test_wrappers_reject_bad_operands():
    ops, kw = _frozen_ops(frame(OBLIQUE))
    rows, r0, r1, dirs, scalars, g1 = ops
    with pytest.raises(TypeError):
        bd.trace_dense_rows(rows, r0.long(), r1, dirs, scalars, g1, **kw)
    with pytest.raises(ValueError):
        bd.trace_dense_rows(rows[:5], r0, r1, dirs, scalars, g1, **kw)
    with pytest.raises(ValueError):
        bd.trace_dense_rows_dma(rows, r0, r1, dirs[:-1], scalars, g1, **kw)
    with pytest.raises(ValueError):
        bd.trace_dense_rows(*ops, ez_chunk=-1, **kw)


def test_c_entry_points_match_ctypes_signatures():
    """Each extern "C" function of csrc/*.cu takes the arguments its ctypes
    binding declares, in order and by kind: a pointer as c_void_p, an int
    as c_int, a long long as c_longlong, a uint32_t as c_uint32, a float
    as c_float (nothing compiles the sources here). The traversal kernels define theirs with trace_common.cuh's
    NTRACE_TRAVERSAL_ENTRY(name, kernel), whose one signature counts for
    each name."""
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
    def kind(arg: str):
        arg = " ".join(arg.replace("\\", " ").split())   # macro lines
        if "*" in arg or arg.startswith("cudaStream_t "):
            return ctypes.c_void_p
        if arg.startswith("long long "):
            return ctypes.c_longlong
        if arg.startswith("uint32_t "):
            return ctypes.c_uint32
        if arg.startswith("float "):
            return ctypes.c_float
        return ctypes.c_int if arg.startswith("int ") else arg

    found = {}
    for src in kbuild.sources() + [kbuild.CSRC_DIR / "trace_common.cuh"]:
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)',
                             src.read_text()):
            found[m.group(1)] = [kind(a) for a in m.group(2).split(",")
                                 if a.strip()]
    per_entry = found.pop("NAME")
    for src in kbuild.sources():
        for m in re.finditer(r"^NTRACE_TRAVERSAL_ENTRY\((\w+), \w+\)$",
                             src.read_text(), re.MULTILINE):
            found[m.group(1)] = per_entry
    assert found == {k: v[1] for k, v in kbuild.SIGNATURES.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("spec,k_cap", [(FRONT, 64), (INSIDE, GLOBAL_K_CAP)],
                         ids=["front", "inside-global"])
def test_kernels_match_twin_on_cuda(spec, k_cap):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    ops, kw = _frozen_ops(frame(spec), k_cap)
    twin = bd.trace_dense_rows_ref(*ops, **kw)
    dev = [None if a is None else a.cuda() for a in ops]
    rows, r0, r1, dirs, scalars, g1 = dev
    args, _, _ = _prep_args(frame(spec), k_cap)
    vt, vb = bd.build_visit_list(
        r0, r1, g1, v_cap=bd.visit_cap(args["p_max"], kw["n_bins"],
                                       args["g2_max"]), nb=kw["n_bins"])
    for out in (bd.trace_dense_rows(*dev, ez_chunk=0, **kw),
                bd.trace_dense_rows(*dev, ez_chunk=4, **kw),
                bd.trace_dense_rows_dma(*dev, **kw),
                bd.trace_dense_visits(rows, vt, vb, dirs, scalars, **kw)):
        torch.cuda.synchronize()
        for a, b in zip(out, twin):
            assert torch.equal(a.cpu(), b)


# -- the renderer ----------------------------------------------------------


W, H = 64, 48
BUILD = BuildConfig(builder="binned_sah")


@pytest.fixture(scope="module")
def conference():
    scene = get_scene("conference", n_tris=2000)
    return scene, port.build_accel(scene, BUILD)


def _armed(conference, dense_kernel="walk"):
    scene, flat = conference
    cfg = RenderConfig(width=W, height=H, mode="primary",
                       engine="binraster_dense")
    r = Renderer(scene, BUILD, cfg, flat=flat, device="cpu",
                 dense_kernel=dense_kernel)
    cam = default_camera("conference")
    ca = raygen.camera_arrays(cam, W, H, "cpu")
    order, _ = pixel_table(W, H)
    batch = raygen.primary(ca, W, H, torch.from_numpy(order.copy()))
    assert r.prepare_primary(ca, W, H)
    assert r.engine == "packet" and isinstance(r.screen, bd.DenseEngine)
    return r, ca, batch


def test_renderer_dense_matches_jax(conference, monkeypatch):
    scene, flat = conference
    # The JAX renderer pinned to the port's settings (tuned.json's
    # br2_* entries; the port reads no tuned.json).
    monkeypatch.setattr(jax_renderer, "_load_tuned", lambda: {
        "br2_tile": 16, "br2_ez": 0, "br2_tpv": 1, "br2_sort": "v5",
        "br2_kcap": 64, "br2_kernel": "walk"})
    cfg = RenderConfig(width=W, height=H, mode="primary",
                       engine="binraster_dense")
    cam = default_camera("conference")
    jr = jax_renderer.Renderer(scene, BUILD, cfg, flat=flat)
    ref = jr.render(cam)
    r = Renderer(scene, BUILD, cfg, flat=flat, device="cpu")
    before = bd.binraster_prep_dense5.calls
    got = r.render(cam)
    assert bd.binraster_prep_dense5.calls == before + 1
    assert jr._br is not None and r.screen.armed
    assert r.screen.sizes["p_max"] == jr._br["p_max"]
    assert r.screen.sizes["n_ks"] == jr._br["n_ks"]
    np.testing.assert_array_equal(got.hit_tri, ref.hit_tri)
    np.testing.assert_allclose(got.image, ref.image, rtol=0, atol=1e-6)
    assert (got.hit_tri >= 0).mean() > 0.5 and not (got.hit_tri == -2).any()


@pytest.mark.parametrize("kernel", ["dma", "visits"])
def test_dense_and_packet_frames_agree(conference, kernel):
    r, ca, batch = _armed(conference, dense_kernel=kernel)
    assert "v_cap" in r.screen.sizes
    rays = (batch.orig, batch.dirn, batch.tmin, batch.tmax)
    dense = r.trace_primary(*rays, cam=ca, canonical=True)
    bvh = r.trace_primary(*rays, cam=ca, canonical=False)
    assert torch.equal(dense[0], bvh[0])
    hit = dense[0] >= 0
    assert torch.equal(dense[1][hit], bvh[1][hit])


def test_canonical_true_on_broken_rays_raises(conference):
    r, ca, batch = _armed(conference)
    bad_tmin = batch.tmin.clone()
    bad_tmin[7] += 0.5
    with pytest.raises(ValueError, match="canonical"):
        r.trace_primary(batch.orig, batch.dirn, bad_tmin, batch.tmax,
                        cam=ca, canonical=True)
    # canonical=None checks the contract and takes the BVH path instead
    before = bd.binraster_prep_dense5.calls
    tri, *_ = r.trace_primary(batch.orig, batch.dirn, bad_tmin, batch.tmax,
                              cam=ca)
    assert bd.binraster_prep_dense5.calls == before
    assert (tri >= 0).any()


@pytest.mark.parametrize("gate", ["pair-count", "p_max"])
def test_pair_budget_declines_arming(conference, monkeypatch, gate):
    r, ca, batch = _armed(conference)
    if gate == "pair-count":
        monkeypatch.setattr(
            bd, "count_pairs_dense",
            lambda *a, **k: (torch.tensor(3_000_000), torch.tensor(0),
                             torch.tensor(0)))
    else:
        # The exact count fits the budget but the armed p_max, sized over
        # the quantised slices, does not: the reference would arm here
        # (ADVICE r5, renderer.py:1009); the port declines.
        total, n_mid, _ = (int(x) for x in bd.count_pairs_dense(
            r.screen.verts, ca, width=W, height=H, tile=16, k_slots=64))
        assert r.screen.sizes["p_max"] > total + n_mid
        monkeypatch.setattr(r.screen, "max_pairs", total + n_mid)
    assert not r.prepare_primary(ca, W, H)
    assert not r.screen.armed
    tri, *_ = r.trace_primary(batch.orig, batch.dirn, batch.tmin,
                              batch.tmax, cam=ca, canonical=True)
    assert (tri >= 0).float().mean() > 0.5


def test_frozen_structure_staleness_guard(conference):
    r, ca, batch = _armed(conference)
    rays = (batch.orig, batch.dirn, batch.tmin, batch.tmax)
    r.freeze_primary_structure(ca)
    before = bd.binraster_prep_dense5.calls
    frozen = r.trace_primary(*rays, cam=ca, canonical=True)
    assert bd.binraster_prep_dense5.calls == before   # the frozen tiles

    # Rotated in place: the same position, so the ray contract holds, but
    # the frozen bins are stale. The guard must re-prep.
    base = default_camera("conference")
    cam2 = Camera(position=base.position,
                  forward=base.forward + np.float32([0.08, 0.02, 0.0]),
                  up=base.up, fov_deg=base.fov_deg, znear=base.znear,
                  zfar=base.zfar)
    ca2 = raygen.camera_arrays(cam2, W, H, "cpu")
    assert torch.equal(ca["pos"], ca2["pos"])
    order, _ = pixel_table(W, H)
    b2 = raygen.primary(ca2, W, H, torch.from_numpy(order.copy()))
    rays2 = (b2.orig, b2.dirn, b2.tmin, b2.tmax)
    got = r.trace_primary(*rays2, cam=ca2, canonical=True)
    assert bd.binraster_prep_dense5.calls == before + 1
    ref = r.trace_primary(*rays2, cam=ca2, canonical=False)
    assert (got[0] >= 0).any() and not torch.equal(got[0], frozen[0])
    assert torch.equal(got[0], ref[0])
