"""The port's v1 screen-space primary engine against the JAX reference.

Inputs are made with numpy from a seed and handed to both sides. The JAX
side runs its Pallas kernel in interpret mode on the CPU; the port runs
`trace_binraster_rows_ref`, the plain version of its CUDA kernel.

Tolerances, and why:
- Integer results (bin order, Morton codes, static sizes, pair counts, row
  ranges, hit ids, `ok`) and the preps' rows are bit-equal to the
  reference: the prep's float lanes are single correctly rounded
  subtractions, its 21 z bits came out equal on every triangle of these
  frames, and `jax.lax.sort` is stable, as `torch.sort(stable=True)` is.
- Hits: tri/t/u/v bit-equal to `brute_force_mt` (the same Moller-Trumbore
  op order, no FMA contraction on either side); against the JAX engine,
  tri exactly (XLA on the CPU contracts a*b + c into FMAs, so its float
  hits differ in the last bits). Misses carry the exact miss record
  (t = tmax, u = v = 0).
- The renderer's image within atol 1e-6 of the JAX renderer's, as
  tests/test_torch_render.py.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntrace_tpu.bvh.golden import brute_force_mt
from ntrace_tpu.core import BuildConfig, Camera, RenderConfig
from ntrace_tpu.ray import raygen as jax_raygen
from ntrace_tpu.ray.pixeltable import pixel_table
from ntrace_tpu.scenes import default_camera, get_scene, make_random_soup
from ntrace_tpu.trace import binraster as jax_br
from ntrace_tpu_torch.kernels import build as kbuild
from ntrace_tpu_torch.ray import raygen
from ntrace_tpu_torch.render import renderer as port
from ntrace_tpu_torch.render.renderer import Renderer
from ntrace_tpu_torch.trace import binraster as br
from ntrace_tpu_torch.trace import binraster_dense as bd

# (width, height, camera position, forward, soup triangles, seed), the
# frames of tests/test_binraster.py
FRONT = (64, 64, (0.0, 0.0, 4.0), (0.0, 0.0, -1.0), 300, 7)
INSIDE = (64, 64, (0.0, 0.0, 0.2), (0.0, 0.0, -1.0), 800, 3)
OFFAXIS = (128, 64, (1.0, 1.0, 1.0), (-1.0, -1.0, -1.0), 1000, 5)
KSLOTS1 = (64, 64, (0.0, 0.0, 4.0), (0.0, 0.0, -1.0), 500, 11)
NOPAY = (64, 64, (0.0, 0.0, 4.0), (0.0, 0.0, -1.0), 400, 13)
CLOSE = (128, 128, (0.0, 0.0, 0.6), (0.0, 0.0, -1.0), 400, 17)
OBLIQUE = (96, 64, (2.5, 1.5, 3.0), (-0.6, -0.35, -1.0), 500, 23)


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
        self._bf = None

    def port_verts(self):
        return torch.from_numpy(self.verts.copy())

    def port(self, **kw):
        out = br.trace_binraster_primary(
            self.port_verts(), self.cam, torch.from_numpy(self.rays[1]),
            width=self.W, height=self.H, **kw)
        return [a.numpy() for a in out]

    def jax(self, **kw):
        out = jax_br.trace_binraster_primary(
            jnp.asarray(self.verts), self.jcam, jnp.asarray(self.rays[1]),
            width=self.W, height=self.H, interpret=True, **kw)
        return [np.asarray(a) for a in out]

    def brute(self):
        if self._bf is None:
            self._bf = brute_force_mt(self.scene, *self.rays)
        return self._bf

    def kw(self):
        return dict(width=self.W, height=self.H, tile=32)


_FRAMES = {}


def frame(spec) -> Frame:
    if spec not in _FRAMES:
        _FRAMES[spec] = Frame(*spec)
    return _FRAMES[spec]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _assert_brute_exact(got, f, min_hits=100):
    tri, t, u, v = got
    bf = f.brute()
    np.testing.assert_array_equal(tri, bf.tri)
    hit = bf.tri >= 0
    assert hit.sum() >= min_hits
    for a, b in zip((t, u, v), (bf.t, bf.u, bf.v)):
        np.testing.assert_array_equal(_bits(a[hit]), _bits(b[hit]))
    np.testing.assert_array_equal(_bits(t[~hit]), _bits(f.rays[3][~hit]))
    assert not u[~hit].any() and not v[~hit].any()


# -- helpers and counts -----------------------------------------------------


@pytest.mark.parametrize("txn,tyn", [(2, 2), (4, 2), (32, 24)])
def test_helpers_match_reference(txn, tyn):
    assert (br.TPB, br.ZLANE, br.INF, br.Z_MARGIN) == (
        jax_br.TPB, jax_br.ZLANE, jax_br.INF, jax_br.Z_MARGIN)
    np.testing.assert_array_equal(br.bin_order(txn, tyn),
                                  jax_br.bin_order(txn, tyn))
    got, ref = br._bin_mcodes(txn, tyn), jax_br._bin_mcodes(txn, tyn)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    for n in (0, 1, 95, 50_000, 462_000, 3_000_000):
        assert br.pick_pmax(n) == jax_br.pick_pmax(n)
        assert br.pick_gmax(n) == jax_br.pick_gmax(n)
        assert br.pick_gmax(n, floor=192) == jax_br.pick_gmax(n, floor=192)


def test_bin_mcodes_refuse_a_grid_past_10_bits():
    for fn in (br._bin_mcodes, jax_br._bin_mcodes):
        with pytest.raises(ValueError, match="31-bit"):
            fn(64, 48)


@pytest.mark.parametrize("spec,k_slots,k2_slots", [
    (FRONT, 8, 64), (INSIDE, 8, 64), (OBLIQUE, 8, 64), (CLOSE, 2, 4),
    (CLOSE, 1, 2), (CLOSE, 1, 1)],
    ids=["front", "inside", "oblique", "close-2-4", "close-1-2",
         "close-1-1"])
def test_counts_match_reference(spec, k_slots, k2_slots):
    f = frame(spec)
    jv = jnp.asarray(f.verts)
    got = br.count_pairs_fast(f.port_verts(), f.cam, k_slots=k_slots,
                              k2_slots=k2_slots, **f.kw())
    ref = jax_br.count_pairs_fast(jv, f.jcam, k_slots=k_slots,
                                  k2_slots=k2_slots, **f.kw())
    assert [int(x) for x in got] == [int(x) for x in ref]
    assert int(br.count_pairs(f.port_verts(), f.cam, **f.kw())) == int(
        jax_br.count_pairs(jv, f.jcam, **f.kw()))
    assert int(got[0]) > 20


# -- the preps --------------------------------------------------------------


def _fast_args(f, k_slots, k2_slots):
    total, n_mid, n_g = (int(x) for x in jax_br.count_pairs_fast(
        jnp.asarray(f.verts), f.jcam, k_slots=k_slots, k2_slots=k2_slots,
        **f.kw()))
    return dict(f.kw(), k_slots=k_slots, k2_slots=k2_slots,
                p_max=jax_br.pick_pmax(total),
                g_max=jax_br.pick_gmax(n_mid + n_g),
                g2_max=jax_br.pick_gmax(n_g, floor=192)), n_g


def _assert_same(got, ref, names):
    for name, a, b in zip(names, got, ref):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)


@pytest.mark.parametrize("payload", [True, False], ids=["payload", "gather"])
@pytest.mark.parametrize("spec,k_slots,k2_slots", [
    (FRONT, 8, 64), (OBLIQUE, 8, 64), (CLOSE, 1, 2), (CLOSE, 1, 1)],
    ids=["front", "oblique", "close-mid-and-global", "close-global"])
def test_prep_fast_matches_reference(spec, k_slots, k2_slots, payload):
    f = frame(spec)
    args, n_g = _fast_args(f, k_slots, k2_slots)
    mc = jax_br._bin_mcodes(f.W // 32, f.H // 32)
    ref = jax_br.binraster_prep_fast(jnp.asarray(f.verts), f.jcam,
                                     jnp.asarray(mc), payload=payload, **args)
    got = br.binraster_prep_fast(f.port_verts(), f.cam, torch.from_numpy(mc),
                                 payload=payload, **args)
    _assert_same(got, ref, "rows row0 row1 g_r1 ok".split())
    assert bool(got[4])
    assert (int(got[3][0]) > 0) == (n_g > 0)
    if spec == CLOSE:
        assert n_g > 0
    # lane 120 holds each row's least decoded zmin
    rows = got[0]
    assert torch.all(rows[:, br.ZLANE] > 0)


@pytest.mark.parametrize("spec", [FRONT, INSIDE, OBLIQUE],
                         ids=["front", "inside", "oblique"])
def test_prep_v0_matches_reference(spec):
    f = frame(spec)
    bo = jax_br.bin_order(f.W // 32, f.H // 32)
    p_max = jax_br.pick_pmax(int(jax_br.count_pairs(jnp.asarray(f.verts),
                                                    f.jcam, **f.kw())))
    ref = jax_br.binraster_prep(jnp.asarray(f.verts), f.jcam,
                                jnp.asarray(bo), p_max=p_max, **f.kw())
    got = br.binraster_prep(f.port_verts(), f.cam, torch.from_numpy(bo),
                            p_max=p_max, **f.kw())
    _assert_same(got, ref, "rows row0 row1 total".split())


# -- the whole engine (prep + kernel twin) ----------------------------------


@pytest.mark.parametrize("prep", ["fast", "v0"])
@pytest.mark.parametrize("ez_chunk,unroll", [(8, 4), (0, 2), (4, 1)])
def test_trace_matches_brute_force(ez_chunk, unroll, prep):
    f = frame(FRONT)
    got = f.port(ez_chunk=ez_chunk, unroll=unroll, prep=prep)
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    _assert_brute_exact(got, f)


@pytest.mark.parametrize("spec,kw", [
    (INSIDE, dict(prep="fast")), (INSIDE, dict(prep="v0")),
    (OFFAXIS, {}), (KSLOTS1, dict(k_slots=1)),
    (CLOSE, dict(k_slots=2, k2_slots=4)), (CLOSE, dict(k_slots=1,
                                                        k2_slots=1)),
    (NOPAY, dict(payload=False))],
    ids=["inside-fast", "inside-v0", "nonsquare-offaxis", "k_slots-1",
         "walked-global-2-4", "walked-global-1-1", "no-payload"])
def test_trace_cases_match_brute_force(spec, kw):
    f = frame(spec)
    _assert_brute_exact(f.port(**kw), f, min_hits=50)


def test_trace_matches_jax():
    # One interpret-mode run of the reference (tens of seconds): the other
    # cases are held to brute_force_mt, as the reference's own tests are.
    f = frame(FRONT)
    kw = dict(k_slots=1, k2_slots=1)     # 9 triangles in the global tier
    got = f.port(**kw)
    ref = f.jax(**kw)
    np.testing.assert_array_equal(got[0], ref[0])
    hit = got[0] >= 0
    np.testing.assert_allclose(got[1][hit], ref[1][hit], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(_bits(got[1][~hit]), _bits(ref[1][~hit]))


def test_overflow_poisons():
    # p_max 24 < one pair per triangle: ok is False, every hit is -2.
    tri, *_ = frame(FRONT).port(prep="fast", p_max=24)
    assert (tri == -2).all()


def test_v1_matches_dense_at_tile_32():
    f = frame(OBLIQUE)
    v1 = f.port()
    dense = bd.trace_dense_primary(f.port_verts(), f.cam,
                                   torch.from_numpy(f.rays[1]), width=f.W,
                                   height=f.H, tile=32)
    for a, b in zip(v1, dense):
        np.testing.assert_array_equal(_bits(a), _bits(b.numpy()))


def test_twin_ignores_staging_and_early_z():
    f = frame(CLOSE)
    args, _ = _fast_args(f, 1, 2)
    mc = torch.from_numpy(jax_br._bin_mcodes(f.W // 32, f.H // 32))
    rows, r0, r1, g1, _ = br.binraster_prep_fast(f.port_verts(), f.cam, mc,
                                                 **args)
    nb = (f.W // 32) * (f.H // 32)
    dirs, scalars = br.dense_rays(torch.from_numpy(f.rays[1]), f.cam["pos"],
                                  f.cam["znear"], f.cam["zfar"], nb, 8)
    ops = (rows, r0, r1, dirs, scalars, g1)
    a = br.trace_binraster_rows_ref(*ops, n_bins=nb, unroll=1, ez_chunk=0)
    old = br.REF_CHUNK
    try:
        br.REF_CHUNK = 1
        b = br.trace_binraster_rows_ref(*ops, n_bins=nb, unroll=32,
                                        ez_chunk=32)
    finally:
        br.REF_CHUNK = old
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# -- kernel wrapper: routing, binding, and the card --------------------------


def _frozen_ops(f, k_slots=8, k2_slots=64):
    args, _ = _fast_args(f, k_slots, k2_slots)
    mc = torch.from_numpy(jax_br._bin_mcodes(f.W // 32, f.H // 32))
    rows, r0, r1, g1, _ = br.binraster_prep_fast(f.port_verts(), f.cam, mc,
                                                 **args)
    nb = (f.W // 32) * (f.H // 32)
    dirs, scalars = br.dense_rays(torch.from_numpy(f.rays[1]), f.cam["pos"],
                                  f.cam["znear"], f.cam["zfar"], nb, 8)
    return (rows, r0, r1, dirs, scalars, g1), dict(n_bins=nb)


def test_cuda_input_never_reaches_twin(monkeypatch):
    """A tensor the device policy routes to the kernel launches it (or
    raises); the twin is never called. CUDA is mocked where absent."""
    ops, kw = _frozen_ops(frame(OBLIQUE))
    launched = []

    def twin(*a, **k):
        raise AssertionError("a kernel-routed tensor reached the twin")

    def fake_launch(name, ints, tensors, n, dev):
        launched.append((name, ints))
        return ()

    monkeypatch.setattr(br, "trace_binraster_rows_ref", twin)
    monkeypatch.setattr(br, "uses_kernel", lambda t: True)
    monkeypatch.setattr(br, "launch", fake_launch)
    before = br.trace_binraster_rows.launches
    br.trace_binraster_rows(*ops, unroll=2, ez_chunk=0, **kw)
    assert launched == [("ntrace_binraster_rows",
                         (kw["n_bins"], ops[0].shape[0], 2, 0))]
    assert br.trace_binraster_rows.launches == before + 1

    def failing(*a):
        raise RuntimeError("ntrace_binraster_rows launch failed")

    monkeypatch.setattr(br, "launch", failing)
    with pytest.raises(RuntimeError):
        br.trace_binraster_rows(*ops, **kw)
    assert br.trace_binraster_rows.launches == before + 1


def test_wrapper_rejects_bad_operands():
    ops, kw = _frozen_ops(frame(OBLIQUE))
    rows, r0, r1, dirs, scalars, g1 = ops
    with pytest.raises(TypeError):
        br.trace_binraster_rows(rows, r0.long(), r1, dirs, scalars, g1, **kw)
    with pytest.raises(ValueError):
        br.trace_binraster_rows(rows[:, :64], r0, r1, dirs, scalars, g1,
                                **kw)
    with pytest.raises(ValueError):
        br.trace_binraster_rows(rows, r0, r1, dirs[:-1], scalars, g1, **kw)
    for bad in (dict(unroll=0), dict(unroll=33), dict(ez_chunk=-1),
                dict(ez_chunk=33)):
        with pytest.raises(ValueError):
            br.trace_binraster_rows(*ops, **bad, **kw)
    with pytest.raises(ValueError, match="tile must be 32"):
        frame(FRONT).port(tile=16)


def test_c_entry_point_matches_ctypes_signature():
    """binraster_trace.cu's extern "C" function takes as many arguments as
    its ctypes binding declares (nothing compiles the sources here)."""
    src = (kbuild.CSRC_DIR / "binraster_trace.cu").read_text()
    m = re.search(r'extern "C" int (\w+)\(([^)]*)\)', src)
    assert m.group(1) == "ntrace_binraster_rows"
    assert len(m.group(2).split(",")) == len(
        kbuild.SIGNATURES["ntrace_binraster_rows"][1])


@pytest.mark.cuda
@pytest.mark.parametrize("spec,k_slots,k2_slots", [
    (FRONT, 8, 64), (CLOSE, 1, 1), (OFFAXIS, 8, 64)],
    ids=["front", "walked-global", "offaxis"])
def test_kernel_matches_twin_on_cuda(spec, k_slots, k2_slots):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    ops, kw = _frozen_ops(frame(spec), k_slots, k2_slots)
    twin = br.trace_binraster_rows_ref(*ops, **kw)
    dev = [None if a is None else a.cuda() for a in ops]
    for ez, unroll in ((0, 4), (8, 4), (0, 1), (1, 32), (32, 1)):
        out = br.trace_binraster_rows(*dev, ez_chunk=ez, unroll=unroll,
                                      **kw)
        torch.cuda.synchronize()
        for a, b in zip(out, twin):
            assert torch.equal(a.cpu(), b), (ez, unroll)


# -- the renderer ----------------------------------------------------------


W, H = 64, 64
BUILD = BuildConfig(builder="binned_sah")


@pytest.fixture(scope="module")
def conference():
    scene = get_scene("conference", n_tris=2000)
    return scene, port.build_accel(scene, BUILD)


def _armed(conference):
    scene, flat = conference
    cfg = RenderConfig(width=W, height=H, mode="primary", engine="binraster")
    r = Renderer(scene, BUILD, cfg, flat=flat, device="cpu")
    ca = raygen.camera_arrays(default_camera("conference"), W, H, "cpu")
    order, _ = pixel_table(W, H)
    batch = raygen.primary(ca, W, H, torch.from_numpy(order.copy()))
    assert r.prepare_primary(ca, W, H)
    assert r.engine == "packet" and isinstance(r.screen, br.V1Engine)
    return r, ca, batch


def test_v1_and_packet_frames_agree(conference):
    r, ca, batch = _armed(conference)
    rays = (batch.orig, batch.dirn, batch.tmin, batch.tmax)
    v1 = r.trace_primary(*rays, cam=ca, canonical=True)
    bvh = r.trace_primary(*rays, cam=ca, canonical=False)
    for a, b in zip(v1, bvh):
        assert torch.equal(a, b)


def test_v1_frozen_structure(conference, monkeypatch):
    r, ca, batch = _armed(conference)
    rays = (batch.orig, batch.dirn, batch.tmin, batch.tmax)
    live = r.trace_primary(*rays, cam=ca, canonical=True)
    r.freeze_primary_structure(ca)
    calls = []
    monkeypatch.setattr(br, "binraster_prep_fast",
                        lambda *a, **k: calls.append(1))
    frozen = r.trace_primary(*rays, cam=ca, canonical=True)
    assert not calls
    for a, b in zip(live, frozen):
        assert torch.equal(a, b)


def test_v1_declines_frames_that_do_not_tile(conference):
    r, ca, _ = _armed(conference)
    assert not r.prepare_primary(ca, 48, 48)
    assert not r.screen.armed
