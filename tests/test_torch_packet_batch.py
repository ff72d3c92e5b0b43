"""The node-batch, deferred-leaf and combined packet traversals of the port
(packet_bfs, packet_dleaf, packet_bdl: torch twins on the CPU) against the
JAX Pallas kernels (interpret mode) and the JAX renderer.

Tolerances: hit ids exactly equal. t/u/v within the reference's own
packet-test tolerances (tests/test_packet.py:92-96: t rtol 1e-5 atol 1e-6,
u/v rtol 1e-4 atol 1e-5): XLA may contract float ops into FMAs, the port
never does. Images within atol 1e-6 (the shading runs in two frameworks).
Any-hit: tri >= 0 equal (which triangle blocks depends on the packet, and
a port packet is rows x 32 rays where the reference's is rows x 128). The
interpret-mode calls are slow, so each kernel makes one closest-hit call
here; tests/test_torch_packet_batch_twin.py holds every knob to the packet
twin and the brute-force oracles.
"""

import numpy as np
import pytest
import torch

from ntrace_tpu.bvh.flatten import flatten_bvh
from ntrace_tpu.bvh.golden import brute_force_anyhit, brute_force_mt
from ntrace_tpu.bvh.packed import pack_bvh
from ntrace_tpu.bvh.sbvh import build_sbvh
from ntrace_tpu.core import BuildConfig, RenderConfig
from ntrace_tpu.render.renderer import Renderer as JaxRenderer
from ntrace_tpu.scenes import default_camera
from ntrace_tpu.trace.packet_bdl import trace_packet_bdl as jax_bdl
from ntrace_tpu.trace.packet_bfs import trace_packet_bfs as jax_bfs
from ntrace_tpu.trace.packet_dleaf import trace_packet_dleaf as jax_dleaf
from ntrace_tpu_torch.render.renderer import Renderer
from ntrace_tpu_torch.tables import tables_from_packed
from ntrace_tpu_torch.trace.packet import trace_packet_ref
from ntrace_tpu_torch.trace.packet_bdl import trace_packet_bdl
from ntrace_tpu_torch.trace.packet_bfs import trace_packet_bfs
from ntrace_tpu_torch.trace.packet_dleaf import trace_packet_dleaf

from conftest import random_rays

KERNELS = {
    "bfs": (trace_packet_bfs, jax_bfs, {}),
    "dleaf": (trace_packet_dleaf, jax_dleaf, {"nodes_per_row": 1}),
    "bdl": (trace_packet_bdl, jax_bdl, {}),
}
ENGINES = ("packet_bfs", "packet_dleaf", "packet_bdl")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The twins run many small torch ops; with the suite's test workers
    sharing the cores, one intra-op thread per worker avoids
    oversubscribing them. Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flat_small(soup_small):
    return flatten_bvh(build_sbvh(soup_small, BuildConfig(
        builder="binned_sah")), soup_small)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_twin_matches_jax_and_oracles(soup_small, flat_small, rng, kernel):
    """700 rays (not a whole packet), rows 8, tables (12, 1): hit ids equal
    to the JAX kernel's, t/u/v within tolerance, bit-equal to the packet
    twin; any hit tri >= 0 equal to brute_force_anyhit."""
    wrapper, jax_fn, extra = KERNELS[kernel]
    packed = pack_bvh(flat_small, soup_small.tri_verts(), tris_per_row=12,
                      nodes_per_row=1)
    tables = tables_from_packed(packed, "cpu")
    orig, dirn, tmin, tmax = random_rays(rng, 700)
    rays = _torch(orig, dirn, tmin, tmax)
    got = wrapper(tables, *rays, rows=8)
    for a, b in zip(got, trace_packet_ref(tables, *rays)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ref = brute_force_mt(soup_small, orig, dirn, tmin, tmax)
    np.testing.assert_array_equal(got[0].numpy(), ref.tri)
    hit = ref.tri >= 0
    assert 0.1 < hit.mean() < 0.9
    jax_out = [np.asarray(a) for a in jax_fn(
        packed.nodes8, packed.tris12, orig, dirn, tmin, tmax, rows=8,
        interpret=True, tris_per_row=12, **extra)]
    np.testing.assert_array_equal(got[0].numpy(), jax_out[0])
    for a, b, rtol, atol in zip(got[1:], jax_out[1:], (1e-5, 1e-4, 1e-4),
                                (1e-6, 1e-5, 1e-5)):
        np.testing.assert_allclose(a.numpy()[hit], b[hit], rtol=rtol,
                                   atol=atol)
    np.testing.assert_array_equal(got[1].numpy()[~hit], tmax[~hit])
    assert not got[2].numpy()[~hit].any() and not got[3].numpy()[~hit].any()

    short = np.full_like(tmax, 14.0)
    any_tri = wrapper(tables, *_torch(orig, dirn, tmin, short), rows=8,
                      any_hit=True)[0].numpy()
    blocked = brute_force_anyhit(soup_small, orig, dirn, tmin, short)
    assert 0.1 < blocked.mean() < 0.95
    np.testing.assert_array_equal(any_tri >= 0, blocked)


@pytest.mark.parametrize("mode", ["primary", "shadow"])
@pytest.mark.parametrize("engine", ENGINES)
def test_render_matches_jax(soup_small, flat_small, engine, mode):
    """render() of a 16 x 16 frame through each engine (its twin on the
    CPU): the primary hits and the image equal the JAX renderer's on the
    same scene, tree and camera, for the primary frame and a frame with an
    any-hit pass (shadow)."""
    cfg = RenderConfig(width=16, height=16, mode=mode, engine=engine)
    cam = default_camera("soup")
    build = BuildConfig(builder="binned_sah")
    ref = JaxRenderer(soup_small, build, cfg, flat=flat_small).render(cam)
    r = Renderer(soup_small, build, cfg, flat=flat_small, device="cpu")
    assert r.engine == engine
    got = r.render(cam)
    np.testing.assert_array_equal(got.hit_tri, ref.hit_tri)
    assert (got.hit_tri >= 0).mean() > 0.1
    np.testing.assert_allclose(got.image, ref.image, rtol=0, atol=1e-6)
    assert np.isfinite(got.image).all() and got.image.max() > 0
