"""The while-while schedules of the port (packet_ww, packet_pipe) on a
small conference: the node loop pauses as soon as a step queues a leaf
run, so the twins do the packet twin's work, their queues hold at most two
runs, and they still equal the JAX kernels (interpret mode) and, on a
card, the CUDA kernels.

Scene: get_scene("conference", n_tris=5000) (10,320 triangles), binned
SAH (sah_tri_cost 0.02, max_leaf_size 48); rays: the primary, diffuse,
AO and shadow passes of render() at 32x32, one sample a pixel (1,024 rays
a pass), on the CPU through the packet engine.

Tolerances: node visits and slot tests within 2% of trace_packet_ref's
walk without its cull on pop (its counts plus the culled ones) on each
closest-hit pass. Hit ids exactly equal everywhere. Against the JAX
kernels t/u/v within tests/test_torch_packet_variants.py's tolerances
(the reference's tests/test_packet.py:92-96: t rtol 1e-5 atol 1e-6, u/v
rtol 1e-4 atol 1e-5; XLA may contract float ops into FMAs, the port never
does) on primary rays, and on diffuse rays bit-equal to brute_force_mt
(the test says why); any-hit tri >= 0 equal. Against the packet twin
closest hits are bit-equal. Kernel against twin on a card: bit-equal,
any-hit tri too.
"""

import numpy as np
import pytest
import torch

from ntrace_tpu.trace.packet_pipe import trace_packet_pipe as jax_pipe
from ntrace_tpu.trace.packet_ww import trace_packet_ww as jax_ww
from ntrace_tpu_torch.host import (BuildConfig, RenderConfig,
                                   brute_force_mt, build_sbvh,
                                   default_camera, flatten_bvh, get_scene,
                                   pack_bvh)
from ntrace_tpu_torch.render.renderer import Renderer
from ntrace_tpu_torch.tables import tables_from_packed
from ntrace_tpu_torch.trace import packet_ww
from ntrace_tpu_torch.trace.packet import trace_packet_ref
from ntrace_tpu_torch.trace.packet_pipe import (trace_packet_pipe,
                                                trace_packet_pipe_ref)
from ntrace_tpu_torch.trace.packet_ww import (trace_packet_ww,
                                              trace_packet_ww_ref)

TWINS = {"ww": (trace_packet_ww, trace_packet_ww_ref, jax_ww),
         "pipe": (trace_packet_pipe, trace_packet_pipe_ref, jax_pipe)}
CLOSEST = ("primary", "diffuse")
ANY = ("ao", "shadow")
WORK_RTOL = 0.02


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread a test worker (the twins run many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def conference():
    """(scene, flat, passes): passes maps primary, diffuse, ao and shadow
    to (rays, any_hit) of the last pass render() traced in that mode."""
    scene = get_scene("conference", n_tris=5000)
    bc = BuildConfig(builder="binned_sah", sah_tri_cost=0.02,
                     max_leaf_size=48)
    flat = flatten_bvh(build_sbvh(scene, bc), scene)
    r = Renderer(scene, bc, RenderConfig(width=32, height=32, samples=1),
                 flat=flat, device="cpu")
    calls, passes = [], {}
    base = r.tracer.trace

    def tracer(o, d, tn, tx, any_hit):
        calls.append(((o, d, tn, tx), any_hit))
        return base(o, d, tn, tx, any_hit)

    r.tracer.trace = tracer
    for mode in ("diffuse", "ao", "shadow"):
        calls.clear()
        r.render(default_camera("conference"), mode)
        passes["primary"], passes[mode] = calls
    assert {k: (v[0][0].shape[0], v[1]) for k, v in passes.items()} == {
        "primary": (1024, False), "diffuse": (1024, False),
        "ao": (1024, True), "shadow": (1024, True)}
    return scene, flat, passes


def _tables(scene, flat, tpr=12, npr=8, device="cpu"):
    packed = pack_bvh(flat, scene.tri_verts(), tris_per_row=tpr,
                      nodes_per_row=npr)
    return packed, tables_from_packed(packed, device)


def _bit_equal(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("batch", CLOSEST)
@pytest.mark.parametrize("kernel", sorted(TWINS))
def test_twin_does_the_packet_twins_work(conference, kernel, batch):
    """Paused as soon as a step queues a run, each twin tests a leaf one
    node step after it finds it: its node visits and slot tests come
    within 2% of the packet twin's walk without its cull on pop (the
    packet twin's work plus what the cull saved; a pause at 30 runs made
    13% and 16% more here), its closest hits stay bit-equal, and no queue
    holds more than two runs."""
    scene, flat, passes = conference
    _, tables = _tables(scene, flat)
    rays, _ = passes[batch]
    ref_work = {"culled_node_visits": 0, "culled_slot_tests": 0}
    work = {"queue_max": 0}
    ref = trace_packet_ref(tables, *rays, work=ref_work)
    got = TWINS[kernel][1](tables, *rays, work=work)
    assert _bit_equal(got, ref)
    assert (ref[0] >= 0).float().mean() > 0.5
    for key, cut in (("node_visits", "culled_node_visits"),
                     ("tri_slot_tests", "culled_slot_tests")):
        uncut = ref_work[key] + ref_work[cut]
        assert work[key] == pytest.approx(uncut, rel=WORK_RTOL), key
    assert work["queue_max"] == packet_ww.QCAP == 2


@pytest.mark.parametrize("kernel", sorted(TWINS))
def test_queue_bound_is_checked(conference, monkeypatch, kernel):
    """The twins refuse to go on past QCAP runs: with room for one, a node
    whose two leaf children are both hit overflows, and the twin raises
    instead of dropping the run."""
    scene, flat, passes = conference
    _, tables = _tables(scene, flat)
    monkeypatch.setattr(packet_ww, "QCAP", 1)
    with pytest.raises(RuntimeError, match="queue held 2 of 1 runs"):
        TWINS[kernel][1](tables, *passes["primary"][0])


def test_pipe_counts_its_early_fetches(conference):
    """The pipe twin counts the node steps that go on to a node and those
    whose next node is the record the kernel fetched before the slab
    tests; counting changes no result. The ww twin, whose near child is
    not known before the slab tests, counts the same guess too."""
    scene, flat, passes = conference
    _, tables = _tables(scene, flat)
    rays, _ = passes["diffuse"]
    for twin in (trace_packet_pipe_ref, trace_packet_ww_ref):
        work = {"fetch_steps": 0, "fetch_predicted": 0}
        assert _bit_equal(twin(tables, *rays, work=work),
                          twin(tables, *rays))
        assert 0 < work["fetch_predicted"] < work["fetch_steps"]
        assert work["fetch_steps"] < work["node_visits"]


@pytest.mark.parametrize("kernel", sorted(TWINS))
def test_twin_matches_jax_on_conference(conference, kernel):
    """Closest hits: ids exact against the JAX kernel (interpret mode) on
    the primary and diffuse passes, t/u/v within tolerance on the primary
    pass, and on the diffuse pass bit-equal to brute_force_mt (on diffuse
    ray 66 XLA's contraction moves JAX's u by 2.3e-5 from brute force's,
    JAX's packet kernel alike, which is past the u tolerance). Any hits of
    the AO and shadow passes: tri >= 0 equal."""
    scene, flat, passes = conference
    wrapper, _, jax_fn = TWINS[kernel]
    packed, tables = _tables(scene, flat)
    for batch in CLOSEST + ANY:
        rays, any_hit = passes[batch]
        host = [a.numpy() for a in rays]
        got = wrapper(tables, *rays, any_hit=any_hit)
        ref = [np.asarray(a) for a in jax_fn(
            packed.nodes8, packed.tris12, *host, any_hit=any_hit,
            interpret=True, tris_per_row=12, nodes_per_row=8)]
        if any_hit:
            np.testing.assert_array_equal(got[0].numpy() >= 0, ref[0] >= 0)
            assert 0.0 < (ref[0] >= 0).mean() < 1.0, batch
            continue
        np.testing.assert_array_equal(got[0].numpy(), ref[0])
        if batch == "diffuse":
            bf = brute_force_mt(scene, *host)
            for a, b in zip(got, (bf.tri, bf.t, bf.u, bf.v)):
                np.testing.assert_array_equal(a.numpy(), b)
            continue
        hit = ref[0] >= 0
        for a, b, rtol, atol in zip(got[1:], ref[1:], (1e-5, 1e-4, 1e-4),
                                    (1e-6, 1e-5, 1e-5)):
            np.testing.assert_allclose(a.numpy()[hit], b[hit], rtol=rtol,
                                       atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(TWINS))
@pytest.mark.parametrize("tpr,npr", [(12, 1), (4, 8)])
def test_kernel_matches_twin_on_cuda(conference, kernel, tpr, npr):
    """Each kernel bit-equal to its twin on every pass, any-hit tri
    included, at both layouts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    scene, flat, passes = conference
    wrapper, twin, _ = TWINS[kernel]
    _, tables = _tables(scene, flat, tpr, npr, device="cuda")
    for batch in CLOSEST + ANY:
        rays, any_hit = passes[batch]
        rays = [a.cuda() for a in rays]
        before = wrapper.launches
        kern = wrapper(tables, *rays, any_hit=any_hit)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert _bit_equal(kern, twin(tables, *rays, any_hit=any_hit)), batch
