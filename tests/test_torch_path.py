"""The port's path mode against the benchmark's plain path reference (CPU).

`Renderer.render(camera, "path")` on the SBVH of two small scenes: the
San Miguel stand-in at 59,952 triangles (shell, columns and leaves: all
three materials), whose closed shell ends every path on a surface that
emits nothing, so its frame is black; and the Fairy Forest stand-in,
open to the sky, whose paths escape and carry the throughput of each
bounce into the image. 128 x 96 pixels, sorted bounce rays: more than the
8,192 rays from which _compact_trace compacts, so the compacted path and
the live_bounce<b> counters run. A seeded subset of the pixels is
re-derived by benchmark/lib/path.py from the scene alone and must agree
within 1e-3 in every channel, primary triangles and the paths' last
triangles (RenderResult.bounce_tri) equal. The reference with every
bounce turned into a miss must not agree, nor with the last bounce's hits
moved to other triangles, which leaves the black frame's colours as they
were; and the reference imports nothing of the port or of JAX.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.lib import checks, gen, path
from benchmark.lib.reference import Triangles, closest_hits
from benchmark.traffic import path_frame
from ntrace_tpu_torch.host import (BuildConfig, RenderConfig, default_camera,
                                   get_scene)
from ntrace_tpu_torch.render.renderer import Renderer

W, H, SEED = 128, 96, 2013
BUILD = BuildConfig(builder="sbvh", max_leaf_size=32, sah_tri_cost=0.02)
SCENES = {"san_miguel": (60_000, 5), "fairy": (20_000, 3)}
CHECKED = 384          # pixels re-derived a frame
RAYS_A_CALL = 64       # keeps the brute force's blocks small


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(SCENES))
def frame(request):
    """(scene, the rendered frame, the checked pixels, the renderer's
    bounces)."""
    n_tris, seed = SCENES[request.param]
    scene = get_scene(request.param, n_tris=n_tris, seed=seed)
    r = Renderer(scene, BUILD, RenderConfig(mode="path", engine="auto",
                                            width=W, height=H, seed=SEED),
                 device="cpu")
    res = r.render(default_camera(request.param), "path")
    pixels = np.sort(np.random.default_rng(SEED).choice(W * H, CHECKED,
                                                        replace=False))
    return scene, res, pixels, r.cfg.bounces


def _slots(pixels):
    return torch.from_numpy(gen.pixel_table(W, H)[1][pixels].astype(
        np.int64))


def _run(res, pixels):
    """The frame's (colours, primary triangles, last triangles) at
    `pixels`, as path_frame.numbers takes them."""
    return [(res.image.reshape(-1, 3)[pixels], res.hit_tri[pixels],
             res.bounce_tri[_slots(pixels)])]


def _live_share(res, pixels):
    """The share of `pixels` whose path's last bounce hit something."""
    return float((res.bounce_tri[_slots(pixels)] >= 0).float().mean())


def _reference(scene, pixels, bounces, trace=None):
    """(colours, primary triangles, last triangles) of `pixels` from
    lib/path.py; `trace`
    wraps the brute-force closest hit of each pass, numbered from 0 (the
    primary rays)."""
    tv = torch.as_tensor(scene.tri_verts())
    tris = Triangles(tv)
    calls = []

    def brute(o, d, tn, tx):
        outs = [closest_hits(tris, o[s:s + RAYS_A_CALL], d[s:s + RAYS_A_CALL],
                             tn[s:s + RAYS_A_CALL], tx[s:s + RAYS_A_CALL])[:2]
                for s in range(0, o.shape[0], RAYS_A_CALL)]
        hits = tuple(torch.cat([h[k] for h in outs]) for k in range(2))
        calls.append(len(calls))
        return hits if trace is None else trace(len(calls) - 1, *hits)

    cam = default_camera(scene.name)
    arr = gen.camera_arrays(cam.position, cam.forward, cam.up, cam.fov_deg,
                            cam.znear, cam.zfar, W, H, "cpu")
    slots = _slots(pixels)
    mats = path.Materials(
        torch.as_tensor(scene.mat_ids.astype(np.int64)),
        torch.tensor([m.diffuse for m in scene.materials]),
        torch.tensor([m.emissive for m in scene.materials]))
    prim = gen.primary(arr, W, H, torch.from_numpy(pixels.astype(np.int32)))
    out = path.radiance(gen.prng_key(SEED), slots, prim, brute,
                        gen.geometric_normals(tv), mats,
                        gen.Scale.of(scene.positions, "cpu"), bounces)
    assert calls == list(range(bounces + 1))
    return out


def test_path_frame_matches_the_plain_reference(frame):
    scene, res, pixels, bounces = frame
    assert bounces == 2
    colour, tri, last = _reference(scene, pixels, bounces)
    got = res.image.reshape(-1, 3)[pixels]
    numbers = checks.pixel_numbers([(got, colour)])
    assert numbers["pixel_mismatch"] == 0.0, numbers
    assert np.array_equal(res.hit_tri[pixels], tri.numpy())
    assert res.bounce_tri.shape == (W * H,)
    assert res.bounce_tri.dtype == torch.int32
    assert torch.equal(res.bounce_tri[_slots(pixels)], last)
    assert _live_share(res, pixels) > 0.1
    assert path_frame.numbers([], [(colour, tri, last)],
                              _run(res, pixels)) == {
        "pixel_mismatch": 0.0, "pixel_gap_mean": 0.0,
        "primary_tri_mismatch": 0.0, "bounce_tri_mismatch": 0.0}
    st = res.stats
    assert st["rays_bounce0"] == st["rays_bounce1"] == W * H
    assert st["live_bounce0"] == int((res.hit_tri >= 0).sum())
    assert 0 < st["live_bounce1"] <= st["live_bounce0"]
    if scene.name == "san_miguel":
        assert set(np.unique(scene.mat_ids)) == {0, 1, 2}
        assert scene.num_tris == 59_952
        assert not res.image.any()      # a closed shell, nothing emits
    else:
        assert (colour.amax(dim=1) > 0.1).float().mean() > 0.5
        assert st["live_bounce1"] < st["live_bounce0"]


def test_bounce_misses_are_not_the_frame(frame):
    """The reference given a miss for every bounce ray: the paths that went
    on now see the sky, and the comparison fails."""
    scene, res, pixels, bounces = frame

    def misses(k, tri, t):
        if k == 0:
            return tri, t
        return torch.full_like(tri, -1), torch.zeros_like(t)

    answer = _reference(scene, pixels, bounces, misses)
    numbers = path_frame.numbers([], [answer], _run(res, pixels))
    assert numbers["pixel_mismatch"] > 0.2, numbers
    assert numbers["bounce_tri_mismatch"] == pytest.approx(
        _live_share(res, pixels)), numbers
    assert numbers["primary_tri_mismatch"] == 0.0, numbers


def test_wrong_last_hits_fail_the_bounce_check(frame):
    """The reference whose last bounce hits the next triangle instead, at
    the same distance: still a hit, so in the closed San Miguel shell the
    colours and the primary triangles agree as before, and only
    bounce_tri_mismatch sees it."""
    scene, res, pixels, bounces = frame

    def moved(k, tri, t):
        if k < bounces:
            return tri, t
        return torch.where(tri >= 0, (tri + 1) % scene.num_tris, tri), t

    numbers = path_frame.numbers([], [_reference(scene, pixels, bounces,
                                                 moved)], _run(res, pixels))
    assert numbers["bounce_tri_mismatch"] == pytest.approx(
        _live_share(res, pixels)), numbers
    assert numbers["primary_tri_mismatch"] == 0.0, numbers
    if scene.name == "san_miguel":
        assert numbers["pixel_mismatch"] == 0.0, numbers


def test_path_check_refuses_a_program_without_last_hits(monkeypatch):
    """A program whose frames keep no last hits (the parent of this check)
    is refused at set-up, before anything is built, so such a run exits
    soon and with an error rather than reading an unchecked frame."""
    from ntrace_tpu_torch.render import renderer

    assert path_frame.keeps_last_hits()

    @dataclasses.dataclass
    class Result:
        image: np.ndarray

    monkeypatch.setattr(renderer, "RenderResult", Result)
    assert not path_frame.keeps_last_hits()
    with pytest.raises(RuntimeError, match="bounce_tri"):
        path_frame.build(None)


def test_path_reference_imports_neither_the_port_nor_jax():
    src = Path(path.__file__).read_text()
    tops = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert tops.isdisjoint({"jax", "jaxlib", "ntrace_tpu",
                            "ntrace_tpu_torch"}), tops
    assert tops <= {"__future__", "contextlib", "dataclasses", "torch",
                    "benchmark"}


def test_path_reference_turns_tf32_off():
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    with path.no_tf32():
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags


def test_split_is_jax_random_split():
    """The reference's host split and the program's (rng.split_words, which
    path mode splits with) against jax.random.split, for a few keys."""
    import jax

    from ntrace_tpu_torch.ray import rng
    for seed in (-2 ** 31, 0, 1, 2013, 2 ** 31 - 1):
        want = np.asarray(jax.random.split(jax.random.PRNGKey(seed))).astype(
            np.int64).tolist()
        for got in (path.split(gen.prng_key(seed)),
                    rng.split_words(rng.key_words(seed))):
            assert [list(got[0]), list(got[1])] == want


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SCENES))
def test_path_frame_on_cuda_matches_the_plain_reference(name):
    """On the card the bounce rays come from csrc/secondary_rays.cu, one
    launch a bounce; the frame still agrees with the plain reference, run
    on the card, and its primary and last hits with the CPU frame's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the packet and secondary-ray "
                    "kernels)")
    from ntrace_tpu_torch.ray import raygen
    n_tris, seed = SCENES[name]
    scene = get_scene(name, n_tris=n_tris, seed=seed)
    cfg = RenderConfig(mode="path", engine="auto", width=W, height=H,
                       seed=SEED)
    r = Renderer(scene, BUILD, cfg, device="cuda")
    launches = raygen.secondary_rays.launches
    res = r.render(default_camera(name), "path")
    assert raygen.secondary_rays.launches == launches + r.cfg.bounces
    pixels = np.sort(np.random.default_rng(SEED).choice(W * H, CHECKED,
                                                        replace=False))
    tv = torch.as_tensor(scene.tri_verts(), device="cuda")
    tris = Triangles(tv)
    cam = default_camera(name)
    arr = gen.camera_arrays(cam.position, cam.forward, cam.up, cam.fov_deg,
                            cam.znear, cam.zfar, W, H, "cuda")
    slots = torch.from_numpy(gen.pixel_table(W, H)[1][pixels].astype(
        np.int64)).cuda()
    mats = path.Materials(
        torch.as_tensor(scene.mat_ids.astype(np.int64), device="cuda"),
        torch.tensor([m.diffuse for m in scene.materials], device="cuda"),
        torch.tensor([m.emissive for m in scene.materials], device="cuda"))
    prim = gen.primary(arr, W, H,
                       torch.from_numpy(pixels.astype(np.int32)).cuda())
    colour, tri, last = path.radiance(
        gen.prng_key(SEED), slots, prim,
        lambda o, d, tn, tx: closest_hits(tris, o, d, tn, tx)[:2],
        gen.geometric_normals(tv), mats, gen.Scale.of(scene.positions,
                                                      "cuda"), r.cfg.bounces)
    numbers = checks.pixel_numbers([(res.image.reshape(-1, 3)[pixels],
                                     colour.cpu())])
    assert numbers["pixel_mismatch"] == 0.0, numbers
    assert np.array_equal(res.hit_tri[pixels], tri.cpu().numpy())
    assert torch.equal(res.bounce_tri[slots], last)
    cpu = Renderer(scene, BUILD, cfg, device="cpu").render(cam, "path")
    assert np.array_equal(res.hit_tri, cpu.hit_tri)
    assert torch.equal(res.bounce_tri.cpu(), cpu.bounce_tri)
