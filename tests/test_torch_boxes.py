"""The LBVH's child boxes (ops/boxes.py, csrc/child_boxes.cu) on the CPU,
and the kernel against its plain version on the card.

`child_boxes_ref`, the plain version, is held bit for bit:
  - to the sparse range-min table and its two probes a range, which the
    build used before (`sparse_table_boxes` below, the reference's
    algorithm in eager torch), on the child ranges of the LBVH builds of
    the scenes tests/test_torch_lbvh.py builds, at max_leaf 4, 8 and 32;
  - to a plain minimum over each range, on ranges that start, end on or
    cross the edges of the min tree's groups of 32, at every depth of the
    tree (1 row to 4 levels above the rows);
  - to the sign rule where a lane holds both +0.0 and -0.0: lo takes -0.0
    and hi +0.0 (lax.min's; the JAX build is held to it in
    tests/test_torch_lbvh.py).
Nodes at or past `count` get zeros. On the card (`cuda` marker) the kernel
equals the plain version bit for bit on the same cases and on every build
of the 16 wind poses of hairball_dynamic at the full 2,900,402 triangles,
one launch a build.
"""

import numpy as np
import pytest
import torch

from ntrace_tpu_torch import host
from ntrace_tpu_torch.bvh import lbvh
from ntrace_tpu_torch.ops import boxes
from ntrace_tpu_torch.ops.morton import clz32

FAN = boxes.FAN


def sparse_table_boxes(slo, shi, a, i, b):
    """The child boxes as the build took them before the kernel: a sparse
    table of ceil(log2 n) + 1 levels of [lo, -hi] (torch.minimum of each
    level with itself shifted), then two probes a range."""
    n = slo.shape[0]
    levels = [torch.cat([slo.t(), -shi.t()], dim=0)]
    logn = max(int(np.ceil(np.log2(max(n, 2)))), 1)
    for k in range(1, logn + 1):
        half = 1 << (k - 1)
        prev = levels[-1]
        pad = torch.full((6, min(half, n)), np.inf)
        levels.append(torch.minimum(prev, torch.cat([prev[:, half:], pad],
                                                    dim=1)))
    table = torch.stack(levels).reshape(-1)
    lanes6 = torch.arange(6)

    def probe(l, r):
        k = torch.clamp(31 - clz32(torch.clamp(r - l, min=1)), max=logn)
        k6 = k.long()[:, None] * 6 + lanes6
        m = torch.minimum(
            table[k6 * n + l.long()[:, None]],
            table[k6 * n + (r - (torch.ones_like(k) << k)).long()[:, None]])
        return torch.cat([m[:, :3], -m[:, 3:]], dim=1)

    return torch.cat([probe(a, i), probe(i, b)], dim=1)


def plain_box(slo, shi, l, r):
    """[lo, hi] of rows [l, r) by numpy over the keys: the minimum and
    maximum of each lane, -0.0 below +0.0."""
    keys = boxes.float_keys(torch.cat([slo[l:r], -shi[l:r]], dim=1))
    m = boxes.key_floats(keys.amin(0).contiguous())
    return torch.cat([m[:3], -m[3:]])


def _bits(t):
    return t.contiguous().view(torch.int32)


def _random_boxes(n, seed):
    g = np.random.default_rng(seed)
    lo = g.normal(size=(n, 3)).astype(np.float32)
    hi = lo + g.random((n, 3)).astype(np.float32)
    return torch.from_numpy(lo), torch.from_numpy(hi)


def _i32(x):
    return torch.tensor(x, dtype=torch.int32)


def dup_soup():
    """tests/test_torch_lbvh.py's soup with five clusters of 120 identical
    triangles (D == 30 boundaries)."""
    tv = host.make_random_soup(n_tris=1000, seed=9).tri_verts().copy()
    for k in range(5):
        tv[k * 120:(k + 1) * 120] = tv[k * 120]
    idx = np.arange(3000, dtype=np.int32).reshape(-1, 3)
    return host.Scene(positions=tv.reshape(-1, 3), indices=idx)


SCENES = {
    "conference@4000": lambda: host.get_scene("conference@4000"),
    "hairball@20000": lambda: host.get_scene("hairball@20000"),
    "dupes": dup_soup,
}


def recorded_queries(monkeypatch, args, **kw):
    """The arguments of every child_boxes call of lbvh_device_fast (or of
    `lbvh_device` with sweep=True) on `args`."""
    seen = []

    def record(*a):
        seen.append(a)
        return boxes.child_boxes(*a)

    sweep = kw.pop("sweep", False)
    monkeypatch.setattr(lbvh, "child_boxes", record)
    if sweep:
        lbvh.lbvh_device(*args, **kw)
    else:
        lbvh.lbvh_device_fast(*args, emit="packed", **kw)
    return seen


# --- sizes -----------------------------------------------------------------

@pytest.mark.parametrize("n,want", [
    (1, [1]), (32, [32]), (33, [33, 2, 1]), (1024, [1024, 32, 1]),
    (1025, [1025, 33, 2]), (32769, [32769, 1025, 33, 2]),
    (2_900_402, [2_900_402, 90_638, 2_833, 89, 3])])
def test_level_sizes(n, want):
    assert boxes.level_sizes(n) == want


def test_keys_order_every_float_and_invert():
    x = torch.tensor([-np.inf, -3.5, -1e-38, -1e-45, -0.0, 0.0, 1e-45,
                      1e-38, 2.0, np.inf], dtype=torch.float32)
    k = boxes.float_keys(x)
    assert (k[1:] > k[:-1]).all()
    assert torch.equal(_bits(boxes.key_floats(k)), _bits(x))


# --- the plain version on the builds ---------------------------------------

@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("max_leaf", [4, 8, 32])
def test_twin_equals_the_sparse_table_on_builds(monkeypatch, name,
                                                max_leaf):
    args = lbvh.device_inputs(SCENES[name](), "cpu")
    (q,) = recorded_queries(monkeypatch, args, max_leaf=max_leaf)
    slo, shi, a, i, b, count = q
    nc = int(count)
    assert 0 < nc <= a.shape[0]
    got = boxes.child_boxes_ref(*q)
    want = sparse_table_boxes(slo, shi, a[:nc], i[:nc], b[:nc])
    assert torch.equal(_bits(got[:nc]), _bits(want))
    assert not _bits(got[nc:]).any()


def test_twin_equals_the_sparse_table_in_the_sweep(monkeypatch):
    """lbvh_device (the 30-level sweep) asks the same queries over its
    split segments."""
    args = lbvh.device_inputs(SCENES["conference@4000"](), "cpu")
    (q,) = recorded_queries(monkeypatch, args, max_leaf=4, sweep=True)
    slo, shi, a, i, b, count = q
    nc = int(count)
    assert nc > 0
    got = boxes.child_boxes_ref(*q)
    assert torch.equal(_bits(got[:nc]), _bits(sparse_table_boxes(
        slo, shi, a[:nc], i[:nc], b[:nc])))


# --- group edges, depths, zeros --------------------------------------------

def edge_ranges(n):
    """Ranges [l, r) of 1 row, exactly FAN rows, FAN + 1, two groups and a
    group of groups, aligned and off by one on either side, and the whole
    array and its ends; clipped to [0, n)."""
    out = set()
    for width in (1, 2, FAN - 1, FAN, FAN + 1, 2 * FAN - 2, 2 * FAN - 1,
                  2 * FAN, 2 * FAN + 1, FAN * FAN - 1, FAN * FAN,
                  FAN * FAN + 1, FAN ** 3 + FAN + 1):
        for start in (0, 1, FAN - 1, FAN, FAN + 1, 3 * FAN - 1, FAN * FAN,
                      FAN * FAN + 5, n - width, n - width - 1):
            if 0 <= start and start + width <= n:
                out.add((start, start + width))
    out |= {(0, n), (1, n), (0, n - 1), (n // 2, n)}
    return sorted((l, r) for l, r in out if 0 <= l < r <= n)


def nodes_of(ranges, n):
    """Nodes (a, i, b) whose left child is each range and whose right
    child the rows after it; the whole array is a left child with an
    empty right one."""
    a, i, b = zip(*[(l, r, n) for l, r in ranges])
    return _i32(a), _i32(i), _i32(b)


# 1 row; the rows alone; 2 levels above; 3; 4 (1,048,577 rows).
EDGE_SIZES = [1, 31, 32, 33, 1024, 1025, 33_001, 1_048_577]


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_ranges_on_group_edges(n):
    slo, shi = _random_boxes(n, seed=n)
    ranges = edge_ranges(n)
    a, i, b = nodes_of(ranges, n)
    got = boxes.child_boxes_ref(slo, shi, a, i, b, _i32(len(ranges)))
    for q, (l, r) in enumerate(ranges):
        assert torch.equal(_bits(got[q, :6]), _bits(plain_box(slo, shi, l,
                                                              r))), (l, r)
        if r < n:
            assert torch.equal(_bits(got[q, 6:]),
                               _bits(plain_box(slo, shi, r, n))), (r, n)
    if n <= 33_001:
        keep = [q for q, (l, r) in enumerate(ranges) if r < n]
        want = sparse_table_boxes(slo, shi, a[keep], i[keep], b[keep])
        assert torch.equal(_bits(got[keep]), _bits(want))


def mixed_zero_boxes(n, seed):
    """Boxes whose lo lanes are +0.0, -0.0 or positive and whose hi lanes
    +0.0, -0.0 or negative: most ranges mix both zeros in a lane."""
    g = np.random.default_rng(seed)
    zeros = np.where(g.random((n, 3)) < 0.5, np.float32(0.0),
                     np.float32(-0.0))
    lo = np.where(g.random((n, 3)) < 0.7, zeros,
                  g.random((n, 3)).astype(np.float32) + 0.5)
    zeros = np.where(g.random((n, 3)) < 0.5, np.float32(0.0),
                     np.float32(-0.0))
    hi = np.where(g.random((n, 3)) < 0.7, zeros,
                  -g.random((n, 3)).astype(np.float32) - 0.5)
    return (torch.from_numpy(lo.astype(np.float32)),
            torch.from_numpy(hi.astype(np.float32)))


def test_mixed_zeros_take_the_sign_rule():
    """Where a range holds both zeros in a lane, lo is -0.0 and hi +0.0;
    where it holds one zero only, that zero."""
    n = 2000
    slo, shi = mixed_zero_boxes(n, seed=3)
    ranges = edge_ranges(n)
    a, i, b = nodes_of(ranges, n)
    got = boxes.child_boxes_ref(slo, shi, a, i, b, _i32(len(ranges)))
    mixed = 0
    for q, (l, r) in enumerate(ranges):
        for lane in range(6):
            vals = slo[l:r, lane] if lane < 3 else shi[l:r, lane - 3]
            signs = torch.signbit(vals[vals == 0]).unique()
            if not signs.numel():
                continue
            mixed += signs.numel() == 2
            want = lane < 3 if signs.numel() == 2 else bool(signs[0])
            assert float(got[q, lane]) == 0.0, (l, r, lane)
            assert bool(torch.signbit(got[q, lane])) == want, (l, r, lane)
    assert mixed > len(ranges)


def test_nodes_past_count_get_zeros():
    slo, shi = _random_boxes(500, seed=1)
    a, i, b = nodes_of(edge_ranges(500), 500)
    full = boxes.child_boxes_ref(slo, shi, a, i, b, _i32(a.shape[0]))
    for count in (0, 3, a.shape[0] - 1):
        got = boxes.child_boxes_ref(slo, shi, a, i, b, _i32(count))
        assert not _bits(got[count:]).any()
        assert torch.equal(_bits(got[:count]), _bits(full[:count]))


def test_cpu_takes_the_plain_version_and_checks_its_inputs(monkeypatch):
    slo, shi = _random_boxes(100, seed=2)
    a, i, b = nodes_of(edge_ranges(100), 100)
    count = _i32(a.shape[0])
    before = boxes.child_boxes.launches
    assert torch.equal(_bits(boxes.child_boxes(slo, shi, a, i, b, count)),
                       _bits(boxes.child_boxes_ref(slo, shi, a, i, b, count)))
    assert boxes.child_boxes.launches == before
    with pytest.raises(ValueError):
        boxes.child_boxes(slo.double(), shi, a, i, b, count)
    with pytest.raises(ValueError):
        boxes.child_boxes(slo, shi, a.long(), i, b, count)
    with pytest.raises(ValueError):
        boxes.child_boxes(slo, shi, a, i[:-1], b, count)
    with pytest.raises(ValueError):
        boxes.child_boxes(slo, shi, a, i, b, count.long())
    # A kernel tensor goes to the kernel or raises, never to the twin.
    monkeypatch.setattr(boxes, "uses_kernel", lambda t: True)

    def no_library():
        raise RuntimeError("no kernel library here")

    def no_plain(*args):
        raise AssertionError("the plain version ran for a kernel tensor")

    monkeypatch.setattr("ntrace_tpu_torch.kernels.build.library",
                        no_library)
    monkeypatch.setattr(boxes, "child_boxes_ref", no_plain)
    with pytest.raises(RuntimeError):
        boxes.child_boxes(slo, shi, a, i, b, count)


# --- on the card -----------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _kernel_equals_twin(q):
    before = boxes.child_boxes.launches
    got = boxes.child_boxes(*q)
    torch.cuda.synchronize()
    assert boxes.child_boxes.launches == before + 1
    want = boxes.child_boxes_ref(*q)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_SIZES)
def test_kernel_equals_twin_on_group_edges(n):
    dev = _card()
    ranges = edge_ranges(n)
    for slo, shi in (_random_boxes(n, seed=n), mixed_zero_boxes(n, seed=n)):
        for count in (len(ranges), len(ranges) // 2):
            _kernel_equals_twin([t.to(dev) for t in (
                slo, shi, *nodes_of(ranges, n), _i32(count))])


@pytest.mark.cuda
def test_kernel_equals_twin_over_the_wind_poses(monkeypatch):
    """Every build of the 16 poses of hairball_dynamic, at its full size:
    the kernel's boxes bit-equal to the plain version's on the card."""
    from benchmark.lib import spec
    from benchmark.lib.motion import Wind

    dev = _card()
    scene = host.get_scene("hairball")
    assert scene.num_tris == 2_900_402
    wind = Wind(spec.config("hairball_dynamic")["motion"], scene.positions,
                scene.indices, scene.mat_ids)
    indices = torch.from_numpy(scene.indices).to(dev)
    for k in range(16):
        args = lbvh.inputs_from(torch.from_numpy(wind.pose(k)).to(dev),
                                indices)
        before = boxes.child_boxes.launches
        (q,) = recorded_queries(monkeypatch, args, max_leaf=32)
        assert boxes.child_boxes.launches == before + 1
        _kernel_equals_twin(q)
