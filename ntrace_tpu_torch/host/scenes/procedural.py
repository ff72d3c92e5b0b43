"""Procedural stand-in scenes for the five reference benchmark scenes.

The reference benchmarks on five classic OBJ scenes (Sibenik ~80k tris, Fairy
Forest ~170k, Conference ~280k, Hairball ~2.9M, San Miguel ~10M; SURVEY.md
SS1). Those assets are not present in this offline environment and cannot be
fetched, so this module synthesizes scenes that match each benchmark's
triangle count and -- more importantly -- its WORKLOAD CHARACTER:

  sibenik     enclosed hall (interior, high occlusion, medium size)
  fairy       ground + scattered detailed objects (mixed scale)
  conference  furnished room (interior; the headline perf target)
  hairball    dense random ribbon tangle in a ball (maximum divergence)
  san_miguel  courtyard + vegetation canopy (huge, uneven density)

Every generator is deterministic in (n_tris, seed) so golden images and
benchmarks are reproducible. Real OBJ files, when supplied, load through
ntrace_tpu.io.obj and take precedence in the CLI (--mesh=path.obj).
"""

from __future__ import annotations

import numpy as np

from ntrace_tpu_torch.host.core import Camera, Material, Scene

# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------


def _tess_quad(corner, eu, ev, nu, nv):
    """Tessellated parallelogram: corner + u*eu + v*ev, (nu x nv) cells.

    Returns (verts (N,3) f32, tris (M,3) i32) with M = 2*nu*nv.
    """
    corner = np.asarray(corner, dtype=np.float32)
    eu = np.asarray(eu, dtype=np.float32)
    ev = np.asarray(ev, dtype=np.float32)
    us = np.linspace(0.0, 1.0, nu + 1, dtype=np.float32)
    vs = np.linspace(0.0, 1.0, nv + 1, dtype=np.float32)
    uu, vv = np.meshgrid(us, vs, indexing="ij")  # (nu+1, nv+1)
    verts = corner + uu[..., None] * eu + vv[..., None] * ev
    verts = verts.reshape(-1, 3)

    i = np.arange(nu)[:, None]
    j = np.arange(nv)[None, :]
    v00 = i * (nv + 1) + j
    v01 = v00 + 1
    v10 = v00 + (nv + 1)
    v11 = v10 + 1
    t0 = np.stack([v00, v10, v11], axis=-1).reshape(-1, 3)
    t1 = np.stack([v00, v11, v01], axis=-1).reshape(-1, 3)
    tris = np.concatenate([t0, t1], axis=0).astype(np.int32)
    return verts.astype(np.float32), tris


def _box(lo, hi, nu=1, nv=1):
    """Axis-aligned box as 6 tessellated quads (outward winding)."""
    lo = np.asarray(lo, dtype=np.float32)
    hi = np.asarray(hi, dtype=np.float32)
    d = hi - lo
    quads = [
        (lo, [d[0], 0, 0], [0, 0, d[2]]),                       # bottom (y=lo)
        ([lo[0], hi[1], lo[2]], [0, 0, d[2]], [d[0], 0, 0]),    # top
        (lo, [0, 0, d[2]], [0, d[1], 0]),                       # x=lo
        ([hi[0], lo[1], lo[2]], [0, d[1], 0], [0, 0, d[2]]),    # x=hi
        (lo, [0, d[1], 0], [d[0], 0, 0]),                       # z=lo
        ([lo[0], lo[1], hi[2]], [d[0], 0, 0], [0, d[1], 0]),    # z=hi
    ]
    vs, ts = [], []
    off = 0
    for c, a, b in quads:
        v, t = _tess_quad(c, a, b, nu, nv)
        vs.append(v)
        ts.append(t + off)
        off += v.shape[0]
    return np.concatenate(vs), np.concatenate(ts)


def _merge(parts):
    """Merge [(verts, tris, mat_id), ...] into Scene arrays."""
    vs, ts, ms = [], [], []
    off = 0
    for v, t, m in parts:
        vs.append(v)
        ts.append(t + off)
        ms.append(np.full((t.shape[0],), m, dtype=np.int32))
        off += v.shape[0]
    return np.concatenate(vs), np.concatenate(ts), np.concatenate(ms)


def _ribbons(rng, n_curves, segs_per_curve, radius, thickness, center):
    """Random smooth polyline ribbons inside a sphere (hairball workload).

    Each segment becomes 2 triangles of a camera-agnostic ribbon (constant
    frame). Returns (verts, tris).
    """
    # Random walks on the sphere interior.
    start = rng.normal(size=(n_curves, 3))
    start /= np.linalg.norm(start, axis=1, keepdims=True) + 1e-9
    start *= rng.uniform(0.2, 0.9, size=(n_curves, 1)) * radius
    steps = rng.normal(size=(n_curves, segs_per_curve, 3)).astype(np.float32)
    steps = steps / (np.linalg.norm(steps, axis=-1, keepdims=True) + 1e-9)
    # Smooth the walk so curves bend gently (moving average of directions).
    k = 5
    kern = np.ones((k,), dtype=np.float32) / k
    for ax in range(3):
        steps[..., ax] = np.apply_along_axis(
            lambda s: np.convolve(s, kern, mode="same"), 1, steps[..., ax]
        )
    step_len = radius * 2.0 / segs_per_curve
    pts = np.cumsum(steps * step_len, axis=1) + start[:, None, :]
    # Clamp inside the ball.
    r = np.linalg.norm(pts, axis=-1, keepdims=True)
    pts = np.where(r > radius, pts * (radius / (r + 1e-9)), pts)
    pts = pts.astype(np.float32) + np.asarray(center, dtype=np.float32)

    # Ribbon side vector: perpendicular-ish constant offset per curve.
    side = rng.normal(size=(n_curves, 1, 3)).astype(np.float32)
    side /= np.linalg.norm(side, axis=-1, keepdims=True) + 1e-9
    side *= thickness

    a = pts - side  # (C, S, 3)
    b = pts + side
    # verts interleaved per curve: a0 b0 a1 b1 ...
    verts = np.stack([a, b], axis=2).reshape(n_curves, segs_per_curve * 2, 3)
    verts = verts.reshape(-1, 3)

    s = np.arange(segs_per_curve - 1)
    base = (2 * s)[None, :] + (np.arange(n_curves) * segs_per_curve * 2)[:, None]
    a0 = base
    b0 = base + 1
    a1 = base + 2
    b1 = base + 3
    t0 = np.stack([a0, b0, a1], axis=-1).reshape(-1, 3)
    t1 = np.stack([b0, b1, a1], axis=-1).reshape(-1, 3)
    tris = np.concatenate([t0, t1], axis=0).astype(np.int32)
    return verts.astype(np.float32), tris


def _scatter_boxes(rng, n_boxes, area_lo, area_hi, size_lo, size_hi, tess):
    parts = []
    for _ in range(n_boxes):
        c = rng.uniform(area_lo, area_hi).astype(np.float32)
        s = rng.uniform(size_lo, size_hi, size=3).astype(np.float32)
        v, t = _box(c - s / 2, c + s / 2, tess, tess)
        parts.append((v, t))
    vs = np.concatenate([p[0] for p in parts])
    ts_off, off = [], 0
    for v, t in parts:
        ts_off.append(t + off)
        off += v.shape[0]
    return vs, np.concatenate(ts_off)


# ---------------------------------------------------------------------------
# tiny test scenes
# ---------------------------------------------------------------------------


def make_single_triangle() -> Scene:
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], dtype=np.float32)
    t = np.array([[0, 1, 2]], dtype=np.int32)
    return Scene(v, t, name="single_triangle")


def make_two_quads() -> Scene:
    """Two parallel quads at z=1 and z=2 (front/back occlusion test)."""
    v1, t1 = _tess_quad([-1, -1, 1], [2, 0, 0], [0, 2, 0], 1, 1)
    v2, t2 = _tess_quad([-1, -1, 2], [2, 0, 0], [0, 2, 0], 1, 1)
    v, t, m = _merge([(v1, t1, 0), (v2, t2, 1)])
    return Scene(v, t, mat_ids=m, materials=[Material(), Material(diffuse=(1, 0, 0))], name="two_quads")


def make_random_soup(n_tris: int = 1000, seed: int = 0, extent: float = 10.0, tri_size: float = 0.5) -> Scene:
    """Random triangle soup in a cube -- the fuzz-test workhorse."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-extent, extent, size=(n_tris, 1, 3))
    off = rng.normal(scale=tri_size, size=(n_tris, 3, 3))
    verts = (c + off).astype(np.float32).reshape(-1, 3)
    tris = np.arange(n_tris * 3, dtype=np.int32).reshape(-1, 3)
    return Scene(verts, tris, name=f"soup{n_tris}_s{seed}")


# ---------------------------------------------------------------------------
# benchmark stand-ins
# ---------------------------------------------------------------------------


def make_conference(n_tris: int = 280_000, seed: int = 1) -> Scene:
    """Furnished room: the Conference stand-in (headline perf target)."""
    rng = np.random.default_rng(seed)
    parts = []
    # Room shell 20 x 8 x 30, tessellated to soak up triangles like the real
    # conference room's panelled walls.
    shell_cells = max(4, int(np.sqrt(n_tris * 0.25 / 12)))
    v, t = _box([-10, 0, -15], [10, 8, 15], shell_cells, shell_cells)
    parts.append((v, t, 0))
    # Long table.
    v, t = _box([-6, 2.4, -9], [6, 2.7, 3], 24, 24)
    parts.append((v, t, 1))
    # Chairs / clutter: scattered boxes around the table.
    remaining = n_tris - sum(p[1].shape[0] for p in parts)
    n_boxes = 160
    tess = max(1, int(np.sqrt(max(remaining, 12) / (12 * n_boxes))))
    v, t = _scatter_boxes(
        rng, n_boxes, np.array([-9, 0.0, -14]), np.array([9, 1.8, 14]),
        0.4, 1.4, tess,
    )
    parts.append((v, t, 2))
    # Ceiling fixtures.
    v, t = _scatter_boxes(
        rng, 24, np.array([-8, 7.2, -13]), np.array([8, 7.8, 13]), 0.5, 1.5, tess,
    )
    parts.append((v, t, 3))
    verts, tris, mats = _merge(parts)
    mats_list = [
        Material(name="walls"),
        Material(diffuse=(0.45, 0.3, 0.18), name="table"),
        Material(diffuse=(0.3, 0.32, 0.4), name="chairs"),
        Material(emissive=(1, 1, 1), name="lights"),
    ]
    return Scene(verts, tris, mat_ids=mats, materials=mats_list, name="conference")


def make_sibenik(n_tris: int = 80_000, seed: int = 2) -> Scene:
    """Enclosed hall with columns: the Sibenik cathedral stand-in."""
    rng = np.random.default_rng(seed)
    parts = []
    shell_cells = max(4, int(np.sqrt(n_tris * 0.5 / 12)))
    v, t = _box([-8, 0, -20], [8, 14, 20], shell_cells, shell_cells)
    parts.append((v, t, 0))
    # Two rows of columns. Each column is a box of 6*(tess x 4*tess)
    # faces = 48*tess^2 triangles.
    col_budget = n_tris - t.shape[0]
    n_cols = 14
    tess = max(1, int(np.sqrt(max(col_budget, 48) / (48 * n_cols))))
    for i in range(n_cols):
        x = -5.0 if i % 2 == 0 else 5.0
        z = -16.0 + (i // 2) * 5.0
        v, t = _box([x - 0.6, 0, z - 0.6], [x + 0.6, 12, z + 0.6], tess, tess * 4)
        parts.append((v, t, 1))
    verts, tris, mats = _merge(parts)
    return Scene(
        verts, tris, mat_ids=mats,
        materials=[Material(name="walls"), Material(diffuse=(0.6, 0.55, 0.5), name="columns")],
        name="sibenik",
    )


def make_fairy_forest(n_tris: int = 170_000, seed: int = 3) -> Scene:
    """Ground plane + scattered 'trees' (clustered small geometry)."""
    rng = np.random.default_rng(seed)
    parts = []
    g_cells = max(4, int(np.sqrt(n_tris * 0.15 / 2)))
    v, t = _tess_quad([-30, 0, -30], [60, 0, 0], [0, 0, 60], g_cells, g_cells)
    parts.append((v, t, 0))
    remaining = n_tris - t.shape[0]
    # Per tree: trunk box 6*2*(t)(2t) = 24t^2 + two canopy boxes
    # 6*2*(2t)(2t) = 48t^2 each -> 120 t^2 triangles. Pick the tessellation
    # for ~120 trees, then let the tree COUNT consume the remainder so the
    # scene lands on the advertised budget (BASELINE.md fairy ~170k).
    tess = max(1, int(np.sqrt(max(remaining, 120) / (120 * 120))))
    n_trees = max(1, remaining // (120 * tess * tess))
    for _ in range(n_trees):
        c = rng.uniform([-28, 0, -28], [28, 0, 28]).astype(np.float32)
        h = rng.uniform(2.0, 6.0)
        # trunk + 2 canopy boxes
        v, t = _box(c + [-0.2, 0, -0.2], c + [0.2, h, 0.2], tess, tess * 2)
        parts.append((v, t, 1))
        for k in range(2):
            s = rng.uniform(0.8, 2.2)
            cc = c + np.array([0, h + k * s * 0.7, 0], dtype=np.float32)
            v, t = _box(cc - s / 2, cc + s / 2, tess * 2, tess * 2)
            parts.append((v, t, 2))
    verts, tris, mats = _merge(parts)
    return Scene(
        verts, tris, mat_ids=mats,
        materials=[Material(diffuse=(0.35, 0.4, 0.2), name="ground"),
                   Material(diffuse=(0.4, 0.25, 0.12), name="trunk"),
                   Material(diffuse=(0.2, 0.5, 0.2), name="canopy")],
        name="fairy",
    )


def make_hairball(n_tris: int = 2_900_000, seed: int = 4) -> Scene:
    """Dense ribbon tangle in a ball: the Hairball divergence stress."""
    rng = np.random.default_rng(seed)
    segs = 64
    n_curves = max(1, n_tris // (2 * (segs - 1)))
    v, t = _ribbons(rng, n_curves, segs, radius=3.0, thickness=0.01, center=[0, 3.2, 0])
    vg, tg = _tess_quad([-10, 0, -10], [20, 0, 0], [0, 0, 20], 16, 16)
    verts, tris, mats = _merge([(v, t, 0), (vg, tg, 1)])
    return Scene(
        verts, tris, mat_ids=mats,
        materials=[Material(diffuse=(0.55, 0.5, 0.4), name="hair"),
                   Material(name="ground")],
        name="hairball",
    )


def make_san_miguel(n_tris: int = 10_000_000, seed: int = 5) -> Scene:
    """Courtyard + dense canopy: the San Miguel scale stand-in."""
    rng = np.random.default_rng(seed)
    parts = []
    shell_cells = max(4, int(np.sqrt(n_tris * 0.08 / 12)))
    v, t = _box([-20, 0, -20], [20, 12, 20], shell_cells, shell_cells)
    parts.append((v, t, 0))
    # Arcade columns.
    for i in range(24):
        ang = i / 24 * 2 * np.pi
        x, z = 14 * np.cos(ang), 14 * np.sin(ang)
        v, t = _box([x - 0.4, 0, z - 0.4], [x + 0.4, 8, z + 0.4], 6, 24)
        parts.append((v, t, 1))
    used = sum(p[1].shape[0] for p in parts)
    # Vegetation canopy: leaf-sized random triangles clustered in blobs
    # (the San Miguel workload killer -- millions of tiny tris).
    n_leaves = max(1, n_tris - used)
    n_blobs = 60
    per_blob = n_leaves // n_blobs
    blob_c = rng.uniform([-16, 4, -16], [16, 10, 16], size=(n_blobs, 3))
    leaves_v = []
    for bc in blob_c:
        c = bc + rng.normal(scale=2.0, size=(per_blob, 1, 3))
        off = rng.normal(scale=0.06, size=(per_blob, 3, 3))
        leaves_v.append((c + off).astype(np.float32).reshape(-1, 3))
    lv = np.concatenate(leaves_v)
    lt = np.arange(lv.shape[0], dtype=np.int32).reshape(-1, 3)
    parts.append((lv, lt, 2))
    verts, tris, mats = _merge(parts)
    return Scene(
        verts, tris, mat_ids=mats,
        materials=[Material(name="walls"), Material(diffuse=(0.7, 0.65, 0.55), name="columns"),
                   Material(diffuse=(0.25, 0.45, 0.2), name="leaves")],
        name="san_miguel",
    )


# ---------------------------------------------------------------------------
# registry + default cameras (the rebuild's "camera signatures")
# ---------------------------------------------------------------------------

SCENE_REGISTRY = {
    "sibenik": make_sibenik,
    "fairy": make_fairy_forest,
    "conference": make_conference,
    "hairball": make_hairball,
    "san_miguel": make_san_miguel,
    "soup": make_random_soup,
    "two_quads": make_two_quads,
}

_DEFAULT_CAMERAS = {
    "sibenik": Camera(position=[0.0, 6.0, 17.0], forward=[0.05, -0.15, -1.0], fov_deg=70),
    "fairy": Camera(position=[18.0, 9.0, 18.0], forward=[-1.0, -0.35, -1.0], fov_deg=60),
    "conference": Camera(position=[8.0, 5.0, 12.5], forward=[-0.55, -0.2, -1.0], fov_deg=70),
    "hairball": Camera(position=[0.0, 4.0, 7.5], forward=[0.0, -0.1, -1.0], fov_deg=60),
    "san_miguel": Camera(position=[12.0, 6.0, 12.0], forward=[-0.8, -0.25, -0.8], fov_deg=70),
    "two_quads": Camera(position=[0.0, 0.0, -1.0], forward=[0.0, 0.0, 1.0], fov_deg=60),
    "soup": Camera(position=[0.0, 0.0, 25.0], forward=[0.0, 0.0, -1.0], fov_deg=60),
}


def default_camera(scene_name: str) -> Camera:
    base = scene_name.split("@")[0]
    return _DEFAULT_CAMERAS.get(base, Camera(position=[0, 1, 5], forward=[0, 0, -1]))


def get_scene(name: str, n_tris: int | None = None, seed: int | None = None) -> Scene:
    """Resolve 'conference' or 'soup@5000' style names to a Scene."""
    if "@" in name:
        name, arg = name.split("@", 1)
        n_tris = int(arg)
    fn = SCENE_REGISTRY[name]
    kw = {}
    if n_tris is not None:
        kw["n_tris"] = n_tris
    if seed is not None:
        kw["seed"] = seed
    try:
        return fn(**kw)
    except TypeError:  # generators without n_tris (two_quads)
        return fn()
