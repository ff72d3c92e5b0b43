"""The camera walk: a fixed set of views around a configuration's camera.

The views come from the workload's own `walk_seed`, so every run offers the
same views and the same work; `--seed` only orders them (and seeds the
secondary rays). Each view moves the camera by up to `jitter` times the
scene's diagonal along each axis and turns its forward direction by up to
`turn_deg` degrees left or right and up or down.
"""

from __future__ import annotations

import numpy as np


def _rotate(v: np.ndarray, axis: np.ndarray, angle: float) -> np.ndarray:
    """v turned by `angle` radians about the unit `axis` (Rodrigues)."""
    c, s = np.cos(angle), np.sin(angle)
    return v * c + np.cross(axis, v) * s + axis * np.dot(axis, v) * (1 - c)


def views(camera: dict, lo: np.ndarray, hi: np.ndarray, n: int,
          walk_seed: int, jitter: float, turn_deg: float) -> list[dict]:
    """`n` cameras, dicts of position, forward, up, fov_deg, znear, zfar."""
    rng = np.random.default_rng(walk_seed)
    diag = float(np.linalg.norm(np.asarray(hi, np.float64)
                                - np.asarray(lo, np.float64)))
    up = np.asarray(camera.get("up", (0.0, 1.0, 0.0)), np.float64)
    up = up / np.linalg.norm(up)
    out = []
    for _ in range(n):
        pos = (np.asarray(camera["position"], np.float64)
               + rng.uniform(-jitter, jitter, 3) * diag)
        yaw, pitch = np.radians(rng.uniform(-turn_deg, turn_deg, 2))
        f = np.asarray(camera["forward"], np.float64)
        f = _rotate(f / np.linalg.norm(f), up, yaw)
        right = np.cross(f, up)
        f = _rotate(f, right / np.linalg.norm(right), pitch)
        out.append({"position": pos.tolist(), "forward": f.tolist(),
                    "up": up.tolist(), "fov_deg": camera["fov_deg"],
                    "znear": camera.get("znear", 1e-3),
                    "zfar": camera.get("zfar", 1e8)})
    return out


def order(n: int, rng: np.random.Generator) -> list[int]:
    """The views' order in a run: a permutation drawn from the run's seed."""
    return [int(i) for i in rng.permutation(n)]
