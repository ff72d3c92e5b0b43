"""The animation of a moving configuration: its poses, in plain numpy.

A configuration's `motion` block defines every pose. Kind "wind", a seeded
wind field: each vertex of a triangle of material `material` moves, every
other vertex stays put; at pose k, t_k = k / fps seconds, coordinate a of
vertex v moves by

    A_a * sin(2 pi (f t_k + (w_a . v) / wavelength) + phi_a),

A the `amplitude`, f the `frequency_hz`, w_a a unit vector and phi_a a phase
drawn from numpy.random.default_rng(motion_seed). Each pose is computed in
float64 from the rest positions and rounded to float32, so the program and
the reference get the same arrays.
"""

from __future__ import annotations

import numpy as np


class Wind:
    """The wind field of a `motion` block over a scene's rest positions
    (V, 3) float32, indices (M, 3) and material ids (M,)."""

    def __init__(self, motion: dict, positions: np.ndarray,
                 indices: np.ndarray, mat_ids: np.ndarray):
        if motion["kind"] != "wind":
            raise ValueError(f"unknown motion kind {motion['kind']!r}")
        rng = np.random.default_rng(motion["motion_seed"])
        w = rng.standard_normal((3, 3))
        self.directions = w / np.linalg.norm(w, axis=1, keepdims=True)
        self.phases = rng.uniform(0.0, 2.0 * np.pi, 3)
        self.amplitude = np.asarray(motion["amplitude"], np.float64)
        self.frequency = float(motion["frequency_hz"])
        self.fps = float(motion["fps"])
        self.count = int(motion["poses"])
        self.rest = np.asarray(positions, np.float32)
        moving = np.zeros(self.rest.shape[0], bool)
        moving[np.asarray(indices)[np.asarray(mat_ids)
                                   == motion["material"]].ravel()] = True
        self.moving = moving
        self._ids = np.flatnonzero(moving)
        self._rest64 = self.rest[self._ids].astype(np.float64)
        # (w_a . v) / wavelength of each moving vertex, a column an axis.
        self._wave = (self._rest64 @ self.directions.T) / float(
            motion["wavelength"])

    def pose(self, k: int) -> np.ndarray:
        """(V, 3) float32: the positions of pose k (k taken modulo the
        block's `poses`)."""
        t = (k % self.count) / self.fps
        # rest + A sin(2 pi (f t + wave) + phi), in float64, in place.
        v = self._wave + self.frequency * t
        v *= 2.0 * np.pi
        v += self.phases
        np.sin(v, out=v)
        v *= self.amplitude
        v += self._rest64
        out = self.rest.copy()
        out[self._ids] = v            # rounded to float32
        return out
