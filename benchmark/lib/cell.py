"""One run of one cell: its files, its seed and what its phases leave for
the next (the traffic modules set further attributes)."""

from __future__ import annotations

from time import perf_counter

import numpy as np
import torch

# Purposes of the run's random streams, one generator each.
ORDER, CHECK = 1, 3


class Cell:
    def __init__(self, name: str, workload: dict, config: dict, seed: int,
                 device, t0: float = None):
        self.name = name
        self.workload = workload
        self.config = config
        self.set_seed(seed)
        self.device = torch.device(device)
        self.setup_parts = {}
        self._mark = perf_counter() if t0 is None else t0

    def set_seed(self, seed: int):
        self.seed = int(seed)
        # RenderConfig.seed and jax.random keys take an int32.
        self.seed32 = self.seed % 2 ** 31

    def rng(self, purpose: int) -> np.random.Generator:
        return np.random.default_rng([self.seed % 2 ** 64, purpose])

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, part: str):
        """Charge the seconds since the last mark, the device's work
        synchronised (once CUDA is up), to set-up part `part`."""
        if self.device.type != "cuda" or torch.cuda.is_initialized():
            self.sync()
        now = perf_counter()
        self.setup_parts[part] = (self.setup_parts.get(part, 0.0)
                                  + now - self._mark)
        self._mark = now


class Readings:
    """What the metric readers read (benchmark/metrics/*.py): attributes
    that a kind of traffic or a run sets, None where it has none."""

    def __init__(self, **fields):
        self.kind = None
        self.mode = None
        self.setup_s = None
        self.window_s = None
        self.live_rays = None      # rays cells: live rays traced
        self.bound_s = None        # rays cells, traced: the passes' bound
        self.trace_kernels = None  # rays cells: names of the traversal
                                   # kernels (the configuration's)
        self.frame_s = None        # frame cells: each frame's seconds
        self.stats = None          # frame cells: each frame's render stats
        self.profile = None        # traced runs: lib/prof.py's reduction
        self.__dict__.update(fields)
