"""The check must be able to fail.

  - The control, the reference computed in bfloat16 and put in the
    program's place, comes out not correct under every cell's limits.
  - A whole run with the timed path broken underneath comes out not
    correct: half of each batch left out (those rays read as misses), and
    an answer altered where it is produced (every fourth ray's hit turned
    into a miss and its miss into a hit). The faults are planted in the
    renderer's pass entries, which the window of every cell drives.

At the rehearsal's size on the CPU (tests/small.py); the faults on the
conference stand-in cut to 5,000 triangles, whose room blocks a good share
of AO rays (the soup and a hairball that small block almost none, so a
lost answer there is mostly a miss either way).
"""

from __future__ import annotations

import pytest
import torch

from small import cells, small  # noqa: E402  (puts ROOT on sys.path)

from benchmark import run  # noqa: E402
from benchmark.lib import checks, spec  # noqa: E402
from benchmark.lib.cell import Cell  # noqa: E402
from ntrace_tpu_torch.render.renderer import Renderer  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", cells())
def test_control_is_not_correct(cell):
    cfg, wl = small(cell)
    kind = spec.traffic(wl["kind"])
    c = Cell(cell, wl, cfg, 2 ** 31 + 99, "cpu")
    kind.build(c)
    kind.traffic(c)
    kind.window(c, 0.1, False)
    samples = kind.sample(c)
    ref = kind.reference(c, samples, torch.float32)
    low = kind.reference(c, samples, torch.bfloat16)
    ok, _ = checks.judged(kind.numbers(samples, ref), wl["limits"])
    assert ok
    bad, rows = checks.judged(
        kind.numbers(samples, ref, kind.control_hits(low)), wl["limits"])
    assert not bad, rows


def _half_left_out(out):
    tri, t, u, v = (a.clone() for a in out)
    n = tri.shape[0]
    tri[n // 2:] = -1
    return tri, t, u, v


def _altered(out):
    tri, t, u, v = (a.clone() for a in out)
    tri[::4] = torch.where(tri[::4] >= 0, -1, 0).to(tri.dtype)
    return tri, t, u, v


FAULTS = {"half_left_out": _half_left_out, "answer_altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", cells())
def test_broken_path_is_not_correct(cell, fault, monkeypatch):
    """The fault is in place for the window alone, as a fault of the timed
    path would be (set-up's traffic stays sound)."""
    broken = FAULTS[fault]
    primary, secondary = Renderer.trace_primary, Renderer._trace_secondary
    cfg, wl = small(cell, room=True)
    kind = spec.traffic(wl["kind"])
    window = kind.window

    def broken_window(*args):
        with monkeypatch.context() as m:
            m.setattr(Renderer, "trace_primary", lambda self, *a, **k:
                      broken(primary(self, *a, **k)))
            m.setattr(Renderer, "_trace_secondary", lambda self, *a, **k:
                      broken(secondary(self, *a, **k)))
            return window(*args)

    monkeypatch.setattr(kind, "window", broken_window)
    res = run.run_cell(cell, 2 ** 31 + 7, 0.1, False, "cpu", config=cfg,
                       workload=wl)
    assert not res["correct"], res["checks"]
