"""The numbers that decide `correct`: what a run produced against what the
reference gives for the same inputs, each held to its limit.

Rays cells:
  closest_tri_mismatch  share of the sampled closest-hit rays (primary,
                        diffuse) whose triangle differs from the reference's
  closest_tuv_gap       over the sampled rays that hit the reference's
                        triangle, the widest of |t - t_ref| / t_ref,
                        |u - u_ref| and |v - v_ref|
  anyhit_mismatch       share of the sampled any-hit (AO) rays whose
                        verdict, blocked or not, differs from the reference's
Frame cells:
  pixel_mismatch        share of the sampled pixels whose colour differs
                        from the reference's by more than PIXEL_TOL in some
                        channel
  pixel_gap_mean        the mean over the sampled pixels of the widest
                        channel difference
"""

from __future__ import annotations

import torch

PIXEL_TOL = 1e-3


def hit_numbers(closest, anyhit) -> dict:
    """closest: [((tri, t, u, v) run, (tri, t, u, v) reference)];
    anyhit: [(tri run, blocked reference)]. Tensors on the CPU."""
    out = {}
    if closest:
        tri = torch.cat([a[0] for a, _ in closest])
        ref = [torch.cat([b[k] for _, b in closest]) for k in range(4)]
        run = [torch.cat([a[k] for a, _ in closest]).float()
               for k in range(1, 4)]
        out["closest_tri_mismatch"] = float((tri != ref[0]).float().mean())
        same = (tri == ref[0]) & (ref[0] >= 0)
        gap = 0.0
        if bool(same.any()):
            t_gap = ((run[0] - ref[1]).abs()
                     / ref[1].abs().clamp_min(1e-30))[same]
            gap = max(float(t_gap.max()),
                      float((run[1] - ref[2]).abs()[same].max()),
                      float((run[2] - ref[3]).abs()[same].max()))
        out["closest_tuv_gap"] = gap
    if anyhit:
        blocked = torch.cat([a >= 0 for a, _ in anyhit])
        ref = torch.cat([b for _, b in anyhit])
        out["anyhit_mismatch"] = float((blocked != ref).float().mean())
    return out


def pixel_numbers(pairs) -> dict:
    """pairs: [(run colours (n, 3), reference colours (n, 3))], CPU."""
    if not pairs:
        return {}
    run = torch.cat([torch.as_tensor(a, dtype=torch.float32)
                     for a, _ in pairs])
    ref = torch.cat([b.float() for _, b in pairs])
    gap = (run - ref).abs().amax(dim=1)
    return {"pixel_mismatch": float((gap > PIXEL_TOL).float().mean()),
            "pixel_gap_mean": float(gap.mean())}


def judged(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}). A
    number with no limit, or a limit with no number, fails."""
    rows = {k: {"value": numbers.get(k), "limit": limits.get(k)}
            for k in sorted(set(numbers) | set(limits))}
    ok = all(r["value"] is not None and r["limit"] is not None
             and r["value"] <= r["limit"] for r in rows.values())
    return ok, rows
