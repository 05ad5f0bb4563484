"""Cut detection per receiver: L/H watermark crossings as reductions.

``receiver_aggregate`` runs every slot's own copy of the multi-node cut
detector over ``[C, C, K]`` (receiver, destination, ring) report planes.
The invalidation fixpoint (each in-flux destination implicitly reports
the rings whose observer is itself at or above L) is a host loop that
runs while any cell changes: one device sync per iteration.
"""
from __future__ import annotations

import torch


def receiver_aggregate(reports, member, obs_full, delivered_down, gate,
                       seen_down, settings):
    """Returns ``(reports, seen_down, any_new, in_flux, crossed)``; the
    announce decision is left to the caller. ``gate``/``seen_down`` are
    ``[C]``, ``member`` ``[C, C]``, the rest ``[C, C, K]``."""
    lo, hi = settings.L, settings.H
    c, _, k = reports.shape
    new = delivered_down & member[:, :, None] & gate[:, None, None]
    reports = reports | new
    any_new = new.any(dim=2).any(dim=1)
    seen_down = seen_down | any_new
    fix_gate = any_new & seen_down

    if bool(fix_gate.any()):
        obs_flat = obs_full.reshape(c, c * k).long()
        gated = fix_gate[:, None, None]
        while True:
            counts = reports.sum(dim=2)
            flux = (counts >= lo) & (counts < hi)
            obs_in_sets = torch.gather(counts >= lo, 1, obs_flat).reshape(
                c, c, k)
            add = flux[:, :, None] & obs_in_sets & ~reports & gated
            if not bool(add.any()):
                break
            reports = reports | add

    counts = reports.sum(dim=2)
    in_flux = ((counts >= lo) & (counts < hi)).any(dim=1)
    crossed = counts >= hi
    return reports, seen_down, any_new, in_flux, crossed
