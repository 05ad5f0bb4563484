"""Cut detection: L/H watermark crossings as reductions.

``aggregate`` runs the shared engine's one cut detector over ``[C, K]``
(destination, ring) report planes; ``receiver_aggregate`` runs every
slot's own copy over ``[C, C, K]`` (receiver, destination, ring) planes.
The invalidation fixpoint makes each in-flux destination implicitly
report the rings whose observer is itself at or above L. The reference
iterates it in a ``while_loop`` until nothing changes; both detectors
here take ``_invalidate``'s one masked pass, which is that fixed point
(its docstring says why), with no loop and no read.
"""
from __future__ import annotations

import torch

from rapid_tpu_torch.device import read_host


def deliver_reports(state, src_alive):
    """bool [C, K]: monitor DOWN reports landing in the shared detector.

    ``pending_deliver[obs, j]`` is observer ``obs``'s ring-j report; the
    ring-j observer of ``dst`` (``obs_idx``) is the one reporter for
    ``(dst, j)``, and a batch whose sender crashed before delivery is
    dropped."""
    obs = state.obs_idx.long()
    return torch.gather(state.pending_deliver, 0, obs) & src_alive[obs]


def deliver_churn_reports(state, src_alive):
    """``(down, up)`` bool [C, K]: join and leave alerts landing this tick.

    ``churn_deliver[dst]`` is dst's scheduled alert batch, flushed last
    tick. A leaver's K observers (``obs_idx``) each report DOWN; a
    joiner's K gatekeepers (``gk_idx``) each report UP. Rings whose
    source crashed before delivery are dropped."""
    member = state.member[:, None]
    src = torch.where(member, state.obs_idx, state.gk_idx).long()
    ok = state.churn_deliver[:, None] & src_alive[src]
    return ok & member, ok & ~member


def _invalidate(reports, obs, gate, lo, hi):
    """The invalidation fixpoint over ``[..., D, K]`` report planes;
    returns ``(reports, added)``. ``obs`` (int64, same shape) is each
    cell's observer, an index into D; ``gate`` broadcasts to ``reports``.

    One pass is the fixed point: a pass adds cells only to destinations
    at or above L, so the set of such destinations, and with it the
    observers that qualify, never changes, while the in-flux set (at or
    above L, below H) can only shrink. A second pass would add cells only
    where the first one already did.
    """
    counts = reports.sum(dim=-1)
    at_lo = counts >= lo
    flux = at_lo & (counts < hi)
    obs_at_lo = torch.gather(at_lo, -1, obs.flatten(-2)).reshape(obs.shape)
    added = flux[..., None] & obs_at_lo & ~reports & gate
    return reports | added, added


def aggregate(state, delivered_down, delivered_up, any_receiver, settings):
    """One tick of reports into the shared detector.

    Returns ``(reports, seen_down, announce_now, proposal, explicit_added,
    implicit_added, announced)``: the reference's six results, then
    ``announce_now`` as a host bool (one read). ``any_receiver`` (0-d
    bool) gates on an alive receiver; ``delivered_down`` are DOWN alerts
    (kept for member destinations), ``delivered_up`` UP alerts (kept for
    non-members; None when there are none). The invalidation fixpoint
    runs where ``any_new & seen_down``, as in the reference.
    """
    out = aggregate_device(state, delivered_down, delivered_up,
                           any_receiver, settings)
    (announced,) = read_host(out[2])
    return out + (bool(announced),)


def aggregate_device(state, delivered_down, delivered_up, any_receiver,
                     settings):
    """``aggregate``'s six device results, without the read; a fleet maps
    it over its members and reads their ``announce_now`` at once."""
    lo, hi = settings.L, settings.H
    gate = any_receiver & ~state.announced
    member = state.member[:, None]
    new = delivered_down & member & gate
    seen_down = state.seen_down | new.any()
    if delivered_up is not None:
        new = new | (delivered_up & ~member & gate)
    explicit_added = (new & ~state.reports).sum().to(torch.int32)
    reports = state.reports | new
    any_new = new.any()

    eff_obs = torch.where(member, state.obs_idx, state.gk_idx).long()
    reports, added = _invalidate(reports, eff_obs, any_new & seen_down, lo,
                                 hi)
    implicit_added = added.sum().to(torch.int32)

    counts = reports.sum(dim=1)
    crossed = counts >= hi
    in_flux = ((counts >= lo) & (counts < hi)).any()
    announce_now = any_new & ~in_flux & crossed.any() & ~state.announced
    return (reports, seen_down, announce_now, crossed, explicit_added,
            implicit_added)


def receiver_aggregate(reports, member, obs_full, delivered_down, gate,
                       seen_down, settings):
    """Returns ``(reports, seen_down, any_new, in_flux, crossed)``; the
    announce decision is left to the caller. ``gate``/``seen_down`` are
    ``[C]``, ``member`` ``[C, C]``, the rest ``[C, C, K]``."""
    lo, hi = settings.L, settings.H
    new = delivered_down & member[:, :, None] & gate[:, None, None]
    reports = reports | new
    any_new = new.any(dim=2).any(dim=1)
    seen_down = seen_down | any_new
    reports, _ = _invalidate(reports, obs_full.long(),
                             (any_new & seen_down)[:, None, None], lo, hi)
    counts = reports.sum(dim=2)
    in_flux = ((counts >= lo) & (counts < hi)).any(dim=1)
    crossed = counts >= hi
    return reports, seen_down, any_new, in_flux, crossed
