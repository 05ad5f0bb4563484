"""Fault evaluation at a tick (crashes, link windows, link delays, probe
drop) and the shared engine's failure-detector interval.

``tick`` is a host int throughout: both engines keep the tick on the host
(it drives the loop), so ring-slot selection, window phases and the drop
hash's seed need no device sync.
"""
from __future__ import annotations

import torch

from rapid_tpu_torch import hashing
from rapid_tpu_torch.engine.rx_packed import pack_bits
from rapid_tpu_torch.engine.state import EngineFaults


def crashed_at(faults: EngineFaults, tick: int):
    """bool [C]: crashed at ``tick`` (crash_tick <= tick)."""
    return faults.crash_tick <= tick


def link_window_active(faults: EngineFaults, tick: int):
    """bool [W]: which link windows block at delivery tick ``tick``."""
    start = faults.link_start
    in_span = (start <= tick) & (tick < faults.link_end)
    period = torch.clamp(faults.link_period, min=1)
    off_phase = (((tick - start) // period) % 2) == 0
    return in_span & torch.where(faults.link_period > 0, off_phase, True)


def link_blocked(faults: EngineFaults, src_idx, dst_idx, tick: int):
    """Directed link-window drop mask for broadcastable slot-index tensors
    (one masked gather per window, no ``[C, C]`` plane)."""
    shape = torch.broadcast_shapes(src_idx.shape, dst_idx.shape)
    blocked = torch.zeros(shape, dtype=torch.bool,
                          device=faults.crash_tick.device)
    if faults.n_windows == 0:
        return blocked
    src_idx = src_idx.long()
    dst_idx = dst_idx.long()
    active = link_window_active(faults, tick)
    for w in range(faults.n_windows):
        src_w, dst_w = faults.link_src[w], faults.link_dst[w]
        hit = src_w[src_idx] & dst_w[dst_idx]
        hit = hit | (faults.link_two_way[w] & dst_w[src_idx]
                     & src_w[dst_idx])
        blocked = blocked | (active[w] & hit)
    return blocked


def link_blocked_matrix(faults: EngineFaults, tick: int):
    """bool [C, C]: the directed edge drop matrix at delivery tick
    ``tick`` (a self-edge blocks where a slot is in a window's src and
    dst sets); all False without windows. The reference's dense plane;
    the port's deliveries read ``link_blocked_packed``, its bit-planes."""
    c = faults.crash_tick.shape[0]
    blocked = torch.zeros((c, c), dtype=torch.bool,
                          device=faults.crash_tick.device)
    if faults.n_windows == 0:
        return blocked
    active = link_window_active(faults, tick)
    for w in range(faults.n_windows):
        src_w, dst_w = faults.link_src[w], faults.link_dst[w]
        hit = src_w[:, None] & dst_w[None, :]
        hit = hit | (faults.link_two_way[w] & dst_w[:, None]
                     & src_w[None, :])
        blocked = blocked | (active[w] & hit)
    return blocked


def link_blocked_packed(faults: EngineFaults, tick: int):
    """uint8 [C, ceil(C/8)]: the blocked-edge plane as little-endian bit
    planes along the dst axis, built per window from the [C] slot masks;
    pad bits are zero."""
    c = faults.crash_tick.shape[0]
    dev = faults.crash_tick.device
    blocked = torch.zeros((c, -(-c // 8)), dtype=torch.uint8, device=dev)
    if faults.n_windows == 0:
        return blocked
    active = link_window_active(faults, tick)
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    for w in range(faults.n_windows):
        src_w, dst_w = faults.link_src[w], faults.link_dst[w]
        pdst = pack_bits(dst_w)
        psrc = pack_bits(src_w)
        hit = torch.where(src_w[:, None], pdst[None, :], zero)
        hit = hit | torch.where(faults.link_two_way[w] & dst_w[:, None],
                                psrc[None, :], zero)
        blocked = blocked | torch.where(active[w], hit, zero)
    return blocked


def delay_matrix(faults: EngineFaults, tick: int):
    """i32 [C, C]: extra delay of a message sent src->dst at ``tick``.

    Jitter is the high limb of ``hash64(src ^ hash64(dst, seed=tick),
    seed=schedule_seed ^ 0x6A1770)`` mod ``jitter_bound + 1`` (computed on
    int64 limbs, so the reference's uint32 ``%`` is exact here); a rule's
    forward direction wins over its reverse and rules combine by max."""
    c = faults.crash_tick.shape[0]
    dev = faults.crash_tick.device
    total = torch.zeros((c, c), dtype=torch.int32, device=dev)
    if faults.n_delay_rules == 0:
        return total
    slots = torch.arange(c, dtype=torch.int64, device=dev)
    thi, tlo = hashing.hash64_limbs_dynseed(
        torch.zeros_like(slots), slots, 0, tick & hashing.MASK32)
    xhi = thi[None, :].expand(c, c)
    xlo = slots[:, None] ^ tlo[None, :]
    rhi, _ = hashing.hash64_limbs_dynseed(
        xhi, xlo, faults.delay_seed_hi, faults.delay_seed_lo)
    for r in range(faults.n_delay_rules):
        active = (faults.delay_start[r] <= tick) & (tick < faults.delay_end[r])
        src_r, dst_r = faults.delay_src[r], faults.delay_dst[r]
        fwd = src_r[:, None] & dst_r[None, :]
        rev = (faults.delay_rev[r] >= 0) & (dst_r[:, None] & src_r[None, :])
        jit = (rhi % (faults.delay_jit[r].to(torch.int64) + 1)).to(
            torch.int32)
        d = torch.where(fwd, faults.delay_base[r] + jit,
                        torch.where(rev, torch.clamp(faults.delay_rev[r],
                                                     min=0) + jit, 0))
        total = torch.maximum(total, torch.where(active, d, 0).to(
            torch.int32))
    return total


def edge_drop(faults: EngineFaults, src_idx, dst_idx, uid_hi, uid_lo,
              tick: int):
    """bool with the broadcast shape of ``src_idx``/``dst_idx``: the fault
    model drops the ``src -> dst`` probe at ``tick``.

    Drop iff the high limb of ``hash64(src_uid ^ hash64(dst_uid,
    seed=tick), seed=drop_seed ^ 0xD809F)`` is below ``drop_p * 2**32``.
    The reference seeds the inner hash with the tick as a uint32 limb
    pair on the device; here the tick is a host int, so the seed's
    splitmix64 is taken on the host (``hash64_limbs``), which is the
    same hash. ``drop_p == 0`` builds nothing.
    """
    shape = torch.broadcast_shapes(src_idx.shape, dst_idx.shape)
    if faults.drop_p <= 0.0:
        return torch.zeros(shape, dtype=torch.bool, device=uid_hi.device)
    src_idx = src_idx.long()
    dst_idx = dst_idx.long()
    thi, tlo = hashing.hash64_limbs(uid_hi[dst_idx], uid_lo[dst_idx],
                                    seed=tick & hashing.MASK32)
    rhi, _ = hashing.hash64_limbs(uid_hi[src_idx] ^ thi,
                                  uid_lo[src_idx] ^ tlo,
                                  seed=faults.drop_seed ^ 0xD809F)
    drop = rhi < (int(faults.drop_p * float(1 << 32)) & hashing.MASK32)
    if faults.drop_targets is not None:
        applies = torch.zeros(shape, dtype=torch.bool, device=uid_hi.device)
        if faults.drop_ingress:
            applies = applies | faults.drop_targets[dst_idx]
        if faults.drop_egress:
            applies = applies | faults.drop_targets[src_idx]
        drop = drop & applies
    return drop


def monitor_tick(state, faults: EngineFaults, settings, tick: int):
    """One failure-detector interval of every node of the shared state at
    ``tick`` (``state.tick`` as a host int).

    Returns ``(fc, notified, notify_expanded, probes_sent,
    probes_failed)``: a saturated counter notifies once and stops
    probing; every other active edge probes its subject and counts a
    failure when either end is crashed, a link window blocks it, or the
    drop model drops it; ``notify_expanded`` fans each notification out
    to every ring of that subject (``fd_first``).
    """
    crashed = crashed_at(faults, tick)
    subj = state.subj_idx.long()
    obs = torch.arange(subj.shape[0], device=subj.device)[:, None]
    probe_fail = (crashed[subj] | crashed[:, None]
                  | link_blocked(faults, obs, subj, tick)
                  | edge_drop(faults, obs, subj, state.uid_hi, state.uid_lo,
                              tick))
    at_threshold = state.fc >= settings.fd_failure_threshold
    probing = state.fd_active & ~at_threshold
    notify_now = state.fd_active & at_threshold & ~state.notified
    failed = probing & probe_fail
    fc = torch.where(failed, state.fc + 1, state.fc)
    notify_expanded = torch.gather(notify_now, 1, state.fd_first.long())
    return (fc, state.notified | notify_now, notify_expanded,
            probing.sum().to(torch.int32), failed.sum().to(torch.int32))


def partitioned_edge_count(faults: EngineFaults, member, tick: int):
    """i32 gauge: directed member->member pairs blocked by active windows,
    counted per window, self-edges excluded."""
    dev = faults.crash_tick.device
    total = torch.zeros((), dtype=torch.int32, device=dev)
    if faults.n_windows == 0:
        return total
    active = link_window_active(faults, tick)
    for w in range(faults.n_windows):
        count = lambda m: m.sum().to(torch.int32)
        src_m = count(faults.link_src[w] & member)
        dst_m = count(faults.link_dst[w] & member)
        both = count(faults.link_src[w] & faults.link_dst[w] & member)
        pairs = src_m * dst_m - both
        two = torch.where(faults.link_two_way[w], pairs, 0)
        total = total + torch.where(active[w], pairs + two, 0).to(torch.int32)
    return total
