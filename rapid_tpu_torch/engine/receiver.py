"""Per-receiver tick engine: exact link faults, every slot with its own view.

The port of the reference's per-receiver engine under all three
``Settings.rx_kernel`` values, which here choose the carry between ticks
and nothing else: "xla" (the default) carries the dense
``ReceiverState``, "packed" and "pallas" the packed carry of
``rx_packed`` (and run the same code). Every layout delivers through the
hand-written kernel (``rx_account.account_into``) on the card and its
plain version on the CPU; the reference's dense ``_account`` and its
Pallas kernel are bit-identical, so one delivery serves all three.
Each slot carries its own membership view, cut detector and Fast Paxos
instance, and the wire is explicit: a delivery ring ``D`` slots deep
(``Settings.delivery_ring_depth``), indexed by arrival tick mod D, with
link reachability evaluated per (sender, receiver) edge at delivery.

Deliveries at tick ``t`` group as ``2b, 2a, 1b, vote, 1a, batch`` — the
oracle's global send order of the previous tick — and within a group
arrival order is recovered from keys stamped at send time (send tick,
then the announce-order key ``t*(C+1) + ring-0 position``), so the
order-dependent triggers (fast-vote quorum crossing, 1a rank prefix-max,
1b majority crossing and value selection, 2a accept chains) are prefix
reductions over that order. Races deeper than the engine tracks set
sticky ``flags`` bits instead of diverging silently (``check_flags``).

Where the reference lowers to one XLA program, the port runs eagerly:
the tick loop is a host loop (``receiver_simulate`` over the dense carry,
``rx_packed.simulate_chunk`` over the packed one), the tick is a host
int, and the data-dependent branch (the topology rebuild after decides)
reads a 0-d tensor on the host; the cut fixpoint takes one masked pass
(``cut._invalidate``). Work that
the reference does on rows that cannot change (decide waves that decide
nothing, fingerprint matches of empty rows) is skipped after such a
check; what it skips is provably the identity. The reference's two
integer einsums become float32 matmuls on 0/1 operands: their sums stay
below 2**24, so they are exact (TF32 is switched off for them).

A tick delivers first: all six groups' messages sit in the ring slot of
the state the tick starts from, so ``_deliver_all`` makes the six
``rx_deliver`` launches before the groups run (``_tick``). A fleet
(``fleet_step``, ``receiver_fleet_simulate``) makes the same six
launches for all members at once and runs the groups per member as one
batched call, with every row masked where the single cluster skips rows
after a read.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from rapid_tpu_torch import hashing
from rapid_tpu_torch.device import resolve_device
from rapid_tpu_torch.engine import cut, monitor, rx_account
from rapid_tpu_torch.engine.paxos import (
    build_delay_table, classic_rank_index, ring0_positions)
from rapid_tpu_torch.engine.state import (
    I32_MAX, EngineFaults, ReceiverState, ReceiverStepLog, boot_identity,
    config_id_limbs, flag_bit, member_map)
from rapid_tpu_torch.engine.topology import build_topology
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry.trace import span

#: Fallback-delay draws precomputed per slot (one per announce).
N_DRAWS = 4

# Sticky envelope / error bits in ``ReceiverState.flags``.
FLAG_DECIDE_NOT_IN_VIEW = 1
FLAG_DRAWS_EXHAUSTED = 2
FLAG_MULTI_2A_ACCEPTS = 4
FLAG_MULTI_2B_ROUNDS = 8
FLAG_REGISTRY_MISS = 16
FLAG_RING_COLLISION = 32
FLAG_CROSS_PHASE_REORDER = 64
FLAG_EPOCH_DELTA_SAT = 128
FLAG_PACK_NARROW_SAT = 256

_FLAG_NAMES = {
    FLAG_DECIDE_NOT_IN_VIEW: "decide-host-not-in-view",
    FLAG_DRAWS_EXHAUSTED: "fallback-delay-draws-exhausted",
    FLAG_MULTI_2A_ACCEPTS: "more-than-two-same-tick-2a-accepts",
    FLAG_MULTI_2B_ROUNDS: "multiple-2b-rounds-tracked",
    FLAG_REGISTRY_MISS: "proposal-registry-miss",
    FLAG_RING_COLLISION: "delivery-ring-collision",
    FLAG_CROSS_PHASE_REORDER: "cross-phase-send-order-inversion",
    FLAG_EPOCH_DELTA_SAT: "epoch-delta-saturated",
    FLAG_PACK_NARROW_SAT: "packed-narrow-overflow",
}

#: The consensus phases with per-phase message counters.
_PHASES = ("fv", "p1a", "p1b", "p2a", "p2b")

#: A tick's int32 counters in their vector: ``rx_account.account_into``
#: adds delivered, dropped and link_dropped into slots 0-2.
_COUNTERS = (("delivered", "dropped", "link_dropped", "sent")
             + tuple(f"{p}_sent" for p in _PHASES)
             + tuple(f"{p}_delivered" for p in _PHASES))
_SLOT = {name: i for i, name in enumerate(_COUNTERS)}

#: Elements of one ``[rows, C, C]`` temporary in the row-blocked
#: fingerprint matches (the dense form is cubic: 283 GiB at C = 4096).
_BLOCK_ELEMENTS = 1 << 28


class ReceiverEnvelopeError(RuntimeError):
    """A run tripped a sticky envelope flag: its results are not exact."""


def decode_flags(flags) -> List[str]:
    f = int(flags)
    return [name for bit, name in sorted(_FLAG_NAMES.items()) if f & bit]


def check_flags(flags) -> None:
    names = decode_flags(flags)
    if names:
        raise ReceiverEnvelopeError(
            "per-receiver run left the exactness envelope: "
            + ", ".join(names))


def _cfg_eq(a_hi, a_lo, b_hi, b_lo):
    return (a_hi == b_hi) & (a_lo == b_lo)


def _i32(x):
    return x.to(torch.int32)


def _pop(m):
    """Popcount of mask rows, int32."""
    return m.sum(dim=1, dtype=torch.int32)


def _first_true(mask, dim=1):
    """Index of the first True along ``dim`` (0 if none), as argmax does."""
    return torch.argmax(mask.to(torch.uint8), dim=dim)


def _prefmax_excl(vals):
    """Exclusive running max along the last axis (identity = -1)."""
    inc = torch.cummax(vals, dim=-1).values
    pad = torch.full(vals.shape[:-1] + (1,), -1, dtype=vals.dtype,
                     device=vals.device)
    return torch.cat([pad, inc[..., :-1]], dim=-1)


def _proposal_fp_rows(masks, uid_hi, uid_lo):
    """Row-wise proposal fingerprint: ``[R, C]`` masks -> two ``[R]`` limbs."""
    phi, plo = hashing.hash64_limbs(uid_hi, uid_lo, seed=0x70726F70)
    m = masks.to(torch.int64)
    shi, slo = hashing.sum64_axis(phi[None, :] * m, plo[None, :] * m)
    return hashing.splitmix64_limbs(shi, slo)


def _registry_lookup(reg_valid, reg_mask, reg_fp_hi, reg_fp_lo,
                     fp_hi, fp_lo, want):
    """Resolve per-receiver fingerprints ``[R]`` to proposal masks
    ``[R, C]`` via the announce registry; a miss leaves the mask empty."""
    hit = (reg_valid[None, :] & (reg_fp_hi[None, :] == fp_hi[:, None])
           & (reg_fp_lo[None, :] == fp_lo[:, None]))
    found = hit.any(dim=1) & want
    mask = reg_mask[_first_true(hit)] & found[:, None]
    return mask, found, (want & ~found).any()


def _pick_min_seq(mask, seqs):
    """Per row: index of the mask element with the smallest seq key."""
    keyed = torch.where(mask, seqs, I32_MAX)
    return torch.argmin(keyed, dim=1), mask.any(dim=1)


def _arrival_perm(present, ticks, seqs):
    """Sender permutation recovering send order in one ring slot: send
    tick first, then the stamped within-tick key; absent senders last.
    Both sorts are stable, as the reference's."""
    p1 = torch.argsort(torch.where(present, seqs, I32_MAX), stable=True)
    k2 = torch.where(present, ticks, I32_MAX)[p1]
    return p1[torch.argsort(k2, stable=True)]


def _row_blocks(rows, c):
    step = max(1, _BLOCK_ELEMENTS // max(1, c * c))
    for i in range(0, rows.shape[0], step):
        yield rows[i:i + step]


def _over_rows(block, rows, c, dense: bool, outs):
    """``block(rows)`` over row blocks, written into the zero ``outs``.
    ``rows`` (the rows that can be non-zero) found by ``nonzero``; with
    ``dense`` every row, in static blocks written out of place, so a
    fleet maps the step over its members."""
    if dense:
        step = max(1, _BLOCK_ELEMENTS // max(1, c * c))
        parts = [block(slice(i, i + step)) for i in range(0, c, step)]
        return tuple(torch.cat(col) for col in zip(*parts))
    for blk in _row_blocks(torch.nonzero(rows).flatten(), c):
        for out, part in zip(outs, block(blk)):
            out[blk] = part
    return outs


def _pb_occurrences(fp_hi, fp_lo, coll, seq, dense=False):
    """Per receiver row r, over its collected 1b values: whether two
    differ (``uneq[r]``) and, per value i, how many equal values arrived
    earlier (``occ[r, i]``). Blocks of rows, never a ``[C, C, C]`` plane;
    rows with nothing collected are 0 / False."""
    c = coll.shape[1]

    def block(blk):
        h, lo, cl, s = fp_hi[blk], fp_lo[blk], coll[blk], seq[blk]
        eq = ((h[:, :, None] == h[:, None, :])
              & (lo[:, :, None] == lo[:, None, :]))
        uneq = (cl[:, :, None] & cl[:, None, :] & ~eq).flatten(1).any(dim=1)
        occ = (cl[:, None, :] & eq & (s[:, None, :] < s[:, :, None])).sum(
            dim=2, dtype=torch.int32)
        return uneq, occ

    return _over_rows(block, coll.any(dim=1), c, dense, (
        torch.zeros(c, dtype=torch.bool, device=coll.device),
        torch.zeros((c, c), dtype=torch.int32, device=coll.device)))


def _vote_baseline(vt_fp_hi, vt_fp_lo, vt_seen, wv_hi, wv_lo, dense=False):
    """``[C, C]``: per receiver row, the stored votes equal to each
    arriving fingerprint (arrival order). Blocks of rows; rows with no
    stored vote are 0."""
    c = vt_seen.shape[1]

    def block(blk):
        eq = ((vt_fp_hi[blk][:, :, None] == wv_hi[None, None, :])
              & (vt_fp_lo[blk][:, :, None] == wv_lo[None, None, :]))
        return ((vt_seen[blk][:, :, None] & eq).sum(dim=1,
                                                    dtype=torch.int32),)

    return _over_rows(block, vt_seen.any(dim=1), c, dense, (torch.zeros(
        (vt_seen.shape[0], wv_hi.shape[0]), dtype=torch.int32,
        device=vt_seen.device),))[0]


def _matmul_count(a, b):
    """``a @ b`` for 0/1 bool operands as exact int32 counts. The sums
    are below 2**24, so float32 accumulates them exactly in any order."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return _i32(a.to(torch.float32) @ b.to(torch.float32))


class _Vars:
    """Mutable working copy of the per-tick state."""

    def __init__(self, rs: ReceiverState):
        for name in ReceiverState._fields:
            setattr(self, name, getattr(rs, name))


def _apply_decides(v: _Vars, t: int, dm, hosts, ridx, dense: bool):
    """Apply a wave of view-change decides: remove ``hosts[r]`` from
    ``r``'s view where ``dm[r]``, recompute cfg, reset per-config state.
    The alert queue (``pf``) is deliberately not reset. A wave that
    decides nothing changes nothing, and is skipped (one read), except
    under ``dense``, where every row is masked by ``dm``."""
    if not dense and not bool(dm.any()):
        return v.cfg_hi, v.cfg_lo
    bad = dm & (hosts & ~v.member).any(dim=1)
    v.flags = v.flags | flag_bit(bad.any(), FLAG_DECIDE_NOT_IN_VIEW)
    hosts = hosts & v.member & dm[:, None]

    hm = hosts.to(torch.int64)
    rem_hi, rem_lo = hashing.sum64_axis(v.mfp_hi[None, :] * hm,
                                        v.mfp_lo[None, :] * hm)
    ms_hi, ms_lo = hashing.sub64(v.memsum_hi, v.memsum_lo, rem_hi, rem_lo)
    v.memsum_hi = torch.where(dm, ms_hi, v.memsum_hi)
    v.memsum_lo = torch.where(dm, ms_lo, v.memsum_lo)
    cfg2_hi, cfg2_lo = config_id_limbs(v.idsum_hi, v.idsum_lo,
                                       v.memsum_hi, v.memsum_lo)
    v.cfg_hi = torch.where(dm, cfg2_hi, v.cfg_hi)
    v.cfg_lo = torch.where(dm, cfg2_lo, v.cfg_lo)

    v.member = v.member & ~hosts
    v.epoch = v.epoch + _i32(dm)
    self_in = v.member[ridx, ridx]
    v.stopped = v.stopped | (dm & ~self_in)
    v.px_n = torch.where(dm, _pop(v.member), v.px_n)

    z1, z2, z3 = dm, dm[:, None], dm[:, None, None]
    v.reports = v.reports & ~z3
    v.seen_down = v.seen_down & ~z1
    v.announced = v.announced & ~z1
    v.ar_seq = torch.where(z1, I32_MAX, v.ar_seq)
    v.fc = torch.where(z2, 0, v.fc)
    v.notified = v.notified & ~z2
    v.fd_gate = torch.where(z1, t, v.fd_gate)
    v.vt_seen = v.vt_seen & ~z2
    v.px_rnd_r = torch.where(z1, 0, v.px_rnd_r)
    v.px_rnd_i = torch.where(z1, 0, v.px_rnd_i)
    v.px_vrnd_r = torch.where(z1, 0, v.px_vrnd_r)
    v.px_vrnd_i = torch.where(z1, 0, v.px_vrnd_i)
    v.px_vv_set = v.px_vv_set & ~z1
    v.px_crnd_r = torch.where(z1, 0, v.px_crnd_r)
    v.px_cval_set = v.px_cval_set & ~z1
    v.px_timer = torch.where(z1, I32_MAX, v.px_timer)
    v.pb_seen = v.pb_seen & ~z2
    v.p2_rnd = torch.where(z1, -1, v.p2_rnd)
    v.p2_seen = v.p2_seen & ~z2
    return v.cfg_hi, v.cfg_lo


def _deliver_all(rs: ReceiverState, faults: EngineFaults, t: int,
                 settings: Settings):
    """The tick's six deliveries, ``rx_account.account_into`` once per
    group in the order ``2b, 2a, 1b, vote, 1a, batch``: every group's
    messages sit in ring slot ``t % D`` of the state the tick starts
    from, so all six are known before the groups run. Returns
    ``(crashed, delivered planes, acc)``: the counter vector ``acc`` holds
    the delivery counts. Takes one member or a fleet (a leading member
    axis on every tensor): the kernel covers all members in each launch.
    """
    dev = rs.member.device
    am = t % settings.delivery_ring_depth
    crashed = monitor.crashed_at(faults, t)
    if rs.member.dim() == 2:
        emat = monitor.link_blocked_packed(faults, t)
    else:
        emat = member_map(lambda fl: monitor.link_blocked_packed(fl, t),
                          faults).contiguous()
    acc = torch.zeros(crashed.shape[:-1] + (len(_COUNTERS),),
                      dtype=torch.int32, device=dev)
    ring = lambda plane, dims: plane.select(plane.dim() - dims, am)
    pd_ring = ring(rs.pd, 3)
    groups = ((ring(rs.w2b, 4), "p2b"), (ring(rs.w2a, 3), "p2a"),
              (ring(rs.w1b, 3), "p1b"), (ring(rs.wv, 3), "fv"),
              (ring(rs.w1a, 3), "p1a"),
              (pd_ring.any(dim=-1)[..., :, None] & ring(rs.pd_bcast, 3),
               None))
    planes = [rx_account.account_into(
        msgs.contiguous(), crashed, emat, acc,
        None if phase is None else _SLOT[f"{phase}_delivered"])
        for msgs, phase in groups]
    return crashed, planes, acc


def receiver_step(rs: ReceiverState, faults: EngineFaults,
                  settings: Settings, tick: Optional[int] = None
                  ) -> Tuple[ReceiverState, ReceiverStepLog]:
    """One tick of the per-receiver engine (module docstring: group order
    and its equivalence to the oracle's send order). ``tick`` is
    ``rs.tick`` as a host int, read from the state when omitted."""
    t = (int(rs.tick) if tick is None else int(tick)) + 1
    with span("rapid.rx.deliver"):
        crashed, planes, acc = _deliver_all(rs, faults, t, settings)
    return _tick(rs, faults, settings, t, crashed, planes, acc, False)


def fleet_step(rs: ReceiverState, faults: EngineFaults, settings: Settings,
               tick: int) -> Tuple[ReceiverState, ReceiverStepLog]:
    """One tick of a fleet (the member axis first on every tensor): the
    six deliveries launch once each for all members, the groups run per
    member as one batched call (``member_map``) with every row masked,
    and ``tick`` is the members' common ``rs.tick``."""
    t = int(tick) + 1
    with span("rapid.rx.deliver"):
        crashed, planes, acc = _deliver_all(rs, faults, t, settings)
    return member_map(
        lambda r, fl, cr, pl, a: _tick(r, fl, settings, t, cr, pl, a, True),
        rs, faults, crashed, planes, acc)


def _tick(rs: ReceiverState, faults: EngineFaults, settings: Settings,
          t: int, crashed, planes, acc, dense: bool):
    """The groups of tick ``t`` after the deliveries ``planes``, whose
    counts ``acc`` holds; ``dense`` takes every row where a read would
    skip some (the fleet's per-member map)."""
    v = _Vars(rs)
    c = rs.member.shape[0]
    k = rs.ring_order.shape[1]
    dev = rs.member.device
    ridx = torch.arange(c, device=dev)
    jidx = ridx
    D = settings.delivery_ring_depth
    am = t % D                  # ring slot arriving this tick
    dv2, dv2a, dv1b, dvv, dv1a, dvpd = planes
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    # The tick's sends, added to the delivery counts at the end.
    sent = dict.fromkeys(("sent",) + tuple(f"{p}_sent" for p in _PHASES),
                         zero)

    dec = {"mask": torch.zeros(c, dtype=torch.bool, device=dev),
           "hosts": torch.zeros((c, c), dtype=torch.bool, device=dev),
           "cfg_hi": torch.zeros(c, dtype=torch.int64, device=dev),
           "cfg_lo": torch.zeros(c, dtype=torch.int64, device=dev)}

    def send(phase, n):
        sent[f"{phase}_sent"] = sent[f"{phase}_sent"] + n
        sent["sent"] = sent["sent"] + n

    def record_decides(dm, hosts, cfg_hi, cfg_lo):
        dec["mask"] = dec["mask"] | dm
        dec["hosts"] = torch.where(dm[:, None], hosts, dec["hosts"])
        dec["cfg_hi"] = torch.where(dm, cfg_hi, dec["cfg_hi"])
        dec["cfg_lo"] = torch.where(dm, cfg_lo, dec["cfg_lo"])

    def cfg_gate(cfg_hi_r, cfg_lo_r):
        return _cfg_eq(cfg_hi_r[None, :], cfg_lo_r[None, :],
                       v.cfg_hi[:, None], v.cfg_lo[:, None])

    # ---- group 1: phase-2b delivery -> decide wave A --------------------
    with span("rapid.rx.p2b"):
        w2b_ring = rs.w2b[am]
        w2b_rnd_r = rs.w2b_rnd[am]
        w2b_mask_r = rs.w2b_mask[am]
        w2b_cfg = cfg_gate(rs.w2b_cfg_hi[am], rs.w2b_cfg_lo[am])
        gates = [dv2[slot].T & ~v.stopped[:, None] & w2b_cfg
                 for slot in (0, 1)]
        g2b_any = (gates[0] | gates[1]).any(dim=1)
        rnd0 = torch.where(gates[0], w2b_rnd_r[0][None, :], -1)
        rnd1 = torch.where(gates[1], w2b_rnd_r[1][None, :], -1)
        mx_in = torch.maximum(rnd0.amax(dim=1), rnd1.amax(dim=1))
        mx = torch.maximum(v.p2_rnd, mx_in)
        reset = mx > v.p2_rnd
        use0 = gates[0] & (w2b_rnd_r[0][None, :] == mx[:, None])
        use1 = gates[1] & (w2b_rnd_r[1][None, :] == mx[:, None])
        low_seen = ((gates[0] & ~use0).any() | (gates[1] & ~use1).any()
                    | (reset & (v.p2_rnd >= 0) & v.p2_seen.any(dim=1)).any())
        v.flags = v.flags | flag_bit(low_seen, FLAG_MULTI_2B_ROUNDS)
        add = use0 | use1
        v.p2_seen = (v.p2_seen & ~reset[:, None]) | add
        a_star = _first_true(add)
        pick0 = use0[ridx, a_star]
        gathered = torch.where(pick0[:, None], w2b_mask_r[0][a_star],
                               w2b_mask_r[1][a_star])
        refresh = reset & add.any(dim=1)
        v.p2_mask = torch.where(refresh[:, None], gathered, v.p2_mask)
        v.p2_rnd = mx
        dec_a = (_pop(v.p2_seen) > v.px_n // 2) & add.any(dim=1)
        hosts_a = v.p2_mask & dec_a[:, None]

    # ---- group 2: apply decide wave A -----------------------------------
    with span("rapid.rx.decide_a"):
        ncfg_hi, ncfg_lo = _apply_decides(v, t, dec_a, hosts_a, ridx, dense)
        record_decides(dec_a, hosts_a, ncfg_hi, ncfg_lo)

    # ---- group 3: phase-2a delivery -> accept chain -> 2b emission ------
    with span("rapid.rx.p2a"):
        w2a_ring = rs.w2a[am]
        w2a_fp_hi_r, w2a_fp_lo_r = rs.w2a_fp_hi[am], rs.w2a_fp_lo[am]
        w2a_mask_arr = rs.w2a_mask[am]
        gate = (dv2a.T & ~v.stopped[:, None]
                & cfg_gate(rs.w2a_cfg_hi[am], rs.w2a_cfg_lo[am]))
        send2a_min = torch.where(gate, rs.w2a_tick[am][None, :],
                                 I32_MAX).amin(dim=1)
        send2a_max = torch.where(gate, rs.w2a_tick[am][None, :],
                                 -1).amax(dim=1)
        perm3 = _arrival_perm(w2a_ring.any(dim=1), rs.w2a_tick[am],
                              rs.w2a_seq[am])
        gate_s = gate[:, perm3]
        rank_j = rs.rank_idx[perm3]
        ge0 = ((v.px_rnd_r[:, None] < 2)
               | ((v.px_rnd_r[:, None] == 2)
                  & (v.px_rnd_i[:, None] <= rank_j[None, :])))
        ne0 = ~((v.px_vrnd_r[:, None] == 2)
                & (v.px_vrnd_i[:, None] == rank_j[None, :]))
        arrived = torch.where(gate_s, rank_j[None, :], -1)
        accept = (gate_s & ge0 & ne0
                  & (rank_j[None, :] > _prefmax_excl(arrived)))
        n_acc = _pop(accept)
        v.flags = v.flags | flag_bit((n_acc > 2).any(), FLAG_MULTI_2A_ACCEPTS)
        j1 = _first_true(accept)
        j2 = _first_true(accept & (jidx[None, :] > j1[:, None]))
        jl = c - 1 - _first_true(accept.flip(1))
        c1, c2, cl = perm3[j1], perm3[j2], perm3[jl]
        emit0 = n_acc >= 1
        emit1 = n_acc >= 2
        w2b_rnd_new = torch.stack([rs.rank_idx[c1], rs.rank_idx[c2]])
        w2b_fp_hi_new = torch.stack([w2a_fp_hi_r[c1], w2a_fp_hi_r[c2]])
        w2b_fp_lo_new = torch.stack([w2a_fp_lo_r[c1], w2a_fp_lo_r[c2]])
        w2b_mask_new = torch.stack([w2a_mask_arr[c1], w2a_mask_arr[c2]])
        w2b_cfg_hi_new, w2b_cfg_lo_new = v.cfg_hi, v.cfg_lo
        # Recipient snapshot here: wave-B decides below must not shrink this
        # tick's fan (the oracle sends 2b during 2a delivery).
        w2b_fan = torch.stack([emit0[:, None] & v.member,
                               emit1[:, None] & v.member])
        send("p2b", _i32((emit0 * _pop(v.member)
                          + emit1 * _pop(v.member)).sum()))
        rank_last = rs.rank_idx[cl]
        v.px_rnd_r = torch.where(emit0, 2, v.px_rnd_r)
        v.px_rnd_i = torch.where(emit0, rank_last, v.px_rnd_i)
        v.px_vrnd_r = torch.where(emit0, 2, v.px_vrnd_r)
        v.px_vrnd_i = torch.where(emit0, rank_last, v.px_vrnd_i)
        v.px_vv_fp_hi = torch.where(emit0, w2a_fp_hi_r[cl], v.px_vv_fp_hi)
        v.px_vv_fp_lo = torch.where(emit0, w2a_fp_lo_r[cl], v.px_vv_fp_lo)
        v.px_vv_set = v.px_vv_set | emit0

    # ---- group 4: phase-1b delivery -> crossing + selection -> 2a -------
    with span("rapid.rx.p1b"):
        w1b_ring = rs.w1b[am]
        w1b_set_r = rs.w1b_set[am]
        gate = (dv1b.T & ~v.stopped[:, None] & (v.px_crnd_r[:, None] == 2)
                & cfg_gate(rs.w1b_cfg_hi[am], rs.w1b_cfg_lo[am]))
        new = gate & ~v.pb_seen
        seq_in = rs.w1b_seq[am]      # send key: tick*(C+1) + promiser rx_pos
        t1b = seq_in // (c + 1)
        send1b_min = torch.where(new, t1b[None, :], I32_MAX).amin(dim=1)
        send1b_max = torch.where(new, t1b[None, :], -1).amax(dim=1)
        v.pb_seen = v.pb_seen | new
        v.pb_vrnd_r = torch.where(new, rs.w1b_vrnd_r[am][None, :], v.pb_vrnd_r)
        v.pb_vrnd_i = torch.where(new, rs.w1b_vrnd_i[am][None, :], v.pb_vrnd_i)
        v.pb_fp_hi = torch.where(new, rs.w1b_fp_hi[am][None, :], v.pb_fp_hi)
        v.pb_fp_lo = torch.where(new, rs.w1b_fp_lo[am][None, :], v.pb_fp_lo)
        v.pb_set = torch.where(new, w1b_set_r[None, :], v.pb_set)
        v.pb_seq = torch.where(new, seq_in[None, :], v.pb_seq)

        prior = v.pb_seen & ~new
        prior_tot = _pop(prior)
        prior_ne = _pop(prior & v.pb_set)
        perm2 = torch.argsort(
            torch.where(w1b_ring.any(dim=1), seq_in, I32_MAX), stable=True)
        new_s = new[:, perm2]
        ne_new_s = new_s & w1b_set_r[perm2][None, :]
        cum_tot = prior_tot[:, None] + torch.cumsum(new_s, dim=1,
                                                    dtype=torch.int32)
        cum_ne = prior_ne[:, None] + torch.cumsum(ne_new_s, dim=1,
                                                  dtype=torch.int32)
        thr = v.px_n // 2 + 1
        elig = new_s & (cum_tot >= thr[:, None]) & (cum_ne >= 1)
        cross = elig.any(dim=1) & ~v.px_cval_set
        sstar = seq_in[perm2[_first_true(elig)]]
        prefix = v.pb_seen & (v.pb_seq <= sstar[:, None])

        mr = torch.where(prefix, v.pb_vrnd_r, -1).amax(dim=1)
        at_mr = prefix & (v.pb_vrnd_r == mr[:, None])
        mi = torch.where(at_mr, v.pb_vrnd_i, -1).amax(dim=1)
        maxmask = at_mr & (v.pb_vrnd_i == mi[:, None])
        collected = maxmask & v.pb_set
        ncoll = _pop(collected)
        with span("rapid.rx.match"):
            pair_uneq, occ = _pb_occurrences(v.pb_fp_hi, v.pb_fp_lo,
                                             collected, v.pb_seq, dense)
        single = (ncoll >= 1) & ~pair_uneq
        cand = collected & pair_uneq[:, None] & (occ == (v.px_n // 4)[:, None])
        d_single, _ = _pick_min_seq(collected, v.pb_seq)
        d_cand, has_cand = _pick_min_seq(cand, v.pb_seq)
        d_fall, _ = _pick_min_seq(prefix & v.pb_set, v.pb_seq)
        d_star = torch.where(single, d_single,
                             torch.where(has_cand, d_cand, d_fall))
        chosen_fp_hi = v.pb_fp_hi[ridx, d_star]
        chosen_fp_lo = v.pb_fp_lo[ridx, d_star]
        res_mask, _, miss = _registry_lookup(
            v.reg_valid, v.reg_mask, v.reg_fp_hi, v.reg_fp_lo,
            chosen_fp_hi, chosen_fp_lo, cross)
        v.flags = v.flags | flag_bit(miss, FLAG_REGISTRY_MISS)
        w2a_fp_hi_new = torch.where(cross, chosen_fp_hi, 0)
        w2a_fp_lo_new = torch.where(cross, chosen_fp_lo, 0)
        w2a_mask_new = res_mask
        w2a_cfg_hi_new, w2a_cfg_lo_new = v.cfg_hi, v.cfg_lo
        w2a_seq_new = v.ar_seq
        # Snapshot before wave-B decides can shrink the view.
        w2a_fan = cross[:, None] & v.member
        v.px_cval_set = v.px_cval_set | cross
        send("p2a", _i32((cross * _pop(v.member)).sum()))

    # ---- group 5: fast-vote delivery -> decide wave B -------------------
    with span("rapid.rx.vote"):
        wv_ring = rs.wv[am]
        wv_fp_hi_r, wv_fp_lo_r = rs.wv_fp_hi[am], rs.wv_fp_lo[am]
        gate = (dvv.T & ~v.stopped[:, None]
                & cfg_gate(rs.wv_cfg_hi[am], rs.wv_cfg_lo[am]))
        process = gate & ~v.vt_seen
        # A vote's send tick is its announce tick.
        tv = rs.wv_seq[am] // (c + 1)
        sendv_min = torch.where(process, tv[None, :], I32_MAX).amin(dim=1)
        sendv_max = torch.where(process, tv[None, :], -1).amax(dim=1)
        perm_v = torch.argsort(
            torch.where(wv_ring.any(dim=1), rs.wv_seq[am], I32_MAX),
            stable=True)
        proc_s = process[:, perm_v]
        wv_hi_p = wv_fp_hi_r[perm_v]
        wv_lo_p = wv_fp_lo_r[perm_v]
        with span("rapid.rx.match"):
            baseline = _vote_baseline(v.vt_fp_hi, v.vt_fp_lo, v.vt_seen,
                                      wv_hi_p, wv_lo_p, dense)
        prior_tot = _pop(v.vt_seen)
        # Arrival-prefix counts of equal fingerprints, in announce order.
        fp_eq_wire = ((wv_hi_p[:, None] == wv_hi_p[None, :])
                      & (wv_lo_p[:, None] == wv_lo_p[None, :]))
        lower_tri = jidx[None, :] <= jidx[:, None]          # [j, j2]: j2 <= j
        prefix_cnt = _matmul_count(proc_s, (fp_eq_wire & lower_tri).T)
        count_after = baseline + prefix_cnt
        total_after = prior_tot[:, None] + torch.cumsum(proc_s, dim=1,
                                                        dtype=torch.int32)
        quorum = v.px_n - (v.px_n - 1) // 4
        trig = (proc_s & (count_after >= quorum[:, None])
                & (total_after >= quorum[:, None]))
        dec_b = trig.any(dim=1)
        win = perm_v[_first_true(trig)]
        hosts_b, _, miss = _registry_lookup(
            v.reg_valid, v.reg_mask, v.reg_fp_hi, v.reg_fp_lo,
            wv_fp_hi_r[win], wv_fp_lo_r[win], dec_b)
        v.flags = v.flags | flag_bit(miss, FLAG_REGISTRY_MISS)
        v.vt_seen = v.vt_seen | process
        v.vt_fp_hi = torch.where(process, wv_fp_hi_r[None, :], v.vt_fp_hi)
        v.vt_fp_lo = torch.where(process, wv_fp_lo_r[None, :], v.vt_fp_lo)

    # ---- group 6: apply decide wave B -----------------------------------
    with span("rapid.rx.decide_b"):
        ncfg_hi, ncfg_lo = _apply_decides(v, t, dec_b, hosts_b, ridx, dense)
        record_decides(dec_b, hosts_b, ncfg_hi, ncfg_lo)

    # ---- group 7: phase-1a delivery -> promises -> 1b emission ----------
    with span("rapid.rx.p1a"):
        w1a_ring = rs.w1a[am]
        gate = (dv1a.T & ~v.stopped[:, None]
                & cfg_gate(rs.w1a_cfg_hi[am], rs.w1a_cfg_lo[am]))
        send1a_min = torch.where(gate, rs.w1a_tick[am][None, :],
                                 I32_MAX).amin(dim=1)
        perm1 = _arrival_perm(w1a_ring.any(dim=1), rs.w1a_tick[am],
                              rs.w1a_seq[am])
        gate_s = gate[:, perm1]
        rank_j = rs.rank_idx[perm1]
        above_cur = ((v.px_rnd_r[:, None] < 2)
                     | ((v.px_rnd_r[:, None] == 2)
                        & (v.px_rnd_i[:, None] < rank_j[None, :])))
        arrived = torch.where(gate_s, rank_j[None, :], -1)
        promise_s = gate_s & above_cur & (rank_j[None, :]
                                          > _prefmax_excl(arrived))
        pr_any = promise_s.any(dim=1)
        max_promised = torch.where(promise_s, rank_j[None, :], -1).amax(dim=1)
        v.px_rnd_r = torch.where(pr_any, 2, v.px_rnd_r)
        v.px_rnd_i = torch.where(pr_any, max_promised, v.px_rnd_i)
        inv1 = torch.argsort(perm1)                  # the inverse permutation
        promise = promise_s[:, inv1]                 # back to slot coordinates
        w1b_new = promise
        w1b_vrnd_r_new, w1b_vrnd_i_new = v.px_vrnd_r, v.px_vrnd_i
        w1b_fp_hi_new, w1b_fp_lo_new = v.px_vv_fp_hi, v.px_vv_fp_lo
        w1b_set_new = v.px_vv_set
        w1b_cfg_hi_new, w1b_cfg_lo_new = v.cfg_hi, v.cfg_lo
        send("p1b", _i32(promise.sum()))

    # ---- cross-phase send-order guard -----------------------------------
    with span("rapid.rx.guard"):
        # The fixed group order equals the oracle's send order only while a
        # tick's processed arrivals left the wire in group order; a delayed
        # older send behind a fresher earlier-processed group sets a flag. A
        # gated 2b arrival counts as sent at t-1, the conservative maximum.
        run_max = _i32(torch.where(g2b_any, t - 1, -1))
        inv = send2a_min < run_max
        run_max = torch.maximum(run_max, send2a_max)
        inv |= send1b_min < run_max
        run_max = torch.maximum(run_max, send1b_max)
        inv |= sendv_min < run_max
        run_max = torch.maximum(run_max, sendv_max)
        inv |= send1a_min < run_max
        v.flags = v.flags | flag_bit(inv.any(), FLAG_CROSS_PHASE_REORDER)

    # ---- group 8: batch delivery -> cut aggregation -> announce ---------
    with span("rapid.rx.batch"):
        pd_ring = rs.pd[am]
        recv = (dvpd.T & ~v.stopped[:, None] & ~v.announced[:, None]
                & cfg_gate(rs.pd_cfg_hi[am], rs.pd_cfg_lo[am]))
        # down[r, d, k] = any_s recv[r, s] & pd[s, k] & (pd_dst[s, k] == d)
        onehot = (pd_ring[:, :, None]
                  & (rs.pd_dst[am][:, :, None] == ridx[None, None, :]))
        down = (_matmul_count(recv, onehot.reshape(c, k * c)) > 0).reshape(
            c, k, c).transpose(1, 2)
        gate8 = ~v.announced & ~v.stopped
        (v.reports, v.seen_down, any_new, in_flux, crossed) = \
            cut.receiver_aggregate(v.reports, v.member, v.obs_full, down,
                                   gate8, v.seen_down, settings)
        announce = (any_new & ~in_flux & crossed.any(dim=1)
                    & ~v.announced & ~v.stopped)
        prop_fp_hi, prop_fp_lo = _proposal_fp_rows(crossed, v.uid_hi, v.uid_lo)
        v.announced = v.announced | announce
        v.ar_seq = torch.where(announce, t * (c + 1) + v.rx_pos, v.ar_seq)
        v.reg_valid = v.reg_valid | announce
        v.reg_mask = torch.where(announce[:, None], crossed, v.reg_mask)
        v.reg_fp_hi = torch.where(announce, prop_fp_hi, v.reg_fp_hi)
        v.reg_fp_lo = torch.where(announce, prop_fp_lo, v.reg_fp_lo)
        wv_fp_hi_new = torch.where(announce, prop_fp_hi, 0)
        wv_fp_lo_new = torch.where(announce, prop_fp_lo, 0)
        wv_cfg_hi_new, wv_cfg_lo_new = v.cfg_hi, v.cfg_lo
        wv_seq_new = v.ar_seq
        wv_fan = announce[:, None] & v.member
        send("fv", _i32((announce * _pop(v.member)).sum()))
        # Seed the fast round unless classic activity already raised the rnd.
        seed_px = announce & (v.px_rnd_r <= 1)
        v.px_rnd_r = torch.where(seed_px, 1, v.px_rnd_r)
        v.px_rnd_i = torch.where(seed_px, 1, v.px_rnd_i)
        v.px_vrnd_r = torch.where(seed_px, 1, v.px_vrnd_r)
        v.px_vrnd_i = torch.where(seed_px, 1, v.px_vrnd_i)
        v.px_vv_fp_hi = torch.where(seed_px, prop_fp_hi, v.px_vv_fp_hi)
        v.px_vv_fp_lo = torch.where(seed_px, prop_fp_lo, v.px_vv_fp_lo)
        v.px_vv_set = v.px_vv_set | seed_px
        # Arm the recovery timer with the slot's next precomputed delay draw.
        d_idx = torch.clamp(v.draws, 0, N_DRAWS - 1).long()
        m_idx = torch.clamp(v.px_n, 0, c).long()
        delay = v.delay_table[ridx, d_idx, m_idx]
        v.flags = v.flags | flag_bit((announce & (v.draws >= N_DRAWS)).any(),
                                  FLAG_DRAWS_EXHAUSTED)
        v.px_timer = torch.where(announce, t + delay, v.px_timer)
        v.draws = v.draws + _i32(announce)
        ann_cfg_hi, ann_cfg_lo = v.cfg_hi, v.cfg_lo
        ann_prop = crossed & announce[:, None]

    # ---- group 9: recovery timers fire -> 1a emission -------------------
    with span("rapid.rx.timers"):
        fire = v.px_timer == t
        v.px_crnd_r = torch.where(fire, 2, v.px_crnd_r)
        v.px_timer = torch.where(fire, I32_MAX, v.px_timer)
        w1a_cfg_hi_new, w1a_cfg_lo_new = v.cfg_hi, v.cfg_lo
        w1a_seq_new = v.ar_seq
        w1a_fan = fire[:, None] & v.member
        send("p1a", _i32((fire * _pop(v.member)).sum()))

    # ---- group 10: failure detectors ------------------------------------
    with span("rapid.rx.fd"):
        if t % settings.fd_interval_ticks == 0:
            is_fd = (v.fd_gate < t) & ~v.stopped
        else:
            is_fd = torch.zeros_like(v.stopped)
        at_thr = v.fc >= settings.fd_failure_threshold
        probing = v.own_fd_active & ~at_thr & is_fd[:, None]
        subj = v.own_subj.long()
        # Lazy per-edge reachability: W masked gathers, never a [C, C] plane.
        probe_fail = (crashed[subj] | crashed[:, None]
                      | monitor.link_blocked(
                          faults, ridx[:, None].expand_as(subj), subj, t))
        probes_sent = _i32(probing.sum())
        probes_failed = _i32((probing & probe_fail).sum())
        v.fc = torch.where(probing & probe_fail, v.fc + 1, v.fc)
        notify_now = v.own_fd_active & at_thr & ~v.notified & is_fd[:, None]
        v.notified = v.notified | notify_now
        pf_new = torch.gather(notify_now, 1, v.own_fd_first.long())

    # ---- group 11: batcher flush (last tick's queue -> the wire) --------
    with span("rapid.rx.flush"):
        flush = rs.pf.any(dim=1) & ~v.stopped
        pd_new = rs.pf & flush[:, None]
        pd_dst_new = rs.pf_dst
        pd_cfg_hi_new, pd_cfg_lo_new = rs.pf_cfg_hi, rs.pf_cfg_lo
        pd_fan = flush[:, None] & v.member
        sent["sent"] = sent["sent"] + _i32((flush * _pop(v.member)).sum())
        v.pf = pf_new
        v.pf_dst = v.own_subj
        v.pf_cfg_hi, v.pf_cfg_lo = v.cfg_hi, v.cfg_lo

    # ---- group 12: topology rebuild after decides -----------------------
    with span("rapid.rx.rebuild"):
        # One read skips it on a tick without decides; ``dense`` rebuilds and
        # keeps the old rows where the member decided nothing.
        if dense or bool(dec["mask"].any()):
            subj_all, obs_all, _gk, fda_all, fdf_all = build_topology(
                v.member, rs.ring_order, rs.ring_rank)
            pos_all = ring0_positions(v.member, rs.ring_order, rs.ring_rank)
            pick = lambda new, old: torch.where(dec["mask"].any(), new, old)
            v.obs_full = pick(obs_all, v.obs_full)
            v.own_subj = pick(subj_all[ridx, ridx], v.own_subj)
            v.own_fd_active = pick(fda_all[ridx, ridx], v.own_fd_active)
            v.own_fd_first = pick(fdf_all[ridx, ridx], v.own_fd_first)
            v.rx_pos = pick(pos_all[ridx, ridx], v.rx_pos)

    # ---- finalize: rotate the delivery ring ------------------------------
    with span("rapid.rx.finalize"):
        # A message sent this tick lands in ring slot (t + 1 + delay) % D, the
        # delay evaluated at send time. Slot ``am`` was consumed this tick and
        # is cleared before inserts; a (slot, sender) overlap means two
        # same-kind messages jittered onto one arrival tick: flagged.
        dmat = monitor.delay_matrix(faults, t)
        darange = torch.arange(D, device=dev)
        keep = (darange != am)[:, None, None]
        slot_hit = ((t + 1 + dmat) % D)[None, :, :] == darange[:, None, None]
        hits = []

        def ring_put(ring, fan):
            cleared = ring & keep
            ins = slot_hit & fan[None]
            landed = ins.any(dim=-1)
            return cleared | ins, landed, (cleared.any(dim=-1) & landed).any()

        def stamp(old, new, landed):
            mask = landed.reshape(landed.shape
                                  + (1,) * (old.dim() - landed.dim()))
            return torch.where(mask, new[None], old)

        v.tick = torch.tensor(t, dtype=torch.int32, device=dev)
        v.wv, landed, hit_old = ring_put(rs.wv, wv_fan)
        hits.append(hit_old)
        v.wv_fp_hi = stamp(rs.wv_fp_hi, wv_fp_hi_new, landed)
        v.wv_fp_lo = stamp(rs.wv_fp_lo, wv_fp_lo_new, landed)
        v.wv_cfg_hi = stamp(rs.wv_cfg_hi, wv_cfg_hi_new, landed)
        v.wv_cfg_lo = stamp(rs.wv_cfg_lo, wv_cfg_lo_new, landed)
        v.wv_seq = stamp(rs.wv_seq, wv_seq_new, landed)

        v.w1a, landed, hit_old = ring_put(rs.w1a, w1a_fan)
        hits.append(hit_old)
        v.w1a_cfg_hi = stamp(rs.w1a_cfg_hi, w1a_cfg_hi_new, landed)
        v.w1a_cfg_lo = stamp(rs.w1a_cfg_lo, w1a_cfg_lo_new, landed)
        v.w1a_seq = stamp(rs.w1a_seq, w1a_seq_new, landed)
        v.w1a_tick = torch.where(landed, t, rs.w1a_tick)

        v.w1b, landed, hit_old = ring_put(rs.w1b, w1b_new)
        hits.append(hit_old)
        v.w1b_vrnd_r = stamp(rs.w1b_vrnd_r, w1b_vrnd_r_new, landed)
        v.w1b_vrnd_i = stamp(rs.w1b_vrnd_i, w1b_vrnd_i_new, landed)
        v.w1b_fp_hi = stamp(rs.w1b_fp_hi, w1b_fp_hi_new, landed)
        v.w1b_fp_lo = stamp(rs.w1b_fp_lo, w1b_fp_lo_new, landed)
        v.w1b_set = stamp(rs.w1b_set, w1b_set_new, landed)
        v.w1b_cfg_hi = stamp(rs.w1b_cfg_hi, w1b_cfg_hi_new, landed)
        v.w1b_cfg_lo = stamp(rs.w1b_cfg_lo, w1b_cfg_lo_new, landed)
        # Promiser send key, stamped post-rebuild.
        v.w1b_seq = stamp(rs.w1b_seq, t * (c + 1) + v.rx_pos, landed)

        v.w2a, landed, hit_old = ring_put(rs.w2a, w2a_fan)
        hits.append(hit_old)
        v.w2a_fp_hi = stamp(rs.w2a_fp_hi, w2a_fp_hi_new, landed)
        v.w2a_fp_lo = stamp(rs.w2a_fp_lo, w2a_fp_lo_new, landed)
        v.w2a_mask = stamp(rs.w2a_mask, w2a_mask_new, landed)
        v.w2a_cfg_hi = stamp(rs.w2a_cfg_hi, w2a_cfg_hi_new, landed)
        v.w2a_cfg_lo = stamp(rs.w2a_cfg_lo, w2a_cfg_lo_new, landed)
        v.w2a_seq = stamp(rs.w2a_seq, w2a_seq_new, landed)
        v.w2a_tick = torch.where(landed, t, rs.w2a_tick)

        # 2b: the two payload lanes share one sender row (and cfg snapshot),
        # so old/new overlap is checked per (slot, sender) across lanes.
        cleared = rs.w2b & keep[:, None]
        ins = slot_hit[:, None] & w2b_fan[None]
        lane_landed = ins.any(dim=-1)                        # [D, 2, C]
        sender_landed = lane_landed.any(dim=1)               # [D, C]
        hits.append((cleared.any(dim=-1).any(dim=1) & sender_landed).any())
        v.w2b = cleared | ins
        v.w2b_rnd = stamp(rs.w2b_rnd, w2b_rnd_new, lane_landed)
        v.w2b_fp_hi = stamp(rs.w2b_fp_hi, w2b_fp_hi_new, lane_landed)
        v.w2b_fp_lo = stamp(rs.w2b_fp_lo, w2b_fp_lo_new, lane_landed)
        v.w2b_mask = stamp(rs.w2b_mask, w2b_mask_new, lane_landed)
        v.w2b_cfg_hi = stamp(rs.w2b_cfg_hi, w2b_cfg_hi_new, sender_landed)
        v.w2b_cfg_lo = stamp(rs.w2b_cfg_lo, w2b_cfg_lo_new, sender_landed)

        v.pd_bcast, landed, hit_old = ring_put(rs.pd_bcast, pd_fan)
        hits.append(hit_old)
        v.pd = stamp(rs.pd, pd_new, landed)
        v.pd_dst = stamp(rs.pd_dst, pd_dst_new, landed)
        v.pd_cfg_hi = stamp(rs.pd_cfg_hi, pd_cfg_hi_new, landed)
        v.pd_cfg_lo = stamp(rs.pd_cfg_lo, pd_cfg_lo_new, landed)

        v.flags = v.flags | flag_bit(torch.stack(hits).any(),
                                     FLAG_RING_COLLISION)

        # The counters: one int32 vector, the deliveries' counts plus the
        # sends, read as column views.
        counts = acc + torch.stack([sent.get(name, zero)
                                    for name in _COUNTERS])
        views = dict(zip(_COUNTERS, counts.unbind(-1)))
        log = ReceiverStepLog(
            tick=v.tick,
            probes_sent=probes_sent, probes_failed=probes_failed,
            partitioned_edges=monitor.partitioned_edge_count(faults,
                                                             ~crashed, t),
            **{name: views[name] for name in _COUNTERS},
            announce=announce, ann_prop=ann_prop,
            ann_cfg_hi=ann_cfg_hi, ann_cfg_lo=ann_cfg_lo,
            decide=dec["mask"], dec_hosts=dec["hosts"],
            dec_cfg_hi=dec["cfg_hi"], dec_cfg_lo=dec["cfg_lo"],
            flags=v.flags,
        )
        nxt = ReceiverState(**{name: getattr(v, name)
                               for name in ReceiverState._fields})
    return nxt, log


def init_receiver_state(uids: Sequence[int], id_fp_sum: int,
                        settings: Settings, *, seed: int,
                        member: Optional[Sequence[bool]] = None,
                        device="cuda") -> ReceiverState:
    """Boot a per-receiver universe: every slot starts with the identical
    converged view; padding slots beyond the membership boot stopped.
    ``seed`` keys the precomputed fallback-delay table."""
    if settings.batching_window_ticks != 1:
        raise ValueError("per-receiver mode assumes the oracle's 1-tick "
                         "alert batching window, got "
                         f"{settings.batching_window_ticks}")
    dev = resolve_device(device)
    base = boot_identity(uids, id_fp_sum, settings, member=member, device=dev)
    c, k = base.ring_order.shape
    d = settings.delivery_ring_depth
    member_row = base.member

    subj_idx, obs_idx, _gk, fd_active, fd_first = build_topology(
        member_row, base.ring_order, base.ring_rank)
    pos = ring0_positions(member_row, base.ring_order, base.ring_rank)
    rank_idx = classic_rank_index(base.uid_hi, base.uid_lo)
    with span("rapid.lower.delays"):
        delay_table = torch.from_numpy(
            build_delay_table(seed, c, N_DRAWS, settings)).to(dev)
    cfg_hi, cfg_lo = config_id_limbs(base.idsum_hi, base.idsum_lo,
                                     base.memsum_hi, base.memsum_lo)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    lz = lambda *s: full(s, 0, torch.int64)          # limb planes
    i32z = lambda *s: full(s, 0, torch.int32)
    bz = lambda *s: full(s, False, torch.bool)
    imax = lambda *s: full(s, I32_MAX, torch.int32)
    return ReceiverState(
        tick=full((), 0, torch.int32),
        uid_hi=base.uid_hi, uid_lo=base.uid_lo,
        mfp_hi=base.mfp_hi, mfp_lo=base.mfp_lo,
        idsum_hi=base.idsum_hi, idsum_lo=base.idsum_lo,
        rank_idx=rank_idx,
        ring_order=base.ring_order, ring_rank=base.ring_rank,
        delay_table=delay_table, draws=i32z(c),
        member=member_row[None, :].expand(c, c).clone(),
        memsum_hi=base.memsum_hi.expand(c).clone(),
        memsum_lo=base.memsum_lo.expand(c).clone(),
        cfg_hi=cfg_hi.expand(c).clone(), cfg_lo=cfg_lo.expand(c).clone(),
        epoch=i32z(c),
        stopped=~member_row,
        rx_pos=torch.where(member_row, pos, I32_MAX).to(torch.int32),
        px_n=full((c,), int(member_row.sum()), torch.int32),
        obs_full=obs_idx[None].expand(c, c, k).clone(),
        own_subj=subj_idx,
        own_fd_active=fd_active & member_row[:, None],
        own_fd_first=fd_first,
        fc=i32z(c, k), notified=bz(c, k), fd_gate=i32z(c),
        pf=bz(c, k), pf_dst=i32z(c, k),
        pf_cfg_hi=lz(c), pf_cfg_lo=lz(c),
        pd=bz(d, c, k), pd_dst=i32z(d, c, k),
        pd_cfg_hi=lz(d, c), pd_cfg_lo=lz(d, c), pd_bcast=bz(d, c, c),
        reports=bz(c, c, k), seen_down=bz(c), announced=bz(c),
        ar_seq=imax(c),
        reg_valid=bz(c), reg_mask=bz(c, c),
        reg_fp_hi=lz(c), reg_fp_lo=lz(c),
        wv=bz(d, c, c), wv_fp_hi=lz(d, c), wv_fp_lo=lz(d, c),
        wv_cfg_hi=lz(d, c), wv_cfg_lo=lz(d, c), wv_seq=imax(d, c),
        vt_seen=bz(c, c), vt_fp_hi=lz(c, c), vt_fp_lo=lz(c, c),
        px_rnd_r=i32z(c), px_rnd_i=i32z(c),
        px_vrnd_r=i32z(c), px_vrnd_i=i32z(c),
        px_vv_fp_hi=lz(c), px_vv_fp_lo=lz(c), px_vv_set=bz(c),
        px_crnd_r=i32z(c), px_cval_set=bz(c), px_timer=imax(c),
        pb_seen=bz(c, c), pb_vrnd_r=i32z(c, c), pb_vrnd_i=i32z(c, c),
        pb_fp_hi=lz(c, c), pb_fp_lo=lz(c, c), pb_set=bz(c, c),
        pb_seq=i32z(c, c),
        p2_rnd=full((c,), -1, torch.int32), p2_seen=bz(c, c),
        p2_mask=bz(c, c),
        w1a=bz(d, c, c), w1a_cfg_hi=lz(d, c), w1a_cfg_lo=lz(d, c),
        w1a_seq=imax(d, c), w1a_tick=i32z(d, c),
        w1b=bz(d, c, c), w1b_vrnd_r=i32z(d, c), w1b_vrnd_i=i32z(d, c),
        w1b_fp_hi=lz(d, c), w1b_fp_lo=lz(d, c), w1b_set=bz(d, c),
        w1b_cfg_hi=lz(d, c), w1b_cfg_lo=lz(d, c), w1b_seq=imax(d, c),
        w2a=bz(d, c, c), w2a_fp_hi=lz(d, c), w2a_fp_lo=lz(d, c),
        w2a_mask=bz(d, c, c), w2a_cfg_hi=lz(d, c), w2a_cfg_lo=lz(d, c),
        w2a_seq=imax(d, c), w2a_tick=i32z(d, c),
        w2b=bz(d, 2, c, c), w2b_rnd=i32z(d, 2, c),
        w2b_fp_hi=lz(d, 2, c), w2b_fp_lo=lz(d, 2, c),
        w2b_mask=bz(d, 2, c, c),
        w2b_cfg_hi=lz(d, c), w2b_cfg_lo=lz(d, c),
        flags=full((), 0, torch.int32),
    )


def _require_layout(state, settings: Settings, fleet: bool = False) -> None:
    """The carry must be in the layout ``settings.rx_kernel`` names: a
    dense ``ReceiverState`` under "xla", a packed bundle under "packed"
    and "pallas" (where one cluster may pass its dense boot, which the
    packed loop packs on entry, as the reference's does). Nothing else is
    packed or unpacked to make a mismatch fit."""
    from rapid_tpu_torch.engine import rx_packed

    dense = settings.rx_kernel == "xla"
    if not (dense or fleet):
        return
    want = ReceiverState if dense else rx_packed.PackedReceiverBundle
    if not isinstance(state, want):
        raise TypeError(
            f"rx_kernel={settings.rx_kernel!r} runs the "
            f"{'dense' if dense else 'packed'} carry: got a "
            f"{type(state).__name__}, want a {want.__name__} (lower the "
            f"members under the same Settings)")


def _dense_loop(rs: ReceiverState, faults: EngineFaults, n_ticks: int,
                settings: Settings):
    """The tick loop over the dense carry: ``receiver_step`` on it
    directly, with no pack or unpack between ticks."""
    from rapid_tpu_torch.engine import rx_packed

    t0 = int(rs.tick)
    logs = []
    for i in range(int(n_ticks)):
        rs, log = receiver_step(rs, faults, settings, tick=t0 + i)
        logs.append(log)
    return rs, rx_packed.stack_logs(logs)


def receiver_simulate(state, faults: EngineFaults, n_ticks: int,
                      settings: Settings):
    """Run ``n_ticks`` ticks; returns ``(final_dense_state,
    stacked_logs)``, and with ``settings.flight_recorder_window > 0``
    ``(final_dense_state, stacked_logs, recorder)``. Under
    ``rx_kernel="xla"`` ``state`` is a dense ``ReceiverState`` and the
    loop carries it as it is (the reference's ``_simulate``); under
    "packed" and "pallas" it is an ``rx_packed.PackedReceiverBundle`` (or
    a dense boot, packed on entry) and the loop carries the packed layout,
    unpacked at the end (``receiver_simulate_chunk``, one chunk). The
    state lies on the device the run should use; the results are the
    same under every layout, but for the packed layouts' saturation
    flags."""
    from rapid_tpu_torch.engine import rx_packed

    out = receiver_simulate_chunk(state, faults, n_ticks, settings)
    if settings.rx_kernel == "xla":
        return out
    bundle = out[0]
    return (rx_packed.unpack_receiver_state(bundle.packed,
                                            bundle.delay_table, settings),
            *out[1:])


def receiver_simulate_chunk(carry, faults: EngineFaults, n_ticks: int,
                            settings: Settings, rec=None,
                            donate: bool = True):
    """One streaming chunk of the per-receiver loop, layout-preserving.

    Under ``rx_kernel="xla"`` the carry is a dense ``ReceiverState`` and
    the final comes back dense (``_dense_loop``); under "packed" and
    "pallas" it is an ``rx_packed.PackedReceiverBundle`` (a dense boot is
    packed on entry, as ``rx_packed.as_bundle`` does) and the final comes
    back as a bundle (``rx_packed.simulate_chunk``), so the service feeds
    it back as it is. Returns ``(final, logs)``, or ``(final, logs, rec)``
    with a recorder window, folding into ``rec`` when given (every chunk
    after the first). Chained chunks equal one uninterrupted
    ``receiver_simulate`` of the summed length. ``donate`` is accepted for
    the reference's callers; PyTorch has no donation
    (``step.simulate_chunk``)."""
    from rapid_tpu_torch.engine import recorder, rx_packed

    _require_layout(carry, settings)
    if settings.rx_kernel != "xla":
        return rx_packed.simulate_chunk(carry, faults, n_ticks, settings,
                                        rec=rec, donate=donate)
    final, logs = _dense_loop(carry, faults, n_ticks, settings)
    if settings.flight_recorder_window:
        if rec is None:
            rec = recorder.init(settings, device=logs.tick.device)
        return final, logs, recorder.record_receiver_run(rec, logs,
                                                         settings)
    return final, logs


def receiver_fleet_simulate(fleet_state, faults: EngineFaults,
                            n_ticks: int, settings: Settings,
                            fleet_mesh=None):
    """Run a stacked per-receiver fleet (states and ``EngineFaults`` with
    the member axis first) ``n_ticks`` ticks: ``(finals, logs)``, the
    logs ``[F, T, ...]``, and with ``settings.flight_recorder_window > 0``
    ``(finals, logs, recorders)``. Under ``rx_kernel="xla"`` the fleet is
    a stacked dense ``ReceiverState`` and the finals come back dense;
    under "packed" and "pallas" a stacked ``PackedReceiverBundle`` and
    the finals come back packed (``receiver_final_view`` reads either).
    ``fleet_mesh`` splits the members over its devices
    (``sharding.fleet_axis_put``); the outputs come back joined on its
    first device."""
    from rapid_tpu_torch.engine import sharding

    ps = getattr(fleet_state, "packed", fleet_state)
    return receiver_fleet_run(sharding.fleet_shards(
        (fleet_state, faults), fleet_mesh, int(ps.member.shape[0]),
        ps.member.device), n_ticks, settings)


def receiver_fleet_run(shards, n_ticks: int, settings: Settings):
    """``receiver_fleet_simulate`` over ``sharding.FleetShards`` of
    ``(state, faults)`` pairs (a ``fleet.ReceiverMember`` is one)."""
    from rapid_tpu_torch.engine import recorder, rx_packed

    for state, _ in shards.shards:
        _require_layout(state, settings, fleet=True)
    run = (rx_packed.dense_fleet_run if settings.rx_kernel == "xla"
           else rx_packed.fleet_run)
    finals, logs = run(shards, n_ticks, settings)
    if settings.flight_recorder_window:
        return finals, logs, recorder.record_fleet_run(
            logs, settings, recorder.record_receiver_run)
    return finals, logs


def receiver_final_view(final):
    """The final-state fields the host reads (``member``, ``stopped``,
    the cfg limbs, ``flags``): the state itself when dense, unpacked from
    a packed fleet final."""
    if isinstance(final, ReceiverState):
        return final
    from rapid_tpu_torch.engine import rx_packed

    return rx_packed.final_view(final)


def receiver_final_fields(final):
    """Just the host-read fields of finals of either layout, one member
    or a fleet: an ``rx_packed.ReceiverFinalView``."""
    from rapid_tpu_torch.engine import rx_packed

    view = receiver_final_view(final)
    return rx_packed.ReceiverFinalView(*[
        getattr(view, f) for f in rx_packed.ReceiverFinalView._fields])


# --- host-side extraction ------------------------------------------------

def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _u64(hi, lo) -> np.ndarray:
    return (_np(hi).astype(np.uint64) << np.uint64(32)) | _np(lo).astype(
        np.uint64)


def receiver_events(logs) -> List[List[Tuple[int, str, int, Tuple[int, ...]]]]:
    """Per-slot ``(tick, kind, config_id, slots)`` event streams (a slot
    announces at most once and decides at most once per tick)."""
    ann = _np(logs.announce)
    dec = _np(logs.decide)
    ann_prop = _np(logs.ann_prop)
    dec_hosts = _np(logs.dec_hosts)
    ann_cfg = _u64(logs.ann_cfg_hi, logs.ann_cfg_lo)
    dec_cfg = _u64(logs.dec_cfg_hi, logs.dec_cfg_lo)
    ticks = _np(logs.tick)
    n_ticks, c = ann.shape
    events: List[List[Tuple[int, str, int, Tuple[int, ...]]]] = [
        [] for _ in range(c)]
    for ti in range(n_ticks):
        t = int(ticks[ti])
        for r in np.nonzero(dec[ti])[0]:
            events[int(r)].append(
                (t, "view_change", int(dec_cfg[ti, r]),
                 tuple(int(s) for s in np.nonzero(dec_hosts[ti, r])[0])))
        for r in np.nonzero(ann[ti])[0]:
            events[int(r)].append(
                (t, "proposal", int(ann_cfg[ti, r]),
                 tuple(int(s) for s in np.nonzero(ann_prop[ti, r])[0])))
    return events


def receiver_counters(logs) -> List[dict]:
    """Per-tick counter deltas, in the host referee's ``tick_history``
    format."""
    keys = ("sent", "delivered", "dropped", "probes_sent", "probes_failed")
    arrs = {key: _np(getattr(logs, key)) for key in keys}
    rows = []
    for i in range(arrs["sent"].shape[0]):
        row = {key: int(arrs[key][i]) for key in keys}
        row["timeouts"] = 0
        rows.append({key: row[key] for key in
                     ("sent", "delivered", "dropped", "timeouts",
                      "probes_sent", "probes_failed")})
    return rows


def receiver_phase_counters(logs) -> List[dict]:
    """Per-tick phase deltas, in the host referee's ``phase_history``
    format."""
    pairs = (("fast_vote", logs.fv_sent, logs.fv_delivered),
             ("phase1a", logs.p1a_sent, logs.p1a_delivered),
             ("phase1b", logs.p1b_sent, logs.p1b_delivered),
             ("phase2a", logs.p2a_sent, logs.p2a_delivered),
             ("phase2b", logs.p2b_sent, logs.p2b_delivered))
    arrs = [(p, _np(s), _np(d)) for p, s, d in pairs]
    n_ticks = arrs[0][1].shape[0]
    return [{f"{p}_{kind}": int(a[i]) for p, s, d in arrs
             for kind, a in (("sent", s), ("delivered", d))}
            for i in range(n_ticks)]


def receiver_state_bytes(capacity: int, k: int, n_draws: int = N_DRAWS,
                         ring_depth: int = 4) -> int:
    """Exact per-member bytes of one dense ``ReceiverState`` in the
    reference's layout (32-bit limbs, 1-byte bools): the count
    ``fleet.check_receiver_budget`` gates on."""
    from rapid_tpu_torch.engine import fleet

    return fleet.dense_state_bytes(capacity, k, n_draws, ring_depth)


def receiver_config_ids(rs: ReceiverState) -> List[int]:
    """Final per-slot configuration ids as python ints."""
    return [int(x) for x in _u64(rs.cfg_hi, rs.cfg_lo)]


def receiver_run_payload(rs: ReceiverState, logs, n: int, n_ticks: int):
    """A finished run (the dense final state ``receiver_simulate``
    returns under every layout, and its logs) as the host adversary
    engine's ``AdversaryRun``, so the differential and the metrics read
    both alike. The gauges and the final views come to the host in one
    transfer."""
    from rapid_tpu_torch.device import read_arrays
    from rapid_tpu_torch.engine.adversary import AdversaryRun

    with span("rapid.fold"):
        events = receiver_events(logs)
        counters = receiver_counters(logs)
        phases = receiver_phase_counters(logs)
        link_dropped, partitioned, member, stopped = read_arrays(
            logs.link_dropped, logs.partitioned_edges, rs.member, rs.stopped)
        totals = {k: sum(row[k] for row in counters)
                  for k in ("sent", "delivered", "dropped", "probes_sent",
                            "probes_failed")}
        totals["timeouts"] = 0
        phase_totals = {k: sum(row[k] for row in phases) for k in phases[0]} \
            if phases else {}
        return AdversaryRun(
            n=n, n_ticks=n_ticks,
            events_by_slot=[events[s] for s in range(n)],
            tick_history=counters,
            phase_history=phases,
            partitioned_edges=[int(x) for x in partitioned],
            link_dropped=[int(x) for x in link_dropped],
            config_ids=receiver_config_ids(rs)[:n],
            members_by_slot=[frozenset(int(i)
                                       for i in np.nonzero(member[s])[0])
                             for s in range(n)],
            stopped=[bool(x) for x in stopped[:n]],
            totals=totals, phase_totals=phase_totals,
        )


# The lowering lives with the fleets, as in the reference; callers of the
# single-cluster engine find it here too.
from rapid_tpu_torch.engine.fleet import (  # noqa: E402
    ReceiverMember, lower_receiver_schedule)
