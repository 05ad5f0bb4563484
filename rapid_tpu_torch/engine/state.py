"""Engine state: the slot universe, the carries, the logs, the faults.

Field for field the reference's ``EngineState`` and ``StepLog`` (the
shared-state engine) and ``ReceiverState`` and ``ReceiverStepLog`` (the
per-receiver engine); see ``rapid_tpu.engine.state`` for the meaning of
every field. They are NamedTuples of tensors, and a field that is a
scalar in the reference is a 0-d tensor here. Dtypes follow the reference
with one change:
every 64-bit value is a ``(hi, lo)`` pair of 32-bit limbs, and the port
carries each limb as ``int64`` holding ``[0, 2**32)`` (see ``hashing``).
Those fields are exactly the ones whose names end in ``_hi`` or ``_lo``.
"""
from __future__ import annotations

import operator
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree

from rapid_tpu_torch import hashing
from rapid_tpu_torch.device import resolve_device
from rapid_tpu_torch.identity import SEED_MEMBER
from rapid_tpu_torch.settings import Settings

I32_MAX = int(np.iinfo(np.int32).max)


def is_limb_field(name: str) -> bool:
    return name.endswith("_hi") or name.endswith("_lo")


def flag_bit(cond, bit: int):
    """int32 ``bit`` where the 0-d bool ``cond`` holds, else 0 (sticky
    ``flags`` bits stay int32, as in the reference)."""
    return cond.to(torch.int32) * bit


class EngineFaults:
    """Crash ticks, probe drop, link-window and delay-rule tensors.

    ``crash_tick[n]`` is the tick at/after which slot ``n`` is crashed
    (``I32_MAX`` = never). Window ``w`` blocks ``src -> dst`` at tick ``t``
    when ``link_src[w, src] & link_dst[w, dst]`` and the window is active
    (``link_start[w] <= t < link_end[w]`` and, for ``link_period[w] > 0``,
    the off-phase ``((t - start) // period) % 2 == 0``); ``link_two_way``
    blocks the reverse too. Rule ``r`` of the ``delay_*`` tensors delays
    ``src -> dst`` sends by ``delay_base`` (``delay_rev`` on the reverse,
    -1 = none) plus a hashed jitter in ``[0, delay_jit]``. ``None`` leaves
    mean no windows (W = 0) or no rules (R = 0).

    The probe-drop configuration (``monitor.edge_drop``) is host data, as
    in the reference, where it is static: ``drop_p`` is the drop
    probability (0 = no drop), ``drop_seed`` keys the per-(edge, tick)
    hash, and ``drop_targets`` (bool [C] tensor, None = every slot)
    limits drops to probes into (``drop_ingress``) or out of
    (``drop_egress``) the target slots.
    """

    FIELDS = ("crash_tick", "drop_targets", "link_src", "link_dst",
              "link_start", "link_end", "link_period", "link_two_way",
              "delay_src", "delay_dst", "delay_base", "delay_rev",
              "delay_jit", "delay_start", "delay_end", "delay_seed_hi",
              "delay_seed_lo")
    DROP_CONFIG = ("drop_p", "drop_seed", "drop_ingress", "drop_egress")

    def __init__(self, crash_tick, drop_p: float = 0.0, drop_seed: int = 0,
                 drop_ingress: bool = True, drop_egress: bool = True,
                 **kw) -> None:
        self.crash_tick = crash_tick
        self.drop_p = float(drop_p)
        self.drop_seed = int(drop_seed)
        self.drop_ingress = bool(drop_ingress)
        self.drop_egress = bool(drop_egress)
        for name in self.FIELDS[1:]:
            setattr(self, name, kw.pop(name, None))
        if kw:
            raise TypeError(f"unknown EngineFaults fields: {sorted(kw)}")

    @property
    def n_windows(self) -> int:
        return 0 if self.link_src is None else int(self.link_src.shape[0])

    @property
    def n_delay_rules(self) -> int:
        return 0 if self.delay_src is None else int(self.delay_src.shape[0])


def _faults_flatten(faults: EngineFaults):
    return ([getattr(faults, f) for f in EngineFaults.FIELDS],
            tuple(getattr(faults, f) for f in EngineFaults.DROP_CONFIG))


def _faults_unflatten(leaves, config) -> EngineFaults:
    return EngineFaults(**dict(zip(EngineFaults.DROP_CONFIG, config)),
                        **dict(zip(EngineFaults.FIELDS, leaves)))


# A pytree, so ``member_map`` batches its tensors; the drop configuration
# rides as host context.
_pytree.register_pytree_node(EngineFaults, _faults_flatten,
                             _faults_unflatten)


def member_map(fn, *args):
    """``fn(*args)`` once per fleet member, as one batched call
    (``torch.func.vmap`` over the leading member axis).

    Every tensor inside ``args`` (NamedTuples, ``EngineFaults``, dicts,
    tensors) carries the member axis first; ``None`` leaves and host
    values pass through unbatched, so ``fn`` sees one member's pytrees as
    the single-cluster code does. ``fn`` returns tensors or pytrees of
    tensors, which come back with the member axis first.

    A ``vmap`` over one member is the call on that member, so a member
    axis of 1 runs ``fn`` on every tensor's ``[0]`` and puts the axis
    back on its outputs, without ``vmap``'s cost per op.
    """
    if _lead_size(args) == 1:
        return _each(_ONE_BACK, fn(*_each(_ONE_OUT, args)))
    leaves, spec = _pytree.tree_flatten(args)
    at = [i for i, leaf in enumerate(leaves) if torch.is_tensor(leaf)]

    def one(*tensors):
        full = list(leaves)
        for i, leaf in zip(at, tensors):
            full[i] = leaf
        return fn(*_pytree.tree_unflatten(full, spec))

    return torch.func.vmap(one)(*[leaves[i] for i in at])


#: A fleet of one's member out of a tensor, and the member axis back on.
_ONE_OUT, _ONE_BACK = operator.itemgetter(0), operator.itemgetter(None)


def _each(fn, tree):
    """``tree`` with ``fn`` applied to each of its tensors (inside
    NamedTuples, tuples, lists, dicts, ``EngineFaults``), the rest kept:
    ``member_map``'s walk of a fleet of one, cheaper than a pytree's."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        items = [fn(x) if isinstance(x, torch.Tensor) else _each(fn, x)
                 for x in tree]
        return tree._make(items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    if isinstance(tree, dict):
        return {k: _each(fn, v) for k, v in tree.items()}
    if isinstance(tree, EngineFaults):
        leaves, config = _faults_flatten(tree)
        return _faults_unflatten([_each(fn, x) for x in leaves], config)
    return tree


def _lead_size(tree) -> Optional[int]:
    """The leading size of the first tensor in ``tree`` (as ``_each``
    walks it), None when it holds no tensor."""
    if isinstance(tree, torch.Tensor):
        return tree.shape[0]
    if isinstance(tree, EngineFaults):
        tree = _faults_flatten(tree)[0]
    elif isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return None
    return next((n for n in map(_lead_size, tree) if n is not None), None)


class EngineState(NamedTuple):
    """The shared-state engine's carry: one view, one cut detector and one
    fast round stand in for every alive receiver's copy."""

    tick: object                      # i32
    member: object                    # bool [C]
    uid_hi: object                    # limb [C]
    uid_lo: object
    mfp_hi: object                    # limb [C] member fingerprints
    mfp_lo: object
    idfp_hi: object                   # limb [C] identifier fingerprints
    idfp_lo: object
    idsum_hi: object                  # limb: identifier-fingerprint sum
    idsum_lo: object
    memsum_hi: object                 # limb: member-fingerprint sum
    memsum_lo: object
    ring_order: object                # i32 [C, K]
    ring_rank: object                 # i32 [C, K]
    subj_idx: object                  # i32 [C, K]
    obs_idx: object                   # i32 [C, K]
    gk_idx: object                    # i32 [C, K]
    fd_active: object                 # bool [C, K]
    fd_first: object                  # i32 [C, K]
    fc: object                        # i32 [C, K] failure counters
    notified: object                  # bool [C, K]
    fd_gate: object                   # i32: probes only at t > fd_gate
    pending_flush: object             # bool [C, K]
    pending_deliver: object           # bool [C, K]
    churn_flush: object               # bool [C]
    churn_deliver: object             # bool [C]
    reports: object                   # bool [C, K] per (dst, ring)
    seen_down: object                 # bool
    announced: object                 # bool
    proposal: object                  # bool [C]
    announce_tick: object             # i32
    vote_pending: object              # bool
    voters: object                    # bool [C]
    phash_hi: object                  # limb: proposal fingerprint
    phash_lo: object
    epoch: object                     # i32
    px_rnd_r: object                  # i32 [C] classic-Paxos fields, inert
    px_rnd_i: object                  # without a fallback schedule
    px_vrnd_r: object
    px_vrnd_i: object
    px_vval: object
    px_crnd_r: object
    px_crnd_i: object
    px_cval: object
    px_timer: object
    px_pos: object                    # i32 [C] ring-0 position
    c1a_tick: object                  # i32
    c1a_coord: object
    c1a_rank_r: object
    c1a_rank_i: object
    c1a_epoch: object
    c1b_tick: object
    c1b_epoch: object
    c1b_mask: object                  # bool [C]
    c2a_tick: object                  # i32
    c2a_rank_r: object
    c2a_rank_i: object
    c2a_pid: object
    c2a_epoch: object
    c2b_tick: object
    c2b_cnt: object
    c2b_pid: object
    c2b_epoch: object


class StepLog(NamedTuple):
    """Per-tick outputs of the shared step: counter *factors* (the host
    multiplies them, ``diff.expand_counters``) and end-of-tick gauges."""

    tick: object                      # i32
    announce_now: object              # bool
    proposal: object                  # bool [C]
    decide_now: object                # bool
    decision: object                  # bool [C]
    config_hi: object                 # limb: config id after this tick
    config_lo: object
    n_member: object                  # i32, and i32 below
    probes_sent: object
    probes_failed: object
    flushers: object
    flush_recipients: object
    flushers_alive: object
    deliver_alive: object
    vote_senders: object
    vote_recipients: object
    vote_senders_alive: object
    vote_deliver_alive: object
    alerts_in_flight: object
    cut_reports: object
    implicit_reports: object
    vote_tally: object
    quorum: object
    epoch: object
    churn_injected: object
    partitioned_edges: object
    link_dropped: object
    pxvote_senders: object
    pxvote_recipients: object
    px1a_senders: object
    px1a_recipients: object
    px1b_senders: object
    px2a_senders: object
    px2a_recipients: object
    px2b_senders: object
    px2b_recipients: object
    px_timers_armed: object
    px_coord_round: object
    inv_bits: object


class ReceiverState(NamedTuple):
    tick: object            # i32
    uid_hi: object          # limb [C]
    uid_lo: object
    mfp_hi: object          # limb [C] membership fingerprints
    mfp_lo: object
    idsum_hi: object        # limb scalar
    idsum_lo: object
    rank_idx: object        # i32 [C]
    ring_order: object      # i32 [C, K]
    ring_rank: object       # i32 [C, K]
    delay_table: object     # i32 [C, N_DRAWS, C+1]
    draws: object           # i32 [C]
    member: object          # bool [C, C]
    memsum_hi: object       # limb [C]
    memsum_lo: object
    cfg_hi: object          # limb [C]
    cfg_lo: object
    epoch: object           # i32 [C]
    stopped: object         # bool [C]
    rx_pos: object          # i32 [C]
    px_n: object            # i32 [C]
    obs_full: object        # i32 [C, C, K]
    own_subj: object        # i32 [C, K]
    own_fd_active: object   # bool [C, K]
    own_fd_first: object    # i32 [C, K]
    fc: object              # i32 [C, K]
    notified: object        # bool [C, K]
    fd_gate: object         # i32 [C]
    pf: object              # bool [C, K]
    pf_dst: object          # i32 [C, K]
    pf_cfg_hi: object       # limb [C]
    pf_cfg_lo: object
    pd: object              # bool [D, C, K]
    pd_dst: object          # i32 [D, C, K]
    pd_cfg_hi: object       # limb [D, C]
    pd_cfg_lo: object
    pd_bcast: object        # bool [D, C, C]
    reports: object         # bool [C, C, K]
    seen_down: object       # bool [C]
    announced: object       # bool [C]
    ar_seq: object          # i32 [C]
    reg_valid: object       # bool [C]
    reg_mask: object        # bool [C, C]
    reg_fp_hi: object       # limb [C]
    reg_fp_lo: object
    wv: object              # bool [D, C, C]
    wv_fp_hi: object        # limb [D, C]
    wv_fp_lo: object
    wv_cfg_hi: object       # limb [D, C]
    wv_cfg_lo: object
    wv_seq: object          # i32 [D, C]
    vt_seen: object         # bool [C, C]
    vt_fp_hi: object        # limb [C, C]
    vt_fp_lo: object
    px_rnd_r: object        # i32 [C]
    px_rnd_i: object
    px_vrnd_r: object
    px_vrnd_i: object
    px_vv_fp_hi: object     # limb [C]
    px_vv_fp_lo: object
    px_vv_set: object       # bool [C]
    px_crnd_r: object       # i32 [C]
    px_cval_set: object     # bool [C]
    px_timer: object        # i32 [C]
    pb_seen: object         # bool [C, C]
    pb_vrnd_r: object       # i32 [C, C]
    pb_vrnd_i: object       # i32 [C, C]
    pb_fp_hi: object        # limb [C, C]
    pb_fp_lo: object
    pb_set: object          # bool [C, C]
    pb_seq: object          # i32 [C, C]
    p2_rnd: object          # i32 [C]
    p2_seen: object         # bool [C, C]
    p2_mask: object         # bool [C, C]
    w1a: object             # bool [D, C, C]
    w1a_cfg_hi: object      # limb [D, C]
    w1a_cfg_lo: object
    w1a_seq: object         # i32 [D, C]
    w1a_tick: object        # i32 [D, C]
    w1b: object             # bool [D, C, C]
    w1b_vrnd_r: object      # i32 [D, C]
    w1b_vrnd_i: object
    w1b_fp_hi: object       # limb [D, C]
    w1b_fp_lo: object
    w1b_set: object         # bool [D, C]
    w1b_cfg_hi: object      # limb [D, C]
    w1b_cfg_lo: object
    w1b_seq: object         # i32 [D, C]
    w2a: object             # bool [D, C, C]
    w2a_fp_hi: object       # limb [D, C]
    w2a_fp_lo: object
    w2a_mask: object        # bool [D, C, C]
    w2a_cfg_hi: object      # limb [D, C]
    w2a_cfg_lo: object
    w2a_seq: object         # i32 [D, C]
    w2a_tick: object        # i32 [D, C]
    w2b: object             # bool [D, 2, C, C]
    w2b_rnd: object         # i32 [D, 2, C]
    w2b_fp_hi: object       # limb [D, 2, C]
    w2b_fp_lo: object
    w2b_mask: object        # bool [D, 2, C, C]
    w2b_cfg_hi: object      # limb [D, C]
    w2b_cfg_lo: object
    flags: object           # i32 scalar


class ReceiverStepLog(NamedTuple):
    tick: object            # i32
    sent: object            # i32
    delivered: object
    dropped: object
    probes_sent: object
    probes_failed: object
    fv_sent: object
    fv_delivered: object
    p1a_sent: object
    p1a_delivered: object
    p1b_sent: object
    p1b_delivered: object
    p2a_sent: object
    p2a_delivered: object
    p2b_sent: object
    p2b_delivered: object
    partitioned_edges: object
    link_dropped: object
    announce: object        # bool [C]
    ann_prop: object        # bool [C, C]
    ann_cfg_hi: object      # limb [C]
    ann_cfg_lo: object
    decide: object          # bool [C]
    dec_hosts: object       # bool [C, C]
    dec_cfg_hi: object      # limb [C]
    dec_cfg_lo: object
    flags: object           # i32


class BootIdentity(NamedTuple):
    """What the receiver boot reads of the reference's ``init_state``."""

    member: object          # bool [C]
    uid_hi: object          # limb [C]
    uid_lo: object
    mfp_hi: object          # limb [C]
    mfp_lo: object
    idsum_hi: object        # limb scalar
    idsum_lo: object
    memsum_hi: object       # limb scalar
    memsum_lo: object
    ring_order: object      # i32 [C, K]
    ring_rank: object       # i32 [C, K]


def config_id_limbs(idsum_hi, idsum_lo, memsum_hi, memsum_lo):
    """Limb form of the configuration id of (identifier sum, member sum)."""
    shi, slo = hashing.splitmix64_limbs(idsum_hi, idsum_lo)
    hi, lo = hashing.add64(shi, slo, memsum_hi, memsum_lo)
    return hashing.splitmix64_limbs(hi, lo)


def boot_identity(uids: Sequence[int], id_fp_sum: int, settings: Settings,
                  member: Optional[Sequence[bool]] = None,
                  device="cuda") -> BootIdentity:
    """Slot identities, fingerprints, sums and the static ring order of a
    converged membership; ``settings.capacity`` beyond ``len(uids)`` pads
    the universe with inert dormant slots, as the reference does."""
    from rapid_tpu_torch.engine.topology import ring_permutations

    dev = resolve_device(device)
    uids_np = np.asarray(uids, dtype=np.uint64)
    member_np = (np.ones(len(uids_np), bool) if member is None
                 else np.asarray(member, bool))
    if settings.capacity > len(uids_np):
        pad = settings.capacity - len(uids_np)
        pad_uids = np.asarray(
            [hashing.hash64(i, seed=0x636170) for i in range(pad)],
            dtype=np.uint64)
        uids_np = np.concatenate([uids_np, pad_uids])
        member_np = np.concatenate([member_np, np.zeros(pad, bool)])
    hi_np, lo_np = hashing.np_to_limbs(uids_np)
    uid_hi = torch.from_numpy(hi_np.astype(np.int64))
    uid_lo = torch.from_numpy(lo_np.astype(np.int64))
    mhi, mlo = hashing.hash64_limbs(uid_hi, uid_lo, seed=SEED_MEMBER)
    memsum = sum(int(h) << 32 | int(lo)
                 for h, lo, m in zip(mhi.tolist(), mlo.tolist(), member_np)
                 if m) & hashing.MASK64
    idh, idl = hashing.to_limbs(id_fp_sum)
    msh, msl = hashing.to_limbs(memsum)
    # The once-per-universe lexsort, on the host before anything else.
    ring_order, ring_rank = ring_permutations(uid_hi, uid_lo, settings.K)
    scalar = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
    return BootIdentity(
        member=torch.from_numpy(member_np).to(dev),
        uid_hi=uid_hi.to(dev), uid_lo=uid_lo.to(dev),
        mfp_hi=mhi.to(dev), mfp_lo=mlo.to(dev),
        idsum_hi=scalar(idh), idsum_lo=scalar(idl),
        memsum_hi=scalar(msh), memsum_lo=scalar(msl),
        ring_order=torch.from_numpy(ring_order).to(dev),
        ring_rank=torch.from_numpy(ring_rank).to(dev))


def state_config_id(state: EngineState) -> int:
    """Current configuration id of the shared state as a Python int."""
    hi, lo = config_id_limbs(state.idsum_hi, state.idsum_lo,
                             state.memsum_hi, state.memsum_lo)
    return hashing.from_limbs(int(hi), int(lo))


def init_state(uids: Sequence[int], id_fp_sum: int, settings: Settings,
               start_tick: int = 0, member: Optional[Sequence[bool]] = None,
               id_fps: Optional[Sequence[int]] = None,
               device="cuda") -> EngineState:
    """The shared engine's state for a converged membership plus dormant
    slots, on ``device``.

    ``uids`` are the 64-bit node identities in slot order and
    ``id_fp_sum`` the identifier-fingerprint sum of the initial members;
    ``member`` marks the initially active slots (default: all) and
    ``id_fps`` each slot's identifier fingerprint, added to the sum when
    its join is decided. ``settings.capacity`` beyond ``len(uids)`` pads
    the universe with inert dormant slots, as the reference does.
    """
    from rapid_tpu_torch.engine.paxos import ring0_positions
    from rapid_tpu_torch.engine.topology import build_topology

    boot = boot_identity(uids, id_fp_sum, settings, member=member,
                         device=device)
    dev = boot.member.device
    c = boot.member.shape[0]
    k = settings.K
    ifp = np.zeros(c, np.uint64)
    if id_fps is not None:
        ifp[:len(id_fps)] = np.asarray(id_fps, dtype=np.uint64)
    ifp_hi, ifp_lo = hashing.np_to_limbs(ifp)
    subj_idx, obs_idx, gk_idx, fd_active, fd_first = build_topology(
        boot.member, boot.ring_order, boot.ring_rank)

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    i32 = lambda v: full((), v, torch.int32)
    i32c = lambda v: full((c,), v, torch.int32)
    limb0 = lambda: full((), 0, torch.int64)
    false = lambda shape=(): full(shape, False, torch.bool)
    return EngineState(
        tick=i32(start_tick), member=boot.member,
        uid_hi=boot.uid_hi, uid_lo=boot.uid_lo,
        mfp_hi=boot.mfp_hi, mfp_lo=boot.mfp_lo,
        idfp_hi=torch.from_numpy(ifp_hi.astype(np.int64)).to(dev),
        idfp_lo=torch.from_numpy(ifp_lo.astype(np.int64)).to(dev),
        idsum_hi=boot.idsum_hi, idsum_lo=boot.idsum_lo,
        memsum_hi=boot.memsum_hi, memsum_lo=boot.memsum_lo,
        ring_order=boot.ring_order, ring_rank=boot.ring_rank,
        subj_idx=subj_idx, obs_idx=obs_idx, gk_idx=gk_idx,
        fd_active=fd_active, fd_first=fd_first,
        fc=full((c, k), 0, torch.int32), notified=false((c, k)),
        fd_gate=i32(start_tick),
        pending_flush=false((c, k)), pending_deliver=false((c, k)),
        churn_flush=false((c,)), churn_deliver=false((c,)),
        reports=false((c, k)), seen_down=false(), announced=false(),
        proposal=false((c,)), announce_tick=i32(-1),
        vote_pending=false(), voters=false((c,)),
        phash_hi=limb0(), phash_lo=limb0(), epoch=i32(0),
        px_rnd_r=i32c(0), px_rnd_i=i32c(0),
        px_vrnd_r=i32c(0), px_vrnd_i=i32c(0), px_vval=i32c(-1),
        px_crnd_r=i32c(0), px_crnd_i=i32c(0), px_cval=i32c(-1),
        px_timer=i32c(I32_MAX),
        px_pos=ring0_positions(boot.member, boot.ring_order,
                               boot.ring_rank),
        c1a_tick=i32(I32_MAX), c1a_coord=i32(0), c1a_rank_r=i32(0),
        c1a_rank_i=i32(0), c1a_epoch=i32(-1),
        c1b_tick=i32(I32_MAX), c1b_epoch=i32(-1), c1b_mask=false((c,)),
        c2a_tick=i32(I32_MAX), c2a_rank_r=i32(0), c2a_rank_i=i32(0),
        c2a_pid=i32(-1), c2a_epoch=i32(-1),
        c2b_tick=i32(I32_MAX), c2b_cnt=i32(0), c2b_pid=i32(-1),
        c2b_epoch=i32(-1),
    )


def crash_faults(crash_ticks: Sequence[int], device="cuda") -> EngineFaults:
    """EngineFaults for a pure crash scenario; I32_MAX/None = never."""
    dev = resolve_device(device)
    arr = np.array([I32_MAX if t is None else t for t in crash_ticks],
                   dtype=np.int32)
    return EngineFaults(crash_tick=torch.from_numpy(arr).to(dev))


def link_faults(crash_ticks: Sequence[int], windows, capacity: int,
                delays=(), delay_seed: int = 0, device="cuda") -> EngineFaults:
    """EngineFaults for crashes plus ``LinkWindow`` masks plus
    ``DelayRule`` latencies; ``delay_seed`` is the schedule seed keying
    the per-(edge, tick) jitter hash."""
    dev = resolve_device(device)
    base = crash_faults(crash_ticks, device=dev)
    t = lambda a: torch.from_numpy(a).to(dev)
    windows = tuple(windows)
    delays = tuple(delays)
    kw = {}
    if windows:
        w = len(windows)
        src = np.zeros((w, capacity), bool)
        dst = np.zeros((w, capacity), bool)
        start = np.zeros(w, np.int32)
        end = np.zeros(w, np.int32)
        period = np.zeros(w, np.int32)
        two_way = np.zeros(w, bool)
        for i, win in enumerate(windows):
            src[i, list(win.src_slots)] = True
            dst[i, list(win.dst_slots)] = True
            start[i] = win.start_tick
            end[i] = min(win.end_tick, I32_MAX)
            period[i] = win.period_ticks
            two_way[i] = win.two_way
        kw.update(link_src=t(src), link_dst=t(dst), link_start=t(start),
                  link_end=t(end), link_period=t(period),
                  link_two_way=t(two_way))
    if delays:
        r = len(delays)
        dsrc = np.zeros((r, capacity), bool)
        ddst = np.zeros((r, capacity), bool)
        dbase = np.zeros(r, np.int32)
        drev = np.zeros(r, np.int32)
        djit = np.zeros(r, np.int32)
        dstart = np.zeros(r, np.int32)
        dend = np.zeros(r, np.int32)
        for i, rule in enumerate(delays):
            dsrc[i, list(rule.src_slots)] = True
            ddst[i, list(rule.dst_slots)] = True
            dbase[i] = rule.delay_ticks
            drev[i] = rule.reverse_delay_ticks
            djit[i] = rule.jitter_ticks
            dstart[i] = rule.start_tick
            dend[i] = min(rule.end_tick, I32_MAX)
        shi, slo = hashing.to_limbs((delay_seed ^ 0x6A1770) & hashing.MASK64)
        kw.update(
            delay_src=t(dsrc), delay_dst=t(ddst), delay_base=t(dbase),
            delay_rev=t(drev), delay_jit=t(djit), delay_start=t(dstart),
            delay_end=t(dend),
            delay_seed_hi=torch.tensor(shi, dtype=torch.int64, device=dev),
            delay_seed_lo=torch.tensor(slo, dtype=torch.int64, device=dev))
    return EngineFaults(crash_tick=base.crash_tick, **kw)


def _with_fields(faults: EngineFaults, **fields) -> EngineFaults:
    """``faults`` with some tensor fields replaced, its drop configuration
    kept."""
    kw = {f: getattr(faults, f) for f in EngineFaults.FIELDS}
    kw.update(fields)
    return EngineFaults(**{f: getattr(faults, f)
                           for f in EngineFaults.DROP_CONFIG}, **kw)


def _grow(existing, pad: int, row_shape, dtype, device, fill=0):
    tail = torch.full((pad,) + tuple(row_shape), fill, dtype=dtype,
                      device=device)
    return tail if existing is None else torch.cat([existing, tail])


def pad_link_windows(faults: EngineFaults, w: int) -> EngineFaults:
    """The link-window tensors padded to exactly ``w`` rows with inert
    windows: empty endpoint sets and ``start == end == 0``, so a pad row
    is never active, blocks no edge and adds nothing to
    ``partitioned_edge_count``. A member with no windows grows them from
    nothing; ``w == n_windows`` is a no-op; shrinking raises."""
    cur = faults.n_windows
    if w == cur:
        return faults
    if w < cur:
        raise ValueError(f"cannot shrink {cur} link windows to {w}")
    c = int(faults.crash_tick.shape[0])
    pad, dev = w - cur, faults.crash_tick.device
    grow = lambda name, shape, dtype: _grow(getattr(faults, name), pad,
                                            shape, dtype, dev)
    return _with_fields(
        faults,
        link_src=grow("link_src", (c,), torch.bool),
        link_dst=grow("link_dst", (c,), torch.bool),
        link_start=grow("link_start", (), torch.int32),
        link_end=grow("link_end", (), torch.int32),
        link_period=grow("link_period", (), torch.int32),
        link_two_way=grow("link_two_way", (), torch.bool))


def pad_delay_rules(faults: EngineFaults, r: int) -> EngineFaults:
    """The delay-rule tensors padded to exactly ``r`` rows with inert
    rules: empty slot sets, zero base and jitter, no reverse direction
    and ``start == end == 0``, so every edge keeps delay 0 (the jitter is
    drawn mod 1). A member with no rules gets zero seed limbs, so every
    stacked member has the same fields; ``r == n_delay_rules`` is a
    no-op; shrinking raises."""
    cur = faults.n_delay_rules
    if r == cur:
        return faults
    if r < cur:
        raise ValueError(f"cannot shrink {cur} delay rules to {r}")
    c = int(faults.crash_tick.shape[0])
    pad, dev = r - cur, faults.crash_tick.device
    grow = lambda name, shape, dtype, fill=0: _grow(
        getattr(faults, name), pad, shape, dtype, dev, fill)
    limb = lambda v: (torch.zeros((), dtype=torch.int64, device=dev)
                      if v is None else v)
    return _with_fields(
        faults,
        delay_src=grow("delay_src", (c,), torch.bool),
        delay_dst=grow("delay_dst", (c,), torch.bool),
        delay_base=grow("delay_base", (), torch.int32),
        delay_rev=grow("delay_rev", (), torch.int32, -1),
        delay_jit=grow("delay_jit", (), torch.int32),
        delay_start=grow("delay_start", (), torch.int32),
        delay_end=grow("delay_end", (), torch.int32),
        delay_seed_hi=limb(faults.delay_seed_hi),
        delay_seed_lo=limb(faults.delay_seed_lo))


# ---------------------------------------------------------------------------
# the slot axis of every leaf: split over a slot mesh and joined back
# ---------------------------------------------------------------------------

#: The slot axis of every engine field that has one (``EngineState``,
#: ``EngineFaults``, ``StepLog``, ``churn.ChurnSchedule``,
#: ``paxos.FallbackSchedule``); every other field is replicated. It is
#: ``sharding.spec_for``'s layout, the first axis of length C. ``StepLog``'s
#: ``[C]`` rows count from the end, so a log stacked ``[T, C]`` splits and
#: joins the same way.
SLOT_AXES = {
    **dict.fromkeys((
        "member", "uid_hi", "uid_lo", "mfp_hi", "mfp_lo", "idfp_hi",
        "idfp_lo", "ring_order", "ring_rank", "subj_idx", "obs_idx",
        "gk_idx", "fd_active", "fd_first", "fc", "notified",
        "pending_flush", "pending_deliver", "churn_flush", "churn_deliver",
        "reports", "voters", "px_rnd_r", "px_rnd_i", "px_vrnd_r",
        "px_vrnd_i", "px_vval", "px_crnd_r", "px_crnd_i", "px_cval",
        "px_timer", "px_pos", "c1b_mask"), 0),
    **dict.fromkeys(("proposal", "decision"), -1),
    **dict.fromkeys(("crash_tick", "drop_targets"), 0),
    **dict.fromkeys(("link_src", "link_dst", "delay_src", "delay_dst"), 1),
    **dict.fromkeys((
        "join_tick", "join_epoch", "leave_tick", "leave_epoch",
        "redraw_tick", "redraw_hi", "redraw_lo", "redraw_idfp_hi",
        "redraw_idfp_lo"), 0),
    **dict.fromkeys(("prop_tick", "prop_pid", "prop_delay"), 1),
    "table_mask": 2,
}


def slot_axis(name: Optional[str], x: torch.Tensor,
              fleet: bool = False) -> Optional[int]:
    """The slot axis of leaf ``x`` of the field ``name`` (``SLOT_AXES``),
    or None for a replicated leaf. A bare tensor (``name`` None, such as
    a sub-kernel's output) has its rows on its first axis, a 0-d one
    none. In a fleet-stacked tree (``fleet``) every leaf carries the
    member axis first: a field's axis counts one further (one counted
    from the end stays), and a bare tensor's rows are its second axis."""
    lead = int(fleet)
    if name is None:
        return lead if x.dim() > lead else None
    axis = SLOT_AXES.get(name)
    if axis is not None and axis >= 0:
        axis += lead
    return axis


def _map_named(fn, *trees, name=None):
    """``fn(name, *leaves)`` over the tensor leaves of engine trees of one
    structure (NamedTuples, ``EngineFaults``, tuples, lists, dicts), with
    each leaf's field name; the first tree's other leaves are kept."""
    first = trees[0]
    if torch.is_tensor(first):
        return fn(name, *trees)
    if isinstance(first, EngineFaults):
        return _faults_unflatten(
            [_map_named(fn, *[getattr(t, f) for t in trees], name=f)
             for f in EngineFaults.FIELDS], _faults_flatten(first)[1])
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[_map_named(fn, *vs, name=f) for f, *vs in
                             zip(first._fields, *trees)])
    if isinstance(first, (tuple, list)):
        return type(first)(_map_named(fn, *vs, name=name)
                           for vs in zip(*trees))
    if isinstance(first, dict):
        return {k: _map_named(fn, *[t[k] for t in trees], name=k)
                for k in first}
    return first


def split_slots(tree, capacity: int, parts: int,
                fleet: bool = False) -> list:
    """``tree`` cut into ``parts`` trees of contiguous slots: each leaf
    with a slot axis of length ``capacity`` (``slot_axis``; ``fleet``: a
    fleet-stacked tree) narrowed to ``capacity / parts`` slots, the
    others shared whole."""
    per = capacity // parts

    def cut(k):
        def piece(name, x):
            axis = slot_axis(name, x, fleet)
            if axis is None or x.shape[axis] != capacity:
                return x
            return x.narrow(axis, k * per, per)
        return _map_named(piece, tree)

    return [cut(k) for k in range(parts)]


def join_slots(trees: Sequence, device, fleet: bool = False):
    """The inverse of ``split_slots`` on ``device``: leaves with a slot
    axis concatenated along it in shard order, the others taken from the
    first shard."""
    def whole(name, *xs):
        axis = None if len(xs) == 1 else slot_axis(name, xs[0], fleet)
        if axis is None:
            return xs[0].to(device)
        return torch.cat([x.to(device) for x in xs], dim=axis)

    return _map_named(whole, *trees)


def gather_slots(tree, group, fleet: bool = False):
    """``tree`` of one shard with every leaf that has a slot axis
    all-gathered along it (``group.all_gather``): the whole tree on this
    shard's device. A group of one shard gives ``tree``."""
    if group.size == 1:
        return tree

    def whole(name, x):
        axis = slot_axis(name, x, fleet)
        return x if axis is None else group.all_gather(x, dim=axis)

    return _map_named(whole, tree)
