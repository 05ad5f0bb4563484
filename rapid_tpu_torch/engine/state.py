"""Per-receiver engine state: the slot universe, the carry, the faults.

Field for field the reference's ``ReceiverState`` and ``ReceiverStepLog``
(see ``rapid_tpu.engine.state`` for the meaning of every field), as
NamedTuples of tensors. Dtypes follow the reference with one change:
every 64-bit value is a ``(hi, lo)`` pair of 32-bit limbs, and the port
carries each limb as ``int64`` holding ``[0, 2**32)`` (see ``hashing``).
Those fields are exactly the ones whose names end in ``_hi`` or ``_lo``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

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
    """Crash ticks plus link-window and delay-rule tensors.

    ``crash_tick[n]`` is the tick at/after which slot ``n`` is crashed
    (``I32_MAX`` = never). Window ``w`` blocks ``src -> dst`` at tick ``t``
    when ``link_src[w, src] & link_dst[w, dst]`` and the window is active
    (``link_start[w] <= t < link_end[w]`` and, for ``link_period[w] > 0``,
    the off-phase ``((t - start) // period) % 2 == 0``); ``link_two_way``
    blocks the reverse too. Rule ``r`` of the ``delay_*`` tensors delays
    ``src -> dst`` sends by ``delay_base`` (``delay_rev`` on the reverse,
    -1 = none) plus a hashed jitter in ``[0, delay_jit]``. ``None`` leaves
    mean no windows (W = 0) or no rules (R = 0).
    """

    FIELDS = ("crash_tick", "link_src", "link_dst", "link_start",
              "link_end", "link_period", "link_two_way", "delay_src",
              "delay_dst", "delay_base", "delay_rev", "delay_jit",
              "delay_start", "delay_end", "delay_seed_hi", "delay_seed_lo")

    def __init__(self, crash_tick, **kw) -> None:
        self.crash_tick = crash_tick
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
