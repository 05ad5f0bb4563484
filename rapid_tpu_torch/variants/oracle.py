"""Variant-aware oracle counters: the oracle's counters under a
``Settings.protocol_variant`` message model, computed on the host.

Own copy of the reference's ``variants.oracle``. The oracle always runs
the reference protocol: decisions, config ids and event ticks do not
depend on the variant inside its envelope (ring changes only the
transport; a hier scenario is admitted only where the two-level quorum
rule agrees with the flat one, which ``check_hier_envelope`` certifies
with ``hier.np_hier_decide``). What changes is the wire accounting, and
this module recomputes the oracle's per-tick counters from host facts
alone: the oracle's per-tick totals and per-phase consensus counts, its
event stream (replayed into per-tick membership masks, before and after
any view change of the tick) and the crash schedule.
``engine.diff.run_variant_differential`` holds these against the
engine's expanded logs.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from rapid_tpu_torch.variants import hier as hier_mod

#: Phase keys of ``SimNetwork.consensus_history``.
_PHASES = ("fast_vote", "phase1a", "phase1b", "phase2a", "phase2b")


class VariantEnvelopeError(ValueError):
    """Scenario outside a variant's bit-identical envelope.

    Raised before any comparison runs — e.g. a crash burst skewed into
    few hier groups, where the two-level quorum legitimately refuses a
    view change the flat quorum accepts. Such scenarios are protocol
    *behavior* differences, not bugs, and the differential only certifies
    scenarios where the variant and the reference must agree.
    """


def _membership_masks(
    n: int, events, n_ticks: int,
) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Per-tick membership masks from the oracle event stream.

    Returns (pre, post), each indexed by tick-1: ``pre[i]`` is the
    membership before any view change at tick i+1 (the engine's
    ``state.member`` during vote delivery), ``post[i]`` after it (the
    engine's ``mid.member`` during flush/announce). Crash differentials
    only remove members, so view-change slots are cleared.
    """
    member = np.ones(n, bool)
    removals: Dict[int, List[int]] = {}
    for e in events:
        if e.kind == "view_change":
            removals.setdefault(e.tick, []).extend(e.slots)
    pre: List[np.ndarray] = []
    post: List[np.ndarray] = []
    for t in range(1, n_ticks + 1):
        pre.append(member.copy())
        for s in removals.get(t, ()):
            member[s] = False
        post.append(member.copy())
    return pre, post


def _crash_masks(n: int, crash_ticks: Dict[int, int],
                 n_ticks: int) -> List[np.ndarray]:
    """``crashed[i][s]`` == slot s is crashed during tick i+1."""
    tick_of = np.full(n, np.iinfo(np.int64).max, np.int64)
    for s, t in crash_ticks.items():
        tick_of[s] = t
    return [tick_of <= t for t in range(1, n_ticks + 1)]


def _uid_limbs(uids: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    u = np.asarray(uids, np.uint64)
    return ((u >> np.uint64(32)).astype(np.uint32),
            (u & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _group_ids(uids: Sequence[int], n_groups: int):
    """i32 tensor [n]: each slot's hier group (``hier.group_ids``)."""
    hi, lo = _uid_limbs(uids)
    return hier_mod.group_ids(torch.from_numpy(hi.astype(np.int64)),
                              torch.from_numpy(lo.astype(np.int64)),
                              n_groups)


def check_hier_envelope(n: int, crash_ticks: Dict[int, int], events,
                        n_ticks: int, uids: Sequence[int],
                        n_groups: int) -> None:
    """Certify every announce lands the same way under both quorum rules.

    For each oracle proposal at tick ``ta``, the reference decided iff a
    view change fired at ``ta + 1``; the hier rule's verdict is
    recomputed host-side from the same voter/validity masks via the
    independent ``np_hier_decide`` twin. Any disagreement means the
    scenario exercises genuinely different protocol behavior — raise
    ``VariantEnvelopeError`` naming the announce instead of producing a
    vacuous differential.
    """
    pre, post = _membership_masks(n, events, n_ticks)
    crashed = _crash_masks(n, crash_ticks, n_ticks)
    uid_hi, uid_lo = _uid_limbs(uids)
    decide_ticks = {e.tick for e in events if e.kind == "view_change"}
    for e in events:
        if e.kind != "proposal":
            continue
        ta = e.tick
        td = ta + 1
        if td > n_ticks:
            continue
        voters = post[ta - 1] & ~crashed[ta - 1]
        valid = voters & ~crashed[td - 1]
        # Group sizes come from the decide-tick membership (the engine's
        # ``state.member`` — crashed slots are members until removed),
        # not from the voter set: a group's quorum is over its members.
        member = pre[td - 1]
        gate = bool((member & ~crashed[td - 1]).any())
        hier_decides = gate and hier_mod.np_hier_decide(
            member, valid, uid_hi, uid_lo, n_groups)
        rapid_decided = td in decide_ticks
        if hier_decides != rapid_decided:
            raise VariantEnvelopeError(
                f"announce at tick {ta} is outside the hier envelope: "
                f"flat quorum {'decides' if rapid_decided else 'fails'} "
                f"at tick {td} but the {n_groups}-group rule "
                f"{'decides' if hier_decides else 'fails'} "
                f"(voters={int(voters.sum())}, valid={int(valid.sum())})")


def variant_oracle_counters(
    variant: str,
    n: int,
    crash_ticks: Dict[int, int],
    events,
    tick_counters: List[Dict[str, int]],
    phase_counters: List[Dict[str, int]],
    uids: Sequence[int],
    contested: bool = False,
) -> Tuple[List[Dict[str, int]], List[Dict[str, int]]]:
    """The oracle's counters under ``variant``'s message model.

    Returns (tick_counters, phase_counters) shaped exactly like the
    inputs. ``contested`` selects the scripted-consensus accounting
    (fast votes are the scripted ``pxvote`` class, delivered == previous
    sent — crash-free envelope) over the organic-announce accounting
    (fast votes are the live vote class with crash-lossy delivery).
    ``variant == "rapid"`` is the identity.
    """
    if variant == "rapid":
        return ([dict(d) for d in tick_counters],
                [dict(d) for d in phase_counters])

    n_ticks = len(tick_counters)
    n_groups = hier_mod.hier_group_count(n)
    if variant == "hier":
        check_hier_envelope(n, crash_ticks, events, n_ticks, uids, n_groups)
        if contested:
            # The scripted contested instance runs the untouched
            # classic top-level fallback; hier only reshapes the organic
            # announce path, so contested accounting is the identity.
            return ([dict(d) for d in tick_counters],
                    [dict(d) for d in phase_counters])

    pre, post = _membership_masks(n, events, n_ticks)
    crashed = _crash_masks(n, crash_ticks, n_ticks)
    gid = _group_ids(uids, n_groups)

    def exchange(voters, relay_targets) -> int:
        return int(hier_mod.hier_exchange_messages(
            torch.from_numpy(voters), torch.from_numpy(relay_targets), gid,
            n_groups))

    out_tick: List[Dict[str, int]] = []
    out_phase: List[Dict[str, int]] = []
    prev_batch = prev_vote = prev_fast = 0
    for i in range(n_ticks):
        tk = dict(tick_counters[i])
        ph = dict(phase_counters[i])
        phase_sent = sum(ph[f"{p}_sent"] for p in _PHASES)
        phase_delivered = sum(ph[f"{p}_delivered"] for p in _PHASES)
        batch_sent = tk["sent"] - phase_sent
        batch_delivered = tk["delivered"] - phase_delivered
        fast_sent = ph["fast_vote_sent"]
        fast_delivered = ph["fast_vote_delivered"]

        m_post = int(post[i].sum())
        a_post = int((post[i] & ~crashed[i]).sum())
        a_pre = int((pre[i] & ~crashed[i]).sum())

        if variant == "ring":
            batch_sent = 2 * m_post if batch_sent > 0 else 0
            batch_delivered = 2 * a_post if batch_delivered > 0 else 0
            if contested:
                fast_sent = 2 * m_post if fast_sent > 0 else 0
                fast_delivered = prev_fast
            else:
                fast_sent = 2 * m_post if fast_sent > 0 else 0
                fast_delivered = 2 * a_pre if fast_delivered > 0 else 0
        else:  # hier, organic mode
            if fast_sent > 0:
                fast_sent = exchange(post[i] & ~crashed[i], post[i])
            if fast_delivered > 0:
                voters = post[i - 1] & ~crashed[i - 1]
                valid = voters & ~crashed[i]
                fast_delivered = exchange(valid, pre[i] & ~crashed[i])

        ph["fast_vote_sent"] = fast_sent
        ph["fast_vote_delivered"] = fast_delivered
        other_sent = sum(ph[f"{p}_sent"] for p in _PHASES[1:])
        other_delivered = sum(ph[f"{p}_delivered"] for p in _PHASES[1:])
        tk["sent"] = batch_sent + fast_sent + other_sent
        tk["delivered"] = batch_delivered + fast_delivered + other_delivered
        if contested:
            # Scripted fast votes are a px class: always delivered next
            # tick (crash-free), excluded from the dropped ledger.
            tk["dropped"] = prev_batch - batch_delivered
        else:
            tk["dropped"] = ((prev_batch - batch_delivered)
                            + (prev_vote - fast_delivered))
        prev_batch = batch_sent
        prev_vote = fast_sent
        prev_fast = fast_sent
        out_tick.append(tk)
        out_phase.append(ph)
    return out_tick, out_phase
