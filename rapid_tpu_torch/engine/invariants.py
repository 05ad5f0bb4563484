"""The shared engine's invariant monitor: protocol invariants every tick.

Seven checks, each folded to one bool and packed into the ``int32`` of
``StepLog.inv_bits`` (bit order is the reference's and append-only):

- **ring_degree**: member rows' subjects and observers are members (and,
  with two or more members, not the row itself); dormant rows
  self-point;
- **report_monotone**: report cells clear only at a decided view change;
- **unique_decide**: the fast round and the classic chain never both
  decide a tick, a decision carries a non-empty mask, and a fast quorum
  forms only for an announced proposal;
- **rank_order**: ``vrnd <= rnd``, a non-zero ``vrnd`` carries a value,
  a chosen coordinator value implies a started round;
- **epoch_monotone**: the epoch advances by exactly this tick's decides;
- **memsum**: the incremental member-fingerprint sum equals the sum over
  the member mask;
- **ghost_reports**: every cell filled this tick comes from an alert in
  flight (monitor or churn) or from the invalidation predicate.

``step`` calls ``check_step`` only under ``Settings.invariant_checks``;
otherwise ``inv_bits`` is the constant 0. On the host, ``check_run``
raises ``InvariantViolationError`` at the first violating tick.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from rapid_tpu_torch import hashing
from rapid_tpu_torch.engine.paxos import rank_lt
from rapid_tpu_torch.telemetry.forensics import (
    DivergenceError, DivergenceReport)

#: Violation bits, in bit order.
INVARIANT_BITS = (
    ("ring_degree", 0),
    ("report_monotone", 1),
    ("unique_decide", 2),
    ("rank_order", 3),
    ("epoch_monotone", 4),
    ("memsum", 5),
    ("ghost_reports", 6),
)

BIT_OF = {name: bit for name, bit in INVARIANT_BITS}
ALL_BITS = sum(1 << bit for _, bit in INVARIANT_BITS)


def describe_bits(mask: int) -> List[str]:
    """The invariant names of a violation bitmask, in bit order."""
    return [name for name, bit in INVARIANT_BITS if (mask >> bit) & 1]


def _ring_degree(post):
    c = post.member.shape[0]
    slots = torch.arange(c, dtype=torch.int32,
                         device=post.member.device)[:, None]
    subj, obs = post.subj_idx, post.obs_idx
    m_rows = post.member[:, None]
    multi = post.member.sum() >= 2
    bad_member = m_rows & (
        ~post.member[subj.long()] | ~post.member[obs.long()]
        | (multi & ((subj == slots) | (obs == slots))))
    bad_dormant = ~m_rows & ((subj != slots) | (obs != slots))
    return (bad_member | bad_dormant).any()


def _rank_order(post):
    bad = rank_lt(post.px_rnd_r, post.px_rnd_i,
                  post.px_vrnd_r, post.px_vrnd_i)
    bad = bad | ((post.px_vrnd_r > 0) & (post.px_vval < 0))
    bad = bad | ((post.px_cval >= 0) & (post.px_crnd_r <= 0))
    return bad.any()


def _memsum(post):
    m = post.member.to(torch.int64)
    hi, lo = hashing.sum64_axis(post.mfp_hi * m, post.mfp_lo * m)
    return (hi != post.memsum_hi) | (lo != post.memsum_lo)


def _ghost_reports(pre, post, settings):
    added = post.reports & ~pre.reports
    eff_obs = torch.where(post.member[:, None], post.obs_idx,
                          post.gk_idx).long()
    in_flight = torch.gather(pre.pending_deliver, 0, eff_obs)
    explicit = in_flight | pre.churn_deliver[:, None]
    at_lo = post.reports.sum(dim=1) >= settings.L
    implicit = at_lo[:, None] & at_lo[eff_obs]
    return (added & ~explicit & ~implicit).any()


def check_step(pre, post, *, decide_now, fast_decide, classic_decide,
               fast_mask, classic_mask, settings):
    """Every check of one tick, packed into a 0-d int32 bitmask (0 when
    every invariant holds). ``pre``/``post`` are the states before and
    after the tick; ``fast_decide``/``classic_decide`` (0-d bool) this
    tick's decision sources, with ``fast_mask``/``classic_mask`` their
    proposal masks."""
    win_mask = torch.where(classic_decide, classic_mask, fast_mask)
    flags = {
        "ring_degree": _ring_degree(post),
        "report_monotone": ~decide_now & (pre.reports
                                          & ~post.reports).any(),
        "unique_decide": ((fast_decide & classic_decide)
                          | (decide_now & ~win_mask.any())
                          | (fast_decide & ~pre.announced)),
        "rank_order": _rank_order(post),
        "epoch_monotone": post.epoch != pre.epoch + decide_now.to(
            torch.int32),
        "memsum": _memsum(post),
        "ghost_reports": _ghost_reports(pre, post, settings),
    }
    bits = torch.stack([flags[name].to(torch.int32) << bit
                        for name, bit in INVARIANT_BITS])
    return bits.sum(dtype=torch.int32)


def expand_violations(logs) -> List[Tuple[int, int, List[str]]]:
    """Nonzero violation rows of a stacked run log, as ``(tick, bitmask,
    [invariant names])`` in tick order."""
    ticks = np.asarray(torch.as_tensor(logs.tick).cpu())
    bits = np.asarray(torch.as_tensor(logs.inv_bits).cpu())
    return [(int(ticks[i]), int(bits[i]), describe_bits(int(bits[i])))
            for i in range(len(bits)) if int(bits[i])]


class InvariantViolationError(DivergenceError):
    """An invariant check fired; ``report`` names the first violating
    tick and its invariants."""

    def __init__(self, report: DivergenceReport,
                 artifact: Optional[str] = None) -> None:
        self.report = report
        self.artifact = artifact
        lines = [f"on-device invariant monitor fired at tick "
                 f"{report.tick}: {report.field} "
                 f"(bitmask {report.engine:#x})"]
        for rec in report.context:
            if rec.get("record") == "invariant_violation":
                lines.append(f"  tick {rec['tick']}: "
                             f"{'+'.join(rec['invariants'])} "
                             f"(bits {rec['bits']:#x})")
        if artifact:
            lines.append(f"forensics artifact: {artifact}")
        AssertionError.__init__(self, "\n".join(lines))


def check_run(logs, metrics: Optional[Sequence] = None,
              artifact: Optional[str] = None, context_n: int = 16) -> None:
    """Raise ``InvariantViolationError`` at a run's first violating tick,
    with up to ``context_n`` violating ticks (and, given ``metrics``, the
    last metrics rows up to that tick) as context; a clean run returns.
    ``artifact``, or the ``RAPID_TPU_FORENSICS`` variable, names a JSONL
    file to write the report to."""
    violations = expand_violations(logs)
    if not violations:
        return
    tick, bits, names = violations[0]
    context = []
    if metrics:
        context += [dict(m.as_dict(), record="tick_metrics")
                    for m in metrics if m.tick <= tick][-4:]
    context += [{"record": "invariant_violation", "tick": t, "bits": b,
                 "invariants": ns} for t, b, ns in violations[:context_n]]
    report = DivergenceReport(
        tick=tick, field="invariants." + "+".join(names),
        engine=bits, oracle=0, context=context)
    artifact = artifact or os.environ.get("RAPID_TPU_FORENSICS")
    if artifact:
        report.write_jsonl(artifact)
    raise InvariantViolationError(report, artifact)
