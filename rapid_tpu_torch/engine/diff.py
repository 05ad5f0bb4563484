"""Host-side extraction from the shared engine's stacked ``StepLog``.

The host half of the reference's differential harness: the event stream
(proposal and view-change ticks, contents and configuration ids) and the
exact per-tick message counts, multiplied out in Python ints from the
logged sender and recipient factors (a 100k-node broadcast tick is 10**10
messages, past int32). The leaves may be tensors on any device or numpy
arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ViewEvent:
    """One protocol-visible event, in slot coordinates."""

    tick: int
    kind: str               # "proposal" | "view_change"
    config_id: int          # pre-change for proposals, post-change for
                            # view changes
    slots: Tuple[int, ...]  # proposed / removed slots, ascending

    def as_dict(self) -> Dict[str, object]:
        return {"tick": self.tick, "kind": self.kind,
                "config_id": self.config_id, "slots": list(self.slots)}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def engine_events(logs) -> List[ViewEvent]:
    """The engine's event stream from stacked StepLogs."""
    ticks = _np(logs.tick)
    ann = _np(logs.announce_now)
    dec = _np(logs.decide_now)
    proposal = _np(logs.proposal)
    decision = _np(logs.decision)
    cfg = ((_np(logs.config_hi).astype(np.uint64) << np.uint64(32))
           | _np(logs.config_lo).astype(np.uint64))
    events: List[ViewEvent] = []
    for i in range(len(ticks)):
        if ann[i]:
            events.append(ViewEvent(
                int(ticks[i]), "proposal", int(cfg[i]),
                tuple(int(s) for s in np.nonzero(proposal[i])[0])))
        if dec[i]:
            events.append(ViewEvent(
                int(ticks[i]), "view_change", int(cfg[i]),
                tuple(int(s) for s in np.nonzero(decision[i])[0])))
    return events


def expand_counters(logs) -> List[Dict[str, int]]:
    """Per-tick exact message counts from the StepLog factors.

    ``dropped`` at tick t is what came due at t and was not delivered:
    last tick's sends minus this tick's deliveries, per traffic class.
    """
    col = lambda name: [int(v) for v in _np(getattr(logs, name))]
    flushers, flush_rcpt = col("flushers"), col("flush_recipients")
    flush_alive, deliver_alive = col("flushers_alive"), col("deliver_alive")
    vote_send, vote_rcpt = col("vote_senders"), col("vote_recipients")
    vote_alive, vote_deliver = (col("vote_senders_alive"),
                                col("vote_deliver_alive"))
    probes_sent, probes_failed = col("probes_sent"), col("probes_failed")
    px = expand_fallback_counters(logs)

    out: List[Dict[str, int]] = []
    prev_batch_sent = prev_vote_sent = 0
    for i in range(len(flushers)):
        batch_sent = flushers[i] * flush_rcpt[i]
        vote_sent = vote_send[i] * vote_rcpt[i]
        batch_delivered = flush_alive[i] * deliver_alive[i]
        vote_delivered = vote_alive[i] * vote_deliver[i]
        px_sent = sum(v for k, v in px[i].items() if k.endswith("_sent"))
        px_delivered = sum(v for k, v in px[i].items()
                           if k.endswith("_delivered"))
        out.append({
            "sent": batch_sent + vote_sent + px_sent,
            "delivered": batch_delivered + vote_delivered + px_delivered,
            "dropped": (prev_batch_sent - batch_delivered)
                       + (prev_vote_sent - vote_delivered),
            "timeouts": 0,
            "probes_sent": probes_sent[i],
            "probes_failed": probes_failed[i],
        })
        prev_batch_sent = batch_sent
        prev_vote_sent = vote_sent
    return out


#: (log field pair -> phase key) for the classic-Paxos message classes.
_PX_CLASSES = (
    ("pxvote_senders", "pxvote_recipients", "fast_vote"),
    ("px1a_senders", "px1a_recipients", "phase1a"),
    ("px1b_senders", None, "phase1b"),              # unicast: 1 recipient
    ("px2a_senders", "px2a_recipients", "phase2a"),
    ("px2b_senders", "px2b_recipients", "phase2b"),
)


def expand_fallback_counters(logs) -> List[Dict[str, int]]:
    """Per-tick per-phase consensus message counts from the StepLog
    factors; every message sent at t-1 is delivered at t."""
    fields = {name: [int(v) for v in _np(getattr(logs, name))]
              for s, r, _ in _PX_CLASSES
              for name in (s, r) if name is not None}
    out: List[Dict[str, int]] = []
    prev = {phase: 0 for _, _, phase in _PX_CLASSES}
    for i in range(len(_np(logs.tick))):
        row: Dict[str, int] = {}
        for s_name, r_name, phase in _PX_CLASSES:
            sent = fields[s_name][i]
            if r_name is not None:
                sent *= fields[r_name][i]
            row[f"{phase}_sent"] = sent
            row[f"{phase}_delivered"] = prev[phase]
            prev[phase] = sent
        out.append(row)
    return out
