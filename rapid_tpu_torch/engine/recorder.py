"""The flight recorder: a bounded ring of per-tick gauges and first-event
stamps, kept beside a run.

With ``Settings.flight_recorder_window`` W > 0, ``step.simulate`` and
``receiver.receiver_simulate`` return ``(final, logs, recorder)``: the
ring holds one ``GAUGE_NAMES`` row for each of the last W ticks (row
``count % W`` is written next) and the stamps the first tick a proposal
was announced, a view change decided, classic-Paxos traffic moved and an
invariant or envelope flag fired (-1: never). Gauges a kernel does not
observe hold ``UNOBSERVED``. The rows are a function of the step logs
alone, so both engines fold a whole run's stacked logs at once
(``record_run``, ``record_receiver_run``); ``record_step`` and
``record_receiver_step`` fold one tick's log, as the reference's scan
does; ``record_fleet_run`` folds a fleet's ``[F, T]`` logs per member.
With W = 0 nothing here is called.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rapid_tpu_torch.device import resolve_device
from rapid_tpu_torch.settings import Settings

#: The value of a gauge the emitting engine does not observe.
UNOBSERVED = -1

#: One row of the ring, in column order. The shared step fills the
#: protocol gauges; the per-receiver step the wire counters and flags.
GAUGE_NAMES = (
    "tick",
    "n_member",
    "alerts_in_flight",
    "cut_reports",
    "vote_tally",
    "epoch",
    "px_timers_armed",
    "px_coord_round",
    "inv_bits",
    "announces",
    "decides",
    "sent",
    "delivered",
    "dropped",
    "flags",
)

N_GAUGES = len(GAUGE_NAMES)
_SHARED_ONLY = 8        # gauges 1-8 are the shared step's


class RecorderState(NamedTuple):
    """The ring and stamps; every leaf is int32."""

    ring: object             # i32 [W, G] last-W gauge rows, ring order
    count: object            # i32 ticks recorded (write pos = count % W)
    first_announce: object   # i32 first tick a proposal was announced
    first_decide: object     # i32 first tick a view change decided
    first_fallback: object   # i32 first tick classic-Paxos traffic moved
    first_violation: object  # i32 first tick inv_bits/flags went nonzero


def init(settings: Settings, device="cuda") -> RecorderState:
    """An empty recorder on ``device``; refuses a window of 0."""
    w = int(settings.flight_recorder_window)
    if w <= 0:
        raise ValueError("recorder.init called with flight_recorder_window=0")
    dev = resolve_device(device)
    neg = lambda: torch.tensor(-1, dtype=torch.int32, device=dev)
    return RecorderState(
        ring=torch.full((w, N_GAUGES), UNOBSERVED, dtype=torch.int32,
                        device=dev),
        count=torch.tensor(0, dtype=torch.int32, device=dev),
        first_announce=neg(), first_decide=neg(), first_fallback=neg(),
        first_violation=neg())


def _push(rec: RecorderState, rows, ticks, announced, decided, fallback,
          violated) -> RecorderState:
    """Write ``T`` gauge rows (``[T, G]``) from position ``count % W`` on,
    and fold the ``[T]`` event masks into the stamps."""
    w, t = rec.ring.shape[0], rows.shape[0]
    kept = min(t, w)
    at = torch.arange(t - kept, t, device=rows.device)
    ring = rec.ring.clone()
    ring[(rec.count.to(torch.int64) + at) % w] = rows[t - kept:]
    ticks = ticks.to(torch.int32)

    def stamp(old, cond):
        first = ticks[torch.argmax(cond.to(torch.uint8))]
        return torch.where((old < 0) & cond.any(), first, old)

    return RecorderState(
        ring=ring,
        count=rec.count + t,
        first_announce=stamp(rec.first_announce, announced),
        first_decide=stamp(rec.first_decide, decided),
        first_fallback=stamp(rec.first_fallback, fallback),
        first_violation=stamp(rec.first_violation, violated))


def record_run(rec: RecorderState, logs, settings: Settings) -> RecorderState:
    """Fold a shared run's stacked ``StepLog`` (leading tick axis)."""
    i32 = lambda x: torch.as_tensor(x).to(torch.int32)
    announced = torch.as_tensor(logs.announce_now).to(torch.bool)
    decided = torch.as_tensor(logs.decide_now).to(torch.bool)
    fallback = (i32(logs.pxvote_senders) + i32(logs.px1a_senders)
                + i32(logs.px1b_senders) + i32(logs.px2a_senders)
                + i32(logs.px2b_senders)) > 0
    inv = i32(logs.inv_bits)
    un = torch.full_like(inv, UNOBSERVED)
    rows = torch.stack([
        i32(logs.tick), i32(logs.n_member), i32(logs.alerts_in_flight),
        i32(logs.cut_reports), i32(logs.vote_tally), i32(logs.epoch),
        i32(logs.px_timers_armed), i32(logs.px_coord_round), inv,
        i32(announced), i32(decided),
        un, un, un, un,          # sent / delivered / dropped / flags
    ], dim=1)
    return _push(rec, rows, logs.tick, announced, decided, fallback,
                 inv != 0)


def record_receiver_run(rec: RecorderState, logs,
                        settings: Settings) -> RecorderState:
    """Fold a per-receiver run's stacked ``ReceiverStepLog``."""
    i32 = lambda x: torch.as_tensor(x).to(torch.int32)
    announce = torch.as_tensor(logs.announce).to(torch.bool)
    decide = torch.as_tensor(logs.decide).to(torch.bool)
    fallback = (i32(logs.p1a_sent) + i32(logs.p1b_sent)
                + i32(logs.p2a_sent) + i32(logs.p2b_sent)) > 0
    flags = i32(logs.flags)
    un = torch.full_like(flags, UNOBSERVED)
    rows = torch.stack(
        [i32(logs.tick)] + [un] * _SHARED_ONLY
        + [announce.sum(dim=-1, dtype=torch.int32),
           decide.sum(dim=-1, dtype=torch.int32),
           i32(logs.sent), i32(logs.delivered), i32(logs.dropped), flags],
        dim=1)
    return _push(rec, rows, logs.tick, announce.any(dim=-1),
                 decide.any(dim=-1), fallback, flags != 0)


def record_fleet_run(logs, settings: Settings, fold) -> RecorderState:
    """Fold a fleet's member-major logs (``[F, T, ...]``) into one
    recorder per member, ``[F, W, G]`` rings and ``[F]`` stamps, in one
    batched pass; ``fold`` is ``record_run`` or ``record_receiver_run``."""
    from rapid_tpu_torch.engine.state import member_map

    f = logs.tick.shape[0]
    fresh = init(settings, device=logs.tick.device)
    recs = RecorderState(*[leaf.expand((f,) + leaf.shape).clone()
                           for leaf in fresh])
    return member_map(lambda r, lg: fold(r, lg, settings), recs, logs)


def member_recorder(recs: RecorderState, i: int) -> RecorderState:
    """Member ``i``'s recorder out of a fleet's stacked recorders."""
    return RecorderState(*[leaf[i] for leaf in recs])


def _one_tick(log):
    return type(log)(*[torch.as_tensor(f)[None] for f in log])


def record_step(rec: RecorderState, log, settings: Settings) -> RecorderState:
    """Fold one shared ``StepLog`` tick."""
    return record_run(rec, _one_tick(log), settings)


def record_receiver_step(rec: RecorderState, log,
                         settings: Settings) -> RecorderState:
    """Fold one ``ReceiverStepLog`` tick."""
    return record_receiver_run(rec, _one_tick(log), settings)


# --- host-side extraction ------------------------------------------------

def _host(x) -> np.ndarray:
    return np.asarray(x.cpu()) if torch.is_tensor(x) else np.asarray(x)


def ring_rows(rec: RecorderState) -> np.ndarray:
    """The recorded rows in tick order, ``[min(count, W), G]``: a partial
    fill gives the written prefix, a full ring starts at the oldest
    retained tick."""
    ring = _host(rec.ring)
    count = int(_host(rec.count))
    w = ring.shape[0]
    if count <= w:
        return ring[:count]
    pos = count % w
    return np.concatenate([ring[pos:], ring[:pos]], axis=0)


def stamps(rec: RecorderState) -> dict:
    """The first-event stamps as Python ints (-1: never)."""
    return {name: int(_host(getattr(rec, name)))
            for name in ("first_announce", "first_decide", "first_fallback",
                         "first_violation")}


def recorder_payload(rec: RecorderState) -> dict:
    """JSON-ready block of one recorder, in the reference's form."""
    return {
        "window": int(_host(rec.ring).shape[0]),
        "gauges": list(GAUGE_NAMES),
        "ticks_recorded": int(_host(rec.count)),
        "rows": [[int(v) for v in row] for row in ring_rows(rec)],
        "stamps": stamps(rec),
    }
