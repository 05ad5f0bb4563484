"""Plain reference of a run's summary: the message totals and the view
changes a user reads off a finished scenario.

Per tick: messages sent, delivered and dropped (dropped is what was due
and did not arrive), probes sent and failed, the announce and decide
flags, the partitioned-edge gauge and the link drops. The summary counts
announcements and decisions, the ticks to the first of each, and for
every decide the messages sent and delivered since the previous one.
"""
from __future__ import annotations

PHASES = ("fast_vote", "phase1a", "phase1b", "phase2a", "phase2b")


def shared_ticks(cols) -> list:
    """Per-tick rows of the shared engine's columns: a batch goes from
    each flusher to every member, a vote from each voter to every member,
    and what was due last tick and did not land counts as dropped."""
    rows, prev_batch, prev_vote = [], 0, 0
    for i in range(len(cols["n_member"])):
        g = lambda name: int(cols[name][i])
        batch = g("flushers") * g("flush_recipients")
        vote = g("vote_senders") * g("vote_recipients")
        batch_in = g("flushers_alive") * g("deliver_alive")
        vote_in = g("vote_senders_alive") * g("vote_deliver_alive")
        phase = {"fast_vote": g("pxvote_senders") * g("pxvote_recipients"),
                 "phase1a": g("px1a_senders") * g("px1a_recipients"),
                 "phase1b": g("px1b_senders"),
                 "phase2a": g("px2a_senders") * g("px2a_recipients"),
                 "phase2b": g("px2b_senders") * g("px2b_recipients")}
        delivered_px = sum(rows[-1]["phase"].values()) if rows else 0
        rows.append({
            "sent": batch + vote + sum(phase.values()),
            "delivered": batch_in + vote_in + delivered_px,
            "dropped": prev_batch - batch_in + prev_vote - vote_in,
            "probes_sent": g("probes_sent"),
            "probes_failed": g("probes_failed"),
            "announce": g("announce_now") > 0, "decide": g("decide_now") > 0,
            "partitioned_edges": g("partitioned_edges"),
            "link_dropped": g("link_dropped"), "inv": g("inv_bits"),
            "phase": phase})
        prev_batch, prev_vote = batch, vote
    return rows


def receiver_ticks(cols, announce, decide) -> list:
    """Per-tick rows of the per-receiver engine: its counters as they
    are, a tick announcing or deciding when any process does."""
    rows = []
    for i in range(len(cols["sent"])):
        g = lambda name: int(cols[name][i])
        rows.append({
            "sent": g("sent"), "delivered": g("delivered"),
            "dropped": g("dropped"), "probes_sent": g("probes_sent"),
            "probes_failed": g("probes_failed"),
            "announce": bool(announce[i].any()),
            "decide": bool(decide[i].any()),
            "partitioned_edges": g("partitioned_edges"),
            "link_dropped": g("link_dropped"), "inv": 0,
            "phase": {"fast_vote": g("fv_sent"), "phase1a": g("p1a_sent"),
                      "phase1b": g("p1b_sent"), "phase2a": g("p2a_sent"),
                      "phase2b": g("p2b_sent")}})
    return rows


def summary(rows: list) -> dict:
    first_announce = first_decide = window_announce = None
    announcements = decisions = 0
    view_changes = []
    window_start = window_sent = window_delivered = 0
    totals = dict.fromkeys(("sent", "delivered", "dropped", "probes_sent",
                            "probes_failed"), 0)
    phases = dict.fromkeys(PHASES, 0)
    for tick, r in enumerate(rows, start=1):
        for key in totals:
            totals[key] += r[key]
        for key in PHASES:
            phases[key] += r["phase"][key]
        window_sent += r["sent"]
        window_delivered += r["delivered"]
        if r["announce"]:
            announcements += 1
            window_announce = tick
            first_announce = first_announce or tick
        if r["decide"]:
            decisions += 1
            first_decide = first_decide or tick
            view_changes.append({
                "announce_tick": window_announce, "decide_tick": tick,
                "ticks_to_decide": tick - window_start,
                "messages_sent": window_sent,
                "messages_delivered": window_delivered})
            window_start, window_announce = tick, None
            window_sent = window_delivered = 0
    return {
        "n_ticks": len(rows),
        "announcements": announcements,
        "decisions": decisions,
        "ticks_to_first_announce": first_announce,
        "ticks_to_first_decide": first_decide,
        "messages_per_view_change": (
            sum(v["messages_sent"] for v in view_changes) / len(view_changes)
            if view_changes else None),
        "view_changes": view_changes,
        "total_sent": totals["sent"],
        "total_delivered": totals["delivered"],
        "total_dropped": totals["dropped"],
        "total_timeouts": 0,
        "total_probes_sent": totals["probes_sent"],
        "total_probes_failed": totals["probes_failed"],
        "invariant_violations": sum(1 for r in rows if r["inv"] > 0),
        "fallback_phase_sent": phases,
        "max_partitioned_edges": max([0] + [r["partitioned_edges"]
                                            for r in rows]),
        "total_link_dropped": sum(r["link_dropped"] for r in rows
                                  if r["link_dropped"] > 0),
    }

