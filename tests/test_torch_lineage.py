"""The port's consensus lineage against the reference's.

The four families of ``tests/test_lineage.py`` at N=64, each run by both
packages' engines and folded by each package's lineage: steady (no
faults: no span), a crash burst (slots 12, 21 and 62), the contested
two-way split (the classic 1a/1b/2a/2b milestones) on the shared engine;
the delay family (a crash and a ``DelayRule`` over a slot block) on the
per-receiver engine, folded per member with its critical paths and per
slot from the counter streams. Spans, ``comparable`` projections and
``lineage_summary`` blocks are equal; every span obeys the phase order
and the telescoping sum. Recorder rings (the synthetic rings of
``tests/test_lineage.py`` and ``rx_n64_recorder.json``'s) fold alike,
with the evicted head span truncated; ``LineageFold`` is chunk-split
invariant, its state survives JSON, and it equals the reference's on
``TickMetrics`` rows. The constants equal the reference's and the
schema's. Tolerance: exact.
"""
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

from rapid_tpu import faults as ref_faults
from rapid_tpu.engine import fleet as ref_fleet
from rapid_tpu.engine import paxos as ref_paxos
from rapid_tpu.engine import receiver as ref_rx
from rapid_tpu.engine.state import crash_faults as ref_crash_faults
from rapid_tpu.engine.state import init_state as ref_init_state
from rapid_tpu.settings import Settings as RefSettings
from rapid_tpu.telemetry import lineage as ref_lineage
from rapid_tpu.telemetry import metrics as ref_metrics
from rapid_tpu.telemetry import schema as ref_schema

from rapid_tpu_torch import faults, golden
from rapid_tpu_torch.convert import from_reference
from rapid_tpu_torch.engine import receiver, step
from rapid_tpu_torch.engine.state import I32_MAX
from rapid_tpu_torch.identity import default_identities
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry import lineage, metrics, schema

ref_simulate = importlib.import_module("rapid_tpu.engine.step").simulate
N = 64


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _shared_boot(family):
    if family == "contested":
        from rapid_tpu.engine.diff import default_endpoints
        from rapid_tpu.oracle.membership_view import uid_of

        uids = np.asarray([uid_of(e) for e in default_endpoints(N)],
                          np.uint64)
        sched, _ = ref_paxos.plan_fallback(
            N, [[0], [1]], {s: (6, s % 2) for s in range(N)},
            {s: (10 if s == 0 else 100) for s in range(N)}, RefSettings(),
            uids=uids)
        crash, ticks = {}, 40
    else:
        sched, ticks = None, 200
        crash = ({} if family == "steady"
                 else {max(1, N // 5): 5, max(2, N // 3): 5, N - 2: 7})
    uids, id_fp_sum = default_identities(N)
    ticks_ = [crash.get(s, I32_MAX) for s in range(N)]
    return (ref_init_state(uids, id_fp_sum, RefSettings()),
            ref_crash_faults(ticks_), sched, ticks)


@pytest.fixture(scope="module",
                params=["steady", "crash_burst", "contested"])
def shared_family(request):
    state, crash, sched, ticks = _shared_boot(request.param)
    kw = {} if sched is None else {"fallback": sched}
    _, want = ref_simulate(state, crash, ticks, RefSettings(), **kw)
    port_kw = ({} if sched is None
               else {"fallback": from_reference(sched, device="cpu")})
    _, got = step.simulate(from_reference(state, device="cpu"),
                           from_reference(crash, device="cpu"), ticks,
                           Settings(), device="cpu", **port_kw)
    return request.param, want, got


def _delay_schedule(pkg, n=N, seed=5):
    block = max(2, n // 8)
    return pkg.AdversarySchedule(
        n=n, crashes=((n - 1, 11),),
        delays=(pkg.DelayRule(src_slots=frozenset(range(block)),
                              dst_slots=frozenset(range(block, n // 2)),
                              delay_ticks=2),),
        seed=seed)


@pytest.fixture(scope="module")
def delay_family():
    ticks = 200
    member = ref_fleet.lower_receiver_schedule(_delay_schedule(ref_faults),
                                               RefSettings())
    _, want = ref_rx.receiver_simulate(member.state, member.faults, ticks,
                                       RefSettings())
    pmember = receiver.lower_receiver_schedule(_delay_schedule(faults),
                                               Settings(), device="cpu")
    _, got = receiver.receiver_simulate(pmember.state, pmember.faults, ticks,
                                        Settings())
    return want, got


def _spans_with_paths(lin, logs, schedule):
    spans = lin.fold_spans(lin.receiver_phase_columns(logs))
    for sp in spans:
        sp["critical_path"] = lin.receiver_critical_path(logs, sp, schedule)
    return spans


def test_shared_families_fold_to_the_reference_spans(shared_family):
    family, want_logs, logs = shared_family
    want = ref_lineage.fold_spans(ref_lineage.engine_phase_columns(
        want_logs), start_tick=0)
    got = lineage.fold_spans(lineage.engine_phase_columns(logs),
                             start_tick=0)
    assert got == want
    assert [lineage.comparable(s) for s in got] == \
        [ref_lineage.comparable(s) for s in want]
    assert lineage.lineage_summary(got) == ref_lineage.lineage_summary(want)
    if family == "steady":
        assert got == []
    else:
        assert got
    if family == "contested":
        assert any(s["fallback"] and s["milestones"]["phase1a_tick"]
                   for s in got)
    cols = lineage.engine_phase_columns(logs)
    ref_cols = ref_lineage.engine_phase_columns(want_logs)
    for f in dataclasses.fields(lineage.PhaseColumns):
        assert np.array_equal(getattr(cols, f.name),
                              getattr(ref_cols, f.name)), f.name


def test_delay_family_folds_to_the_reference_spans(delay_family):
    want_logs, logs = delay_family
    want = _spans_with_paths(ref_lineage, want_logs,
                             _delay_schedule(ref_faults))
    got = _spans_with_paths(lineage, logs, _delay_schedule(faults))
    assert got == want and got
    assert any(s["critical_path"] is not None for s in got)
    for sp in got:
        assert schema.validate_lineage_span(sp) == []
    # Per slot, from the counter streams and each slot's events.
    counters = receiver.receiver_counters(logs)
    phases = receiver.receiver_phase_counters(logs)
    events = receiver.receiver_events(logs)
    ref_events = ref_rx.receiver_events(want_logs)
    for s in range(N):
        got_s = lineage.fold_spans(lineage.counter_phase_columns(
            counters, phases, events[s]), start_tick=0)
        want_s = ref_lineage.fold_spans(ref_lineage.counter_phase_columns(
            ref_rx.receiver_counters(want_logs),
            ref_rx.receiver_phase_counters(want_logs), ref_events[s]),
            start_tick=0)
        assert got_s == want_s, s


def test_span_invariants_and_telescoping_sum(shared_family, delay_family):
    spans = lineage.fold_spans(lineage.engine_phase_columns(
        shared_family[2]), start_tick=0)
    spans += lineage.fold_spans(lineage.receiver_phase_columns(
        delay_family[1]))
    for sp in spans:
        assert schema.validate_lineage_span(sp) == []
        assert not sp["truncated"]
        ms, d = sp["milestones"], sp["decide_tick"]
        assert sp["window_start"] < d
        for name in lineage.LINEAGE_MILESTONES:
            if ms[name] is not None:
                assert sp["window_start"] < ms[name] <= d, name
        if ms["announce_tick"] is not None and \
                ms["first_vote_tick"] is not None:
            assert ms["announce_tick"] <= ms["first_vote_tick"]
        dur = sp["durations"]
        assert all(v is not None and v >= 0 for v in dur.values())
        assert sum(dur.values()) == sp["ticks_to_view_change"]
        if sp["fallback"]:
            assert dur["fast_vote_wait"] == 0
        else:
            assert dur["fallback_wait"] == dur["classic_phase_ticks"] == 0
    assert schema.validate_lineage_summary(lineage.lineage_summary(spans)) \
        == []


def test_lineage_fold_on_tick_metrics_equals_the_reference(shared_family):
    _, want_logs, logs = shared_family
    rows = metrics.engine_metrics(logs)
    ref_rows = ref_metrics.engine_metrics(want_logs)
    fold, ref_fold = lineage.LineageFold(), ref_lineage.LineageFold()
    got, want = [], []
    for lo in range(0, len(rows), 23):
        got += fold.fold(rows[lo:lo + 23])
        want += ref_fold.fold(ref_rows[lo:lo + 23])
        fold = lineage.LineageFold.from_state(
            json.loads(json.dumps(fold.state_dict())))
    assert got == want
    assert fold.state_dict() == ref_fold.state_dict()
    assert fold.fold([]) == []


_RING_GAUGES = ("tick", "alerts_in_flight", "cut_reports", "vote_tally",
                "announces", "decides", "px_timers_armed")


def _ring_payload(first_tick, ticks_recorded):
    t = first_tick
    rows = [[t + 0, 2, 0, 0, 0, 0, 0], [t + 1, 0, 3, 0, 1, 0, 0],
            [t + 2, 0, 0, 5, 0, 1, 0], [t + 3, 4, 0, 0, 0, 0, 0],
            [t + 4, 0, 2, 0, 1, 0, 0], [t + 5, 0, 0, 6, 0, 1, 0]]
    return {"gauges": list(_RING_GAUGES), "rows": rows,
            "ticks_recorded": ticks_recorded}


def test_recorder_rings_fold_as_the_reference_does():
    evicted = _ring_payload(40, 51)
    spans = lineage.lineage_from_recorder(evicted)
    assert spans == ref_lineage.lineage_from_recorder(evicted)
    assert [s["truncated"] for s in spans] == [True, False]
    assert spans[0]["window_start"] is None
    assert all(v is None for v in spans[0]["durations"].values())
    assert (spans[1]["window_start"], spans[1]["decide_tick"]) == (42, 45)
    assert lineage.lineage_summary(spans)["truncated"] == 1
    full = _ring_payload(1, 6)
    spans = lineage.lineage_from_recorder(full)
    assert spans == ref_lineage.lineage_from_recorder(full)
    assert [s["truncated"] for s in spans] == [False, False]
    assert all(s["milestones"]["phase1a_tick"] is None for s in spans)
    assert lineage.lineage_from_recorder({"rows": []}) == []
    payload = golden.load(golden.RX_RECORDERS[0].path)["recorder"]
    assert lineage.lineage_from_recorder(payload) == \
        ref_lineage.lineage_from_recorder(payload)
    assert schema.validate_flight_recorder(payload) == []


def _synthetic_cols():
    t = 16
    cols = {f.name: np.zeros(t, np.int64)
            for f in dataclasses.fields(lineage.PhaseColumns)}
    cols["tick"] = np.arange(1, t + 1, dtype=np.int64)
    cols["announce"] = np.zeros(t, bool)
    cols["decide"] = np.zeros(t, bool)
    cols["alert_sent"][[0, 8]] = 3
    cols["alert_delivered"][[1, 9]] = 2
    cols["announce"][[2, 10]] = True
    cols["fast_vote_sent"][[3, 11]] = 5
    cols["decide"][4] = True
    cols["timers_armed"][11] = 1
    cols["phase1a_sent"][12] = 4
    cols["phase1b_sent"][13] = 3
    cols["phase2a_sent"][14] = 4
    cols["phase2b_sent"][15] = 3
    cols["decide"][15] = True
    return cols


def _slice(cols, lo, hi):
    return lineage.PhaseColumns(**{k: v[lo:hi] for k, v in cols.items()})


def test_lineage_fold_is_chunk_split_invariant_and_survives_json():
    raw = _synthetic_cols()
    cols = lineage.PhaseColumns(**raw)
    whole = lineage.fold_spans(cols, start_tick=0)
    assert whole == ref_lineage.fold_spans(
        ref_lineage.PhaseColumns(**raw), start_tick=0)
    assert [s["fallback"] for s in whole] == [False, True]
    assert sum(whole[1]["durations"].values()) == 11
    for step_ in (1, 2, 3, 5, 7, 16):
        fold = lineage.LineageFold(0)
        spans = []
        for lo in range(0, 16, step_):
            spans += fold.fold_columns(_slice(raw, lo, lo + step_))
        assert spans == whole, step_
    for cut in (3, 6, 12):
        fold = lineage.LineageFold(0)
        spans = fold.fold_columns(_slice(raw, 0, cut))
        blob = json.loads(json.dumps(fold.state_dict()))
        resumed = lineage.LineageFold.from_state(blob)
        spans += resumed.fold_columns(_slice(raw, cut, 16))
        assert spans == whole, cut
    with pytest.raises(ValueError, match="member"):
        lineage.fold_spans(lineage.PhaseColumns(
            **{k: np.stack([v, v]) for k, v in raw.items()}))


def test_lineage_constants_equal_the_reference_and_the_schema():
    assert lineage.LINEAGE_DURATIONS == ref_lineage.LINEAGE_DURATIONS
    assert lineage.LINEAGE_MILESTONES == ref_lineage.LINEAGE_MILESTONES
    assert tuple(schema.LINEAGE_DURATION_NAMES) == lineage.LINEAGE_DURATIONS
    assert tuple(schema.LINEAGE_MILESTONE_NAMES) == \
        lineage.LINEAGE_MILESTONES
    assert schema.LINEAGE_SPAN_SPEC == ref_schema.LINEAGE_SPAN_SPEC


def test_delay_of_slots_equals_the_reference():
    rules = (faults.DelayRule(src_slots=frozenset({0, 1, 2}),
                              dst_slots=frozenset({3, 4}), delay_ticks=1,
                              jitter_ticks=2, reverse_delay_ticks=0,
                              start_tick=2, end_tick=40),)
    ref_rules = tuple(ref_faults.DelayRule(**vars(r)) for r in rules)
    for src in range(6):
        for dst in range(6):
            for tick in (0, 2, 17, 39, 40):
                assert faults.delay_of_slots(rules, 9, src, dst, tick) == \
                    ref_faults.delay_of_slots(ref_rules, 9, src, dst, tick)
