"""The port's program spans (``telemetry.trace.span``) on the CPU.

Off (the default), a span is the shared null context and records
nothing. On, a shared fleet (F=2, N=64: a crash pair and the contested
split vote) and a per-receiver fleet (F=2, N=64, one-way ingress
partitions) give bit-identical outputs to the same runs with spans off;
a dispatch records one ``rapid.fleet.host``, one ``rapid.fleet.tick`` a
tick with the step's phases nested under it, and one ``rapid.read`` per
count of ``device.host_reads``. Under ``torch.profiler`` each span
agrees with the profiler's own event of its name within 1 ms, and
``wall_span`` still writes its slice to a ``TraceWriter``.
"""
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rapid_tpu_torch import device, faults
from rapid_tpu_torch.engine import fleet
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry import trace

N, F, TICKS = 64, 2, 24

SHARED_PHASES = ("rapid.step.chain", "rapid.step.decide",
                 "rapid.step.late1a", "rapid.step.deliver",
                 "rapid.step.flush", "rapid.step.churn",
                 "rapid.step.monitor", "rapid.step.task", "rapid.step.log")


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def spans_on():
    """Spans on for the test, an empty record before and after."""
    trace.take_spans()
    record = trace.enable_spans()
    try:
        yield record
    finally:
        trace.disable_spans()
        trace.take_spans()


def _shared_fleet():
    settings = Settings()
    schedules = [
        faults.AdversarySchedule(n=N, crashes=((3, 5), (7, 5)), seed=1),
        faults.AdversarySchedule(n=N, proposes=tuple(
            faults.ScriptedPropose(slot=i, tick=5,
                                   proposal=(0,) if i % 2 else (1,),
                                   delay_ticks=4 + i % 3)
            for i in range(N)), seed=2)]
    return settings, fleet.stack_members(
        [fleet.lower_schedule(s, settings, device="cpu") for s in schedules])


def _receiver_fleet():
    settings = Settings(rx_kernel="xla")
    schedules = [faults.AdversarySchedule(n=N, windows=(faults.LinkWindow(
        src_slots=frozenset(range(N)), dst_slots=frozenset({1 + m, 9}),
        start_tick=5),), seed=3 + m) for m in range(F)]
    return settings, fleet.stack_receiver_members(
        [fleet.lower_receiver_schedule(s, settings, fleet_size=F,
                                       device="cpu") for s in schedules])


def _dispatch(engine):
    if engine == "shared":
        settings, stacked = _shared_fleet()
        return lambda: fleet.fleet_simulate(stacked, TICKS, settings,
                                            device="cpu")
    settings, stacked = _receiver_fleet()
    return lambda: fleet.receiver_fleet_simulate(stacked, TICKS, settings,
                                                 device="cpu")


def _children(spans, parent):
    return [s for s in spans if s[3] == parent]


def test_off_records_nothing():
    trace.disable_spans()
    trace.take_spans()
    ctx = trace.span("rapid.test")
    assert ctx is trace.span("rapid.other")
    with ctx:
        device.read_host(torch.tensor(1))
    assert trace.take_spans() == []


@pytest.mark.parametrize("engine", ["shared", "receiver"])
def test_spans_change_no_output(engine):
    run = _dispatch(engine)
    trace.disable_spans()
    off = run()
    trace.enable_spans()
    try:
        on = run()
    finally:
        trace.disable_spans()
        trace.take_spans()
    for a, b in zip(torch.utils._pytree.tree_leaves(off),
                    torch.utils._pytree.tree_leaves(on)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("engine", ["shared", "receiver"])
def test_one_host_and_one_tick_span_a_tick(engine, spans_on):
    run = _dispatch(engine)
    trace.take_spans()
    reads = device.host_reads
    run()
    reads = device.host_reads - reads
    spans = trace.take_spans()
    names = Counter(s[0] for s in spans)
    assert names["rapid.fleet.dispatch"] == 1
    assert names["rapid.fleet.host"] == 1
    assert names["rapid.fleet.tick"] == TICKS
    assert names["rapid.read"] == reads > 0
    assert all(s[0].startswith("rapid.") and s[1] <= s[2] for s in spans)
    dispatch = [i for i, s in enumerate(spans)
                if s[0] == "rapid.fleet.dispatch"][0]
    assert spans[dispatch][3] == -1
    ticks = [i for i, s in enumerate(spans) if s[0] == "rapid.fleet.tick"]
    for i in ticks:
        inner = _children(spans, i)
        lo, hi = spans[i][1], spans[i][2]
        assert all(lo <= s[1] <= s[2] <= hi for s in inner)
        if engine == "shared":
            phases = [s[0] for s in inner if s[0] != "rapid.read"]
            assert tuple(phases) == SHARED_PHASES
        else:
            assert [s[0] for s in inner][0] == "rapid.rx.deliver"
            assert {"rapid.rx.p1b", "rapid.rx.vote", "rapid.rx.batch",
                    "rapid.rx.finalize"} <= {s[0] for s in inner}
    if engine == "receiver":
        match = [s for s in spans if s[0] == "rapid.rx.match"]
        assert len(match) == 2 * TICKS
        assert {spans[s[3]][0] for s in match} == {"rapid.rx.p1b",
                                                   "rapid.rx.vote"}


def test_spans_agree_with_the_profiler(spans_on):
    run = _dispatch("shared")
    trace.take_spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = trace.take_spans()
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("rapid."):
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    ours = {}
    for name, start, end, _ in spans:
        ours.setdefault(name, []).append((start, end))
    assert set(ours) == set(events)
    for name, got in ours.items():
        want = events[name]
        assert len(got) == len(want), name
        for (s0, e0), (s1, e1) in zip(sorted(got), sorted(want)):
            assert abs(s0 - s1) < 1_000_000 and abs(e0 - e1) < 1_000_000


def test_wall_span_writes_its_slice(spans_on):
    writer = trace.TraceWriter()
    with trace.wall_span(writer, "execute", {"clusters": 2}):
        device.read_host(torch.tensor(3))
    with trace.wall_span(None, "fold"):
        pass
    events = writer.to_json()["traceEvents"]
    begin = [e for e in events if e["ph"] == "B"]
    end = [e for e in events if e["ph"] == "E"]
    assert [e["name"] for e in begin] == ["execute"]
    assert begin[0]["args"] == {"clusters": 2}
    assert begin[0]["pid"] == trace.WALL_PID and len(end) == 1
    assert end[0]["ts"] > begin[0]["ts"] >= 0
    spans = trace.take_spans()
    assert [s[0] for s in spans] == ["rapid.execute", "rapid.read",
                                     "rapid.fold"]
    assert spans[1][3] == 0 and spans[2][3] == -1
    us = (spans[0][2] - spans[0][1]) // 1000
    assert abs((end[0]["ts"] - begin[0]["ts"]) - us) <= 1
