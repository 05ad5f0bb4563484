"""The readings of the program's spans (``portbench/spans.py``) on
synthetic records, the annotations ``record_function`` leaves on the
CUDA timeline kept out of the device's work, and a traced run of each
tiny cell on the CPU with spans on (``span_run.py``)."""
import pytest
import torch

from conftest import tiny
from portbench import profiling, spans
from portbench.metrics import device_idle_pct, kernels_per_tick

MS = 1_000_000


def _spans():
    """A dispatch with its host state and two ticks, each with a read;
    the second tick's read holds a nested span."""
    return [
        ("rapid.fleet.dispatch", 0, 100 * MS, -1),      # 0
        ("rapid.fleet.host", 1 * MS, 21 * MS, 0),       # 1
        ("rapid.read", 2 * MS, 20 * MS, 1),             # 2
        ("rapid.fleet.tick", 30 * MS, 50 * MS, 0),      # 3
        ("rapid.step.decide", 31 * MS, 45 * MS, 3),     # 4
        ("rapid.read", 40 * MS, 44 * MS, 4),            # 5
        ("rapid.fleet.tick", 60 * MS, 90 * MS, 0),      # 6
        ("rapid.rx.match", 61 * MS, 70 * MS, 6),        # 7
        ("rapid.read", 75 * MS, 85 * MS, 6),            # 8
    ]


def _rec(spans_=None, device=(), owner=()):
    return {"members": 4,
            "setup_spans": [("rapid.lower.proposes", 0, 3 * MS, -1),
                            ("rapid.lower.boot", 3 * MS, 4 * MS, -1),
                            ("rapid.lower.proposes", 4 * MS, 9 * MS, -1)],
            "profile": {"start_ns": 0, "end_ns": 100 * MS,
                        "device": list(device), "host": [],
                        "spans": _spans() if spans_ is None else spans_,
                        "device_span": list(owner), "ticks": 2}}


def test_readings_of_a_synthetic_record():
    device = [("k", 62 * MS, 4 * MS, "kernel"),     # under rx.match
              ("k", 64 * MS, 4 * MS, "kernel"),     # overlaps it
              ("k", 71 * MS, 8 * MS, "kernel")]     # under the tick only
    rec = _rec(device=device, owner=[7, 7, 6])
    got = {name: read(rec) for name, read in spans.READINGS.items()}
    assert got["fleet_host_ms_per_dispatch"] == pytest.approx(20.0)
    assert got["read_wait_ms_per_tick"] == pytest.approx((4 + 10) / 2)
    assert got["tick_host_ms_per_tick"] == pytest.approx(
        ((20 - 4) + (30 - 10)) / 2)
    # 6 ms of the union under the match, over 14 busy ms
    assert got["rx_match_busy_pct"] == pytest.approx(100 * 6 / 14)
    assert got["lower_proposes_ms_per_member"] == pytest.approx(8 / 4)


def test_readings_without_spans_are_none():
    rec = _rec(spans_=[], device=[("k", 0, MS, "kernel")], owner=[-1])
    rec["setup_spans"] = []
    assert all(read(rec) is None for read in spans.READINGS.values())
    # a profile from a program without spans at all
    assert all(read({"members": 4, "profile": {"start_ns": 0,
                                               "end_ns": MS}}) is None
               for read in spans.READINGS.values())


def test_innermost_open_span():
    s = _spans()
    times = [-1, 0, 2 * MS, 21 * MS, 41 * MS, 65 * MS, 72 * MS, 95 * MS,
             200 * MS]
    assert spans.innermost(s, times) == [-1, 0, 2, 0, 5, 7, 6, 0, -1]
    assert spans.innermost([("a", 0, None, -1)], [5]) == [0]


def test_idle_time_goes_to_the_innermost_open_span():
    device = [("k", 0, 41 * MS, "kernel"),       # gap 41-62
              ("k", 62 * MS, 30 * MS, "kernel")]  # gap 92-100
    record = _rec(device=device, owner=[0, 7])["profile"]
    got = dict(spans.idle_by_span(record))
    # 41-44 in the read, 44-45 in decide, 45-50 in the tick, 50-60 in
    # the dispatch, 60-61 in the tick, 61-62 in the match; 92-100 in
    # the dispatch
    assert got == pytest.approx({
        "rapid.read": 0.003, "rapid.step.decide": 0.001,
        "rapid.fleet.tick": 0.006, "rapid.fleet.dispatch": 0.018,
        "rapid.rx.match": 0.001})
    assert sum(got.values()) == pytest.approx(0.029)
    record["spans"] = []
    assert spans.idle_by_span(record) == [["none", pytest.approx(0.029)]]


class _Event:
    def __init__(self, name, dtype, start, dur, annotation=False, corr=0,
                 linked=0):
        self._v = (name, dtype, start, dur, annotation, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]


def _events(annotations: bool):
    cpu, cuda = "DeviceType.CPU", "DeviceType.CUDA"
    ev = [_Event(profiling.SPAN, cpu, 0, 100 * MS, True, 1),
          _Event("aten::add", cpu, 62 * MS, MS, corr=5),
          _Event("cudaLaunchKernel", cpu, 62 * MS + 10, 50, corr=900,
                 linked=5),
          _Event("add_kernel", cuda, 63 * MS, 2 * MS, corr=900, linked=5),
          _Event("aten::mul", cpu, 71 * MS, MS, corr=6),
          _Event("mul_kernel", cuda, 72 * MS, 3 * MS, corr=0, linked=6),
          _Event("Memcpy DtoH", cuda, 80 * MS, MS, corr=901, linked=0)]
    if annotations:
        ev += [_Event(profiling.SPAN, cuda, 63 * MS, 18 * MS, True),
               _Event("rapid.rx.match", cuda, 63 * MS, 2 * MS, True),
               _Event("rapid.fleet.tick", cuda, 63 * MS, 12 * MS, True)]
    return ev


def test_annotations_on_the_cuda_timeline_are_no_work():
    plain = spans.record_of(_events(False), _spans())
    marked = spans.record_of(_events(True), _spans())
    assert marked["device"] == plain["device"]
    assert len(plain["device"]) == 3
    for rec in (plain, marked):
        rec["ticks"] = 2
    for reader in (kernels_per_tick, device_idle_pct):
        assert reader.read({"profile": marked}) == \
            reader.read({"profile": plain})
    # launches found by the runtime call, then by the linked op
    assert plain["device_span"] == [7, 6, -1]
    assert [h[0] for h in plain["host"]] == ["aten::add", "aten::mul"]


@pytest.mark.parametrize("engine", ["shared", "receiver"])
def test_traced_run_with_spans_on_the_cpu(engine):
    from portbench import run, span_run
    from rapid_tpu_torch.telemetry import trace

    workload, config, traffic = tiny(engine)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    res = span_run.run_with_spans(workload, config, traffic, 2**31 + 5,
                                  0.1, True, torch.device("cpu"), bench,
                                  start=0.0)
    assert res["correct"] is True
    got = res["spans"]
    assert got["span_counts"]["rapid.fleet.tick"] == config["scenario_ticks"]
    assert got["span_counts"]["rapid.fleet.dispatch"] == 1
    assert got["fleet_host_ms_per_dispatch"] > 0
    assert got["tick_host_ms_per_tick"] > 0
    if engine == "shared":
        assert got["read_wait_ms_per_tick"] > 0
        assert got["lower_proposes_ms_per_member"] > 0
        assert got["rx_match_busy_pct"] is None
    else:
        # the dense fleet loop reads only its start tick, in its host span
        assert got["read_wait_ms_per_tick"] == 0
        assert got["lower_proposes_ms_per_member"] is None
        assert got["span_counts"]["rapid.rx.match"] == \
            2 * config["scenario_ticks"]
    assert trace.take_spans() == []
    assert trace.span("rapid.x") is trace.span("rapid.y")    # spans off
