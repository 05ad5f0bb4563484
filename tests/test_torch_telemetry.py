"""The port's telemetry folds against the reference's.

The same runs through both packages, each folded by its own telemetry:

- the shared engine's N=64 crash burst (slots 3 and 17 at tick 5, 130
  ticks, the run of ``tests/test_telemetry.py``), a contested N=64 run
  (the two-way vote split, 30 ticks) and the trace scenario of
  ``tests/test_telemetry.py`` (N=16, slot 2 crashing at tick 3): equal
  ``TickMetrics`` rows, ``RunSummary`` blocks, JSONL bytes and Perfetto
  JSON (the wall-clock track's times dropped);
- the per-receiver engine at N=16 (``crash_window_delay_schedule``):
  ``receiver_run_payload(...).metrics()`` equal to the reference's;
- a shared fleet of three N=16 members: ``fleet_summaries``,
  ``merge_summaries`` and ``summary_distributions``;
- the SLO windows and both view-change folds fed the same streams in
  chunks, and their states through JSON;
- the validators, on the port's payloads and on the malformed ones the
  reference rejects; the schema's constants.

``testdata/telemetry_golden.json`` holds the reference's folds of the
runs other golden files hold (``golden.telemetry_record``); it is
regenerated from the reference here (the two fleet pools run the
reference at F=256 and are ``slow``), and the port's folds of the same
inputs equal it. Regenerate with ``PYTHONPATH=. JAX_PLATFORMS=cpu python
tests/test_torch_telemetry.py``. Tolerance: exact.
"""
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
from rapid_tpu.telemetry import slo as ref_slo
from rapid_tpu.telemetry import trace as ref_trace

from rapid_tpu_torch import campaign, faults, golden, variants
from rapid_tpu_torch.convert import from_reference
from rapid_tpu_torch.engine import fleet, receiver, step
from rapid_tpu_torch.engine.state import I32_MAX
from rapid_tpu_torch.identity import default_identities
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry import (json_artifact_line, lineage, metrics,
                                       schema, slo, trace,
                                       write_json_artifact,
                                       write_jsonl_artifact)

ref_simulate = importlib.import_module("rapid_tpu.engine.step").simulate


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _crash_boot(n, crashes, uids=None):
    if uids is None:
        uids, id_fp_sum = default_identities(n)
    else:
        id_fp_sum = 0
    crash = [I32_MAX] * n
    for slot, tick in crashes.items():
        crash[slot] = tick
    return (ref_init_state(uids, id_fp_sum, RefSettings()),
            ref_crash_faults(crash), None)


def _contested_boot(n):
    from rapid_tpu.engine.diff import default_endpoints, default_node_ids
    from rapid_tpu.oracle.membership_view import MembershipView, uid_of

    settings = RefSettings()
    uids = np.asarray([uid_of(e) for e in default_endpoints(n)], np.uint64)
    sched, _ = ref_paxos.plan_fallback(
        n, [[0], [1]], {s: (6, s % 2) for s in range(n)},
        {s: (10 if s == 0 else 100) for s in range(n)}, settings,
        uids=uids)
    id_fp_sum = MembershipView(settings.K, default_node_ids(n),
                               [])._id_fp_sum
    return (ref_init_state(uids, id_fp_sum, settings),
            ref_crash_faults([I32_MAX] * n), sched)


def _trace_uids(n):
    from rapid_tpu.oracle.membership_view import uid_of
    from rapid_tpu.types import Endpoint

    return [uid_of(Endpoint(f"n{i}.sim", 5000)) for i in range(n)]


#: name -> (boot, ticks): the shared runs both packages fold.
SHARED_RUNS = {
    "crash_n64": (lambda: _crash_boot(64, {3: 5, 17: 5}), 130),
    "contested_n64": (lambda: _contested_boot(64), 30),
    "trace_n16": (lambda: _crash_boot(16, {2: 3}, _trace_uids(16)), 130),
}


@pytest.fixture(scope="module", params=sorted(SHARED_RUNS))
def shared_runs(request):
    boot, ticks = SHARED_RUNS[request.param]
    state, faults_, sched = boot()
    kw = {} if sched is None else {"fallback": sched}
    _, want = ref_simulate(state, faults_, ticks, RefSettings(), **kw)
    port_kw = ({} if sched is None
               else {"fallback": from_reference(sched, device="cpu")})
    _, got = step.simulate(from_reference(state, device="cpu"),
                           from_reference(faults_, device="cpu"), ticks,
                           Settings(), device="cpu", **port_kw)
    return request.param, want, got


def test_engine_metrics_and_summary_equal_the_reference(shared_runs):
    name, want_logs, logs = shared_runs
    want = ref_metrics.engine_metrics(want_logs)
    got = metrics.engine_metrics(logs)
    assert [m.as_dict() for m in got] == [m.as_dict() for m in want]
    assert all(metrics.counters_equal(a, a) for a in got)
    got_sum = metrics.summarize(got).as_dict()
    assert got_sum == ref_metrics.summarize(want).as_dict()
    assert schema.validate_telemetry(got_sum) == []
    if name == "crash_n64":
        assert (got_sum["ticks_to_first_announce"],
                got_sum["ticks_to_first_decide"]) == (112, 113)
    if name == "contested_n64":
        assert got_sum["fallback_phase_sent"]["phase1a"] > 0


def test_tick_metrics_jsonl_equals_the_reference(shared_runs, tmp_path):
    _, want_logs, logs = shared_runs
    rows = metrics.engine_metrics(logs)
    metrics.write_jsonl(rows, tmp_path / "port.jsonl")
    ref_metrics.write_jsonl(ref_metrics.engine_metrics(want_logs),
                            tmp_path / "ref.jsonl")
    raw = (tmp_path / "port.jsonl").read_bytes()
    assert raw == (tmp_path / "ref.jsonl").read_bytes()
    assert metrics.read_jsonl(tmp_path / "port.jsonl") == rows
    assert set(json.loads(raw.splitlines()[0])) == \
        set(metrics.TickMetrics(0, "engine").as_dict())


def _without_wall_times(payload):
    return [dict(e, ts=None) if e["pid"] == trace.WALL_PID else e
            for e in payload["traceEvents"]]


def _paired_b_e(events):
    stacks = {}
    for e in events:
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            stacks.setdefault(key, []).append(e)
        elif e["ph"] == "E":
            if not stacks.get(key):
                return False
            stacks[key].pop()
    return all(not s for s in stacks.values())


def test_perfetto_trace_equals_the_reference(shared_runs, tmp_path):
    name, want_logs, logs = shared_runs
    writer = trace.TraceWriter()
    with trace.wall_span(writer, "device_dispatch", {"run": name}):
        pass
    trace.trace_from_logs(logs, Settings(), writer=writer)
    writer.write(tmp_path / "port.json")
    ref_writer = ref_trace.TraceWriter()
    with ref_trace.wall_span(ref_writer, "device_dispatch", {"run": name}):
        pass
    ref_trace.trace_from_logs(want_logs, RefSettings(), writer=ref_writer)
    got = json.loads((tmp_path / "port.json").read_text())
    assert (tmp_path / "port.json").read_bytes().endswith(b"}\n")
    want = ref_writer.to_json()
    assert _without_wall_times(got) == _without_wall_times(want)
    events = got["traceEvents"]
    assert [e["ts"] for e in events] == sorted(e["ts"] for e in events)
    assert _paired_b_e(events)
    names = {e["name"] for e in events if e["ph"] in ("B", "i")}
    if name != "contested_n64":
        assert {"deliver", "flush", "monitor", "proposal", "view_change",
                "proposal 0"} <= names
    else:
        assert {"decide", "monitor", "fallback", "phase1a",
                "phase2b"} <= names


def test_receiver_metrics_equal_the_reference():
    sched = faults.crash_window_delay_schedule(16)
    ticks = 160
    ref_sched = golden.schedule_from_json(golden.schedule_json(sched),
                                          ref_faults)
    member = ref_fleet.lower_receiver_schedule(ref_sched, RefSettings())
    want_final, want_logs = ref_rx.receiver_simulate(
        member.state, member.faults, ticks, RefSettings())
    want = ref_rx.receiver_run_payload(want_final, want_logs, 16,
                                       ticks).metrics()
    pmember = receiver.lower_receiver_schedule(sched, Settings(),
                                               device="cpu")
    final, logs = receiver.receiver_simulate(pmember.state, pmember.faults,
                                             ticks, Settings())
    got = receiver.receiver_run_payload(final, logs, 16, ticks).metrics()
    assert [m.as_dict() for m in got] == [m.as_dict() for m in want]
    assert metrics.summarize(got).as_dict() == \
        ref_metrics.summarize(want).as_dict()
    assert metrics.summarize(got).decisions >= 1

    # The per-slot view-change fold over the same log, in chunks of 40.
    ref_fold = ref_slo.ReceiverViewChangeFold(16)
    fold = slo.ReceiverViewChangeFold(16)
    for lo in range(0, ticks, 40):
        sl = slice(lo, lo + 40)
        want_s = ref_fold.fold(np.asarray(want_logs.tick)[sl],
                               np.asarray(want_logs.announce)[sl],
                               np.asarray(want_logs.decide)[sl])
        got_s = fold.fold(logs.tick[sl], logs.announce[sl], logs.decide[sl])
        assert got_s == want_s
        blob = json.loads(json.dumps(fold.state_dict()))
        assert blob == ref_fold.state_dict()
        fold = slo.ReceiverViewChangeFold.from_state(blob)


def _fleet_schedules(pkg):
    return [pkg.random_adversary_schedule(16, seed, 60)
            for seed in (1, 2, 3)]


def test_fleet_folds_equal_the_reference():
    ticks = 60
    ref_settings = RefSettings()
    _, want_logs = ref_fleet.fleet_simulate(ref_fleet.stack_members(
        [ref_fleet.lower_schedule(s, ref_settings)
         for s in _fleet_schedules(ref_faults)]), ticks, ref_settings)
    _, logs = fleet.fleet_simulate(fleet.stack_members(
        [fleet.lower_schedule(s, Settings(), device="cpu")
         for s in _fleet_schedules(faults)]), ticks, Settings(),
        device="cpu")
    want = ref_metrics.fleet_summaries(want_logs)
    got = metrics.fleet_summaries(logs)
    assert [s.as_dict() for s in got] == [s.as_dict() for s in want]
    assert metrics.merge_summaries(got).as_dict() == \
        ref_metrics.merge_summaries(want).as_dict()
    assert metrics.summary_distributions(got) == \
        ref_metrics.summary_distributions(want)
    assert metrics.regime_distributions({"a": [3, 1, 2], "b": []}) == \
        ref_metrics.regime_distributions({"a": [3, 1, 2], "b": []})
    with pytest.raises(ValueError, match="empty fleet"):
        metrics.merge_summaries([])


def test_slo_windows_and_view_change_fold_equal_the_reference(shared_runs):
    _, want_logs, logs = shared_runs
    rows = metrics.engine_metrics(logs)
    ref_rows = ref_metrics.engine_metrics(want_logs)
    windows, ref_windows = slo.SloWindows(3), ref_slo.SloWindows(3)
    fold, ref_fold = slo.ViewChangeFold(), ref_slo.ViewChangeFold()
    for lo in range(0, len(rows), 17):
        samples = fold.fold(rows[lo:lo + 17])
        assert samples == ref_fold.fold(ref_rows[lo:lo + 17])
        block = windows.fold_chunk(samples)
        assert block == ref_windows.fold_chunk(samples)
        assert schema.validate_slo_window(block) == []
        fold = slo.ViewChangeFold.from_state(
            json.loads(json.dumps(fold.state_dict())))
        windows = slo.SloWindows.from_state(
            json.loads(json.dumps(windows.state_dict())))
    assert windows.state_dict() == ref_windows.state_dict()
    assert fold.state_dict() == ref_fold.state_dict()
    with pytest.raises(ValueError, match="window_chunks"):
        slo.SloWindows(0)


def test_artifact_writers_terminate_with_newline(tmp_path):
    line = json_artifact_line({"b": 1, "a": 2}, sort_keys=True)
    assert line.endswith("\n") and not line[:-1].endswith("\n")
    assert line.index('"a"') < line.index('"b"')
    path = tmp_path / "artifact.json"
    write_json_artifact(path, {"x": [1, 2]}, indent=2)
    raw = path.read_bytes()
    assert raw.endswith(b"\n") and not raw.endswith(b"\n\n")
    assert json.loads(raw) == {"x": [1, 2]}
    jsonl = tmp_path / "records.jsonl"
    write_jsonl_artifact(jsonl, ({"i": i} for i in range(3)))
    assert [json.loads(x) for x in jsonl.read_bytes().splitlines()] == \
        [{"i": 0}, {"i": 1}, {"i": 2}]
    write_jsonl_artifact(tmp_path / "empty.jsonl", [])
    assert (tmp_path / "empty.jsonl").read_bytes() == b""


def _good_payload():
    return {"bench": "engine_tick", "n": 64, "ticks": 20, "wall_s": 0.1,
            "schema_version": schema.SCHEMA_VERSION,
            "ticks_per_sec": 200.0, "rounds_per_sec": 40.0,
            "telemetry": metrics.summarize([]).as_dict()}


def test_validators_accept_the_port_payloads(shared_runs):
    _, _, logs = shared_runs
    summary = metrics.summarize(metrics.engine_metrics(logs)).as_dict()
    payload = dict(_good_payload(), telemetry=summary)
    assert schema.validate_bench_payload(payload) == []
    assert schema.validate_run_payload(payload) == []
    assert schema.validate_bench_payload(
        {"schema_version": schema.SCHEMA_VERSION,
         "sweep": [payload, payload]}) == []
    spans = lineage.fold_spans(lineage.engine_phase_columns(logs))
    for sp in spans:
        assert schema.validate_lineage_span(sp) == []
    assert schema.validate_lineage_summary(
        lineage.lineage_summary(spans)) == []


def test_validators_reject_what_the_reference_rejects():
    good = _good_payload()
    assert schema.validate_bench_payload(good) == \
        ref_schema.validate_bench_payload(good) == []
    cases = []
    bad = dict(good)
    bad.pop("telemetry")
    cases.append((bad, "telemetry"))
    cases.append((dict(good, telemetry=dict(good["telemetry"],
                                            decisions="three")),
                  "decisions"))
    cases.append(({"bench": "engine_tick_suite",
                   "schema_version": schema.SCHEMA_VERSION,
                   "steady": good}, "churn"))
    cases.append(({k: v for k, v in good.items()
                   if k != "schema_version"}, "schema_version"))
    cases.append((dict(good, schema_version=schema.SCHEMA_VERSION + 1),
                  "schema_version"))
    cases.append((dict(good, schema_version="1"), "schema_version"))
    for payload, word in cases:
        got = schema.validate_bench_payload(payload)
        assert got == ref_schema.validate_bench_payload(payload)
        assert any(word in e for e in got), (word, got)
    assert schema.validate_bench_payload([]) == ["payload: expected a "
                                                 "JSON object"]
    rec = {"window": 2, "gauges": ["a", "b"], "ticks_recorded": 3,
           "rows": [[1, 2], [3], [4, 5]], "stamps": {"first_announce": 1}}
    assert schema.validate_flight_recorder(rec) == \
        ref_schema.validate_flight_recorder(rec)
    assert len(schema.validate_flight_recorder(rec)) == 5
    block = slo.SloWindows(2).fold_chunk({"decide_latency": [3]})
    block["metrics"]["decide_latency"]["count"] = 7
    block["metrics"]["bogus"] = {}
    assert schema.validate_slo_window(block) == \
        ref_schema.validate_slo_window(block) != []
    campaign = dict(good, campaign={})
    assert schema.validate_run_payload(campaign) == \
        ref_schema.validate_run_payload(campaign) != []
    # Streaming payloads validate since the service was ported (they
    # raised NotImplementedError before): the same verdict as the
    # reference's on a run without the streaming fields.
    streaming = dict(good, scenario="streaming")
    assert schema.validate_run_payload(streaming) == \
        ref_schema.validate_run_payload(streaming) != []


def test_schema_constants_equal_the_reference():
    for name in ("SCHEMA_VERSION", "GAUGE_SEMANTICS", "TELEMETRY_SPEC",
                 "VIEW_CHANGE_SPEC", "RUN_SPEC", "FALLBACK_PHASES",
                 "RECORDER_STAMPS", "FLIGHT_RECORDER_SPEC",
                 "DISTRIBUTION_SPEC", "LINEAGE_DURATION_NAMES",
                 "LINEAGE_MILESTONE_NAMES", "LINEAGE_SPAN_SPEC",
                 "LINEAGE_CRITICAL_PATH_SPEC", "LINEAGE_SUMMARY_SPEC",
                 "SLO_METRIC_NAMES", "SLO_METRIC_SPEC", "SLO_WINDOW_SPEC",
                 "PROTOCOL_VARIANTS", "CAMPAIGN_SPEC", "TRIAGE_CLASSES",
                 "TRIAGE_SPEC", "TRIAGE_CLASS_SPEC", "TRIAGE_EXEMPLAR_SPEC",
                 "TRIAGE_EXPECTED_SPEC", "CAMPAIGN_POOL_SPEC",
                 "TOURNAMENT_SPEC", "TOURNAMENT_VARIANT_SPEC",
                 "DELAY_REGIMES", "PER_RECEIVER_SPEC", "SPOT_CHECK_SPEC",
                 "SPOT_MEMBER_SPEC", "CAMPAIGN_DISTRIBUTIONS",
                 "CAMPAIGN_LINEAGE_SPEC", "DISPATCH_STAGES",
                 "DISPATCH_RECORD_SPEC", "DISPATCH_PADDING_SPEC",
                 "DISPATCH_MEMORY_SPEC", "AOT_COMPILE_SPEC",
                 "OBSERVATORY_SPEC", "PIPELINE_SPEC",
                 "PROGRESS_DISPATCH_SPEC", "STAGE_SUM_TOLERANCE",
                 "TRAFFIC_CONFIG_SPEC", "STREAM_TRAFFIC_INFO_SPEC",
                 "STREAM_CHECKPOINT_SPEC", "STREAM_CHUNK_SPEC",
                 "STREAM_WATERMARK_SPEC", "STREAM_SUMMARY_SPEC",
                 "SERVO_CONFIG_SPEC", "SERVO_CHUNK_SPEC",
                 "STATUS_SNAPSHOT_SPEC", "LOAD_SWEEP_RATE_SPEC",
                 "LOAD_SWEEP_KNEE_SPEC", "LOAD_SWEEP_SPEC",
                 "CHECKPOINT_MANIFEST_SPEC", "CHECKPOINT_LEAF_SPEC",
                 "STREAMING_RUN_SPEC"):
        assert getattr(schema, name) == getattr(ref_schema, name), name
    assert set(schema.GAUGE_SEMANTICS) | {"source", "n_ticks",
                                           "messages_per_view_change",
                                           "view_changes"} == \
        set(schema.TELEMETRY_SPEC)
    assert slo.DEFAULT_BUCKET_EDGES == ref_slo.DEFAULT_BUCKET_EDGES
    assert metrics.COUNTER_FIELDS == ref_metrics.COUNTER_FIELDS
    assert schema.PROTOCOL_VARIANTS == variants.VARIANTS
    assert schema.TRIAGE_CLASSES == campaign.TRIAGE_CLASSES


# ---------------------------------------------------------------------------
# testdata/telemetry_golden.json
# ---------------------------------------------------------------------------

RECORDER_ENTRY = "rx_n1024_recorder"
ENTRIES = (golden.TELEMETRY_SHARED + (RECORDER_ENTRY,)
           + tuple(f"fleet_pool{p}" for p in golden.TELEMETRY_POOLS))


def reference_folds():
    return golden.Folds(
        ref_metrics, ref_lineage, ref_schema,
        lambda final, log, n: ref_rx.receiver_run_payload(
            final, log, n, len(log.tick)).metrics(),
        lambda d: golden.schedule_from_json(d, ref_faults))


def telemetry_entry(name: str, folds, pool_run=None) -> dict:
    """Entry ``name`` of the telemetry file through ``folds``;
    ``pool_run(pool_id)`` gives a pool's ``(members, logs, finals)``."""
    if name in golden.TELEMETRY_SHARED:
        return golden.shared_telemetry(folds, golden.log_columns(
            golden.load(golden.SCENARIOS[name].path)))
    if name == RECORDER_ENTRY:
        return golden.recorder_telemetry(
            folds, golden.load(golden.RX_RECORDERS[-1].path)["recorder"])
    pool = golden.FLEET_POOLS[int(name[len("fleet_pool"):])]
    return golden.pool_telemetry(folds, pool, *pool_run(pool.pool_id))


def reference_pool(pool_id: int):
    from test_torch_fleet_golden import reference_pool_run

    members, logs, finals, _ = reference_pool_run(pool_id)
    return members, logs, finals


def _entry_params():
    return [pytest.param(name, marks=pytest.mark.slow)
            if name.startswith("fleet_pool") else name for name in ENTRIES]


@pytest.mark.parametrize("name", _entry_params())
def test_telemetry_golden_matches_reference(name):
    want = golden.load(golden.TELEMETRY_PATH)["entries"][name]
    got = json.loads(golden.dumps(telemetry_entry(name, reference_folds(),
                                                  reference_pool)))
    assert golden.differences(got, want) == []
    assert want["errors"] == []


@pytest.mark.parametrize("name", golden.TELEMETRY_SHARED + (RECORDER_ENTRY,))
def test_port_folds_equal_the_golden(name):
    want = golden.load(golden.TELEMETRY_PATH)["entries"][name]
    got = json.loads(golden.dumps(telemetry_entry(name,
                                                  golden.port_folds())))
    assert golden.differences(got, want) == []


@pytest.mark.parametrize("pool_id", golden.TELEMETRY_POOLS)
def test_port_pool_folds_equal_the_golden_members(pool_id):
    """The port's CPU run of a pool's first members folds to their
    entries (the merged blocks cover all 256 and are held on the card)."""
    head = 8
    pool = golden.FLEET_POOLS[pool_id]
    members = golden.pool_inputs(golden.load(pool.path), head)
    out = golden.run_pool(pool, members, device="cpu")
    finals = (None if pool.mode == "shared"
              else receiver.receiver_final_fields(out[0]))
    got = json.loads(golden.dumps(golden.pool_telemetry(
        golden.port_folds(), pool, members, out[1], finals)))
    want = golden.load(golden.TELEMETRY_PATH)["entries"][
        f"fleet_pool{pool_id}"]
    assert got["members"] == want["members"][:head]
    assert got["errors"] == []


def test_telemetry_golden_file_shape():
    rec = golden.load(golden.TELEMETRY_PATH)
    assert rec["schema_version"] == schema.SCHEMA_VERSION
    assert sorted(rec["entries"]) == sorted(ENTRIES)
    assert golden.TELEMETRY_PATH.read_text() == golden.dumps(rec)
    crash = rec["entries"]["shared_n100k_crash"]["summary"]
    assert (crash["decisions"], crash["ticks_to_first_decide"]) == (1, 113)
    assert rec["entries"][RECORDER_ENTRY]["lineage"]["spans"] >= 1
    for p in golden.TELEMETRY_POOLS:
        assert len(rec["entries"][f"fleet_pool{p}"]["members"]) == \
            golden.FLEET_CAMPAIGN["fleet_size"]


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(golden.Path(__file__).resolve().parent))
    folds = reference_folds()
    entries = {name: telemetry_entry(name, folds, reference_pool)
               for name in ENTRIES}
    golden.TELEMETRY_PATH.write_text(golden.dumps(
        golden.telemetry_record(entries)))
    print("wrote", golden.TELEMETRY_PATH,
          golden.TELEMETRY_PATH.stat().st_size, "bytes")
