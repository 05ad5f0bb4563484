"""The port's streaming service against the reference's.

The resident shared engine at ``benchmarks/soak.json``'s configuration
for its first chunks against the reference's and the committed file;
the resident receiver at the two-zone N=64 against the reference's under
both carries; the pinned load servo against ``stream_servo.json``; a
save and restore that resumes the traffic, servo, SLO windows and
lineage; the status file and socket; the CLI's three modes against the
reference's; and the seven streaming validators against the reference's
on its committed payloads and on broken copies.
"""
import copy
import json
import threading
import time

import pytest
import torch

from rapid_tpu import service as ref_service
from rapid_tpu.service import __main__ as ref_main
from rapid_tpu.telemetry import schema as ref_schema

from rapid_tpu_torch import golden
from rapid_tpu_torch.service import (ResidentEngine, StatusPublisher,
                                     read_status)
from rapid_tpu_torch.service import __main__ as port_main
from rapid_tpu_torch.engine.state import I32_MAX, crash_faults
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry import schema
from rapid_tpu_torch.telemetry.slo import SloWindows

from test_torch_service import RefService

CPU = "cpu"
ROOT = golden.TESTDATA.parents[1]


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _strip(rec):
    return {k: v for k, v in rec.items() if k not in golden.STREAM_WALL_KEYS}


def test_resident_engine_equals_reference_and_soak_json(tmp_path):
    """The soak's first chunks, with the round trip at chunk 2, equal the
    reference's run record for record, and ``soak.json``'s on its keys."""
    records = []
    for svc in (golden.PortService(CPU), RefService()):
        eng = golden.boot_soak(svc, sink=str(tmp_path / "s.jsonl"))
        golden.run_stream(eng, 4, 2, tmp_path / "ck")
        records.append(golden.stream_record(eng))
        eng.close()
        if isinstance(svc, golden.PortService):
            lines = (tmp_path / "s.jsonl").read_text().splitlines()
            assert schema.validate_streaming_stream(lines) == []
            assert ref_schema.validate_streaming_stream(lines) == []
    assert golden.differences(records[0], records[1]) == []
    assert golden.soak_errors(records[0]["chunks"]) == []
    assert records[0]["chunks"][2]["checkpoint"]["tick"] == 1024


def _receiver_stream(svc, layout, path):
    """The two-zone N=64 member in chunks of 16 with its round trip at
    chunk 6 (tick 96) and 56 decides at tick 128: ``(record, timing)``."""
    rc = golden.RX_CHECKPOINT
    settings = svc.Settings(rx_kernel=layout, flight_recorder_window=8)
    rx = svc.boot_resident_receiver(
        settings, rc["n"], seed=rc["seed"], horizon_ticks=rc["horizon"],
        chunk_ticks=rc["chunk"], slo=svc.SloWindows(8))
    golden.run_stream(rx, 9, 6, path)
    return golden.stream_record(rx), getattr(rx, "timing", None)


@pytest.fixture(scope="module")
def reference_receiver_stream(tmp_path_factory):
    """The reference's packed run (its layouts give equal records)."""
    return _receiver_stream(RefService(), "packed",
                            tmp_path_factory.mktemp("ref_rx") / "ck")[0]


@pytest.mark.parametrize("layout", ["packed", "xla"])
def test_resident_receiver_equals_reference(layout, tmp_path,
                                            reference_receiver_stream):
    """Every record of the port's resident receiver, under either carry,
    equals the reference's."""
    got, timing = _receiver_stream(golden.PortService(CPU), layout,
                                   tmp_path / "ck")
    assert golden.differences(got, reference_receiver_stream) == []
    assert got["summary"]["decisions"] == 56
    assert all(v for k, v in got["summary"]["checkpoint"].items()
               if k.endswith("identical"))
    assert [t["index"] for t in timing] == list(range(9))
    assert all(t["device_s"] is None and t["fence_s"] == 0.0
               for t in timing)


def test_pinned_servo_stream_equals_golden(tmp_path):
    """``--target-rate 40 --pinned-tps 1000`` at the soak's
    configuration: every record, servo blocks included, is the
    reference's."""
    got = golden.servo_stream_record(golden.PortService(CPU), tmp_path)
    assert golden.differences(got, golden.load(golden.SERVO_PATH)) == []
    servo = [c["servo"] for c in got["chunks"]]
    assert {s["rate_per_ktick"] for s in servo} == {40.0}
    assert {s["updates"] for s in servo} == {0}


def test_restore_resumes_traffic_servo_slo_and_lineage(tmp_path):
    """Saved after 3 chunks and restored, a pinned-servo stream with SLO
    windows continues equal to the uninterrupted one; the restored
    traffic, servo and SLO state is the saved one."""
    svc = golden.PortService(CPU)
    cfg = dict(golden.SOAK, chunk=256, slo_window=2)

    def boot():
        servo = svc.service.LoadServo(svc.service.ServoConfig(
            target_events_per_sec=60.0, pinned_ticks_per_sec=2000.0))
        return golden.boot_soak(svc, cfg, servo=servo, closed_loop=True)

    whole = boot()
    whole.run(5)
    eng = boot()
    eng.run(3)
    eng.save(str(tmp_path / "ck"))
    settings = golden.soak_settings(svc, cfg)
    back = ResidentEngine.restore(str(tmp_path / "ck"),
                                  crash_faults([I32_MAX] * 96, device=CPU),
                                  settings, device=CPU)
    for attr in ("traffic", "servo", "slo"):
        assert getattr(back, attr).state_dict() == \
            getattr(eng, attr).state_dict()
    assert back._vc_fold.state_dict() == eng._vc_fold.state_dict()
    assert back.lineage_spans == eng.lineage_spans
    back.run(2)
    assert [_strip(r) for r in back.chunk_records] == \
        [_strip(r) for r in whole.chunk_records[3:]]
    assert back.slo.state_dict() == whole.slo.state_dict()
    assert back.traffic.state_dict() == whole.traffic.state_dict()
    assert _strip(back.summary())["lineage"] == \
        _strip(whole.summary())["lineage"]


def test_status_file_and_socket(tmp_path):
    """A snapshot every chunk, valid under both packages' validators, in
    the file and over the socket; ``watch`` streams the later frames in
    tick order; attaching them changes no non-wall record."""
    sock = str(tmp_path / "status.sock")
    status = StatusPublisher(file_path=str(tmp_path / "status.json"),
                             socket_path=sock)
    svc = golden.PortService(CPU)
    cfg = dict(golden.SOAK, chunk=128)
    eng = golden.boot_soak(svc, cfg, status=status)
    frames, ready = [], threading.Event()

    def watch():
        import socket

        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sk:
            sk.connect(sock)
            sk.sendall(b"watch\n")
            ready.set()
            with sk.makefile("r") as fh:
                for line in fh:
                    frames.append(json.loads(line))
                    if len(frames) == 4:
                        return

    with_watch = threading.Thread(target=watch, daemon=True)
    with_watch.start()
    ready.wait(10)
    time.sleep(0.2)
    eng.run(4)
    with_watch.join(20)
    snap = read_status(sock)[0]
    assert read_status(sock, "bogus")[0] == {"error": "unknown command "
                                                      "'bogus'"}
    on_file = json.loads((tmp_path / "status.json").read_text())
    eng.close()
    assert [f["tick"] for f in frames] == [128, 256, 384, 512]
    for frame in frames + [snap, on_file]:
        assert schema.validate_status_snapshot(frame) == []
        assert ref_schema.validate_status_snapshot(frame) == []
    assert snap["tick"] == on_file["tick"] == 512
    plain = golden.boot_soak(svc, cfg)
    plain.run(4)
    assert [_strip(r) for r in plain.chunk_records] == \
        [_strip(r) for r in eng.chunk_records]


def _cli(main, args, tmp_path, tag):
    out = tmp_path / f"{tag}.json"
    rc = main(args + ["--artifact", str(out)])
    return rc, json.loads(out.read_text())


#: The soak's and the two-zone member's shapes (the reference's
#: executables of the tests above serve these runs too), cut short.
SMALL_SOAK = ["--soak", "--ticks", "2048", "--no-tick-rows"]
SMALL_RX = ["--rx-soak", "--n", "64", "--ticks", "48", "--chunk", "16",
            "--horizon", "192"]
SMALL_SWEEP = ["--load-sweep", "--targets", "10,640", "--pinned-tps", "1000",
               "--chunks-per-rate", "3", "--warmup", "1", "--chunk", "128",
               "--n", "10", "--capacity", "24"]
SWEEP_WALL_KEYS = ("wall_s", "achieved_events_per_sec", "ticks_per_sec")


@pytest.mark.parametrize("args", [SMALL_SOAK, SMALL_RX, SMALL_SWEEP],
                         ids=["soak", "rx_soak", "load_sweep"])
def test_cli_modes_equal_the_reference(args, tmp_path, capsys):
    """``python -m rapid_tpu_torch.service`` with the reference's flags
    (and ``--device cpu``) exits as the reference's does with the same
    artifact but its walls."""
    rc, got = _cli(port_main.main, args + ["--device", CPU], tmp_path, "p")
    ref_rc, want = _cli(ref_main.main, args, tmp_path, "r")
    assert rc == ref_rc == 0
    capsys.readouterr()
    if args is SMALL_SWEEP:
        assert schema.validate_load_sweep(got) == []
        for payload in (got, want):
            payload.pop("wall_s")
            for rate in payload["rates"]:
                for key in SWEEP_WALL_KEYS:
                    rate.pop(key, None)
            if payload["knee"]:
                payload["knee"].pop("achieved_events_per_sec")
        assert got == want
        assert got["knee"]["target_events_per_sec"] == 10.0
        return
    for payload in (got, want):
        payload["summary"] = _strip(payload["summary"])
        payload["chunks"] = [_strip(c) for c in payload["chunks"]]
    assert golden.differences(got, want) == []


def test_cli_refuses_without_a_mode_and_without_a_card(monkeypatch):
    from rapid_tpu_torch.device import NoCudaDeviceError

    with pytest.raises(SystemExit) as exc:
        port_main.main([])
    assert exc.value.code == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError):
        port_main.main(SMALL_SOAK)


# ---------------------------------------------------------------------------
# the streaming validators
# ---------------------------------------------------------------------------

def _payloads():
    soak = json.loads((ROOT / "benchmarks" / "soak.json").read_text())
    rx = json.loads((ROOT / "benchmarks" / "rx_soak.json").read_text())
    sweep = json.loads((ROOT / "benchmarks" / "load_sweep.json").read_text())
    servo = golden.load(golden.SERVO_PATH)
    manifest = json.loads((golden.CHECKPOINT_DIR / "engine"
                           / "manifest.json").read_text())
    summary = dict(servo["summary"], wall_s=1.0, compile_s=0.1,
                   ticks_per_sec=None, events_per_sec=None,
                   live_buffer_bytes={"first": 1, "max": 2,
                                      "steady_max": 1, "last": 1})
    chunk = dict(servo["chunks"][0], wall_s=1.0, compile_s=None,
                 ticks_per_sec=None, events_per_sec=None,
                 live_buffer_bytes=7)
    status = {"record": "status_snapshot", "schema_version": 12,
              "source": "resident", "tick": 512, "chunks": 1, "epoch": 3,
              "n_members": 27, "ticks_per_sec": 10.0,
              "events_per_sec": None, "backlog": 0,
              "live_buffer_bytes": 9, "servo": chunk["servo"],
              "slo": chunk["slo"], "lineage": chunk["lineage"],
              "checkpoint": None, "wall_s": 2.0}
    stream = [json.dumps(dict(c, wall_s=1.0, compile_s=None,
                              ticks_per_sec=None, events_per_sec=None,
                              live_buffer_bytes=7))
              for c in servo["chunks"][:3]] + [json.dumps(summary)]
    return {
        "servo_summary": ("validate_servo_summary", summary["servo"]),
        "stream_chunk": ("validate_stream_chunk", chunk),
        "stream_chunk_soak": ("validate_stream_chunk", soak["chunks"][5]),
        "stream_summary": ("validate_stream_summary", summary),
        "stream_summary_rx": ("validate_stream_summary", rx["summary"]),
        "status_snapshot": ("validate_status_snapshot", status),
        "load_sweep": ("validate_load_sweep", sweep),
        "checkpoint_manifest": ("validate_checkpoint_manifest", manifest),
        "streaming_stream": ("validate_streaming_stream", stream),
    }


def _broken(name, payload):
    """Broken copies: a key dropped, a wrong type, and one semantic
    fault per validator where it has one."""
    out = []
    if isinstance(payload, list):
        out.append(payload[:-1])                      # no summary
        out.append(payload + payload[-1:])            # two summaries
        out.append(list(reversed(payload)))           # summary first
        out.append(["{not json"] + payload)
        return out
    for key in list(payload)[:3]:
        d = copy.deepcopy(payload)
        d.pop(key)
        out.append(d)
    d = copy.deepcopy(payload)
    d[list(d)[0]] = object.__name__
    out.append(d)
    if name == "load_sweep":
        d = copy.deepcopy(payload)
        d["knee"]["target_events_per_sec"] = 1.0
        out.append(d)
        d = copy.deepcopy(payload)
        d["rates"] = d["rates"][:-1]
        out.append(d)
    if name.startswith("stream_summary") or name == "status_snapshot":
        d = copy.deepcopy(payload)
        d["schema_version"] = 3
        out.append(d)
    if name == "stream_chunk":
        d = copy.deepcopy(payload)
        d["slo"]["metrics"]["decide_latency"]["count"] += 1
        out.append(d)
    if name == "checkpoint_manifest":
        d = copy.deepcopy(payload)
        d["leaves"][0].pop("dtype")
        out.append(d)
    return out


@pytest.mark.parametrize("name", sorted(_payloads()))
def test_streaming_validators_match_the_reference(name):
    fn, payload = _payloads()[name]
    port_fn, ref_fn = getattr(schema, fn), getattr(ref_schema, fn)
    if name in ("stream_chunk_soak", "stream_summary_rx", "load_sweep"):
        # The committed files predate schema v12 (no lineage, version
        # 11): both packages flag the same fields.
        assert port_fn(payload) == ref_fn(payload) != []
    else:
        assert port_fn(payload) == ref_fn(payload) == []
    for bad in _broken(name, payload):
        got = port_fn(bad)
        assert got == ref_fn(bad)
        assert got != []


def test_streaming_run_payload_validates_as_the_reference():
    servo = golden.load(golden.SERVO_PATH)["summary"]
    run = {"scenario": "streaming", "n": 24, "ticks": 4096,
           "wall_s": 1.0, "ticks_per_sec": 4096.0, "capacity": 96,
           "chunk_ticks": 512, "chunks": 8, "events_injected": 10,
           "events_per_sec": None, "traffic": servo["traffic"],
           "ticks_to_view_change": servo["ticks_to_view_change"],
           "lineage": servo["lineage"], "checkpoint": servo["checkpoint"]}
    for payload in (run, dict(run, traffic={"seed": "x"}),
                    {k: v for k, v in run.items() if k != "chunks"}):
        assert schema.validate_run_payload(payload) == \
            ref_schema.validate_run_payload(payload)


def test_service_exports_match_the_reference():
    from rapid_tpu_torch import service

    assert sorted(ref_service.__all__) == \
        sorted(n for n in service.__all__ if n != "synthetic_uids")
    assert service.CHECKPOINT_VERSION == ref_service.CHECKPOINT_VERSION
    from rapid_tpu.service import checkpoint as ref_ck
    from rapid_tpu_torch.service import checkpoint as ck

    assert (ck.FAMILIES, ck.STATIC_FIELDS, ck.CHECKPOINT_RECORD) == \
        (ref_ck.FAMILIES, ref_ck.STATIC_FIELDS, ref_ck.CHECKPOINT_RECORD)


def test_slo_windows_state_round_trip_matches_the_reference():
    samples = [{"decide_latency": [1, 1, 3], "ticks_to_view_change": [40]},
               {"decide_latency": [], "ticks_to_view_change": []},
               {"decide_latency": [2], "ticks_to_view_change": [600, 7]}]
    from rapid_tpu.telemetry.slo import SloWindows as RefSlo

    port, ref = SloWindows(2), RefSlo(2)
    for s in samples:
        assert port.fold_chunk(s) == ref.fold_chunk(s)
    assert port.state_dict() == ref.state_dict()
    assert SloWindows.from_state(ref.state_dict()).block() == ref.block()


@pytest.mark.slow
def test_whole_soak_equals_the_current_reference(tmp_path, capsys):
    """The whole soak of ``benchmarks/soak.json`` through both CLIs
    (about a minute for the port and 20 s for the reference here): every
    chunk record and the summary equal on every non-wall key, lineage
    blocks and ``schema_version`` included, which the committed file
    predates."""
    rc, got = _cli(port_main.main, ["--soak", "--no-tick-rows", "--device",
                                    CPU], tmp_path, "p")
    ref_rc, want = _cli(ref_main.main, ["--soak", "--no-tick-rows"],
                        tmp_path, "r")
    capsys.readouterr()
    assert rc == ref_rc == 0
    for payload in (got, want):
        payload["summary"] = _strip(payload["summary"])
        payload["chunks"] = [_strip(c) for c in payload["chunks"]]
    assert golden.differences(got, want) == []
    assert golden.soak_errors(got["chunks"], got["summary"]) == []


@pytest.mark.slow
def test_n100k_resident_equals_golden(tmp_path):
    """The N=100,000 resident of ``chip_smoke.py`` phase 31 on the CPU
    (about a minute and a half here)."""
    got = golden.n100k_stream_record(golden.PortService(CPU), tmp_path)
    assert golden.differences(got, golden.load(golden.STREAM_N100K_PATH)) \
        == []


def test_settings_carry_the_stream_chunk_default():
    assert Settings().stream_chunk_ticks == 256
