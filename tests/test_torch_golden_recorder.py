"""The flight recorder's golden files against the JAX reference.

``testdata/shared_n100k_crash_rec64.json``: ``shared_n100k_crash`` with a
64-row recorder (ring rows and stamps beside every field of the plain
file). ``testdata/rx_n{64,1024}_recorder.json`` (``golden.RX_RECORDERS``):
the per-receiver engine on ``faults.crash_window_delay_schedule(n)`` over
160 ticks with a 32- and a 64-row recorder (counters, events, config ids,
ring rows and stamps); the reference makes them on its dense carry
(``rx_kernel="xla"``), whose logs equal its packed layouts'.
``chip_smoke.py`` phase 14 holds the card to the N=100,000 shared file and
the N=1024 receiver file. Here the port's CPU runs equal the files, and
the reference regenerates them unchanged. Regenerate with
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_golden_recorder.py``
(about 5 minutes: the reference's N=1024 receiver run). Tolerance: exact.
"""
import numpy as np
import pytest
import torch

from rapid_tpu_torch import golden
from rapid_tpu_torch.engine import receiver, recorder
from rapid_tpu_torch.faults import crash_window_delay_schedule
from rapid_tpu_torch.settings import Settings

NAME = "shared_n100k_crash_rec64"


def rx_reference_record(run: golden.RxRecorderRun) -> dict:
    from rapid_tpu.engine import fleet as ref_fleet
    from rapid_tpu.engine import receiver as ref_rx
    from rapid_tpu.engine import recorder as ref_recorder
    from rapid_tpu.settings import Settings as RefSettings
    from test_torch_golden import reference_schedule

    n, ticks = run.n, golden.GOLDEN_TICKS
    settings = RefSettings(rx_kernel="xla", flight_recorder_window=run.window)
    member = ref_fleet.lower_receiver_schedule(
        reference_schedule(crash_window_delay_schedule(n)), settings)
    final, logs, rec = ref_rx.receiver_simulate(member.state, member.faults,
                                                ticks, settings)
    ref_rx.check_flags(int(np.asarray(final.flags)))
    out = golden.record(ref_rx.receiver_events(logs),
                        ref_rx.receiver_counters(logs),
                        ref_rx.receiver_phase_counters(logs),
                        ref_rx.receiver_config_ids(final), n)
    out["recorder"] = ref_recorder.recorder_payload(rec)
    return out


def rx_port_record(run: golden.RxRecorderRun, device="cpu") -> dict:
    settings = Settings(rx_kernel="pallas", flight_recorder_window=run.window)
    member = receiver.lower_receiver_schedule(
        crash_window_delay_schedule(run.n), settings, device=device)
    final, logs, rec = receiver.receiver_simulate(
        member.state, member.faults, golden.GOLDEN_TICKS, settings)
    receiver.check_flags(final.flags)
    out = golden.run_record(final, logs, run.n)
    out["recorder"] = recorder.recorder_payload(rec)
    return out


@pytest.fixture
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_port_cpu_run_equals_the_shared_recorder_golden(few_threads):
    sc = golden.OPTIONS[NAME]
    want = golden.load(sc.path)
    assert golden.differences(golden.run_scenario(sc, device="cpu"),
                              want) == []
    # The plain file's fields are the recorder run's too.
    plain = golden.load(golden.SHARED["shared_n100k_crash"].path)
    assert {k: v for k, v in want.items() if k not in ("name", "recorder")} \
        == {k: v for k, v in plain.items() if k != "name"}
    rows = want["recorder"]["rows"]
    assert len(rows) == 64 and [r[0] for r in rows] == list(range(97, 161))
    assert want["recorder"]["stamps"] == {
        "first_announce": 112, "first_decide": 113, "first_fallback": -1,
        "first_violation": -1}


def test_shared_recorder_golden_matches_reference():
    from test_torch_engine_golden import reference_record

    rec = reference_record(golden.OPTIONS[NAME])
    assert golden.dumps(rec) == golden.OPTIONS[NAME].path.read_text()


SMALL, LARGE = golden.RX_RECORDERS


def test_port_cpu_run_equals_the_small_receiver_recorder_golden(few_threads):
    want = golden.load(SMALL.path)
    assert golden.differences(rx_port_record(SMALL), want) == []
    # The plain N=64 file's fields are the recorder run's too.
    assert {k: v for k, v in want.items() if k != "recorder"} == \
        golden.load(golden.GOLDEN_PATH)
    rows = want["recorder"]["rows"]
    # 160 ticks in 32 rows: the ring wrapped, and holds the last 32 ticks
    assert len(rows) == SMALL.window
    assert [r[0] for r in rows] == list(range(129, 161))
    assert want["recorder"]["stamps"]["first_decide"] > 0


def test_small_receiver_recorder_golden_matches_reference():
    assert golden.dumps(rx_reference_record(SMALL)) == \
        SMALL.path.read_text()


@pytest.mark.slow
def test_port_cpu_run_equals_the_receiver_recorder_golden(few_threads):
    """The port's per-receiver run at N=1024 takes several minutes on the
    CPU; the card runs it in seconds (``chip_smoke.py`` phase 14), and
    ``tests/test_torch_recorder.py`` holds the receiver recorder to the
    reference at N=12 and 16 and the N=64 file above."""
    want = golden.load(LARGE.path)
    assert golden.differences(rx_port_record(LARGE), want) == []
    assert len(want["recorder"]["rows"]) == LARGE.window
    assert want["recorder"]["stamps"]["first_decide"] > 0


@pytest.mark.slow
def test_receiver_recorder_golden_matches_reference():
    """The reference's dense receiver run at N=1024 takes minutes on the
    CPU."""
    assert golden.dumps(rx_reference_record(LARGE)) == \
        LARGE.path.read_text()


if __name__ == "__main__":
    from test_torch_engine_golden import reference_record

    sc = golden.OPTIONS[NAME]
    sc.path.write_text(golden.dumps(reference_record(sc)))
    print("wrote", sc.path)
    for run in golden.RX_RECORDERS:
        run.path.write_text(golden.dumps(rx_reference_record(run)))
        print("wrote", run.path)
