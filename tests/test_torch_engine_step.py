"""Whole runs of the port's shared engine against
``rapid_tpu.engine.step.simulate``: every ``StepLog`` field at every tick
and every final-state field, bit for bit (tolerance: exact), on crash
bursts, probe drop with link windows, and two bursts whose decides follow
one another; plus the host-side events and counters, the host reads per
tick, and what the port still refuses."""
import importlib
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import pytest
import torch

from rapid_tpu.engine import diff as ref_diff
from rapid_tpu.engine.state import EngineFaults as RefFaults
from rapid_tpu.engine.state import init_state as ref_init_state
from rapid_tpu.engine.state import link_faults as ref_link_faults
from rapid_tpu.faults import LinkWindow as RefWindow
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch import device
from rapid_tpu_torch.convert import from_reference, to_numpy
from rapid_tpu_torch.engine import diff, step
from rapid_tpu_torch.engine.state import I32_MAX, init_state
from rapid_tpu_torch.identity import default_identities
from rapid_tpu_torch.settings import Settings

ref_step = importlib.import_module("rapid_tpu.engine.step")


@dataclass(frozen=True)
class Run:
    n: int
    ticks: int
    crashes: Tuple[Tuple[int, int], ...] = ()
    windows: Tuple[RefWindow, ...] = ()
    drop_p: float = 0.0


RUNS = {
    "n64_crash_burst": Run(64, 160, crashes=((3, 5), (17, 5), (40, 5))),
    "n256_crash_burst": Run(256, 160,
                            crashes=tuple((s, 5) for s in range(0, 256, 50))),
    "n64_drop_two_way_and_flip_flop": Run(
        64, 200, crashes=((50, 5),), drop_p=0.3,
        windows=(RefWindow(src_slots=frozenset(range(4)),
                           dst_slots=frozenset(range(4, 12)), start_tick=3,
                           two_way=True),
                 RefWindow(src_slots=frozenset(range(30, 34)),
                           dst_slots=frozenset(range(40, 64)),
                           start_tick=20, period_ticks=20))),
    "n64_two_bursts": Run(64, 250, crashes=((3, 5), (17, 5), (40, 130),
                                             (41, 130))),
}


def _reference_boot(run: Run):
    uids, id_fp_sum = default_identities(run.n)
    state = ref_init_state(uids, id_fp_sum, RefSettings())
    crash = [I32_MAX] * run.n
    for slot, tick in run.crashes:
        crash[slot] = tick
    base = ref_link_faults(crash, run.windows, run.n)
    faults = RefFaults(
        base.crash_tick, drop_p=run.drop_p, drop_seed=7,
        link_src=base.link_src, link_dst=base.link_dst,
        link_start=base.link_start, link_end=base.link_end,
        link_period=base.link_period, link_two_way=base.link_two_way)
    return state, faults


@pytest.fixture(scope="module", params=sorted(RUNS))
def runs(request):
    run = RUNS[request.param]
    state, faults = _reference_boot(run)
    want = ref_step.simulate(state, faults, run.ticks, RefSettings())
    before = device.host_reads
    got = step.simulate(from_reference(state, device="cpu"),
                        from_reference(faults, device="cpu"), run.ticks,
                        Settings(), device="cpu")
    return request.param, want, got, device.host_reads - before


def _assert_same(port_nt, ref_nt):
    port_np = to_numpy(port_nt)
    for name in ref_nt._fields:
        want = np.asarray(getattr(ref_nt, name))
        got = getattr(port_np, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if not np.array_equal(got, want):
            first = (np.argwhere(got != want)[0].tolist()
                     if got.ndim else [])
            pytest.fail(f"{name} differs first at {first}")


def test_logs_equal_the_reference_at_every_tick(runs):
    _, (_, ref_logs), (_, port_logs), _ = runs
    _assert_same(port_logs, ref_logs)


def test_final_state_equals_the_reference(runs):
    _, (ref_final, _), (port_final, _), _ = runs
    _assert_same(port_final, ref_final)


def test_events_and_counters_equal_the_reference(runs):
    name, (_, ref_logs), (_, port_logs), _ = runs
    events = [e.as_dict() for e in diff.engine_events(port_logs)]
    assert events == [e.as_dict() for e in ref_diff.engine_events(ref_logs)]
    assert diff.expand_counters(port_logs) == \
        ref_diff.expand_counters(ref_logs)
    decides = [e["tick"] for e in events if e["kind"] == "view_change"]
    if "crash" in name:
        assert decides == [113]
    elif "two_bursts" in name:
        assert decides == [113, 233]


def test_scenarios_exercise_the_alert_path(runs):
    name, (_, ref_logs), _, _ = runs
    assert int(np.asarray(ref_logs.cut_reports).max()) > 0
    if "drop" in name:
        assert int(np.asarray(ref_logs.probes_failed).sum()) > 0
        assert int(np.asarray(ref_logs.partitioned_edges).max()) > 0


def test_host_reads_per_tick(runs):
    """Two reads at start (the tick, whether votes arrive), then per tick:
    whether the tick announces, and whether a tick with arriving votes
    decides. Later arrivals come from the last tick's announce read."""
    _, (_, ref_logs), _, reads = runs
    ticks = len(np.asarray(ref_logs.tick))
    vote_ticks = int((np.asarray(ref_logs.quorum) > 0).sum())
    assert reads == 2 + ticks + vote_ticks


def test_step_reads_the_tick_when_not_given():
    run = RUNS["n64_crash_burst"]
    state, faults = _reference_boot(run)
    port_state = from_reference(state, device="cpu")
    port_faults = from_reference(faults, device="cpu")
    got = step.step(port_state, port_faults, Settings())
    want = step.step(port_state, port_faults, Settings(), tick=0)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kw,item", [
    (dict(mesh=object()), "item 8"),
])
def test_out_of_slice_options_are_refused(kw, item):
    uids, id_fp_sum = default_identities(8)
    state = init_state(uids, id_fp_sum, Settings(), device="cpu")
    faults = from_reference(RefFaults(np.full(8, I32_MAX, np.int32)),
                            device="cpu")
    settings = kw.pop("settings", Settings())
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
        step.simulate(state, faults, 2, settings, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match=f"Queue 1 {item}"):
        step.step(state, faults, settings, **kw)


@pytest.mark.parametrize("settings", [
    Settings(protocol_variant="ring"), Settings(protocol_variant="hier"),
    Settings(invariant_checks=True), Settings(flight_recorder_window=4),
], ids=["ring", "hier", "invariant_checks", "flight_recorder"])
def test_options_once_refused_now_run(settings):
    """The variants, the monitor and the recorder run in the port; a
    quiet 8-slot run logs the same as the default settings'."""
    uids, id_fp_sum = default_identities(8)
    state = init_state(uids, id_fp_sum, Settings(), device="cpu")
    faults = from_reference(RefFaults(np.full(8, I32_MAX, np.int32)),
                            device="cpu")
    got = step.simulate(state, faults, 2, settings, device="cpu")
    want = step.simulate(state, faults, 2, Settings(), device="cpu")
    assert len(got) == (3 if settings.flight_recorder_window else 2)
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    new, log = step.step(state, faults, settings)
    assert int(log.inv_bits) == 0 and int(new.tick) == 1


def test_simulate_refuses_state_on_another_device():
    uids, id_fp_sum = default_identities(8)
    state = init_state(uids, id_fp_sum, Settings(), device="cpu")
    faults = from_reference(RefFaults(np.full(8, I32_MAX, np.int32)),
                            device="cpu")
    with pytest.raises(ValueError, match="state lives on cpu"):
        step.simulate(state, faults, 2, Settings(), device="meta")
