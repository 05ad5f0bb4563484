"""The port's per-receiver engine against the JAX reference, end to end.

Two scenarios, each lowered and run by both packages with
``rx_kernel="pallas"`` (the reference's Pallas kernel in interpret mode,
the port's kernel through its plain version on the CPU):

- the crash + partition + delay scenario at N=16 over 160 ticks;
- the tier-1 ``RX_PALLAS_SMOKE`` member (N=64, a partition window and a
  jittered delay rule) over 80 ticks.

The final dense state and every ``ReceiverStepLog`` field must be
bit-identical (exact: all integer and bool arithmetic), and the port's
events, counters and config ids must equal the host referee's
(``rapid_tpu.engine.adversary.AdversaryEngine``).
"""
import numpy as np
import pytest

from rapid_tpu.engine import fleet as fleet_mod
from rapid_tpu.engine import receiver as ref_rx
from rapid_tpu.engine.adversary import AdversaryEngine
from rapid_tpu.faults import AdversarySchedule, DelayRule, LinkWindow
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch import faults as port_faults
from rapid_tpu_torch.convert import to_numpy
from rapid_tpu_torch.engine import receiver as port_rx
from rapid_tpu_torch.identity import default_identities
from rapid_tpu_torch.settings import Settings


def _smoke_member(mod, n=64):
    return mod.AdversarySchedule(
        n=n,
        windows=(mod.LinkWindow(src_slots=frozenset(range(8)),
                                dst_slots=frozenset(range(8, n)),
                                start_tick=20, end_tick=60, two_way=True),),
        delays=(mod.DelayRule(src_slots=frozenset(range(0, 16)),
                              dst_slots=frozenset(range(16, 40)),
                              delay_ticks=1, jitter_ticks=2,
                              start_tick=5, end_tick=70),),
        seed=11)


class _RefFaults:
    AdversarySchedule = AdversarySchedule
    LinkWindow = LinkWindow
    DelayRule = DelayRule


SCENARIOS = {
    "crash_window_delay_n16": (
        lambda: port_faults.crash_window_delay_schedule(16), 160),
    "rx_pallas_smoke_n64": (lambda: _smoke_member(port_faults), 80),
}


def _to_reference(sched):
    return AdversarySchedule(
        n=sched.n, crashes=sched.crashes,
        windows=tuple(LinkWindow(**vars(w)) for w in sched.windows),
        delays=tuple(DelayRule(**vars(r)) for r in sched.delays),
        seed=sched.seed)


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def runs(request):
    make, ticks = SCENARIOS[request.param]
    sched = make()
    ref_sched = _to_reference(sched)
    if request.param.startswith("rx_pallas_smoke"):
        assert ref_sched == _smoke_member(_RefFaults)
    ref_settings = RefSettings(rx_kernel="pallas")
    member = fleet_mod.lower_receiver_schedule(ref_sched, ref_settings)
    ref_final, ref_logs = ref_rx.receiver_simulate(
        member.state, member.faults, ticks, ref_settings)

    settings = Settings(rx_kernel="pallas")
    pmember = port_rx.lower_receiver_schedule(sched, settings, device="cpu")
    final, logs = port_rx.receiver_simulate(pmember.state, pmember.faults,
                                            ticks, settings)

    uids, id_fp_sum = default_identities(sched.n)
    host = AdversaryEngine(ref_sched, uids, id_fp_sum,
                           RefSettings()).run(ticks)
    return dict(n=sched.n, ticks=ticks, ref_final=ref_final,
                ref_logs=ref_logs, final=final, logs=logs, host=host)


def _assert_same(got, want):
    got = to_numpy(got)
    assert got._fields == type(want)._fields
    for field in got._fields:
        g = getattr(got, field)
        w = np.asarray(getattr(want, field))
        assert g.dtype == w.dtype, field
        assert g.shape == w.shape, field
        assert np.array_equal(g, w), field


def test_final_state_bit_identical(runs):
    _assert_same(runs["final"], runs["ref_final"])


def test_every_log_field_bit_identical(runs):
    _assert_same(runs["logs"], runs["ref_logs"])


def test_flags_clear_and_faults_exercised(runs):
    port_rx.check_flags(runs["final"].flags)
    logs = runs["logs"]
    assert int(logs.partitioned_edges.max()) > 0
    assert int(logs.probes_failed.sum()) > 0
    if runs["n"] == 16:     # the crash scenario decides its view change
        assert int(logs.decide.sum()) > 0
        assert int(logs.fv_sent.sum()) > 0


def test_matches_host_referee(runs):
    n, host = runs["n"], runs["host"]
    logs, final = runs["logs"], runs["final"]
    assert port_rx.receiver_events(logs)[:n] == host.events_by_slot
    assert port_rx.receiver_counters(logs) == host.tick_history
    assert port_rx.receiver_phase_counters(logs) == host.phase_history
    assert port_rx.receiver_config_ids(final)[:n] == host.config_ids


def test_host_extractors_match_reference_extractors(runs):
    logs, ref_logs = runs["logs"], runs["ref_logs"]
    assert port_rx.receiver_events(logs) == ref_rx.receiver_events(ref_logs)
    assert port_rx.receiver_counters(logs) == \
        ref_rx.receiver_counters(ref_logs)
    assert port_rx.receiver_config_ids(runs["final"]) == \
        ref_rx.receiver_config_ids(runs["ref_final"])
