"""Tests of the port that need the card (the CUDA kernel has no CPU mode).

Marked ``cuda``; each skips with a reason when no CUDA device is present.
This file imports neither JAX nor the reference, so on the card it runs
with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from rapid_tpu_torch.convert import to_numpy
from rapid_tpu_torch.engine import receiver, rx_account
from rapid_tpu_torch.engine.rx_packed import pack_bits
from rapid_tpu_torch.faults import crash_window_delay_schedule
from rapid_tpu_torch.settings import Settings

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("c", [13, 64, 96, 200, 1000, 1024])
def test_kernel_matches_plain(card, c):
    rng = np.random.default_rng(c)
    msgs = torch.from_numpy(rng.random((c, c)) < 0.4).to(card)
    blocked = torch.from_numpy(rng.random((c, c)) < 0.25).to(card)
    crashed = torch.from_numpy(rng.random(c) < 0.15).to(card)
    planes = (pack_bits(msgs), pack_bits(blocked),
              torch.where(crashed, 0, 0xFF).to(torch.uint8)[:, None]
              .contiguous(), pack_bits(~crashed)[None, :].contiguous())
    dv_k, cnt_k = rx_account.account_kernel(*planes)
    dv_p, cnt_p = rx_account.account_plain(*planes)
    torch.cuda.synchronize()
    assert torch.equal(dv_k, dv_p) and torch.equal(cnt_k, cnt_p)


@pytest.mark.parametrize("phase", [None, 3])
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("c", [13, 64, 200, 1000, 1024, 4096])
def test_deliver_kernel_matches_plain(card, c, planes, phase):
    rng = np.random.default_rng(10 * c + planes)
    msgs = torch.from_numpy(rng.random((planes, c, c)) < 0.4).to(card)
    blocked = torch.from_numpy(rng.random((c, c)) < 0.25).to(card)
    crashed = torch.from_numpy(rng.random(c) < 0.15).to(card)
    pe = pack_bits(blocked)
    start = torch.tensor([5, -2, 9, 4, 1], dtype=torch.int32, device=card)
    acc_k, acc_p = start.clone(), start.clone()
    before = rx_account.deliver_launches
    got = rx_account.account_into_kernel(msgs, crashed, pe, acc_k, phase)
    want = rx_account.account_into_plain(msgs, crashed, pe, acc_p, phase)
    torch.cuda.synchronize()
    assert rx_account.deliver_launches == before + 1
    assert torch.equal(got, want) and torch.equal(acc_k, acc_p)


@pytest.mark.parametrize("rx_kernel", ["pallas", "xla", "packed"])
def test_card_run_equals_cpu_run(card, rx_kernel):
    settings = Settings(rx_kernel=rx_kernel)
    sched = crash_window_delay_schedule(16)
    runs = []
    for device in (card, "cpu"):
        member = receiver.lower_receiver_schedule(sched, settings,
                                                  device=device)
        before = (rx_account.deliver_launches, rx_account.launches)
        runs.append(receiver.receiver_simulate(member.state, member.faults,
                                               120, settings))
        fused = rx_account.deliver_launches - before[0]
        assert fused == (6 * 120 if device == card else 0)
        assert rx_account.launches == before[1]
    for got, want in zip(runs[0], runs[1]):
        got, want = to_numpy(got), to_numpy(want)
        for field in got._fields:
            assert np.array_equal(getattr(got, field),
                                  getattr(want, field)), field


def _same(a, b):
    a, b = to_numpy(a), to_numpy(b)
    for field in a._fields:
        assert np.array_equal(getattr(a, field), getattr(b, field)), field


@pytest.mark.parametrize("options", [
    dict(protocol_variant="ring"), dict(protocol_variant="hier"),
    dict(invariant_checks=True), dict(flight_recorder_window=16),
    dict(protocol_variant="ring", invariant_checks=True,
         flight_recorder_window=200),
], ids=["ring", "hier", "monitor", "recorder", "ring_monitor_recorder"])
def test_shared_options_card_run_equals_cpu_run(card, options):
    from rapid_tpu_torch.engine import simulate
    from rapid_tpu_torch.engine.state import I32_MAX, crash_faults, init_state
    from rapid_tpu_torch.identity import synthetic_uids

    n = 256
    settings = Settings(**options)
    crash = [5 if s % 50 == 0 else I32_MAX for s in range(n)]
    runs = []
    for device in (card, "cpu"):
        state = init_state(synthetic_uids(n), 0, settings, device=device)
        runs.append(simulate(state, crash_faults(crash, device=device), 130,
                             settings, device=device))
    assert len(runs[0]) == (3 if settings.flight_recorder_window else 2)
    for got, want in zip(*runs):
        _same(got, want)
    assert int(runs[0][1].decide_now.sum()) == 1
    assert int(runs[0][1].inv_bits.abs().sum()) == 0


def test_planned_churn_card_run_equals_cpu_run(card):
    from rapid_tpu_torch.convert import from_reference
    from rapid_tpu_torch.engine import churn, simulate
    from rapid_tpu_torch.engine.state import I32_MAX, crash_faults, init_state
    from rapid_tpu_torch.identity import (default_endpoints,
                                          default_identities,
                                          default_node_ids)

    n, c = 64, 66
    plan = churn.plan_churn(default_endpoints(c), n, default_node_ids(n),
                            180, Settings(), joins={64: 120, 65: 120},
                            leaves={7: 140}, crashes={3: 5, 17: 5, 40: 5})
    crash = [5 if s in (3, 17, 40) else I32_MAX for s in range(c)]
    runs = []
    for device in (card, "cpu"):
        state = init_state(default_identities(c)[0],
                           default_identities(n)[1], Settings(),
                           member=np.arange(c) < n, id_fps=plan.id_fps,
                           device=device)
        runs.append(simulate(state, crash_faults(crash, device=device), 180,
                             Settings(),
                             churn=from_reference(plan, device=device),
                             device=device))
    for got, want in zip(*runs):
        _same(got, want)
    assert int(runs[0][1].decide_now.sum()) == 3


def test_receiver_recorder_card_run_equals_cpu_run(card):
    settings = Settings(rx_kernel="pallas", flight_recorder_window=32)
    sched = crash_window_delay_schedule(16)
    runs = []
    for device in (card, "cpu"):
        member = receiver.lower_receiver_schedule(sched, settings,
                                                  device=device)
        before = rx_account.deliver_launches
        runs.append(receiver.receiver_simulate(member.state, member.faults,
                                               120, settings))
        fused = rx_account.deliver_launches - before
        assert fused == (6 * 120 if device == card else 0)
    for got, want in zip(*runs):
        _same(got, want)


@pytest.mark.parametrize("phase", [None, 3])
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("c, f", [(13, 3), (32, 256), (48, 256), (1024, 2)])
def test_deliver_kernel_over_members_matches_plain(card, c, f, planes,
                                                   phase):
    rng = np.random.default_rng(c + f + planes)
    shape = (f, c, c) if planes == 1 else (f, planes, c, c)
    msgs = torch.from_numpy(rng.random(shape) < 0.4).to(card)
    pe = pack_bits(torch.from_numpy(rng.random((f, c, c)) < 0.25).to(card))
    crashed = torch.from_numpy(rng.random((f, c)) < 0.15).to(card)
    start = torch.from_numpy(rng.integers(-9, 9, (f, 14)).astype(
        np.int32)).to(card)
    acc_k, acc_p = start.clone(), start.clone()
    before = rx_account.deliver_launches
    got = rx_account.account_into_kernel(msgs, crashed, pe, acc_k, phase)
    want = rx_account.account_into_plain(msgs, crashed, pe, acc_p, phase)
    torch.cuda.synchronize()
    assert rx_account.deliver_launches == before + 1
    assert torch.equal(got, want) and torch.equal(acc_k, acc_p)


@pytest.mark.parametrize("pool_id", [0, 1, 2, 3])
def test_fleet_card_run_equals_cpu_run(card, pool_id):
    from rapid_tpu_torch import golden

    pool = golden.FLEET_POOLS[pool_id]
    members = golden.pool_inputs(golden.load(pool.path), 6)
    before = rx_account.deliver_launches
    on_card = golden.run_pool(pool, members, device=card)
    launches = rx_account.deliver_launches - before
    on_cpu = golden.run_pool(pool, members, device="cpu")
    ticks = golden.FLEET_CAMPAIGN["ticks"]
    assert launches == (6 * ticks if pool.mode == "per_receiver" else 0)
    for a, b in zip(on_card, on_cpu):
        _same(a, b)


@pytest.mark.parametrize("pool_id", [2, 3])
def test_dense_fleet_card_run_equals_cpu_run(card, pool_id):
    from rapid_tpu_torch import golden

    pool = golden.FLEET_POOLS[pool_id]
    members = golden.pool_inputs(golden.load(pool.path), 6)
    before = rx_account.deliver_launches
    on_card = golden.run_pool(pool, members, device=card, rx_kernel="xla")
    launches = rx_account.deliver_launches - before
    on_cpu = golden.run_pool(pool, members, device="cpu", rx_kernel="xla")
    assert launches == 6 * golden.FLEET_CAMPAIGN["ticks"]
    assert type(on_card[0]).__name__ == "ReceiverState"
    for a, b in zip(on_card, on_cpu):
        _same(a, b)


def test_telemetry_folds_card_logs_as_cpu_logs(card):
    from rapid_tpu_torch import golden

    sc = golden.SHARED["shared_n1000_crash"]
    records = []
    for device in (card, "cpu"):
        from rapid_tpu_torch.engine import simulate

        boot = sc.boot(device=device)
        _, logs = simulate(boot.state, boot.faults, sc.ticks, sc.settings(),
                           device=device)
        records.append(golden.shared_telemetry(golden.port_folds(), logs))
    assert records[0] == records[1]
    assert records[0]["errors"] == []
    assert records[0]["summary"]["decisions"] == 1


@pytest.mark.parametrize("rx_kernel", ["xla", "packed"])
def test_receiver_differential_on_card(card, rx_kernel):
    """The referee holds the card's per-receiver run at N=64, and the card's
    result equals the CPU's field by field. The scenario is
    ``chip_smoke.half_delay_schedule``: slot 63 crashes at tick 11, and
    the first half's alert batches and votes arrive 2-3 ticks late."""
    from rapid_tpu_torch.convert import plain
    from rapid_tpu_torch.engine import diff
    from rapid_tpu_torch.faults import AdversarySchedule, DelayRule

    settings = Settings(rx_kernel=rx_kernel)
    schedule = AdversarySchedule(
        n=64, crashes=((63, 11),), seed=41,
        delays=(DelayRule(src_slots=frozenset(range(32)),
                          dst_slots=frozenset(range(64)), delay_ticks=2,
                          jitter_ticks=1),))
    before = (rx_account.deliver_launches, rx_account.launches)
    on_card = diff.run_receiver_differential(schedule, 200, settings,
                                             device=card)
    launched = (rx_account.deliver_launches - before[0],
                rx_account.launches - before[1])
    on_card.assert_identical()
    assert launched == (6 * 200, 0)
    on_cpu = diff.run_receiver_differential(schedule, 200, settings,
                                            device="cpu")
    assert plain(on_card) == plain(on_cpu)


def test_shared_differential_on_card(card):
    from rapid_tpu_torch.convert import plain
    from rapid_tpu_torch.engine import diff

    on_card = diff.run_differential(64, {3: 5, 17: 5, 40: 7}, 130,
                                    device=card)
    on_card.assert_identical()
    assert [e.slots for e in on_card.engine_events] == [(3, 17, 40)] * 2
    on_cpu = diff.run_differential(64, {3: 5, 17: 5, 40: 7}, 130,
                                   device="cpu")
    assert plain(on_card) == plain(on_cpu)


@pytest.mark.parametrize("pipeline", [True, False])
def test_campaign_on_card_equals_cpu(card, pipeline):
    """A campaign straddling both modes (crash and partition members,
    spot checks with a forced contested member, a recorder) gives the
    same payload on the card as on the CPU in every non-wall field, and
    the card's per-receiver dispatches go through ``rx_deliver``; its
    exemplars replay verified on the card."""
    import dataclasses

    from rapid_tpu_torch import campaign, golden, replay
    from rapid_tpu_torch.faults import SCENARIO_KINDS, ScenarioWeights

    cfg = campaign.CampaignConfig(
        clusters=4, n=16, ticks=60, seed=1, fleet_size=2, headroom=8,
        spot_checks=2, flight_recorder=8, pipeline=pipeline,
        weights=ScenarioWeights(**{k: float(k in ("crash", "partition"))
                                   for k in SCENARIO_KINDS}))
    before = rx_account.deliver_launches
    on_card = campaign.run_campaign(cfg, device=card)
    launched = rx_account.deliver_launches - before
    on_cpu = campaign.run_campaign(dataclasses.replace(cfg, pipeline=True),
                                   device="cpu")
    assert golden.campaign_record(on_card) == golden.campaign_record(on_cpu)
    assert on_card["platform"] == "gpu"
    rx = on_card["campaign"]["per_receiver"]
    # The per-receiver dispatches, and the spot check's engine run.
    assert launched == 6 * cfg.ticks * (rx["dispatches"] + 1)
    for block in on_card["campaign"]["triage"]["classes"].values():
        for ex in block["exemplars"]:
            rec = replay.replay_member(on_card, ex["dispatch"],
                                       ex["member_index"], lineage=True,
                                       device=card)
            assert (rec["match"], rec["recorder_match"],
                    rec["lineage_match"]) == (True, True, True)


@pytest.mark.parametrize("layout", ["xla", "packed"])
def test_chunked_receiver_across_a_checkpoint_equals_one_run(card, layout,
                                                             tmp_path):
    """The two-zone N=256 member in chunks of 16 on the card, saved after
    6 chunks and restored from disk, then 3 more chunks: logs, recorder
    and final equal one uninterrupted ``receiver_simulate`` on the card,
    every chunk through ``rx_deliver`` (6 launches a tick)."""
    from rapid_tpu_torch.engine import rx_packed
    from rapid_tpu_torch.faults import two_zone_schedule
    from rapid_tpu_torch.service import checkpoint

    settings = Settings(rx_kernel=layout, flight_recorder_window=8)
    member = receiver.lower_receiver_schedule(
        two_zone_schedule(256, 0, 192), settings, device=card)
    final, logs, rec = receiver.receiver_simulate(member.state,
                                                  member.faults, 144,
                                                  settings)
    before = rx_account.deliver_launches
    carry, r, parts = member.state, None, []
    for i in range(9):
        if i == 6:
            checkpoint.save_receiver(str(tmp_path), carry, settings,
                                     tick=96, rec=r)
            cp = checkpoint.load_checkpoint(str(tmp_path), settings,
                                            device=card)
            carry = checkpoint.restore_receiver_carry(cp, settings)
            r = cp.parts["recorder"]
        carry, lg, r = receiver.receiver_simulate_chunk(
            carry, member.faults, 16, settings, rec=r)
        parts.append(lg)
    torch.cuda.synchronize()
    assert rx_account.deliver_launches - before == 6 * 144
    chained = type(logs)(*[torch.cat(col) for col in zip(*parts)])
    for got, want in zip(chained, logs):
        assert torch.equal(got, want)
    for got, want in zip(r, rec):
        assert torch.equal(got, want)
    if layout == "packed":
        carry = rx_packed.unpack_receiver_state(carry.packed,
                                                carry.delay_table, settings)
    for got, want in zip(carry, final):
        assert torch.equal(got, want)
