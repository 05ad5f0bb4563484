"""PyTorch and CUDA port of rapid-tpu's per-receiver engine.

The engine runs the Rapid membership protocol (K-ring monitoring,
multi-node cut detection, Fast Paxos with the classic fallback) for every
simulated slot at once, each slot with its own view, exact under link
partitions and link delays. The port carries the reference's dense or
packed receiver state between ticks (``Settings.rx_kernel``) and replaces
its TPU delivery kernel with a CUDA kernel for Hopper
(``engine/csrc/rx_deliver.cu``; the packed kernel ``rx_account.cu`` is
kept as its yardstick).

Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
without a card the default raises. The user-facing pair is::

    member = engine.receiver.lower_receiver_schedule(schedule, settings)
    final, logs = engine.receiver.receiver_simulate(
        member.state, member.faults, n_ticks, settings)

under any ``settings.rx_kernel`` ("xla", the default, is the dense
carry). The shared-state engine
(``engine.init_state`` then ``engine.simulate``) runs one view for every
receiver, with churn (``engine.plan_churn`` schedules it from the join
protocol, against the host mirrors in ``oracle``), the classic-Paxos
fallback, the ring and hier variants (``variants``), the invariant
monitor and the flight recorder. ``telemetry`` folds either engine's
logs into the reference's summaries, lineage spans, SLO windows and
Perfetto traces.

The host referee checks any scenario against an independent simulation
of the protocol: ``oracle`` (a whole simulated cluster of
``MembershipService`` nodes on a deterministic network) and
``engine.adversary`` (per-slot host replay of a fault schedule), with
``engine.diff``'s runners driving a scenario through the referee and an
engine::

    res = engine.diff.run_differential(256, {5: 11, 100: 13}, 140)
    res = engine.diff.run_receiver_differential(schedule, 160, settings)
    res.assert_identical()

Campaigns (``campaign``) sample thousands of seeded fault scenarios,
run them as pools of fleets on either engine and fold them into the
reference's payload (distributions, triage, lineage, tournaments across
protocol variants); ``replay`` re-runs any member of a payload alone::

    payload = run_campaign(CampaignConfig(clusters=4096, n=32, ticks=120,
                                          fleet_size=256))
    record = replay_member(payload, dispatch, member_index, oracle=True)

This package imports ``torch``, ``numpy`` and the standard library only.
"""
from rapid_tpu_torch.campaign import (CampaignConfig, run_campaign,
                                      run_tournament)
from rapid_tpu_torch.replay import replay_member
from rapid_tpu_torch.settings import Settings

__all__ = ["CampaignConfig", "Settings", "replay_member", "run_campaign",
           "run_tournament"]
