"""The port's schedule samplers and schedule checks against the reference.

``sample_adversary_schedule`` draws the reference's schedule for seeds
0-299 under every single-kind weighting and the default mix (kind,
``wants_churn``, crashes, windows, proposes, delays and seed), and every
draw passes the port's ``validate_schedule``; ``random_adversary_schedule``,
``two_zone_schedule`` and ``scenario_weights_preset`` equal theirs too.
``validate_schedule`` refuses what the reference's refuses. Host Python
only: the comparison is exact.
"""
import dataclasses

import pytest

from rapid_tpu import faults as ref_faults

from rapid_tpu_torch import faults

SEEDS = range(300)


def canon(schedule) -> dict:
    """A schedule of either package as plain Python values."""
    def rule(obj):
        return tuple(sorted(obj.src_slots)), tuple(sorted(obj.dst_slots)), \
            tuple(v for k, v in sorted(dataclasses.asdict(obj).items())
                  if k not in ("src_slots", "dst_slots"))

    return {
        "n": schedule.n, "seed": schedule.seed,
        "crashes": tuple(schedule.crashes),
        "windows": tuple(rule(w) for w in schedule.windows),
        "delays": tuple(rule(r) for r in schedule.delays),
        "proposes": tuple((p.slot, p.tick, tuple(p.proposal), p.delay_ticks)
                          for p in schedule.proposes),
    }


def _weights(pkg, kind):
    if kind is None:
        return pkg.DEFAULT_SCENARIO_WEIGHTS
    return pkg.ScenarioWeights(**{k: (1.0 if k == kind else 0.0)
                                  for k in pkg.SCENARIO_KINDS})


def test_kind_tables_match():
    assert faults.SCENARIO_KINDS == ref_faults.SCENARIO_KINDS
    assert faults.DELAY_KINDS == ref_faults.DELAY_KINDS
    assert [f.name for f in dataclasses.fields(faults.ScenarioWeights)] == \
        list(faults.SCENARIO_KINDS)
    assert dataclasses.asdict(faults.DEFAULT_SCENARIO_WEIGHTS) == \
        dataclasses.asdict(ref_faults.DEFAULT_SCENARIO_WEIGHTS)


@pytest.mark.parametrize("kind", (None,) + ref_faults.SCENARIO_KINDS)
def test_sampler_matches_reference(kind):
    for seed in SEEDS:
        got = faults.sample_adversary_schedule(32, seed, 120,
                                               _weights(faults, kind),
                                               ring_depth=4)
        want = ref_faults.sample_adversary_schedule(
            32, seed, 120, _weights(ref_faults, kind), ring_depth=4)
        assert (got.kind, got.wants_churn) == (want.kind, want.wants_churn)
        assert canon(got.schedule) == canon(want.schedule), (kind, seed)
        faults.validate_schedule(got.schedule, ring_depth=4)


@pytest.mark.parametrize("n", [16, 64])
def test_fixed_schedules_match_reference(n):
    for seed in range(40):
        assert canon(faults.random_adversary_schedule(n, seed, 120)) == \
            canon(ref_faults.random_adversary_schedule(n, seed, 120))
        for depth in (3, 4, 6):
            try:
                want = canon(ref_faults.two_zone_schedule(n, seed, 120,
                                                          depth))
            except ref_faults.DelayBudgetError:
                with pytest.raises(faults.DelayBudgetError):
                    faults.two_zone_schedule(n, seed, 120, depth)
                continue
            assert canon(faults.two_zone_schedule(n, seed, 120, depth)) == \
                want


def test_weight_presets_match_reference():
    for name in ref_faults.SCENARIO_WEIGHT_PRESETS:
        assert dataclasses.asdict(faults.scenario_weights_preset(name)) == \
            dataclasses.asdict(ref_faults.scenario_weights_preset(name))
    with pytest.raises(ValueError, match="unknown scenario-weights preset"):
        faults.scenario_weights_preset("nope")
    with pytest.raises(ValueError, match="all scenario weights are zero"):
        faults.ScenarioWeights(**{k: 0.0 for k in faults.SCENARIO_KINDS}
                               ).items()


def _propose(slot=0, tick=5, proposal=(1,), delay=3):
    return (slot, tick, proposal, delay)


@pytest.mark.parametrize("proposes, match", [
    ([_propose(slot=16)], "propose slot 16 outside"),
    ([_propose(tick=0)], "propose tick 0 must be >= 1"),
    ([_propose(proposal=())], "non-empty ascending"),
    ([_propose(proposal=(2, 1))], "non-empty ascending"),
    ([_propose(proposal=(1, 99))], "proposal slot outside"),
    ([_propose(delay=-1)], "delay_ticks must be >= 0"),
    ([_propose(), _propose()], "two scripted proposes on slot 0"),
    ([_propose(), _propose(tick=9)], "more than one scripted propose"),
])
def test_validate_refuses_proposes_as_reference(proposes, match):
    for pkg in (faults, ref_faults):
        sched = pkg.AdversarySchedule(n=16, proposes=tuple(
            pkg.ScriptedPropose(slot=s, tick=t, proposal=p, delay_ticks=d)
            for s, t, p, d in proposes))
        with pytest.raises(ValueError, match=match):
            pkg.validate_schedule(sched)


def test_validate_refuses_overlapping_static_windows_as_reference():
    for pkg in (faults, ref_faults):
        a = pkg.LinkWindow(src_slots=frozenset({0, 1}),
                           dst_slots=frozenset({2}), start_tick=5,
                           end_tick=20)
        b = pkg.LinkWindow(src_slots=frozenset({1}),
                           dst_slots=frozenset({2, 3}), start_tick=10,
                           end_tick=30)
        with pytest.raises(ValueError, match="edge 1->2 in ticks"):
            pkg.validate_schedule(pkg.AdversarySchedule(n=8, windows=(a, b)))
        flip = dataclasses.replace(b, period_ticks=10)
        pkg.validate_schedule(pkg.AdversarySchedule(n=8, windows=(a, flip)))
