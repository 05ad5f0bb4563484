"""The port's differential runners against the reference's.

Each of the ``run_*_differential`` runners of ``rapid_tpu_torch.engine.diff``
(``run_receiver_differential`` in ``test_torch_referee_receiver.py``) runs
the scenarios of the reference's own
tests (``test_engine_diff.py``, ``test_adversary.py``, ``test_delay.py``,
``test_variants.py``, ``test_fallback_engine.py``, ``test_lineage.py`` and
the identifier redraw of ``test_topology_static.py``) at N <= 64, and at
N=256 where the reference's test is marked slow (so are these), with
``device="cpu"``, beside the reference's runner on the same inputs (JAX
on the CPU). The two results must be equal field by field
(``convert.plain``): events, counters, phase counters, config ids,
memberships, metrics rows and lineage spans, and both must be
``assert_identical``. Where the reference raises an envelope error, the
port raises its own with the same message. Everything is integer: the
tolerance is exact.
"""
import dataclasses

import numpy as np
import pytest
import torch

from rapid_tpu import faults as ref_faults
from rapid_tpu.engine import diff as ref_diff
from rapid_tpu.engine.churn import ChurnEnvelopeError as RefChurnError
from rapid_tpu.engine.paxos import FallbackEnvelopeError as RefFallbackError
from rapid_tpu.oracle.cluster import default_rng as ref_default_rng
from rapid_tpu.settings import Settings as RefSettings
from rapid_tpu.telemetry.forensics import DivergenceError as RefDivergence
from rapid_tpu.variants import hier as ref_hier
from rapid_tpu.variants.oracle import VariantEnvelopeError as RefVariantError

from rapid_tpu_torch import convert
from rapid_tpu_torch.engine import diff, sharding
from rapid_tpu_torch.engine.churn import ChurnEnvelopeError
from rapid_tpu_torch.engine.paxos import FallbackEnvelopeError
from rapid_tpu_torch.oracle.cluster import default_rng
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry.forensics import DivergenceError
from rapid_tpu_torch.types import NodeId
from rapid_tpu_torch.variants.oracle import VariantEnvelopeError


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _same(port, ref):
    """Both results exact, and equal field by field."""
    ref.assert_identical()
    port.assert_identical()
    assert type(port).__name__ == type(ref).__name__
    for f in dataclasses.fields(ref):
        assert convert.plain(getattr(port, f.name)) == \
            convert.plain(getattr(ref, f.name)), f.name


def _same_error(port_exc, ref_exc, port_call, ref_call):
    with pytest.raises(ref_exc) as want:
        ref_call()
    with pytest.raises(port_exc) as got:
        port_call()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# run_differential: crash bursts on the shared engine
# ---------------------------------------------------------------------------

CRASHES = {
    "single": (64, {7: 5}, 130),
    "burst": (64, {3: 5, 17: 5, 40: 7}, 130),
    "two_bursts": (64, {3: 5, 17: 5, 40: 201, 41: 205}, 360),
    "quiescent": (64, {}, 60),
}
SLOW_CRASHES = {"n256_large_burst": (256, {s: 5 for s in range(0, 64, 2)},
                                     140)}


@pytest.mark.parametrize("name", sorted(CRASHES) + [
    pytest.param(name, marks=pytest.mark.slow) for name in SLOW_CRASHES])
def test_differential_equals_reference(name):
    n, crashes, ticks = {**CRASHES, **SLOW_CRASHES}[name]
    port = diff.run_differential(n, crashes, ticks, device="cpu")
    _same(port, ref_diff.run_differential(n, crashes, ticks))
    assert set(port.seconds) == {"oracle", "engine"}


def test_divergence_names_tick_and_field_on_both(tmp_path):
    port = diff.run_differential(64, {7: 5}, 130, device="cpu")
    ref = ref_diff.run_differential(64, {7: 5}, 130)
    port.engine_counters[50]["sent"] += 1
    ref.engine_counters[50]["sent"] += 1
    with pytest.raises(RefDivergence) as want:
        ref.assert_identical(artifact=str(tmp_path / "ref.jsonl"))
    with pytest.raises(DivergenceError) as got:
        port.assert_identical(artifact=str(tmp_path / "port.jsonl"))
    for exc in (want.value, got.value):
        assert exc.report.tick == 51
        assert exc.report.field == "counters.sent"
    assert str(got.value).replace("port.jsonl", "ref.jsonl") == \
        str(want.value)
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "ref.jsonl").read_text()


def test_mesh_is_refused():
    """Once refused, a slot mesh of two devices now runs the crash
    differential and gives the reference's events, counters and config
    id."""
    got = diff.run_differential(16, {2: 3}, 130, device="cpu",
                                mesh=sharding.slot_mesh(2, device="cpu"))
    got.assert_identical()
    want = ref_diff.run_differential(16, {2: 3}, 130)
    assert [e.as_dict() for e in got.engine_events] == \
        [e.as_dict() for e in want.engine_events]
    assert got.engine_counters == want.engine_counters
    assert got.engine_config_id == want.engine_config_id


# ---------------------------------------------------------------------------
# run_churn_differential: joins, leaves, crashes, identifier redraws
# ---------------------------------------------------------------------------

CHURN = {
    "join_burst": dict(n=64, capacity=68, n_ticks=40,
                       joins={64: 5, 65: 5, 66: 5, 67: 5}),
    "leave_burst": dict(n=64, capacity=64, n_ticks=40,
                        leaves={3: 5, 17: 5, 40: 5}),
    "mixed": dict(n=64, capacity=66, n_ticks=180,
                  crashes={3: 5, 17: 5, 40: 5}, joins={64: 120, 65: 120},
                  leaves={7: 140}),
    "join_then_leave": dict(n=16, capacity=18, n_ticks=60, joins={16: 5},
                            leaves={16: 30}),
}

CHURN_REFUSED = {
    "partial": dict(n=64, capacity=65, n_ticks=130, crashes={4: 5, 9: 5},
                    joins={64: 118}),
    "in_flight": dict(n=16, capacity=17, n_ticks=40, joins={16: 5},
                      leaves={3: 9}),
    "view_changed": dict(n=16, capacity=17, n_ticks=40, joins={16: 5},
                         leaves={3: 10}),
    "leaver_crashes": dict(n=16, capacity=16, n_ticks=40, leaves={3: 5},
                           crashes={3: 6}),
}


@pytest.mark.parametrize("name", sorted(CHURN))
def test_churn_differential_equals_reference(name):
    kw = CHURN[name]
    port = diff.run_churn_differential(**kw, device="cpu")
    _same(port, ref_diff.run_churn_differential(**kw))
    assert set(port.seconds) == {"plan", "oracle", "engine"}


@pytest.mark.parametrize("name", sorted(CHURN_REFUSED))
def test_churn_envelope_errors_equal_reference(name):
    kw = CHURN_REFUSED[name]
    _same_error(ChurnEnvelopeError, RefChurnError,
                lambda: diff.run_churn_differential(**kw, device="cpu"),
                lambda: ref_diff.run_churn_differential(**kw))


def test_identifier_redraw_equals_reference():
    """A joiner's first node-id draw burnt into an initial member: the
    phase-1 answer is UUID_ALREADY_IN_RING on every side and the retry
    redraws, in the planner, the oracle and the engine."""
    n, capacity, joiner = 64, 65, 64
    ref_eps = ref_diff.default_endpoints(capacity)
    rng = ref_default_rng(RefSettings(), ref_eps[joiner])
    collide = (rng.getrandbits(64), rng.getrandbits(64))
    port_rng = default_rng(Settings(), diff.default_endpoints(capacity)[joiner])
    assert (port_rng.getrandbits(64), port_rng.getrandbits(64)) == collide
    ref_ids = list(ref_diff.default_node_ids(n))
    ref_ids[3] = type(ref_ids[0])(*collide)
    port_ids = list(diff.default_node_ids(n))
    port_ids[3] = NodeId(*collide)
    kw = dict(n=n, capacity=capacity, n_ticks=40, joins={joiner: 5})
    port = diff.run_churn_differential(**kw, node_ids=port_ids, device="cpu")
    _same(port, ref_diff.run_churn_differential(**kw, node_ids=ref_ids))
    assert [(e.kind, e.tick, e.slots) for e in port.engine_events] == [
        ("proposal", 12, (joiner,)), ("view_change", 13, (joiner,))]


# ---------------------------------------------------------------------------
# run_fallback_differential: contested consensus on the shared engine
# ---------------------------------------------------------------------------

def two_way_split(n):
    return ([[0], [1]], {s: (6, s % 2) for s in range(n)},
            {s: (10 if s == 0 else 100) for s in range(n)})


def three_way_split(n):
    a = n - 2 * (n // 3)
    votes = {s: (6, 0 if s < a else (1 if s < a + n // 3 else 2))
             for s in range(n)}
    return ([[0], [1], [2]], votes,
            {s: (10 if s == n - 1 else 100) for s in range(n)})


def racing_fast_quorum(n):
    q = n - (n - 1) // 4
    votes = {s: (6, 0 if s < q - 1 else 1) for s in range(n - 1)}
    votes[n - 1] = (19, 0)
    delays = {s: 100 for s in range(n)}
    delays[0] = 13
    return [[0], [1]], votes, delays


def mid_fast_count(n=8):
    q = n - (n - 1) // 4
    votes = {s: (6, 0) for s in range(q - 1)}
    votes[n - 1] = (10, 0)
    delays = {s: 100 for s in votes}
    delays[0] = 2
    return [[0], [1]], votes, delays


def tied_first_timers(n=8):
    values, votes, delays = two_way_split(n)
    delays[1] = delays[0]
    return values, votes, delays


def rank_race(n=8):
    values, votes, delays = two_way_split(n)
    delays[1] = delays[0] + 2
    return values, votes, delays


def pre_start_tick(n=8):
    values, votes, delays = two_way_split(n)
    votes[3] = (0, 1)
    return values, votes, delays


CONTESTED = {"two_way_split": two_way_split,
             "three_way_split": three_way_split,
             "racing_fast_quorum": racing_fast_quorum}
CONTESTED_REFUSED = {"mid_fast_count": mid_fast_count,
                     "tied_first_timers": tied_first_timers,
                     "rank_race": rank_race,
                     "pre_start_tick": pre_start_tick}


@pytest.mark.parametrize("name", sorted(CONTESTED))
def test_fallback_differential_equals_reference(name):
    args = (64, *CONTESTED[name](64), 30)
    port = diff.run_fallback_differential(*args, device="cpu")
    _same(port, ref_diff.run_fallback_differential(*args))


@pytest.mark.parametrize("name", sorted(CONTESTED_REFUSED))
def test_fallback_envelope_errors_equal_reference(name):
    args = (8, *CONTESTED_REFUSED[name](), 120)
    _same_error(FallbackEnvelopeError, RefFallbackError,
                lambda: diff.run_fallback_differential(*args, device="cpu"),
                lambda: ref_diff.run_fallback_differential(*args))


# ---------------------------------------------------------------------------
# run_variant_differential: ring and hier
# ---------------------------------------------------------------------------

VARIANTS = {
    "ring_crash": ("ring", {3: 5, 17: 5, 40: 7}, 130, None),
    "hier_crash": ("hier", {3: 5, 17: 5, 40: 7}, 130, None),
    "ring_contested": ("ring", {}, 30, two_way_split(64)),
    "hier_contested": ("hier", {}, 30, two_way_split(64)),
    "rapid_crash": ("rapid", {7: 5}, 130, None),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_differential_equals_reference(name):
    variant, crashes, ticks, contested = VARIANTS[name]
    port = diff.run_variant_differential(64, crashes, ticks, variant,
                                         contested=contested, device="cpu")
    _same(port, ref_diff.run_variant_differential(
        64, crashes, ticks, variant, contested=contested))


def _skewed_burst(n=64):
    """The reference's hier-envelope scenario (``test_variants.py``):
    crashes that break two groups' quorums while the flat quorum holds."""
    uids = np.asarray([ref_diff.uid_of(e)
                       for e in ref_diff.default_endpoints(n)], np.uint64)
    hi = (uids >> np.uint64(32)).astype(np.uint32)
    lo = (uids & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    n_groups = ref_hier.hier_group_count(n)
    gid = np.asarray(ref_hier.group_ids(np, hi, lo, n_groups))
    crashes, broken = {}, 0
    for g in np.argsort(np.bincount(gid, minlength=n_groups)):
        members = np.nonzero(gid == g)[0]
        need = (len(members) - 1) // 4 + 1
        if len(members) == 0 or \
                len(crashes) + need > (n - 1) // 4:
            continue
        for s in members[:need]:
            crashes[int(s)] = 5
        broken += 1
        if broken == 2:
            break
    assert broken == 2
    return crashes


def test_variant_envelope_errors_equal_reference():
    crashes = _skewed_burst()
    _same_error(VariantEnvelopeError, RefVariantError,
                lambda: diff.run_variant_differential(
                    64, crashes, 130, "hier", device="cpu"),
                lambda: ref_diff.run_variant_differential(
                    64, crashes, 130, "hier"))
    _same_error(ValueError, ValueError,
                lambda: diff.run_variant_differential(
                    64, {7: 5}, 30, "ring", contested=two_way_split(64),
                    device="cpu"),
                lambda: ref_diff.run_variant_differential(
                    64, {7: 5}, 30, "ring", contested=two_way_split(64)))


# ---------------------------------------------------------------------------
# run_adversarial_differential: the host adversary engine against the oracle
# ---------------------------------------------------------------------------

def _one_way(n, iso, start=3):
    return ref_faults.LinkWindow(src_slots=frozenset(range(n)) - iso,
                                 dst_slots=iso, start_tick=start)


def _scripted(n, values, votes, delays, seed=11):
    return ref_faults.AdversarySchedule(n=n, seed=seed, proposes=tuple(
        ref_faults.ScriptedPropose(slot=s, tick=tick,
                                   proposal=tuple(values[pid]),
                                   delay_ticks=delays[s])
        for s, (tick, pid) in sorted(votes.items())))


def _crash_delay(n, delays, seed=5, windows=()):
    return ref_faults.AdversarySchedule(
        n=n, crashes=((n - 1, 11),), windows=windows, delays=tuple(delays),
        seed=seed)


def _slow_voters(n, n_slow, delay, start=100, seed=9):
    return ref_faults.AdversarySchedule(
        n=n, crashes=((5, 11),), seed=seed,
        delays=(ref_faults.DelayRule(
            src_slots=frozenset(range(n - n_slow, n)),
            dst_slots=frozenset(range(n)), delay_ticks=delay,
            start_tick=start),))


DR = ref_faults.DelayRule
ADVERSARIAL = {
    "single_crash_n8": (ref_faults.AdversarySchedule(
        n=8, crashes=((3, 5),), seed=1), 160, None),
    "straddling_n64": (ref_faults.AdversarySchedule(
        n=64, crashes=((1, 5), (2, 5), (40, 15), (41, 15)), seed=2),
        260, None),
    "one_way_classic_n64": (ref_faults.AdversarySchedule(
        n=64, windows=(_one_way(64, frozenset(range(44, 64))),), seed=7),
        300, None),
    "flip_flop_n8": (ref_faults.AdversarySchedule(
        n=8, crashes=((6, 9),), seed=13, windows=(ref_faults.LinkWindow(
            src_slots=frozenset({0, 1, 2}), dst_slots=frozenset({5, 6}),
            start_tick=4, end_tick=140, period_ticks=7, two_way=True),)),
        220, None),
    "random_seed0_n16": (ref_faults.random_adversary_schedule(16, 0, 300),
                         300, None),
    "random_seed1_n16": (ref_faults.random_adversary_schedule(16, 1, 300),
                         300, None),
    "scripted_mix_n8": (ref_faults.AdversarySchedule(
        n=8, crashes=((7, 25),), seed=21, proposes=(
            ref_faults.ScriptedPropose(slot=0, tick=20, proposal=(5,),
                                       delay_ticks=12),
            ref_faults.ScriptedPropose(slot=1, tick=20, proposal=(6,),
                                       delay_ticks=12))), 200, None),
    "mid_fast_count_n8": (_scripted(8, *mid_fast_count()), 120, None),
    "tied_timers_n8": (_scripted(8, *tied_first_timers()), 120, None),
    "rank_race_n8": (_scripted(8, *rank_race()), 120, None),
    "delay_only_n64": (_crash_delay(64, [DR(
        src_slots=frozenset(range(12)), dst_slots=frozenset(range(12, 64)),
        delay_ticks=2)]), 200, None),
    "slow_link_n16": (_slow_voters(16, 6, 30), 400, 32),
    "cross_phase_n64": (_slow_voters(64, 16, 30), 400, 32),
}


@pytest.mark.parametrize("name", sorted(ADVERSARIAL))
def test_adversarial_differential_equals_reference(name):
    ref_sched, ticks, ring = ADVERSARIAL[name]
    port_settings, ref_settings = Settings(), RefSettings()
    if ring is not None:
        port_settings = port_settings.with_(delivery_ring_depth=ring)
        ref_settings = ref_settings.with_(delivery_ring_depth=ring)
    port = diff.run_adversarial_differential(
        convert.schedule_from_reference(ref_sched), ticks, port_settings)
    _same(port, ref_diff.run_adversarial_differential(ref_sched, ticks,
                                                      ref_settings))
    assert set(port.seconds) == {"oracle", "referee"}


# ---------------------------------------------------------------------------
# run_lineage_differential: phase-attributed spans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, pytest.param(256, marks=pytest.mark.slow)])
@pytest.mark.parametrize("family", ref_diff.LINEAGE_FAMILIES)
def test_lineage_differential_equals_reference(family, n):
    port = diff.run_lineage_differential(family, n, device="cpu")
    _same(port, ref_diff.run_lineage_differential(family, n))
    assert diff.LINEAGE_FAMILIES == ref_diff.LINEAGE_FAMILIES
