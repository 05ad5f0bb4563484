"""The port's classic-Paxos fallback of the shared engine against the JAX
reference: the coordinator rule and the four device phases
(``chain_deliver``, ``fast_tally``, ``phase1a_deliver``, ``task_phase``)
on states that fire them; the host half (``plan_fallback`` and its
envelope errors, ``synthetic_contested_schedule``); and whole runs of
``step.simulate(..., fallback=)``, alone and with ``churn=``, every
``StepLog`` field at every tick and every final-state field. Everything
is integer or bool: the tolerance is exact."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_tpu.engine import churn as ref_churn
from rapid_tpu.engine import diff as ref_diff
from rapid_tpu.engine import paxos as ref_paxos
from rapid_tpu.engine.state import crash_faults as ref_crash_faults
from rapid_tpu.engine.state import init_state as ref_init_state
from rapid_tpu.oracle.membership_view import MembershipView, uid_of
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch import device
from rapid_tpu_torch.convert import from_reference, to_numpy
from rapid_tpu_torch.engine import diff, paxos, step
from rapid_tpu_torch.engine.state import I32_MAX
from rapid_tpu_torch.settings import Settings

ref_step = importlib.import_module("rapid_tpu.engine.step")
SETTINGS = RefSettings()


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


def _same_scalars(port: dict, ref: dict):
    assert sorted(port) == sorted(ref)
    for key in ref:
        assert port[key].dtype == torch.int32, key
        assert int(port[key]) == int(ref[key]), key


# ---------------------------------------------------------------------------
# the contested scenarios of tests/test_fallback_engine.py
# ---------------------------------------------------------------------------


def two_way_split(n):
    values = [[0], [1]]
    votes = {s: (6, s % 2) for s in range(n)}
    delays = {s: (10 if s == 0 else 100) for s in range(n)}
    return values, votes, delays, 30


def three_way_split(n):
    a = n - 2 * (n // 3)
    values = [[0], [1], [2]]
    votes = {s: (6, 0 if s < a else (1 if s < a + n // 3 else 2))
             for s in range(n)}
    delays = {s: (10 if s == n - 1 else 100) for s in range(n)}
    return values, votes, delays, 30


def fallback_racing_fast_quorum(n):
    q = n - (n - 1) // 4
    values = [[0], [1]]
    votes = {s: (6, 0 if s < q - 1 else 1) for s in range(n - 1)}
    votes[n - 1] = (19, 0)
    delays = {s: 100 for s in range(n)}
    delays[0] = 13
    return values, votes, delays, 30


SCENARIOS = {
    "two_way_split": two_way_split,
    "three_way_split": three_way_split,
    "racing_fast_quorum": fallback_racing_fast_quorum,
}


def _uids(n):
    return np.asarray([uid_of(e) for e in ref_diff.default_endpoints(n)],
                      np.uint64)


def _boot(scenario, n):
    values, votes, delays, ticks = SCENARIOS[scenario](n)
    sched, info = ref_paxos.plan_fallback(n, values, votes, delays,
                                          SETTINGS, uids=_uids(n))
    id_fp_sum = MembershipView(SETTINGS.K, ref_diff.default_node_ids(n),
                               [])._id_fp_sum
    state = ref_init_state(_uids(n), id_fp_sum, SETTINGS)
    return state, ref_crash_faults([I32_MAX] * n), sched, info, ticks


def _schedule_equal(port, ref):
    for field in ref._fields:
        a, b = np.asarray(getattr(port, field)), np.asarray(getattr(ref,
                                                                    field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a, b), field


# ---------------------------------------------------------------------------
# the coordinator rule
# ---------------------------------------------------------------------------

RULE_CASES = {
    # promised, vval (-1 = no value), n, n_pids
    "no_values": ([1, 1, 1, 1, 0, 1], [-1] * 6, 6, 2),
    "no_promises": ([0] * 6, [0, 1, 0, 1, 0, 1], 6, 2),
    "single_value": ([1, 1, 1, 1, 1, 0], [1, -1, 1, 1, -1, 0], 6, 3),
    "tie_first_voted": ([1] * 8, [0, 1, 0, 1, 1, 0, -1, -1], 16, 2),
    "n4_crossing": ([1] * 12, [1, 0, 0, 1, 0, 1, 1, 0, 0, 0, 1, 1], 12, 2),
    "first_value_late": ([1] * 10, [-1] * 7 + [2, 1, 2], 10, 3),
}


def _rule_inputs(promised, vval, pos_perm_seed):
    c = len(promised)
    pos = np.random.default_rng(pos_perm_seed).permutation(c).astype(
        np.int32)
    return (np.asarray(promised, bool), pos, np.asarray(vval, np.int32))


@pytest.mark.parametrize("case", sorted(RULE_CASES))
@pytest.mark.parametrize("perm_seed", [0, 1, 2])
def test_coordinator_rule_equals_reference(case, perm_seed):
    promised, vval, n, n_pids = RULE_CASES[case]
    promised, pos, vval = _rule_inputs(promised, vval, perm_seed)
    want = ref_paxos.coordinator_rule_pid(
        jnp, jnp.asarray(promised), jnp.asarray(pos), jnp.asarray(vval),
        jnp.int32(n), n_pids)
    got = paxos.coordinator_rule_pid(
        torch.from_numpy(promised), torch.from_numpy(pos),
        torch.from_numpy(vval), torch.tensor(n, dtype=torch.int32), n_pids)
    assert got.dtype == torch.int32 and got.shape == ()
    assert int(got) == int(want)
    if case in ("no_values", "no_promises"):
        assert int(got) == -1


def test_coordinator_rule_on_random_promises_equals_reference():
    rng = np.random.default_rng(5)
    for trial in range(40):
        c = (12, 33)[trial % 2]           # two shapes: one compile each
        n_pids = 1 + trial % 3
        promised = rng.random(c) < 0.8
        vval = np.where(rng.random(c) < 0.6,
                        rng.integers(0, n_pids, c), -1).astype(np.int32)
        pos = rng.permutation(c).astype(np.int32)
        n = int(rng.integers(1, c + 1))
        want = ref_paxos.coordinator_rule_pid(
            jnp, jnp.asarray(promised), jnp.asarray(pos), jnp.asarray(vval),
            jnp.int32(n), n_pids)
        got = paxos.coordinator_rule_pid(
            torch.from_numpy(promised), torch.from_numpy(pos),
            torch.from_numpy(vval), torch.tensor(n, dtype=torch.int32),
            n_pids)
        assert int(got) == int(want), trial


# ---------------------------------------------------------------------------
# the device phases, on the reference's states tick by tick
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["two_way_split", "three_way_split"])
def tick_states(request):
    """The reference's state after each tick 0..22 (index = tick) of a
    classic round at N=64: proposes at 6, the fire at 16, 1a lands at 17,
    1b at 18, 2a at 19, 2b decides at 20."""
    state, faults, sched, info, _ = _boot(request.param, 64)
    states = [state]
    jsched = type(sched)(*[jnp.asarray(x) for x in sched])
    for _ in range(22):
        state, _ = ref_step.engine_step(state, faults, SETTINGS, None,
                                        jsched)
        states.append(state)
    assert info["mode"] == "classic" and info["decide_tick"] == 20
    return states, jsched, from_reference(sched, device="cpu")


def _n(state):
    return np.asarray(state.member).sum().astype(np.int32)


@pytest.mark.parametrize("t", [7, 16, 17, 18, 19, 20])
def test_chain_deliver_equals_reference(tick_states, t):
    states, jsched, sched = tick_states
    ref_state = states[t - 1]
    n = _n(ref_state)
    want = ref_paxos.chain_deliver(jnp, ref_state, jsched, t, jnp.int32(n))
    got = paxos.chain_deliver(from_reference(ref_state, device="cpu"), sched,
                              t, torch.tensor(n))
    _assert_same(got[0], want[0])
    _same_scalars(got[1], want[1])
    assert bool(got[2]) == bool(want[2]) == (t == 20)
    assert int(got[3]) == int(want[3])
    if t == 19:
        assert int(got[1]["px2b_senders"]) == 64


@pytest.mark.parametrize("t", [6, 7, 12])
def test_fast_tally_equals_reference(tick_states, t):
    states, jsched, sched = tick_states
    ref_state = states[t - 1]
    n = _n(ref_state)
    for blocked in (False, True):
        want = ref_paxos.fast_tally(jnp, ref_state, jsched, t, jnp.int32(n),
                                    jnp.asarray(blocked))
        ok, win_pid, tally, quorum = paxos.fast_tally(
            from_reference(ref_state, device="cpu"), sched, 0, t,
            torch.tensor(n))
        assert bool(ok & ~torch.tensor(blocked)) == bool(want[0])
        assert int(win_pid) == int(want[1])
        assert int(tally) == int(want[2]) and int(quorum) == int(want[3])
        assert tally.dtype == quorum.dtype == torch.int32
    assert int(tally) == (0 if t == 6 else int(want[2]))


@pytest.mark.parametrize("t", [16, 17, 18])
def test_phase1a_deliver_equals_reference(tick_states, t):
    states, jsched, sched = tick_states
    ref_state = states[t - 1]
    want_state, want = ref_paxos.phase1a_deliver(
        jnp, ref_state, jsched, t, jnp.int32(_n(ref_state)),
        jnp.asarray(False))
    got_state, px1b = paxos.phase1a_deliver(
        from_reference(ref_state, device="cpu"), t)
    _assert_same(got_state, want_state)
    _same_scalars({"px1b_senders": px1b}, want)
    assert (int(px1b) == 64) == (t == 17)


@pytest.mark.parametrize("t", [5, 6, 16])
def test_task_phase_equals_reference(tick_states, t):
    states, jsched, sched = tick_states
    ref_state = states[t - 1]
    n = _n(ref_state)
    want_state, want = ref_paxos.task_phase(
        jnp, ref_state, jsched, t, jnp.int32(n), jnp.asarray(False))
    got_state, got = paxos.task_phase(
        from_reference(ref_state, device="cpu"), sched, 0, t,
        torch.tensor(n), True, True)
    _assert_same(got_state, want_state)
    _same_scalars(got, want)
    assert int(got["pxvote_senders"]) == (64 if t == 6 else 0)
    assert int(got["px1a_senders"]) == (1 if t == 16 else 0)


# ---------------------------------------------------------------------------
# the host half
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_plan_fallback_equals_reference(scenario, n):
    values, votes, delays, _ = SCENARIOS[scenario](n)
    want, want_info = ref_paxos.plan_fallback(n, values, votes, delays,
                                              SETTINGS, uids=_uids(n))
    got, got_info = paxos.plan_fallback(n, values, votes, delays,
                                        Settings(), uids=_uids(n))
    _schedule_equal(got, want)
    assert got_info == want_info
    # Default identities: the port's own endpoint hashes.
    got, got_info = paxos.plan_fallback(n, values, votes, delays,
                                        Settings(), epoch=3)
    want, want_info = ref_paxos.plan_fallback(n, values, votes, delays,
                                              SETTINGS, epoch=3)
    _schedule_equal(got, want)
    assert got_info == want_info


def _base(n=8):
    values = [[0], [1]]
    votes = {s: (6, s % 2) for s in range(n)}
    delays = {s: (10 if s == 0 else 100) for s in range(n)}
    return values, votes, delays


def _envelope_cases():
    n = 8
    q = n - (n - 1) // 4
    mid_count = ([[0], [1]], {**{s: (6, 0) for s in range(q - 1)},
                              n - 1: (10, 0)},
                 {**{s: 100 for s in range(q - 1)}, n - 1: 100, 0: 2})
    tied = _base()
    tied[2][1] = tied[2][0]
    race = _base()
    race[2][1] = race[2][0] + 2
    pre = _base()
    pre[1][3] = (0, 1)
    late = _base()
    late[1][5] = (16, 1)
    return {
        "mid_fast_count": (mid_count, {}, "before the fast"),
        "tied_first_timers": (tied, {}, "unique first"),
        "rank_race": (race, {}, "rank race"),
        "pre_start_tick": (pre, {}, "tick >= 1"),
        "non_member_voter": (_base(), {"member": np.arange(8) != 5},
                             "not a member"),
        "late_propose": (late, {}, "mid-classic-round"),
        "no_values": (([], *_base()[1:]), {}, "at least one"),
        "empty_value": (([[0], []], *_base()[1:]), {}, "empty"),
        "removes_non_member": (([[0], [9]], *_base()[1:]), {},
                               "non-member"),
        "unknown_pid": (([[0]], *_base()[1:]), {}, "unknown pid"),
        "missing_delay": ((_base()[0], _base()[1], {0: 10}), {},
                          "no fallback delay"),
        "zero_delay": ((_base()[0], _base()[1],
                        {s: 0 for s in range(8)}), {}, ">= 1"),
    }


@pytest.mark.parametrize("case", sorted(_envelope_cases()))
def test_envelope_errors_match_reference(case):
    (values, votes, delays), kw, match = _envelope_cases()[case]
    with pytest.raises(ref_paxos.FallbackEnvelopeError, match=match):
        ref_paxos.plan_fallback(8, values, votes, delays, SETTINGS, **kw)
    with pytest.raises(paxos.FallbackEnvelopeError, match=match):
        paxos.plan_fallback(8, values, votes, delays, Settings(), **kw)


def test_ring0_positions_and_host_rule_equal_reference():
    rng = np.random.default_rng(3)
    uids = _uids(40)
    for _ in range(5):
        member = rng.random(40) < 0.8
        pos = paxos.np_ring0_positions(uids, member)
        assert pos.dtype == np.int32
        assert np.array_equal(pos, ref_paxos.np_ring0_positions(uids,
                                                                member))
        voters = [int(s) for s in np.nonzero(member)[0]]
        votes = {s: int(rng.integers(3)) for s in voters}
        positions = {s: int(pos[s]) for s in voters}
        n = len(voters)
        assert paxos.host_coordinator_rule(n, positions, votes) == \
            ref_paxos.host_coordinator_rule(n, positions, votes)
    assert paxos.host_coordinator_rule(4, {}, {}) == -1


@pytest.mark.parametrize("n,ticks", [(32, 70), (1000, 160)])
def test_synthetic_contested_schedule_equals_reference(n, ticks):
    want, want_info = ref_paxos.synthetic_contested_schedule(
        n, SETTINGS, ticks, uids=_uids(n))
    got, got_info = paxos.synthetic_contested_schedule(
        n, Settings(), ticks, uids=_uids(n))
    _schedule_equal(got, want)
    assert got_info == want_info
    assert got_info["instances"] >= 2


def test_empty_and_concatenated_schedules_equal_reference():
    _schedule_equal(paxos.empty_fallback_schedule(9, 2, 3),
                    ref_paxos.empty_fallback_schedule(9, 2, 3))
    parts = [paxos.empty_fallback_schedule(5, 1, 2) for _ in range(3)]
    ref_parts = [ref_paxos.empty_fallback_schedule(5, 1, 2)
                 for _ in range(3)]
    _schedule_equal(paxos.concat_schedules(parts),
                    ref_paxos.concat_schedules(ref_parts))


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------


def _port_run(state, faults, ticks, fallback=None, churn_sched=None):
    before = device.host_reads
    got = step.simulate(
        from_reference(state, device="cpu"),
        from_reference(faults, device="cpu"), ticks, Settings(),
        churn=None if churn_sched is None else from_reference(
            churn_sched, device="cpu"),
        fallback=None if fallback is None else from_reference(
            fallback, device="cpu"), device="cpu")
    return got, device.host_reads - before


@pytest.fixture(scope="module",
                params=[(s, n) for n in (64, 256) for s in sorted(SCENARIOS)],
                ids=lambda p: f"{p[0]}-n{p[1]}")
def runs(request):
    scenario, n = request.param
    state, faults, sched, info, ticks = _boot(scenario, n)
    want = ref_step.simulate(state, faults, ticks, SETTINGS, fallback=sched)
    got, reads = _port_run(state, faults, ticks, fallback=sched)
    return request.param, info, want, got, reads


def test_fallback_logs_equal_the_reference_at_every_tick(runs):
    _, _, (_, ref_logs), (_, port_logs), _ = runs
    _assert_same(port_logs, ref_logs)


def test_fallback_final_state_equals_the_reference(runs):
    _, _, (ref_final, _), (port_final, _), _ = runs
    _assert_same(port_final, ref_final)


def test_fallback_events_and_counters_equal_the_reference(runs):
    (_, n), info, (_, ref_logs), (_, port_logs), _ = runs
    events = [e.as_dict() for e in diff.engine_events(port_logs)]
    assert events == [e.as_dict() for e in ref_diff.engine_events(ref_logs)]
    assert diff.expand_counters(port_logs) == \
        ref_diff.expand_counters(ref_logs)
    phases = diff.expand_fallback_counters(port_logs)
    assert phases == ref_diff.expand_fallback_counters(ref_logs)
    assert [e["tick"] for e in events] == [info["decide_tick"]]
    assert sum(row["phase1a_sent"] for row in phases) == n
    if info["mode"] == "classic":
        assert sum(row["phase2b_sent"] for row in phases) == n * n
    else:
        assert sum(row["phase1b_sent"] for row in phases) == 0


def test_fallback_host_reads_per_tick(runs):
    """One read at start and one for the first tick's vote-arrival bit;
    then per tick the announce read, one read when the scripted fast
    round's tally changes, and one on the tick a phase 2b can land."""
    (_, _), info, (_, ref_logs), _, reads = runs
    ticks = len(np.asarray(ref_logs.tick))
    assert reads <= 2 * ticks
    arrival_ticks = 2 if info["mode"] == "fast" else 1
    classic_ticks = 1 if info["mode"] == "classic" else 0
    assert reads == 2 + ticks + arrival_ticks + classic_ticks


@pytest.mark.parametrize("split", [6, 15, 16, 17, 18, 19])
def test_fallback_run_resumed_mid_round_equals_reference(split):
    """The port resumed from the reference's state at ``split`` (around
    the proposes at 6, the fire at 16 and the chain 17-20) ends where the
    reference's whole run does."""
    state, faults, sched, _, ticks = _boot("two_way_split", 64)
    head, _ = ref_step.simulate(state, faults, split, SETTINGS,
                                fallback=sched)
    want, want_logs = ref_step.simulate(state, faults, ticks, SETTINGS,
                                        fallback=sched)
    (got, got_logs), _ = _port_run(head, faults, ticks - split,
                                   fallback=sched)
    _assert_same(got, want)
    for field in ("decide_now", "px2b_senders", "px_timers_armed",
                  "quorum", "vote_tally"):
        assert np.array_equal(getattr(got_logs, field).numpy(),
                              np.asarray(getattr(want_logs, field))[split:])


def test_synthetic_contested_run_equals_reference():
    n, ticks = 32, 70
    sched, info = ref_paxos.synthetic_contested_schedule(
        n, SETTINGS, ticks, uids=_uids(n))
    state = ref_init_state(_uids(n), 0, SETTINGS)
    faults = ref_crash_faults([I32_MAX] * n)
    want = ref_step.simulate(state, faults, ticks, SETTINGS, fallback=sched)
    (got, got_logs), _ = _port_run(state, faults, ticks, fallback=sched)
    _assert_same(got_logs, want[1])
    _assert_same(got, want[0])
    decided = [e.tick for e in diff.engine_events(got_logs)
               if e.kind == "view_change"]
    assert decided == info["decide_ticks"]


def _churn_and_fallback(n=64, capacity=68, ticks=70):
    """Joins of slots 64-67 enqueued at 8 (epoch 0, decided at 11), a
    two-way contested instance live at epoch 1 (proposes at 20, the fire
    at 30, decided by the classic round at 34), then leaves of 64 and 65
    enqueued at 45 (epoch 2)."""
    uids = _uids(capacity)
    sched = ref_churn.empty_schedule(capacity)
    sched.join_tick[n:] = 8
    sched.leave_tick[[64, 65]] = 45
    sched.leave_epoch[[64, 65]] = 2
    id_fps = np.zeros(capacity, np.uint64)
    id_fps[n:] = np.arange(1, capacity - n + 1, dtype=np.uint64) * 0x9E37
    votes = {s: (20, s % 2) for s in range(capacity)}
    delays = {s: (10 if s == 0 else 100) for s in range(capacity)}
    fallback, info = ref_paxos.plan_fallback(
        capacity, [[0], [1]], votes, delays, SETTINGS, uids=uids, epoch=1)
    port_fallback, port_info = paxos.plan_fallback(
        capacity, [[0], [1]], votes, delays, Settings(), uids=uids, epoch=1)
    _schedule_equal(port_fallback, fallback)
    assert port_info == info
    state = ref_init_state(uids, 0, SETTINGS,
                           member=np.arange(capacity) < n, id_fps=id_fps)
    return state, ref_crash_faults([I32_MAX] * capacity), sched, fallback


def test_churn_and_fallback_together_equal_reference():
    state, faults, sched, fallback = _churn_and_fallback()
    want = ref_step.simulate(state, faults, 70, SETTINGS, churn=sched,
                             fallback=fallback)
    (got, got_logs), _ = _port_run(state, faults, 70, fallback=fallback,
                                   churn_sched=sched)
    _assert_same(got_logs, want[1])
    _assert_same(got, want[0])
    decides = [(e.tick, e.slots) for e in diff.engine_events(got_logs)
               if e.kind == "view_change"]
    assert [tick for tick, _ in decides] == [11, 34, 48]
    assert decides[0][1] == (64, 65, 66, 67)
    assert decides[2][1] == (64, 65)
    assert int(got_logs.px2b_senders.sum()) > 0


def test_simulate_refuses_a_fallback_on_another_device():
    state, faults, sched, _, _ = _boot("two_way_split", 64)
    port = from_reference(sched, device="cpu")
    with pytest.raises(ValueError, match="fallback schedule lives on meta"):
        step.simulate(from_reference(state, device="cpu"),
                      from_reference(faults, device="cpu"), 2, Settings(),
                      fallback=port._replace(
                          prop_tick=port.prop_tick.to("meta")),
                      device="cpu")
