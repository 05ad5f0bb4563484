"""The port's host oracle and host adversary engine against the reference's.

The same scenario, built from the same inputs, runs through each
package's own classes and must give equal records (``convert.plain``):

- ``FastPaxos`` and ``Paxos`` over the test kit (``DirectMessagingClient``,
  ``DirectBroadcaster``, ``ManualScheduler``) on the scenarios of
  ``tests/test_paxos.py``: every node's decision, and the coordinator
  rule's choice;
- whole simulated clusters (``Cluster``, ``MembershipService``,
  ``SimNetwork``) on the scenarios of ``tests/test_cluster_sim.py``:
  every tick's counters (``tick_history``), per-phase consensus counters
  (``consensus_history``), each node's view-change events, member list
  and configuration id;
- the churn differential of ``tests/test_service.py`` (its traffic
  generator's joins and leaves);
- ``AdversaryEngine.run`` on the N=64 schedules of ``tests/test_adversary.py``
  and ``tests/test_delay.py``: every ``AdversaryRun`` field and its
  metrics rows;
- the fault models, mask for mask.

Everything is integer: the tolerance is exact. Node ids drawn from
``default_rng`` hash a salted ``str``; both packages run in this process
under one salt.
"""
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import rapid_tpu.engine.adversary as ref_adversary
import rapid_tpu.engine.diff as ref_diff
import rapid_tpu.events as ref_events
import rapid_tpu.faults as ref_faults
import rapid_tpu.oracle.cluster as ref_cluster
import rapid_tpu.oracle.paxos as ref_paxos
import rapid_tpu.oracle.simulation as ref_simulation
import rapid_tpu.oracle.testkit as ref_testkit
import rapid_tpu.settings as ref_settings
import rapid_tpu.types as ref_types
from rapid_tpu.service.traffic import TrafficConfig, TrafficGenerator

import rapid_tpu_torch.engine.adversary as adversary
import rapid_tpu_torch.engine.diff as diff
import rapid_tpu_torch.events as events
import rapid_tpu_torch.faults as faults
import rapid_tpu_torch.oracle.cluster as cluster
import rapid_tpu_torch.oracle.paxos as paxos
import rapid_tpu_torch.oracle.simulation as simulation
import rapid_tpu_torch.oracle.testkit as testkit
import rapid_tpu_torch.settings as settings
import rapid_tpu_torch.types as types
from rapid_tpu_torch import convert
from rapid_tpu_torch.identity import default_identities

REF = SimpleNamespace(cluster=ref_cluster, paxos=ref_paxos,
                      sim=ref_simulation, testkit=ref_testkit,
                      faults=ref_faults, types=ref_types, events=ref_events,
                      Settings=ref_settings.Settings)
PORT = SimpleNamespace(cluster=cluster, paxos=paxos, sim=simulation,
                       testkit=testkit, faults=faults, types=types,
                       events=events, Settings=settings.Settings)


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _same(scenario, *args):
    got = convert.plain(scenario(PORT, *args))
    want = convert.plain(scenario(REF, *args))
    assert got == want


# ---------------------------------------------------------------------------
# Fast Paxos and classic Paxos over the test kit (tests/test_paxos.py)
# ---------------------------------------------------------------------------

def _instances(P, n, drop=(), seed=123):
    decisions = {}
    instances = {}
    client = P.testkit.DirectMessagingClient(
        instances, drop_types={getattr(P.types, t) for t in drop})
    broadcaster = P.testkit.DirectBroadcaster(instances, client)
    scheduler = P.testkit.ManualScheduler()
    rng = random.Random(seed)
    for i in range(n):
        addr = P.types.Endpoint("127.0.0.1", 1234 + i)
        instances[addr] = P.paxos.FastPaxos(
            addr, configuration_id=1, membership_size=n, client=client,
            broadcaster=broadcaster, scheduler=scheduler,
            on_decide=lambda hosts_, a=addr: decisions.__setitem__(
                a, tuple(hosts_)), rng=rng)
    return instances, scheduler, decisions


def _hosts(P, *specs):
    return tuple(P.types.Endpoint.parse(s) for s in specs)


def paxos_single_propose(P, n):
    instances, scheduler, decisions = _instances(P, n)
    next(iter(instances.values())).propose(
        list(_hosts(P, "172.14.12.3:1234")), recovery_delay_ticks=5)
    scheduler.advance_by(10)
    return decisions


def paxos_different_proposals(P, n):
    instances, scheduler, decisions = _instances(P, n)
    for addr, fp in instances.items():
        fp.propose([addr], recovery_delay_ticks=10)
    scheduler.advance_by(1000)
    return decisions


def paxos_organic_timers(P, n):
    """Every node proposes its own address with the expovariate timer
    drawn from the shared rng."""
    instances, scheduler, decisions = _instances(P, n, seed=7)
    for addr, fp in instances.items():
        fp.propose([addr])
    scheduler.advance_by(5000)
    return decisions


def paxos_mixed_values(P, n, p2_votes):
    instances, _, decisions = _instances(
        P, n, drop=("FastRoundPhase2bMessage",))
    p1 = _hosts(P, "127.0.0.1:5891", "127.0.0.1:5821")
    p2 = _hosts(P, "127.0.0.1:5821", "127.0.0.1:5872")
    for i, fp in enumerate(instances.values()):
        fp.propose(list(p1 if i < n - p2_votes else p2),
                   recovery_delay_ticks=10**9)
    for fp in instances.values():
        fp.start_classic_paxos_round()
    return decisions


def coordinator_rule(P, n, seed):
    """The coordinator rule on shuffled phase-1b quorums of mixed vrnds."""
    rng = random.Random(seed)
    values = [_hosts(P, "127.0.0.1:5891"), _hosts(P, "127.0.0.1:5821"),
              _hosts(P, "127.0.0.1:5872", "127.0.0.1:1")]
    me = P.types.Endpoint("127.0.0.1", 1)
    px = P.paxos.Paxos(me, 1, n, P.testkit.NoOpClient(),
                       P.testkit.NoOpBroadcaster(), lambda hosts_: None)
    out = []
    for _ in range(40):
        msgs = [P.types.Phase1bMessage(
            P.types.Endpoint("127.0.0.1", 2000 + i), 1,
            P.types.Rank(3, 3),
            P.types.Rank(rng.choice((1, 2)), rng.choice((1, 7))),
            rng.choice(values + [()]))
            for i in range(n // 2 + 1)]
        out.append(px.select_proposal_using_coordinator_rule(msgs))
    return out, P.paxos.classic_rank_node_index(me)


PAXOS = {
    **{f"single_propose_n{n}": (paxos_single_propose, n)
       for n in (5, 6, 10, 11, 20)},
    **{f"different_proposals_n{n}": (paxos_different_proposals, n)
       for n in (5, 6, 10, 11, 20)},
    **{f"organic_timers_n{n}": (paxos_organic_timers, n) for n in (8, 20)},
    **{f"mixed_n{n}_p2x{v}": (paxos_mixed_values, n, v)
       for n, v in ((6, 5), (6, 1), (6, 4), (6, 2), (5, 4), (10, 4),
                    (10, 1))},
    **{f"coordinator_rule_n{n}": (coordinator_rule, n, n)
       for n in (5, 6, 10, 11)},
}


@pytest.mark.parametrize("name", sorted(PAXOS))
def test_paxos_equals_reference(name):
    scenario, *args = PAXOS[name]
    _same(scenario, *args)


# ---------------------------------------------------------------------------
# whole simulated clusters (tests/test_cluster_sim.py)
# ---------------------------------------------------------------------------

def _ep(P, i):
    return P.types.Endpoint("10.0.0.1", 1234 + i)


class _Run:
    """A network and its clusters, every node's events recorded."""

    def __init__(self, P, fault_model=None):
        self.P = P
        s = P.Settings()
        self.net = P.sim.SimNetwork(s) if fault_model is None else \
            P.sim.SimNetwork(s, fault_model)
        self.clusters = []
        self.seen = []

    def add(self, i, join=True, **kw):
        c = self.P.cluster.Cluster(self.net, _ep(self.P, i), **kw)
        for kind in ("VIEW_CHANGE_PROPOSAL", "VIEW_CHANGE", "KICKED"):
            c.register_subscription(
                getattr(self.P.events.ClusterEvents, kind),
                lambda ch, k=kind, a=c.listen_address: self.seen.append(
                    (self.net.tick, k, a, ch)))
        self.clusters.append(c)
        return c.join(_ep(self.P, 0)) if join else c.start()

    def until(self, predicate, max_ticks):
        for _ in range(max_ticks):
            if predicate():
                return True
            self.net.step()
        return predicate()

    def boot(self, n, parallel=False):
        self.add(0, join=False)
        for i in range(1, n):
            c = self.add(i)
            if not parallel:
                assert self.until(lambda: c.is_active, 500)
        assert self.until(lambda: all(
            c.is_active and c.get_membership_size() == n
            for c in self.clusters), 3000)

    def record(self):
        return {
            "tick": self.net.tick,
            "tick_history": self.net.tick_history,
            "consensus_history": self.net.consensus_history,
            "seen": self.seen,
            "views": [(c.get_memberlist(), c.get_configuration_id(),
                       c.get_cluster_metadata())
                      if c.is_active else None for c in self.clusters],
        }


def cluster_joins(P, n, parallel):
    run = _Run(P)
    run.boot(n, parallel)
    return run.record()


def cluster_metadata(P):
    run = _Run(P)
    run.add(0, join=False, metadata={"role": b"seed"})
    joiner = run.add(1, metadata={"role": b"worker"})
    assert run.until(lambda: joiner.is_active, 200)
    return run.record()


def cluster_crash(P, n, victims):
    crash = P.faults.CrashFault()
    run = _Run(P, crash)
    run.boot(n)
    for v in victims:
        crash.crashes[_ep(P, v)] = run.net.tick + 1
    survivors = [c for i, c in enumerate(run.clusters) if i not in victims]
    assert run.until(lambda: all(c.get_membership_size() == n - len(victims)
                                 for c in survivors), 3000)
    return run.record()


def cluster_one_way(P, n=8, target=3):
    part = P.faults.OneWayPartitionFault()
    run = _Run(P, part)
    run.boot(n)
    part.from_set = frozenset(_ep(P, i) for i in range(n) if i != target)
    part.to_set = frozenset({_ep(P, target)})
    part.start_tick = run.net.tick + 1
    assert run.until(lambda: run.clusters[0].get_membership_size() == n - 1,
                     3000)
    return run.record()


def cluster_kicked(P):
    fd = P.testkit.StaticFailureDetector()
    run = _Run(P)
    run.add(0, join=False, fd_factory=fd)
    for i in range(1, 5):
        c = run.add(i, fd_factory=fd)
        assert run.until(lambda: c.is_active, 500)
    fd.add_failed_nodes([_ep(P, 2)])
    assert run.until(lambda: any(k == "KICKED" for _, k, _, _ in run.seen),
                     3000)
    run.until(lambda: False, 20)
    return run.record()


def cluster_join_and_crash(P, n=10):
    crash = P.faults.CrashFault()
    run = _Run(P, crash)
    run.boot(n)
    crash.crashes[_ep(P, 5)] = run.net.tick + 1
    late = run.add(100)
    assert run.until(lambda: late.is_active and
                     late.get_membership_size() == n, 5000)
    return run.record()


def cluster_leave(P, n=6):
    run = _Run(P)
    run.boot(n)
    run.clusters[2].leave_gracefully()
    assert run.until(lambda: run.clusters[0].get_membership_size() == n - 1,
                     1000)
    return run.record()


def cluster_ingress_loss(P, n=8, target=4):
    drop = P.faults.PacketDropFault(p=0.0, ingress=True, egress=False,
                                    seed=7)
    run = _Run(P, drop)
    run.boot(n)
    drop.p = 0.8
    drop.targets = frozenset({_ep(P, target)})
    assert run.until(lambda: run.clusters[0].get_membership_size() == n - 1,
                     6000)
    return run.record()


CLUSTERS = {
    "sequential_joins_n5": (cluster_joins, 5, False),
    "sequential_joins_n10": (cluster_joins, 10, False),
    "parallel_joins_n10": (cluster_joins, 10, True),
    "parallel_joins_n21": (cluster_joins, 21, True),
    "metadata": (cluster_metadata,),
    "crash_one_of_five": (cluster_crash, 5, (2,)),
    "crash_quarter_of_twenty": (cluster_crash, 20, (3, 7, 11, 15, 19)),
    "one_way_partition": (cluster_one_way,),
    "kicked": (cluster_kicked,),
    "join_and_crash": (cluster_join_and_crash,),
    "graceful_leave": (cluster_leave,),
    "ingress_loss": (cluster_ingress_loss,),
}


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_cluster_simulation_equals_reference(name):
    scenario, *args = CLUSTERS[name]
    _same(scenario, *args)


def test_message_kinds_never_merge():
    """Two messages of different kinds with equal fields stay apart in a
    set, as the reference's dataclasses do."""
    e = types.Endpoint("n0.sim", 5000)
    assert len({types.LeaveMessage(e), types.ProbeMessage(e)}) == 2
    assert types.Rank(2, 1) < types.Rank(2, 3) < types.Rank(3, 0)
    assert hash(e) == hash(ref_types.Endpoint("n0.sim", 5000))
    assert types.Endpoint.parse("10.0.0.1:80") == ("10.0.0.1", 80)
    with pytest.raises(ValueError, match="malformed"):
        types.Endpoint.parse("nope")


# ---------------------------------------------------------------------------
# the churn differential of tests/test_service.py
# ---------------------------------------------------------------------------

def test_traffic_churn_differential_equals_reference():
    s = ref_settings.Settings()
    gen = TrafficGenerator(
        TrafficConfig(seed=11, join_rate_per_ktick=50.0,
                      leave_burst_rate_per_ktick=8.0, leave_burst_size=2,
                      min_members=6, reuse_slots=False),
        s, capacity=24, n_initial=8)
    for _ in range(4):
        gen.next_chunk(105)
    joins, leaves = gen.churn_calls(s)
    assert joins and leaves
    kw = dict(n=8, capacity=24, n_ticks=420, joins=joins, leaves=leaves)
    port = diff.run_churn_differential(**kw, device="cpu")
    ref = ref_diff.run_churn_differential(**kw)
    port.assert_identical()
    for f in ("oracle_events", "engine_events", "plan_events",
              "oracle_config_id", "engine_config_id", "oracle_members",
              "engine_members", "engine_metrics"):
        assert convert.plain(getattr(port, f)) == \
            convert.plain(getattr(ref, f)), f


# ---------------------------------------------------------------------------
# the host adversary engine (tests/test_adversary.py, tests/test_delay.py)
# ---------------------------------------------------------------------------

def _slow(n, n_slow, delay, seed=9):
    return ref_faults.AdversarySchedule(
        n=n, crashes=((5, 11),), seed=seed,
        delays=(ref_faults.DelayRule(
            src_slots=frozenset(range(n - n_slow, n)),
            dst_slots=frozenset(range(n)), delay_ticks=delay,
            start_tick=100),))


def _crash_delay(rule, seed):
    return ref_faults.AdversarySchedule(n=64, crashes=((63, 11),),
                                        delays=(rule,), seed=seed)


DR = ref_faults.DelayRule
SCHEDULES = {
    "straddling": (ref_faults.AdversarySchedule(
        n=64, crashes=((1, 5), (2, 5), (40, 15), (41, 15)), seed=2),
        260, 4),
    "one_way_classic": (ref_faults.AdversarySchedule(
        n=64, seed=7, windows=(ref_faults.LinkWindow(
            src_slots=frozenset(range(44)),
            dst_slots=frozenset(range(44, 64)), start_tick=3),)), 300, 4),
    "random_seed2_n64": (ref_faults.random_adversary_schedule(64, 2, 300),
                         300, 4),
    "delay_only": (_crash_delay(DR(
        src_slots=frozenset(range(12)), dst_slots=frozenset(range(12, 64)),
        delay_ticks=2), 5), 200, 4),
    "delay_partition": (ref_faults.AdversarySchedule(
        n=64, seed=17,
        windows=(ref_faults.LinkWindow(src_slots=frozenset(range(52)),
                                       dst_slots=frozenset(range(52, 64)),
                                       start_tick=6),),
        delays=(DR(src_slots=frozenset(range(10)),
                   dst_slots=frozenset(range(10, 40)), delay_ticks=2,
                   jitter_ticks=1),)), 240, 4),
    "jitter_reorder": (_crash_delay(DR(
        src_slots=frozenset(range(8)), dst_slots=frozenset(range(8, 64)),
        delay_ticks=0, jitter_ticks=2, reverse_delay_ticks=1), 23), 200, 4),
    "slow_link_d40": (_slow(64, 16, 40), 400, 48),
    "cross_phase_d30": (_slow(64, 16, 30), 400, 32),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_adversary_engine_equals_reference(name):
    ref_sched, ticks, ring = SCHEDULES[name]
    uids, id_fp_sum = default_identities(ref_sched.n)
    ref_run = ref_adversary.AdversaryEngine(
        ref_sched, uids, id_fp_sum,
        ref_settings.Settings(delivery_ring_depth=ring)).run(ticks)
    port_run = adversary.AdversaryEngine(
        convert.schedule_from_reference(ref_sched), uids, id_fp_sum,
        settings.Settings(delivery_ring_depth=ring)).run(ticks)
    assert convert.plain(port_run) == convert.plain(ref_run)
    assert convert.plain(port_run.metrics()) == \
        convert.plain(ref_run.metrics())


def test_adversary_execution_error_equals_reference():
    """A scripted proposal removing a slot already removed crashes both
    referees alike."""
    ref_sched = ref_faults.AdversarySchedule(n=8, seed=3, proposes=tuple(
        ref_faults.ScriptedPropose(slot=s, tick=t, proposal=(4,),
                                   delay_ticks=1)
        for s, t in ((0, 5), (1, 40))))
    uids, id_fp_sum = default_identities(8)
    with pytest.raises(ref_adversary.AdversaryExecutionError) as want:
        ref_adversary.AdversaryEngine(ref_sched, uids, id_fp_sum).run(120)
    with pytest.raises(adversary.AdversaryExecutionError) as got:
        adversary.AdversaryEngine(convert.schedule_from_reference(ref_sched),
                                  uids, id_fp_sum).run(120)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the fault models
# ---------------------------------------------------------------------------

def test_fault_models_equal_reference():
    n = 24
    ref_eps = ref_diff.default_endpoints(n)
    eps = diff.default_endpoints(n)
    rng = np.random.default_rng(5)
    pick = lambda k: frozenset(ref_eps[i] for i in
                               rng.choice(n, size=k, replace=False))
    window = ref_faults.LinkWindow(src_slots=frozenset({1, 2}),
                                   dst_slots=frozenset({5, 9}),
                                   start_tick=3, end_tick=40,
                                   period_ticks=4, two_way=True)
    ref_models = [
        ref_faults.HEALTHY,
        ref_faults.CrashFault({e: int(t) for e, t in
                               zip(pick(5), rng.integers(1, 30, 5))}),
        ref_faults.PacketDropFault(p=0.3, seed=9),
        ref_faults.PacketDropFault(p=0.8, targets=pick(3), egress=False,
                                   seed=2),
        ref_faults.OneWayPartitionFault(from_set=pick(6), to_set=pick(4),
                                        start_tick=4, end_tick=30),
        ref_faults.FlipFlopFault(targets=pick(3), period_ticks=5,
                                 start_tick=2, one_way=False),
        ref_faults.correlated_rack_failure(ref_eps, lambda e: e.port % 3
                                           + int(e.hostname[1:-4]) % 4,
                                           {1, 4}, 7),
        ref_faults.AdversarySchedule(
            n=n, crashes=((3, 6),), windows=(window,), seed=4,
            delays=(ref_faults.DelayRule(src_slots=frozenset({0, 1}),
                                         dst_slots=frozenset({7}),
                                         delay_ticks=1, jitter_ticks=2),)
        ).fault_model(ref_eps),
    ]
    ref_models.append(ref_faults.ComposedFault(ref_models[2:6]))
    for ref_model in ref_models:
        model = convert.fault_model_from_reference(ref_model)
        for tick in (0, 3, 5, 8, 13, 31):
            assert np.array_equal(model.edge_mask(eps, tick),
                                  ref_model.edge_mask(ref_eps, tick))
            assert np.array_equal(model.crash_mask(eps, tick),
                                  ref_model.crash_mask(ref_eps, tick))
            for s, d in ((0, 7), (1, 7), (2, 5), (9, 1), (4, 4)):
                assert model.edge_ok(eps[s], eps[d], tick) == \
                    ref_model.edge_ok(ref_eps[s], ref_eps[d], tick)
                assert model.delay_of(eps[s], eps[d], tick) == \
                    ref_model.delay_of(ref_eps[s], ref_eps[d], tick)
        want = ref_faults.link_windows_of(ref_model, ref_eps)
        got = faults.link_windows_of(model, eps)
        assert convert.plain(got) == convert.plain(want)
