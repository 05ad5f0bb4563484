"""The fleet host's tick tables, derived on the device, against the host
derivation.

``step._FleetHost`` reads only the distinct join and leave ticks and the
distinct ``paxos.tick_keys`` (send and fire ticks) of the fallback
schedules. Its ``inject_ticks``, each member's ``FallbackTicks``
(``send``, ``fire`` and the sorted ``arrivals``) and the unions
``fire_any``, ``send_any`` and ``arrive_any`` must equal what the whole
schedules give through numpy sets (``_host_ticks``, here). At
N=4,096 and F=4 the start read of one ``fleet_simulate`` moves the
distinct ticks and the ``[F]`` vectors (``step.fleet_schedule_values``),
not ``F x C`` values.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from rapid_tpu_torch import faults
from rapid_tpu_torch.engine import fleet, paxos, step
from rapid_tpu_torch.engine.state import I32_MAX
from rapid_tpu_torch.settings import Settings

F, I, C = 3, 2, 40


def _never(rng):
    tick = np.full((F, I, C), I32_MAX)
    return dict(join=np.full((F, C), I32_MAX), leave=np.full((F, C), I32_MAX),
                prop_tick=tick, prop_pid=rng.integers(0, 3, (F, I, C)),
                prop_delay=rng.integers(0, 30, (F, I, C)))


def _no_voters(rng):
    return dict(join=rng.integers(0, 50, (F, C)),
                leave=rng.integers(0, 50, (F, C)),
                prop_tick=rng.integers(0, 50, (F, I, C)),
                prop_pid=np.full((F, I, C), -1),
                prop_delay=rng.integers(0, 30, (F, I, C)))


def _rows(rng):
    """Each instance row its own ticks, the same in every member."""
    tick = np.broadcast_to(np.array([5, 40])[None, :, None] +
                           rng.integers(0, 3, (1, I, C)), (F, I, C))
    return dict(join=np.full((F, C), I32_MAX),
                leave=np.full((F, C), I32_MAX), prop_tick=tick,
                prop_pid=rng.integers(0, 3, (F, I, C)),
                prop_delay=np.broadcast_to(rng.integers(10, 30, (1, I, C)),
                                           (F, I, C)))


def _members_differ(rng):
    return dict(join=rng.choice([3, 9, I32_MAX], (F, C)),
                leave=rng.choice([12, 15, I32_MAX], (F, C)),
                prop_tick=np.arange(F)[:, None, None] * 7 +
                rng.integers(0, 4, (F, I, C)),
                prop_pid=rng.integers(0, 3, (F, I, C)),
                prop_delay=rng.integers(0, 30, (F, I, C)))


def _wrap(rng):
    """Ticks near ``I32_MAX``, where ``+ delay`` and ``+ 1`` wrap to
    negative, and near the least int32, whose sign bits the keys drop."""
    near = rng.integers(0, 4, (F, I, C))
    return dict(join=I32_MAX - rng.integers(0, 3, (F, C)),
                leave=rng.integers(-5, 5, (F, C)),
                prop_tick=np.where(rng.random((F, I, C)) < 0.5,
                                   I32_MAX - near, -I32_MAX - 1 + near),
                prop_pid=rng.integers(0, 3, (F, I, C)),
                prop_delay=rng.integers(0, 8, (F, I, C)))


def _mixed_pids(rng):
    """Negative pids (no vote) among voters, with ticks of their own."""
    return dict(join=rng.integers(0, 50, (F, C)),
                leave=rng.integers(0, 50, (F, C)),
                prop_tick=rng.integers(0, 60, (F, I, C)),
                prop_pid=rng.integers(-3, 3, (F, I, C)),
                prop_delay=rng.integers(0, 30, (F, I, C)))


CASES = {"all_never": _never, "no_voters": _no_voters,
         "instance_rows": _rows, "members_differ": _members_differ,
         "wrap": _wrap, "negative_pids": _mixed_pids}


def _host(case):
    """A ``_FleetHost`` over the case's schedules, and the schedules."""
    got = {k: np.ascontiguousarray(v, np.int64)
           for k, v in CASES[case](np.random.default_rng(17)).items()}
    i32 = lambda a: torch.from_numpy(a.astype(np.int32))
    inst_epoch = np.tile(np.arange(I), (F, 1))
    state = SimpleNamespace(tick=torch.full((F,), 4, dtype=torch.int32),
                            epoch=torch.arange(F, dtype=torch.int32),
                            member=torch.ones((F, C), dtype=torch.bool))
    churn = SimpleNamespace(join_tick=i32(got["join"]),
                            leave_tick=i32(got["leave"]), redraw_tick=None)
    fallback = SimpleNamespace(
        prop_tick=i32(got["prop_tick"]), prop_pid=i32(got["prop_pid"]),
        prop_delay=i32(got["prop_delay"]), inst_epoch=i32(inst_epoch))
    return step._FleetHost(state, churn, fallback), got, inst_epoch


def _host_ticks(prop_tick, prop_pid, prop_delay, inst_epoch):
    """One member's tick sets from its whole ``[I, C]`` schedule: each
    row's voters' send ticks, fire ticks (``prop_tick + prop_delay``) and
    sorted distinct arrival ticks (``prop_tick + 1``), in int32 as the
    device wraps them (``I32_MAX + 1`` is the least int32)."""
    voter = np.asarray(prop_pid) >= 0
    tick = np.asarray(prop_tick).astype(np.int64)
    fire = paxos._wrap32(tick + np.asarray(prop_delay))
    arrive = paxos._wrap32(tick + 1)
    rows = range(len(inst_epoch))
    return SimpleNamespace(
        inst_epoch=np.asarray(inst_epoch),
        send=[set(tick[e][voter[e]].tolist()) for e in rows],
        fire=[set(fire[e][voter[e]].tolist()) for e in rows],
        arrivals=[np.unique(arrive[e][voter[e]]) for e in rows])


@pytest.mark.parametrize("case", list(CASES))
def test_device_tables_equal_host_derivation(case):
    host, got, inst_epoch = _host(case)
    assert host.tick == 4 and host.epoch.tolist() == list(range(F))
    assert host.inject_ticks == set(got["join"].ravel().tolist()) | set(
        got["leave"].ravel().tolist())
    want = [_host_ticks(*rows) for rows in zip(
        got["prop_tick"], got["prop_pid"], got["prop_delay"], inst_epoch)]
    for m, (fb, ref) in enumerate(zip(host.fb.per, want)):
        assert np.array_equal(fb.inst_epoch, ref.inst_epoch), m
        assert fb.send == ref.send and fb.fire == ref.fire, m
        for a, b in zip(fb.arrivals, ref.arrivals):
            assert a.dtype == b.dtype and np.array_equal(a, b), m
    assert host.fb.fire_any == set().union(*(s for fb in want
                                             for s in fb.fire))
    assert host.fb.send_any == set().union(*(s for fb in want
                                             for s in fb.send))
    assert host.fb.arrive_any == set().union(*(a.tolist() for fb in want
                                               for a in fb.arrivals))


N4K, F4 = 4096, 4


def _crash(seed):
    rng = np.random.default_rng(seed)
    slots = rng.choice(N4K, 41, replace=False)
    return faults.AdversarySchedule(
        n=N4K, seed=seed, crashes=tuple((int(s), 5) for s in slots))


def _contested(seed):
    rng = np.random.default_rng(seed)
    victims = rng.choice(N4K, 3, replace=False)
    camp = rng.integers(0, 3, N4K)
    delay = rng.integers(15, 31, N4K)
    delay[int(rng.integers(0, N4K))] = 10
    return faults.AdversarySchedule(n=N4K, seed=seed, proposes=tuple(
        faults.ScriptedPropose(slot=i, tick=5, delay_ticks=int(delay[i]),
                               proposal=(int(victims[camp[i]]),))
        for i in range(N4K)))


@pytest.mark.parametrize("kind", ["crash", "contested"])
def test_start_read_moves_distinct_ticks_only(kind):
    settings = Settings(capacity=N4K)
    make = {"crash": _crash, "contested": _contested}[kind]
    stacked = fleet.stack_members([
        fleet.lower_schedule(make(seed), settings, device="cpu")
        for seed in range(F4)])
    step.fleet_schedule_values = 0
    fleet.fleet_simulate(stacked, 2, settings, device="cpu")
    got = step.fleet_schedule_values
    fb, churn = stacked.fallback, stacked.churn
    n_inst = fb.inst_epoch.shape[1]
    voter = (fb.prop_pid >= 0).numpy()
    tick = fb.prop_tick.numpy().astype(np.int64)
    row = np.arange(F4 * n_inst).reshape(F4, n_inst, 1)
    distinct = [len(set(zip(np.broadcast_to(row, voter.shape)[voter],
                            paxos._wrap32(t)[voter].tolist())))
                for t in (tick, tick + fb.prop_delay.numpy())]
    inject = np.unique(torch.cat([churn.join_tick, churn.leave_tick]))
    assert got == (2 * F4 + F4 * n_inst + len(inject) + sum(distinct)
                   + (not voter.all()))
    assert got < F4 * N4K // 100
