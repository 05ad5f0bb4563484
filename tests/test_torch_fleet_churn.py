"""Churn on the fleet path: ``fleet.lower_schedule(member=...)`` boots
dormant slots, so a fleet member's joiners inject and decide.

- ``member=None`` boots every slot of the padded universe a member, as
  the lowering always has, field for field; a mask gives what
  ``state.init_state(member=..., id_fps=...)`` gives, and members of one
  mask share one cached boot.
- A fleet of three members (N=64 in 96 slots, 80 ticks) under waves of
  eight joiners and eight leavers, six ticks apart, equals member by
  member, bit for bit, the port's single-cluster ``step.simulate`` and
  the JAX package's ``simulate`` of the same schedules; every member
  injects and decides once a wave, each decision its wave's eight slots.

Everything is integer or bool: the tolerance is exact.
"""
import importlib

import numpy as np
import pytest
import torch

from rapid_tpu.engine import churn as ref_churn
from rapid_tpu.engine import fleet as ref_fleet
from rapid_tpu.engine import state as ref_state
from rapid_tpu.faults import AdversarySchedule as RefSchedule
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch import faults, hashing
from rapid_tpu_torch.convert import to_numpy
from rapid_tpu_torch.engine import churn, fleet, state, step
from rapid_tpu_torch.identity import default_identities
from rapid_tpu_torch.settings import Settings

ref_step = importlib.import_module("rapid_tpu.engine.step")

N, C, TICKS, WAVES, SIZE, PERIOD = 64, 96, 80, 8, 8, 6
STARTS = (5, 7, 10)


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _waves(start: int, seed: int):
    """A host ``ChurnSchedule`` and the identifier fingerprints: wave
    ``i`` at ``start + PERIOD * i``, epoch ``i``; even waves join the
    next ``SIZE`` dormant slots, odd ones remove ``SIZE`` members drawn
    from the view of that wave (slot 0 kept)."""
    rng = np.random.default_rng(seed)
    sched = churn.empty_schedule(C)
    view, fresh = set(range(N)), N
    for i in range(WAVES):
        tick = start + PERIOD * i
        if i % 2 == 0:
            slots = np.arange(fresh, fresh + SIZE)
            fresh += SIZE
            sched.join_tick[slots], sched.join_epoch[slots] = tick, i
            view |= set(slots.tolist())
        else:
            slots = rng.choice(sorted(view - {0}), SIZE, replace=False)
            sched.leave_tick[slots], sched.leave_epoch[slots] = tick, i
            view -= set(slots.tolist())
    id_fps = np.zeros(C, np.uint64)
    id_fps[N:] = [hashing.hash64(s, seed=0x6964) for s in range(N, C)]
    return sched, id_fps


def _padded_uids():
    uids, fp_sum = default_identities(N)
    return uids + [hashing.hash64(i, seed=0x636170)
                   for i in range(C - N)], fp_sum


def _assert_same(got, want, what):
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        if a is None or b is None:
            assert a is None and b is None, f"{what}.{name}"
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what}.{name}"
        if not np.array_equal(a, b):
            first = np.argwhere(a != b)[0].tolist() if a.ndim else []
            pytest.fail(f"{what}.{name} differs first at {first}")


def _lower(sched, id_fps, **kw):
    return fleet.lower_schedule(faults.AdversarySchedule(n=N, seed=4),
                                Settings(capacity=C), churn=sched,
                                id_fps=id_fps, device="cpu", **kw)


@pytest.mark.parametrize("masked", [False, True])
def test_boot_equals_init_state(masked):
    """No mask: every slot of the padded universe a member, as before;
    a mask: ``init_state``'s boot of that view. One mask, one boot."""
    fleet.clear_boot_caches()
    sched, id_fps = _waves(5, 0)
    mask = np.arange(C) < N if masked else None
    got = _lower(sched, id_fps, member=mask)
    uids, fp_sum = _padded_uids()
    want = state.init_state(uids, fp_sum, Settings(capacity=C), member=mask,
                            id_fps=id_fps, device="cpu")
    _assert_same(to_numpy(got.state), to_numpy(want), "boot")
    assert int(got.state.member.sum()) == (N if masked else C)
    again = _lower(*_waves(7, 1), member=mask)
    assert again.state.ring_order is got.state.ring_order
    other = _lower(sched, id_fps, member=None if masked else np.arange(C)
                   < N)
    assert other.state.member is not got.state.member
    with pytest.raises(ValueError, match="member mask"):
        _lower(sched, id_fps, member=np.ones(N, bool))


@pytest.fixture(scope="module")
def runs():
    """The fleet's run, and each member's single-cluster runs in the
    port and in the JAX package."""
    fleet.clear_boot_caches()
    settings, ref_settings = Settings(capacity=C), RefSettings(capacity=C)
    mask = np.arange(C) < N
    plans = [_waves(start, seed) for seed, start in enumerate(STARTS)]
    members = [_lower(s, f, member=mask) for s, f in plans]
    got = fleet.fleet_simulate(fleet.stack_members(members), TICKS,
                               settings, device="cpu")
    single = [step.simulate(m.state, m.faults, TICKS, settings,
                            churn=m.churn, fallback=m.fallback, device="cpu")
              for m in members]
    uids, fp_sum = _padded_uids()
    never = [np.iinfo(np.int32).max] * C
    ref = [ref_step.simulate(
        ref_state.init_state(uids, fp_sum, ref_settings, member=mask,
                             id_fps=f),
        ref_state.link_faults(never, (), C), TICKS, ref_settings,
        churn=ref_churn.ChurnSchedule(*s[:4]),
        fallback=ref_fleet._compile_proposes(RefSchedule(n=N), None, C))
        for s, f in plans]
    return got, single, ref


@pytest.mark.parametrize("i", range(len(STARTS)))
def test_fleet_member_equals_both_single_cluster_runs(runs, i):
    got, single, ref = runs
    finals, logs = fleet.member_of(got[0], i), fleet.member_logs(got[1], i)
    _assert_same(to_numpy(logs), to_numpy(single[i][1]), "port logs")
    _assert_same(to_numpy(finals), to_numpy(single[i][0]), "port finals")
    _assert_same(to_numpy(logs), ref[i][1], "JAX logs")
    _assert_same(to_numpy(finals), ref[i][0], "JAX finals")


def test_every_member_injects_and_decides_once_a_wave(runs):
    got, _, _ = runs
    logs = to_numpy(got[1])
    assert (logs.churn_injected.sum(axis=1) == WAVES * SIZE).all()
    assert (logs.decide_now.sum(axis=1) == WAVES).all()
    assert logs.n_member.min() == N and logs.n_member.max() == N + SIZE
    decided = logs.decision[logs.decide_now.astype(bool)]
    assert (decided.sum(axis=-1) == SIZE).all()
