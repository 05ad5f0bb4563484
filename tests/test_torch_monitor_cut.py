"""Fault evaluation (``engine.monitor``) and per-receiver cut detection
(``engine.cut``) of the port against the JAX reference, on seeded inputs.
Tolerance: exact (integer and bool)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rapid_tpu.engine import cut as ref_cut
from rapid_tpu.engine import monitor as ref_monitor
from rapid_tpu.engine import topology as ref_topology
from rapid_tpu.engine.state import link_faults as ref_link_faults
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch.engine import cut as port_cut
from rapid_tpu_torch.engine import monitor as port_monitor
from rapid_tpu_torch.engine.state import link_faults as port_link_faults
from rapid_tpu_torch.faults import AdversarySchedule, DelayRule, LinkWindow
from rapid_tpu_torch.settings import Settings

C = 21      # C % 8 != 0: the packed planes carry pad bits


def _schedule():
    return AdversarySchedule(
        n=C, crashes=((2, 4), (17, 9)),
        windows=(
            LinkWindow(src_slots=frozenset(range(5)),
                       dst_slots=frozenset(range(5, C)), start_tick=3,
                       end_tick=30, two_way=True),
            LinkWindow(src_slots=frozenset({7, 8}),
                       dst_slots=frozenset({8, 9, 20}), start_tick=2,
                       period_ticks=3),
        ),
        delays=(
            DelayRule(src_slots=frozenset(range(4)),
                      dst_slots=frozenset(range(10, 16)), delay_ticks=1,
                      jitter_ticks=2, reverse_delay_ticks=0, start_tick=2,
                      end_tick=25),
            DelayRule(src_slots=frozenset({18, 19}),
                      dst_slots=frozenset({0, 1}), delay_ticks=0,
                      jitter_ticks=3, start_tick=5),
        ),
        seed=13)


@pytest.fixture(scope="module")
def faults():
    sched = _schedule()
    crash = sched.crash_tick_array().tolist()
    kw = dict(delays=sched.delays, delay_seed=sched.seed)
    return (ref_link_faults(crash, sched.windows, C, **kw),
            port_link_faults(crash, sched.windows, C, device="cpu", **kw))


TICKS = [1, 2, 3, 5, 6, 8, 9, 12, 24, 29, 30, 40]


def _eq(got, want):
    want = np.asarray(want)
    assert np.array_equal(got.numpy().astype(want.dtype), want)


@pytest.mark.parametrize("tick", TICKS)
def test_link_masks_and_gauges(faults, tick):
    ref, port = faults
    t = jnp.int32(tick)
    _eq(port_monitor.crashed_at(port, tick), ref_monitor.crashed_at(ref, t))
    _eq(port_monitor.link_window_active(port, tick),
        ref_monitor.link_window_active(jnp, ref, t))
    packed = port_monitor.link_blocked_packed(port, tick)
    assert packed.dtype == torch.uint8
    _eq(packed, ref_monitor.link_blocked_packed(jnp, ref, t))
    rng = np.random.default_rng(tick)
    src = rng.integers(0, C, size=(C, 10))
    dst = rng.integers(0, C, size=(C, 10))
    _eq(port_monitor.link_blocked(port, torch.from_numpy(src),
                                  torch.from_numpy(dst), tick),
        ref_monitor.link_blocked(jnp, ref, jnp.asarray(src),
                                 jnp.asarray(dst), t))
    alive = ~port_monitor.crashed_at(port, tick)
    count = port_monitor.partitioned_edge_count(port, alive, tick)
    assert count.dtype == torch.int32
    _eq(count, ref_monitor.partitioned_edge_count(
        jnp, ref, jnp.asarray(alive.numpy()), t))


@pytest.mark.parametrize("tick", TICKS)
def test_delay_matrix(faults, tick):
    ref, port = faults
    got = port_monitor.delay_matrix(port, tick)
    assert got.dtype == torch.int32
    _eq(got, ref_monitor.delay_matrix(jnp, ref, jnp.int32(tick)))


@pytest.mark.parametrize("seed", range(6))
def test_receiver_aggregate(seed):
    rng = np.random.default_rng(seed)
    k = Settings().K
    uid_hi = rng.integers(0, 2**32, size=C, dtype=np.uint64).astype(np.uint32)
    uid_lo = rng.integers(0, 2**32, size=C, dtype=np.uint64).astype(np.uint32)
    order, rank = ref_topology.ring_permutations(np, uid_hi, uid_lo, k)
    member = rng.random((C, C)) < 0.8
    obs_full = np.stack([ref_topology.build_topology(np, member[r], order,
                                                     rank)[1]
                         for r in range(C)])
    reports = rng.random((C, C, k)) < 0.3
    down = rng.random((C, C, k)) < 0.15
    gate = rng.random(C) < 0.8
    seen_down = rng.random(C) < 0.3
    want = ref_cut.receiver_aggregate(
        jnp, jnp.asarray(reports), jnp.asarray(member),
        jnp.asarray(obs_full), jnp.asarray(down), jnp.asarray(gate),
        jnp.asarray(seen_down), RefSettings())
    t = torch.from_numpy
    got = port_cut.receiver_aggregate(
        t(reports), t(member), t(obs_full), t(down), t(gate), t(seen_down),
        Settings())
    # the invalidation fixpoint must have had work to do
    assert (np.asarray(want[0]) & ~(reports | (down & member[:, :, None]
                                               & gate[:, None, None]))).any()
    for g, w in zip(got, want):
        assert g.dtype == torch.bool
        _eq(g, w)
