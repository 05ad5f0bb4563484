"""The shared engine's modules of the port against the JAX reference, one
function at a time, on seeded numpy inputs: ``state.init_state``, the
converters, ``votes``, ``monitor.edge_drop`` and ``monitor_tick``,
``cut.deliver_reports`` and ``cut.aggregate``. Tolerance: exact (all
values are integers or bools)."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_tpu.engine import cut as ref_cut
from rapid_tpu.engine import monitor as ref_monitor
from rapid_tpu.engine import votes as ref_votes
from rapid_tpu.engine.state import EngineFaults as RefFaults
from rapid_tpu.engine.state import init_state as ref_init_state
from rapid_tpu.engine.state import link_faults as ref_link_faults
from rapid_tpu.engine.topology import build_topology as ref_topology
from rapid_tpu.faults import LinkWindow as RefWindow
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch import device
from rapid_tpu_torch.convert import from_reference, to_numpy
from rapid_tpu_torch.engine import cut, monitor, votes
from rapid_tpu_torch.engine.state import init_state
from rapid_tpu_torch.settings import Settings

ref_step = importlib.import_module("rapid_tpu.engine.step")
C = 45
K = Settings().K


def _eq(got, want):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    if want.dtype == np.uint32:
        got = got.astype(np.uint32)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def _eq_nt(port_nt, ref_nt):
    port_np = to_numpy(port_nt)
    assert port_np._fields == ref_nt._fields
    for name in ref_nt._fields:
        want = np.asarray(getattr(ref_nt, name))
        got = getattr(port_np, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert np.array_equal(got, want), name


def _uids(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**63, size=n, dtype=np.uint64) * 2 + 1


@pytest.mark.parametrize("case", ["converged", "padded_dormant"])
def test_init_state(case):
    n = 30
    uids = _uids(n, 1)
    kw = {}
    capacity = 0
    if case == "padded_dormant":
        rng = np.random.default_rng(2)
        capacity = n + 7
        kw = dict(start_tick=4, member=rng.random(n) < 0.7,
                  id_fps=rng.integers(0, 2**64, size=n, dtype=np.uint64))
    id_fp_sum = 0x1234_5678_9ABC_DEF0
    want = ref_init_state(uids, id_fp_sum, RefSettings(capacity=capacity),
                          **kw)
    got = init_state(uids, id_fp_sum, Settings(capacity=capacity),
                     device="cpu", **kw)
    assert len(got) == 63
    _eq_nt(got, want)
    _eq_nt(from_reference(want, device="cpu"), want)


def test_faults_carry_the_drop_configuration():
    targets = np.arange(C) % 3 == 0
    ref = RefFaults(jnp.full((C,), 9, jnp.int32), drop_p=0.3, drop_seed=7,
                    drop_targets=jnp.asarray(targets), drop_ingress=False)
    port = from_reference(ref, device="cpu")
    assert (port.drop_p, port.drop_seed, port.drop_ingress,
            port.drop_egress) == (0.3, 7, False, True)
    back = to_numpy(port)
    assert back["drop_p"] == 0.3 and back["drop_ingress"] is False
    assert np.array_equal(back["drop_targets"], targets)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _limbs(rng, pool, size):
    """Fingerprint limbs drawn from ``pool`` distinct 64-bit values."""
    values = rng.integers(0, 2**64, size=pool, dtype=np.uint64)
    pick = values[rng.integers(0, pool, size=size)]
    return ((pick >> np.uint64(32)).astype(np.uint32),
            (pick & np.uint64(0xFFFFFFFF)).astype(np.uint32))


@pytest.mark.parametrize("seed", range(4))
def test_proposal_fingerprint(seed):
    rng = np.random.default_rng(seed)
    hi, lo = _limbs(rng, C, C)
    for mask in (rng.random(C) < 0.3, np.zeros(C, bool), np.ones(C, bool)):
        want = ref_votes.proposal_fingerprint(
            jnp, jnp.asarray(mask), jnp.asarray(hi), jnp.asarray(lo))
        got = votes.proposal_fingerprint(_t(mask), _t(hi).long(),
                                         _t(lo).long())
        for g, w in zip(got, want):
            _eq(g, w)


def _vote_cases():
    rng = np.random.default_rng(11)
    cases = {}
    hi, lo = _limbs(rng, 4, C)
    cases["ties"] = (hi, lo, rng.random(C) < 0.7)
    cases["all_invalid"] = (hi, lo, np.zeros(C, bool))
    # Invalid votes share the fingerprints of valid ones, the largest
    # included, so a run of valid votes borders invalid ones after the
    # sort.
    hi2, lo2 = _limbs(rng, 3, C)
    valid = np.zeros(C, bool)
    valid[::2] = True
    cases["invalid_equals_valid"] = (hi2, lo2, valid)
    same = np.full(C, 0xDEADBEEF, np.uint32)
    cases["one_value"] = (same, same, rng.random(C) < 0.5)
    # Equal hi limbs, lo limbs that order differently than slots.
    cases["hi_tie"] = (np.full(C, 7, np.uint32),
                       rng.integers(0, 3, size=C).astype(np.uint32),
                       rng.random(C) < 0.6)
    return cases


@pytest.mark.parametrize("name", sorted(_vote_cases()))
def test_segmented_vote_count(name):
    hi, lo, valid = _vote_cases()[name]
    want = ref_votes.segmented_vote_count(
        jnp, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid))
    got = votes.segmented_vote_count(_t(hi).long(), _t(lo).long(),
                                     _t(valid))
    _eq(got, want)


@pytest.mark.parametrize("n,quorum", [(0, 1), (1, 1), (4, 4), (5, 4),
                                      (8, 7), (100, 76)])
def test_fast_quorum_and_count_fast_round(n, quorum):
    n_member = torch.tensor(n, dtype=torch.int32)
    got = votes.fast_quorum(n_member)
    _eq(got, ref_votes.fast_quorum(jnp, jnp.int32(n)))
    assert int(got) == quorum
    rng = np.random.default_rng(n)
    hi, lo = _limbs(rng, 2, C)
    for valid in (rng.random(C) < 0.9, np.ones(C, bool)):
        # One value holds every vote on the second pass.
        if valid.all():
            hi, lo = np.full(C, 3, np.uint32), np.full(C, 5, np.uint32)
        want = ref_votes.count_fast_round(
            jnp, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid),
            jnp.int32(n))
        got = votes.count_fast_round(_t(hi).long(), _t(lo).long(),
                                     _t(valid), n_member)
        for g, w in zip(got, want):
            _eq(g, w)


def _fault_pair(drop_p=0.0, targets=None, ingress=True, egress=True):
    """The same crash + window + drop faults for both packages."""
    crash = np.full(C, np.iinfo(np.int32).max, np.int32)
    crash[[3, 17, 30]] = [6, 12, 25]
    windows = (
        RefWindow(src_slots=frozenset(range(5)),
                  dst_slots=frozenset(range(5, C)), start_tick=8,
                  end_tick=40, two_way=True),
        RefWindow(src_slots=frozenset({7, 8, 9}),
                  dst_slots=frozenset({8, 20, 44}), start_tick=4,
                  period_ticks=6),
    )
    base = ref_link_faults(crash.tolist(), windows, C)
    ref = RefFaults(
        base.crash_tick, drop_p=drop_p, drop_seed=7,
        drop_targets=None if targets is None else jnp.asarray(targets),
        drop_ingress=ingress, drop_egress=egress, link_src=base.link_src,
        link_dst=base.link_dst, link_start=base.link_start,
        link_end=base.link_end, link_period=base.link_period,
        link_two_way=base.link_two_way)
    return ref, from_reference(ref, device="cpu")


DROP_CASES = [(p, targets, ingress, egress)
              for p in (0.3, 0.999)
              for targets, ingress, egress in (
                  (False, True, True), (True, True, True),
                  (True, True, False), (True, False, True),
                  (True, False, False))]


@pytest.mark.parametrize("p,targets,ingress,egress", DROP_CASES)
def test_edge_drop(p, targets, ingress, egress):
    rng = np.random.default_rng(int(p * 1000) + 2 * ingress + egress)
    mask = (rng.random(C) < 0.4) if targets else None
    ref, port = _fault_pair(p, mask, ingress, egress)
    uid_hi, uid_lo = _limbs(rng, C, C)
    src = rng.integers(0, C, size=(C, K))
    dst = rng.integers(0, C, size=(C, K))
    for tick in (0, 10, 37, 2**31 - 1):
        want = ref_monitor.edge_drop(
            jnp, ref, jnp.asarray(src), jnp.asarray(dst),
            jnp.asarray(uid_hi), jnp.asarray(uid_lo), jnp.int32(tick))
        got = monitor.edge_drop(port, _t(src), _t(dst), _t(uid_hi).long(),
                                _t(uid_lo).long(), tick)
        _eq(got, want)
        assert bool(got.any()) == (not targets or ingress or egress)


def _mid_run_state(seed, drop_p):
    """A reference state part-way through a run with crash, window and
    drop faults, with its counters and latches then scrambled."""
    ref_faults, port_faults = _fault_pair(drop_p)
    settings = RefSettings()
    state = ref_init_state(_uids(C, seed), 0, settings)
    state, _ = ref_step.simulate(state, ref_faults, 20 + seed, settings)
    rng = np.random.default_rng(seed)
    member = rng.random(C) < 0.9
    topo = ref_topology(jnp, jnp.asarray(member), state.ring_order,
                        state.ring_rank)
    state = state._replace(
        member=jnp.asarray(member),
        subj_idx=topo[0], obs_idx=topo[1], gk_idx=topo[2],
        fd_active=topo[3], fd_first=topo[4],
        fc=jnp.asarray(rng.integers(0, 13, size=(C, K)).astype(np.int32)),
        notified=jnp.asarray(rng.random((C, K)) < 0.2))
    return state, ref_faults, port_faults


@pytest.mark.parametrize("seed,drop_p", [(0, 0.0), (1, 0.3), (2, 0.999)])
def test_monitor_tick(seed, drop_p):
    state, ref_faults, port_faults = _mid_run_state(seed, drop_p)
    want = ref_monitor.monitor_tick(jnp, state, ref_faults, RefSettings())
    port_state = from_reference(state, device="cpu")
    got = monitor.monitor_tick(port_state, port_faults, Settings(),
                               int(state.tick))
    for g, w in zip(got, want):
        _eq(g, w)
    assert int(got[2].sum()) > 0 and int(got[4]) > 0


@pytest.mark.parametrize("seed", range(3))
def test_deliver_reports(seed):
    state, _, _ = _mid_run_state(seed, 0.0)
    rng = np.random.default_rng(seed + 10)
    state = state._replace(
        pending_deliver=jnp.asarray(rng.random((C, K)) < 0.3))
    alive = rng.random(C) < 0.8
    want = ref_cut.deliver_reports(jnp, state, jnp.asarray(alive))
    got = cut.deliver_reports(from_reference(state, device="cpu"),
                              _t(alive))
    _eq(got, want)


def _aggregate_case(seed):
    """Report planes around the L..H watermarks, so that the reference's
    invalidation ``while_loop`` adds cells and iterates again."""
    state, _, _ = _mid_run_state(seed % 3, 0.0)
    rng = np.random.default_rng(seed)
    p = (0.25, 0.35, 0.45, 0.6)[seed % 4]
    state = state._replace(
        reports=jnp.asarray(rng.random((C, K)) < p),
        seen_down=jnp.asarray(seed % 5 != 4),
        announced=jnp.asarray(seed == 7))
    down = rng.random((C, K)) < 0.1
    up = rng.random((C, K)) < (0.1 if seed % 2 else 0.0)
    return state, down, up


@pytest.mark.parametrize("seed", range(12))
def test_aggregate(seed):
    state, down, up = _aggregate_case(seed)
    want = ref_cut.aggregate(jnp, state, jnp.asarray(down), jnp.asarray(up),
                             jnp.asarray(True), RefSettings())
    before = device.host_reads
    got = cut.aggregate(from_reference(state, device="cpu"), _t(down),
                        _t(up) if up.any() else None, torch.tensor(True),
                        Settings())
    assert device.host_reads - before == 1
    for g, w in zip(got[:6], want):
        _eq(g, w)
    assert got[6] == bool(want[2])
    # The fixpoint had work to do wherever the gate was open (seed 7 has
    # announced already, which closes it).
    assert (int(np.asarray(want[5])) > 0) == (seed != 7)


def test_aggregate_announces_a_clean_crossing():
    state, _, _ = _mid_run_state(0, 0.0)
    member = np.asarray(state.member)
    dst = int(np.nonzero(member)[0][4])
    down = np.zeros((C, K), bool)
    down[dst] = True
    state = state._replace(reports=jnp.zeros((C, K), bool),
                           announced=jnp.asarray(False))
    want = ref_cut.aggregate(jnp, state, jnp.asarray(down),
                             jnp.zeros((C, K), bool), jnp.asarray(True),
                             RefSettings())
    got = cut.aggregate(from_reference(state, device="cpu"), _t(down), None,
                        torch.tensor(True), Settings())
    for g, w in zip(got[:6], want):
        _eq(g, w)
    assert got[6] is True and bool(want[2])
