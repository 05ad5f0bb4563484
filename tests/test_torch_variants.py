"""The port's protocol variants against the JAX reference.

Parts: the ring's tally and report delivery (the reference's
``votes.scan_vote_count``, ``ring_count_fast_round`` and
``cut.ring_deliver_reports``, a permutation round trip) against the
port's ``segmented_vote_count``, ``count_fast_round`` and
``deliver_reports``, which the port runs under "ring";
``ring_pair_factor``; and ``variants.hier`` (``group_ids``,
``hier_count_fast_round``, ``np_hier_decide``,
``hier_exchange_messages``). Whole runs of ``step.simulate`` under
``protocol_variant`` "ring" and "hier": the crash bursts and the contested
two-way split of ``tests/test_variants.py`` at N=64 and 256, every
``StepLog`` field at every tick and every final-state field. And
"rapid" runs exactly the ops it ran before the variants were ported.
Everything is integer or bool: the tolerance is exact.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from rapid_tpu.engine import cut as ref_cut
from rapid_tpu.engine import diff as ref_diff
from rapid_tpu.engine import paxos as ref_paxos
from rapid_tpu.engine import votes as ref_votes
from rapid_tpu.engine.state import crash_faults as ref_crash_faults
from rapid_tpu.engine.state import init_state as ref_init_state
from rapid_tpu.oracle.membership_view import MembershipView, uid_of
from rapid_tpu.settings import Settings as RefSettings
from rapid_tpu.variants import hier as ref_hier
from rapid_tpu.variants import ring as ref_ring

from rapid_tpu_torch import device
from rapid_tpu_torch.convert import from_reference, to_numpy
from rapid_tpu_torch.engine import cut, diff, invariants, recorder, step, \
    votes
from rapid_tpu_torch.engine.state import I32_MAX, crash_faults, init_state
from rapid_tpu_torch.identity import default_identities
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.variants import hier, ring

ref_step = importlib.import_module("rapid_tpu.engine.step")


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


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _uids(n):
    return np.asarray([uid_of(e) for e in ref_diff.default_endpoints(n)],
                      np.uint64)


def _votes(c, seed):
    """Vote fingerprints with ties (few distinct values), a random valid
    mask and, for odd seeds, an invalid tail."""
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 3, c).astype(np.uint32)
    lo = rng.integers(0, 2, c).astype(np.uint32) * np.uint32(0xFFFFFFFF)
    valid = rng.random(c) < 0.7
    if seed % 2:
        valid[c // 2:] = False
    return hi, lo, valid


# ---------------------------------------------------------------------------
# parts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [64, 256])
@pytest.mark.parametrize("seed", range(6))
def test_reference_scan_tally_equals_segmented_count(c, seed):
    hi, lo, valid = _votes(c, seed)
    want = np.asarray(ref_votes.scan_vote_count(
        jnp, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid)))
    got = votes.segmented_vote_count(_t(hi), _t(lo), torch.from_numpy(valid))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def _ref_state(n, seed):
    """A reference state with a random member mask, pending reports and
    proposal fingerprints."""
    rng = np.random.default_rng(seed)
    uids, id_fp_sum = default_identities(n)
    state = ref_init_state(uids, id_fp_sum, RefSettings(),
                           member=rng.random(n) < 0.9)
    return state._replace(
        pending_deliver=jnp.asarray(rng.random((n, 10)) < 0.2)), rng


@pytest.mark.parametrize("n,seed", [(64, 0), (64, 1), (256, 2)])
def test_ring_parts_equal_reference(n, seed):
    state, rng = _ref_state(n, seed)
    port = from_reference(state, device="cpu")
    hi, lo, valid = _votes(n, seed)
    for n_member in (int(valid.sum()), n):
        want = ref_ring.ring_count_fast_round(
            jnp, state, jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(valid),
            jnp.int32(n_member))
        got = votes.count_fast_round(_t(hi), _t(lo), torch.from_numpy(valid),
                                     torch.tensor(n_member))
        assert [bool(got[0]), int(got[1])] == [bool(want[0]), int(want[1])]
        assert got[1].dtype == torch.int32
    for mask in (valid, np.zeros(n, bool)):
        got = ring.ring_pair_factor(torch.from_numpy(mask))
        assert got.dtype == torch.int32
        assert int(got) == int(ref_ring.ring_pair_factor(jnp,
                                                         jnp.asarray(mask)))
    alive = rng.random(n) < 0.8
    want = ref_cut.ring_deliver_reports(jnp, state, jnp.asarray(alive))
    got = cut.deliver_reports(port, torch.from_numpy(alive))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,seed", [(64, 0), (256, 1), (1000, 2)])
def test_hier_parts_equal_reference(n, seed):
    uids = _uids(n)
    hi = (uids >> np.uint64(32)).astype(np.uint32)
    lo = (uids & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    g = hier.hier_group_count(n)
    assert g == ref_hier.hier_group_count(n)
    got = hier.group_ids(_t(hi), _t(lo), g)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          np.asarray(ref_hier.group_ids(np, hi, lo, g)))
    rng = np.random.default_rng(seed)
    for p_member, p_valid in ((1.0, 0.9), (0.9, 0.75), (0.8, 0.3)):
        member = rng.random(n) < p_member
        valid = member & (rng.random(n) < p_valid)
        args = (jnp.asarray(member), jnp.asarray(valid), jnp.asarray(hi),
                jnp.asarray(lo), g)
        want = ref_hier.hier_count_fast_round(jnp, *args)
        gid = hier.group_ids(_t(hi), _t(lo), g)
        got = hier.hier_count_fast_round(
            torch.from_numpy(member), torch.from_numpy(valid), gid, g)
        assert [bool(got[0]), int(got[1])] == [bool(want[0]), int(want[1])]
        assert hier.np_hier_decide(member, valid, hi, lo, g) == \
            ref_hier.np_hier_decide(np, member, valid, hi, lo, g) == \
            bool(want[0])
        want = ref_hier.hier_exchange_messages(
            jnp, jnp.asarray(valid), jnp.asarray(member), jnp.asarray(hi),
            jnp.asarray(lo), g)
        got = hier.hier_exchange_messages(
            torch.from_numpy(valid), torch.from_numpy(member), gid, g)
        assert got.dtype == torch.int32 and int(got) == int(want)


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

CRASH_SCENARIOS = {
    64: ({3: 5, 17: 5, 40: 7}, 130),
    256: ({5: 11, 100: 13, 200: 15, 250: 19}, 140),
}


def two_way_split(n):
    values = [[0], [1]]
    votes_ = {s: (6, s % 2) for s in range(n)}
    delays = {s: (10 if s == 0 else 100) for s in range(n)}
    return values, votes_, delays, 30


def _boot(kind, n):
    """The reference's state, faults, fallback schedule and ticks, as
    ``run_variant_differential`` boots them."""
    id_fp_sum = MembershipView(10, ref_diff.default_node_ids(n),
                               [])._id_fp_sum
    state = ref_init_state(_uids(n), id_fp_sum, RefSettings())
    if kind == "crash":
        crashes, ticks = CRASH_SCENARIOS[n]
        faults = ref_crash_faults([crashes.get(s, I32_MAX)
                                   for s in range(n)])
        return state, faults, None, ticks
    values, votes_, delays, ticks = two_way_split(n)
    sched, _ = ref_paxos.plan_fallback(n, values, votes_, delays,
                                       RefSettings(), uids=_uids(n))
    return state, ref_crash_faults([I32_MAX] * n), sched, ticks


RUNS = [(variant, kind, n) for variant in ("ring", "hier")
        for kind in ("crash", "contested") for n in (64, 256)]


@pytest.fixture(scope="module", params=RUNS,
                ids=[f"{v}-{k}-n{n}" for v, k, n in RUNS])
def runs(request):
    variant, kind, n = request.param
    state, faults, sched, ticks = _boot(kind, n)
    want = ref_step.simulate(state, faults, ticks,
                             RefSettings(protocol_variant=variant),
                             fallback=sched)
    before = device.host_reads
    got = step.simulate(
        from_reference(state, device="cpu"),
        from_reference(faults, device="cpu"), ticks,
        Settings(protocol_variant=variant),
        fallback=None if sched is None else from_reference(sched,
                                                           device="cpu"),
        device="cpu")
    return request.param, want, got, device.host_reads - before


def test_variant_logs_equal_the_reference_at_every_tick(runs):
    _, (_, ref_logs), (_, port_logs), _ = runs
    _assert_same(port_logs, ref_logs)


def test_variant_final_state_equals_the_reference(runs):
    _, (ref_final, _), (port_final, _), _ = runs
    _assert_same(port_final, ref_final)


def test_variant_events_and_counters_equal_the_reference(runs):
    (variant, kind, n), (_, ref_logs), (_, port_logs), _ = runs
    events = [e.as_dict() for e in diff.engine_events(port_logs)]
    assert events == [e.as_dict() for e in ref_diff.engine_events(ref_logs)]
    assert any(e["kind"] == "view_change" for e in events)
    assert diff.expand_counters(port_logs) == \
        ref_diff.expand_counters(ref_logs)
    assert diff.expand_fallback_counters(port_logs) == \
        ref_diff.expand_fallback_counters(ref_logs)
    announce = port_logs.announce_now.numpy()
    if variant == "ring":
        # one lap up and one down, whatever the number of senders
        assert set(port_logs.vote_senders.numpy()[announce]) <= {2}
        if kind == "contested":
            assert set(port_logs.pxvote_senders.numpy()) <= {0, 2}
    else:
        assert set(port_logs.vote_recipients.numpy()[announce]) <= {1}


def test_variant_adds_no_host_read(runs):
    """The variants read nothing more than "rapid" does: one read at the
    start, the first tick's vote-arrival bit, the announce read every
    tick and the decide read on vote ticks (contested runs read their
    schedule's tally and classic decides as "rapid" does)."""
    (_, kind, _), (_, ref_logs), _, reads = runs
    if kind == "crash":
        ticks = len(np.asarray(ref_logs.tick))
        vote_ticks = int((np.asarray(ref_logs.quorum) > 0).sum())
        assert reads == 2 + ticks + vote_ticks


class _CountOps(TorchDispatchMode):
    """Counts the aten ops dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


#: Aten ops of ``_rapid_run`` on the tree before the variants, the
#: invariant monitor and the flight recorder were ported (13,417), less
#: the one op the fleets' out-of-place ``votes.segmented_vote_count``
#: saves on the run's one vote tick.
RAPID_OPS = 13416


def _rapid_run():
    uids, id_fp_sum = default_identities(64)
    state = init_state(uids, id_fp_sum, Settings(), device="cpu")
    crash = [I32_MAX] * 64
    for slot in (3, 17, 40):
        crash[slot] = 5
    faults = crash_faults(crash, device="cpu")
    with _CountOps() as ops:
        _, logs = step.simulate(state, faults, 130, Settings(), device="cpu")
    return ops.n, logs


def test_rapid_runs_exactly_what_it_ran_before(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a variant, the monitor or the recorder ran "
                             "under the default settings")

    for mod, names in ((ring, ("ring_pair_factor",)),
                       (hier, ("group_ids", "hier_count_fast_round",
                               "hier_exchange_messages")),
                       (invariants, ("check_step",)),
                       (recorder, ("init", "record_run"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    n_ops, logs = _rapid_run()
    assert n_ops == RAPID_OPS
    assert int(logs.decide_now.sum()) == 1
    assert int(logs.inv_bits.abs().sum()) == 0
