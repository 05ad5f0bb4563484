"""Boot, packing, conversion and entry-point guards of the port's
per-receiver engine, against the JAX reference where there is one.
Tolerance: exact (integer and bool state)."""
import numpy as np
import pytest
import torch

from rapid_tpu.engine import paxos as ref_paxos
from rapid_tpu.engine import receiver as ref_rx
from rapid_tpu.engine import rx_packed as ref_packed
from rapid_tpu.engine import topology as ref_topology
from rapid_tpu.engine.fleet import _default_identities
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch import faults as port_faults
from rapid_tpu_torch.convert import from_reference, to_numpy
from rapid_tpu_torch.engine import paxos as port_paxos
from rapid_tpu_torch.engine import receiver as port_rx
from rapid_tpu_torch.engine import rx_packed as port_packed
from rapid_tpu_torch.engine import topology as port_topology
from rapid_tpu_torch.identity import default_identities
from rapid_tpu_torch.settings import Settings


def _assert_same(got, want):
    got = to_numpy(got)
    for field in got._fields:
        g = getattr(got, field)
        w = np.asarray(getattr(want, field))
        assert g.dtype == w.dtype, field
        assert g.shape == w.shape, field
        assert np.array_equal(g, w), field


@pytest.mark.parametrize("seed,capacity", [(11, 16), (0, 40), (7, 65)])
def test_build_delay_table_equals_reference(seed, capacity):
    want = ref_paxos.build_delay_table(seed, capacity, port_rx.N_DRAWS,
                                       RefSettings())
    got = port_paxos.build_delay_table(seed, capacity, port_rx.N_DRAWS,
                                       Settings())
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_default_identities_equal_reference():
    for n in (16, 64, 1024):
        assert default_identities(n) == _default_identities(n)


BOOTS = {"n16": (16, 0), "n64": (64, 0), "n16_padded_to_24": (16, 24)}


@pytest.fixture(scope="module", params=sorted(BOOTS))
def boot(request):
    n, capacity = BOOTS[request.param]
    uids, id_fp_sum = default_identities(n)
    ref = ref_rx.init_receiver_state(
        uids, id_fp_sum, RefSettings(rx_kernel="pallas", capacity=capacity),
        seed=5)
    port = port_rx.init_receiver_state(
        uids, id_fp_sum, Settings(rx_kernel="pallas", capacity=capacity),
        seed=5, device="cpu")
    return ref, port


def test_init_receiver_state_equals_reference(boot):
    ref, port = boot
    _assert_same(port, ref)


def test_pack_equals_reference_pack(boot):
    ref, port = boot
    settings = Settings(rx_kernel="pallas")
    want = ref_packed.pack_receiver_state(ref, RefSettings(rx_kernel="pallas"))
    _assert_same(port_packed.pack_receiver_state(port, settings), want)


def test_pack_unpack_round_trip(boot):
    _ref, port = boot
    settings = Settings(rx_kernel="pallas")
    packed = port_packed.pack_receiver_state(port, settings)
    back = port_packed.unpack_receiver_state(packed, port.delay_table,
                                             settings)
    _assert_same(back, to_numpy(port))


def test_from_reference_carries_state_across(boot):
    ref, port = boot
    carried = from_reference(ref, device="cpu")
    for field in port._fields:
        a, b = getattr(carried, field), getattr(port, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field
    _assert_same(carried, ref)


def test_batched_topology_equals_reference_rows():
    n = 24
    uids, _ = default_identities(n)
    from rapid_tpu import hashing as ref_hashing
    hi, lo = ref_hashing.np_to_limbs(np.asarray(uids, dtype=np.uint64))
    order, rank = ref_topology.ring_permutations(np, hi, lo, 10)
    port_order, port_rank = port_topology.ring_permutations(
        torch.from_numpy(hi.astype(np.int64)),
        torch.from_numpy(lo.astype(np.int64)), 10)
    assert np.array_equal(order, port_order)
    assert np.array_equal(rank, port_rank)
    rng = np.random.default_rng(3)
    members = rng.random((6, n)) < 0.6
    members[0] = False          # empty view
    members[1] = True
    members[2, :] = False
    members[2, 5] = True        # single member
    got = port_topology.build_topology(torch.from_numpy(members),
                                       torch.from_numpy(order),
                                       torch.from_numpy(rank))
    pos = port_paxos.ring0_positions(torch.from_numpy(members),
                                     torch.from_numpy(order),
                                     torch.from_numpy(rank))
    for r in range(members.shape[0]):
        want = ref_topology.build_topology(np, members[r], order, rank)
        for g, w in zip(got, want):
            assert np.array_equal(g[r].numpy(), np.asarray(w))
        want_pos = ref_paxos.ring0_positions(np, members[r], order, rank)
        assert np.array_equal(pos[r].numpy(), want_pos)


def test_flags_decode_and_check():
    assert port_rx.decode_flags(0) == []
    assert port_rx.decode_flags(port_rx.FLAG_RING_COLLISION | 1) == \
        ref_rx.decode_flags(ref_rx.FLAG_RING_COLLISION | 1)
    with pytest.raises(port_rx.ReceiverEnvelopeError,
                       match="delivery-ring-collision"):
        port_rx.check_flags(torch.tensor(port_rx.FLAG_RING_COLLISION))


@pytest.mark.parametrize("kw", [{"rx_kernel": "xla"},
                                {"rx_kernel": "packed"}])
def test_out_of_slice_settings_raise(kw):
    """Every layout runs now; a carry in another layout than the one
    ``rx_kernel`` names raises instead of being converted: a packed
    bundle under "xla", a stacked dense fleet under "packed"."""
    from rapid_tpu_torch.engine import fleet

    sched = port_faults.crash_window_delay_schedule(16)
    settings = Settings(**kw)
    other = Settings(rx_kernel="pallas" if kw["rx_kernel"] == "xla"
                     else "xla")
    member = port_rx.lower_receiver_schedule(sched, other, device="cpu")
    with pytest.raises(TypeError, match=f"rx_kernel='{kw['rx_kernel']}'"):
        if kw["rx_kernel"] == "xla":
            port_rx.receiver_simulate(member.state, member.faults, 2,
                                      settings)
        else:
            fleet.receiver_fleet_simulate(
                fleet.stack_receiver_members([member]), 2, settings,
                device="cpu")


def test_schedule_guards():
    settings = Settings(rx_kernel="pallas")
    sched = port_faults.AdversarySchedule(
        n=16, delays=(port_faults.DelayRule(
            src_slots=frozenset({0}), dst_slots=frozenset({1}),
            delay_ticks=3, jitter_ticks=2),))
    with pytest.raises(port_faults.DelayBudgetError) as err:
        port_rx.lower_receiver_schedule(sched, settings, device="cpu")
    assert err.value.ring_depth == 4 and err.value.max_delay == 5
    with pytest.raises(ValueError, match="scripted"):
        port_rx.lower_receiver_schedule(
            port_faults.AdversarySchedule(n=16, proposes=(object(),)),
            settings, device="cpu")


def test_settings_validation_matches_reference():
    for kw in ({"K": 2}, {"H": 11}, {"delivery_ring_depth": 0},
               {"rx_kernel": "dense"}, {"rx_epoch_delta_bits": 12}):
        with pytest.raises(ValueError):
            RefSettings(**kw)
        with pytest.raises(ValueError):
            Settings(**kw)
    assert [f for f in Settings.__dataclass_fields__] == \
        [f for f in RefSettings.__dataclass_fields__]


def test_link_faults_and_from_reference_agree():
    from rapid_tpu.engine.state import link_faults as ref_link_faults
    from rapid_tpu_torch.engine.state import link_faults as port_link_faults

    sched = port_faults.crash_window_delay_schedule(32)
    crash = sched.crash_tick_array().tolist()
    ref = ref_link_faults(crash, sched.windows, 32, delays=sched.delays,
                          delay_seed=sched.seed)
    port = port_link_faults(crash, sched.windows, 32, delays=sched.delays,
                            delay_seed=sched.seed, device="cpu")
    carried = from_reference(ref, device="cpu")
    assert port.n_windows == ref.n_windows == 1
    assert port.n_delay_rules == ref.n_delay_rules == 1
    arrays = to_numpy(port)
    for field in port.DROP_CONFIG:
        assert arrays.pop(field) == getattr(ref, field) == \
            getattr(carried, field)
    assert arrays.pop("drop_targets") is None
    assert ref.drop_targets is None and carried.drop_targets is None
    for field, want in arrays.items():
        got = np.asarray(getattr(ref, field))
        assert want.dtype == got.dtype and np.array_equal(want, got), field
        assert torch.equal(getattr(carried, field), getattr(port, field))
