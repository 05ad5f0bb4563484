"""One cluster's slot universe split over a slot mesh of several devices
(``rapid_tpu_torch.engine.sharding``), on entries of the CPU, against the
JAX reference.

- ``tests/test_sharding.py``'s three scenarios (a steady crash burst at
  N=64, contested consensus at N=16, churn at N=24 in 64 slots), and
  probe drop with a two-way and a flip-flop window at N=64, on
  ``slot_mesh(D)`` for D in {2, 4, 8}: logs and final state equal to the
  reference's ``simulate``; chained ``simulate_chunk`` calls on four
  shards equal one run; the N=1,000 golden files at D=8; ring, hier,
  the invariant monitor and the flight recorder at D=4; an identifier
  redraw at D=4; a capacity that does not divide the mesh (N=20, D=8)
  replicates, as the reference's divisibility guard does.
- The split is real: every shard's tick holds ``C / D`` slots of every
  leaf the reference's ``spec_for`` puts on the slot axis, and
  ``cut.aggregate`` runs on ``[C / D, K]``.
- A reference state placed on its 8-way mesh carries across
  (``convert.from_reference``) and runs on the port's 4-way mesh.
- ``profile.kernel_cases`` at D=4: each sub-kernel's joined outputs
  equal the unsharded ones and the reference's closures';
  ``multichip_comparison`` on listed devices.
- ``diff.run_differential`` / ``run_variant_differential`` on
  ``slot_mesh(8)`` equal the reference with and without its mesh;
  ``multichip.dryrun_multichip(8, device="cpu")`` is ok with the
  reference's config id.
- ``sharding.run_spmd``: a shard that raises, leaves early or skips a
  collective fails the run with its rank, within the barrier timeout.

Everything is integer or bool: the tolerance is exact.
"""
import dataclasses
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from rapid_tpu import hashing as ref_hashing
from rapid_tpu.engine import diff as ref_diff
from rapid_tpu.engine import sharding as ref_sharding
from rapid_tpu.engine import state as ref_state
from rapid_tpu.engine.churn import empty_schedule as ref_churn_empty
from rapid_tpu.engine.churn import synthetic_churn_schedule as \
    ref_churn_schedule
from rapid_tpu.engine.paxos import synthetic_contested_schedule as \
    ref_contested
from rapid_tpu.engine.step import simulate as ref_simulate
from rapid_tpu.faults import LinkWindow as RefWindow
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch import golden, multichip
from rapid_tpu_torch.convert import from_reference, to_numpy
from rapid_tpu_torch.engine import cut, diff, sharding, step
from rapid_tpu_torch.engine.paxos import empty_fallback_schedule
from rapid_tpu_torch.engine.state import crash_faults, init_state
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry import profile

I32_MAX = ref_state.I32_MAX


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ref_mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest-forced 8-device CPU mesh")
    return ref_sharding.slot_mesh(8)


def _uids(n: int):
    """``tests/test_sharding.py``'s synthetic identities."""
    hi, lo = ref_hashing.np_to_limbs(np.arange(1, n + 1, dtype=np.uint64))
    hi, lo = ref_hashing.hash64_limbs(np, hi, lo, seed=0xBEEF)
    return [int(u) for u in ref_hashing.np_from_limbs(hi, lo)]


def _assert_same(port_nt, ref_nt, what):
    port_np = to_numpy(port_nt)
    for name in ref_nt._fields:
        want = np.asarray(getattr(ref_nt, name))
        got = np.asarray(getattr(port_np, name))
        assert got.dtype == want.dtype and got.shape == want.shape, \
            f"{what}.{name}"
        if not np.array_equal(got, want):
            first = np.argwhere(got != want)[0].tolist() if got.ndim else []
            pytest.fail(f"{what}.{name} differs first at {first}")


# ---------------------------------------------------------------------------
# the reference's three scenarios
# ---------------------------------------------------------------------------


def _crash_scenario(settings):
    n = 64
    crash = [I32_MAX] * n
    for slot in (3, 17, 40):
        crash[slot] = 5
    return dict(uids=_uids(n), faults=ref_state.crash_faults(crash),
                ticks=130, member=None, id_fps=None, churn=None,
                fallback=None)


def _drop_windows_scenario(settings):
    """Probe drop p=0.3 on every edge, a two-way window and a flip-flop
    one: the monitor's reads of other shards' crash ticks, window masks
    and identities."""
    n = 64
    crash = [I32_MAX] * n
    crash[50] = 5
    windows = (RefWindow(src_slots=frozenset(range(4)),
                         dst_slots=frozenset(range(4, 12)), start_tick=3,
                         two_way=True),
               RefWindow(src_slots=frozenset(range(30, 34)),
                         dst_slots=frozenset(range(40, 64)), start_tick=20,
                         period_ticks=20))
    base = ref_state.link_faults(crash, windows, n)
    faults = ref_state.EngineFaults(
        base.crash_tick, drop_p=0.3, drop_seed=7, link_src=base.link_src,
        link_dst=base.link_dst, link_start=base.link_start,
        link_end=base.link_end, link_period=base.link_period,
        link_two_way=base.link_two_way)
    return dict(uids=_uids(n), faults=faults, ticks=200, member=None,
                id_fps=None, churn=None, fallback=None)


def _contested_scenario(settings):
    n, ticks = 16, 120
    uids = _uids(n)
    schedule, _ = ref_contested(n, settings, ticks, uids=uids)
    return dict(uids=uids, faults=ref_state.crash_faults([I32_MAX] * n),
                ticks=ticks, member=None, id_fps=None, churn=None,
                fallback=schedule)


def _churn_scenario(settings):
    n, burst, ticks = 24, 8, 120
    period = settings.churn_decide_delay_ticks + 3
    capacity = n + max(1, (ticks - 10) // (2 * period)) * burst
    schedule, id_fps, _ = ref_churn_schedule(capacity, n, settings,
                                             start=10, burst=burst,
                                             period=period)
    member = np.zeros(capacity, bool)
    member[:n] = True
    return dict(uids=_uids(capacity),
                faults=ref_state.crash_faults([I32_MAX] * capacity),
                ticks=ticks, member=member, id_fps=id_fps, churn=schedule,
                fallback=None)


REDRAW_SLOT, REDRAW_UID = 25, 0x1234_5678_9ABC_DEF0


def _redraw_scenario(settings):
    """Dormant slot 25 of 32 (24 members) redraws its identifier at
    tick 7 (``churn.apply_redraws``)."""
    cap, n = 32, 24
    sched = ref_churn_empty(cap)
    redraw = {name: np.zeros(cap, np.uint32) for name in (
        "redraw_hi", "redraw_lo", "redraw_idfp_hi", "redraw_idfp_lo")}
    redraw["redraw_tick"] = np.full(cap, I32_MAX, np.int32)
    redraw["redraw_tick"][REDRAW_SLOT] = 7
    redraw["redraw_hi"][REDRAW_SLOT] = REDRAW_UID >> 32
    redraw["redraw_lo"][REDRAW_SLOT] = REDRAW_UID & 0xFFFF_FFFF
    redraw["redraw_idfp_lo"][REDRAW_SLOT] = 99
    return dict(uids=_uids(cap),
                faults=ref_state.crash_faults([I32_MAX] * cap), ticks=12,
                member=np.arange(cap) < n, id_fps=None,
                churn=sched._replace(**redraw), fallback=None)


SCENARIOS = {"crash": _crash_scenario, "contested": _contested_scenario,
             "churn": _churn_scenario,
             "drop_windows": _drop_windows_scenario,
             "redraw": _redraw_scenario}
_REF = {}


def _reference(name: str, **options):
    """The scenario and the reference's unsharded run of it."""
    key = (name, tuple(sorted(options.items())))
    if key not in _REF:
        settings = RefSettings(**options)
        sc = SCENARIOS[name](settings)
        state = ref_state.init_state(sc["uids"], id_fp_sum=0,
                                     settings=settings, member=sc["member"],
                                     id_fps=sc["id_fps"])
        _REF[key] = (sc, ref_simulate(state, sc["faults"], sc["ticks"],
                                      settings, sc["churn"],
                                      sc["fallback"]))
    return _REF[key]


def _port_inputs(sc):
    state = init_state(sc["uids"], 0, Settings(), member=sc["member"],
                       id_fps=sc["id_fps"], device="cpu")
    port = lambda x: None if x is None else from_reference(x, "cpu")
    return state, port(sc["faults"]), port(sc["churn"]), port(
        sc["fallback"])


def _run_on(mesh, sc, settings=None):
    state, faults, churn, fallback = _port_inputs(sc)
    c = int(state.member.shape[0])
    return step.simulate(sharding.shard_put(state, mesh, c),
                         sharding.shard_put(faults, mesh, c), sc["ticks"],
                         settings or Settings(), churn=churn,
                         fallback=fallback, mesh=mesh, device="cpu")


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("name", ["crash", "contested", "churn",
                                  "drop_windows"])
def test_scenario_on_a_slot_mesh_equals_the_reference(name, n_dev):
    sc, (want_final, want_logs) = _reference(name)
    final, logs = _run_on(sharding.slot_mesh(n_dev, device="cpu"), sc)
    _assert_same(logs, want_logs, "logs")
    _assert_same(final, want_final, "final")
    if name == "drop_windows":
        assert int(logs.probes_failed.sum()) > 0
        assert int(logs.partitioned_edges.max()) > 0
    else:
        decides = int(logs.decide_now.sum())
        assert decides >= {"crash": 1, "contested": 1, "churn": 2}[name]


def test_chunks_on_a_slot_mesh_equal_one_run():
    """``simulate_chunk`` chained three times on four shards, the flight
    recorder resuming across the joins and splits, equals one unsplit
    ``simulate`` of the summed length."""
    sc, _ = _reference("contested")
    settings = Settings(flight_recorder_window=16)
    state, faults, _, fallback = _port_inputs(sc)
    want = step.simulate(state, faults, sc["ticks"], settings,
                         fallback=fallback, device="cpu")
    mesh = sharding.slot_mesh(4, device="cpu")
    rec, logs = None, []
    for ticks in (19, 41, sc["ticks"] - 60):
        state, log, rec = step.simulate_chunk(
            state, faults, ticks, settings, fallback=fallback, mesh=mesh,
            rec=rec, device="cpu")
        logs.append(log)
    joined = type(logs[0])(*[torch.cat(col) for col in zip(*logs)])
    for got, exp in ((state, want[0]), (joined, want[1]), (rec, want[2])):
        for a, b in zip(got, exp):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["shared_n1000_crash",
                                  "shared_n1000_churn",
                                  "shared_n1000_contested"])
def test_n1000_golden_on_eight_shards(name):
    sc = golden.SCENARIOS[name]
    rec = golden.run_scenario(sc, device="cpu",
                              mesh=sharding.slot_mesh(8, device="cpu"))
    assert golden.differences(rec, golden.load(sc.path)) == []


@pytest.mark.parametrize("options", [
    dict(protocol_variant="ring"), dict(protocol_variant="hier"),
    dict(invariant_checks=True), dict(flight_recorder_window=16)],
    ids=["ring", "hier", "invariants", "recorder"])
def test_options_on_four_shards_equal_the_reference(options):
    sc, want = _reference("crash", **options)
    got = _run_on(sharding.slot_mesh(4, device="cpu"), sc,
                  Settings(**options))
    _assert_same(got[1], want[1], "logs")
    _assert_same(got[0], want[0], "final")
    if "flight_recorder_window" in options:
        _assert_same(got[2], want[2], "recorder")
    if "invariant_checks" in options:
        assert not np.asarray(want[1].inv_bits).any()


def test_identifier_redraw_on_four_shards():
    """A dormant slot on shard 3 redraws its identity at tick 7: its
    owner writes it (``first_true`` finds it), the ring tables move on
    every shard, and the run equals the reference's."""
    sc, (want_final, want_logs) = _reference("redraw")
    final, logs = _run_on(sharding.slot_mesh(4, device="cpu"), sc)
    _assert_same(logs, want_logs, "logs")
    _assert_same(final, want_final, "final")
    assert int(final.uid_lo[REDRAW_SLOT]) == REDRAW_UID & 0xFFFF_FFFF


def test_non_dividing_capacity_replicates_and_equals_the_reference(
        ref_mesh8):
    """N=20 on eight devices: the reference's guard replicates every
    leaf; the port runs the whole cluster on the mesh's first device."""
    n, ticks = 20, 120
    uids = _uids(n)
    crash = [I32_MAX] * n
    crash[4] = 5
    ref_st = ref_state.init_state(uids, id_fp_sum=0, settings=RefSettings())
    ref_fa = ref_state.crash_faults(crash)
    assert ref_sharding.spec_for((n,), n, ref_mesh8) == \
        jax.sharding.PartitionSpec()
    want_final, want_logs = ref_simulate(
        ref_sharding.shard_put(ref_st, ref_mesh8, n),
        ref_sharding.shard_put(ref_fa, ref_mesh8, n), ticks, RefSettings(),
        mesh=ref_mesh8)
    mesh = sharding.slot_mesh(8, device="cpu")
    put = sharding.shard_put(init_state(uids, 0, Settings(), device="cpu"),
                             mesh, n)
    assert len(put.shards) == 1 and put.devices == mesh.devices[:1]
    final, logs = step.simulate(put, crash_faults(crash, device="cpu"),
                                ticks, Settings(), mesh=mesh, device="cpu")
    _assert_same(logs, want_logs, "logs")
    _assert_same(final, want_final, "final")


# ---------------------------------------------------------------------------
# the split is real
# ---------------------------------------------------------------------------


def test_shard_local_carries_are_partitioned(ref_mesh8, monkeypatch):
    """The counterpart of the reference's ``_assert_partitioned``: every
    leaf the reference's ``spec_for`` puts on the slot axis holds ``C /
    D`` rows in each shard's tick (one cluster runs as a fleet of one,
    so every leaf has a member axis of 1 in front), every other leaf its
    whole shape, and ``cut.aggregate_device`` runs on ``[1, C / D, K]``."""
    sc, (want_final, _) = _reference("contested")
    c, d = 16, 8
    seen_states, seen_reports = [], []
    real_step, real_agg = step._fleet_step, cut.aggregate_device

    def spy_step(state, *args, **kw):
        seen_states.append((threading.get_ident(), state))
        return real_step(state, *args, **kw)

    def spy_agg(state, *args, **kw):
        seen_reports.append(tuple(state.reports.shape))
        return real_agg(state, *args, **kw)

    monkeypatch.setattr(step, "_fleet_step", spy_step)
    monkeypatch.setattr(cut, "aggregate_device", spy_agg)
    final, _ = _run_on(sharding.slot_mesh(d, device="cpu"), sc)
    _assert_same(final, want_final, "final")
    assert len({tid for tid, _ in seen_states}) == d
    assert len(seen_states) == d * sc["ticks"]
    for _, state in seen_states:
        for name, leaf, ref_leaf in zip(state._fields, state, want_final):
            shape = np.asarray(ref_leaf).shape
            spec = tuple(ref_sharding.spec_for(shape, c, ref_mesh8))
            want = [1] + list(shape)
            if sharding.AXIS in spec:
                want[1 + spec.index(sharding.AXIS)] = c // d
            assert list(leaf.shape) == want, name
    assert seen_reports and set(seen_reports) == {(1, c // d,
                                                   Settings().K)}


def test_reference_state_on_its_mesh_carries_across(ref_mesh8):
    """A reference state placed on its 8-way mesh, converted, runs on the
    port's 4-way mesh and equals the reference's sharded run."""
    sc, _ = _reference("crash")
    n = len(sc["uids"])
    ref_st = ref_sharding.shard_put(
        ref_state.init_state(sc["uids"], id_fp_sum=0,
                             settings=RefSettings()), ref_mesh8, n)
    ref_fa = ref_sharding.shard_put(sc["faults"], ref_mesh8, n)
    assert sharding.AXIS in tuple(ref_st.member.sharding.spec)
    want_final, want_logs = ref_simulate(ref_st, ref_fa, sc["ticks"],
                                         RefSettings(), mesh=ref_mesh8)
    final, logs = step.simulate(
        from_reference(ref_st, "cpu"), from_reference(ref_fa, "cpu"),
        sc["ticks"], Settings(), mesh=sharding.slot_mesh(4, device="cpu"),
        device="cpu")
    _assert_same(logs, want_logs, "logs")
    _assert_same(final, want_final, "final")


# ---------------------------------------------------------------------------
# the observatory's sub-kernels, the differentials, the dry run
# ---------------------------------------------------------------------------


def _leaves_equal(a, b, what):
    from torch.utils import _pytree

    xs, ys = _pytree.tree_leaves(a), _pytree.tree_leaves(b)
    assert len(xs) == len(ys), what
    for x, y in zip(xs, ys):
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), what
        else:
            assert x == y, what


def _flat(tree, port: bool):
    """Leaves as ``(path, numpy array)`` in the reference's dtypes."""
    if hasattr(tree, "_fields"):
        fields = to_numpy(tree) if port else tree
        return [(f"{type(tree).__name__}.{name}", np.asarray(leaf))
                for name, leaf in zip(tree._fields, fields)]
    if isinstance(tree, dict):  # a jitted result has its keys sorted
        return [(f"{k}.{p}", a) for k, v in sorted(tree.items())
                for p, a in _flat(v, port)]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}].{p}", a) for i, v in enumerate(tree)
                for p, a in _flat(v, port)]
    return [("", np.asarray(tree.numpy() if port else tree))]


def test_kernel_cases_on_four_shards_equal_the_reference():
    """Each sub-kernel of ``profile.kernel_cases`` on four shards: its
    joined outputs equal the unsharded ones and the reference's closure's
    (jitted), output by output."""
    from rapid_tpu.engine import paxos as ref_paxos
    from rapid_tpu.telemetry import profile as ref_profile

    settings = Settings()
    state, faults = profile.synthetic_state(256, settings, device="cpu")
    fallback = from_reference(empty_fallback_schedule(256), "cpu")
    plain = profile.kernel_cases(state, faults, settings, fallback)
    sharded = profile.kernel_cases(state, faults, settings, fallback,
                                   mesh=sharding.slot_mesh(4, device="cpu"))
    ref_st, ref_fa = ref_profile.synthetic_state(256, RefSettings())
    ref = ref_profile.kernel_cases(
        ref_st, ref_fa, RefSettings(),
        fallback=ref_paxos.empty_fallback_schedule(256))
    assert [c[0] for c in sharded] == [c[0] for c in plain] == \
        [c[0] for c in ref] == list(profile.KERNEL_ORDER)
    for (name, fn, args), (_, s_fn, s_args), (_, r_fn, r_args) in zip(
            plain, sharded, ref):
        assert isinstance(s_args[0], sharding.SlotShards), name
        got = s_fn(*s_args)
        _leaves_equal(got, fn(*args), name)
        if name == "cut_aggregate":  # the port's one read: announce
            got = got[:-1]
        elif name == "paxos_phase1a_deliver":  # the port's count is bare
            got = (got[0], {"px1b_senders": got[1]})
        got, want = _flat(got, True), _flat(jax.jit(r_fn)(*r_args), False)
        assert [p for p, _ in got] == [p for p, _ in want], name
        for (path, a), (_, b) in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, (name, path)
            assert np.array_equal(a, b), (name, path)


def test_multichip_comparison_on_listed_devices():
    block = profile.multichip_comparison([64, 62], Settings(), repeats=1,
                                         devices=["cpu"] * 4)
    assert block["n_devices"] == 4 and block["axis"] == sharding.AXIS
    assert [(e["kernel"], e["n"]) for e in block["kernels"]] == [
        (k, 64) for k in profile.MULTICHIP_KERNELS]
    assert all(e["sharded_wall_median_s"] > 0 for e in block["kernels"])
    assert profile.multichip_comparison([64], Settings(),
                                        device="cpu") is None


def test_differentials_on_eight_shards_equal_the_reference(ref_mesh8):
    mesh = sharding.slot_mesh(8, device="cpu")
    port = diff.run_differential(16, {2: 3}, 130, mesh=mesh, device="cpu")
    port.assert_identical()
    for ref_mesh in (None, ref_mesh8):
        want = ref_diff.run_differential(16, {2: 3}, 130, mesh=ref_mesh)
        assert [dataclasses.astuple(e) for e in port.engine_events] == \
            [dataclasses.astuple(e) for e in want.engine_events]
        assert port.engine_counters == want.engine_counters
        assert port.engine_config_id == want.engine_config_id
    for variant in ("ring", "hier"):
        got = diff.run_variant_differential(16, {2: 3}, 130, variant,
                                            mesh=mesh, device="cpu")
        got.assert_identical()
        want = ref_diff.run_variant_differential(16, {2: 3}, 130, variant,
                                                 mesh=ref_mesh8)
        assert got.engine_counters == want.engine_counters
        assert got.engine_config_id == want.engine_config_id


def test_dryrun_multichip_on_eight_cpu_shards(capsys):
    got = multichip.dryrun_multichip(8, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == got
    want = ref_diff.run_differential(multichip.BASELINE_N,
                                     multichip.BASELINE_CRASHES,
                                     multichip.BASELINE_TICKS)
    assert got["ok"] and not got["skipped"]
    assert got["config_id"] == want.engine_config_id
    assert got["counters_checked"] == multichip.BASELINE_TICKS
    assert set(got) == {"bench", "ok", "skipped", "n_devices", "mesh_axis",
                        "n", "n_ticks", "crashes", "config_id",
                        "counters_checked"}
    with pytest.raises(ValueError, match="need 8 devices for the slot"):
        multichip.dryrun_multichip(8, devices=["cpu"] * 3, device="cpu")


def test_dryrun_multichip_skips_without_cards(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    got = multichip.dryrun_multichip(8)
    assert got["skipped"] and not got["ok"]
    assert got["marker"] == "__GRAFT_DRYRUN_SKIP__"
    assert multichip.main(["--n-devices", "8"]) == 0


# ---------------------------------------------------------------------------
# run_spmd: no hang, no fallback
# ---------------------------------------------------------------------------


def _parts(n: int):
    return sharding.SlotShards(tuple(range(n)), (torch.device("cpu"),) * n,
                               4 * n)


def test_a_shard_that_raises_fails_the_run_with_its_rank():
    def fn(g, shard):
        if g.rank == 2:
            raise ValueError("boom")
        g.sum(torch.tensor(1))
        return shard

    start = time.perf_counter()
    with pytest.raises(sharding.ShardError, match="shard 2 of 4") as info:
        sharding.run_spmd(fn, _parts(4), timeout=30)
    assert info.value.rank == 2
    assert isinstance(info.value.__cause__, ValueError)
    assert time.perf_counter() - start < 10


def test_a_shard_that_leaves_early_fails_the_run():
    def fn(g, shard):
        if g.rank != 1:
            g.any(torch.tensor(True))
        return shard

    start = time.perf_counter()
    with pytest.raises(sharding.ShardError, match="left the run") as info:
        sharding.run_spmd(fn, _parts(3), timeout=0.5)
    assert info.value.rank == 1
    assert time.perf_counter() - start < 10


def test_a_shard_that_stops_times_the_others_out():
    release = threading.Event()

    def fn(g, shard):
        if g.rank == 2:
            release.wait(5)
        return g.sum(torch.tensor(1))

    start = time.perf_counter()
    with pytest.raises(sharding.ShardError,
                       match="did not reach a collective") as info:
        sharding.run_spmd(fn, _parts(3), timeout=0.5)
    release.set()
    assert info.value.rank == 2
    assert time.perf_counter() - start < 10


def test_a_skipped_collective_is_caught_not_paired():
    def fn(g, shard):
        if g.rank != 0:
            g.sum(torch.tensor(1))
        return g.max(torch.tensor(g.rank))

    with pytest.raises(sharding.ShardError, match="another collective"):
        sharding.run_spmd(fn, _parts(2), timeout=30)


def test_collectives_combine_exactly():
    def fn(g, shard):
        mask = torch.zeros(4, dtype=torch.bool)
        if g.rank in (1, 2):
            mask[3 - g.rank] = True
        x = torch.arange(4, dtype=torch.int32) + 4 * g.rank
        hi = torch.tensor(0xFFFFFFFF, dtype=torch.int64)
        return (g.all_gather(x), g.sum(x.sum(), x), g.max(x.max()),
                g.min(x.min()), g.any(mask.any()), g.first_true(mask),
                g.sum64(hi, hi), g.at(x, 9), g.slots(4, "cpu"))

    out = sharding.run_spmd(fn, _parts(3), timeout=30)
    whole = torch.arange(12, dtype=torch.int32)
    for rank, (gathered, (total, xs), hi, lo, anyv, first, (h64, l64),
               at9, slots) in enumerate(out):
        assert torch.equal(gathered, whole)
        assert int(total) == 66 and xs.dtype == torch.int32
        assert xs.tolist() == [12, 15, 18, 21]
        assert (int(hi), int(lo), bool(anyv)) == (11, 0, True)
        assert int(first) == 6       # shard 1's slot 2
        assert (int(h64), int(l64)) == ((3 * 0xFFFFFFFF + 2) & 0xFFFFFFFF,
                                        (3 * 0xFFFFFFFF) & 0xFFFFFFFF)
        assert int(at9) == 9
        assert slots.tolist() == list(range(4 * rank, 4 * rank + 4))


def test_shards_run_only_on_their_mesh():
    sc, _ = _reference("crash")
    state, faults, _, _ = _port_inputs(sc)
    four = sharding.slot_mesh(4, device="cpu")
    put = sharding.shard_put(state, four, 64)
    with pytest.raises(ValueError, match="slot mesh it was split over"):
        step.simulate(put, faults, 2, Settings(), device="cpu")
    with pytest.raises(ValueError, match="split over"):
        step.simulate(put, faults, 2, Settings(), device="cpu",
                      mesh=sharding.slot_mesh(8, device="cpu"))


def test_vote_counts_on_shards_equal_the_whole():
    """Both tallies on four shards: the sorts and the run scan on the
    gathered votes, each shard's slots of the whole tally."""
    from rapid_tpu_torch.engine import votes

    rng = np.random.default_rng(3)
    pool = rng.integers(0, 2**32, (2, 3))
    pick = rng.integers(0, 3, 64)
    hi = torch.from_numpy(pool[0][pick])
    lo = torch.from_numpy(pool[1][pick])
    valid = torch.from_numpy(rng.random(64) < 0.8)
    parts = sharding.shard_put((hi, lo, valid),
                               sharding.slot_mesh(4, device="cpu"), 64)
    out = sharding.run_spmd(lambda g, sh: (
        votes.segmented_vote_count(*sh, group=g),
        votes.scan_vote_count(*sh, group=g),
        votes.count_fast_round(*sh, torch.tensor(64), group=g)), parts)
    want = votes.segmented_vote_count(hi, lo, valid)
    assert torch.equal(torch.cat([o[0] for o in out]), want)
    assert torch.equal(torch.cat([o[1] for o in out]), want)
    whole = votes.count_fast_round(hi, lo, valid, torch.tensor(64))
    for o in out:
        assert [int(x) for x in o[2]] == [int(x) for x in whole]
