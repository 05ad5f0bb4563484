"""The fleet golden files: the reference's pools at a campaign's shape.

``testdata/fleet_pool{0,1,2,3}.json`` hold the first 256 members of each
pool of the campaign of ``benchmarks/campaign_4096.json``'s shape (seed 0,
N=32, 120 ticks, headroom 16, default weights; ``golden.FLEET_CAMPAIGN``),
made by the reference's own functions (``campaign._member_seed``,
``_sample_scenario``, ``_lower_shared``, the routing predicates and the
pool keys of ``_build_pools``): pool 0 the shared crash and churn
members, pool 1 the contested ones (both at C=48 with a 16-row flight
recorder), pool 2 the per-receiver latency members and pool 3 the
partition and flip-flop ones (both at C=32, run by the reference on its
dense carry). Each file records every member's index, seed, kind,
schedule and churn draw, its events and final config ids, one SHA-256
over its log fields and one over its final fields, the shared pools'
recorder rows and stamps, the stack shape, and per field one SHA-256 over
all 256 members. ``chip_smoke.py`` phase 17 holds the card's F=256 runs
to them.

Here (tier 1) the port's sampler reproduces all 1,024 recorded
schedules, and the port's CPU runs of the first 16 members of pools 0
and 3, stacked to the pool's shape, equal the files. Regenerating them
from the reference takes minutes and is marked ``slow``; regenerate with
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_fleet_golden.py``.
Tolerance: exact.
"""
import numpy as np
import pytest
import torch

from rapid_tpu_torch import faults, golden

HEAD = 16


@pytest.fixture
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("pool_id", sorted(golden.FLEET_POOLS))
def test_sampler_reproduces_the_recorded_schedules(pool_id):
    pool = golden.FLEET_POOLS[pool_id]
    want = golden.load(pool.path)
    camp = want["campaign"]
    assert camp == golden.FLEET_CAMPAIGN
    assert want["shape"] == list(pool.shape)
    assert len(want["members"]) == camp["fleet_size"]
    for m in want["members"]:
        seed = golden.member_seed(m["index"], camp["seed"])
        drawn = faults.sample_adversary_schedule(
            camp["n"], seed, camp["ticks"], ring_depth=camp["ring_depth"])
        assert m["seed"] == seed and m["kind"] == drawn.kind
        assert m["kind"] in pool.kinds
        assert golden.schedule_json(drawn.schedule) == m["schedule"]
        assert golden.schedule_json(golden.schedule_from_json(
            m["schedule"])) == m["schedule"]
        churn = (golden.churn_params(seed, camp["headroom"])
                 if drawn.wants_churn else None)
        assert m["churn"] == churn


@pytest.mark.parametrize("pool_id", [0, 3])
def test_port_cpu_run_equals_the_pool_golden(pool_id, few_threads):
    pool = golden.FLEET_POOLS[pool_id]
    want = golden.pool_head(golden.load(pool.path), HEAD)
    members = golden.pool_inputs(want)
    got = golden.pool_head(golden.fleet_run_record(
        pool, members, golden.run_pool(pool, members, device="cpu")), HEAD)
    assert golden.differences(got, want) == []


def reference_pool_members():
    """``{pool_id: [(index, SampledScenario)]}``: the first
    ``fleet_size`` members of each pool, in campaign index order, routed
    and keyed as the reference's campaign routes them."""
    from rapid_tpu import campaign as ref_campaign

    camp = golden.FLEET_CAMPAIGN
    cfg = ref_campaign.CampaignConfig(
        clusters=4096, n=camp["n"], ticks=camp["ticks"], seed=camp["seed"],
        fleet_size=camp["fleet_size"], headroom=camp["headroom"],
        flight_recorder=camp["recorder"])
    pool_of = {("shared", (False, False)): 0, ("shared", (False, True)): 1,
               ("per_receiver", (False, True)): 2,
               ("per_receiver", (True, False)): 3}
    pools = {pid: [] for pid in golden.FLEET_POOLS}
    idx = 0
    while any(len(v) < camp["fleet_size"] for v in pools.values()):
        sc = ref_campaign._sample_scenario(cfg, idx)
        if ref_campaign._receiver_eligible(sc) or \
                ref_campaign._delay_member(sc):
            key = ("per_receiver",
                   ref_campaign._rx_pool_key(ref_campaign._rx_dims(sc)))
        else:
            key = ("shared", ref_campaign._shared_pool_key(
                ref_campaign._shared_dims(sc)))
        members = pools[pool_of[key]]
        if len(members) < camp["fleet_size"]:
            members.append((idx, sc))
        idx += 1
    return cfg, pools


def reference_pool_run(pool_id: int, cfg=None, pools=None):
    """The reference's run of one pool: ``(members, logs, finals,
    recorders)``, the member entries and NamedTuples of numpy arrays
    (per-receiver finals cut to ``ReceiverFinalView``'s fields, no
    recorders)."""
    from rapid_tpu import campaign as ref_campaign
    from rapid_tpu.engine import fleet as ref_fleet
    from rapid_tpu.settings import Settings as RefSettings

    if pools is None:
        cfg, pools = reference_pool_members()
    pool = golden.FLEET_POOLS[pool_id]
    camp = golden.FLEET_CAMPAIGN
    members = pools[pool_id]
    metas = []
    for idx, sc in members:
        seed = ref_campaign._member_seed(cfg, idx)
        metas.append({
            "index": idx, "seed": seed, "kind": sc.kind,
            "schedule": golden.schedule_json(sc.schedule),
            "churn": (golden.churn_params(seed, camp["headroom"])
                      if sc.wants_churn else None)})
    numpy = lambda nt: type(nt)(*[np.asarray(x) for x in nt])
    if pool.mode == "shared":
        settings = RefSettings(capacity=pool.capacity,
                               flight_recorder_window=camp["recorder"])
        lowered = [ref_campaign._lower_shared(cfg, settings, idx, sc)
                   for idx, sc in members]
        shape = (max(m.faults.n_windows for m in lowered),
                 max(m.fallback.inst_epoch.shape[0] for m in lowered),
                 max(m.fallback.table_mask.shape[1] for m in lowered))
        stacked = ref_fleet.stack_members(lowered, n_windows=shape[0],
                                          n_instances=shape[1],
                                          n_pids=shape[2])
        finals, logs, recs = ref_fleet.fleet_simulate(
            stacked, camp["ticks"], settings)
        finals, recs = numpy(finals), numpy(recs)
    else:
        settings = RefSettings(capacity=pool.capacity)
        lowered = [ref_fleet.lower_receiver_schedule(
            sc.schedule, settings, fleet_size=len(members))
            for _, sc in members]
        shape = (max(m.faults.n_windows for m in lowered),
                 max(m.faults.n_delay_rules for m in lowered))
        stacked = ref_fleet.stack_receiver_members(
            lowered, n_windows=shape[0], n_delay_rules=shape[1])
        finals, logs = ref_fleet.receiver_fleet_simulate(
            stacked, camp["ticks"], settings)
        from rapid_tpu_torch.engine.rx_packed import ReceiverFinalView
        finals = ReceiverFinalView(*[np.asarray(getattr(finals, f))
                                     for f in ReceiverFinalView._fields])
        recs = None
    assert shape == pool.shape, (pool_id, shape)
    return metas, numpy(logs), finals, recs


def reference_pool_record(pool_id: int, cfg=None, pools=None) -> dict:
    """The reference's record of one pool."""
    return golden.pool_record(golden.FLEET_POOLS[pool_id],
                              *reference_pool_run(pool_id, cfg, pools))


@pytest.mark.slow
@pytest.mark.parametrize("pool_id", sorted(golden.FLEET_POOLS))
def test_pool_golden_matches_reference(pool_id):
    rec = reference_pool_record(pool_id)
    assert golden.dumps(rec) == golden.FLEET_POOLS[pool_id].path.read_text()


if __name__ == "__main__":
    import sys

    cfg, pools = reference_pool_members()
    for pool_id in map(int, sys.argv[1:] or sorted(golden.FLEET_POOLS)):
        path = golden.FLEET_POOLS[pool_id].path
        path.write_text(golden.dumps(reference_pool_record(pool_id, cfg,
                                                           pools)))
        print("wrote", path, path.stat().st_size, "bytes")
