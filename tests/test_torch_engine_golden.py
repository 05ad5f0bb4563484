"""The shared engine's committed golden runs against the JAX reference.

``rapid_tpu_torch/testdata/shared_*.json`` hold the reference's events,
per-tick ``StepLog`` scalars, expanded counters, final config id and
final-state digests on the ``golden.SHARED`` scenarios (160 ticks each:
crash bursts, probe drop with a flip-flop window, sustained churn and
contested consensus); ``chip_smoke.py`` holds the card to them. Here each
file is regenerated from the reference and must be unchanged, and the
port's CPU run of each scenario must equal its file.
Regenerate with
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_engine_golden.py``.
Tolerance: exact.
"""
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from rapid_tpu.engine import churn as ref_churn
from rapid_tpu.engine import diff as ref_diff
from rapid_tpu.engine import paxos as ref_paxos
from rapid_tpu.engine import recorder as ref_recorder
from rapid_tpu.engine.state import I32_MAX
from rapid_tpu.engine.state import EngineFaults as RefFaults
from rapid_tpu.engine.state import init_state as ref_init_state
from rapid_tpu.engine.state import link_faults as ref_link_faults
from rapid_tpu.engine.state import state_config_id as ref_config_id
from rapid_tpu.faults import LinkWindow as RefWindow
from rapid_tpu.oracle.membership_view import MembershipView, uid_of
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch import golden
from rapid_tpu_torch.identity import synthetic_uids

ref_step = importlib.import_module("rapid_tpu.engine.step")
ROOT = Path(__file__).resolve().parents[1]


def _bench_engine():
    spec = importlib.util.spec_from_file_location(
        "bench_engine", ROOT / "benchmarks" / "bench_engine.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_record(sc: golden.SharedScenario) -> dict:
    """The reference's run of ``sc``, built as ``bench_engine`` builds
    its crash, churn and contested runs; a planned scenario's schedule
    comes from the reference's ``plan_churn`` (in the churn
    differentials' identity universe), and the recorder's payload and the
    plan's prediction join the record where the scenario has them."""
    settings = RefSettings(protocol_variant=sc.variant,
                           invariant_checks=sc.invariant_checks,
                           flight_recorder_window=sc.recorder_window)
    c = sc.capacity(settings)
    uids = _bench_engine().synthetic_uids(c)
    churn = fallback = id_fps = plan = None
    id_fp_sum = 0
    if sc.planned:
        joins, leaves, crashes = sc.plan_calls()
        endpoints = ref_diff.default_endpoints(c)
        node_ids = ref_diff.default_node_ids(sc.n)
        plan = ref_churn.plan_churn(endpoints, sc.n, node_ids, sc.ticks,
                                    settings, joins=joins, leaves=leaves,
                                    crashes=crashes)
        churn, id_fps = plan.schedule, plan.id_fps
        uids = [uid_of(e) for e in endpoints]
        id_fp_sum = MembershipView(settings.K, node_ids, [])._id_fp_sum
    if sc.churn_burst:
        churn, id_fps, _ = ref_churn.synthetic_churn_schedule(
            c, sc.n, settings, start=10, burst=sc.churn_burst,
            period=sc.churn_period(settings))
    if sc.contested:
        fallback, _ = ref_paxos.synthetic_contested_schedule(
            sc.n, settings, golden.SHARED_TICKS, uids=uids)
    state = ref_init_state(uids, id_fp_sum, settings,
                           member=np.arange(c) < sc.n, id_fps=id_fps)
    base = ref_link_faults(sc.crash_ticks() + [I32_MAX] * (c - sc.n),
                           [RefWindow(**vars(w)) for w in sc.windows()], c)
    faults = RefFaults(
        base.crash_tick, drop_p=sc.drop_p, drop_seed=sc.drop_seed,
        link_src=base.link_src, link_dst=base.link_dst,
        link_start=base.link_start, link_end=base.link_end,
        link_period=base.link_period, link_two_way=base.link_two_way)
    out = ref_step.simulate(state, faults, sc.ticks, settings, churn=churn,
                            fallback=fallback)
    final, logs = out[:2]
    as_np = lambda nt: type(nt)(*[np.asarray(x) for x in nt])
    rec = golden.shared_record(
        sc.name, [e.as_dict() for e in ref_diff.engine_events(logs)],
        as_np(logs), ref_diff.expand_counters(logs), ref_config_id(final),
        as_np(final))
    if sc.recorder_window:
        rec["recorder"] = ref_recorder.recorder_payload(out[2])
    if plan is not None:
        rec["plan"] = golden.plan_record(plan)
    return rec


def _decides(rec: dict):
    return [(e["tick"], len(e["slots"])) for e in rec["events"]
            if e["kind"] == "view_change"]


def check_outcome(rec: dict) -> None:
    """What each scenario is for, on top of equality with its file."""
    sc = golden.SHARED[rec["name"]]
    n_member = rec["log"]["n_member"]
    if sc.churn_burst:
        # 12 join and 12 leave bursts of 8, one decide each.
        assert [k for _, k in _decides(rec)] == [8] * 24
        assert _decides(rec)[0][0] == 13
        assert max(rec["log"]["churn_injected"]) == 8
        assert max(n_member) == sc.n + 8 and n_member[-1] == sc.n
    elif sc.contested:
        # 8 split votes, each decided by the classic round 4 ticks
        # after the coordinator's timer fires; no fast-round decide.
        assert [k for _, k in _decides(rec)] == [1] * 8
        assert _decides(rec)[0][0] == 19
        assert n_member[-1] == sc.n - 8
        assert sum(rec["log"]["px2b_senders"]) > 0
        assert max(rec["log"]["px_coord_round"]) == 2
    elif sc.crash_every:
        kinds = [(e["tick"], e["kind"], len(e["slots"]))
                 for e in rec["events"]]
        burst = len(range(0, sc.n, sc.crash_every))
        assert kinds == [(112, "proposal", burst),
                         (113, "view_change", burst)]
        assert n_member[-1] == sc.n - burst
    else:
        assert rec["events"] == []
        assert max(rec["log"]["partitioned_edges"]) == \
            (sc.n // 100) * (sc.n - sc.n // 100)


@pytest.fixture
def few_threads():
    """The port's run is thousands of small ops. With JAX's CPU thread
    pools up in the same process, torch's default of one thread per core
    makes it several times slower than two threads do."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_synthetic_uids_match_the_reference_benchmark():
    for n in (1, 64, 1000):
        assert np.array_equal(synthetic_uids(n),
                              _bench_engine().synthetic_uids(n))


N1000 = sorted(name for name in golden.SHARED if "n1000" in name)
N100K = sorted(name for name in golden.SHARED if "n100k" in name)


@pytest.mark.parametrize("name", N1000)
def test_n1000_golden_file_matches_reference(name):
    rec = reference_record(golden.SHARED[name])
    assert golden.dumps(rec) == golden.SHARED[name].path.read_text()
    check_outcome(rec)


@pytest.mark.parametrize("name", N1000)
def test_port_cpu_run_equals_n1000_golden(name, few_threads):
    got = golden.run_scenario(golden.SHARED[name], device="cpu")
    assert golden.differences(got, golden.load(golden.SHARED[name].path)) \
        == []


@pytest.mark.parametrize("name", N100K)
def test_port_cpu_run_equals_n100k_golden(name, few_threads):
    got = golden.run_scenario(golden.SHARED[name], device="cpu")
    assert golden.differences(got, golden.load(golden.SHARED[name].path)) \
        == []


@pytest.mark.parametrize("name", N100K)
def test_n100k_golden_file_matches_reference(name):
    rec = reference_record(golden.SHARED[name])
    assert golden.dumps(rec) == golden.SHARED[name].path.read_text()
    check_outcome(rec)


if __name__ == "__main__":
    import sys

    for sc in golden.SHARED.values():
        if len(sys.argv) > 1 and sc.name not in sys.argv[1:]:
            continue
        sc.path.write_text(golden.dumps(reference_record(sc)))
        print("wrote", sc.path)
