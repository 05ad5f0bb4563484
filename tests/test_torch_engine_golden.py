"""The shared engine's committed golden runs against the JAX reference.

``rapid_tpu_torch/testdata/shared_*.json`` hold the reference's events,
per-tick ``StepLog`` scalars, expanded counters, final config id and
final-state digests on the ``golden.SHARED`` scenarios (160 ticks each);
``chip_smoke.py`` holds the card to them. Here each file is regenerated
from the reference and must be unchanged, and the port's CPU run of each
scenario must equal its file.
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

from rapid_tpu.engine import diff as ref_diff
from rapid_tpu.engine.state import EngineFaults as RefFaults
from rapid_tpu.engine.state import init_state as ref_init_state
from rapid_tpu.engine.state import link_faults as ref_link_faults
from rapid_tpu.engine.state import state_config_id as ref_config_id
from rapid_tpu.faults import LinkWindow as RefWindow
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch import golden
from rapid_tpu_torch.engine import step as port_step
from rapid_tpu_torch.identity import synthetic_uids
from rapid_tpu_torch.settings import Settings

ref_step = importlib.import_module("rapid_tpu.engine.step")
ROOT = Path(__file__).resolve().parents[1]


def _bench_engine():
    spec = importlib.util.spec_from_file_location(
        "bench_engine", ROOT / "benchmarks" / "bench_engine.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_record(sc: golden.SharedScenario) -> dict:
    settings = RefSettings()
    state = ref_init_state(_bench_engine().synthetic_uids(sc.n), 0, settings)
    base = ref_link_faults(sc.crash_ticks(),
                           [RefWindow(**vars(w)) for w in sc.windows()], sc.n)
    faults = RefFaults(
        base.crash_tick, drop_p=sc.drop_p, drop_seed=sc.drop_seed,
        link_src=base.link_src, link_dst=base.link_dst,
        link_start=base.link_start, link_end=base.link_end,
        link_period=base.link_period, link_two_way=base.link_two_way)
    final, logs = ref_step.simulate(state, faults, golden.SHARED_TICKS,
                                    settings)
    as_np = lambda nt: type(nt)(*[np.asarray(x) for x in nt])
    return golden.shared_record(
        sc.name, [e.as_dict() for e in ref_diff.engine_events(logs)],
        as_np(logs), ref_diff.expand_counters(logs), ref_config_id(final),
        as_np(final))


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


@pytest.fixture(scope="module")
def n1000():
    return reference_record(golden.SHARED["shared_n1000_crash"])


def test_n1000_golden_file_matches_reference(n1000):
    sc = golden.SHARED["shared_n1000_crash"]
    assert golden.dumps(n1000) == sc.path.read_text()
    kinds = [(e["tick"], e["kind"], len(e["slots"])) for e in n1000["events"]]
    assert kinds == [(112, "proposal", 10), (113, "view_change", 10)]


def test_port_cpu_run_equals_n1000_golden(few_threads):
    sc = golden.SHARED["shared_n1000_crash"]
    state, faults = sc.boot(device="cpu")
    final, logs = port_step.simulate(state, faults, golden.SHARED_TICKS,
                                     Settings(), device="cpu")
    got = golden.shared_run_record(sc.name, final, logs)
    assert golden.differences(got, golden.load(sc.path)) == []


@pytest.mark.parametrize("name", ["shared_n100k_crash",
                                  "shared_n100k_drop_flipflop"])
def test_port_cpu_run_equals_n100k_golden(name, few_threads):
    sc = golden.SHARED[name]
    state, faults = sc.boot(device="cpu")
    final, logs = port_step.simulate(state, faults, golden.SHARED_TICKS,
                                     Settings(), device="cpu")
    got = golden.shared_run_record(sc.name, final, logs)
    assert golden.differences(got, golden.load(sc.path)) == []


@pytest.mark.parametrize("name", ["shared_n100k_crash",
                                  "shared_n100k_drop_flipflop"])
def test_n100k_golden_file_matches_reference(name):
    sc = golden.SHARED[name]
    rec = reference_record(sc)
    assert golden.dumps(rec) == sc.path.read_text()
    if sc.crash_every:
        kinds = [(e["tick"], e["kind"], len(e["slots"]))
                 for e in rec["events"]]
        assert kinds == [(112, "proposal", 1000),
                         (113, "view_change", 1000)]
        assert rec["log"]["n_member"][-1] == 99_000
    else:
        assert rec["events"] == []
        assert max(rec["log"]["partitioned_edges"]) == 99_000_000


if __name__ == "__main__":
    for sc in golden.SHARED.values():
        sc.path.write_text(golden.dumps(reference_record(sc)))
        print("wrote", sc.path)
