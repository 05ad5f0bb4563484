"""The control (the reference with a stated guarantee broken, in the
program's place) and every fault a cell can have come out not correct;
the unbroken run comes out correct. The whole harness runs, on the CPU,
with its look for a chip skipped."""
import pytest
import torch

from conftest import tiny
from portbench import control


@pytest.mark.parametrize("engine", ["shared", "receiver", "contested"])
@pytest.mark.parametrize("fault", control.FAULTS)
def test_fault_comes_out_not_correct(engine, fault):
    workload, config, traffic = tiny(engine)
    res = control.check(workload["name"], 2**31 + 3, fault, 0.1,
                        torch.device("cpu"), workload, config, traffic)
    assert res["correct"] is False
    assert res["checks"]["output_mismatches"]["value"] > 0 or \
        res["checks"]["summary_mismatches"]["value"] > 0


@pytest.mark.parametrize("engine", ["shared", "receiver", "contested"])
def test_sound_run_comes_out_correct(engine):
    from portbench import run

    workload, config, traffic = tiny(engine)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    res = run.run_cell(workload, config, traffic, 2**31 + 3, 0.1, False,
                       torch.device("cpu"), bench, start=0.0)
    assert res["correct"] is True
    assert list(res)[-1] == "checks"
    assert all(c == {"value": 0, "limit": 0}
               for c in res["checks"].values())


def test_half_of_one_members_receivers_comes_out_not_correct():
    """A fleet of one per-receiver member has no half of members; half
    of its receivers is the batch that fault leaves out."""
    workload, config, traffic = tiny("receiver")
    workload = dict(workload, members=1)
    res = control.check(workload["name"], 2**31 + 5, "half", 0.1,
                        torch.device("cpu"), workload, config, traffic)
    assert res["correct"] is False
