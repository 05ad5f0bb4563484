"""The join-and-leave deployment (``shared-n100k-churn``) at a tiny size
on the CPU: its kind of traffic, its engine and its reference, through
the whole harness. A run is correct against the reference; the control
the reference declares (every batch flushed a tick early) and the three
planted faults are not; the reference refuses what it does not model
and moves every view change with the batching window."""
import json

import numpy as np
import pytest
import torch

from conftest import HERE
from portbench import control, own_control, run
from portbench.reference import OutOfScope, shared_churn
from portbench.traffic import generate
from portbench.traffic.kinds import churn

SEED = 2**31 + 3
#: Eight waves: four of joiners fill the 32 dormant slots of 96.
WAVES = 8


def _tiny(members: int = 2):
    """``(workload, config, traffic)`` of the tiny churn cell: 64 nodes
    in 96 slots, 80 ticks, eight waves of eight."""
    config = json.loads((HERE / "tiny-shared-churn-n64.json").read_text())
    traffic = generate.load("churn-waves-8")
    traffic["churn"]["waves"] = WAVES
    workload = {"name": "shared100k-churn", "config": config["name"],
                "members": members, "chips": 1}
    return workload, config, traffic


def test_waves_join_fresh_slots_and_remove_members():
    spec = dict(generate.load("churn-waves-8")["churn"], waves=WAVES)
    got = churn.draw(spec, 64, np.random.default_rng(SEED))["churn"]
    join, leave = np.array(got["join"]), np.array(got["leave"])
    assert join[:, 0].tolist() == list(range(64, 96))
    start = int(join[0, 1])
    assert 5 <= start <= 10
    assert sorted(set(join[:, 2])) == [0, 2, 4, 6]
    assert sorted(set(leave[:, 2])) == [1, 3, 5, 7]
    for rows in (join, leave):
        assert (rows[:, 1] == start + 6 * rows[:, 2]).all()
    view = set(range(64))
    for i in range(WAVES):
        if i % 2:
            slots = set(leave[leave[:, 2] == i, 0].tolist())
            assert len(slots) == 8 and slots <= view and 0 not in slots
            view -= slots
        else:
            view |= set(join[join[:, 2] == i, 0].tolist())


def test_tiny_cell_is_correct():
    workload, config, traffic = _tiny()
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    res = run.run_cell(workload, config, traffic, SEED, 0.1, False,
                       torch.device("cpu"), bench, start=0.0)
    assert res["correct"] is True
    assert all(c == {"value": 0, "limit": 0}
               for c in res["checks"].values())
    descs = generate.fleet(traffic, config["nodes"], 2, SEED)
    for out in run.reference_outputs(config, descs, config["scenario_ticks"],
                                     torch.device("cpu")):
        cols = out["columns"]
        assert len(out["decide_ticks"]) == WAVES
        assert cols["churn_injected"].sum() == 8 * WAVES
        assert (cols["n_member"].min(), cols["n_member"].max()) == (64, 72)
        assert out["decisions"].sum() == 8 * WAVES


# Not control.py's control: it breaks the failure detector's threshold and
# the classic round's length, and churn alone runs neither (no process
# fails, no round is contested), so its reference run is the sound one.
# The reference declares its own (own_control.py).
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fault_comes_out_not_correct(fault):
    workload, config, traffic = _tiny()
    res = control.check(workload["name"], SEED, fault, 0.1,
                        torch.device("cpu"), workload, config, traffic)
    assert res["correct"] is False
    assert res["checks"]["output_mismatches"]["value"] > 0 or \
        res["checks"]["summary_mismatches"]["value"] > 0


@pytest.mark.parametrize("key,value", [("crashes", [[3, 5]]),
                                       ("windows", [{"src": [1]}]),
                                       ("proposes", {"tick": 5})])
def test_reference_refuses_what_it_does_not_model(key, value):
    _, config, traffic = _tiny()
    (desc,) = generate.fleet(traffic, config["nodes"], 1, SEED)
    uni = shared_churn.universe(config, torch.device("cpu"))
    with pytest.raises(OutOfScope, match=key):
        shared_churn.simulate(config, dict(desc, **{key: value}), 10, uni)


def test_declared_control_comes_out_not_correct():
    workload, config, traffic = _tiny()
    assert own_control.declares(config)
    res = own_control.check(workload["name"], SEED, 0.1,
                            torch.device("cpu"), workload, config, traffic)
    assert res["fault"] == "declared" and res["correct"] is False
    assert res["checks"]["output_mismatches"]["value"] > 0
    assert control.ControlFleet is not own_control.DeclaredControl


@pytest.mark.parametrize("window", [0, 2])
def test_batching_window_moves_every_view_change(window):
    """A batch is flushed ``batching_window_ticks`` after its enqueue, so
    each wave decides as many ticks later (earlier) than with the shipped
    window of one tick."""
    _, config, traffic = _tiny()
    (desc,) = generate.fleet(traffic, config["nodes"], 1, SEED)
    uni = shared_churn.universe(config, torch.device("cpu"))
    ticks = config["scenario_ticks"]
    want = shared_churn.simulate(config, desc, ticks, uni)
    got = shared_churn.simulate(dict(config, batching_window_ticks=window),
                                desc, ticks, uni)
    assert len(want["decide_ticks"]) == WAVES
    assert (got["decide_ticks"] == want["decide_ticks"] + window - 1).all()
    assert (got["decisions"] == want["decisions"]).all()
    assert shared_churn.control(config)["batching_window_ticks"] == 0
