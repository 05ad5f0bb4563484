"""The harness's pieces on the CPU at a tiny size: one dispatch of the
program agrees with the plain reference, output for output and summary
for summary; the reference's identities are the program's."""
import numpy as np
import pytest
import torch

from conftest import tiny
from portbench import compare, system
from portbench.reference import ids, receiver, shared
from portbench.traffic import generate


@pytest.mark.parametrize("engine", ["shared", "receiver", "contested"])
def test_one_dispatch_agrees_with_reference(engine):
    workload, config, traffic = tiny(engine)
    descs = generate.fleet(traffic, config["nodes"], workload["members"],
                           2**31 + 99)
    ticks = config["scenario_ticks"]
    fleet = system.build(config, descs, ticks, torch.device("cpu"))
    out = fleet.dispatch()
    got, sums = fleet.outputs(out), fleet.fold(out)
    uni = shared.Universe(config["nodes"], config["K"], torch.device("cpu"))
    model = receiver if engine == "receiver" else shared
    want = [model.simulate(config, d, ticks, uni) for d in descs]
    assert compare.outputs(got, want) == []
    assert compare.summaries(sums, [model.member_summary(w)
                                    for w in want]) == []
    # the scenario did the work the cell is for
    for s in sums:
        assert s["decisions"] == 1
        if engine == "contested":
            assert s["fallback_phase_sent"]["phase2b"] > 0
        else:
            assert s["ticks_to_first_decide"] == 113


def test_shared_reference_covers_flux_and_stalls():
    """A burst large enough for reports in flux (completed implicitly)
    and one too large for the fast quorum, against the program."""
    config = dict(tiny("shared")[1], nodes=400, capacity=400)
    uni = shared.Universe(400, config["K"], torch.device("cpu"))
    for share, decides in ((0.12, 1), (0.3, 0)):
        traffic = {"crash": {"share": share, "tick": 7}}
        descs = generate.fleet(traffic, 400, 2, 5)
        fleet = system.build(config, descs, 120, torch.device("cpu"))
        got = fleet.outputs(fleet.dispatch())
        want = [shared.simulate(config, d, 120, uni) for d in descs]
        assert compare.outputs(got, want) == []
        assert all(len(w["decide_ticks"]) == decides for w in want)
    assert any(w["columns"]["implicit_reports"].sum() > 0 for w in want)


def test_identities_match_the_program():
    from rapid_tpu_torch.identity import SEED_MEMBER, default_identities
    from rapid_tpu_torch import hashing

    uids, id_sum = ids.universe(500)
    want_uids, want_sum = default_identities(500)
    assert uids.tolist() == want_uids and id_sum == want_sum
    assert int(ids.hash64(np.uint64(want_uids[3]), SEED_MEMBER)) == \
        hashing.hash64(want_uids[3], SEED_MEMBER)


def test_reference_refuses_what_it_does_not_model():
    config = tiny("shared")[1]
    uni = shared.Universe(64, config["K"], torch.device("cpu"))
    desc = {"seed": 1, "crashes": [], "windows": [{"src": [1], "dst": [2],
            "start": 0, "end": 9, "period": 0, "two_way": False}]}
    with pytest.raises(shared.OutOfScope):
        shared.simulate(config, desc, 10, uni)
