"""A deployment is new files alone: a test-only engine, its reference and
a kind of fault, found by the names a configuration and a traffic mix
give, run through the whole harness with no edit to the harness; the
harness's own files name no engine and no kind."""
import importlib
import io
import json
import sys
import tokenize

import pytest
import torch

from conftest import HERE, ROOT
from portbench import control, run
from portbench.reference import OutOfScope, receiver, shared
from portbench.traffic import generate

#: The test-only modules and the names they are found by.
MODULES = {"portbench.engines.blocks": "testonly_engine_blocks",
           "portbench.reference.blocks": "testonly_reference_blocks",
           "portbench.traffic.kinds.crash_block": "testonly_kind_crash_block"}
MIX = {"name": "block-5pct", "crash_block": {"share": 0.05, "tick": 5}}
#: The files that find engines and kinds by name, and the names.
HARNESS = ("run.py", "system.py", "control.py", "traffic/generate.py",
           "reference/fold.py")
NAMES = {"shared", "receiver", "blocks", "crash", "ingress_partition",
         "contested", "crash_block"}


def _config(name: str) -> dict:
    return json.loads((HERE / f"{name}.json").read_text())


@pytest.fixture
def blocks(monkeypatch, tmp_path):
    """``(workload, config, traffic)`` of a tiny cell of the test-only
    deployment, its modules registered and its mix a file."""
    for name, module in MODULES.items():
        monkeypatch.setitem(sys.modules, name,
                            importlib.import_module(module))
    monkeypatch.setattr(generate, "HERE", tmp_path)
    (tmp_path / "block-5pct.json").write_text(json.dumps(MIX))
    config = dict(_config("tiny-shared-n64"), name="tiny-blocks-n64",
                  engine="blocks")
    workload = {"name": "blocks-n64", "config": config["name"],
                "members": 2, "chips": 1}
    return workload, config, generate.load("block-5pct")


def test_new_deployment_runs_correct(blocks):
    workload, config, traffic = blocks
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    res = run.run_cell(workload, config, traffic, 2**31 + 3, 0.1, False,
                       torch.device("cpu"), bench, start=0.0)
    assert res["correct"] is True
    assert all(c == {"value": 0, "limit": 0}
               for c in res["checks"].values())
    # the block is what the members crash on, and they decide it
    descs = generate.fleet(traffic, config["nodes"], 2, 2**31 + 3)
    assert all(d["crash_block"]["count"] == 3 and d["crashes"] == []
               for d in descs)
    want = run.reference_outputs(config, descs, config["scenario_ticks"],
                                 torch.device("cpu"))
    assert [len(w["decide_ticks"]) for w in want] == [1, 1]
    assert [int(w["member"].sum()) for w in want] == [61, 61]


@pytest.mark.parametrize("fault", ["control", "unchanged"])
def test_new_deployments_faults_come_out_not_correct(blocks, fault):
    workload, config, traffic = blocks
    res = control.check(workload["name"], 2**31 + 3, fault, 0.1,
                        torch.device("cpu"), workload, config, traffic)
    assert res["correct"] is False
    assert res["checks"]["output_mismatches"]["value"] > 0


def test_unknown_kind_refused(monkeypatch, tmp_path):
    monkeypatch.setattr(generate, "HERE", tmp_path)
    for bad in ({"meteor": {}}, MIX, {"traffic.crash": {}}):
        (tmp_path / "bad.json").write_text(json.dumps(bad))
        with pytest.raises(ValueError, match="unknown keys"):
            generate.load("bad")


@pytest.mark.parametrize("model", [shared, receiver])
def test_existing_references_refuse_an_unmodelled_key(blocks, model):
    _, config, traffic = blocks
    if model is receiver:
        config = _config("tiny-rapid-n64")
    (desc,) = generate.fleet(traffic, config["nodes"], 1, 7)
    uni = model.universe(config, torch.device("cpu"))
    with pytest.raises(OutOfScope, match="crash_block"):
        model.simulate(config, desc, 10, uni)
    # an empty entry of an unmodelled key is no fault to model
    model.simulate(config, dict(desc, crash_block=None), 10, uni)


@pytest.mark.parametrize("path", HARNESS)
def test_harness_names_no_engine_and_no_kind(path):
    """No identifier and no string literal of the harness's files is an
    engine's or a kind's name."""
    source = (ROOT / "portbench" / path).read_text()
    found = []
    for tok in tokenize.generate_tokens(io.StringIO(source).readline):
        if tok.type == tokenize.NAME and tok.string in NAMES:
            found.append((tok.start[0], tok.string))
        elif tok.type == tokenize.STRING:
            value = eval(tok.string, {})
            if isinstance(value, str) and value in NAMES:
                found.append((tok.start[0], tok.string))
    assert found == []
