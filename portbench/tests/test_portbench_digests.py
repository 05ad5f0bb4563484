"""The harness's repair moved nothing: every description a traffic file
gives, at each cell's own size and at three seeds, and the tiny cells'
reference and program outputs and folded summaries, have the digests
taken on the tree before the engines, references and kinds of fault were
found by name."""
import hashlib
import json

import numpy as np
import pytest
import torch

from conftest import tiny
from portbench import run, system
from portbench.traffic import generate

#: ``(nodes, members)`` of the cell that runs each traffic file.
SIZES = {"crash-burst-1pct": (100_000, 32),
         "ingress-partition-1pct": (1000, 1),
         "contested-3camps": (100_000, 32)}
DESCRIPTIONS = {
    ("crash-burst-1pct", 0):
        "40e9bbe4cd9f9413c491c4c046aeaec27145c8bfb8da8f8b5f93884e65f80ae8",
    ("crash-burst-1pct", 1):
        "84fb776aa82f563bf4f8caac51a63c34dcc78e45a938a2683a0d367acc68f210",
    ("crash-burst-1pct", 3418000031):
        "75163a7b0847c486880d0ee14a15e137439168597f7c7a5312a6171462d93cf0",
    ("ingress-partition-1pct", 0):
        "9032a095fe801d919737943b8e47dd3d83582dca4dfeb6e96ceceaad29c28e8e",
    ("ingress-partition-1pct", 1):
        "cdbf9806ee1be352d33bb4923ef8fc77e150bc1c0532ac8a9c4d5d169221e501",
    ("ingress-partition-1pct", 3418000031):
        "da2662d84ae060ec2dd7fcd7fe20952583460229ea5e29e4969c1830dd19744d",
    ("contested-3camps", 0):
        "0710be21782b657a24f9e2bcea54c2eab63c0ebb55fdbb3f70d4fd53989cc19c",
    ("contested-3camps", 1):
        "450e67e6d212cc54b35efb91b25e3098267cdc171e39d7e73e9523c2440cab92",
    ("contested-3camps", 3418000031):
        "16a2af7110b749b0ed004206deef28d6944938533cab2a083cf3d90133701bcc",
}
#: ``(outputs, summaries)`` of each tiny cell at seed 0, the reference's
#: and the program's alike.
TINY = {
    "shared": (
        "f77bc81cbc06071198ec3349efd4c120f10e3ff70ce24e4dbbdb72205adb7baa",
        "ac5062931d8d72c05bb91bb9d902a1d5026a75c229ef7b87673542d93a69192a"),
    "receiver": (
        "8b631f1806d51807073b757afdf888eb69fd8021a4d7e964bd1b09e111ce604b",
        "aefe4514a258920e58ea9bbf0d9fe28299269549e63d7cd7d6b5c99afc2a5d04"),
    "contested": (
        "ae66042af46e2911c3f578f274952aee0c11eb7088f9f6165f385ac82fd6609e",
        "1e64608ff45820173ea0181c4241aac9c450cba36be94bf61c2ec5b0ababd969"),
}


def _plain(x):
    if isinstance(x, np.ndarray):
        return {"dtype": str(x.dtype), "shape": list(x.shape),
                "values": x.tolist()}
    if isinstance(x, np.generic):
        return {"dtype": str(x.dtype), "value": x.item()}
    raise TypeError(type(x))


def digest(obj) -> str:
    """sha256 of ``json.dumps`` (keys in their order; an array with its
    dtype and shape)."""
    return hashlib.sha256(json.dumps(obj, default=_plain).encode()
                          ).hexdigest()


@pytest.mark.parametrize("name,seed", sorted(DESCRIPTIONS))
def test_descriptions_unchanged(name, seed):
    nodes, members = SIZES[name]
    descs = generate.fleet(generate.load(name), nodes, members, seed)
    assert digest(descs) == DESCRIPTIONS[name, seed]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_tiny_cells_outputs_unchanged(cell):
    workload, config, traffic = tiny(cell)
    ticks = config["scenario_ticks"]
    descs = generate.fleet(traffic, config["nodes"], workload["members"], 0)
    cpu = torch.device("cpu")
    want = run.reference_outputs(config, descs, ticks, cpu)
    model = run.reference_of(config)
    fleet = system.build(config, descs, ticks, cpu)
    out = fleet.dispatch()
    outputs, summaries = TINY[cell]
    assert digest(want) == outputs
    assert digest([model.member_summary(w) for w in want]) == summaries
    assert digest(fleet.outputs(out)) == outputs
    assert digest(fleet.fold(out)) == summaries
