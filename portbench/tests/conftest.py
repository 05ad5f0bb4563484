"""Shared pieces of the benchmark's tests: the tiny test-only cells."""
import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def tiny(engine: str):
    """``(workload, config, traffic)`` of a tiny cell: 64 nodes, 2
    members, 120 ticks, 5 % of the nodes faulted (or, ``contested``, the
    contested mix)."""
    from portbench.traffic import generate

    if engine == "contested":
        config = json.loads((HERE / "tiny-shared-n64.json").read_text())
        traffic = generate.load("contested-3camps")
        name = "shared100k-contested"
    elif engine == "shared":
        config = json.loads((HERE / "tiny-shared-n64.json").read_text())
        traffic = generate.load("crash-burst-1pct")
        traffic["crash"]["share"] = 0.05
        name = "shared100k-crash"
    else:
        config = json.loads((HERE / "tiny-rapid-n64.json").read_text())
        traffic = generate.load("ingress-partition-1pct")
        traffic["ingress_partition"]["share"] = 0.05
        name = "rapid1k-partition"
    workload = {"name": name, "config": config["name"], "members": 2,
                "chips": 1}
    return workload, config, traffic


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
