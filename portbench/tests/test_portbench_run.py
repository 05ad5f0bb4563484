"""The command refuses to run without the card it needs and never falls
back to the CPU; on the card, a short run of each cell is correct."""
import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = ("shared100k-crash", "rapid1k-partition", "shared100k-contested")


def test_without_a_card_no_result(monkeypatch):
    import torch

    from portbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    called = []
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: called.append(a))
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1", "--trace", "0"]) == 2
    assert called == []


def test_command_without_a_card_exits_nonzero():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card_is_correct(cell, cuda_device):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 11), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
