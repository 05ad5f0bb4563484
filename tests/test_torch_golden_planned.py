"""Churn planned by ``churn.plan_churn``: golden files against the JAX
reference.

``testdata/shared_n100k_planned_churn.json``: 100k members, 16-slot join
bursts at ticks 10 and 40 and 16-slot leave bursts at 25 and 55, 160
ticks. ``testdata/shared_n10k_planned_mixed.json``: ``BASELINE.json``
configuration 5's shape at 10k members, a contiguous 5 % crash block at
tick 5, then join bursts at 120 and 150 and leave bursts at 135 and 165,
200 ticks. Each file holds the run and the planner's prediction.

Joiner node ids come from a salted ``str`` hash, so the files are made,
and every run compared with them is planned, in a child process under
``PYTHONHASHSEED`` ``golden.PLAN_HASH_SEED`` (recorded in each file).
``chip_smoke.py`` phase 15 does the same on the card. Regenerate with
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_golden_planned.py``
(the reference's planner takes about a minute at 100k). Tolerance: exact.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from rapid_tpu_torch import golden

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("shared_n100k_planned_churn", "shared_n10k_planned_mixed")

_PORT = """
import sys
import torch
from rapid_tpu_torch import golden
torch.set_num_threads(2)  # the port's small ops run no faster on more
rec = golden.run_scenario(golden.OPTIONS[sys.argv[1]], device="cpu")
open(sys.argv[2], "w").write(golden.dumps(rec))
"""

_REFERENCE = """
import sys
sys.path.insert(0, "tests")
from rapid_tpu_torch import golden
from test_torch_engine_golden import reference_record
rec = reference_record(golden.OPTIONS[sys.argv[1]])
open(sys.argv[2], "w").write(golden.dumps(rec))
"""


def planned_record(script: str, name: str, out: Path) -> dict:
    """The record ``script`` writes for scenario ``name``, run in a child
    process under the pinned ``PYTHONHASHSEED``."""
    env = dict(os.environ, PYTHONHASHSEED=golden.PLAN_HASH_SEED,
               PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", script, name, str(out)],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=900)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(out.read_text())


def _decides(rec):
    return [(e["tick"], len(e["slots"])) for e in rec["events"]
            if e["kind"] == "view_change"]


@pytest.mark.parametrize("name", NAMES)
def test_port_cpu_run_equals_the_planned_golden(name, tmp_path):
    want = golden.load(golden.OPTIONS[name].path)
    got = planned_record(_PORT, name, tmp_path / "port.json")
    assert golden.differences(got, want) == []
    assert want["plan"]["pythonhashseed"] == golden.PLAN_HASH_SEED
    assert want["plan"]["redraws"] == {}
    # The engine's view changes are the ones the planner predicted.
    assert [(t, len(s)) for t, kind, _, s in want["plan"]["events"]
            if kind == "view_change"] == _decides(want)
    if name == "shared_n100k_planned_churn":
        assert _decides(want) == [(16, 16), (29, 16), (46, 16), (59, 16)]
        assert want["plan"]["final_members"] == 100_000
    else:
        assert _decides(want) == [(113, 500), (126, 16), (139, 16),
                                  (156, 16), (169, 16)]
        assert want["plan"]["final_members"] == 9_500


def test_mixed_planned_golden_matches_reference(tmp_path):
    name = "shared_n10k_planned_mixed"
    got = planned_record(_REFERENCE, name, tmp_path / "ref.json")
    assert golden.dumps(got) == golden.OPTIONS[name].path.read_text()


@pytest.mark.slow
def test_churn_planned_golden_matches_reference(tmp_path):
    """The reference's planner alone takes 30-50 s at 100k members."""
    name = "shared_n100k_planned_churn"
    got = planned_record(_REFERENCE, name, tmp_path / "ref.json")
    assert golden.dumps(got) == golden.OPTIONS[name].path.read_text()


if __name__ == "__main__":
    import tempfile

    for name in NAMES:
        with tempfile.TemporaryDirectory() as tmp:
            rec = planned_record(_REFERENCE, name, Path(tmp) / "ref.json")
        golden.OPTIONS[name].path.write_text(golden.dumps(rec))
        print("wrote", golden.OPTIONS[name].path)
