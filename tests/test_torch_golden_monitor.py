"""The invariant monitor at full width, against the reference's golden
files.

``shared_n100k_crash`` and ``shared_n100k_contested`` run in the port
with ``invariant_checks=True``: every tick logs ``inv_bits == 0``, so the
record equals the plain golden file field for field (the reference's
files log the constant 0). A memsum limb corrupted in the boot state
flags bit 5 from tick 1 on, and ``check_run`` names tick 1, as the
reference's ``test_memsum_corruption_flags_bit5_from_first_tick`` does at
N=64. ``chip_smoke.py`` phase 13 does the same on the card. Tolerance:
exact.
"""
import dataclasses

import pytest
import torch

from rapid_tpu_torch import golden
from rapid_tpu_torch.engine import invariants, simulate
from rapid_tpu_torch.hashing import MASK32


@pytest.fixture
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", ["shared_n100k_crash",
                                  "shared_n100k_contested"])
def test_monitored_run_equals_the_plain_golden(name, few_threads):
    sc = dataclasses.replace(golden.SHARED[name], invariant_checks=True)
    rec = golden.run_scenario(sc, device="cpu")
    assert set(rec["log"]["inv_bits"]) == {0}
    assert golden.differences(rec, golden.load(sc.path)) == []


def test_memsum_corruption_flags_bit5_from_tick_1_at_100k(few_threads):
    sc = dataclasses.replace(golden.SHARED["shared_n100k_crash"],
                             invariant_checks=True)
    boot = sc.boot(device="cpu")
    state = boot.state._replace(
        memsum_lo=(boot.state.memsum_lo + 1) & MASK32)
    _, logs = simulate(state, boot.faults, 4, sc.settings(), device="cpu")
    memsum = 1 << invariants.BIT_OF["memsum"]
    assert invariants.expand_violations(logs) == [
        (t, memsum, ["memsum"]) for t in range(1, 5)]
    with pytest.raises(invariants.InvariantViolationError,
                       match="tick 1: invariants.memsum"):
        invariants.check_run(logs)
