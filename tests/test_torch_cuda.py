"""Tests of the port that need the card (the CUDA kernel has no CPU mode).

Marked ``cuda``; each skips with a reason when no CUDA device is present.
This file imports neither JAX nor the reference, so on the card it runs
with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from rapid_tpu_torch.convert import to_numpy
from rapid_tpu_torch.engine import receiver, rx_account
from rapid_tpu_torch.engine.rx_packed import pack_bits
from rapid_tpu_torch.faults import crash_window_delay_schedule
from rapid_tpu_torch.settings import Settings

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("c", [13, 64, 96, 200, 1000, 1024])
def test_kernel_matches_plain(card, c):
    rng = np.random.default_rng(c)
    msgs = torch.from_numpy(rng.random((c, c)) < 0.4).to(card)
    blocked = torch.from_numpy(rng.random((c, c)) < 0.25).to(card)
    crashed = torch.from_numpy(rng.random(c) < 0.15).to(card)
    planes = (pack_bits(msgs), pack_bits(blocked),
              torch.where(crashed, 0, 0xFF).to(torch.uint8)[:, None]
              .contiguous(), pack_bits(~crashed)[None, :].contiguous())
    dv_k, cnt_k = rx_account.account_kernel(*planes)
    dv_p, cnt_p = rx_account.account_plain(*planes)
    torch.cuda.synchronize()
    assert torch.equal(dv_k, dv_p) and torch.equal(cnt_k, cnt_p)


def test_card_run_equals_cpu_run(card):
    settings = Settings(rx_kernel="pallas")
    sched = crash_window_delay_schedule(16)
    runs = []
    for device in (card, "cpu"):
        member = receiver.lower_receiver_schedule(sched, settings,
                                                  device=device)
        before = rx_account.launches
        runs.append(receiver.receiver_simulate(member.state, member.faults,
                                               120, settings))
        launched = rx_account.launches - before
        assert launched == (7 * 120 if device == card else 0)
    for got, want in zip(runs[0], runs[1]):
        got, want = to_numpy(got), to_numpy(want)
        for field in got._fields:
            assert np.array_equal(getattr(got, field),
                                  getattr(want, field)), field
