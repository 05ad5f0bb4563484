"""PyTorch and CUDA port of rapid-tpu's per-receiver engine.

The engine runs the Rapid membership protocol (K-ring monitoring,
multi-node cut detection, Fast Paxos with the classic fallback) for every
simulated slot at once, each slot with its own view, exact under link
partitions and link delays. The port keeps the reference's packed scan
carry and replaces its TPU delivery kernel with a CUDA kernel for Hopper
(``engine/csrc/rx_account.cu``).

Entry points run on ``device="cuda"`` unless the caller asks for the CPU;
without a card the default raises. The user-facing pair is::

    member = engine.receiver.lower_receiver_schedule(schedule, settings)
    final, logs = engine.receiver.receiver_simulate(
        member.state, member.faults, n_ticks, settings)

with ``settings.rx_kernel == "pallas"``. This package imports ``torch``,
``numpy`` and the standard library only.
"""
from rapid_tpu_torch.settings import Settings

__all__ = ["Settings"]
