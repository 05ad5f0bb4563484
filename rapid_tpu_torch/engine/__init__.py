"""The per-receiver tick engine in PyTorch, with its CUDA delivery kernel.

Modules mirror the reference's layout: ``state`` (the carry and the
faults), ``topology``, ``paxos``, ``monitor``, ``cut``, ``rx_account``
(the kernel and its plain version), ``receiver`` (the step, boot,
lowering and host extractors) and ``rx_packed`` (the packed carry and
the tick loop).
"""
