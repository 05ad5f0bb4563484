"""Device selection for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. Without a
card the default raises: a run meant for the GPU never drops quietly to
the CPU. Tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


class NoCudaDeviceError(RuntimeError):
    """A CUDA device was asked for (the default) and none is present."""


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCudaDeviceError(
            "rapid_tpu_torch entry points run on a CUDA device by default "
            "and torch.cuda.is_available() is False; pass device='cpu' to "
            "run the plain-PyTorch path on the CPU")
    return dev
