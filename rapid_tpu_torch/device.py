"""Device selection for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. Without a
card the default raises: a run meant for the GPU never drops quietly to
the CPU. Tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch

from rapid_tpu_torch.telemetry.trace import span


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


#: Device-to-host reads made by ``read_host`` and ``read_arrays`` since
#: the last reset. A read waits for the queued device work, so it is the
#: cost of a host branch; ``chip_smoke.py`` and ``profile`` report it per
#: tick. Each read is one span ``rapid.read`` (``telemetry.trace``)
#: around the transfer: the time the host is blocked.
host_reads = 0


def read_host(*scalars):
    """The values of 0-d integer or bool tensors as Python ints, copied to
    the host in one transfer (and counted in ``host_reads``)."""
    global host_reads
    host_reads += 1
    flat = torch.stack([s.to(torch.int64) for s in scalars])
    with span("rapid.read"):
        return flat.tolist()


def read_flags(mask):
    """A bool numpy copy of a bool tensor (a fleet's ``[F]`` flags),
    copied to the host in one transfer (and counted in ``host_reads``)."""
    global host_reads
    host_reads += 1
    with span("rapid.read"):
        return mask.cpu().numpy().copy()


def read_arrays(*tensors):
    """Int64 numpy copies of integer or bool tensors of any shapes,
    copied to the host in one transfer (and counted in ``host_reads``)."""
    global host_reads
    host_reads += 1
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors])
    with span("rapid.read"):
        flat = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out
