"""Carrying state across between the reference and the port.

``from_reference`` maps a reference NamedTuple (``EngineState``,
``StepLog``, ``ReceiverState``, ``PackedReceiverState``,
``ReceiverStepLog``, ``PackedReceiverBundle``, ``RecorderState``, and
the schedules ``ChurnSchedule`` and ``FallbackSchedule``, the reference's
or the port's own host half's; a ``ChurnPlan`` gives its schedule; the
fleets' ``FleetMember`` and ``ReceiverMember``, stacked or not) or
``EngineFaults`` of arrays to the port's type on ``device``: 32-bit
limbs (fields named ``*_hi``/``*_lo``) become masked int64, bool, int8,
int16, int32 and uint8 keep their dtype; the faults' drop configuration
is copied as host values, and a schedule's absent (None) fields stay
None. ``to_numpy`` maps the port's
NamedTuples back to numpy in the reference's dtypes (uint32 limbs), so
the two sides compare with ``np.array_equal``; a fleet's members, finals,
logs and recorders keep their leading member axis either way. Only duck typing by class
name is used: this module imports nothing of the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from rapid_tpu_torch.device import resolve_device
from rapid_tpu_torch.engine.churn import ChurnSchedule
from rapid_tpu_torch.engine.fleet import FleetMember, ReceiverMember
from rapid_tpu_torch.engine.paxos import FallbackSchedule
from rapid_tpu_torch.engine.recorder import RecorderState
from rapid_tpu_torch.engine.rx_packed import (
    PackedReceiverBundle, PackedReceiverState)
from rapid_tpu_torch.engine.state import (
    EngineFaults, EngineState, ReceiverState, ReceiverStepLog, StepLog,
    is_limb_field)

_TYPES = {cls.__name__: cls for cls in
          (EngineState, StepLog, ReceiverState, ReceiverStepLog,
           PackedReceiverState, PackedReceiverBundle, ChurnSchedule,
           FallbackSchedule, RecorderState)}


def _leaf_from(name: str, leaf, dev):
    if leaf is None:
        return None
    arr = np.array(leaf, dtype=np.int64 if is_limb_field(name) else None)
    return torch.from_numpy(arr).to(dev)


def from_reference(nt, device="cuda"):
    """A reference NamedTuple or ``EngineFaults`` -> the port's twin."""
    dev = resolve_device(device)
    name = type(nt).__name__
    if name == "EngineFaults":
        config = {f: getattr(nt, f) for f in EngineFaults.DROP_CONFIG}
        return EngineFaults(**config,
                            **{f: _leaf_from(f, getattr(nt, f, None), dev)
                               for f in EngineFaults.FIELDS})
    if name == "ChurnPlan":
        return from_reference(nt.schedule, dev)
    if name in ("FleetMember", "ReceiverMember"):
        cls = FleetMember if name == "FleetMember" else ReceiverMember
        return cls(*[from_reference(part, dev) for part in nt])
    if name == "PackedReceiverBundle":
        return PackedReceiverBundle(
            packed=from_reference(nt.packed, dev),
            delay_table=_leaf_from("delay_table", nt.delay_table, dev))
    if name not in _TYPES:
        raise TypeError(f"no port counterpart for {name}")
    cls = _TYPES[name]
    return cls(**{f: _leaf_from(f, getattr(nt, f), dev)
                  for f in cls._fields})


def _leaf_to(name: str, leaf):
    if leaf is None:
        return None
    arr = leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else \
        np.asarray(leaf)
    if is_limb_field(name):
        arr = arr.astype(np.uint32)
    return arr


def to_numpy(nt):
    """The port's NamedTuple (same type, numpy leaves) or ``EngineFaults``
    (a dict of numpy arrays and the drop configuration) in the
    reference's dtypes."""
    if isinstance(nt, EngineFaults):
        out = {f: _leaf_to(f, getattr(nt, f)) for f in EngineFaults.FIELDS}
        out.update({f: getattr(nt, f) for f in EngineFaults.DROP_CONFIG})
        return out
    if isinstance(nt, (FleetMember, ReceiverMember)):
        return type(nt)(*[to_numpy(part) for part in nt])
    if isinstance(nt, PackedReceiverBundle):
        return PackedReceiverBundle(packed=to_numpy(nt.packed),
                                    delay_table=_leaf_to("delay_table",
                                                         nt.delay_table))
    return type(nt)(**{f: _leaf_to(f, getattr(nt, f)) for f in nt._fields})
