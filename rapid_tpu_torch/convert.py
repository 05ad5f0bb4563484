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
logs and recorders keep their leading member axis either way.

The host referee's inputs and results cross too: ``schedule_from_reference``
gives the port's ``AdversarySchedule`` (windows, delay rules and proposes)
of a reference schedule, ``fault_model_from_reference`` the port's
``FaultModel`` of any of the reference's fault models, and ``plain`` turns
a result of either package (a differential's result, an ``AdversaryRun``,
view events, metrics rows, lineage spans) into plain Python values, so
the two compare with ``==`` field by field. The streaming service's
state crosses as well: ``checkpoint_from_reference`` gives the port's
``service.checkpoint.Checkpoint`` of a reference ``Checkpoint`` (every
part carried by ``from_reference``), ``traffic_from_reference`` and
``servo_from_reference`` the port's ``TrafficGenerator`` and
``LoadServo`` of the reference's (or of their ``state_dict``s). Only duck
typing by class name is used: this module imports nothing of the
reference.
"""
from __future__ import annotations

import dataclasses
import enum

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


# ---------------------------------------------------------------------------
# the streaming service's checkpoints and host state
# ---------------------------------------------------------------------------


def checkpoint_from_reference(cp, device="cuda"):
    """The port's ``Checkpoint`` of a reference ``Checkpoint``: the same
    family, tick, host blob and manifest, every part on ``device``."""
    from rapid_tpu_torch.service.checkpoint import Checkpoint

    dev = resolve_device(device)
    parts = {name: (_leaf_from(name, part, dev)
                    if not hasattr(part, "_fields")
                    else from_reference(part, dev))
             for name, part in cp.parts.items()}
    return Checkpoint(family=cp.family, tick=int(cp.tick), parts=parts,
                      host=cp.host, manifest=cp.manifest)


def _state_dict(obj) -> dict:
    return obj if isinstance(obj, dict) else obj.state_dict()


def traffic_from_reference(generator, settings):
    """The port's ``TrafficGenerator`` in the state of a reference
    generator (or of its ``state_dict``), under the port's ``settings``:
    it draws on from the same point of the same PCG64 stream."""
    from rapid_tpu_torch.service.traffic import TrafficGenerator

    return TrafficGenerator.from_state(_state_dict(generator), settings)


def servo_from_reference(servo):
    """The port's ``LoadServo`` in the state of a reference servo (or of
    its ``state_dict``)."""
    from rapid_tpu_torch.service.servo import LoadServo

    return LoadServo.from_state(_state_dict(servo))


# ---------------------------------------------------------------------------
# the host referee's schedules, fault models and results
# ---------------------------------------------------------------------------


def _endpoint(e):
    from rapid_tpu_torch.types import Endpoint

    return Endpoint(e.hostname, e.port)


def _fields(obj, cls, **override):
    kw = {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}
    kw.update(override)
    return cls(**kw)


def schedule_from_reference(schedule):
    """The port's ``faults.AdversarySchedule`` of a reference schedule
    (or of the port's own, copied)."""
    from rapid_tpu_torch import faults

    return _fields(
        schedule, faults.AdversarySchedule,
        windows=tuple(_fields(w, faults.LinkWindow)
                      for w in schedule.windows),
        delays=tuple(_fields(r, faults.DelayRule) for r in schedule.delays),
        proposes=tuple(_fields(p, faults.ScriptedPropose)
                       for p in schedule.proposes))


def fault_model_from_reference(model):
    """The port's ``faults.FaultModel`` of a reference fault model, by
    class name; endpoints become the port's ``Endpoint``."""
    from rapid_tpu_torch import faults

    name = type(model).__name__
    eps = lambda es: None if es is None else frozenset(
        _endpoint(e) for e in es)
    if name == "FaultModel":
        return faults.HEALTHY
    if name == "CrashFault":
        return faults.CrashFault({_endpoint(e): t
                                  for e, t in model.crashes.items()})
    if name == "PacketDropFault":
        return _fields(model, faults.PacketDropFault,
                       targets=eps(model.targets))
    if name == "OneWayPartitionFault":
        return _fields(model, faults.OneWayPartitionFault,
                       from_set=eps(model.from_set), to_set=eps(model.to_set))
    if name == "FlipFlopFault":
        return _fields(model, faults.FlipFlopFault,
                       targets=eps(model.targets))
    if name == "ComposedFault":
        return faults.ComposedFault([fault_model_from_reference(m)
                                     for m in model.models])
    if name == "LinkWindowFault":
        return faults.LinkWindowFault([_fields(w, faults.LinkWindow)
                                       for w in model.windows])
    if name == "LinkDelayFault":
        return faults.LinkDelayFault([_fields(r, faults.DelayRule)
                                      for r in model.delays], model.seed)
    raise TypeError(f"no port counterpart for fault model {name}")


#: Fields that ``plain`` leaves out: the port's results carry the host
#: seconds of each side, the reference's do not.
_SKIP = ("seconds",)


def plain(value):
    """``value`` as plain Python values, the same for the reference's
    objects and the port's: a dataclass becomes ``(class name, {field:
    value})`` without the fields named in ``_SKIP``, an endpoint
    ``("Endpoint", hostname, port)``, an enum ``"Class.NAME"``, numpy
    values lists and scalars; lists, tuples, sets and dicts keep their
    kind."""
    if value is None or isinstance(value, (bool, int, float, str, bytes)):
        return value
    if isinstance(value, enum.Enum):
        return f"{type(value).__name__}.{value.name}"
    if hasattr(value, "hostname") and hasattr(value, "port"):
        return ("Endpoint", value.hostname, value.port)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value).__name__,
                {f.name: plain(getattr(value, f.name))
                 for f in dataclasses.fields(value) if f.name not in _SKIP})
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, dict):
        return {plain(k): plain(v) for k, v in value.items()}
    if isinstance(value, (set, frozenset)):
        return frozenset(plain(v) for v in value)
    if isinstance(value, (list, tuple)):
        return type(value)(plain(v) for v in value) \
            if type(value) in (list, tuple) else \
            (type(value).__name__, tuple(plain(v) for v in value))
    raise TypeError(f"no plain form for {type(value).__name__}")
