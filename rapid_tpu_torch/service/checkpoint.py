"""Versioned checkpoint/restore for resident carries, in the reference's
on-disk form, so a checkpoint written by either package loads in the
other.

A checkpoint is a directory artifact with two files:

- ``manifest.json``: ``record: "rapid_tpu_checkpoint"``, the pinned
  ``CHECKPOINT_VERSION``, the telemetry ``schema_version``, the carry
  *family*, the tick the carry had reached, a snapshot of the
  layout-bearing ``Settings`` statics, a leaf table
  (``name``/``dtype``/``shape`` per array), and an optional ``host``
  blob (JSON-serialisable host state: the traffic generator's rng
  snapshot, the servo, the SLO windows), validated by
  ``telemetry.schema.validate_checkpoint_manifest``;
- ``arrays.npz``: every leaf under ``<part>.<field>`` keys, saved with
  ``allow_pickle=False`` so a checkpoint can never smuggle code.

Families map parts to carry types:

- ``"engine"``: ``state`` (``EngineState``);
- ``"receiver_dense"``: ``state`` (``ReceiverState``, the
  ``rx_kernel="xla"`` carry);
- ``"receiver_packed"``: ``packed`` (``rx_packed.PackedReceiverState``,
  the ``"packed"``/``"pallas"`` carry, epoch-delta base and sticky flags
  included) plus ``delay_table`` (the loop constant beside the carry);

and every family may carry ``recorder`` (``engine.recorder
.RecorderState``) so a restored run resumes the gauge ring mid-fill.

Leaves are written in the reference's dtypes and shapes: the port holds
32-bit limbs (fields named ``*_hi``/``*_lo``) as masked int64, and they
go to disk as uint32 (``convert.to_numpy``'s rule) and come back as int64
(``convert.from_reference``'s rule); every other leaf keeps its dtype.
So the manifest's leaf table is the reference's, byte for byte.

Restore is strict, never best-effort: a version mismatch raises
``CheckpointVersionError`` naming saved and expected version; a statics
mismatch raises ``CheckpointCompatError`` naming every differing field;
leaf-table drift between manifest and npz raises ``CheckpointError``.
The messages and attributes are the reference's.
"""
from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

import numpy as np

from rapid_tpu_torch.convert import _leaf_from, _leaf_to
from rapid_tpu_torch.device import resolve_device
from rapid_tpu_torch.engine import recorder as recorder_mod
from rapid_tpu_torch.engine import rx_packed
from rapid_tpu_torch.engine.state import EngineState, ReceiverState
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry import write_json_artifact

#: Bump on any incompatible change to the directory layout, the leaf
#: key scheme, or the manifest fields. Restore refuses other versions.
CHECKPOINT_VERSION = 1

CHECKPOINT_RECORD = "rapid_tpu_checkpoint"

MANIFEST_NAME = "manifest.json"
ARRAYS_NAME = "arrays.npz"

FAMILIES = ("engine", "receiver_dense", "receiver_packed")

#: Settings fields that shape the saved arrays (or gate which carry
#: layout is legal); snapshotted at save and compared field by field at
#: restore.
STATIC_FIELDS = ("K", "delivery_ring_depth", "rx_kernel",
                 "rx_epoch_delta_bits", "flight_recorder_window")


class CheckpointError(ValueError):
    """Malformed or internally inconsistent checkpoint artifact."""


class CheckpointVersionError(CheckpointError):
    """Saved checkpoint version differs from this build's pin."""

    def __init__(self, saved: int, expected: int):
        self.saved = saved
        self.expected = expected
        super().__init__(
            f"checkpoint was saved as version {saved} but this build "
            f"reads version {expected}; re-save with a matching build "
            f"(no cross-version migration is defined)")


class CheckpointCompatError(CheckpointError):
    """Saved layout statics differ from the restoring ``Settings``."""

    def __init__(self, mismatches: dict):
        self.mismatches = dict(mismatches)
        detail = ", ".join(
            f"{k}: saved={s!r} expected={e!r}"
            for k, (s, e) in sorted(self.mismatches.items()))
        super().__init__(
            f"checkpoint statics do not match the restoring Settings "
            f"({detail}); restore with the Settings the run was saved "
            f"under")


class Checkpoint(NamedTuple):
    """A restored checkpoint: ``parts`` maps part name to the rebuilt
    NamedTuple of tensors (``delay_table`` restores as a bare tensor)."""

    family: str
    tick: int
    parts: dict
    host: Optional[dict]
    manifest: dict


def _part_cls(family: str, part: str):
    """The NamedTuple class a part rebuilds into (None = bare array)."""
    if part == "recorder":
        return recorder_mod.RecorderState
    if family == "engine" and part == "state":
        return EngineState
    if family == "receiver_dense" and part == "state":
        return ReceiverState
    if family == "receiver_packed" and part == "packed":
        return rx_packed.PackedReceiverState
    if family == "receiver_packed" and part == "delay_table":
        return None
    raise CheckpointError(
        f"unknown checkpoint part {part!r} for family {family!r}")


def _leaves(family: str, parts: dict) -> dict:
    """Flatten the parts to ``<part>.<field> -> np.ndarray`` in the
    reference's dtypes."""
    flat = {}
    for part, tree in parts.items():
        cls = _part_cls(family, part)
        if cls is None:
            flat[part] = np.asarray(_leaf_to(part, tree))
            continue
        if not isinstance(tree, cls) and tuple(getattr(
                tree, "_fields", ())) != cls._fields:
            raise CheckpointError(
                f"part {part!r} of family {family!r} must be a "
                f"{cls.__name__} (got {type(tree).__name__})")
        for field in cls._fields:
            flat[f"{part}.{field}"] = np.asarray(
                _leaf_to(field, getattr(tree, field)))
    return flat


def save_checkpoint(path: str, family: str, parts: dict,
                    settings: Settings, *, tick: Optional[int] = None,
                    host: Optional[dict] = None) -> dict:
    """Write one checkpoint directory; returns the manifest dict.

    ``parts`` maps part names (see the module docstring) to live
    NamedTuples of tensors, copied to host numpy arrays. ``tick``
    defaults to ``parts["state"].tick`` for the engine family and is
    required otherwise.
    """
    from rapid_tpu_torch.telemetry.schema import SCHEMA_VERSION

    if family not in FAMILIES:
        raise CheckpointError(
            f"unknown checkpoint family {family!r}; expected one of "
            f"{FAMILIES}")
    if tick is None:
        state = parts.get("state")
        if family == "engine" and state is not None:
            tick = int(np.asarray(_leaf_to("tick", state.tick)))
        else:
            raise CheckpointError(
                f"tick is required when saving family {family!r}")
    flat = _leaves(family, parts)
    os.makedirs(path, exist_ok=True)
    manifest = {
        "record": CHECKPOINT_RECORD,
        "checkpoint_version": CHECKPOINT_VERSION,
        "schema_version": SCHEMA_VERSION,
        "family": family,
        "tick": int(tick),
        "statics": {f: getattr(settings, f) for f in STATIC_FIELDS},
        "leaves": [{"name": name, "dtype": str(arr.dtype),
                    "shape": list(arr.shape)}
                   for name, arr in sorted(flat.items())],
        "host": host,
    }
    np.savez(os.path.join(path, ARRAYS_NAME), **flat)
    write_json_artifact(os.path.join(path, MANIFEST_NAME), manifest,
                        indent=2, sort_keys=True)
    return manifest


def _check_statics(manifest: dict, settings: Settings) -> None:
    saved = manifest.get("statics", {})
    mismatches = {}
    for field in STATIC_FIELDS:
        want = getattr(settings, field)
        got = saved.get(field)
        if got != want:
            mismatches[field] = (got, want)
    if mismatches:
        raise CheckpointCompatError(mismatches)


def load_checkpoint(path: str, settings: Optional[Settings] = None,
                    device="cuda") -> Checkpoint:
    """Read one checkpoint directory back into tensors on ``device``.

    With ``settings`` given, the saved layout statics are compared field
    by field (``CheckpointCompatError`` on any difference): always pass
    it when the carry will be fed back into a run.
    """
    dev = resolve_device(device)
    mpath = os.path.join(path, MANIFEST_NAME)
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
    except FileNotFoundError:
        raise CheckpointError(f"no checkpoint manifest at {mpath}")
    except json.JSONDecodeError as exc:
        raise CheckpointError(f"unparseable checkpoint manifest "
                              f"{mpath}: {exc}")
    if manifest.get("record") != CHECKPOINT_RECORD:
        raise CheckpointError(
            f"{mpath} is not a checkpoint manifest "
            f"(record={manifest.get('record')!r})")
    saved_version = manifest.get("checkpoint_version")
    if saved_version != CHECKPOINT_VERSION:
        raise CheckpointVersionError(saved_version, CHECKPOINT_VERSION)
    family = manifest.get("family")
    if family not in FAMILIES:
        raise CheckpointError(
            f"unknown checkpoint family {family!r}; expected one of "
            f"{FAMILIES}")
    if settings is not None:
        _check_statics(manifest, settings)

    with np.load(os.path.join(path, ARRAYS_NAME),
                 allow_pickle=False) as npz:
        arrays = {name: npz[name] for name in npz.files}
    declared = {leaf["name"]: leaf for leaf in manifest.get("leaves", ())}
    if set(declared) != set(arrays):
        missing = sorted(set(declared) - set(arrays))
        extra = sorted(set(arrays) - set(declared))
        raise CheckpointError(
            f"checkpoint leaf table does not match {ARRAYS_NAME} "
            f"(missing from npz: {missing}, undeclared: {extra})")
    for name, arr in arrays.items():
        leaf = declared[name]
        if (str(arr.dtype) != leaf["dtype"]
                or list(arr.shape) != list(leaf["shape"])):
            raise CheckpointError(
                f"leaf {name!r} drifted from its manifest entry: npz "
                f"{arr.dtype}{list(arr.shape)} vs declared "
                f"{leaf['dtype']}{leaf['shape']}")

    grouped: dict = {}
    for name, arr in arrays.items():
        part, _, field = name.partition(".")
        if not field:
            grouped[part] = _leaf_from(part, arr, dev)
            continue
        grouped.setdefault(part, {})[field] = _leaf_from(field, arr, dev)
    parts = {}
    for part, fields in grouped.items():
        cls = _part_cls(family, part)
        if cls is None:
            parts[part] = fields
            continue
        if set(fields) != set(cls._fields):
            missing = sorted(set(cls._fields) - set(fields))
            extra = sorted(set(fields) - set(cls._fields))
            raise CheckpointError(
                f"part {part!r} fields do not match {cls.__name__} "
                f"(missing: {missing}, extra: {extra})")
        parts[part] = cls(**fields)
    return Checkpoint(family=family, tick=int(manifest["tick"]),
                      parts=parts, host=manifest.get("host"),
                      manifest=manifest)


# --- carry-level conveniences (what the resident service calls) ----------

def save_engine(path: str, state: EngineState, settings: Settings, *,
                rec=None, host: Optional[dict] = None) -> dict:
    parts = {"state": state}
    if rec is not None:
        parts["recorder"] = rec
    return save_checkpoint(path, "engine", parts, settings, host=host)


def save_receiver(path: str, carry, settings: Settings, *, tick: int,
                  rec=None, host: Optional[dict] = None) -> dict:
    """Checkpoint a receiver carry in whichever layout it is running:
    a dense ``ReceiverState`` or a packed ``PackedReceiverBundle``."""
    if isinstance(carry, ReceiverState):
        family, parts = "receiver_dense", {"state": carry}
    else:
        family = "receiver_packed"
        parts = {"packed": carry.packed, "delay_table": carry.delay_table}
    if rec is not None:
        parts["recorder"] = rec
    return save_checkpoint(path, family, parts, settings, tick=tick,
                           host=host)


def restore_receiver_carry(cp: Checkpoint, settings: Settings):
    """The run-ready carry from a receiver checkpoint (dense state, or a
    rebuilt ``PackedReceiverBundle`` for the packed family)."""
    if cp.family == "receiver_dense":
        return cp.parts["state"]
    if cp.family == "receiver_packed":
        return rx_packed.PackedReceiverBundle(
            packed=cp.parts["packed"],
            delay_table=cp.parts["delay_table"])
    raise CheckpointError(
        f"not a receiver checkpoint (family {cp.family!r})")

