"""Device meshes for the tick engines: the slot axis and the fleet axis.

Own copy of the reference's ``engine/sharding.py`` in PyTorch's idiom.
The reference partitions arrays over a 1-D ``jax.sharding.Mesh`` in two
layouts, and GSPMD turns the annotations into a partitioned program:

- **the slot axis** (``AXIS``): one cluster's capacity axis split over
  the devices; the gathers and the vote-count sort that cross slots
  become collectives;
- **the fleet axis** (``FLEET_AXIS``): whole fleet members on each
  device, with no collective at all.

PyTorch has no GSPMD. Here a mesh is a small frozen value, a tuple of
``torch.device``s and one axis name (``Mesh``), and a spec is the tuple a
``PartitionSpec`` holds (``(None, "slots")``, ``()``). The spec functions
are the reference's shape logic, divisibility guards included.

- **The fleet axis runs on any mesh.** ``fleet_axis_put`` cuts every
  ``("fleet",)`` leaf into ``F / D`` contiguous members per device and
  copies a replicated leaf whole to each, returning ``FleetShards``. The
  fleet loops (``step.fleet_body``, ``rx_packed.fleet_simulate``,
  ``dense_fleet_simulate``) advance every shard one tick before the next
  tick, each under its device's context (``run_shards``), and join the
  outputs in member order on the mesh's first device (``join``). A
  member's run does not depend on the other members, so the joined
  outputs are the unsplit fleet's. When ``F`` does not divide the mesh,
  the reference replicates everything; the port then runs the whole
  fleet on the first device, which gives the values the replicated run
  computes.
- **The slot axis runs on one device.** ``slot_mesh`` builds a mesh of
  any size (the spec functions need one of eight), but ``shard_put`` and
  every entry point take a slot mesh of one device only, which places
  everything on that device. A larger one raises ``NotImplementedError``
  (``require_slot_mesh``): splitting one cluster over cards needs one
  process per card over ``torch.distributed``, the ROADMAP.md Queue 1
  sharding item "the slot axis across cards".
- ``constrain``, ``replicate``, ``constrain_tree`` and
  ``fleet_axis_constrain_tree`` annotate a layout for XLA's partitioner
  in the reference and change no value; here they return their input.

All engine state is integer or bool, so a run on a mesh equals the run
without one bit for bit, as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree

from rapid_tpu_torch.device import resolve_device

#: The slot axis: the partitioned capacity dimension.
AXIS = "slots"

#: The fleet axis: the stacked member dimension.
FLEET_AXIS = "fleet"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: its devices, in order, and its one axis name.
    ``shape[axis]`` is the device count, as ``jax.sharding.Mesh.shape``
    gives it. A device may appear more than once."""

    devices: Tuple[torch.device, ...]
    axis: str

    @property
    def shape(self):
        return {self.axis: len(self.devices)}


class NamedSharding(NamedTuple):
    """A mesh and the spec of one leaf on it (the reference's
    ``jax.sharding.NamedSharding``)."""

    mesh: Mesh
    spec: tuple


class FleetShards(NamedTuple):
    """What ``fleet_axis_put`` returns: one sub-tree per device that
    runs, in member order, and each one's device. ``fleet_size`` is the
    whole fleet's F."""

    shards: tuple
    devices: Tuple[torch.device, ...]
    fleet_size: int


def pinned(dev: torch.device) -> torch.device:
    """``dev`` with its index, as a tensor placed there reports it."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _mesh(n_devices: Optional[int], devices, device, axis: str,
          what: str) -> Mesh:
    """A 1-D mesh over ``devices`` (each resolved, so a card asked for
    without one raises), or over the visible cards of ``device``'s type:
    every card on "cuda", ``n_devices`` entries of the CPU on "cpu"."""
    if devices is None:
        dev = resolve_device(device)
        if dev.type == "cuda":
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [dev] * (n_devices or 1)
    else:
        devices = [pinned(resolve_device(d)) for d in devices]
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(
                f"need {n_devices} devices for the {what} mesh, have "
                f"{len(devices)} — pass devices= (a device may repeat) or "
                f"device='cpu' for entries of the CPU")
        devices = devices[:n_devices]
    return Mesh(tuple(devices), axis)


def slot_mesh(n_devices: Optional[int] = None, devices=None,
              device="cuda") -> Mesh:
    """A 1-D mesh over ``devices`` (default: every visible card, or
    ``n_devices`` entries of the CPU with ``device="cpu"``), axis name
    ``AXIS``. ``n_devices`` trims the list and raises ``ValueError`` when
    fewer are there. Any size builds; the entry points run one device
    (``require_slot_mesh``)."""
    return _mesh(n_devices, devices, device, AXIS, "slot")


def mesh_size(mesh) -> int:
    """Number of devices along the slot axis."""
    return int(mesh.shape[AXIS])


def require_slot_mesh(mesh) -> Optional[torch.device]:
    """The device of a one-device slot mesh (None without a mesh); a
    larger one raises ``NotImplementedError``."""
    if mesh is None:
        return None
    n = mesh_size(mesh)
    if n != 1:
        raise NotImplementedError(
            f"a slot mesh of {n} devices: the slot axis across cards (the "
            f"ROADMAP.md Queue 1 sharding item) is not ported; a slot mesh "
            f"of one device and fleet meshes of any size run")
    return mesh.devices[0]


def spec_for(shape: Sequence[int], capacity: int, mesh) -> tuple:
    """The spec of one leaf: the first capacity-sized axis on ``AXIS``,
    everything else replicated. A capacity that does not divide the mesh
    replicates the whole leaf (the divisibility guard), as do scalars and
    leaves with no capacity-sized axis."""
    n_dev = mesh_size(mesh)
    for axis, dim in enumerate(shape):
        if dim == capacity and capacity % n_dev == 0:
            return (None,) * axis + (AXIS,)
    return ()


def sharding_for(x, capacity: int, mesh) -> NamedSharding:
    """The ``NamedSharding`` of one tensor leaf."""
    return NamedSharding(mesh, spec_for(tuple(x.shape), capacity, mesh))


def constrain(x, mesh, capacity: int):
    """``x``: the reference pins a layout for XLA's partitioner here and
    changes no value."""
    return x


def replicate(x, mesh):
    """``x``: the reference pins a replicated layout for XLA here."""
    return x


def constrain_tree(tree, mesh, capacity: int):
    """``tree``: ``constrain`` of every leaf."""
    return tree


def _infer_capacity(leaves) -> int:
    """The largest dimension of any leaf (the slot universe's ``C``)."""
    dims = [d for leaf in leaves if torch.is_tensor(leaf)
            for d in leaf.shape]
    if not dims:
        raise ValueError("cannot infer capacity from an all-scalar pytree")
    return max(dims)


def _move(tree, dev: torch.device):
    return _pytree.tree_map(
        lambda x: x.to(dev) if torch.is_tensor(x) else x, tree)


def shard_put(tree, mesh, capacity: Optional[int] = None):
    """Place a pytree on a one-device slot mesh: every tensor leaf moved
    to its device. ``capacity`` defaults to the largest dimension, as in
    the reference; a larger mesh raises ``NotImplementedError``."""
    if capacity is None:
        _infer_capacity(_pytree.tree_leaves(tree))
    return _move(tree, require_slot_mesh(mesh))


def fleet_spec_for(shape: Sequence[int], capacity: int, mesh) -> tuple:
    """``spec_for`` of a fleet-stacked leaf: axis 0 is the member axis
    and stays replicated, even where ``F == C``; the first later
    capacity-sized axis that divides the mesh goes on ``AXIS``."""
    n_dev = mesh_size(mesh)
    for axis, dim in enumerate(shape):
        if axis == 0:
            continue
        if dim == capacity and capacity % n_dev == 0:
            return (None,) * axis + (AXIS,)
    return ()


def fleet_shard_put(tree, mesh, capacity: int):
    """Place a fleet-stacked pytree on a one-device slot mesh
    (``fleet_spec_for``'s layout; a larger mesh raises)."""
    return _move(tree, require_slot_mesh(mesh))


def fleet_axis_mesh(n_devices: Optional[int] = None, devices=None,
                    device="cuda") -> Mesh:
    """A 1-D mesh over ``devices``, axis name ``FLEET_AXIS``: each
    device runs whole fleet members. On "cuda" it takes the visible
    cards and raises ``ValueError`` with the count when fewer than
    ``n_devices`` are there; on "cpu" it gives ``n_devices`` entries of
    the CPU. ``devices`` may repeat a device (four shards on one card)."""
    return _mesh(n_devices, devices, device, FLEET_AXIS, "fleet")


def _fleet_devices(mesh) -> int:
    return int(mesh.shape[FLEET_AXIS])


def fleet_axis_spec_for(shape: Sequence[int], fleet_size: int,
                        mesh) -> tuple:
    """The spec of one fleet-stacked leaf: ``("fleet",)`` when axis 0 is
    the fleet axis and ``fleet_size`` divides the mesh, else replicated
    (``()``), as for a leaf without the fleet axis."""
    n_dev = _fleet_devices(mesh)
    if len(shape) and shape[0] == fleet_size and fleet_size % n_dev == 0:
        return (FLEET_AXIS,)
    return ()


def fleet_axis_constrain_tree(tree, mesh, fleet_size: int):
    """``tree``: the reference pins ``fleet_axis_spec_for``'s layout for
    XLA here and changes no value."""
    return tree


def fleet_axis_put(tree, mesh, fleet_size: int) -> FleetShards:
    """Split a fleet-stacked pytree over a fleet mesh: shard ``s`` holds
    members ``[s·F/D, (s+1)·F/D)`` of every ``("fleet",)`` leaf and a
    whole copy of every replicated leaf, on device ``s``. When
    ``fleet_size`` does not divide the mesh, one shard holds the whole
    fleet on the mesh's first device."""
    n_dev = _fleet_devices(mesh)
    if fleet_size % n_dev:
        return FleetShards((_move(tree, mesh.devices[0]),),
                           mesh.devices[:1], fleet_size)
    per = fleet_size // n_dev

    def piece(s: int, dev: torch.device):
        def cut(x):
            if not torch.is_tensor(x):
                return x
            if fleet_axis_spec_for(tuple(x.shape), fleet_size, mesh):
                x = x[s * per:(s + 1) * per]
            return x.to(dev)
        return _pytree.tree_map(cut, tree)

    return FleetShards(tuple(piece(s, dev)
                             for s, dev in enumerate(mesh.devices)),
                       mesh.devices, fleet_size)


def fleet_shards(tree, fleet_mesh, fleet_size: int,
                 home: Optional[torch.device] = None) -> FleetShards:
    """``tree`` split over ``fleet_mesh`` (``fleet_axis_put``), as it is
    when it already is ``FleetShards``, or one shard on ``home`` without
    a mesh; a mesh of another axis raises."""
    if isinstance(tree, FleetShards):
        return tree
    if fleet_mesh is None:
        return FleetShards((tree,), (home,), fleet_size)
    if FLEET_AXIS not in fleet_mesh.shape:
        raise ValueError(f"fleet_mesh must have the {FLEET_AXIS!r} axis, "
                         f"got {tuple(fleet_mesh.shape)}")
    return fleet_axis_put(tree, fleet_mesh, fleet_size)


def require_one_layout(mesh, fleet_mesh) -> None:
    """The two layouts do not combine in one dispatch."""
    if mesh is not None and fleet_mesh is not None:
        raise ValueError(
            "mesh (slot-axis sharding) and fleet_mesh (fleet-axis "
            "sharding) are mutually exclusive routings")
    require_slot_mesh(mesh)


def device_context(dev: torch.device):
    """The context a shard's tick runs in: the card current for a CUDA
    device (a kernel launched through ``ctypes`` runs on the current
    card, whatever its stream's), nothing for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def run_shards(devices: Sequence[torch.device], carries: List,
               n_ticks: int, tick: Callable) -> Tuple[List, List[list]]:
    """Advance each shard ``n_ticks`` ticks, every shard one tick before
    any shard takes the next (round robin), each under its device's
    context, so that on several cards one card's work overlaps the
    host's dispatch to the next. ``tick(k, carry, i)`` runs tick ``i``
    of shard ``k`` and returns ``(carry, log)``. Returns the carries and
    each shard's list of logs."""
    carries = list(carries)
    logs: List[list] = [[] for _ in carries]
    for i in range(int(n_ticks)):
        for k, dev in enumerate(devices):
            with device_context(dev):
                carries[k], log = tick(k, carries[k], i)
            logs[k].append(log)
    return carries, logs


def join(trees: Sequence, device: torch.device, dim: int = 0):
    """Shards' outputs joined in member order along ``dim`` on
    ``device``; a single shard comes back as it is."""
    if len(trees) == 1:
        return trees[0]
    return _pytree.tree_map(
        lambda *xs: torch.cat([x.to(device) for x in xs], dim=dim), *trees)


def state_shardings(state, mesh):
    """Per-leaf ``NamedSharding`` of an ``EngineState`` (or any
    slot-universe pytree), keyed on ``state.member``'s capacity."""
    capacity = int(state.member.shape[0])
    return _pytree.tree_map(
        lambda x: sharding_for(x, capacity, mesh), state)
