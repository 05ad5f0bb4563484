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
- **The slot axis runs on any mesh.** ``shard_put`` cuts one cluster's
  tree into ``C / D`` contiguous slots per device (``SlotShards``; each
  field's slot axis is ``state.SLOT_AXES``, ``spec_for``'s layout, and a
  bare tensor's rows are its first axis). ``step.simulate`` and the
  entry points above it run one thread per shard (``run_spmd``), each
  under its device's context, on a shard-local tick: elementwise work on
  the local slots, and every read across slots an explicit collective of
  the shard's ``SlotGroup`` (gathers along the slot axis, exact integer
  all-reduces, the 64-bit limb sums, the first set slot). On one card
  repeated the shards run the same program and exchanges as on D cards.
  When ``C`` does not divide the mesh (the divisibility guard) the
  reference replicates every leaf; the port then runs the whole cluster
  on the mesh's first device.
- **Fleets run on a slot mesh too.** ``fleet_shard_put`` cuts every
  member of a fleet-stacked tree the same way (``fleet_spec_for``'s
  layout: the member axis first and never split, even where ``F == C``;
  a field's slot axis is its ``SLOT_AXES`` axis plus one), and
  ``step.fleet_body`` runs the fleet tick on each shard's thread. The
  per-member phases run under ``torch.func.vmap`` (``state.member_map``),
  so every collective is vmap-aware by design (``SlotGroup._unbatched``):
  under ``vmap`` it exchanges plain tensors with the member axis in
  front, one exchange for all members, and returns one result per
  member.
- ``constrain``, ``replicate``, ``constrain_tree`` and
  ``fleet_axis_constrain_tree`` annotate a layout for XLA's partitioner
  in the reference and change no value; here they return their input.

All engine state is integer or bool, so a run on a mesh equals the run
without one bit for bit, as in the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree

from rapid_tpu_torch import hashing
from rapid_tpu_torch.device import resolve_device
from rapid_tpu_torch.telemetry.trace import span

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
    fewer are there. ``devices`` may repeat a device (four shards on one
    card)."""
    return _mesh(n_devices, devices, device, AXIS, "slot")


def mesh_size(mesh) -> int:
    """Number of devices along the slot axis."""
    return int(mesh.shape[AXIS])


def require_slot_mesh(mesh) -> Optional[torch.device]:
    """The first device of a slot mesh (None without a mesh), where the
    outputs of a run on it are joined; a mesh of another axis raises
    ``ValueError``."""
    if mesh is None:
        return None
    if AXIS not in mesh.shape:
        raise ValueError(f"mesh must have the {AXIS!r} axis, got "
                         f"{tuple(mesh.shape)}")
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


class SlotShards(NamedTuple):
    """What ``shard_put`` returns on a slot mesh of more than one device:
    one sub-tree per shard, in slot order, each shard's device, and the
    whole slot universe's C. Shard ``s`` holds slots ``[s·C/D,
    (s+1)·C/D)`` of every leaf with a slot axis and a whole copy of the
    rest. A single shard is the whole tree on the mesh's first device
    (the divisibility guard)."""

    shards: tuple
    devices: Tuple[torch.device, ...]
    capacity: int


def shard_put(tree, mesh, capacity: Optional[int] = None):
    """Place a pytree on a slot mesh. ``capacity`` defaults to the
    largest dimension, as in the reference. On one device every tensor
    leaf moves there; on ``D`` devices the tree is split into
    ``SlotShards`` by ``state.split_slots`` (the slot axis of each leaf,
    ``state.slot_axis``), or, when ``capacity`` does not divide ``D``,
    one whole shard on the mesh's first device."""
    if isinstance(tree, SlotShards):
        return tree
    if capacity is None:
        capacity = _infer_capacity(_pytree.tree_leaves(tree))
    return _put(tree, mesh, capacity, fleet=False)


def _put(tree, mesh, capacity: int, fleet: bool):
    """``shard_put`` (``fleet``: ``fleet_shard_put``) of a tree that is
    not split yet."""
    from rapid_tpu_torch.engine import state as state_mod

    first = require_slot_mesh(mesh)
    n_dev = mesh_size(mesh)
    if n_dev == 1:
        return _move(tree, first)
    if capacity % n_dev:
        return SlotShards((_move(tree, first),), (first,), capacity)
    return SlotShards(
        tuple(_move(part, dev) for part, dev in zip(
            state_mod.split_slots(tree, capacity, n_dev, fleet),
            mesh.devices)),
        mesh.devices, capacity)


def slot_shards(tree, mesh, capacity: int, fleet: bool = False):
    """``tree`` as the ``SlotShards`` of a run on ``mesh``: placed by
    ``shard_put`` (``fleet``: ``fleet_shard_put``) unless it already is
    ``SlotShards`` (None stays None)."""
    if tree is None or isinstance(tree, SlotShards):
        return tree
    placed = _put(tree, mesh, capacity, fleet)
    if isinstance(placed, SlotShards):
        return placed
    return SlotShards((placed,), (mesh.devices[0],), capacity)


def shard_tuple(trees: Sequence, mesh, capacity: int,
                fleet: bool = False) -> SlotShards:
    """Several trees of one slot universe as one ``SlotShards`` whose
    shard ``k`` is the tuple of their shards ``k`` (each placed by
    ``slot_shards``; a None stays None in every shard). The trees must
    come out on the same devices."""
    parts = [slot_shards(t, mesh, capacity, fleet) for t in trees]
    lead = next(p for p in parts if p is not None)
    for p in parts:
        if p is not None and (p.devices, p.capacity) != (lead.devices,
                                                         lead.capacity):
            raise ValueError(f"trees split over {p.devices} (C="
                             f"{p.capacity}) and {lead.devices} (C="
                             f"{lead.capacity}) do not run together")
    none = (None,) * len(lead.shards)
    return SlotShards(tuple(zip(*[none if p is None else p.shards
                                  for p in parts])), lead.devices, capacity)


def on_mesh(parts: SlotShards, mesh, dev) -> SlotShards:
    """``parts``, checked to be split over ``mesh`` (or whole on its
    first device) on devices of ``dev``'s type."""
    if parts.devices not in (mesh.devices, mesh.devices[:1]):
        raise ValueError(f"the inputs are split over {parts.devices}, the "
                         f"slot mesh holds {mesh.devices}")
    for where in parts.devices:
        if where.type != dev.type:
            raise ValueError(f"the slot mesh holds {where}, the run was "
                             f"asked for {dev}")
    return parts


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
    """Place a fleet-stacked pytree on a slot mesh under
    ``fleet_spec_for``'s layout. On one device every tensor leaf moves
    there; on ``D`` devices each member's slots are split as
    ``shard_put`` splits one cluster's (``SlotShards``; a field's slot
    axis is its ``state.SLOT_AXES`` axis plus one, a bare tensor's its
    second axis), the member axis never, even where ``F == C``. When
    ``capacity`` does not divide ``D`` the fleet is one whole shard on
    the mesh's first device. ``capacity`` is explicit, so an ``F >= C``
    fleet is not mistaken for the slot universe."""
    if isinstance(tree, SlotShards):
        return tree
    return _put(tree, mesh, capacity, fleet=True)


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
    """The two layouts do not combine in one dispatch; ``mesh`` must be a
    slot mesh (``require_slot_mesh``)."""
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
            with device_context(dev), span("rapid.fleet.tick"):
                carries[k], log = tick(k, carries[k], i)
            logs[k].append(log)
    return carries, logs


def join(trees: Sequence, device: torch.device, dim: int = 0):
    """Shards' outputs joined in member order along ``dim`` on
    ``device``; a single shard comes back as it is."""
    if len(trees) == 1:
        return trees[0]
    with span("rapid.fleet.join"):
        return _pytree.tree_map(
            lambda *xs: torch.cat([x.to(device) for x in xs], dim=dim),
            *trees)


def state_shardings(state, mesh):
    """Per-leaf ``NamedSharding`` of an ``EngineState`` (or any
    slot-universe pytree), keyed on ``state.member``'s capacity."""
    capacity = int(state.member.shape[0])
    return _pytree.tree_map(
        lambda x: sharding_for(x, capacity, mesh), state)


# ---------------------------------------------------------------------------
# the slot axis: one thread per shard and the collectives between them
# ---------------------------------------------------------------------------

#: Seconds a shard waits at a collective for its turn before the run
#: fails (a shard that raised aborts the wait at once).
COLLECTIVE_TIMEOUT_S = 600.0

#: Collectives made since the last reset, counted once per collective
#: (by shard 0); ``chip_smoke.py`` reports it per tick.
collectives = 0


class ShardError(RuntimeError):
    """A shard of a slot-mesh run raised, skipped a collective, left the
    run early, or stopped while the others waited. ``rank`` names the
    shard (the first that raised, else the one that skipped, left or
    stopped), and the run has no result: nothing reruns it unsharded."""

    def __init__(self, rank: int, size: int, message: str):
        super().__init__(f"shard {rank} of {size}: {message}")
        self.rank = rank
        self.size = size


class _Aborted(Exception):
    """Another shard failed; this one stops at its next collective."""


class _Stalled(Exception):
    """A shard's wait for its turn outlasted the timeout."""


class _Mismatch(Exception):
    """A collective met shards at another collective."""

    def __init__(self, message: str, odd: List[int]):
        super().__init__(message)
        self.odd = odd


class _Rendezvous:
    """What the shards of one run share: a turn that passes from rank to
    rank (one semaphore each), a broken flag, and two buffers, used in
    turns by consecutive collectives.

    The shards meet at every collective in turns: each posts its part,
    hands the turn on and waits for its own turn again, which comes back
    only after every shard has posted. So one shard's host code runs at
    a time, in rank order, as the interpreter's lock would allow anyway,
    without the threads contending for it; each card's queued work runs
    on while the host dispatches to the next shard. A shard can write a
    buffer again only two collectives later, after every shard has taken
    its turn between, so every read of it is done."""

    def __init__(self, size: int, timeout: float):
        self.size, self.timeout = size, timeout
        self.turns = [threading.Semaphore(0) for _ in range(size)]
        self.broken = False
        self.buffers = ([None] * size, [None] * size)

    def wait_turn(self, rank: int) -> None:
        if not self.turns[rank].acquire(timeout=self.timeout):
            self.abort()
            raise _Stalled(f"shard {rank} waited {self.timeout} s for its "
                           f"turn")
        if self.broken:
            raise _Aborted()

    def pass_turn(self, rank: int) -> None:
        self.turns[(rank + 1) % self.size].release()

    def abort(self) -> None:
        self.broken = True
        for turn in self.turns:
            turn.release()


#: functorch's own functions that read a tensor's ``vmap`` level and
#: batch axis and move a level's axis out and back in (``torch.func.vmap``
#: calls the last two around every mapped function). ``SlotGroup.
#: _unbatched`` makes the collectives vmap-aware with them.
_FT = torch._C._functorch
_MISSING = [name for name in ("maybe_get_level", "maybe_get_bdim",
                              "get_unwrapped", "_remove_batch_dim",
                              "_add_batch_dim") if not hasattr(_FT, name)]
if _MISSING:
    raise ImportError(f"torch {torch.__version__} lacks functorch's "
                      f"{', '.join(_MISSING)}, which a slot mesh's "
                      f"collectives use under vmap")


class SlotGroup:
    """One shard's view of a slot-mesh run: its ``rank`` of ``size``,
    its slots ``lo:hi`` of the ``capacity``, its ``device``, and the
    collectives. Every shard calls the same collectives in the same
    order (each host branch reads an all-reduced value); each exchange
    carries the shard's count of collectives and the engine's line that
    made it, so a shard that skips one fails the run at the next.

    Reductions combine per-shard partials elementwise (any shape, one
    exchange for several tensors): ``sum`` (exact, in the partials'
    dtype), ``any``, ``max``, ``min``, and ``sum64`` of ``(hi, lo)`` limb
    partials with ``hashing.add64``'s carry. ``all_gather`` concatenates
    shards along the slot axis, ``first_true`` is the global index of a
    mask's first set slot, ``at`` the value at one global slot, ``local``
    takes this shard's slots of a whole tensor and ``slots`` this shard's
    global slot indices. Under ``torch.func.vmap`` over a fleet's members
    each collective makes one exchange of plain tensors with the member
    axis in front, and each member gets the result of its own call
    (``_unbatched``). The methods are the whole interface the engine uses, so
    another transport (one process per card) needs only these."""

    def __init__(self, rank: int, size: int, capacity: int,
                 device: torch.device, rendezvous: _Rendezvous):
        per = capacity // size
        self.rank, self.size, self.capacity = rank, size, capacity
        self.lo, self.hi = rank * per, (rank + 1) * per
        self.device = device
        self._rv = rendezvous
        self._calls = 0

    def _exchange(self, obj) -> list:
        """Every shard's ``obj``, in rank order, checked to come from the
        same collective (count and calling line) on every shard."""
        global collectives
        frame = sys._getframe(1)
        while frame.f_code.co_filename == __file__:
            frame = frame.f_back
        tag = (self._calls, frame.f_code.co_filename, frame.f_lineno)
        buf = self._rv.buffers[self._calls % 2]
        self._calls += 1
        if self.rank == 0:
            collectives += 1
        buf[self.rank] = (tag, obj)
        self._rv.pass_turn(self.rank)
        self._rv.wait_turn(self.rank)
        got = list(buf)
        odd = [r for r, entry in enumerate(got)
               if entry is None or entry[0] != tag]
        if odd:
            raise _Mismatch(
                f"collective {tag[0]} of shard {self.rank} ({tag[1]}:"
                f"{tag[2]}) met shards {odd} at another collective or "
                f"none: a shard skipped one or left", odd)
        return [entry[1] for entry in got]

    def _gathered(self, xs) -> List[List[torch.Tensor]]:
        """For each tensor of ``xs``, every shard's, on this device."""
        parts = self._exchange(tuple(xs))
        return [[p[i].to(self.device) for p in parts]
                for i in range(len(xs))]

    def _collect(self, op, lead: int, xs) -> tuple:
        """Collective ``op`` of plain tensors ``xs`` whose first ``lead``
        axes are members (``_unbatched``): the reductions are
        elementwise, a gather's ``dim`` counts past them, and the first
        set slot is found along the last axis."""
        if op == "first_true":
            (mask,) = xs
            local = torch.argmax(mask.to(torch.uint8), dim=-1) + self.lo
            anys, idxs = self._gathered((mask.any(dim=-1), local))
            pick = torch.argmax(torch.stack(anys).to(torch.uint8), dim=0)
            return (torch.stack(idxs).gather(0, pick.unsqueeze(0))
                    .squeeze(0),)
        if op == "sum64":
            his, los = self._gathered(xs)
            out_hi, out_lo = his[0], los[0]
            for h, l in zip(his[1:], los[1:]):
                out_hi, out_lo = hashing.add64(out_hi, out_lo, h, l)
            return out_hi, out_lo
        if isinstance(op, tuple):           # ("all_gather", dim)
            dim = op[1] + lead if op[1] >= 0 else op[1]
            return tuple(torch.cat(ps, dim=dim) for ps in self._gathered(xs))
        return tuple(_FOLDS[op](torch.stack(ps)) for ps in self._gathered(xs))

    def _call(self, op, xs):
        if torch._C._are_functorch_transforms_active():
            out = self._unbatched(op, 0, xs)
        else:
            out = self._collect(op, 0, xs)
        return out[0] if len(out) == 1 else out

    def _unbatched(self, op, lead: int, xs) -> tuple:
        """Collective ``op`` under ``vmap``, on the innermost level of
        ``xs``: each input's batch axis of that level moved to the front
        (an input not batched there broadcast), the collective applied a
        level down with one more leading axis (``lead``), and each result
        batched along axis 0 at that level. So every shard trades plain
        tensors with the members in front, one exchange for all members,
        whatever the levels' numbering, and each member gets the result
        of its own call. Plain inputs go to ``_collect``."""
        levels = [_FT.maybe_get_level(x) for x in xs]
        level = max(levels)
        if level < 0:
            return self._collect(op, lead, xs)
        x = xs[levels.index(level)]
        size = _FT.get_unwrapped(x).shape[_FT.maybe_get_bdim(x)]
        out = self._unbatched(op, lead + 1, [
            _FT._remove_batch_dim(x, level, size, 0) for x in xs])
        return tuple(_FT._add_batch_dim(o, 0, level) for o in out)

    def all_gather(self, *xs, dim: int = 0):
        """Each tensor of ``xs`` concatenated over the shards along
        ``dim`` (its slot axis), on this shard's device."""
        return self._call(("all_gather", dim), xs)

    def sum(self, *xs):
        return self._call("sum", xs)

    def any(self, *xs):
        return self._call("any", xs)

    def max(self, *xs):
        return self._call("max", xs)

    def min(self, *xs):
        return self._call("min", xs)

    def sum64(self, hi, lo):
        """The shards' ``(hi, lo)`` partial sums added mod 2**64 in rank
        order, equal to the sum over the whole slot axis."""
        return self._call("sum64", (hi, lo))

    def first_true(self, mask):
        """0-d int64: the global index of the first set slot of the
        shards' ``[C / D]`` ``mask``, 0 when none is set (``argmax`` of
        the whole mask through uint8)."""
        return self._call("first_true", (mask,))

    def at(self, x, index):
        """The value at global slot ``index`` (0-d) of the shards' ``[C /
        D]`` tensor ``x``: the owner's, all-reduced as a masked sum."""
        mine = self.slots(x.shape[0], x.device) == index
        return self.sum(torch.where(mine, x, torch.zeros_like(x)).sum(
            dim=0, dtype=x.dtype))

    def local(self, x, dim: int = 0):
        """This shard's slots of a whole tensor, along ``dim``."""
        return x.narrow(dim, self.lo, self.hi - self.lo)

    def slots(self, n: int, device, dtype=torch.int64):
        """This shard's ``n`` global slot indices."""
        return torch.arange(self.lo, self.lo + n, dtype=dtype,
                            device=device)


#: The elementwise folds over the stacked partials (shards first).
_FOLDS = {"sum": lambda s: s.sum(dim=0, dtype=s.dtype),
          "any": lambda s: s.any(dim=0),
          "max": lambda s: s.amax(dim=0),
          "min": lambda s: s.amin(dim=0)}


class _Solo:
    """The group of a run without a slot mesh: one shard holding every
    slot, every collective the identity. It is the engine's functions'
    default ``group``; with it they compute what they always did."""

    rank, size, lo = 0, 1, 0

    @staticmethod
    def _same(xs):
        return xs[0] if len(xs) == 1 else xs

    def all_gather(self, *xs, dim: int = 0):
        return self._same(xs)

    def sum(self, *xs):
        return self._same(xs)

    any = max = min = sum

    def sum64(self, hi, lo):
        return hi, lo

    def first_true(self, mask):
        return torch.argmax(mask.to(torch.uint8))

    def at(self, x, index):
        return x[index]

    def local(self, x, dim: int = 0):
        return x

    def slots(self, n: int, device, dtype=torch.int64):
        return torch.arange(n, dtype=dtype, device=device)


SOLO = _Solo()


def run_spmd(fn: Callable, parts: SlotShards,
             timeout: float = COLLECTIVE_TIMEOUT_S) -> list:
    """``fn(group, shard)`` for every shard of ``parts``, one thread
    each, each under its device's context, meeting at every collective
    in turns (``_Rendezvous``); returns the results in rank order. A
    single shard runs ``fn(SOLO, shard)`` in this thread. When a shard
    raises, the run is aborted, every other shard raises at its next
    collective, and ``ShardError`` names the first shard that raised
    (chained to its error). When a shard leaves the run or stops without
    the collective the others wait at, their wait times out after
    ``timeout`` seconds and ``ShardError`` names it. Nothing reruns."""
    size = len(parts.shards)
    if size == 1:
        with device_context(parts.devices[0]):
            return [fn(SOLO, parts.shards[0])]
    rv = _Rendezvous(size, timeout)
    results: list = [None] * size
    errors: list = [None] * size
    done = [False] * size
    threads_per_shard = torch.get_num_threads()

    def body(rank: int) -> None:
        dev = parts.devices[rank]
        group = SlotGroup(rank, size, parts.capacity, dev, rv)
        # A new thread's CPU ops would otherwise take the default pool.
        torch.set_num_threads(threads_per_shard)
        try:
            rv.wait_turn(rank)
            with device_context(dev):
                results[rank] = fn(group, parts.shards[rank])
            done[rank] = True
            rv.pass_turn(rank)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            errors[rank] = exc
            rv.abort()

    threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                name=f"slot-shard-{r}")
               for r in range(size)]
    for th in threads:
        th.start()
    rv.pass_turn(size - 1)
    for th in threads:
        # Once the run is broken every live shard stops at its next
        # collective; one that does not return within the timeout hangs.
        while th.is_alive() and not rv.broken:
            th.join(timeout=1.0)
        th.join(timeout=timeout)
    hung = [r for r, th in enumerate(threads) if th.is_alive()]
    secondary = (_Aborted, _Stalled, _Mismatch)
    raised = [r for r, e in enumerate(errors) if e is not None
              and not isinstance(e, secondary)]
    if raised:
        rank = raised[0]
        err = errors[rank]
        raise ShardError(rank, size, f"{type(err).__name__}: {err}") \
            from err
    failed = [r for r, e in enumerate(errors) if e is not None]
    if hung:
        raise ShardError(hung[0], size, f"shards {hung} did not reach a "
                         f"collective or return within {timeout} s")
    if failed:
        left = [r for r in range(size) if done[r]]
        first = errors[failed[0]]
        if left:
            rank, why = left[0], (f"shards {left} left the run while "
                                  f"shards {failed} waited at a collective")
        elif isinstance(first, _Mismatch):
            rank, why = first.odd[0], str(first)
        else:
            rank, why = failed[0], (f"the collectives timed out after "
                                    f"{timeout} s")
        raise ShardError(rank, size, why) from first
    return results
