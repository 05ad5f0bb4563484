"""The shared-state tick engine: one view stands in for every receiver.

Exact for crash faults: every alive receiver sees the same alert stream,
so one cut detector and one fast round serve them all. Link windows and
probe drop perturb the failure detector's probes only. There is one
tick, ``_fleet_step``, over F >= 1 clusters (members), the member axis
first on every tensor; ``simulate``, ``step`` and ``simulate_chunk`` run
one cluster as a fleet of one. Phase order inside a tick mirrors the
reference's ``rapid_tpu.engine.step``:

0. **classic chain** (with a fallback schedule): phase-2b, 2a and 1b
   messages land, then the scripted fast-round votes are tallied; a
   classic majority or a scripted fast quorum decides;
1. **decide**: fast-round votes sent at the announce tick arrive; a
   quorum (or the scripted instance) triggers the view change
   (membership XOR with the decided mask, 64-bit member and identifier
   sums, the sort-free topology rebuild, the reset of monitor, cut and
   consensus state, an epoch increment); then phase-1a broadcasts land;
2. **deliver**: alert batches flushed last tick (monitor DOWNs, and the
   churn pipeline's leave-DOWNs and join-UPs) land in the cut detector;
   an H-crossing with no destination in flux announces the proposal and
   casts the votes;
3. **flush**: batches enqueued last tick move to delivery;
4. **churn, monitor, tasks**: scheduled identifier redraws (4a′) and
   join/leave alerts whose epoch still holds (4a); on ticks
   ``t % fd_interval_ticks == 0`` past ``fd_gate`` every node probes its
   subjects (4b); scripted proposes and fallback-timer fires (4c).

Where the reference lowers one ``lax.scan`` with ``lax.cond``s (and
``vmap``s it over a fleet), the port runs eagerly: the tick is a host
int, ``_FleetHost`` keeps what the host knows of each member (epochs,
vote arrivals, member counts, config ids, the schedules' tick sets), and
a branch reads an ``[F]`` vector in one transfer whatever F. A phase
runs when any member needs it, as one call over the members
(``state.member_map``) or the plain op where it broadcasts, and its
result is kept where a ``[F]`` host mask holds (whole where it holds for
all). What a branch skips is what the reference computes and masks
away: the vote count off vote ticks (votes arrive one tick after an
announce, so the announce read carries over); the view change off
decide ticks, read only when the host cannot tell; the announce updates
off announce ticks; ``monitor_tick`` off ``t % fd_interval_ticks == 0``
(``t > fd_gate`` stays a ``torch.where``); churn deliveries, injections
and redraws off their schedule's ticks; every fallback phase off the
ticks ``paxos.FallbackTicks`` allows, the scripted fast round's quorum
read once per arrival tick. Without a churn schedule (``churn=None``)
the churn pipeline does not run; without a fallback schedule phases 0,
1b and 4c do not run, the quorum is logged on vote ticks only, and a
view change leaves the consensus fields and ring-0 positions as they
are. Fleets pass inert schedules instead, as the reference's do.

``Settings.protocol_variant`` picks the vote tally and the message
factors ("ring": two laps, ``variants.ring``; "hier": group quorums,
``variants.hier``), each branch under its variant only;
``invariant_checks`` packs ``invariants.check_step`` into ``inv_bits``;
with ``flight_recorder_window > 0`` the runs also return their recorders.

On a slot mesh (``sharding.slot_mesh``) of ``D`` devices every member's
slots are split ``C / D`` a shard and ``sharding.run_spmd`` runs
``_fleet_step`` on one thread per shard with its ``SlotGroup``: every
read across slots is one of the group's collectives (all-gathers, exact
all-reduces, ``add64``'s carried sums, the first set slot), vmap-aware
under ``member_map``, and every host branch reads an all-reduced ``[F]``
value, so the shards take the same branches; each shard's ``_FleetHost``
is built from the whole schedules and keeps the whole faults. The
outputs are joined on the mesh's first device and equal the unsplit run
bit for bit. Under a fleet mesh (``sharding.fleet_axis_mesh``) each
shard of members keeps its own ``_FleetHost`` and the shards advance in
turns (``sharding.run_shards``), exact because every phase is a value
identity for a member that does not need it.
"""
from __future__ import annotations

import collections
import functools
from typing import List, Optional

import numpy as np
import torch
from torch.utils import _pytree

from rapid_tpu_torch import hashing
from rapid_tpu_torch.device import read_arrays, read_flags, resolve_device
from rapid_tpu_torch.engine import churn as churn_mod
from rapid_tpu_torch.engine import (cut, invariants, monitor, paxos,
                                    recorder, sharding, votes)
from rapid_tpu_torch.engine import state as state_mod
from rapid_tpu_torch.engine.fleet import member_of
from rapid_tpu_torch.engine.sharding import SOLO
from rapid_tpu_torch.engine.state import (
    I32_MAX, EngineFaults, EngineState, StepLog, config_id_limbs, member_map)
from rapid_tpu_torch.engine.topology import rebuild
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry.trace import span
from rapid_tpu_torch.variants import hier, ring

#: Values moved to the host by ``_FleetHost``'s start read since the last
#: reset: the distinct ticks of the run's schedules and its ``[F]`` and
#: ``[F, I]`` vectors, once per run (and per shard). It counts the read's
#: size, as ``device.host_reads`` counts reads.
fleet_schedule_values = 0

#: The classic-Paxos message factors of ``StepLog``.
PX_COUNTS = ("pxvote_senders", "pxvote_recipients", "px1a_senders",
             "px1a_recipients", "px1b_senders", "px2a_senders",
             "px2a_recipients", "px2b_senders", "px2b_recipients")


def require_scope(mesh=None) -> Optional[torch.device]:
    """The first device of a slot mesh, where a run's outputs are joined;
    None without one (``sharding.require_slot_mesh``)."""
    return sharding.require_slot_mesh(mesh)


def _split(mesh, state=None) -> bool:
    """Whether ``mesh`` is a slot mesh of more than one device; a
    ``state`` split into ``SlotShards`` needs one."""
    split = require_scope(mesh) is not None and sharding.mesh_size(mesh) > 1
    if not split and isinstance(state, sharding.SlotShards):
        raise ValueError("a state split into SlotShards runs on the slot "
                         "mesh it was split over (mesh=)")
    return split


def _mesh_parts(inputs, mesh, dev,
                fleet: bool = False) -> "sharding.SlotShards":
    """``inputs``, ``(state, faults, churn, fallback)``, as one
    ``SlotShards`` over ``mesh`` (``sharding.shard_tuple``: each input
    split by ``shard_put``, or with ``fleet`` by ``fleet_shard_put``,
    unless it already is ``SlotShards``), on devices of ``dev``'s type.
    ``inputs`` may also be the ``SlotShards`` of all four together
    (``fleet_shard_put`` of a ``fleet.FleetMember``)."""
    if not isinstance(inputs, sharding.SlotShards):
        state = inputs[0]
        cap = (state.capacity if isinstance(state, sharding.SlotShards)
               else int(state.member.shape[int(fleet)]))
        inputs = sharding.shard_tuple(inputs, mesh, cap, fleet)
    return sharding.on_mesh(inputs, mesh, dev)


def _view_change(state: EngineState, pmask, with_pos: bool, group=SOLO):
    """The decided view: member XOR ``pmask``, the 64-bit sums, the
    topology rebuilt from the static ring order, and (with a fallback
    schedule) the ring-0 positions. On a slot mesh the limb sums are
    added across shards (``group.sum64``) and the rebuild runs on the
    all-gathered mask and ring tables; each shard keeps its rows."""
    removed = (pmask & state.member).to(torch.int64)
    joined = (pmask & ~state.member).to(torch.int64)
    member = state.member ^ pmask
    rhi, rlo = group.sum64(*hashing.sum64_axis(state.mfp_hi * removed,
                                               state.mfp_lo * removed))
    ahi, alo = group.sum64(*hashing.sum64_axis(state.mfp_hi * joined,
                                               state.mfp_lo * joined))
    ms_hi, ms_lo = hashing.sub64(state.memsum_hi, state.memsum_lo, rhi, rlo)
    ms_hi, ms_lo = hashing.add64(ms_hi, ms_lo, ahi, alo)
    # Identifiers are remembered forever: joins add, removals never
    # subtract.
    ihi, ilo = group.sum64(*hashing.sum64_axis(state.idfp_hi * joined,
                                               state.idfp_lo * joined))
    id_hi, id_lo = hashing.add64(state.idsum_hi, state.idsum_lo, ihi, ilo)
    with span("rapid.step.rebuild"):
        subj, obs, gk, fd_active, fd_first = rebuild(
            member, state.ring_order, state.ring_rank, group)
        out = dict(member=member, memsum_hi=ms_hi, memsum_lo=ms_lo,
                   idsum_hi=id_hi, idsum_lo=id_lo, subj_idx=subj,
                   obs_idx=obs, gk_idx=gk, fd_active=fd_active,
                   fd_first=fd_first)
        if with_pos:
            out["px_pos"] = paxos.ring0_positions(member, state.ring_order,
                                                  state.ring_rank, group)
    return out


def _px_resets(state: EngineState) -> dict:
    """A decision replaces the consensus instance: ranks back to zero,
    chosen values cleared, every timer and the classic chain dropped."""
    zero = torch.zeros_like(state.px_rnd_r)
    none = torch.full_like(state.px_vval, -1)
    never = torch.full_like(state.c1a_tick, I32_MAX)
    return dict(
        px_rnd_r=zero, px_rnd_i=zero, px_vrnd_r=zero, px_vrnd_i=zero,
        px_vval=none, px_crnd_r=zero, px_crnd_i=zero, px_cval=none,
        px_timer=torch.full_like(state.px_timer, I32_MAX),
        c1a_tick=never, c1b_tick=never, c2a_tick=never, c2b_tick=never,
        c1b_mask=torch.zeros_like(state.c1b_mask))


# ---------------------------------------------------------------------------
# one cluster: a fleet of one member
# ---------------------------------------------------------------------------


def _one_member(tree):
    """``tree`` (a state, faults, a schedule, their ``SlotShards``, or
    None) as a fleet of one member: every tensor with a member axis of 1
    in front."""
    return _pytree.tree_map(
        lambda x: x[None] if torch.is_tensor(x) else x, tree)


def _run_one(inputs, n_ticks: int, settings: Settings, mesh, dev,
             tick: Optional[int] = None):
    """One cluster's ``(state, faults, churn, fallback)`` run ``n_ticks``
    ticks as a fleet of one member: ``(final, [T, ...] logs)`` of that
    member. On a slot mesh of several devices each input's stack is split
    by ``fleet_shard_put`` (``SlotShards`` given gain the member axis)
    and the outputs are joined on the first. ``tick`` overrides the
    host's start tick."""
    stacked = tuple(_one_member(x) for x in inputs)
    if _split(mesh, inputs[0]):
        final, logs = _slot_run(_mesh_parts(stacked, mesh, dev, fleet=True),
                                n_ticks, settings, tick)
    else:
        final, logs = _shard_run(SOLO, stacked, n_ticks, settings, tick)
    return member_of(final, 0), member_of(logs, 0)


def step(state: EngineState, faults: EngineFaults, settings: Settings,
         churn=None, fallback=None, mesh=None, *, tick: Optional[int] = None):
    """Advance the shared engine by one tick; returns ``(state, log)``.

    ``churn`` is a ``churn.ChurnSchedule`` and ``fallback`` a
    ``paxos.FallbackSchedule`` of tensors on the state's device, or None.
    ``tick`` is ``state.tick`` as a host int, read from the state when
    omitted (the state's epoch and the schedules are read all the same).
    On a slot mesh of ``D`` devices the inputs are split over it (or
    given as ``sharding.SlotShards``), each shard ticks on its thread, and
    the state and the log come back joined on the mesh's first device.
    """
    final, logs = _run_one((state, faults, churn, fallback), 1, settings,
                           mesh, require_scope(mesh), tick)
    return final, member_of(logs, 0)


def simulate(state: EngineState, faults: EngineFaults, n_ticks: int,
             settings: Settings, churn=None, fallback=None, mesh=None,
             device="cuda"):
    """Run ``n_ticks`` shared-engine steps on ``device``, where ``state``,
    ``faults`` and the schedules must live; returns ``(final, logs)``
    with every ``StepLog`` field stacked on a leading tick axis, as the
    reference's ``lax.scan`` gives them, and with
    ``settings.flight_recorder_window > 0`` ``(final, logs, recorder)``.
    ``churn`` is a ``churn.ChurnSchedule`` and ``fallback`` a
    ``paxos.FallbackSchedule`` of tensors (``convert.from_reference``
    moves a host schedule), or None.

    ``mesh`` is a slot mesh (``sharding.slot_mesh``). On one device the
    inputs must lie there. On ``D`` devices each input is split over it
    by ``sharding.shard_put`` (or given as its ``SlotShards``): one
    thread per shard runs the shard-local tick, the final state and the
    logs come back joined on the mesh's first device, and the flight
    recorder folds the joined logs; every output equals the run without
    a mesh bit for bit. When the capacity does not divide ``D`` the run
    goes whole on the first device (the divisibility guard)."""
    return _simulate(state, faults, n_ticks, settings, churn, fallback,
                     mesh, device, None)


def _simulate(state, faults, n_ticks: int, settings: Settings, churn,
              fallback, mesh, device, rec):
    """``simulate``, folding the logs into the recorder ``rec`` when one
    is given (``simulate_chunk``) and into a fresh one otherwise."""
    dev = home = resolve_device(device)
    if _split(mesh, state):
        home = mesh.devices[0]
    else:
        on_mesh = require_scope(mesh)
        placed = [("state", state.member.device),
                  ("faults", faults.crash_tick.device)]
        if churn is not None:
            placed.append(("churn schedule", churn.join_tick.device))
        if fallback is not None:
            placed.append(("fallback schedule", fallback.prop_tick.device))
        for name, where in placed:
            if where.type != dev.type:
                raise ValueError(f"{name} lives on {where}, the run was "
                                 f"asked for {dev}")
            if on_mesh is not None and where != on_mesh:
                raise ValueError(f"{name} lives on {where}, the slot mesh's "
                                 f"device is {on_mesh} (sharding.shard_put "
                                 f"places it)")
    state, logs = _run_one((state, faults, churn, fallback), n_ticks,
                           settings, mesh, dev)
    return _recorded(state, logs, settings, rec, home)


def _recorded(state, logs, settings: Settings, rec, dev):
    """``(state, logs)``, and with ``settings.flight_recorder_window``
    the logs folded into ``rec`` (a fresh recorder on ``dev`` when
    None)."""
    if settings.flight_recorder_window:
        if rec is None:
            rec = recorder.init(settings, device=dev)
        return state, logs, recorder.record_run(rec, logs, settings)
    return state, logs


def simulate_chunk(state: EngineState, faults: EngineFaults, n_ticks: int,
                   settings: Settings, churn=None, fallback=None, mesh=None,
                   rec=None, donate: bool = True, device="cuda"):
    """One streaming chunk: ``n_ticks`` steps from an arbitrary carry, as
    the resident service (``rapid_tpu_torch.service.resident``) chains
    them. The same as ``simulate``, but the flight recorder resumes from
    ``rec`` when given (needed for every chunk after the first when
    ``settings.flight_recorder_window > 0``). Chained chunks equal one
    uninterrupted ``simulate`` of the summed length: each chunk rebuilds
    the host's knowledge (``_FleetHost``: the epoch, the member count, the
    config id, whether votes arrive on its first tick) from the state it
    is given, as a fresh ``simulate`` does, so a boundary between an
    announce and its decide changes nothing.

    ``donate`` is accepted so the reference's callers port unchanged.
    PyTorch has no donation: every step builds new tensors and leaves its
    inputs intact, so ``donate=False`` needs no copy, and the old carry
    is freed when the caller drops it (the service's live-buffer
    watermark holds that)."""
    del donate
    return _simulate(state, faults, n_ticks, settings, churn, fallback,
                     mesh, device, rec)


# ---------------------------------------------------------------------------
# the tick: F clusters through one host loop and one set of launches
# ---------------------------------------------------------------------------


#: The state's fields each per-member phase reads and writes: it is handed
#: these alone (``_fields``), as ``member_map`` moves each tensor into a
#: member's call one op at a time (``[0]`` on a fleet of one).
_PROBE = ("uid_hi", "uid_lo", "subj_idx", "fd_active", "fd_first", "fc",
          "notified")
_VIEW = ("member", "mfp_hi", "mfp_lo", "idfp_hi", "idfp_lo", "idsum_hi",
         "idsum_lo", "memsum_hi", "memsum_lo", "ring_order", "ring_rank")
_INJECT = ("member", "epoch", "churn_flush")
_TALLY = ("member",)
_PAXOS = ("member", "epoch", "uid_hi", "uid_lo") + EngineState._fields[
    EngineState._fields.index("px_rnd_r"):]


@functools.lru_cache(maxsize=None)
def _fields_type(names: tuple):
    return collections.namedtuple("Fields", names)


def _fields(state, names: tuple):
    """``state``'s fields ``names`` as a NamedTuple of their own; a phase
    that returns one with some replaced is merged back by
    ``state._replace(**fields._asdict())``."""
    return _fields_type(names)._make([getattr(state, n) for n in names])


class _FleetTicks:
    """``paxos.FallbackTicks`` of every member, with the union of their
    tick sets so that a tick on which no member can act is passed over
    without a loop over the members."""

    def __init__(self, inst_epoch, keys):
        """From ``inst_epoch`` (``[F, I]``) and the ``paxos.tick_keys`` of
        the ``[F, I, C]`` schedules, read back."""
        self.inst_epoch = np.asarray(inst_epoch)
        f, i = self.inst_epoch.shape
        rows = paxos.split_keys(keys, 2 * f * i)
        self.per = [paxos.FallbackTicks.from_rows(
            self.inst_epoch[m], rows[m * i:(m + 1) * i],
            rows[(f + m) * i:(f + m + 1) * i]) for m in range(f)]
        self.fire_any = set().union(*(s for fb in self.per for s in fb.fire))
        self.send_any = set().union(*(s for fb in self.per for s in fb.send))
        self.arrive_any = set().union(*(a.tolist() for fb in self.per
                                        for a in fb.arrivals))
        self._arrived = None      # (epochs, t, counts) of the last call
        self._rows = None         # (epochs, e, live) of the last call
        self.none = np.zeros(f, bool)     # nothing due for any member

    def rows(self, epoch):
        """``(e, live)``: each member's schedule row and whether its
        instance is live, as ``[F]`` numpy arrays (the host's epochs are
        a new array whenever one moves)."""
        if self._rows is None or self._rows[0] is not epoch:
            e = np.clip(epoch, 0, self.inst_epoch.shape[1] - 1)
            self._rows = (epoch, e,
                          self.inst_epoch[np.arange(len(e)), e] == epoch)
        return self._rows[1:]

    def fired(self, e, live, t: int, *lags: int):
        """bool ``[F]``: a timer of the member's row fired ``lag`` ticks
        before ``t`` for one of ``lags``."""
        if not any(t - lag in self.fire_any for lag in lags):
            return self.none
        return live & np.array([fb.fired_before(int(r), t, *lags)
                                for fb, r in zip(self.per, e)])

    def sends(self, e, live, t: int):
        if t not in self.send_any:
            return self.none
        return live & np.array([t in fb.send[int(r)]
                                for fb, r in zip(self.per, e)])

    def fires(self, e, live, t: int):
        if t not in self.fire_any:
            return self.none
        return live & np.array([t in fb.fire[int(r)]
                                for fb, r in zip(self.per, e)])

    def arrived(self, epoch, t: int):
        """int ``[F]``: ``FallbackTicks.arrived`` of each live member (0
        for the others); it changes only at an arrival tick or with an
        epoch (the host's epochs are a new array whenever one moves)."""
        last = self._arrived
        if last is not None and last[0] is epoch and \
                not any(last[1] < a <= t for a in self.arrive_any):
            return last[2]
        e, live = self.rows(epoch)
        counts = np.array([fb.arrived(int(r), t) if ok else 0
                           for fb, r, ok in zip(self.per, e, live)])
        self._arrived = (epoch, t, counts)
        return counts


def _where(m, a, b):
    """``torch.where`` of the ``[F]`` bool ``m`` over ``a`` and ``b``,
    whose member axis is first."""
    return torch.where(m.reshape(m.shape + (1,) * (a.dim() - 1)), a, b)


class _FleetHost:
    """What the host knows of a run of F members between its ticks.
    Epochs, vote arrivals and the scripted fast round's quorum are
    ``[F]`` numpy arrays; the member counts, config-id limbs and Paxos
    gauges ``[F]`` tensors. On a slot mesh (``group``) each shard keeps
    one, built from the whole schedules (all-gathered along each member's
    slot axis); ``faults`` is kept whole. ``churn`` and ``fallback`` may
    be None. The schedules' tick tables are derived on their device (the
    distinct join, leave and redraw ticks, ``paxos.tick_keys``), and only
    those are read, with the ``[F]`` ticks and epochs and the ``[F, I]``
    instance epochs, in one transfer (``fleet_schedule_values``)."""

    def __init__(self, state: EngineState, churn, fallback, faults=None,
                 group=SOLO):
        global fleet_schedule_values
        self.faults = state_mod.gather_slots(faults, group, fleet=True)
        sched = {}
        if churn is not None:
            sched.update(join_tick=churn.join_tick,
                         leave_tick=churn.leave_tick)
            if churn.redraw_tick is not None:
                sched["redraw_tick"] = churn.redraw_tick
        if fallback is not None:
            sched.update(prop_tick=fallback.prop_tick,
                         prop_pid=fallback.prop_pid,
                         prop_delay=fallback.prop_delay)
        sched = state_mod.gather_slots(sched, group, fleet=True)
        arrays = [state.tick, state.epoch]
        if churn is not None:
            arrays.append(torch.unique(torch.cat([
                sched["join_tick"].reshape(-1),
                sched["leave_tick"].reshape(-1)])))
            if "redraw_tick" in sched:
                arrays.append(torch.unique(sched["redraw_tick"]))
        if fallback is not None:
            arrays += [fallback.inst_epoch, paxos.tick_keys(
                sched["prop_tick"], sched["prop_pid"], sched["prop_delay"])]
        fleet_schedule_values += sum(a.numel() for a in arrays)
        got = read_arrays(*arrays)
        if len(set(got[0].tolist())) != 1:
            raise ValueError("fleet members must start at one tick")
        self.dev = state.member.device
        self.tick = int(got[0][0])
        self.start = self.tick
        self.epoch = got[1].astype(np.int64)
        self.inject_ticks = (set(got[2].tolist()) if churn is not None
                             else set())
        self.redraw_ticks = (set(got[3].tolist()) if "redraw_tick" in sched
                             else set())
        self.fb = (_FleetTicks(got[-2], got[-1]) if fallback is not None
                   else None)
        self.arriving = None    # bool [F]: fast-round votes arrive next tick
        self.n_member = None    # i32 [F]
        self.config = None      # config-id limbs, [F] each
        self.px_gauges = None   # (px_timers_armed, px_coord_round), [F]
        self.tally = None       # (keys, ok, win_pid, tally, ok read back)
        self._rows = None       # (epochs, per-member schedule rows)
        self._put = None        # (host mask, its copy on the device)
        self._every = None      # (host mask, all, any)
        self.none = np.zeros(len(self.epoch), bool)   # an [F] mask, all off

    def put(self, mask):
        """A host ``[F]`` mask on the run's device (no wait for the
        queued work), put once for the calls that share it."""
        if self._put is None or self._put[0] is not mask:
            self._put = (mask, torch.from_numpy(np.ascontiguousarray(
                mask)).to(self.dev, non_blocking=True))
        return self._put[1]

    def every(self, mask):
        """``(all, any)`` of a host ``[F]`` bool mask, for the calls that
        share it."""
        if self._every is None or self._every[0] is not mask:
            flags = mask.tolist()     # quicker than numpy's reductions
            self._every = (mask, all(flags), any(flags))
        return self._every[1:]

    def pick(self, mask, a, b, on=None):
        """``a`` where the host ``[F]`` bool ``mask`` holds, else ``b``:
        ``torch.where`` on ``on`` (the mask on the device; ``put`` when
        None), or ``a`` or ``b`` whole, with no launch, where the mask
        holds for every member or for none."""
        every, some = self.every(mask)
        if every or not some:
            return a if every else b
        return _where(self.put(mask) if on is None else on, a, b)

    def keep(self, mask, a, on=None):
        """bool ``a`` where the host ``[F]`` mask holds, else False
        (``a`` whole, with no launch, where it holds for every
        member)."""
        if self.every(mask)[0]:
            return a
        m = self.put(mask) if on is None else on
        return a & m.reshape(m.shape + (1,) * (a.dim() - 1))

    def merge(self, mask, new, old, on=None):
        """``pick`` of two states field by field; fields ``new`` shares
        with ``old`` are kept as they are."""
        every, some = self.every(mask)
        if every or not some:
            return new if every else old
        m = self.put(mask) if on is None else on
        return old._replace(**{f: _where(m, a, b) for f, a, b in
                               zip(old._fields, new, old) if a is not b})

    def fallback_rows(self, fallback, state):
        """Each member's live-instance row of ``fallback`` as a
        one-instance schedule (leaves ``[F, 1, ...]``), gathered by the
        device epochs, which equal ``self.epoch`` (a new array whenever
        one moves)."""
        if self._rows is None or self._rows[0] is not self.epoch:
            e = torch.clamp(state.epoch.long(), 0,
                            fallback.inst_epoch.shape[1] - 1)
            at = torch.arange(e.shape[0], device=e.device)
            self._rows = (self.epoch, paxos.FallbackSchedule(
                *[leaf[at, e][:, None] for leaf in fallback]))
        return self._rows[1]


def _fleet_step(state: EngineState, faults: EngineFaults, settings: Settings,
                host: _FleetHost, churn=None, fallback=None, group=SOLO):
    """One tick ``t = host.tick + 1`` of every member, the member axis
    first on every tensor; returns ``(state, log)`` and advances
    ``host`` past it. Each phase runs when any member needs it: the
    host's condition for one member becomes a ``[F]`` mask, the phase
    runs for all members, and its result is taken where the mask holds,
    so a member gets what the reference's ``vmap`` of its ``lax.cond``s
    gives it. On a slot mesh ``group`` is the shard's ``SlotGroup``: the
    state, the schedules and the log's ``[C]`` fields hold the shard's
    slots, ``faults`` every member's whole universe (a probe's subject or
    an alert's sender may be any slot)."""
    t = host.tick + 1
    dev = state.member.device
    f, c = state.member.shape
    variant = settings.protocol_variant
    n_groups, gid = hier.hier_group_count(group.size * c), None
    i32 = lambda x: x.to(torch.int32)
    zero = torch.zeros(f, dtype=torch.int32, device=dev)
    no_slots = lambda: torch.zeros((f, c), dtype=torch.bool, device=dev)
    no_members = lambda: torch.zeros(f, dtype=torch.bool, device=dev)
    pick = host.pick
    crashed_all = monitor.crashed_at(faults, t)
    crashed = group.local(crashed_all, dim=1)
    tick_t = state.tick + 1
    if host.n_member is None:
        host.n_member = i32(group.sum(state.member.sum(dim=-1)))
    n_member = host.n_member
    fb = host.fb
    px = {}

    # ---- phase 0: classic-chain deliveries and the scripted fast round
    with span("rapid.step.chain"):
        sc = sc_pid = None
        px_tally = zero
        # Members whose scripted round is read to decide, and members on
        # which a phase 2b can land.
        known = classic_can = host.none
        if fallback is not None:
            e, live = fb.rows(host.epoch)
            rows = host.fallback_rows(fallback, state)
            chain = fb.fired(e, live, t, 2, 3, 4)
            if chain.any():
                new, counts, classic, classic_pid = member_map(
                    lambda s, r, n: paxos.chain_deliver(s, r, t, n, group),
                    _fields(state, _PAXOS), rows, n_member)
                state = host.merge(chain, state._replace(**new._asdict()),
                                   state)
                px = {k: pick(chain, v, zero) for k, v in counts.items()}
                classic_can = fb.fired(e, live, t, 4)
                if classic_can.any():
                    sc = host.keep(classic_can, classic)
                    sc_pid = classic_pid
            arrived = fb.arrived(host.epoch, t)
            if arrived.any():
                keys = (host.epoch.tolist(), arrived.tolist())
                if host.tally is None or host.tally[0] != keys:
                    # A member's tally is a function of its key alone, so
                    # all members are recomputed when any key moves, and
                    # whether each reaches the quorum is read once.
                    ok, win_pid, tally = member_map(
                        lambda s, r, n: paxos.fast_tally(s, r, 0, t, n,
                                                         group)[:3],
                        _fields(state, _TALLY), rows, n_member)
                    host.tally = (keys, ok, win_pid, tally,
                                  read_flags(ok))
                _, ok, win_pid, tally, ok_host = host.tally
                am = arrived > 0
                px_tally = pick(am, tally, zero)
                wins = ok_host & am
                known = wins & ~classic_can
                if wins.any():
                    ok = host.keep(am, ok)
                    if sc is None:
                        sc, sc_pid = ok, win_pid
                    else:
                        # The fast round is blocked by a classic decide
                        # earlier in the same tick.
                        sc_pid = torch.where(sc, sc_pid, win_pid)
                        sc = sc | ok

    # ---- phase 1: vote delivery and decision --------------------------
    with span("rapid.step.decide"):
        votes_arriving = state.vote_pending & (state.announce_tick + 1 == t)
        arriving = host.arriving
        if arriving is None:
            arriving = read_flags(votes_arriving)
        alert = None
        vote_tally = vote_quorum = zero
        vote_senders_alive = vote_deliver_alive = zero
        vote_pending = state.vote_pending
        if host.every(arriving)[1]:
            va = votes_arriving
            alive_members = state.member & ~crashed
            valid = state.voters & ~crashed
            if variant == "hier":
                gid = member_map(
                    lambda hi, lo: hier.group_ids(hi, lo, n_groups),
                    state.uid_hi, state.uid_lo)
                decided, tally = member_map(
                    lambda m, v, g: hier.hier_count_fast_round(
                        m, v, g, n_groups, group),
                    state.member, valid, gid)
            else:
                decided, tally = member_map(
                    lambda hi, lo, v, n: votes.count_fast_round(
                        hi.expand(c), lo.expand(c), v, n, group),
                    state.phash_hi, state.phash_lo, valid, n_member)
            vote_tally = pick(arriving, tally, zero, va)
            vote_quorum = pick(arriving, votes.fast_quorum(n_member), zero,
                               va)
            any_valid, any_alive = group.any(valid.any(dim=-1),
                                             alive_members.any(dim=-1))
            # A decision needs an alive receiver to count the votes, and
            # a scripted decide this tick takes precedence.
            alert = host.keep(arriving, decided & any_alive, va)
            if sc is not None:
                alert = alert & ~sc
            # Vote delivery factors: every vote to every alive member; the
            # ring's two laps; hier's whole exchange as one factor,
            # recipient 1.
            if variant == "hier":
                gate = any_valid & any_alive
                senders = torch.where(gate, member_map(
                    lambda v, a, g: hier.hier_exchange_messages(
                        v, a, g, n_groups, group),
                    valid, alive_members, gid), zero)
                recipients = i32(gate)
            else:
                senders = (ring.ring_pair_factor(valid, group)
                           if variant == "ring"
                           else i32(group.sum(valid.sum(dim=-1))))
                recipients = i32(group.sum(alive_members.sum(dim=-1)))
            vote_senders_alive = pick(arriving, senders, zero, va)
            vote_deliver_alive = pick(arriving, recipients, zero, va)
            vote_pending = vote_pending & ~votes_arriving
        if fallback is not None:
            vote_tally = torch.maximum(vote_tally, px_tally)
            vote_quorum = torch.maximum(vote_quorum,
                                        votes.fast_quorum(n_member))

        # One read settles whatever the host does not know yet: a member
        # with arriving votes whose scripted round is not known to
        # decide, or one on which a phase 2b can land.
        flags = [x for x in (alert, sc) if x is not None]
        decide_now = (flags[0] | flags[1] if len(flags) == 2 else flags[0]) \
            if flags else no_members()
        unknown = (arriving if fallback is None
                   else (arriving & ~known) | classic_can)
        decide = read_flags(decide_now) if host.every(unknown)[1] else known
        decided = host.every(decide)[1]
        pmask = state.proposal

        if decided:
            if sc is not None:
                n_pids = rows.table_mask.shape[2]
                chosen = rows.table_mask[:, 0][
                    torch.arange(f, device=dev),
                    sc_pid.clamp(0, n_pids - 1).long()]
                pmask = torch.where(sc[:, None], chosen, state.proposal)
            ck_false = torch.zeros_like(state.reports)
            with_px = fallback is not None
            decided_state = state._replace(
                tick=tick_t,
                **member_map(lambda s, p: _view_change(s, p, with_px, group),
                             _fields(state, _VIEW), pmask),
                fc=torch.zeros_like(state.fc), notified=ck_false,
                fd_gate=tick_t, pending_flush=ck_false,
                pending_deliver=ck_false,
                churn_flush=no_slots(), churn_deliver=no_slots(),
                reports=ck_false, seen_down=no_members(),
                announced=no_members(), proposal=no_slots(),
                vote_pending=vote_pending, voters=no_slots(),
                epoch=state.epoch + 1,
                **(_px_resets(state) if with_px else {}))
            mid = host.merge(decide, decided_state,
                             state._replace(tick=tick_t,
                                            vote_pending=vote_pending),
                             decide_now)
            decision = host.keep(decide, pmask, decide_now)
            host.epoch = host.epoch + decide
            host.n_member = n_member = pick(
                decide, i32(group.sum(mid.member.sum(dim=-1))), n_member,
                decide_now)
            host.px_gauges = None
            if fallback is not None:
                e, live = fb.rows(host.epoch)
                rows = host.fallback_rows(fallback, mid)
        else:
            mid = state._replace(tick=tick_t, vote_pending=vote_pending)
            decision = no_slots()

    # ---- phase 1b: late phase-1a delivery (a task-phase send) ----------
    with span("rapid.step.late1a"):
        if fallback is not None:
            late = ~decide & fb.fired(e, live, t, 1)
            if late.any():
                new, senders = member_map(
                    lambda s: paxos.phase1a_deliver(s, t, group),
                    _fields(mid, _PAXOS))
                mid = host.merge(late, mid._replace(**new._asdict()), mid)
                px["px1b_senders"] = pick(late, senders, zero)

    # ---- phase 2: alert delivery, aggregation, announce ----------------
    with span("rapid.step.deliver"):
        src_alive_all = ~crashed_all
        src_alive = group.local(src_alive_all, dim=1)
        batch_src = mid.pending_deliver.any(dim=-1)
        n_alive = i32(group.sum((mid.member & src_alive).sum(dim=-1)))
        flushers_alive = (ring.ring_pair_factor(batch_src & src_alive, group)
                          if variant == "ring"
                          else i32(group.sum((batch_src & src_alive)
                                             .sum(dim=-1))))
        delivered_down = cut.deliver_reports(mid, src_alive_all, group)
        delivered_up = None
        if churn is not None and (t - 2 in host.inject_ticks
                                  or t <= host.start + 2):
            # Alerts injected at tick i flush at i + 1 and land at i + 2;
            # a run's first two ticks may land what its state holds. Off
            # its own injection ticks a member's churn batch is empty, so
            # the delivery adds nothing there.
            with span("rapid.step.churn_deliver"):
                churn_down, delivered_up = cut.deliver_churn_reports(
                    mid, src_alive_all)
                delivered_down = delivered_down | churn_down
        (reports, seen_down, announce_now, crossed, _explicit,
         implicit_added) = cut.aggregate_device(
            mid, delivered_down, delivered_up, n_alive > 0, settings, group)
        announce = read_flags(announce_now)
        announced = host.every(announce)[1]
        mid = mid._replace(reports=reports, seen_down=seen_down)
        an = announce_now
        if announced:
            ph_hi, ph_lo = member_map(
                lambda p, hi, lo: votes.proposal_fingerprint(p, hi, lo, group),
                crossed, mid.uid_hi, mid.uid_lo)
            mid = mid._replace(
                announced=mid.announced | an,
                proposal=pick(announce, crossed, mid.proposal, an),
                announce_tick=pick(announce, tick_t, mid.announce_tick, an),
                vote_pending=mid.vote_pending | an,
                voters=pick(announce, mid.member & src_alive, mid.voters,
                            an),
                phash_hi=pick(announce, ph_hi, mid.phash_hi, an),
                phash_lo=pick(announce, ph_lo, mid.phash_lo, an))
        vote_senders = pick(announce, n_alive, zero, an)
        vote_recipients = pick(announce, n_member, zero, an)
        if variant == "ring":
            vote_senders = pick(announce, torch.full_like(zero, 2), zero, an)
        elif variant == "hier" and announced:
            if gid is None:
                gid = member_map(
                    lambda hi, lo: hier.group_ids(hi, lo, n_groups),
                    mid.uid_hi, mid.uid_lo)
            vote_senders = pick(announce, member_map(
                lambda v, m, g: hier.hier_exchange_messages(v, m, g, n_groups,
                                                            group),
                mid.member & src_alive, mid.member, gid), zero, an)
            vote_recipients = pick(announce, torch.ones_like(zero), zero, an)

    # ---- phase 3: batch flush (1-tick quiescence) ----------------------
    with span("rapid.step.flush"):
        flusher_mask = mid.pending_flush.any(dim=-1)
        flushers = (ring.ring_pair_factor(flusher_mask, group)
                    if variant == "ring"
                    else i32(group.sum(flusher_mask.sum(dim=-1))))
        flush_recipients = torch.where(group.any(flusher_mask.any(dim=-1)),
                                       n_member, zero)
        mid = mid._replace(pending_deliver=mid.pending_flush,
                           pending_flush=torch.zeros_like(mid.pending_flush),
                           churn_deliver=mid.churn_flush,
                           churn_flush=torch.zeros_like(mid.churn_flush))

    with span("rapid.step.churn"):
        # ---- phase 4a': scripted identifier redraws --------------------
        if t in host.redraw_ticks:
            redraw_now = (churn.redraw_tick == t) & ~mid.member
            redraws, slots = read_arrays(
                group.any(redraw_now.any(dim=-1)),
                member_map(group.first_true, redraw_now))
            redraws = redraws.astype(bool)
            for slot in np.unique(slots[redraws]).tolist():
                mid = host.merge(redraws & (slots == slot), member_map(
                    lambda s, ch: churn_mod.apply_redraws(s, ch, slot, group),
                    mid, churn), mid)

        # ---- phase 4a: churn alert injection ---------------------------
        # Off its own schedule's ticks a member injects nothing, so no
        # mask.
        churn_injected = zero
        if t in host.inject_ticks:
            flush, churn_injected = member_map(
                lambda s, ch: churn_mod.inject(s, ch, t, group),
                _fields(mid, _INJECT), churn)
            mid = mid._replace(churn_flush=flush)

    # ---- phase 4b: failure-detector interval ---------------------------
    with span("rapid.step.monitor"):
        probes_sent = probes_failed = zero
        new = mid
        if t % settings.fd_interval_ticks == 0:
            is_fd = t > mid.fd_gate
            fc, notified, notify_exp, sent, failed = member_map(
                lambda s, fl: monitor.monitor_tick(s, fl, settings, t, group),
                _fields(mid, _PROBE), faults)
            fd = is_fd.reshape(f, 1, 1)
            new = mid._replace(fc=torch.where(fd, fc, mid.fc),
                               notified=torch.where(fd, notified,
                                                    mid.notified),
                               pending_flush=notify_exp & fd)
            probes_sent = torch.where(is_fd, sent, zero)
            probes_failed = torch.where(is_fd, failed, zero)

    # ---- phase 4c: scripted proposes and fallback-timer fires ----------
    with span("rapid.step.task"):
        px_timers_armed = px_coord_round = zero
        if fallback is not None:
            for half, due in (("send", fb.sends(e, live, t)),
                              ("fire", ~decide & fb.fires(e, live, t))):
                if due.any():
                    stepped, task_counts = member_map(
                        lambda s, r, n: paxos.task_phase(
                            s, r, 0, t, n, half == "send", half == "fire",
                            group),
                        _fields(new, _PAXOS), rows, n_member)
                    new = host.merge(due, new._replace(**stepped._asdict()),
                                     new)
                    px.update({k: pick(due, v, zero)
                               for k, v in task_counts.items()})
                    host.px_gauges = None
            if host.px_gauges is None:
                host.px_gauges = (
                    i32(group.sum((new.px_timer != I32_MAX).sum(dim=-1))),
                    group.max(new.px_crnd_r.amax(dim=-1)))
            px_timers_armed, px_coord_round = host.px_gauges
        if variant == "ring" and "pxvote_senders" in px:
            # The scripted fast-round votes ride the ring's two laps too.
            px["pxvote_senders"] = torch.where(px["pxvote_senders"] > 0, 2,
                                               zero).to(torch.int32)

    with span("rapid.step.log"):
        inv_bits = zero
        if settings.invariant_checks:
            fast = no_members() if alert is None else alert
            classic = no_members() if sc is None else sc
            inv_bits = member_map(
                lambda pre, post, d, fd, cd, fm, cm: invariants.check_step(
                    pre, post, decide_now=d, fast_decide=fd, classic_decide=cd,
                    fast_mask=fm, classic_mask=cm, settings=settings,
                    group=group),
                state, new, decide_now, fast, classic, state.proposal,
                pmask & classic[:, None])

        if decided or host.config is None:
            host.config = config_id_limbs(new.idsum_hi, new.idsum_lo,
                                          new.memsum_hi, new.memsum_lo)
        cfg_hi, cfg_lo = host.config
        in_flight = group.sum(new.pending_flush.any(dim=-1).sum(dim=-1),
                              new.pending_deliver.any(dim=-1).sum(dim=-1),
                              new.churn_flush.sum(dim=-1),
                              new.churn_deliver.sum(dim=-1),
                              new.reports.sum(dim=(-2, -1)))
        alerts_in_flight = i32(in_flight[0] + in_flight[1] + in_flight[2]
                               + in_flight[3])
        log = StepLog(
            tick=tick_t,
            announce_now=announce_now,
            proposal=host.keep(announce, crossed, an),
            decide_now=decide_now,
            decision=decision,
            config_hi=cfg_hi, config_lo=cfg_lo,
            n_member=n_member,
            probes_sent=probes_sent, probes_failed=probes_failed,
            flushers=flushers, flush_recipients=flush_recipients,
            flushers_alive=flushers_alive,
            deliver_alive=torch.where(group.any(batch_src.any(dim=-1)),
                                      n_alive, zero),
            vote_senders=vote_senders, vote_recipients=vote_recipients,
            vote_senders_alive=vote_senders_alive,
            vote_deliver_alive=vote_deliver_alive,
            alerts_in_flight=alerts_in_flight,
            cut_reports=i32(in_flight[4]),
            implicit_reports=implicit_added,
            vote_tally=vote_tally, quorum=vote_quorum,
            epoch=new.epoch,
            churn_injected=churn_injected,
            partitioned_edges=zero if faults.link_src is None else member_map(
                lambda fl, m: monitor.partitioned_edge_count(fl, m, t, group),
                faults, new.member),
            link_dropped=zero,
            px_timers_armed=px_timers_armed, px_coord_round=px_coord_round,
            inv_bits=inv_bits,
            **{name: px.get(name, zero) for name in PX_COUNTS},
        )
    host.tick = t
    host.arriving = announce
    return new, log


def fleet_body(state: EngineState, faults: EngineFaults, churn, fallback,
               n_ticks: int, settings: Settings, mesh=None, fleet_mesh=None):
    """Run a stacked fleet ``n_ticks`` ticks: one host loop, one set of
    launches a tick for all F members. Every leaf of the inputs carries
    the member axis first; ``churn`` and ``fallback`` are required (inert
    schedules stand in for none, as the reference's fleets have them).
    Returns ``(finals, logs)`` with logs member-major ``[F, T, ...]``,
    and with ``settings.flight_recorder_window > 0`` ``(finals, logs,
    recorders)`` with ``[F, W, G]`` rings.

    ``mesh`` is a slot mesh. On one device the inputs must lie there; on
    ``D`` devices each input is split over it by
    ``sharding.fleet_shard_put`` (or given as its ``SlotShards``), every
    member's slots ``C / D`` a shard, and one thread per shard runs the
    fleet tick (``run_fleet_slots``). ``fleet_mesh`` splits the members
    over its devices (``sharding.fleet_axis_put``). Either way the
    outputs come back joined on the mesh's first device and equal the
    unsplit run. The two are mutually exclusive."""
    sharding.require_one_layout(mesh, fleet_mesh)
    if _split(mesh, state):
        return run_fleet_slots(_mesh_parts(
            (state, faults, churn, fallback), mesh, mesh.devices[0],
            fleet=True), n_ticks, settings)
    return run_fleet_shards(sharding.fleet_shards(
        (state, faults, churn, fallback), fleet_mesh, state.member.shape[0],
        state.member.device), n_ticks, settings)


def _fleet_outputs(state, logs, settings: Settings):
    """``(finals, logs)``, and with ``settings.flight_recorder_window``
    the recorders folded from the joined logs."""
    if settings.flight_recorder_window:
        return state, logs, recorder.record_fleet_run(logs, settings,
                                                      recorder.record_run)
    return state, logs


def _member_major(logs: List[StepLog]) -> StepLog:
    """Per-tick ``[F, ...]`` fleet logs -> ``[F, T, ...]``."""
    with span("rapid.fleet.join"):
        return StepLog(*[torch.stack(col, dim=1) for col in zip(*logs)])


def run_fleet_shards(parts: "sharding.FleetShards", n_ticks: int,
                     settings: Settings):
    """``fleet_body`` over ``FleetShards`` of ``(state, faults, churn,
    fallback)`` (a ``fleet.FleetMember`` is one): one ``_FleetHost`` per
    shard, the shards advanced in turns, each under its device's
    context, and the finals and logs joined in member order on the first
    shard's device."""
    hosts = []
    for dev, (state, faults, churn, fallback) in zip(parts.devices,
                                                     parts.shards):
        with sharding.device_context(dev), span("rapid.fleet.host"):
            hosts.append(_FleetHost(state, churn, fallback, faults))
    if len({h.tick for h in hosts}) != 1:
        raise ValueError("fleet members must start at one tick")

    def tick(k, state, _):
        _, _, churn, fallback = parts.shards[k]
        return _fleet_step(state, hosts[k].faults, settings, hosts[k], churn,
                           fallback)

    finals, shard_logs = sharding.run_shards(
        parts.devices, [p[0] for p in parts.shards], n_ticks, tick)
    home = parts.devices[0]
    return _fleet_outputs(
        sharding.join(finals, home),
        sharding.join([_member_major(logs) for logs in shard_logs], home),
        settings)


def _shard_run(group, shard, n_ticks: int, settings: Settings,
               tick: Optional[int] = None):
    """``n_ticks`` ticks of one slot shard's ``(state, faults, churn,
    fallback)`` (the whole fleet with ``SOLO``): its ``_FleetHost``,
    started at ``tick`` when given, then ``_fleet_step`` on ``group``;
    ``(finals, [F, T, ...] logs)``."""
    state, faults, churn, fallback = shard
    with span("rapid.fleet.host"):
        host = _FleetHost(state, churn, fallback, faults, group)
    if tick is not None:
        host.tick = int(tick)
    logs = []
    for _ in range(int(n_ticks)):
        with span("rapid.fleet.tick"):
            state, log = _fleet_step(state, host.faults, settings, host,
                                     churn, fallback, group)
        logs.append(log)
    return state, _member_major(logs)


def _slot_run(parts: "sharding.SlotShards", n_ticks: int, settings: Settings,
              tick: Optional[int] = None):
    """``_shard_run`` on every shard of ``parts``, one thread per shard
    (``sharding.run_spmd``), the finals and logs joined along each leaf's
    slot axis on the first shard's device."""
    out = sharding.run_spmd(
        lambda group, shard: _shard_run(group, shard, n_ticks, settings,
                                        tick), parts)
    home = parts.devices[0]
    return (state_mod.join_slots([o[0] for o in out], home, fleet=True),
            state_mod.join_slots([o[1] for o in out], home, fleet=True))


def run_fleet_slots(parts: "sharding.SlotShards", n_ticks: int,
                    settings: Settings):
    """``fleet_body`` over ``SlotShards`` of ``(state, faults, churn,
    fallback)`` (``sharding.fleet_shard_put`` of a ``fleet.FleetMember``
    is one) by ``_slot_run``; a single shard (the divisibility guard)
    runs the whole fleet there."""
    return _fleet_outputs(*_slot_run(parts, n_ticks, settings), settings)
