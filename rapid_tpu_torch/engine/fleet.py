"""Fleets: F independent clusters advanced together, one member axis.

The reference ``vmap``s its scanned tick over a leading fleet axis. The
port runs one host loop for the whole fleet and one set of kernel
launches a tick, on tensors whose first axis is the member
(``step.fleet_body``, ``receiver.receiver_fleet_simulate``); every member's
slice equals its own single-cluster run bit for bit.

Lowering (``lower_schedule``) compiles an ``faults.AdversarySchedule``
into a ``FleetMember`` on a device:

- crashes -> ``EngineFaults.crash_tick`` (padded to capacity with
  ``I32_MAX``), windows -> the ``link_*`` tensors;
- scripted proposes -> a one-instance ``paxos.FallbackSchedule`` gated on
  epoch 0 (``_compile_proposes``): the explicit ``delay_ticks`` is the
  slot's fallback timer, the distinct proposals the fingerprint table;
- a churn schedule without redraws rides along (an inert one otherwise).

Slot identities default to the differential universe
(``identity.default_identities``); a boot per shape and boot member mask
is cached (``clear_boot_caches``) and each member patches in its
dormant-slot identifier fingerprints. Every slot of the padded universe
boots a member unless ``member`` masks the boot view, so that a churn
schedule's joiners start dormant. ``stack_members`` pads window rows,
fallback instances (negative ``inst_epoch``) and pids (all-False rows) to
the fleet's maxima, or to a campaign's larger ones, and stacks every
leaf.

Per-receiver members (``lower_receiver_schedule``,
``stack_receiver_members``) carry the receiver state in the layout that
``Settings.rx_kernel`` names (dense under "xla", packed otherwise) and
their link windows and delay rules; ``check_receiver_budget`` refuses a
capacity above ``Settings.receiver_capacity_cap`` with a
``ReceiverBudgetError`` before anything is allocated.

Not here: ``enable_compile_cache``, ``fleet_aot_compile`` and
``receiver_fleet_aot_compile`` exist to persist and time XLA
executables; the port compiles nothing ahead of time (its kernels are
built once by ``rx_account.build``).

Meshes (``engine.sharding``): ``fleet_mesh`` splits the member axis over
its devices, whole members on each (``fleet_axis_put``); the fleet loops
advance the shards in turns and join the outputs in member order on the
mesh's first device, equal to the unsplit run. ``mesh`` is a slot mesh
of any size: on ``D`` devices every member's slots are split over it
(``fleet_shard_put``, the member axis whole), one thread per shard runs
the fleet tick (``step.run_fleet_slots``) and the outputs are joined
along each leaf's slot axis, equal to the unsplit run.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree

from rapid_tpu_torch import hashing
from rapid_tpu_torch.device import resolve_device
from rapid_tpu_torch.engine import churn as churn_mod
from rapid_tpu_torch.engine import paxos, sharding
from rapid_tpu_torch.engine.state import (
    I32_MAX, EngineFaults, EngineState, ReceiverState, init_state,
    is_limb_field, link_faults, pad_delay_rules, pad_link_windows)
from rapid_tpu_torch.faults import AdversarySchedule, validate_schedule
from rapid_tpu_torch.identity import default_identities
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry.trace import span


class FleetMember(NamedTuple):
    """One cluster's device program: state plus lowered scripts. ``churn``
    and ``fallback`` are always present (inert schedules for none), so
    every member stacks alike."""

    state: EngineState
    faults: EngineFaults
    churn: churn_mod.ChurnSchedule
    fallback: paxos.FallbackSchedule


class ReceiverMember(NamedTuple):
    """One per-receiver cluster: its state (a dense ``ReceiverState``
    under ``rx_kernel="xla"``, an ``rx_packed.PackedReceiverBundle``
    otherwise) and its faults."""

    state: object
    faults: EngineFaults


#: Booted default-universe states, keyed by
#: ``(n, len(uids), id_fp_sum, settings, device, mask)`` (``mask`` the
#: boot member mask's bytes, None for every slot); members of one shape
#: and mask differ only in their dormant-slot identifier fingerprints.
_BOOT_CACHE: Dict[Tuple, EngineState] = {}

#: Per-receiver boots (dense under "xla", packed otherwise), keyed by
#: ``(n, id_fp_sum, settings, device)``: only the delay table depends
#: on the schedule's seed.
_RX_BOOT_CACHE: Dict[Tuple, object] = {}


def clear_boot_caches() -> None:
    """Drop the cached boots."""
    _BOOT_CACHE.clear()
    _RX_BOOT_CACHE.clear()


def _to_device(host, device):
    """A numpy ``ChurnSchedule``/``FallbackSchedule`` on ``device``; one
    of tensors moves there."""
    from rapid_tpu_torch.convert import from_reference

    if all(leaf is None or torch.is_tensor(leaf) for leaf in host):
        return type(host)(*[None if leaf is None else leaf.to(device)
                            for leaf in host])
    return from_reference(host, device=device)


def _compile_proposes(schedule: AdversarySchedule, uids_np: np.ndarray,
                      c: int) -> paxos.FallbackSchedule:
    """Scripted proposes -> one host instance gated on epoch 0: distinct
    proposals become table rows, each propose arms its slot's timer with
    its explicit delay."""
    values = sorted({tuple(p.proposal) for p in schedule.proposes})
    sched = paxos.empty_fallback_schedule(c, instances=1,
                                          pids=max(1, len(values)))
    if not values:
        return sched
    pid_of = {v: i for i, v in enumerate(values)}
    for p in schedule.proposes:
        sched.prop_tick[0, p.slot] = p.tick
        sched.prop_pid[0, p.slot] = pid_of[tuple(p.proposal)]
        sched.prop_delay[0, p.slot] = p.delay_ticks
    for v, pid in pid_of.items():
        sched.table_mask[0, pid, list(v)] = True
    paxos._fingerprint_tables(sched, uids_np, c)
    return sched


def _patch_id_fps(state: EngineState, id_fps, c: int) -> EngineState:
    """A cached boot with this member's identifier fingerprints, as
    ``init_state(..., id_fps=...)`` gives them (zero-padded to C)."""
    ifp = np.zeros(c, np.uint64)
    ifp[:len(id_fps)] = np.asarray(id_fps, dtype=np.uint64)
    hi, lo = hashing.np_to_limbs(ifp)
    dev = state.member.device
    return state._replace(
        idfp_hi=torch.from_numpy(hi.astype(np.int64)).to(dev),
        idfp_lo=torch.from_numpy(lo.astype(np.int64)).to(dev))


def _uids_np_from_state(state: EngineState) -> np.ndarray:
    hi = state.uid_hi.cpu().numpy().astype(np.uint64)
    lo = state.uid_lo.cpu().numpy().astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def lower_schedule(schedule: AdversarySchedule, settings: Settings, *,
                   churn: Optional[churn_mod.ChurnSchedule] = None,
                   id_fps: Optional[np.ndarray] = None,
                   uids: Optional[Sequence[int]] = None,
                   id_fp_sum: Optional[int] = None,
                   member: Optional[Sequence[bool]] = None,
                   device="cuda") -> FleetMember:
    """Compile one ``AdversarySchedule`` into a ``FleetMember`` on
    ``device`` (module docstring). ``churn`` (host or device) must carry
    no redraw script; delay rules are refused (the shared wire has no
    per-edge arrival ticks). The universe is padded to
    ``settings.capacity`` when that exceeds ``schedule.n``. ``member``
    (bool ``[C]``) is the boot view, as ``state.init_state`` takes it:
    slots outside it boot dormant; None boots every slot of the padded
    universe a member."""
    dev = resolve_device(device)
    with span("rapid.lower.validate"):
        validate_schedule(schedule)
    if schedule.delays:
        raise ValueError("shared-state members do not support delay rules; "
                         "lower with lower_receiver_schedule instead")
    if churn is not None and churn.redraw_tick is not None:
        raise ValueError("fleet members cannot carry redraw scripts "
                         "(every member must stack alike)")
    n = schedule.n
    default_universe = uids is None
    if uids is None:
        uids, default_sum = default_identities(n)
        if id_fp_sum is None:
            id_fp_sum = default_sum
    elif id_fp_sum is None:
        id_fp_sum = 0
    c = max(settings.capacity, n)
    eff = settings if settings.capacity == c else settings.with_(capacity=c)
    if member is not None:
        member = np.asarray(member, bool)
        if member.shape != (c,):
            raise ValueError(f"member mask of shape {member.shape}, the "
                             f"universe has {c} slots")
    span_to = c if member is not None else (
        0 if id_fps is None else len(id_fps))
    if span_to > len(uids):
        # id_fps or a boot view spanning the padded universe: extend the
        # uids with the boot's own pad rule so all stay slot-aligned.
        uids = list(uids) + [hashing.hash64(i, seed=0x636170)
                             for i in range(span_to - len(uids))]
    with span("rapid.lower.boot"):
        if default_universe:
            mask = None if member is None else member.tobytes()
            key = (n, len(uids), id_fp_sum, eff, dev, mask)
            state = _BOOT_CACHE.get(key)
            if state is None:
                state = _BOOT_CACHE[key] = init_state(
                    uids, id_fp_sum, eff, member=member, device=dev)
            if id_fps is not None:
                state = _patch_id_fps(state, id_fps, c)
        else:
            state = init_state(uids, id_fp_sum, eff, member=member,
                               id_fps=id_fps, device=dev)
    crash = np.full(c, I32_MAX, np.int64)
    crash[:n] = schedule.crash_tick_array()
    with span("rapid.lower.faults"):
        faults = link_faults(crash.tolist(), schedule.windows, c, device=dev)
    with span("rapid.lower.proposes"):
        fallback = _compile_proposes(schedule, _uids_np_from_state(state), c)
    with span("rapid.lower.churn"):
        churn = _to_device(churn_mod.empty_schedule(c) if churn is None
                           else churn, dev)
    return FleetMember(state=state, faults=faults, churn=churn,
                       fallback=_to_device(fallback, dev))


def _pad_fallback(sched: paxos.FallbackSchedule, n_inst: int,
                  n_pids: int) -> paxos.FallbackSchedule:
    """Instances and pids padded so schedules stack: pad instances get
    negative ``inst_epoch`` (the epoch never goes negative, so they are
    never live); pad pids are all-False rows no ``prop_pid`` names."""
    i0, p0, c = sched.table_mask.shape
    if (i0, p0) == (n_inst, n_pids):
        return sched
    i_pad, p_pad = n_inst - i0, n_pids - p0
    if i_pad < 0 or p_pad < 0:
        raise ValueError("cannot shrink a fallback schedule")
    dev = sched.table_mask.device

    def cat(a, pad_shape, fill, dim=0):
        return torch.cat([a, torch.full(pad_shape, fill, dtype=a.dtype,
                                        device=dev)], dim=dim)

    def pad_table(a, *row):
        a = cat(a, (i0, p_pad) + row, 0, dim=1)
        return cat(a, (i_pad, n_pids) + row, 0)

    return paxos.FallbackSchedule(
        inst_epoch=torch.cat([sched.inst_epoch, -torch.arange(
            1, i_pad + 1, dtype=sched.inst_epoch.dtype, device=dev)]),
        prop_tick=cat(sched.prop_tick, (i_pad, c), I32_MAX),
        prop_pid=cat(sched.prop_pid, (i_pad, c), -1),
        prop_delay=cat(sched.prop_delay, (i_pad, c), 0),
        table_mask=pad_table(sched.table_mask, c),
        table_hi=pad_table(sched.table_hi),
        table_lo=pad_table(sched.table_lo))


def _resolve_max(requested: Optional[int], fleet_max: int, what: str) -> int:
    if requested is None:
        return fleet_max
    if requested < fleet_max:
        raise ValueError(f"{what}={requested} below the fleet max "
                         f"{fleet_max}; padding cannot shrink")
    return requested


def _stack(members):
    """Every leaf stacked on a new leading member axis; members whose
    ``None`` leaves or drop configurations differ do not stack."""
    configs = {tuple(getattr(m.faults, f) for f in EngineFaults.DROP_CONFIG)
               for m in members}
    if len(configs) != 1:
        raise ValueError("fleet members must share one probe-drop "
                         "configuration (EngineFaults.DROP_CONFIG)")

    def stack(*leaves):
        if all(leaf is None for leaf in leaves):
            return None
        if any(leaf is None for leaf in leaves):
            raise ValueError("fleet members differ in which fault fields "
                             "they carry")
        return torch.stack(leaves)

    return _pytree.tree_map(stack, *members)


def stack_members(members: Sequence[FleetMember], *,
                  n_windows: Optional[int] = None,
                  n_instances: Optional[int] = None,
                  n_pids: Optional[int] = None) -> FleetMember:
    """Stack members on a new leading fleet axis. They must share
    capacity, the probe-drop configuration and no redraw scripts; window
    rows and fallback instances and pids are padded with inert rows to
    the fleet's maxima, or to ``n_windows``/``n_instances``/``n_pids``
    where a campaign passes its larger ones (never smaller)."""
    if not members:
        raise ValueError("empty fleet")
    c0 = int(members[0].state.member.shape[0])
    for m in members:
        if int(m.state.member.shape[0]) != c0:
            raise ValueError("fleet members must share one capacity")
        if m.churn.redraw_tick is not None:
            raise ValueError("fleet members cannot carry redraw scripts")
    w = _resolve_max(n_windows, max(m.faults.n_windows for m in members),
                     "n_windows")
    n_inst = _resolve_max(
        n_instances, max(m.fallback.inst_epoch.shape[0] for m in members),
        "n_instances")
    pids = _resolve_max(
        n_pids, max(m.fallback.table_mask.shape[1] for m in members),
        "n_pids")
    with span("rapid.lower.stack"):
        return _stack([m._replace(faults=pad_link_windows(m.faults, w),
                                  fallback=_pad_fallback(m.fallback, n_inst,
                                                         pids))
                       for m in members])


def _placed_on(tree, dev: torch.device) -> None:
    for leaf in _pytree.tree_leaves(tree):
        if torch.is_tensor(leaf) and leaf.device != dev:
            raise ValueError(f"a fleet leaf lives on {leaf.device}, the "
                             f"run was asked for {dev}")


def _shards(fleet, mesh, fleet_mesh, device) -> sharding.FleetShards:
    """``fleet`` (stacked, or ``sharding.FleetShards``) as the shards the
    run takes, each checked to lie on its device, index included.
    Without a fleet mesh the whole fleet is one shard on ``device``, or
    on the one-device slot mesh's device."""
    dev = resolve_device(device)
    home = sharding.require_slot_mesh(mesh)
    if home is None:
        home = sharding.pinned(dev)
    shards = fleet if isinstance(fleet, sharding.FleetShards) else \
        sharding.fleet_shards(fleet, fleet_mesh, _fleet_size(fleet), home)
    _check_placed(shards, dev)
    return shards


def _check_placed(shards, dev: torch.device) -> None:
    for tree, where in zip(shards.shards, shards.devices):
        if where.type != dev.type:
            raise ValueError(f"a fleet shard is placed on {where}, the run "
                             f"was asked for {dev}")
        _placed_on(tree, where)


def _fleet_size(fleet) -> int:
    state = fleet.state
    return int(getattr(state, "packed", state).member.shape[0])


def fleet_simulate(fleet: FleetMember, n_ticks: int, settings: Settings,
                   mesh=None, fleet_mesh=None, device="cuda") -> tuple:
    """Run every member of a stacked fleet ``n_ticks`` ticks on
    ``device``; returns ``(finals, logs)`` with the member axis first on
    every leaf (logs ``[F, T, ...]``), and with
    ``settings.flight_recorder_window > 0`` ``(finals, logs, recorders)``
    (``[F, W, G]`` rings, ``[F]`` stamps).

    ``fleet_mesh`` (``sharding.fleet_axis_mesh`` of ``device``'s type)
    splits the members over its devices; ``fleet`` may also be the
    ``FleetShards`` that ``sharding.fleet_axis_put`` gave. ``mesh`` is a
    slot mesh: on one device the fleet must lie there; on ``D`` devices
    every member's slots are split over it (``sharding.fleet_shard_put``,
    whose ``SlotShards`` ``fleet`` may also be) and one thread per shard
    runs the fleet tick (``step.run_fleet_slots``). The outputs come back
    joined on the mesh's first device, equal to the unsplit run's."""
    from rapid_tpu_torch.engine import step

    sharding.require_one_layout(mesh, fleet_mesh)
    with span("rapid.fleet.dispatch"):
        if step._split(mesh, fleet):
            dev = resolve_device(device)
            parts = step._mesh_parts(fleet, mesh, dev, fleet=True)
            _check_placed(parts, dev)
            return step.run_fleet_slots(parts, int(n_ticks), settings)
        return step.run_fleet_shards(
            _shards(fleet, mesh, fleet_mesh, device), int(n_ticks), settings)


def member_of(tree, i: int):
    """Member ``i`` out of any stacked fleet pytree (a ``FleetMember``,
    states, faults, schedules, logs)."""
    return _pytree.tree_map(lambda leaf: None if leaf is None else leaf[i],
                            tree)


def member_logs(logs, i: int):
    """Member ``i``'s ``[T, ...]`` logs out of fleet logs."""
    return member_of(logs, i)


# --- per-receiver members -----------------------------------------------


class ReceiverBudgetError(ValueError):
    """A per-receiver fleet would exceed the sized memory budget. Raised
    before any allocation, with the per-member and total bytes."""

    def __init__(self, capacity: int, fleet_size: int, cap: int,
                 member_bytes: int, total_bytes: int, *,
                 packed_bytes: Optional[int] = None,
                 unpacked_bytes: Optional[int] = None) -> None:
        self.capacity = capacity
        self.fleet_size = fleet_size
        self.cap = cap
        self.member_bytes = member_bytes
        self.total_bytes = total_bytes
        self.packed_bytes = packed_bytes
        self.unpacked_bytes = unpacked_bytes
        diet = ""
        if packed_bytes is not None and unpacked_bytes:
            diet = (f"; packed layout {packed_bytes / 2**20:.1f} MiB vs "
                    f"{unpacked_bytes / 2**20:.1f} MiB dense "
                    f"({unpacked_bytes / packed_bytes:.1f}x headroom via "
                    f"Settings.rx_kernel)")
        super().__init__(
            f"per-receiver fleet over budget: capacity {capacity} > "
            f"receiver_capacity_cap {cap} "
            f"({member_bytes / 2**20:.1f} MiB/member, "
            f"{total_bytes / 2**20:.1f} MiB for fleet of {fleet_size}; "
            f"raise Settings.receiver_capacity_cap to override{diet})")


def receiver_field_shapes(capacity: int, k: int, n_draws: int = 4,
                          ring_depth: int = 4):
    """``{field: (shape, itemsize)}`` of every ``ReceiverState`` leaf in
    the reference's layout (32-bit limbs, 1-byte bools)."""
    c, d = capacity, ring_depth
    b, i, u = 1, 4, 4
    s = {"tick": ((), i), "flags": ((), i),
         "idsum_hi": ((), u), "idsum_lo": ((), u),
         "delay_table": ((c, n_draws, c + 1), i),
         "ring_order": ((c, k), i), "ring_rank": ((c, k), i),
         "obs_full": ((c, c, k), i), "reports": ((c, c, k), b),
         "own_subj": ((c, k), i), "own_fd_first": ((c, k), i),
         "own_fd_active": ((c, k), b), "fc": ((c, k), i),
         "notified": ((c, k), b), "pf": ((c, k), b),
         "pf_dst": ((c, k), i),
         "pd": ((d, c, k), b), "pd_dst": ((d, c, k), i),
         "w2b": ((d, 2, c, c), b), "w2b_rnd": ((d, 2, c), i),
         "w2b_fp_hi": ((d, 2, c), u), "w2b_fp_lo": ((d, 2, c), u),
         "w2b_mask": ((d, 2, c, c), b)}
    for f in ("uid_hi", "uid_lo", "mfp_hi", "mfp_lo", "memsum_hi",
              "memsum_lo", "cfg_hi", "cfg_lo", "pf_cfg_hi", "pf_cfg_lo",
              "reg_fp_hi", "reg_fp_lo", "px_vv_fp_hi", "px_vv_fp_lo"):
        s[f] = ((c,), u)
    for f in ("pd_cfg_hi", "pd_cfg_lo", "wv_fp_hi", "wv_fp_lo",
              "wv_cfg_hi", "wv_cfg_lo", "w1a_cfg_hi", "w1a_cfg_lo",
              "w1b_fp_hi", "w1b_fp_lo", "w1b_cfg_hi", "w1b_cfg_lo",
              "w2a_fp_hi", "w2a_fp_lo", "w2a_cfg_hi", "w2a_cfg_lo",
              "w2b_cfg_hi", "w2b_cfg_lo"):
        s[f] = ((d, c), u)
    for f in ("rank_idx", "draws", "epoch", "rx_pos", "px_n", "fd_gate",
              "ar_seq", "px_rnd_r", "px_rnd_i", "px_vrnd_r",
              "px_vrnd_i", "px_crnd_r", "px_timer", "p2_rnd"):
        s[f] = ((c,), i)
    for f in ("wv_seq", "w1a_seq", "w1a_tick", "w1b_vrnd_r", "w1b_vrnd_i",
              "w1b_seq", "w2a_seq", "w2a_tick"):
        s[f] = ((d, c), i)
    for f in ("stopped", "seen_down", "announced", "reg_valid",
              "px_vv_set", "px_cval_set"):
        s[f] = ((c,), b)
    for f in ("member", "reg_mask", "vt_seen", "pb_seen", "pb_set",
              "p2_seen", "p2_mask"):
        s[f] = ((c, c), b)
    for f in ("vt_fp_hi", "vt_fp_lo", "pb_fp_hi", "pb_fp_lo"):
        s[f] = ((c, c), u)
    for f in ("pb_vrnd_r", "pb_vrnd_i", "pb_seq"):
        s[f] = ((c, c), i)
    s["w1b_set"] = ((d, c), b)
    for f in ("wv", "w1a", "w1b", "w2a", "w2a_mask", "pd_bcast"):
        s[f] = ((d, c, c), b)
    return s


def _tree_bytes(tree) -> int:
    """Bytes of a pytree of tensors in the reference's layout: limb
    fields count 4 bytes an element (the reference's uint32)."""
    total = 0
    for name, leaf in zip(tree._fields, tree):
        item = 4 if is_limb_field(name) else leaf.element_size()
        total += leaf.numel() * item
    return total


def _meta_state(capacity: int, k: int, n_draws: int,
                ring_depth: int) -> ReceiverState:
    """A dense ``ReceiverState`` of meta tensors (no memory allocated),
    in the port's dtypes."""
    shapes = receiver_field_shapes(capacity, k, n_draws, ring_depth)
    dtype = lambda name, item: (torch.bool if item == 1 else torch.int64
                                if is_limb_field(name) else torch.int32)
    return ReceiverState(**{
        name: torch.empty(shape, dtype=dtype(name, item), device="meta")
        for name, (shape, item) in shapes.items()})


def dense_state_bytes(capacity: int, k: int, n_draws: int = 4,
                      ring_depth: int = 4) -> int:
    """Bytes of one dense ``ReceiverState`` in the reference's layout."""
    return _tree_bytes(_meta_state(capacity, k, n_draws, ring_depth))


@functools.lru_cache(maxsize=None)
def _state_bytes(capacity: int, settings: Settings) -> Tuple[int, int]:
    """``(dense_bytes, bundle_bytes)`` of one member at ``capacity``: the
    dense ``ReceiverState`` and the packed carry plus its delay table,
    from the shapes ``pack_receiver_state`` produces on meta tensors (no
    memory is allocated)."""
    from rapid_tpu_torch.engine import receiver, rx_packed

    dense = _meta_state(capacity, settings.K, receiver.N_DRAWS,
                        settings.delivery_ring_depth)
    packed = rx_packed.pack_receiver_state(dense, settings)
    table = dense.delay_table
    return (_tree_bytes(dense),
            _tree_bytes(packed) + table.numel() * table.element_size())


def check_receiver_budget(capacity: int, fleet_size: int,
                          settings: Settings) -> int:
    """Per-member bytes of a per-receiver fleet, or
    ``ReceiverBudgetError`` when ``capacity`` exceeds
    ``settings.receiver_capacity_cap``. The figures are the reference's:
    the packed bundle's bytes (``packed_bytes``) and the dense state's
    (``unpacked_bytes``), with 32-bit limbs, which the port carries in
    int64 (``state``'s docstring); ``member_bytes`` is the layout that
    ``settings.rx_kernel`` names. Campaigns compare them across the two
    packages."""
    dense_bytes, packed_bytes = _state_bytes(capacity, settings)
    member_bytes = dense_bytes if settings.rx_kernel == "xla" \
        else packed_bytes
    if capacity > settings.receiver_capacity_cap:
        raise ReceiverBudgetError(capacity, fleet_size,
                                  settings.receiver_capacity_cap,
                                  member_bytes, member_bytes * fleet_size,
                                  packed_bytes=packed_bytes,
                                  unpacked_bytes=dense_bytes)
    return member_bytes


def lower_receiver_schedule(schedule: AdversarySchedule, settings: Settings,
                            *, uids: Optional[Sequence[int]] = None,
                            id_fp_sum: Optional[int] = None,
                            fleet_size: int = 1,
                            device="cuda") -> ReceiverMember:
    """Compile one link-fault schedule into a booted member on
    ``device``: its state in the layout ``settings.rx_kernel`` names (a
    dense ``ReceiverState`` under "xla", a ``PackedReceiverBundle``
    otherwise) plus its ``EngineFaults``. Scripted proposes are refused;
    delay rules are budget-checked against
    ``settings.delivery_ring_depth``; ``check_receiver_budget`` runs for
    a fleet of ``fleet_size`` before anything is allocated."""
    from rapid_tpu_torch.engine import receiver, rx_packed

    dense = settings.rx_kernel == "xla"
    dev = resolve_device(device)
    if schedule.proposes:
        raise ValueError("per-receiver members do not support scripted "
                         "proposes; lower with lower_schedule instead")
    with span("rapid.lower.validate"):
        validate_schedule(schedule, ring_depth=settings.delivery_ring_depth)
    n = schedule.n
    c = max(settings.capacity, n)
    eff = settings if settings.capacity == c else settings.with_(capacity=c)
    with span("rapid.lower.budget"):
        check_receiver_budget(c, fleet_size, eff)
    default_universe = uids is None
    if uids is None:
        uids, default_sum = default_identities(n)
        if id_fp_sum is None:
            id_fp_sum = default_sum
    elif id_fp_sum is None:
        id_fp_sum = 0
    if default_universe:
        # Only the delay table depends on the seed; the carry is booted
        # once per shape (the packed carry leaves the table out, the
        # dense one takes the member's in its place).
        key = (n, id_fp_sum, eff, dev)
        with span("rapid.lower.boot"):
            boot = _RX_BOOT_CACHE.get(key)
            if boot is None:
                boot = receiver.init_receiver_state(uids, id_fp_sum, eff,
                                                    seed=0, device=dev)
                if not dense:
                    boot = rx_packed.pack_receiver_state(boot, eff)
                _RX_BOOT_CACHE[key] = boot
        with span("rapid.lower.delays"):
            table = torch.from_numpy(paxos.build_delay_table(
                schedule.seed, c, receiver.N_DRAWS, eff)).to(dev)
        state = (boot._replace(delay_table=table) if dense else
                 rx_packed.PackedReceiverBundle(packed=boot,
                                                delay_table=table))
    else:
        with span("rapid.lower.boot"):
            state = receiver.init_receiver_state(
                uids, id_fp_sum, eff, seed=schedule.seed, device=dev)
            if not dense:
                state = rx_packed.bundle_from_dense(state, eff)
    crash = np.full(c, I32_MAX, np.int64)
    crash[:n] = schedule.crash_tick_array()
    with span("rapid.lower.faults"):
        faults = link_faults(crash.tolist(), schedule.windows, c,
                             delays=schedule.delays,
                             delay_seed=schedule.seed, device=dev)
    return ReceiverMember(state=state, faults=faults)


def stack_receiver_members(members: Sequence[ReceiverMember], *,
                           n_windows: Optional[int] = None,
                           n_delay_rules: Optional[int] = None
                           ) -> ReceiverMember:
    """Stack per-receiver members on a new leading fleet axis, as
    ``stack_members`` does: one capacity, window rows and delay rules
    padded with inert rows to the fleet's maxima or the larger
    ``n_windows``/``n_delay_rules``. Every plane becomes ``[F, ...]``;
    the members share one layout, dense or packed."""
    if not members:
        raise ValueError("empty fleet")
    layouts = {type(m.state) for m in members}
    if len(layouts) != 1:
        raise ValueError("fleet members must share one carry layout")
    # The slot axis is first on every plane of either layout.
    capacity = lambda m: int(getattr(m.state, "packed", m.state)
                             .member.shape[0])
    c0 = capacity(members[0])
    for m in members:
        if capacity(m) != c0:
            raise ValueError("fleet members must share one capacity")
    w = _resolve_max(n_windows, max(m.faults.n_windows for m in members),
                     "n_windows")
    r = _resolve_max(n_delay_rules,
                     max(m.faults.n_delay_rules for m in members),
                     "n_delay_rules")
    with span("rapid.lower.stack"):
        return _stack([m._replace(
            faults=pad_delay_rules(pad_link_windows(m.faults, w), r))
            for m in members])


def receiver_fleet_simulate(fleet: ReceiverMember, n_ticks: int,
                            settings: Settings, fleet_mesh=None,
                            device="cuda") -> tuple:
    """Run a stacked per-receiver fleet ``n_ticks`` ticks on ``device``:
    ``(finals, logs)`` with the member axis first, the finals in the
    carry's layout (``receiver.receiver_final_view`` reads either), and
    with ``settings.flight_recorder_window > 0`` ``(finals, logs,
    recorders)``. ``fleet_mesh`` splits the members over its devices, as
    in ``fleet_simulate``; ``fleet`` may be ``sharding.FleetShards``."""
    from rapid_tpu_torch.engine import receiver

    with span("rapid.fleet.dispatch"):
        return receiver.receiver_fleet_run(
            _shards(fleet, None, fleet_mesh, device), int(n_ticks), settings)
