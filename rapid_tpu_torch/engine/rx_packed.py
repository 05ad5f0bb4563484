"""Packed per-receiver scan carry, and the tick loop over it.

The dense ``ReceiverState`` is quadratic per member, mostly in bool
planes. Between ticks the port carries :class:`PackedReceiverState`:

- every bool plane becomes a little-endian uint8 bit-plane packed along
  its trailing axis (``[C, C] -> [C, ceil(C/8)]``); ``reports [C, C, K]``
  is transposed to ``[C, K, C]`` first so the packed axis is C-sized;
- per-slot epochs become narrow deltas from the shared minimum, clamped
  AND flagged (``receiver.FLAG_EPOCH_DELTA_SAT``) when they do not fit
  ``Settings.rx_epoch_delta_bits``;
- ``obs_full`` is dropped and rebuilt from membership at unpack (the step
  keeps ``obs_full[r] == build_topology(member[r])`` at every tick start);
- ``delay_table`` (read-only in the step) rides beside the carry in
  :class:`PackedReceiverBundle`;
- ``pb_vrnd_r``/``pb_vrnd_i`` narrow to int8/int16 with the same
  clamp-and-flag guard (``receiver.FLAG_PACK_NARROW_SAT``).

``unpack(pack(rs)) == rs`` bit for bit whenever no saturation flag fires,
and ``simulate_chunk`` runs the dense ``receiver_step`` between unpack and
pack, so results are those of the dense step; its packed final feeds
the next chunk as it is. ``fleet_simulate`` does the same
for a stacked fleet and keeps its finals packed (``final_view`` unpacks
what the host reads); ``dense_fleet_simulate`` is its twin on the dense
carry (``rx_kernel="xla"``), with no unpack or repack.

This carry serves ``rx_kernel`` "packed" and "pallas" alike. In the
reference the two differ in the delivery ("packed" runs the dense
``_account``, "pallas" the Pallas kernel, bit-identical to it); the port
has one delivery for every layout, so the two run the same code.
``dense_state_bytes``, ``packed_state_bytes`` and ``bundle_state_bytes``
count one member of each layout in the reference's dtypes.
"""
from __future__ import annotations

import collections
import functools

import torch

from rapid_tpu_torch.engine.state import (
    ReceiverState, ReceiverStepLog, flag_bit)
from rapid_tpu_torch.engine.topology import build_topology
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry.trace import span

#: Dense leaves that leave the packed carry entirely.
OMITTED_FIELDS = ("obs_full", "delay_table", "epoch")

#: Bool leaves carried as packed uint8 bit-planes (trailing axis / 8).
BIT_FIELDS = frozenset((
    "stopped", "seen_down", "announced", "reg_valid", "px_vv_set",
    "px_cval_set",
    "own_fd_active", "notified", "pf",
    "pd",
    "w1b_set",
    "member", "reg_mask", "vt_seen", "pb_seen", "pb_set", "p2_seen",
    "p2_mask",
    "wv", "w1a", "w1b", "w2a", "w2a_mask", "pd_bcast",
    "w2b", "w2b_mask",
    "reports",
))

#: BIT_FIELDS whose trailing (packed) axis is K-sized, not C-sized.
_K_LAST = frozenset(("own_fd_active", "notified", "pf", "pd"))

#: int32 leaves narrowed in the packed carry: name -> (dtype, lo, hi).
NARROW_FIELDS = {
    "pb_vrnd_r": (torch.int8, -128, 127),
    "pb_vrnd_i": (torch.int16, -32768, 32767),
}

PackedReceiverState = collections.namedtuple(
    "PackedReceiverState",
    [f for f in ReceiverState._fields if f not in OMITTED_FIELDS]
    + ["epoch_base", "epoch_delta"])

#: The packed carry plus the read-only delay table.
PackedReceiverBundle = collections.namedtuple(
    "PackedReceiverBundle", ("packed", "delay_table"))


#: ``_bit_weights`` by device: built once, never written.
_WEIGHTS = {}


def _bit_weights(device):
    """uint8 ``[8]``: ``1 << j``. Cached per device, except while a CUDA
    graph captures (its private pool would own the tensor)."""
    device = torch.device(device)
    w = _WEIGHTS.get(device)
    if w is None:
        w = (1 << torch.arange(8, dtype=torch.int32, device=device)).to(
            torch.uint8)
        if device.type != "cuda" or \
                not torch.cuda.is_current_stream_capturing():
            _WEIGHTS[device] = w
    return w


def pack_bits(x):
    """bool ``[..., n]`` -> uint8 ``[..., ceil(n/8)]``, little-endian along
    the last axis (bit ``j`` of byte ``b`` is ``x[..., 8*b + j]``), the
    last byte zero-padded."""
    n = x.shape[-1]
    nb = -(-n // 8)
    if nb * 8 != n:
        pad = torch.zeros(x.shape[:-1] + (nb * 8 - n,), dtype=torch.bool,
                          device=x.device)
        x = torch.cat([x, pad], dim=-1)
    planes = x.reshape(x.shape[:-1] + (nb, 8)).to(torch.uint8)
    return (planes * _bit_weights(x.device)).sum(dim=-1, dtype=torch.uint8)


def unpack_bits(x, count: int):
    """uint8 ``[..., nb]`` -> bool ``[..., count]`` (inverse of pack_bits)."""
    bits = (x[..., None] & _bit_weights(x.device)) != 0
    return bits.reshape(x.shape[:-1] + (x.shape[-1] * 8,))[..., :count]


def _delta_width(settings: Settings):
    if settings.rx_epoch_delta_bits == 8:
        return torch.int8, 127
    return torch.int16, 32767


def pack_receiver_state(rs: ReceiverState,
                        settings: Settings) -> PackedReceiverState:
    """Dense -> packed, clamping-and-flagging any value that does not fit
    its narrow carry dtype."""
    from rapid_tpu_torch.engine import receiver as receiver_mod

    flags = rs.flags
    ddtype, dmax = _delta_width(settings)
    base = rs.epoch.min()
    delta = rs.epoch - base
    flags = flags | flag_bit((delta > dmax).any(),
                          receiver_mod.FLAG_EPOCH_DELTA_SAT)
    kw = {"epoch_base": base,
          "epoch_delta": torch.clamp(delta, 0, dmax).to(ddtype)}
    for name in PackedReceiverState._fields:
        if name in kw or name == "flags":
            continue
        leaf = getattr(rs, name)
        if name == "reports":
            kw[name] = pack_bits(leaf.transpose(-1, -2))
        elif name in BIT_FIELDS:
            kw[name] = pack_bits(leaf)
        elif name in NARROW_FIELDS:
            ndtype, lo, hi = NARROW_FIELDS[name]
            flags = flags | flag_bit(((leaf < lo) | (leaf > hi)).any(),
                                  receiver_mod.FLAG_PACK_NARROW_SAT)
            kw[name] = torch.clamp(leaf, lo, hi).to(ndtype)
        else:
            kw[name] = leaf
    kw["flags"] = flags
    return PackedReceiverState(**kw)


def unpack_receiver_state(ps: PackedReceiverState, delay_table,
                          settings: Settings) -> ReceiverState:
    """Packed -> dense, rebuilding ``obs_full`` from every receiver's
    membership in one batched topology build."""
    c = ps.member.shape[0]
    k = ps.ring_order.shape[1]
    kw = {"delay_table": delay_table,
          "epoch": ps.epoch_base + ps.epoch_delta.to(torch.int32)}
    for name in ReceiverState._fields:
        if name in kw or name == "obs_full":
            continue
        leaf = getattr(ps, name)
        if name == "reports":
            kw[name] = unpack_bits(leaf, c).transpose(-1, -2)
        elif name in BIT_FIELDS:
            kw[name] = unpack_bits(leaf, k if name in _K_LAST else c)
        elif name in NARROW_FIELDS:
            kw[name] = leaf.to(torch.int32)
        else:
            kw[name] = leaf
    kw["obs_full"] = build_topology(kw["member"], ps.ring_order,
                                    ps.ring_rank)[1]
    return ReceiverState(**kw)


def bundle_from_dense(rs: ReceiverState,
                      settings: Settings) -> PackedReceiverBundle:
    """Wrap a booted dense state as the packed loop's input."""
    return PackedReceiverBundle(packed=pack_receiver_state(rs, settings),
                                delay_table=rs.delay_table)


def as_bundle(state, settings: Settings) -> PackedReceiverBundle:
    if isinstance(state, PackedReceiverBundle):
        return state
    return bundle_from_dense(state, settings)


def stack_logs(logs) -> ReceiverStepLog:
    """Per-tick logs -> one log with a leading tick axis."""
    return ReceiverStepLog(*[torch.stack(f) for f in zip(*logs)])


#: What the host reads of a packed final: ``receiver_final_view``.
ReceiverFinalView = collections.namedtuple(
    "ReceiverFinalView", ("member", "stopped", "cfg_hi", "cfg_lo", "flags"))


def final_view(ps: PackedReceiverState) -> ReceiverFinalView:
    """The dense ``member``/``stopped`` planes, cfg limbs and flags of a
    packed final (one member or a fleet)."""
    c = ps.member.shape[-2]
    return ReceiverFinalView(member=unpack_bits(ps.member, c),
                             stopped=unpack_bits(ps.stopped, c),
                             cfg_hi=ps.cfg_hi, cfg_lo=ps.cfg_lo,
                             flags=ps.flags)


def dense_state_bytes(capacity: int, settings: Settings) -> int:
    """Exact bytes of one dense carry (``ReceiverState``) in the
    reference's layout: 32-bit limbs at 4 bytes, bools at 1."""
    from rapid_tpu_torch.engine import fleet

    return fleet._state_bytes(capacity, settings)[0]


@functools.lru_cache(maxsize=None)
def packed_state_bytes(capacity: int, settings: Settings) -> int:
    """Exact bytes of one packed carry (``PackedReceiverState``) in the
    reference's layout, from the shapes ``pack_receiver_state`` gives on
    meta tensors."""
    from rapid_tpu_torch.engine import fleet, receiver

    dense = fleet._meta_state(capacity, settings.K, receiver.N_DRAWS,
                              settings.delivery_ring_depth)
    return fleet._tree_bytes(pack_receiver_state(dense, settings))


def bundle_state_bytes(capacity: int, settings: Settings) -> int:
    """Exact per-member bytes of the packed carry plus its delay table,
    in the reference's layout (the count ``fleet.check_receiver_budget``
    gates on)."""
    from rapid_tpu_torch.engine import fleet

    return fleet._state_bytes(capacity, settings)[1]


def _start_tick(shards) -> int:
    """The members' common start tick, each shard's read once."""
    from rapid_tpu_torch.device import read_arrays
    from rapid_tpu_torch.engine import sharding

    ticks = set()
    for dev, (state, _) in zip(shards.devices, shards.shards):
        with sharding.device_context(dev):
            ticks |= set(read_arrays(getattr(state, "packed",
                                             state).tick)[0].tolist())
    if len(ticks) != 1:
        raise ValueError("fleet members must start at one tick")
    return ticks.pop()


def _joined(shards, finals, logs):
    """Each shard's finals and ``[F, T, ...]`` logs joined in member
    order on the first shard's device."""
    from rapid_tpu_torch.engine import sharding

    home = shards.devices[0]
    with span("rapid.fleet.join"):
        return (sharding.join(finals, home),
                sharding.join([ReceiverStepLog(*[torch.stack(col, dim=1)
                                                 for col in zip(*lg)])
                               for lg in logs], home))


def fleet_simulate(bundle, faults, n_ticks: int, settings: Settings,
                   fleet_mesh=None):
    """The tick loop of a stacked fleet (member axis first on every
    leaf): unpack, ``receiver.fleet_step``, repack, once per tick, each
    map batched over the members. Returns the packed finals and the
    logs, member-major ``[F, T, ...]``. ``fleet_mesh`` splits the
    members over its devices (``fleet_run``)."""
    from rapid_tpu_torch.engine import sharding

    ps = bundle.packed
    return fleet_run(sharding.fleet_shards(
        (bundle, faults), fleet_mesh, int(ps.member.shape[0]),
        ps.member.device), n_ticks, settings)


def fleet_run(shards, n_ticks: int, settings: Settings):
    """``fleet_simulate`` over ``sharding.FleetShards`` of ``(bundle,
    faults)``: every shard one tick before the next tick, each under its
    device's context (``sharding.run_shards``), the outputs joined."""
    from rapid_tpu_torch.engine import receiver as receiver_mod
    from rapid_tpu_torch.engine import sharding
    from rapid_tpu_torch.engine.state import member_map

    with span("rapid.fleet.host"):
        t0 = _start_tick(shards)

    def tick(k, ps, i):
        bundle, faults = shards.shards[k]
        rs = member_map(lambda p, d: unpack_receiver_state(p, d, settings),
                        ps, bundle.delay_table)
        nxt, log = receiver_mod.fleet_step(rs, faults, settings, t0 + i)
        return member_map(lambda r: pack_receiver_state(r, settings),
                          nxt), log

    finals, logs = sharding.run_shards(
        shards.devices, [b.packed for b, _ in shards.shards], n_ticks, tick)
    return _joined(shards, finals, logs)


def dense_fleet_simulate(rs, faults, n_ticks: int, settings: Settings,
                         fleet_mesh=None):
    """The tick loop of a stacked fleet on the dense carry (member axis
    first on every leaf): ``receiver.fleet_step`` on the stacked
    ``ReceiverState`` once per tick. Returns the dense finals and the
    logs, member-major ``[F, T, ...]``. ``fleet_mesh`` splits the members
    over its devices (``dense_fleet_run``)."""
    from rapid_tpu_torch.engine import sharding

    return dense_fleet_run(sharding.fleet_shards(
        (rs, faults), fleet_mesh, int(rs.member.shape[0]),
        rs.member.device), n_ticks, settings)


def dense_fleet_run(shards, n_ticks: int, settings: Settings):
    """``dense_fleet_simulate`` over ``sharding.FleetShards`` of
    ``(state, faults)``, advanced in turns as ``fleet_run`` does."""
    from rapid_tpu_torch.engine import receiver as receiver_mod
    from rapid_tpu_torch.engine import sharding

    with span("rapid.fleet.host"):
        t0 = _start_tick(shards)

    def tick(k, rs, i):
        return receiver_mod.fleet_step(rs, shards.shards[k][1], settings,
                                       t0 + i)

    finals, logs = sharding.run_shards(
        shards.devices, [rs for rs, _ in shards.shards], n_ticks, tick)
    return _joined(shards, finals, logs)


def simulate_chunk(bundle, faults, n_ticks: int, settings: Settings,
                   rec=None, donate: bool = True):
    """One streaming chunk over the packed carry: unpack, the dense
    ``receiver_step``, repack, once per tick; bundle in, bundle out.

    Returns ``(PackedReceiverBundle, logs)``, or ``(..., logs, rec)``
    when the recorder window is nonzero, folding into ``rec`` when given.
    The packed state crosses the boundary as it is, epoch-delta base and
    sticky flags included: a dense final repacked on the next entry would
    rebuild the base, and ``FLAG_EPOCH_DELTA_SAT`` could move. Chained
    chunks equal one uninterrupted chunk of the summed length.
    ``donate`` is accepted for the reference's callers; PyTorch has no
    donation (``step.simulate_chunk``)."""
    from rapid_tpu_torch.engine import receiver as receiver_mod
    from rapid_tpu_torch.engine import recorder

    del donate
    bundle = as_bundle(bundle, settings)
    ps, delay_table = bundle.packed, bundle.delay_table
    t0 = int(ps.tick)
    logs = []
    for i in range(int(n_ticks)):
        rs = unpack_receiver_state(ps, delay_table, settings)
        nxt, log = receiver_mod.receiver_step(rs, faults, settings,
                                              tick=t0 + i)
        ps = pack_receiver_state(nxt, settings)
        logs.append(log)
    logs = stack_logs(logs)
    out = PackedReceiverBundle(packed=ps, delay_table=delay_table)
    if settings.flight_recorder_window:
        if rec is None:
            rec = recorder.init(settings, device=logs.tick.device)
        return out, logs, recorder.record_receiver_run(rec, logs, settings)
    return out, logs
