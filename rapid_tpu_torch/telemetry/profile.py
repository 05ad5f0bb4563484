"""Per-kernel cost observatory: where does a tick's work go, sub-kernel
by sub-kernel?

The port's own copy of the reference's ``telemetry.profile``: each
sub-kernel of the shared engine's tick (topology rebuild, failure-detector
monitor, cut delivery and aggregation, fast-round vote count, the four
classic-Paxos phases) and the composed step are run *separately* on a
mid-protocol snapshot, at each N of a sweep, and ``dominance_report``
emits the ``kernel_profile_sweep`` payload of the reference: the costs per
kernel and N, the wall-clock-dominant kernel per N, the per-receiver fleet
step's memory block and the ring-variant block. (``rapid_tpu_torch.profile``
is another tool: ``torch.profiler`` windows over whole ticks.)

    python -m rapid_tpu_torch.telemetry.profile --sizes 256 1000 10000 \\
        100000 --variant-sizes 4096 1000000 --out report.json
    python -m rapid_tpu_torch.telemetry.profile --device cpu --sizes 256 \\
        --no-receiver-memory

Entry points run on the card (``device="cuda"``) unless asked for the CPU,
and raise without a card. The reference AOT-compiles each kernel and reads
XLA's analyses; the port has no compiler in between, so each figure of a
``KernelCost`` comes from the eager program:

- ``compile_s`` is the wall of the first call, which pays what is done
  once: the boot caches and, in a fresh process, the delivery kernel's
  build at its first launch. One untimed call follows, under the card's
  allocator: ``peak_bytes`` is the argument bytes resident on the card
  plus ``max_memory_allocated`` during that call less
  ``memory_allocated`` before it, and ``temp_bytes`` is what the peak
  holds beyond the arguments and results. On the CPU no card memory is
  in use, so both read 0, the reference's "not measured".
- ``wall_median_s`` and ``wall_best_s`` time ``repeats`` calls on the host
  clock, each ending in ``torch.cuda.synchronize()`` (the counterpart of
  ``jax.block_until_ready``): a host-bound kernel shows as host-bound.
- ``flops`` and ``bytes_accessed`` are the eager program's own count, not
  XLA's: one more untimed call runs under a ``TorchDispatchMode`` that
  counts, for each aten op, ``2·M·N·K`` for a matmul
  (``torch.utils.flop_counter``'s formulas; the integer einsums run as
  float32 matmuls) and the element count of its largest output for any
  other op, and the bytes of every tensor input and output. Eager ops
  are not fused, so the bytes come out above XLA's. The hand-written
  delivery kernel is not an aten op: its work is not in the count.
- ``argument_bytes`` and ``output_bytes`` are the reference's count, as
  XLA's ``memory_analysis`` gives it: tensor leaves in the reference's
  dtypes (no reference array is wider than 32 bits: the port's int64
  limbs count 4 bytes), the arguments the call reads or returns (XLA
  drops a parameter nothing uses), and the results plus an 8-byte table
  entry each when there are several (XLA's result tuple).

The profiled state is a mid-protocol snapshot (a seeded crash burst warmed
up a few ticks), so the kernels see realistic occupancy.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from rapid_tpu_torch.device import read_arrays, resolve_device
from rapid_tpu_torch.telemetry.schema import SCHEMA_VERSION

#: Kernel names in report order; ``full_step`` is the composed reference
#: and never picked as dominant.
KERNEL_ORDER = (
    "topology_rebuild",
    "monitor",
    "cut_aggregate",
    "vote_count",
    "paxos_chain_deliver",
    "paxos_fast_tally",
    "paxos_phase1a_deliver",
    "paxos_task_phase",
    "full_step",
)

#: Bytes of one entry of XLA's result tuple, which its ``memory_analysis``
#: counts in ``output_size_in_bytes`` when a call has several results.
RESULT_TABLE_ENTRY_BYTES = 8


@dataclass(frozen=True)
class KernelCost:
    """One kernel's counted and measured cost at one N."""

    kernel: str
    flops: float
    bytes_accessed: float
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    peak_bytes: int
    compile_s: float
    wall_median_s: float
    wall_best_s: float
    repeats: int

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def synthetic_state(n: int, settings, seed: int = 0,
                    warmup_ticks: int = 8, crash_frac: float = 0.01,
                    crash_tick: int = 5, device="cuda"):
    """A mid-protocol ``(state, faults)`` pair at size ``n`` on ``device``.

    The reference's synthetic identities (``identity.synthetic_uids``); a
    crash slot every ``n // n_crash`` at ``crash_tick`` plus
    ``warmup_ticks`` of ``step.simulate`` leave the monitor counters, the
    alert pipeline and the cut detector occupied.
    """
    from rapid_tpu_torch.engine.state import I32_MAX, crash_faults, init_state
    from rapid_tpu_torch.engine.step import simulate
    from rapid_tpu_torch.identity import synthetic_uids

    dev = resolve_device(device)
    state = init_state(synthetic_uids(n, seed).tolist(), id_fp_sum=0,
                       settings=settings, device=dev)
    n_crash = max(1, int(n * crash_frac))
    crash_ticks = [I32_MAX] * n
    for slot in range(0, n, max(1, n // n_crash)):
        crash_ticks[slot] = crash_tick
    faults = crash_faults(crash_ticks, device=dev)
    if warmup_ticks > 0:
        state, _ = simulate(state, faults, warmup_ticks, settings,
                            device=dev)
    _synchronize(dev)
    return state, faults


def kernel_cases(state, faults, settings, fallback=None,
                 mesh=None) -> List[Tuple]:
    """``(name, fn, args)`` for each separately run sub-kernel.

    The closures make the port's step's own calls (``engine/step.py``),
    with its operand shapes and derived values. What the step keeps on
    the host (the tick, the epoch, the schedule row, the tick's member
    count) is read once here, so no call reads the card more often than
    the step does at that point. Each Paxos phase runs in full, as the
    reference's closure runs it; the composed step skips a phase on a
    tick where its host knows the phase does nothing, so the sub-kernels
    can add up to more than ``full_step``. ``fallback`` is a
    ``paxos.FallbackSchedule`` of tensors on the state's device; its
    instance must be live at the state's epoch.

    ``mesh`` is a slot mesh. On one device the state lies there. On
    ``D`` devices the inputs are split over it (or given as
    ``sharding.SlotShards``), each case's one argument is the
    ``SlotShards`` of its inputs, and its function runs the sub-kernel on
    every shard with the shard's ``SlotGroup`` (``sharding.run_spmd``),
    as the step calls it there, and joins the outputs on the mesh's first
    device; ``full_step`` is ``step.step`` on the mesh. Each sub-kernel
    is written once, as ``fn(group, ...)``: without a split it runs with
    ``sharding.SOLO`` on the inputs themselves.
    """
    from rapid_tpu_torch.engine import (cut, monitor, paxos, sharding,
                                        step, votes)
    from rapid_tpu_torch.engine import state as state_mod
    from rapid_tpu_torch.engine.topology import rebuild

    trees, parts = (state, faults, fallback), None
    if step._split(mesh):
        cap = (state.capacity if isinstance(state, sharding.SlotShards)
               else int(state.member.shape[0]))
        trees = tuple(sharding.slot_shards(x, mesh, cap) for x in trees)
        parts = sharding.shard_tuple(trees, mesh, cap)
        home = parts.devices[0]
        n = sum(sh[0].member.sum().to(home) for sh in parts.shards)
        counts = [n.to(torch.int32).to(dev) for dev in parts.devices]
        first = parts.shards[0]
    else:
        step.require_scope(mesh)
        counts = [state.member.sum().to(torch.int32)]
        first = trees
    t_now, epoch = (int(v) for v in read_arrays(first[0].tick,
                                                first[0].epoch))
    t = t_now + 1
    members = lambda g: counts[g.rank]  # the tick's member count

    def case(name, fn, pick):
        """``(name, run, args)`` for sub-kernel ``fn(group, *inputs)``,
        its inputs picked from each shard's ``(state, faults,
        fallback)``."""
        if parts is None:
            return name, lambda *a: fn(sharding.SOLO, *a), pick(*trees)
        args = sharding.SlotShards(tuple(pick(*sh) for sh in parts.shards),
                                   parts.devices, parts.capacity)

        def run(shards):
            out = sharding.run_spmd(lambda g, sh: fn(g, *sh), shards)
            return state_mod.join_slots(out, shards.devices[0])
        return name, run, (args,)

    def topology_rebuild(g, member, ring_order, ring_rank):
        return rebuild(member, ring_order, ring_rank, g)

    def monitor_kernel(g, state, faults):
        return monitor.monitor_tick(
            state, state_mod.gather_slots(faults, g), settings, t_now, g)

    def cut_aggregate(g, state, faults):
        src_alive = ~monitor.crashed_at(
            state_mod.gather_slots(faults, g), t)
        n_alive = g.sum((state.member & g.local(src_alive)).sum()).to(
            torch.int32)
        return cut.aggregate(state, cut.deliver_reports(state, src_alive, g),
                             None, n_alive > 0, settings, g)

    def vote_count(g, state, faults):
        c = state.member.shape[0]
        valid = state.voters & ~monitor.crashed_at(faults, t) \
            & state.vote_pending
        return votes.count_fast_round(state.phash_hi.expand(c),
                                      state.phash_lo.expand(c), valid,
                                      members(g), g)

    state_faults = lambda s, f, _: (s, f)
    cases = [
        case("topology_rebuild", topology_rebuild,
             lambda s, *_: (s.member, s.ring_order, s.ring_rank)),
        case("monitor", monitor_kernel, state_faults),
        case("cut_aggregate", cut_aggregate, state_faults),
        case("vote_count", vote_count, state_faults),
    ]
    if fallback is None:
        def full_step(state, faults):
            return step.step(state, faults, settings, mesh=mesh,
                             tick=t_now)

        return cases + [("full_step", full_step, trees[:2])]

    e, live = paxos.instance_row(read_arrays(first[2].inst_epoch)[0], epoch)
    if not live:
        raise ValueError(f"the fallback schedule has no live instance at "
                         f"epoch {epoch}")

    def paxos_chain_deliver(g, state, sched):
        return paxos.chain_deliver(state, sched, t, members(g), g)

    def paxos_fast_tally(g, state, sched):
        return paxos.fast_tally(state, sched, e, t, members(g), g)

    def paxos_phase1a_deliver(g, state, sched):
        return paxos.phase1a_deliver(state, t, g)

    def paxos_task_phase(g, state, sched):
        return paxos.task_phase(state, sched, e, t, members(g), True, True,
                                g)

    def full_step(state, faults, sched):
        return step.step(state, faults, settings, None, sched, mesh,
                         tick=t_now)

    state_sched = lambda s, _, fb: (s, fb)
    return cases + [
        case("paxos_chain_deliver", paxos_chain_deliver, state_sched),
        case("paxos_fast_tally", paxos_fast_tally, state_sched),
        case("paxos_phase1a_deliver", paxos_phase1a_deliver, state_sched),
        case("paxos_task_phase", paxos_task_phase, state_sched),
        ("full_step", full_step, trees),
    ]


# ---------------------------------------------------------------------------
# measurement
# ---------------------------------------------------------------------------


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _device_of(args) -> torch.device:
    return _tensors(args)[0].device


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _reference_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t`` in the reference's dtype: JAX runs without 64-bit
    types, so the port's int64 limbs are its uint32."""
    return t.numel() * min(t.element_size(), 4)


class OpCount(TorchDispatchMode):
    """Counts what the aten ops of a call do: ``ops``, ``flops`` (matmuls
    by ``torch.utils.flop_counter``'s formulas, any other op the elements
    of its largest output), ``bytes`` (every tensor input and output) and
    ``read``, the storages the ops took as inputs."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.flops = 0
        self.bytes = 0
        self.read = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        formula = flop_registry.get(func.overloadpacket)
        self.ops += 1
        self.flops += (formula(*args, **kwargs, out_val=out) if formula
                       else max((o.numel() for o in outs), default=0))
        self.bytes += sum(x.numel() * x.element_size() for x in ins + outs)
        self.read.update(_storage(x) for x in ins)
        return out


def count_ops(fn, args) -> Tuple[OpCount, object]:
    """One untimed ``fn(*args)`` under ``OpCount``: the count and the
    result."""
    with OpCount() as count:
        out = fn(*args)
    return count, out


def _io_bytes(args, out, count: OpCount) -> Tuple[int, int]:
    """``(argument_bytes, output_bytes)`` as XLA's ``memory_analysis``
    counts them (module docstring)."""
    outs = _tensors(out)
    used = count.read | {_storage(o) for o in outs}
    arg_bytes = sum(_reference_bytes(a) for a in _tensors(args)
                    if _storage(a) in used)
    table = RESULT_TABLE_ENTRY_BYTES * len(outs) if len(outs) > 1 else 0
    return arg_bytes, sum(_reference_bytes(o) for o in outs) + table


def _card_peak(fn, args, dev: torch.device) -> int:
    """Bytes ``fn(*args)`` holds on the card at its peak: the arguments
    resident there plus what the allocator's peak rose by during the
    call. A CPU run has nothing on the card and reads 0."""
    cuda = dev.type == "cuda"
    seen, resident = set(), 0
    for a in _tensors(args):
        if a.device.type == "cuda" and _storage(a) not in seen:
            seen.add(_storage(a))
            resident += a.untyped_storage().nbytes()
    _synchronize(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev) if cuda else 0
    if before < resident:
        raise RuntimeError(f"the card's allocator reads {before} bytes "
                           f"allocated, below the {resident} bytes of "
                           f"arguments resident on {dev}")
    fn(*args)
    _synchronize(dev)
    during = torch.cuda.max_memory_allocated(dev) if cuda else 0
    return resident + during - before


def _run(fn, args, repeats: int) -> Dict[str, object]:
    """Run ``fn(*args)``: the first call (its wall is ``compile_s``), one
    call under the card's allocator, ``repeats`` timed calls and one
    counting call (module docstring)."""
    dev = _device_of(args)
    _synchronize(dev)
    t0 = time.perf_counter()
    fn(*args)
    _synchronize(dev)
    compile_s = time.perf_counter() - t0
    peak = _card_peak(fn, args, dev)
    times: List[float] = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn(*args)
        _synchronize(dev)
        times.append(time.perf_counter() - t0)
    count, out = count_ops(fn, args)
    arg_bytes, out_bytes = _io_bytes(args, out, count)
    return {"count": count, "times": times, "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": max(0, peak - arg_bytes - out_bytes),
            "peak_bytes": peak, "compile_s": round(compile_s, 6)}


def measure_kernel(name: str, fn, args, repeats: int = 5) -> KernelCost:
    """Run one kernel and give its ``KernelCost``."""
    r = _run(fn, args, max(1, repeats))
    times = r["times"]
    return KernelCost(
        kernel=name,
        flops=float(r["count"].flops),
        bytes_accessed=float(r["count"].bytes),
        argument_bytes=r["argument_bytes"],
        output_bytes=r["output_bytes"],
        temp_bytes=r["temp_bytes"],
        peak_bytes=r["peak_bytes"],
        compile_s=r["compile_s"],
        wall_median_s=round(statistics.median(times), 9),
        wall_best_s=round(min(times), 9),
        repeats=len(times),
    )


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------


def profile_kernels(n: int, settings, repeats: int = 5, seed: int = 0,
                    warmup_ticks: int = 8, include_fallback: bool = True,
                    device="cuda") -> Dict[str, object]:
    """Profile every sub-kernel at size ``n``; returns one report entry."""
    from rapid_tpu_torch.convert import from_reference
    from rapid_tpu_torch.engine.paxos import empty_fallback_schedule

    state, faults = synthetic_state(n, settings, seed=seed,
                                    warmup_ticks=warmup_ticks, device=device)
    c = int(state.member.shape[0])
    fallback = from_reference(empty_fallback_schedule(c),
                              state.member.device) \
        if include_fallback else None
    costs = [measure_kernel(name, fn, args, repeats=repeats)
             for name, fn, args in kernel_cases(state, faults, settings,
                                                fallback)]
    sub = [k for k in costs if k.kernel != "full_step"]
    dominant = {
        "wall_clock": max(sub, key=lambda k: k.wall_median_s).kernel,
        "flops": max(sub, key=lambda k: k.flops).kernel,
        "bytes": max(sub, key=lambda k: k.bytes_accessed).kernel,
    }
    full = next(k for k in costs if k.kernel == "full_step")
    sub_wall = sum(k.wall_median_s for k in sub)
    return {
        "n": n,
        "capacity": c,
        "warmup_ticks": warmup_ticks,
        "kernels": [k.as_dict() for k in costs],
        "dominant": dominant,
        # How much of the composed step the sub-kernels account for.
        "subkernel_wall_fraction": round(
            sub_wall / full.wall_median_s, 3) if full.wall_median_s else None,
    }


#: Kernels the reference's multichip block compares sharded against one
#: device.
MULTICHIP_KERNELS = ("cut_aggregate", "vote_count", "full_step")


def multichip_comparison(sizes: Sequence[int], settings,
                         n_devices: int = 8, repeats: int = 5,
                         seed: int = 0, warmup_ticks: int = 8,
                         devices=None,
                         device="cuda") -> Optional[Dict[str, object]]:
    """Sharded-vs-single-device wall clock for ``MULTICHIP_KERNELS``, the
    reference's block: per size, each kernel once on the synthetic state
    on one device and once with the state and faults ``shard_put`` on a
    slot mesh (``kernel_cases`` on the mesh), both medians and the
    speedup. Sizes whose capacity does not divide the mesh are skipped:
    the sharder would replicate them.

    The mesh is ``devices`` when given (a device may repeat: four shards
    on one card), else ``n_devices`` visible cards; with fewer cards than
    that the block is ``None``, as the reference answers with too few
    devices (the payload records the absence)."""
    from rapid_tpu_torch.engine import sharding

    if devices is None:
        if torch.cuda.device_count() < n_devices:
            return None
        mesh = sharding.slot_mesh(n_devices, device=device)
    else:
        mesh = sharding.slot_mesh(devices=devices)
    n_dev = sharding.mesh_size(mesh)
    entries: List[Dict[str, object]] = []
    for n in sizes:
        state, faults = synthetic_state(n, settings, seed=seed,
                                        warmup_ticks=warmup_ticks,
                                        device=mesh.devices[0])
        c = int(state.member.shape[0])
        if c % n_dev:
            continue
        plain = {name: (fn, args) for name, fn, args
                 in kernel_cases(state, faults, settings)}
        s_state = sharding.shard_put(state, mesh, c)
        s_faults = sharding.shard_put(faults, mesh, c)
        sharded = {name: (fn, args) for name, fn, args
                   in kernel_cases(s_state, s_faults, settings, mesh=mesh)}
        for kname in MULTICHIP_KERNELS:
            base = measure_kernel(kname, *plain[kname], repeats=repeats)
            shrd = measure_kernel(kname, *sharded[kname], repeats=repeats)
            entries.append({
                "kernel": kname,
                "n": n,
                "single_wall_median_s": base.wall_median_s,
                "sharded_wall_median_s": shrd.wall_median_s,
                "speedup": round(
                    base.wall_median_s / shrd.wall_median_s, 3)
                if shrd.wall_median_s else None,
            })
    return {"n_devices": n_dev, "axis": sharding.AXIS, "kernels": entries}


def receiver_fleet_ticks(settings, n: int = 64,
                         fleet_sizes: Sequence[int] = (4, 64), seed: int = 0,
                         device="cuda"):
    """``(fleet_size, layout, fn, args)`` per fleet size and layout
    ("dense", then "packed"): a one-tick run of a per-receiver fleet of
    ``F`` copies of a partition member (a draw of
    ``sample_adversary_schedule`` with the partition weight alone of the
    crash family, lowered by ``lower_receiver_schedule``), through
    ``rx_packed.dense_fleet_simulate`` on the dense carry and
    ``rx_packed.fleet_simulate`` (unpack, ``fleet_step``, repack) on the
    packed one. Each reads the members' tick once, as a run does, and
    launches the delivery kernel 6 times over the member axis."""
    from rapid_tpu_torch.engine import rx_packed
    from rapid_tpu_torch.engine.fleet import (lower_receiver_schedule,
                                              stack_receiver_members)
    from rapid_tpu_torch.engine.state import member_map
    from rapid_tpu_torch.faults import ScenarioWeights, \
        sample_adversary_schedule

    dev = resolve_device(device)
    dense_settings, packed_settings = _layout_settings(settings)
    weights = ScenarioWeights(crash=0.0, partition=1.0, flip_flop=0.0,
                              contested=0.0, churn=0.0)
    sc = sample_adversary_schedule(n, seed, 8 * settings.fd_interval_ticks,
                                   weights)
    member = lower_receiver_schedule(sc.schedule, dense_settings,
                                     fleet_size=max(fleet_sizes), device=dev)

    def dense_tick(state, faults):
        return rx_packed.dense_fleet_simulate(state, faults, 1,
                                              dense_settings)

    def packed_tick(bundle, faults):
        return rx_packed.fleet_simulate(bundle, faults, 1, packed_settings)

    for f in fleet_sizes:
        fleet = stack_receiver_members([member] * f)
        yield f, "dense", dense_tick, (fleet.state, fleet.faults)
        packed = member_map(lambda rs: rx_packed.pack_receiver_state(
            rs, packed_settings), fleet.state)
        bundle = rx_packed.PackedReceiverBundle(
            packed=packed, delay_table=fleet.state.delay_table)
        yield f, "packed", packed_tick, (bundle, fleet.faults)


def _layout_settings(settings):
    """``(dense, packed)``: ``settings`` under ``rx_kernel`` "xla" and
    under a packed layout, the one it names if it names one."""
    dense = settings if settings.rx_kernel == "xla" \
        else settings.with_(rx_kernel="xla")
    packed = settings if settings.rx_kernel != "xla" \
        else settings.with_(rx_kernel="packed")
    return dense, packed


def receiver_memory_block(settings, n: int = 64,
                          fleet_sizes: Sequence[int] = (4, 64),
                          seed: int = 0, device="cuda") -> Dict[str, object]:
    """Memory footprint of the per-receiver fleet step, dense and packed.

    Runs the fleet ticks of ``receiver_fleet_ticks``: the first call of
    each gives ``compile_s``, one more the allocator's peak
    (``temp_bytes``, ``peak_bytes``), one more the reference's
    ``argument_bytes`` and ``output_bytes`` (module docstring).
    ``member_state_bytes`` is the per-member dense figure
    (``receiver.receiver_state_bytes``) the argument bytes F-multiply,
    ``member_state_bytes_packed`` the packed bundle's, and
    ``bytes_per_member_curve`` counts both layouts at campaign
    capacities from their shapes alone.
    """
    from rapid_tpu_torch.engine import receiver, rx_packed

    dense_settings, packed_settings = _layout_settings(settings)
    fleets: Dict[str, List[Dict[str, object]]] = {"dense": [], "packed": []}
    c = None
    for f, layout, fn, args in receiver_fleet_ticks(settings, n, fleet_sizes,
                                                    seed, device):
        c = int(args[1].crash_tick.shape[-1])
        r = _run(fn, args, 0)
        fleets[layout].append({"fleet_size": f, **{
            key: r[key] for key in ("argument_bytes", "output_bytes",
                                    "temp_bytes", "peak_bytes",
                                    "compile_s")}})
    curve: List[Dict[str, object]] = []
    for cc in (64, 256, 1024, 4096):
        dense_b = rx_packed.dense_state_bytes(cc, dense_settings)
        packed_b = rx_packed.packed_state_bytes(cc, packed_settings)
        bundle_b = rx_packed.bundle_state_bytes(cc, packed_settings)
        curve.append({
            "capacity": cc,
            "dense_bytes": dense_b,
            "packed_carry_bytes": packed_b,
            "packed_bundle_bytes": bundle_b,
            "carry_reduction": round(dense_b / packed_b, 2),
            "bundle_reduction": round(dense_b / bundle_b, 2),
        })
    return {
        "n": n,
        "capacity": c,
        "k": settings.K,
        "member_state_bytes": receiver.receiver_state_bytes(
            c, settings.K, ring_depth=settings.delivery_ring_depth),
        "member_state_bytes_packed": rx_packed.bundle_state_bytes(
            c, packed_settings),
        "fleets": fleets["dense"],
        "packed_fleets": fleets["packed"],
        "bytes_per_member_curve": curve,
    }


#: Working-set budget of the protocol-variant block (bytes): sizes whose
#: dense O(N^2) broadcast would exceed it are recorded as refusals and
#: never attempted.
VARIANT_BUDGET_BYTES = 2 << 30


def variant_sweep_block(settings, sizes: Sequence[int],
                        repeats: int = 3, seed: int = 0,
                        budget_bytes: int = VARIANT_BUDGET_BYTES,
                        device="cuda") -> Dict[str, object]:
    """The ring variant's aggregation kernel against the dense broadcast,
    per size, on the reference's draws (``default_rng(seed ^ n)``: a pool
    of 4 fingerprints, 95 % of slots valid, one ring permutation).

    ``ring_aggregate`` is ``votes.scan_vote_count`` under the permutation
    and its inverse: O(C) state, so it runs at a million slots.
    ``dense_broadcast`` builds the ``[C, C]`` pairwise delivery matrix;
    where its ``C^2`` bytes exceed ``budget_bytes`` the size lands in
    ``refusals`` with the reference's reason and is never run.
    """
    from rapid_tpu_torch.engine import votes

    dev = resolve_device(device)
    kernels: List[Dict[str, object]] = []
    refusals: List[Dict[str, object]] = []
    for n in sizes:
        rng = np.random.default_rng(seed ^ n)
        pool = rng.integers(0, 2**64, 4, dtype=np.uint64)
        fps = pool[rng.integers(0, len(pool), n)]
        put = lambda a: torch.from_numpy(a).to(dev)
        hi = put((fps >> np.uint64(32)).astype(np.int64))
        lo = put((fps & np.uint64(0xFFFFFFFF)).astype(np.int64))
        valid = put(rng.random(n) < 0.95)
        perm_np = rng.permutation(n).astype(np.int32)
        perm = put(perm_np)
        inv = put(np.argsort(perm_np).astype(np.int32))

        def ring_aggregate(hi, lo, valid, perm, inv):
            p = perm.long()
            counts = votes.scan_vote_count(hi[p], lo[p], valid[p])[inv.long()]
            return counts.max(), valid.sum().to(torch.int32)

        kc = measure_kernel("ring_aggregate", ring_aggregate,
                            (hi, lo, valid, perm, inv), repeats=repeats)
        kernels.append({**kc.as_dict(), "n": n})

        dense_bytes = n * n  # the [C, C] bool delivery matrix
        if dense_bytes > budget_bytes:
            refusals.append({
                "kernel": "dense_broadcast",
                "n": n,
                "bytes_required": dense_bytes,
                "budget_bytes": budget_bytes,
                "reason": (f"[C, C] pairwise delivery matrix needs "
                           f"{dense_bytes} bytes at C={n}, over the "
                           f"{budget_bytes}-byte budget — the dense "
                           f"reference cannot run at this size"),
            })
            continue

        def dense_broadcast(hi, valid):
            seen = valid[:, None] & valid[None, :]
            return (seen.sum(dim=0, dtype=torch.int32).max(),
                    valid.sum().to(torch.int32))

        kc = measure_kernel("dense_broadcast", dense_broadcast,
                            (hi, valid), repeats=repeats)
        kernels.append({**kc.as_dict(), "n": n})
    return {"sizes": list(sizes), "budget_bytes": budget_bytes,
            "kernels": kernels, "refusals": refusals}


def dominance_report(sizes: Sequence[int], settings, repeats: int = 5,
                     seed: int = 0, warmup_ticks: int = 8,
                     include_fallback: bool = True,
                     multichip: bool = True,
                     multichip_devices: int = 8,
                     receiver_memory: bool = True,
                     receiver_n: int = 64,
                     variant_sizes: Optional[Sequence[int]] = None,
                     device="cuda") -> Dict[str, object]:
    """The ``kernel_profile_sweep`` payload on ``device``: per-N kernel
    costs and the wall-clock-dominant kernel per N, the ``multichip``,
    ``receiver_memory`` and ``variants`` blocks, each ``null`` when
    skipped or not measured, as in the reference."""
    dev = resolve_device(device)
    runs = [profile_kernels(n, settings, repeats=repeats, seed=seed,
                            warmup_ticks=warmup_ticks,
                            include_fallback=include_fallback, device=dev)
            for n in sizes]
    return {
        "bench": "kernel_profile_sweep",
        "schema_version": SCHEMA_VERSION,
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "k": settings.K,
        "sizes": list(sizes),
        "runs": runs,
        "dominant_by_n": {str(r["n"]): r["dominant"]["wall_clock"]
                          for r in runs},
        "multichip": multichip_comparison(
            sizes, settings, n_devices=multichip_devices, repeats=repeats,
            seed=seed, warmup_ticks=warmup_ticks,
            device=dev) if multichip else None,
        "receiver_memory": receiver_memory_block(
            settings, n=receiver_n, seed=seed, device=dev)
        if receiver_memory else None,
        "variants": variant_sweep_block(
            settings, variant_sizes, seed=seed, device=dev)
        if variant_sizes else None,
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sizes", type=int, nargs="+",
                        default=[1_000, 10_000, 100_000],
                        help="cluster sizes to sweep (default 1k 10k 100k)")
    parser.add_argument("--repeats", type=int, default=5,
                        help="timed calls per kernel (default 5)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--warmup-ticks", type=int, default=8,
                        help="simulated ticks before snapshotting the "
                             "profiled state (default 8)")
    parser.add_argument("--no-fallback", action="store_true",
                        help="skip the classic-Paxos phase kernels")
    parser.add_argument("--no-multichip", action="store_true",
                        help="skip the sharded-vs-single-device block")
    parser.add_argument("--no-receiver-memory", action="store_true",
                        help="skip the per-receiver fleet memory block")
    parser.add_argument("--receiver-n", type=int, default=64,
                        help="cluster size for the per-receiver memory "
                             "block (default 64)")
    parser.add_argument("--multichip-devices", type=int, default=8,
                        help="mesh width for the multichip block "
                             "(default 8; with fewer CUDA devices the "
                             "block is null)")
    parser.add_argument("--variant-sizes", type=int, nargs="+",
                        default=None, metavar="N",
                        help="also profile the ring-variant aggregation "
                             "kernel vs the dense broadcast at these "
                             "sizes; dense sizes over the memory budget "
                             "are recorded as refusals, never attempted "
                             "(default: skip the block)")
    parser.add_argument("--merge-multichip", type=str, default=None,
                        metavar="REPORT",
                        help="take the multichip block from an existing "
                             "report instead of measuring it here")
    parser.add_argument("--out", type=str, default=None,
                        help="write the report JSON to FILE "
                             "(default: stdout)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; 'cpu' runs the "
                             "plain PyTorch path)")
    args = parser.parse_args(argv)

    from rapid_tpu_torch.settings import Settings

    report = dominance_report(args.sizes, Settings(), repeats=args.repeats,
                              seed=args.seed,
                              warmup_ticks=args.warmup_ticks,
                              include_fallback=not args.no_fallback,
                              multichip=(not args.no_multichip
                                         and args.merge_multichip is None),
                              multichip_devices=args.multichip_devices,
                              receiver_memory=not args.no_receiver_memory,
                              receiver_n=args.receiver_n,
                              variant_sizes=args.variant_sizes,
                              device=args.device)
    if args.merge_multichip is not None:
        with open(args.merge_multichip) as fh:
            report["multichip"] = json.load(fh).get("multichip")
    if args.out:
        from rapid_tpu_torch.telemetry import write_json_artifact

        write_json_artifact(args.out, report, indent=2)
    else:
        sys.stdout.write(json.dumps(report) + "\n")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
