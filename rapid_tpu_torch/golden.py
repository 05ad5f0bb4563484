"""The committed golden runs that hold the card to the reference.

``testdata/rx_n64_golden.json`` records the reference's per-receiver
engine on ``faults.crash_window_delay_schedule(64)`` over 160 ticks:
per-tick counters and phase counters, per-slot events and final config
ids; ``testdata/rx_n{64,1024}_recorder.json`` the same at N=64 and
N=1024 with a flight recorder (``RX_RECORDERS``; 32 and 64 rows, so the
ring wraps). ``testdata/shared_*.json``
record the reference's shared engine on the ``SHARED`` and ``OPTIONS``
scenarios: events, every per-tick scalar of ``StepLog``, the expanded
counters, the final config id, a SHA-256 of every final-state field and,
where the scenario has them, the recorder's rows and stamps and the churn
planner's prediction. ``SHARED`` are crash bursts, probe drop with a
flip-flop window, sustained churn and contested consensus, each in the
shape ``benchmarks/bench_engine.py`` gives it; ``OPTIONS`` the ring and
hier variants, the recorder, and churn planned by ``churn.plan_churn``.
``testdata/fleet_pool{0,1,2,3}.json`` (``FLEET_POOLS``) record the
reference's fleets of the first 256 members of each pool of a campaign
of ``benchmarks/campaign_4096.json``'s shape (``FLEET_CAMPAIGN``):
shared crash and churn members, shared contested members, per-receiver
latency members, per-receiver partition and flip-flop members; each
member's schedule, events, config ids and log and final digests, the
shared pools' recorders, and per field a digest over all members
(``pool_record``). A planned scenario's node ids depend on ``PYTHONHASHSEED``
(``oracle.cluster.default_rng``): its file records the seed it was made
under (``PLAN_HASH_SEED``), and a run compared with it must use the same.
``testdata/telemetry_golden.json`` (``TELEMETRY_PATH``) records the
reference's telemetry folds of runs the other files hold: ``summarize``
of ``engine_metrics``, the lineage spans (``comparable``) and their
``lineage_summary`` of three ``SHARED`` runs (from the file's ``log``
columns), ``lineage_from_recorder`` of the N=1024 receiver recorder, and
``fleet_summaries``/``merge_summaries``/``summary_distributions`` with
the members' spans of fleet pools 0 and 2; each with the verdict of the
schema's validators (``telemetry_record``).
``testdata/checkpoints/`` holds one checkpoint of each family written by
the reference's ``save_checkpoint`` (``write_checkpoint``) and
``continuations.json`` its uninterrupted run on from each, two chunks
with a save and load between (``continue_checkpoint``);
``testdata/stream_n100k.json`` the reference's resident shared engine at
N=100,000 and ``testdata/stream_servo.json`` its pinned load servo
stream (``stream_record``), run through ``PortService`` or its reference
twin in the tests, so both packages run the same service code here.
CPU tests regenerate the files from the reference and hold the port's CPU
runs to them; ``chip_smoke.py`` compares the port's runs on the card
against them. ``profile_sweep_errors`` holds a kernel-cost dominance
report (``telemetry.profile``) to ``benchmarks/dominance_report.json``
by the rules of ``scripts/bench_compare.py``.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, NamedTuple, Tuple

import numpy as np

from rapid_tpu_torch.faults import LinkWindow

TESTDATA = Path(__file__).resolve().parent / "testdata"
GOLDEN_PATH = TESTDATA / "rx_n64_golden.json"
GOLDEN_N = 64
GOLDEN_TICKS = 160
SHARED_TICKS = 160
PLAN_BURST = 16         # slots per planned join or leave burst
PLAN_HASH_SEED = "0"    # the PYTHONHASHSEED planned scenarios are made under
I32_MAX = (1 << 31) - 1


class RxRecorderRun(NamedTuple):
    """The per-receiver engine on ``faults.crash_window_delay_schedule(n)``
    over ``GOLDEN_TICKS`` ticks with a ``window``-row flight recorder."""

    n: int
    window: int

    @property
    def path(self) -> Path:
        return TESTDATA / f"rx_n{self.n}_recorder.json"


#: The receiver recorder runs: N=64 for the CPU tests, N=1024 for the card.
RX_RECORDERS = (RxRecorderRun(64, 32), RxRecorderRun(1024, 64))


class SharedBoot(NamedTuple):
    """A scenario's boot on a device: what ``simulate`` takes, and the
    host seconds that building the schedule and ``init_state`` took."""

    state: object
    faults: object
    churn: object           # a ChurnSchedule of tensors, or None
    fallback: object        # a FallbackSchedule of tensors, or None
    setup_s: float
    plan: object = None     # the churn.ChurnPlan of a planned scenario
    plan_s: float = 0.0     # host seconds of plan_churn (in setup_s)


@dataclass(frozen=True)
class SharedScenario:
    """One shared-engine run: ``n`` slots with ``synthetic_uids`` and
    identifier sum 0, default ``Settings()``. Slots
    ``range(0, n, crash_every)`` crash at ``crash_tick`` (none when
    ``crash_every`` is 0); ``drop_p``/``drop_seed`` drop probes;
    ``flip_flop`` adds one one-way window from the first ``n // 100``
    slots to the rest, from tick 20, flipping every 20 ticks.

    ``churn_burst`` > 0 is ``bench_engine.run_churn``: ``capacity``
    slots, members ``[0, n)``, and ``churn.synthetic_churn_schedule``'s
    alternating join and leave bursts of that many slots from tick 10.
    ``contested`` is ``bench_engine.run_contested``:
    ``paxos.synthetic_contested_schedule`` over the run's ticks.

    ``join_bursts``/``leave_bursts`` plan churn with ``churn.plan_churn``
    over ``ticks`` ticks, in the churn differentials' identity universe
    (``identity.default_endpoints``/``default_node_ids``): burst ``i``
    joins dormant slots ``[n + 16 i, n + 16 (i + 1))`` or removes members
    ``[1 + 16 i, 1 + 16 (i + 1))`` at its tick; ``crash_block`` crashes
    the ``n // 20`` slots from ``n // 2`` at ``crash_tick``. ``variant``,
    ``invariant_checks`` and ``recorder_window`` are the run's
    ``Settings``."""

    name: str
    n: int
    crash_every: int = 0
    crash_tick: int = 5
    drop_p: float = 0.0
    drop_seed: int = 0
    flip_flop: bool = False
    churn_burst: int = 0
    contested: bool = False
    variant: str = "rapid"
    invariant_checks: bool = False
    recorder_window: int = 0
    join_bursts: Tuple[int, ...] = ()
    leave_bursts: Tuple[int, ...] = ()
    crash_block: bool = False
    ticks: int = SHARED_TICKS

    @property
    def path(self) -> Path:
        return TESTDATA / f"{self.name}.json"

    @property
    def planned(self) -> bool:
        return bool(self.join_bursts or self.leave_bursts)

    def settings(self):
        """The run's ``Settings``."""
        from rapid_tpu_torch.settings import Settings

        return Settings(protocol_variant=self.variant,
                        invariant_checks=self.invariant_checks,
                        flight_recorder_window=self.recorder_window)

    def churn_period(self, settings) -> int:
        return settings.churn_decide_delay_ticks + 3

    def plan_calls(self):
        """``(joins, leaves, crashes)`` of a planned scenario, as
        ``plan_churn`` takes them: slot -> tick."""
        joins = {self.n + PLAN_BURST * i + k: tick
                 for i, tick in enumerate(self.join_bursts)
                 for k in range(PLAN_BURST)}
        leaves = {1 + PLAN_BURST * i + k: tick
                  for i, tick in enumerate(self.leave_bursts)
                  for k in range(PLAN_BURST)}
        ticks = self.crash_ticks()
        crashes = {s: t for s, t in enumerate(ticks) if t != I32_MAX}
        return joins, leaves, crashes

    def capacity(self, settings) -> int:
        if self.planned:
            return self.n + PLAN_BURST * len(self.join_bursts)
        if not self.churn_burst:
            return self.n
        cycles = max(1, (SHARED_TICKS - 10) // (2 * self.churn_period(
            settings)))
        return self.n + cycles * self.churn_burst

    def crash_ticks(self) -> List[int]:
        ticks = [I32_MAX] * self.n
        if self.crash_every:
            for slot in range(0, self.n, self.crash_every):
                ticks[slot] = self.crash_tick
        if self.crash_block:
            for slot in range(self.n // 2, self.n // 2 + self.n // 20):
                ticks[slot] = self.crash_tick
        return ticks

    def windows(self) -> Tuple[LinkWindow, ...]:
        if not self.flip_flop:
            return ()
        cut = self.n // 100
        return (LinkWindow(src_slots=frozenset(range(cut)),
                           dst_slots=frozenset(range(cut, self.n)),
                           start_tick=20, period_ticks=20),)

    def boot(self, device="cuda") -> SharedBoot:
        """The port's boot of this scenario on ``device``."""
        import time

        from rapid_tpu_torch.convert import from_reference
        from rapid_tpu_torch.engine import churn, paxos
        from rapid_tpu_torch.engine.state import (
            EngineFaults, init_state, link_faults)
        from rapid_tpu_torch.identity import (
            default_endpoints, default_identities, default_node_ids,
            synthetic_uids)
        from rapid_tpu_torch.settings import Settings

        settings = Settings()
        start = time.perf_counter()
        c = self.capacity(settings)
        uids = synthetic_uids(c)
        id_fp_sum = 0
        member = np.arange(c) < self.n
        churn_sched = fallback = id_fps = plan = None
        plan_s = 0.0
        if self.planned:
            joins, leaves, crashes = self.plan_calls()
            plan = churn.plan_churn(
                default_endpoints(c), self.n, default_node_ids(self.n),
                self.ticks, settings, joins=joins, leaves=leaves,
                crashes=crashes)
            plan_s = time.perf_counter() - start
            uids = default_identities(c)[0]
            id_fp_sum = default_identities(self.n)[1]
            id_fps = plan.id_fps
            churn_sched = from_reference(plan, device=device)
        if self.churn_burst:
            sched, id_fps, _ = churn.synthetic_churn_schedule(
                c, self.n, settings, start=10, burst=self.churn_burst,
                period=self.churn_period(settings))
            churn_sched = from_reference(sched, device=device)
        if self.contested:
            sched, _ = paxos.synthetic_contested_schedule(
                self.n, settings, SHARED_TICKS, uids=uids)
            fallback = from_reference(sched, device=device)
        state = init_state(uids, id_fp_sum, settings, member=member,
                           id_fps=id_fps, device=device)
        base = link_faults(self.crash_ticks() + [I32_MAX] * (c - self.n),
                           self.windows(), c, device=device)
        faults = EngineFaults(
            drop_p=self.drop_p, drop_seed=self.drop_seed,
            **{f: getattr(base, f) for f in EngineFaults.FIELDS})
        state.member.sum().item()       # the boot has reached the device
        return SharedBoot(state, faults, churn_sched, fallback,
                          time.perf_counter() - start, plan, plan_s)


SHARED = {sc.name: sc for sc in (
    # BASELINE configuration 2: 1k nodes, a 1 % crash burst.
    SharedScenario("shared_n1000_crash", 1000, crash_every=100),
    # The same burst at 100k nodes.
    SharedScenario("shared_n100k_crash", 100_000, crash_every=100),
    # BASELINE configuration 4: 100k nodes, flip-flop reachability with
    # probabilistic probe drop p = 0.3.
    SharedScenario("shared_n100k_drop_flipflop", 100_000, drop_p=0.3,
                   drop_seed=7, flip_flop=True),
    # BASELINE configuration 5's concurrent joins: 24 alternating join and
    # leave bursts of 8 slots, at 1k and 100k members.
    SharedScenario("shared_n1000_churn", 1000, churn_burst=8),
    SharedScenario("shared_n100k_churn", 100_000, churn_burst=8),
    # ... and its Fast Paxos fallback: 8 split votes, each decided by the
    # classic round.
    SharedScenario("shared_n1000_contested", 1000, contested=True),
    SharedScenario("shared_n100k_contested", 100_000, contested=True),
)}


#: The shared engine's options, each in a golden file of its own.
OPTIONS = {sc.name: sc for sc in (
    # shared_n100k_crash under the ring and hier variants.
    SharedScenario("shared_n100k_crash_ring", 100_000, crash_every=100,
                   variant="ring"),
    SharedScenario("shared_n100k_crash_hier", 100_000, crash_every=100,
                   variant="hier"),
    # shared_n100k_crash with a flight recorder of 64 rows.
    SharedScenario("shared_n100k_crash_rec64", 100_000, crash_every=100,
                   recorder_window=64),
    # BASELINE configuration 5's concurrent joins and leaves, scheduled by
    # the join protocol: two join and two leave bursts of 16 at 100k
    # members ...
    SharedScenario("shared_n100k_planned_churn", 100_000,
                   join_bursts=(10, 40), leave_bursts=(25, 55)),
    # ... and its correlated failure (a contiguous 5 % crash block) with
    # concurrent joins and leaves, at 10k members.
    SharedScenario("shared_n10k_planned_mixed", 10_000, crash_block=True,
                   join_bursts=(120, 150), leave_bursts=(135, 165),
                   ticks=200),
)}

SCENARIOS = {**SHARED, **OPTIONS}


def plan_record(plan) -> dict:
    """JSON-ready form of a ``ChurnPlan``'s prediction."""
    return {
        "events": [[int(t), kind, int(cfg), [int(s) for s in slots]]
                   for t, kind, cfg, slots in plan.events],
        "redraws": {str(s): int(t) for s, t in sorted(plan.redraws.items())},
        "wired": {str(s): int(t) for s, t in sorted(plan.wired.items())},
        "joiner_ids": {str(s): [int(i.high), int(i.low)]
                       for s, i in sorted(plan.joiner_ids.items())},
        "final_members": len(plan.final_members),
        "final_config_id": int(plan.final_config_id),
        "pythonhashseed": PLAN_HASH_SEED,
    }


def record(events, counters, phase_counters, config_ids, n: int) -> dict:
    """Canonical JSON-ready form of one run's host-side results."""
    return {
        "n": n,
        "ticks": len(counters),
        "counters": [dict(row) for row in counters],
        "phase_counters": [dict(row) for row in phase_counters],
        "events": [[[int(t), kind, int(cfg), [int(s) for s in slots]]
                    for t, kind, cfg, slots in events[slot]]
                   for slot in range(n)],
        "config_ids": [int(x) for x in config_ids[:n]],
    }


def run_record(final, logs, n: int) -> dict:
    """``record`` of a port run (final dense state and stacked logs)."""
    from rapid_tpu_torch.engine import receiver

    return record(receiver.receiver_events(logs),
                  receiver.receiver_counters(logs),
                  receiver.receiver_phase_counters(logs),
                  receiver.receiver_config_ids(final), n)


def load(path: Path = GOLDEN_PATH) -> dict:
    return json.loads(path.read_text())


def state_digests(state) -> Dict[str, str]:
    """SHA-256 of each field of a NamedTuple of numpy arrays (reference
    dtypes), over its dtype, shape and bytes."""
    out = {}
    for name in state._fields:
        arr = np.asarray(getattr(state, name))
        h = hashlib.sha256(f"{arr.dtype}{arr.shape}".encode())
        h.update(arr.tobytes())
        out[name] = h.hexdigest()
    return out


def shared_record(name: str, events, logs, counters, config_id: int,
                  final) -> dict:
    """Canonical JSON-ready form of one shared-engine run: ``events`` as
    dicts, ``logs`` and ``final`` NamedTuples of numpy arrays in the
    reference's dtypes, ``counters`` the expanded per-tick counts."""
    scalars = {f: [int(v) for v in np.asarray(getattr(logs, f))]
               for f in logs._fields if np.ndim(getattr(logs, f)) == 1}
    return {
        "name": name,
        "ticks": len(counters),
        "events": [dict(e) for e in events],
        "log": scalars,
        "counters": [dict(row) for row in counters],
        "config_id": int(config_id),
        "state_sha256": state_digests(final),
    }


def shared_run_record(name: str, final, logs, rec=None,
                      plan=None) -> dict:
    """``shared_record`` of a port run (final state and stacked logs),
    with the recorder's payload and the plan's prediction when given."""
    from rapid_tpu_torch.convert import to_numpy
    from rapid_tpu_torch.engine import diff, recorder
    from rapid_tpu_torch.engine.state import state_config_id

    out = shared_record(
        name, [e.as_dict() for e in diff.engine_events(logs)],
        to_numpy(logs), diff.expand_counters(logs), state_config_id(final),
        to_numpy(final))
    if rec is not None:
        out["recorder"] = recorder.recorder_payload(rec)
    if plan is not None:
        out["plan"] = plan_record(plan)
    return out


def run_scenario(sc: SharedScenario, device="cuda", mesh=None) -> dict:
    """Boot ``sc`` on ``device``, run it (on the slot mesh ``mesh`` when
    given), and return its record."""
    from rapid_tpu_torch.engine import simulate

    boot = sc.boot(device=device)
    out = simulate(boot.state, boot.faults, sc.ticks, sc.settings(),
                   churn=boot.churn, fallback=boot.fallback, mesh=mesh,
                   device=device)
    return shared_run_record(sc.name, *out, plan=boot.plan)


def dumps(rec: dict) -> str:
    return json.dumps(rec, sort_keys=True, separators=(",", ":")) + "\n"


def differences(got: dict, want: dict) -> List[str]:
    """Names of the sections (and first differing tick or slot) in which
    two records differ; empty when they are equal."""
    out = []
    for key in sorted(set(got) | set(want)):
        a, b = got.get(key), want.get(key)
        if a == b:
            continue
        if isinstance(a, dict) and isinstance(b, dict):
            out.extend(f"{key}.{sub}" for sub in differences(a, b))
        elif isinstance(a, list) and isinstance(b, list):
            first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
            out.append(f"{key}[{first}]")
        else:
            out.append(key)
    return out


# --- fleets at the campaign's shape --------------------------------------

#: The campaign whose pools the fleet golden files copy: the shape of
#: ``benchmarks/campaign_4096.json`` (seed 0, N=32, 120 ticks, 16 dormant
#: slots of churn headroom, the default scenario weights, dispatches of
#: 256 members), with a 16-row flight recorder on the shared pools.
FLEET_CAMPAIGN = {"seed": 0, "n": 32, "ticks": 120, "headroom": 16,
                  "fleet_size": 256, "recorder": 16, "ring_depth": 4}


class FleetPool(NamedTuple):
    """One pool of the campaign, in the reference's pool order: its mode,
    the capacity its members boot at, the stack shape the file records
    (shared: windows, fallback instances, pids; per-receiver: windows,
    delay rules) and its golden file. The file holds its first
    ``FLEET_CAMPAIGN["fleet_size"]`` members."""

    pool_id: int
    mode: str
    capacity: int
    shape: Tuple[int, ...]
    kinds: Tuple[str, ...]

    @property
    def path(self) -> Path:
        return TESTDATA / f"fleet_pool{self.pool_id}.json"


FLEET_POOLS = {p.pool_id: p for p in (
    FleetPool(0, "shared", 48, (0, 1, 1), ("crash", "churn")),
    FleetPool(1, "shared", 48, (0, 1, 3), ("contested",)),
    FleetPool(2, "per_receiver", 32, (0, 1),
              ("delay", "jitter", "slow_asym")),
    FleetPool(3, "per_receiver", 32, (1, 0), ("partition", "flip_flop")),
)}


def member_seed(idx: int, seed: int = 0) -> int:
    """A campaign member's scenario seed (``campaign._member_seed``)."""
    from rapid_tpu_torch import campaign

    return campaign._member_seed(campaign.CampaignConfig(seed=seed), idx)


def churn_params(seed: int, headroom: int) -> Dict[str, int]:
    """The campaign's churn draw for a member that wants churn:
    ``synthetic_churn_schedule``'s ``burst`` and ``start``
    (``campaign._churn_draw``)."""
    from rapid_tpu_torch import campaign

    return campaign._churn_draw(seed, headroom)


def schedule_json(schedule) -> dict:
    """An ``AdversarySchedule`` of either package as JSON values."""
    rule = lambda r, names: dict(
        {k: getattr(r, k) for k in names},
        src=sorted(r.src_slots), dst=sorted(r.dst_slots))
    return {
        "n": schedule.n, "seed": schedule.seed,
        "crashes": [list(c) for c in schedule.crashes],
        "windows": [rule(w, ("start_tick", "end_tick", "period_ticks",
                             "two_way")) for w in schedule.windows],
        "proposes": [[p.slot, p.tick, list(p.proposal), p.delay_ticks]
                     for p in schedule.proposes],
        "delays": [rule(r, ("delay_ticks", "jitter_ticks",
                            "reverse_delay_ticks", "start_tick",
                            "end_tick")) for r in schedule.delays],
    }


def schedule_from_json(d: dict, faults=None):
    """The ``AdversarySchedule`` of ``schedule_json``'s form, of the
    ``faults`` module given (default: the port's)."""
    if faults is None:
        from rapid_tpu_torch import faults

    slots = lambda r: dict(src_slots=frozenset(r["src"]),
                           dst_slots=frozenset(r["dst"]))
    rest = lambda r: {k: v for k, v in r.items() if k not in ("src", "dst")}
    return faults.AdversarySchedule(
        n=d["n"], seed=d["seed"],
        crashes=tuple(tuple(c) for c in d["crashes"]),
        windows=tuple(faults.LinkWindow(**slots(w), **rest(w))
                      for w in d["windows"]),
        proposes=tuple(faults.ScriptedPropose(s, t, tuple(p), dl)
                       for s, t, p, dl in d["proposes"]),
        delays=tuple(faults.DelayRule(**slots(r), **rest(r))
                     for r in d["delays"]))


def pool_settings(pool: FleetPool, rx_kernel: str = "pallas"):
    """The port's ``Settings`` of a pool's members; ``rx_kernel`` is the
    per-receiver pools' carry layout."""
    from rapid_tpu_torch.settings import Settings

    if pool.mode == "shared":
        return Settings(capacity=pool.capacity,
                        flight_recorder_window=FLEET_CAMPAIGN["recorder"])
    return Settings(capacity=pool.capacity, rx_kernel=rx_kernel)


def lower_pool(pool: FleetPool, members: List[dict], device="cuda",
               rx_kernel: str = "pallas"):
    """The port's stacked fleet of a pool's recorded members (``members``:
    the file's member entries), lowered as the campaign lowers them and
    stacked to the pool's shape."""
    from rapid_tpu_torch.engine import churn, fleet

    settings = pool_settings(pool, rx_kernel)
    n, headroom = FLEET_CAMPAIGN["n"], FLEET_CAMPAIGN["headroom"]
    lowered = []
    for m in members:
        schedule = schedule_from_json(m["schedule"])
        if pool.mode == "per_receiver":
            lowered.append(fleet.lower_receiver_schedule(
                schedule, settings, fleet_size=len(members), device=device))
            continue
        sched = id_fps = None
        if m["churn"] is not None:
            sched, id_fps, _ = churn.synthetic_churn_schedule(
                n + headroom, n, settings, **m["churn"])
        lowered.append(fleet.lower_schedule(schedule, settings, churn=sched,
                                            id_fps=id_fps, device=device))
    if pool.mode == "per_receiver":
        return fleet.stack_receiver_members(
            lowered, n_windows=pool.shape[0], n_delay_rules=pool.shape[1])
    return fleet.stack_members(lowered, n_windows=pool.shape[0],
                               n_instances=pool.shape[1],
                               n_pids=pool.shape[2])


def run_pool(pool: FleetPool, members: List[dict], device="cuda",
             rx_kernel: str = "pallas", fleet_mesh=None):
    """Lower, stack and run a pool's members for the campaign's ticks on
    ``device``, split over ``fleet_mesh`` when given; returns the fleet's
    outputs (``fleet_simulate`` or ``receiver_fleet_simulate``)."""
    from rapid_tpu_torch.engine import fleet

    stacked = lower_pool(pool, members, device=device, rx_kernel=rx_kernel)
    run = (fleet.fleet_simulate if pool.mode == "shared"
           else fleet.receiver_fleet_simulate)
    return run(stacked, FLEET_CAMPAIGN["ticks"],
               pool_settings(pool, rx_kernel), fleet_mesh=fleet_mesh,
               device=device)


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for arr in arrays:
        arr = np.ascontiguousarray(arr)
        h.update(f"{arr.dtype}{arr.shape}".encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _slots(mask) -> List[int]:
    return [int(s) for s in np.nonzero(mask)[0]]


def _u64(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(lo).astype(np.uint64)


def _receiver_events(logs, i: int) -> List[list]:
    """Member ``i``'s per-receiver events, receivers with one event
    grouped: ``[tick, kind, config_id, slots, receivers]``."""
    out = []
    ticks = np.asarray(logs.tick)[i]
    for kind, flag, hosts, hi, lo in (
            ("view_change", logs.decide, logs.dec_hosts, logs.dec_cfg_hi,
             logs.dec_cfg_lo),
            ("proposal", logs.announce, logs.ann_prop, logs.ann_cfg_hi,
             logs.ann_cfg_lo)):
        flag, hosts = np.asarray(flag)[i], np.asarray(hosts)[i]
        cfg = _u64(np.asarray(hi)[i], np.asarray(lo)[i])
        for t in np.nonzero(flag.any(axis=1))[0]:
            groups: Dict[Tuple, List[int]] = {}
            for r in np.nonzero(flag[t])[0]:
                key = (int(cfg[t, r]), tuple(_slots(hosts[t, r])))
                groups.setdefault(key, []).append(int(r))
            out += [[int(ticks[t]), kind, c, list(s), rs]
                    for (c, s), rs in sorted(groups.items())]
    return sorted(out, key=lambda e: (e[0], e[1] != "view_change"))


def pool_record(pool: FleetPool, members: List[dict], logs, finals,
                recs=None) -> dict:
    """The JSON-ready record of one pool run: ``members`` (index, seed,
    kind, schedule, churn), then per member its events, final config ids
    and one SHA-256 over its log fields and one over its final fields
    (in field order), and per field one SHA-256 over all members. ``logs``
    (``[F, T, ...]``), ``finals`` (shared: the final ``EngineState``;
    per-receiver: ``receiver_final_view``'s fields) and ``recs`` are
    NamedTuples of numpy arrays in the reference's dtypes, from either
    package."""
    from rapid_tpu_torch.engine import diff, recorder

    out_members = []
    for i, meta in enumerate(members):
        entry = dict(meta)
        if pool.mode == "shared":
            one = type(logs)(*[np.asarray(x)[i] for x in logs])
            entry["events"] = [list(e.as_dict().values())
                               for e in diff.engine_events(one)]
            entry["config_ids"] = [int(_u64(one.config_hi,
                                            one.config_lo)[-1])]
        else:
            entry["events"] = _receiver_events(logs, i)
            cfg = _u64(finals.cfg_hi, finals.cfg_lo)[i]
            live = ~np.asarray(finals.stopped)[i]
            entry["config_ids"] = sorted({int(c) for c in cfg[live]})
        entry["log_sha256"] = _digest(np.asarray(x)[i] for x in logs)
        entry["final_sha256"] = _digest(np.asarray(x)[i] for x in finals)
        if recs is not None:
            rec = type(recs)(*[np.asarray(x)[i] for x in recs])
            entry["recorder"] = {"rows": recorder.ring_rows(rec).tolist(),
                                 "stamps": recorder.stamps(rec)}
        out_members.append(entry)
    return {
        "pool_id": pool.pool_id, "mode": pool.mode,
        "capacity": pool.capacity, "shape": list(pool.shape),
        "campaign": dict(FLEET_CAMPAIGN),
        "members": out_members,
        "log_field_sha256": {name: _digest([np.asarray(x)])
                             for name, x in zip(logs._fields, logs)},
        "final_field_sha256": {name: _digest([np.asarray(x)])
                               for name, x in zip(finals._fields, finals)},
    }


def fleet_run_record(pool: FleetPool, members: List[dict], out) -> dict:
    """``pool_record`` of a port run (``run_pool``'s outputs)."""
    from rapid_tpu_torch.convert import to_numpy
    from rapid_tpu_torch.engine import receiver

    finals = out[0] if pool.mode == "shared" \
        else receiver.receiver_final_fields(out[0])
    return pool_record(pool, members, to_numpy(out[1]), to_numpy(finals),
                       to_numpy(out[2]) if len(out) > 2 else None)


def pool_inputs(want: dict, count=None) -> List[dict]:
    """The inputs of a pool file's first ``count`` members (all when
    None): index, seed, kind, schedule and churn draw."""
    keys = ("index", "seed", "kind", "schedule", "churn")
    return [{k: m[k] for k in keys} for m in want["members"][:count]]


def pool_head(want: dict, count: int) -> dict:
    """A pool file cut to its first ``count`` members: the per-field
    digests cover all members, so they are dropped."""
    out = dict(want, members=want["members"][:count])
    out.pop("log_field_sha256")
    out.pop("final_field_sha256")
    return out


# --- the committed campaigns ----------------------------------------------

#: ``benchmarks/campaign_4096.json``'s configuration (``CampaignConfig``
#: keywords): 4,096 clusters of N=32, 120 ticks, seed 0, dispatches of
#: 256, 16 dormant churn slots, the default weights, a 16-row recorder.
CAMPAIGN_4096 = {"clusters": 4096, "n": 32, "ticks": 120, "seed": 0,
                 "fleet_size": 256, "headroom": 16, "flight_recorder": 16}

#: The reference's payload at ``CAMPAIGN_4096`` without its wall keys.
CAMPAIGN_PATH = TESTDATA / "campaign_4096_reference.json"

#: Machine-dependent keys of a campaign payload, left out of every
#: comparison (the reference's ``tests/test_campaign.py``).
CAMPAIGN_WALL_KEYS = ("boot_s", "wall_s", "fold_s", "compile_s",
                      "device_busy_s", "host_blocked_s", "spot_check_s",
                      "total_s", "ticks_per_sec", "rounds_per_sec",
                      "clusters_per_sec", "platform", "observatory")

#: Machine-dependent keys of one ``dispatch_timeline`` record.
DISPATCH_WALL_KEYS = ("stages", "wall_s", "clusters_per_sec",
                      "host_blocked_frac", "memory")


def campaign_record(payload: dict) -> dict:
    """A campaign payload of either package after a JSON round trip,
    without its wall keys."""
    out = json.loads(json.dumps(payload))
    for key in CAMPAIGN_WALL_KEYS:
        out.pop(key, None)
    for rec in out.get("dispatch_timeline", []):
        for key in DISPATCH_WALL_KEYS:
            rec.pop(key, None)
    return out


# --- telemetry folds ------------------------------------------------------

TELEMETRY_PATH = TESTDATA / "telemetry_golden.json"

#: The shared runs whose golden ``log`` columns the telemetry file folds.
TELEMETRY_SHARED = ("shared_n100k_crash", "shared_n100k_churn",
                    "shared_n100k_contested")

#: The fleet pools it folds (whole, ``FLEET_CAMPAIGN["fleet_size"]``).
TELEMETRY_POOLS = (0, 2)


class Folds(NamedTuple):
    """One package's telemetry, so the reference and the port fill the
    same record: its ``metrics``, ``lineage`` and ``schema`` modules,
    ``receiver_metrics(final, log, n)`` (one per-receiver member's
    ``TickMetrics`` for its first ``n`` slots) and ``schedule(json)``
    (its ``AdversarySchedule`` of ``schedule_json``'s form)."""

    metrics: object
    lineage: object
    schema: object
    receiver_metrics: Callable
    schedule: Callable


def port_folds() -> Folds:
    from rapid_tpu_torch.engine.receiver import receiver_run_payload
    from rapid_tpu_torch.telemetry import lineage, metrics, schema

    def receiver_metrics(final, log, n):
        final, log = _tensor_tree(final), _tensor_tree(log)
        return receiver_run_payload(final, log, n, len(log.tick)).metrics()

    return Folds(metrics, lineage, schema, receiver_metrics,
                 schedule_from_json)


def _tensor_tree(nt):
    """A NamedTuple of host arrays or tensors as one of tensors (host
    arrays shared, not copied)."""
    import torch

    return type(nt)(*[torch.as_tensor(x) for x in nt])


def log_columns(rec: dict):
    """A shared golden file's ``log`` columns as a log of numpy arrays
    (every ``StepLog`` field without a slot axis)."""
    cols = {k: np.asarray(v, np.int64) for k, v in rec["log"].items()}
    return SimpleNamespace(_fields=tuple(sorted(cols)), **cols)


def _span_block(folds: Folds, spans) -> dict:
    summary = folds.lineage.lineage_summary(spans)
    errors = [e for s in spans for e in folds.schema.validate_lineage_span(s)]
    errors += folds.schema.validate_lineage_summary(summary)
    return {"spans": [folds.lineage.comparable(s) for s in spans],
            "lineage": summary, "errors": errors}


def shared_telemetry(folds: Folds, logs) -> dict:
    """The telemetry record of one shared run's ``StepLog`` (or its
    golden columns): the run summary and the lineage spans, with the
    validators' verdicts."""
    summary = folds.metrics.summarize(
        folds.metrics.engine_metrics(logs)).as_dict()
    out = _span_block(folds, folds.lineage.fold_spans(
        folds.lineage.engine_phase_columns(logs)))
    out["summary"] = summary
    out["errors"] = folds.schema.validate_telemetry(summary) + out["errors"]
    return out


def recorder_telemetry(folds: Folds, payload: dict) -> dict:
    """The lineage of a flight-recorder payload, with its verdicts."""
    out = _span_block(folds, folds.lineage.lineage_from_recorder(payload))
    out["errors"] = (folds.schema.validate_flight_recorder(payload)
                     + out["errors"])
    return out


def _host_tree(nt):
    """A log or state NamedTuple with its leaves on the host, tensors read
    in one transfer (``metrics.host_log``)."""
    from rapid_tpu_torch.telemetry.metrics import host_log

    host = host_log(nt, nt._fields)
    return type(nt)(*[getattr(host, f) for f in nt._fields])


def pool_telemetry(folds: Folds, pool: FleetPool, members: List[dict],
                   logs, finals=None) -> dict:
    """A pool run's telemetry as the reference's campaign folds it: per
    member its summary and lineage spans (a per-receiver member's spans
    with their critical paths where its schedule has delays), the merged
    summary, the distributions and the lineage summary of every span.
    ``logs`` is the fleet's member-major log, ``finals`` the
    per-receiver finals' host-read fields
    (``receiver.receiver_final_fields``)."""
    lin = folds.lineage
    if pool.mode == "shared":
        summaries = folds.metrics.fleet_summaries(logs)
        cols = lin.engine_phase_columns(logs)
        spans = [lin.fold_spans(cols.member(j)) for j in range(len(members))]
    else:
        n = FLEET_CAMPAIGN["n"]
        logs, finals = _host_tree(logs), _host_tree(finals)
        summaries, spans = [], []
        for j, meta in enumerate(members):
            mlog = type(logs)(*[x[j] for x in logs])
            mfinal = type(finals)(*[x[j] for x in finals])
            summaries.append(folds.metrics.summarize(
                folds.receiver_metrics(mfinal, mlog, n)))
            member_spans = lin.fold_spans(lin.receiver_phase_columns(mlog))
            schedule = folds.schedule(meta["schedule"])
            if schedule.delays:
                for sp in member_spans:
                    sp["critical_path"] = lin.receiver_critical_path(
                        mlog, sp, schedule)
            spans.append(member_spans)
    merged = folds.metrics.merge_summaries(summaries).as_dict()
    out = _span_block(folds, [s for member in spans for s in member])
    out.pop("spans")
    out["summary"] = merged
    out["distributions"] = folds.metrics.summary_distributions(summaries)
    out["members"] = [
        {"index": meta["index"], "summary": s.as_dict(),
         "spans": [dict(lin.comparable(sp),
                        critical_path=sp["critical_path"]) for sp in sp_]}
        for meta, s, sp_ in zip(members, summaries, spans)]
    out["errors"] = (folds.schema.validate_telemetry(merged)
                     + [e for s in summaries
                        for e in folds.schema.validate_telemetry(
                            s.as_dict())]
                     + out["errors"])
    return out


def telemetry_record(entries: Dict[str, dict]) -> dict:
    """The telemetry file's JSON-ready form."""
    return {"schema_version": 12, "entries": dict(sorted(entries.items()))}


# --- the streaming service ------------------------------------------------

#: ``benchmarks/soak.json``'s configuration: the reference CLI's
#: ``--soak`` defaults (``rapid_tpu/service/__main__.py``).
SOAK = {"n": 24, "capacity": 96, "chunk": 512, "seed": 0, "rate": 20.0,
        "leave_rate": 2.0, "leave_burst": 4, "diurnal": 0.3,
        "diurnal_period": 4096, "recorder": 8, "slo_window": 8}

#: Machine-dependent keys of a chunk record or a stream summary, left out
#: of every comparison.
STREAM_WALL_KEYS = ("wall_s", "compile_s", "ticks_per_sec",
                    "events_per_sec", "live_buffer_bytes")

#: The keys a soak's chunk records are held to ``benchmarks/soak.json``'s
#: without: the walls, and the checkpoint block (checked on its own).
SOAK_SKIP_KEYS = STREAM_WALL_KEYS + ("checkpoint",)

#: One checkpoint of each family, written by the reference's
#: ``save_checkpoint``; ``continuations.json`` holds the reference's
#: continuation from each (``checkpoint_record``).
CHECKPOINT_DIR = TESTDATA / "checkpoints"
CHECKPOINT_PATH = CHECKPOINT_DIR / "continuations.json"
CHECKPOINT_FAMILIES = ("engine", "receiver_dense", "receiver_packed")
ENGINE_CHECKPOINT_CHUNKS = 2   # the soak's chunks before the save
#: The receiver checkpoints: the two-zone deployment at N=64 in chunks of
#: 16 (``rx_soak.json``'s horizon and chunk), saved after 6 chunks (tick
#: 96); the second continuation decides.
RX_CHECKPOINT = {"n": 64, "seed": 0, "horizon": 192, "chunk": 16,
                 "chunks": 6, "recorder": 8}

#: A resident shared engine at full width: N=100,000 in phase 9's slot
#: count, the soak's traffic rates, 6 chunks of 256 with the round trip
#: at chunk 3.
STREAM_N100K = dict(SOAK, n=100_000, capacity=100_096, chunk=256,
                    chunks=6, verify_at=3)
STREAM_N100K_PATH = TESTDATA / "stream_n100k.json"

#: The pinned servo stream: the soak's configuration, ``--target-rate
#: 40 --pinned-tps 1000``, 8 chunks with the round trip at chunk 4 (the
#: CLI's ``--ticks 4096``).
SERVO_STREAM = dict(SOAK, target_rate=40.0, pinned_tps=1000.0, chunks=8,
                    verify_at=4)
SERVO_PATH = TESTDATA / "stream_servo.json"


class PortService:
    """The port's service entry points in the shape the golden runners
    below call; tests pass the reference's twin, so both packages run
    the same code here."""

    def __init__(self, device="cuda"):
        from rapid_tpu_torch import service
        from rapid_tpu_torch.convert import to_numpy
        from rapid_tpu_torch.settings import Settings
        from rapid_tpu_torch.telemetry.slo import SloWindows

        self.device = device
        self.service, self.Settings, self.SloWindows = (service, Settings,
                                                        SloWindows)
        self._to_numpy = to_numpy

    def boot_resident(self, settings, capacity, n, **kw):
        return self.service.boot_resident(settings, capacity, n,
                                          device=self.device, **kw)

    def boot_resident_receiver(self, settings, n, **kw):
        return self.service.boot_resident_receiver(settings, n,
                                                   device=self.device, **kw)

    def load_checkpoint(self, path, settings):
        return self.service.load_checkpoint(str(path), settings,
                                            device=self.device)

    def engine_faults(self, capacity):
        from rapid_tpu_torch.engine.state import crash_faults

        return crash_faults([I32_MAX] * capacity, device=self.device)

    def receiver_faults(self, settings):
        from rapid_tpu_torch.engine.fleet import lower_receiver_schedule
        from rapid_tpu_torch.faults import two_zone_schedule

        rc = RX_CHECKPOINT
        sched = two_zone_schedule(rc["n"], rc["seed"], rc["horizon"],
                                  ring_depth=settings.delivery_ring_depth)
        return lower_receiver_schedule(sched, settings,
                                       device=self.device).faults

    def engine_chunk(self, state, faults, n_ticks, settings, schedule, rec):
        from rapid_tpu_torch.convert import from_reference
        from rapid_tpu_torch.engine.churn import empty_schedule
        from rapid_tpu_torch.engine.step import simulate_chunk

        if schedule is None:
            schedule = empty_schedule(state.member.shape[0])
        return simulate_chunk(state, faults, n_ticks, settings,
                              churn=from_reference(schedule, self.device),
                              rec=rec, device=self.device)

    def receiver_chunk(self, carry, faults, n_ticks, settings, rec):
        from rapid_tpu_torch.engine.receiver import receiver_simulate_chunk

        return receiver_simulate_chunk(carry, faults, n_ticks, settings,
                                       rec=rec)

    def to_numpy(self, tree):
        return self._to_numpy(tree)

    def array(self, name, leaf):
        from rapid_tpu_torch.convert import _leaf_to

        return _leaf_to(name, leaf)


def soak_settings(svc, cfg: dict):
    return svc.Settings(stream_chunk_ticks=cfg["chunk"],
                        flight_recorder_window=cfg["recorder"])


def boot_soak(svc, cfg: dict = SOAK, *, servo=None, status=None, sink=None,
              closed_loop=False):
    """A resident engine at ``cfg`` (``SOAK``'s keys) with the soak's
    traffic and SLO windows, as the CLI's ``--soak`` boots it."""
    traffic = svc.service.TrafficConfig(
        seed=cfg["seed"], join_rate_per_ktick=cfg["rate"],
        leave_burst_rate_per_ktick=cfg["leave_rate"],
        leave_burst_size=cfg["leave_burst"],
        diurnal_amplitude=cfg["diurnal"],
        diurnal_period_ticks=cfg["diurnal_period"], closed_loop=closed_loop)
    return svc.boot_resident(
        soak_settings(svc, cfg), cfg["capacity"], cfg["n"], seed=cfg["seed"],
        traffic_config=traffic, servo=servo,
        slo=svc.SloWindows(window_chunks=cfg["slo_window"]), status=status,
        sink=sink, write_ticks=False)


def run_stream(eng, chunks: int, verify_at: int, path) -> None:
    """``verify_at`` chunks, the round trip through ``path`` (itself a
    chunk), then the rest of ``chunks``."""
    eng.run(verify_at)
    eng.verify_round_trip(str(path))
    eng.run(chunks - verify_at - 1)


def stream_record(eng, final=None, svc=None) -> dict:
    """A finished stream without its wall keys: every chunk record, the
    summary (written by this call) and, with ``final``, a SHA-256 of each
    final-state field."""
    def strip(rec):
        return {k: v for k, v in rec.items() if k not in STREAM_WALL_KEYS}

    out = {"chunks": [strip(r) for r in eng.chunk_records],
           "summary": strip(eng.summary())}
    if final is not None:
        out["state_sha256"] = state_digests(svc.to_numpy(final))
    return json.loads(json.dumps(out))


def servo_stream_record(svc, scratch, status=None) -> dict:
    """``SERVO_STREAM`` run through ``svc`` (its checkpoint under
    ``scratch``), with ``status`` attached: ``stream_record``."""
    cfg = SERVO_STREAM
    servo = svc.service.LoadServo(svc.service.ServoConfig(
        target_events_per_sec=cfg["target_rate"],
        pinned_ticks_per_sec=cfg["pinned_tps"]))
    eng = boot_soak(svc, cfg, servo=servo, status=status, closed_loop=True)
    run_stream(eng, cfg["chunks"], cfg["verify_at"], Path(scratch) / "servo")
    out = stream_record(eng)
    eng.close()
    return out


def n100k_stream_record(svc, scratch, keep=None) -> dict:
    """``STREAM_N100K`` run through ``svc``: ``stream_record`` with the
    final state's digests; ``keep`` (a dict) receives the engine."""
    cfg = STREAM_N100K
    eng = boot_soak(svc, cfg)
    run_stream(eng, cfg["chunks"], cfg["verify_at"], Path(scratch) / "n100k")
    out = stream_record(eng, eng.state, svc)
    if keep is not None:
        keep["engine"] = eng
    return out


def soak_errors(records, summary=None) -> List[str]:
    """Where a soak's chunk records (and summary) differ from
    ``benchmarks/soak.json``'s on the file's keys (``SOAK_SKIP_KEYS``
    left out; the summary's ``schema_version`` too, which the reference
    moved from 11 to 12 since the file was written), and any checkpoint
    block that is not all true."""
    committed = json.loads((TESTDATA.parents[1] / "benchmarks"
                            / "soak.json").read_text())
    errors = []
    for got, want in zip(records, committed["chunks"]):
        for key in want:
            if key not in SOAK_SKIP_KEYS and got.get(key) != want[key]:
                errors.append(f"chunk {want['index']}: {key}")
        block = got.get("checkpoint")
        if block is not None and not all(
                v for k, v in block.items() if k.endswith("identical")):
            errors.append(f"chunk {want['index']}: checkpoint {block}")
    if len(records) > len(committed["chunks"]):
        errors.append(f"{len(records)} chunks, the file has "
                      f"{len(committed['chunks'])}")
    if summary is not None:
        for key, want in committed["summary"].items():
            if key in SOAK_SKIP_KEYS + ("schema_version",):
                continue
            if summary.get(key) != want:
                errors.append(f"summary: {key}")
        block = summary.get("checkpoint") or {}
        if block != committed["summary"]["checkpoint"]:
            errors.append(f"summary: checkpoint {block}")
    return errors


def _tree_np(svc, tree):
    """A NamedTuple (or packed bundle) as ``{field: numpy}`` in the
    reference's dtypes; a bundle's packed fields prefixed ``packed.``."""
    arr = svc.to_numpy(tree)
    if hasattr(arr, "packed"):
        out = {f"packed.{f}": np.asarray(getattr(arr.packed, f))
               for f in arr.packed._fields}
        out["delay_table"] = np.asarray(arr.delay_table)
        return out
    return {f: np.asarray(getattr(arr, f)) for f in arr._fields}


def _digests(fields: Dict[str, np.ndarray]) -> Dict[str, str]:
    return {name: _digest([arr]) for name, arr in sorted(fields.items())}


def continuation_record(svc, final, logs, rec) -> dict:
    """One continuation chunk: a SHA-256 of every log and final-state
    field (reference dtypes), the recorder's rows and stamps, and the
    chunk's announce and decide counts."""
    from rapid_tpu_torch.engine.recorder import recorder_payload

    log_np = _tree_np(svc, logs)
    announce = log_np.get("announce_now", log_np.get("announce"))
    decide = log_np.get("decide_now", log_np.get("decide"))
    return {"ticks": [int(log_np["tick"][0]), int(log_np["tick"][-1])],
            "announces": int(np.asarray(announce, bool).sum()),
            "decides": int(np.asarray(decide, bool).sum()),
            "log_sha256": _digests(log_np),
            "final_sha256": _digests(_tree_np(svc, final)),
            "recorder": recorder_payload(svc.to_numpy(rec))}


def family_settings(svc, family: str):
    if family == "engine":
        return soak_settings(svc, SOAK)
    kernel = "xla" if family == "receiver_dense" else "packed"
    return svc.Settings(rx_kernel=kernel,
                        flight_recorder_window=RX_CHECKPOINT["recorder"])


def write_checkpoint(svc, family: str, path) -> None:
    """The checkpoint of ``family`` that ``CHECKPOINT_DIR`` holds: the
    soak after ``ENGINE_CHECKPOINT_CHUNKS`` chunks, or the two-zone
    receiver after ``RX_CHECKPOINT["chunks"]``."""
    if family == "engine":
        eng = boot_soak(svc)
        eng.run(ENGINE_CHECKPOINT_CHUNKS)
        eng.save(str(path))
        return
    rc = RX_CHECKPOINT
    rx = svc.boot_resident_receiver(
        family_settings(svc, family), rc["n"], seed=rc["seed"],
        horizon_ticks=rc["horizon"], chunk_ticks=rc["chunk"])
    rx.run(rc["chunks"])
    rx.save(str(path))


def continue_checkpoint(svc, family: str, path, scratch) -> dict:
    """Restore the checkpoint at ``path``, run one chunk, save it under
    ``scratch``, load that and run one more: the record of both chunks
    (``continuation_record``) and of what was restored."""
    settings = family_settings(svc, family)
    cp = svc.load_checkpoint(path, settings)
    out = {"family": cp.family, "tick": cp.tick,
           "leaves": cp.manifest["leaves"],
           "restored_sha256": {
               p: _digests(_tree_np(svc, t) if hasattr(t, "_fields")
                           else {p: svc.array(p, t)})
               for p, t in sorted(cp.parts.items())},
           "continuations": []}
    if family == "engine":
        gen = svc.service.TrafficGenerator.from_state(cp.host["traffic"],
                                                      settings)
        faults = svc.engine_faults(SOAK["capacity"])
        state, rec = cp.parts["state"], cp.parts["recorder"]
        for i in range(2):
            schedule, _ = gen.next_chunk(SOAK["chunk"])
            state, logs, rec = svc.engine_chunk(state, faults, SOAK["chunk"],
                                                settings, schedule, rec)
            out["continuations"].append(dict(
                continuation_record(svc, state, logs, rec),
                traffic=gen.state_dict()))
            if i == 0:
                svc.service.save_engine(str(scratch), state, settings,
                                        rec=rec,
                                        host={"traffic": gen.state_dict()})
                cp2 = svc.load_checkpoint(scratch, settings)
                gen = svc.service.TrafficGenerator.from_state(
                    cp2.host["traffic"], settings)
                state, rec = cp2.parts["state"], cp2.parts["recorder"]
        return out
    faults = svc.receiver_faults(settings)
    carry = svc.service.restore_receiver_carry(cp, settings)
    rec, tick = cp.parts["recorder"], cp.tick
    n = RX_CHECKPOINT["chunk"]
    for i in range(2):
        carry, logs, rec = svc.receiver_chunk(carry, faults, n, settings,
                                              rec)
        tick += n
        out["continuations"].append(
            continuation_record(svc, carry, logs, rec))
        if i == 0:
            svc.service.save_receiver(str(scratch), carry, settings,
                                      tick=tick, rec=rec)
            cp2 = svc.load_checkpoint(scratch, settings)
            carry = svc.service.restore_receiver_carry(cp2, settings)
            rec = cp2.parts["recorder"]
    return out


def _wall_warning(where: str, cur, base, tolerance: float) -> List[str]:
    """A warning when the number ``cur`` is more than ``tolerance`` above
    ``base``, in ``bench_compare``'s words."""
    if isinstance(cur, (int, float)) and isinstance(base, (int, float)) \
            and base > 0 and cur > base * (1.0 + tolerance):
        up = 100.0 * (cur / base - 1.0)
        return [f"{where}: {cur:.3e} is {up:.0f}% above baseline "
                f"{base:.3e} (tolerance {tolerance * 100:.0f}%)"]
    return []


def profile_sweep_errors(current: dict, baseline: dict,
                         wall_tolerance: float = 0.50
                         ) -> Tuple[List[str], List[str]]:
    """``(errors, warnings)`` of ``bench_compare.compare_profile_sweeps``
    on two ``kernel_profile_sweep`` payloads, the same rules in the same
    words (a copy: the script imports the reference's schema).

    Errors: a kernel of a baseline run missing from the current run of
    the same ``n``; a mismatch of the multichip mesh shape, of the
    receiver-memory config, ``member_state_bytes``, the bytes-per-member
    curve or a fleet's ``argument_bytes``/``output_bytes``; of the
    variant block's config, or a refusal attempted or its arithmetic
    changed. Walls, temp and peak bytes only warn past
    ``wall_tolerance``."""
    errors: List[str] = []
    warnings: List[str] = []
    base_runs = {run.get("n"): run for run in baseline.get("runs", [])}
    for run in current.get("runs", []):
        n = run.get("n")
        where = f"payload.runs[n={n}]"
        base = base_runs.get(n)
        if base is None:
            warnings.append(f"{where}: no baseline run at this n "
                            f"(baseline sizes {sorted(base_runs)})")
            continue
        if run.get("k") != base.get("k"):
            errors.append(f"{where}.k: config mismatch (current "
                          f"{run.get('k')!r} vs baseline {base.get('k')!r})"
                          f" — regenerate with --update-baseline")
            continue
        base_kernels = {k["kernel"]: k for k in base.get("kernels", [])}
        cur_kernels = {k["kernel"]: k for k in run.get("kernels", [])}
        for name in sorted(set(base_kernels) - set(cur_kernels)):
            errors.append(f"{where}: kernel {name!r} in baseline but "
                          f"missing from current sweep")
        for name, cur_k in sorted(cur_kernels.items()):
            base_k = base_kernels.get(name)
            if base_k is None:
                warnings.append(f"{where}: new kernel {name!r} not in "
                                f"baseline")
                continue
            warnings += _wall_warning(
                f"{where}.{name}.wall_median_s", cur_k.get("wall_median_s"),
                base_k.get("wall_median_s"), wall_tolerance)

    cur_mc = current.get("multichip")
    base_mc = baseline.get("multichip")
    if isinstance(cur_mc, dict) and isinstance(base_mc, dict):
        for key in ("n_devices", "axis"):
            if cur_mc.get(key) != base_mc.get(key):
                errors.append(
                    f"payload.multichip.{key}: config mismatch (current "
                    f"{cur_mc.get(key)!r} vs baseline {base_mc.get(key)!r})"
                    f" — regenerate with --update-baseline")

    cur_rm = current.get("receiver_memory")
    base_rm = baseline.get("receiver_memory")
    if isinstance(cur_rm, dict) and isinstance(base_rm, dict):
        for key in ("n", "capacity", "k", "member_state_bytes"):
            if cur_rm.get(key) != base_rm.get(key):
                errors.append(
                    f"payload.receiver_memory.{key}: config mismatch "
                    f"(current {cur_rm.get(key)!r} vs baseline "
                    f"{base_rm.get(key)!r}) — regenerate with "
                    f"--update-baseline")
        base_fleets = {f.get("fleet_size"): f
                       for f in base_rm.get("fleets", [])}
        cur_curve = {row.get("capacity"): row
                     for row in cur_rm.get("bytes_per_member_curve", [])}
        base_curve = {row.get("capacity"): row
                      for row in base_rm.get("bytes_per_member_curve", [])}
        for cap in sorted(set(cur_curve) & set(base_curve)):
            for key in ("dense_bytes", "packed_carry_bytes",
                        "packed_bundle_bytes"):
                if cur_curve[cap].get(key) != base_curve[cap].get(key):
                    errors.append(
                        f"payload.receiver_memory.bytes_per_member_curve"
                        f"[C={cap}].{key}: {cur_curve[cap].get(key)!r} != "
                        f"baseline {base_curve[cap].get(key)!r}")
        for fl in cur_rm.get("fleets", []):
            fsz = fl.get("fleet_size")
            where = f"payload.receiver_memory.fleets[F={fsz}]"
            base_f = base_fleets.get(fsz)
            if base_f is None:
                warnings.append(f"{where}: no baseline fleet at this size "
                                f"(baseline sizes {sorted(base_fleets)})")
                continue
            for key in ("argument_bytes", "output_bytes"):
                if fl.get(key) != base_f.get(key):
                    errors.append(f"{where}.{key}: {fl.get(key)!r} != "
                                  f"baseline {base_f.get(key)!r}")
            for key in ("temp_bytes", "peak_bytes"):
                cur_v, base_v = fl.get(key), base_f.get(key)
                if isinstance(cur_v, int) and isinstance(base_v, int) and \
                        base_v > 0 and \
                        cur_v > base_v * (1.0 + wall_tolerance):
                    up = 100.0 * (cur_v / base_v - 1.0)
                    warnings.append(
                        f"{where}.{key}: {cur_v} is {up:.0f}% above "
                        f"baseline {base_v} (tolerance "
                        f"{wall_tolerance * 100:.0f}%)")

    cur_vb = current.get("variants")
    base_vb = baseline.get("variants")
    if isinstance(cur_vb, dict) and isinstance(base_vb, dict):
        for key in ("sizes", "budget_bytes"):
            if cur_vb.get(key) != base_vb.get(key):
                errors.append(
                    f"payload.variants.{key}: config mismatch (current "
                    f"{cur_vb.get(key)!r} vs baseline {base_vb.get(key)!r})"
                    f" — regenerate with --update-baseline")
        cur_ref = {(r.get("kernel"), r.get("n")): r
                   for r in cur_vb.get("refusals", [])}
        base_ref = {(r.get("kernel"), r.get("n")): r
                    for r in base_vb.get("refusals", [])}
        for key in sorted(set(base_ref) - set(cur_ref)):
            errors.append(f"payload.variants.refusals: {key[0]!r} at "
                          f"n={key[1]} refused in baseline but attempted "
                          f"in current sweep")
        for key in sorted(set(cur_ref) & set(base_ref)):
            for field in ("bytes_required", "budget_bytes"):
                if cur_ref[key].get(field) != base_ref[key].get(field):
                    errors.append(
                        f"payload.variants.refusals[{key[0]}, n={key[1]}]"
                        f".{field}: {cur_ref[key].get(field)!r} != "
                        f"baseline {base_ref[key].get(field)!r}")
        base_vk = {(k.get("kernel"), k.get("n")): k
                   for k in base_vb.get("kernels", [])}
        for k in cur_vb.get("kernels", []):
            ref = (k.get("kernel"), k.get("n"))
            base_k = base_vk.get(ref)
            where = f"payload.variants.kernels[{ref[0]}, n={ref[1]}]"
            if base_k is None:
                warnings.append(f"{where}: not in baseline")
                continue
            warnings += _wall_warning(
                f"{where}.wall_median_s", k.get("wall_median_s"),
                base_k.get("wall_median_s"), wall_tolerance)
    return errors, warnings
