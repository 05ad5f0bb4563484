"""Monte-Carlo fault campaigns over fleets of batched clusters.

Own copy of the reference's ``campaign.py``. A campaign samples
scenario space with ``faults.sample_adversary_schedule`` (seeded weights
over crash, partition, flip-flop, contested, churn and the latency
family), routes each member to the shared engine or the per-receiver
engine, buckets the members into kind-homogeneous pools by schedule
shape, and runs each pool as fleets of ``fleet_size`` clusters
(``engine.fleet``). Every member's logs fold into a ``RunSummary``,
lineage spans and, for triage exemplars, its flight-recorder ring; the
fleet merges, nearest-rank distributions, per-delay-regime tails, triage
classes and the lineage summaries are bit-deterministic in the campaign
seed, as the reference's are, so the same configuration gives the same
``campaign`` block in both packages.

Routing: partition, flip-flop and latency members run per-receiver
(device-exact under link faults and per-edge delay; latency members
always, since the shared wire has no per-edge arrival ticks); crash,
contested and churn members run the shared engine. Churn members are
inert in both packages (``ROADMAP.md`` Queue 3). Spot checks replay a
seeded subset through the host referee (``engine.diff``) before any
dispatch; a divergence writes a JSONL artifact and a payload record, and
the campaign aborts once failures exceed ``max_spot_failures``.

How the reference's JAX-only parts map:

- *Async dispatch and ``jax.block_until_ready``.* ``_launch`` runs the
  fleet's host loop, which enqueues every tick on the current CUDA
  stream, and records a ``torch.cuda.Event`` after the last tick;
  ``_retire`` waits on that event and then folds. On the CPU there is no
  event and the launch is synchronous. Retirement stays FIFO at
  ``PIPELINE_DEPTH`` = 2, so ``pipeline=False`` gives a payload equal in
  every non-wall field. A shared fleet reads host scalars every tick, so
  its launch blocks on the card; a per-receiver fleet rarely does, so
  the host runs ahead.
- *Ahead-of-time compiles, donation and the compile cache* have no
  PyTorch form (``ROADMAP.md`` Queue 1 item 1). ``compiled`` keeps its
  meaning, the first dispatch of its pool, and that dispatch's
  ``compile`` stage times its one-time work: the kernel build when a
  per-receiver pool first runs on the card, and the lowering of the
  pool's first member, which boots the pool's shape into
  ``engine.fleet``'s boot caches. ``observatory.compile`` records per
  pool ``lower_s`` 0.0, that time as ``compile_s``, the stacked fleet's
  tensor bytes (``argument_bytes``), the bytes of finals, logs and
  recorder (``output_bytes``), and ``peak_bytes``/``temp_bytes`` from
  ``torch.cuda.max_memory_allocated`` over the dispatch (0 on the CPU).
- *``jax.live_arrays`` and ``memory_stats``* become
  ``torch.cuda.memory_allocated`` and ``max_memory_allocated``;
  ``device_peak_bytes`` is null on the CPU, and ``platform`` is "gpu" on
  the card, "cpu" otherwise.
- *``fleet_shard``* raises ``engine.fleet``'s ``NotImplementedError``
  (``ROADMAP.md`` Queue 1 item 8).
- *The recorder's host copy* is one copy of the dispatch's rings;
  triage slices exemplars out of it with ``recorder.member_recorder``.

Tournaments (``run_tournament``) run the same sampled members once per
protocol variant on the shared engine and report per-variant tails,
message totals and per-kind win/loss.

CLI (runs on the card unless ``--device cpu``)::

    python -m rapid_tpu_torch.campaign --clusters 4096 --n 32 --ticks 120 \\
        --fleet-size 256 --flight-recorder 16 --out campaign.json

    python -m rapid_tpu_torch.campaign --clusters 256 --n 32 --ticks 160 \\
        --fleet-size 16 --tournament rapid,ring \\
        --weights crash=1,partition=1,flip_flop=1,contested=1,churn=1,\\
delay=0,jitter=0,slow_asym=0 --out tournament.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import random
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from rapid_tpu_torch import hashing
from rapid_tpu_torch.faults import (DEFAULT_SCENARIO_WEIGHTS, DELAY_KINDS,
                                    SCENARIO_KINDS, SampledScenario,
                                    ScenarioWeights, sample_adversary_schedule)
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry import lineage as lineage_lib

__all__ = ["CampaignConfig", "run_campaign", "run_tournament", "main"]

#: Spot-check kinds the acceptance gate requires when the budget allows:
#: a partition (link-masked FD path), a contested split (classic-Paxos
#: fallback on both sides of the differential), and a delay member (the
#: delivery-ring latency path).
REQUIRED_SPOT_KINDS = ("partition", "contested", "delay")

#: Walls below this are timer noise; rates derived from them
#: (``ticks_per_sec``, ``clusters_per_sec``) are reported as ``null``.
MIN_MEASURABLE_WALL_S = 1e-3

#: Launched-but-unretired dispatches the pipelined loop keeps in
#: flight: dispatch d runs on the card while the host samples, lowers and
#: stacks d+1.
PIPELINE_DEPTH = 2

#: Anomaly classes of the post-dispatch triage classifier, in report
#: order. Every member is tested against every class; counts and
#: exemplar refs are seed-deterministic.
TRIAGE_CLASSES = (
    "no_decide_by_deadline",   # never decided within cfg.ticks
    "slow_decide",             # decided past the campaign p99 tail
    "invariant_violations",    # invariant monitor tripped
    "envelope_flags",          # per-receiver sticky envelope flags
    "excess_fallback",         # unexpected / repeated classic-Paxos rounds
    "spot_failures",           # host oracle referee divergence
)

#: Kinds for which classic-Paxos fallback traffic is the expected
#: resolution path; any other kind sending classic traffic is an anomaly.
EXPECTED_FALLBACK_KINDS = ("contested",) + DELAY_KINDS

#: Classic rounds at or above which even an expected-fallback member is
#: flagged.
EXCESS_FALLBACK_ROUNDS = 2

#: Exemplar member refs embedded per triage class (first in campaign
#: index order).
MAX_TRIAGE_EXEMPLARS = 4


def _rate(numerator: float, wall_s: float) -> Optional[float]:
    """``numerator / wall_s``, or None when the wall is unmeasurable."""
    if wall_s < MIN_MEASURABLE_WALL_S:
        return None
    return numerator / wall_s


class _ProgressWriter:
    """``--progress`` JSONL heartbeat: one flushed, newline-terminated
    line per completed dispatch (and per spot check). ``-`` streams to
    stderr; None disables it."""

    def __init__(self, path: Optional[str]) -> None:
        self._fh = None
        self._own = False
        if path == "-":
            self._fh = sys.stderr
        elif path:
            self._fh = open(path, "w")
            self._own = True

    def emit(self, record: Dict[str, object]) -> None:
        if self._fh is None:
            return
        from rapid_tpu_torch.telemetry import json_artifact_line

        self._fh.write(json_artifact_line(record, sort_keys=True))
        self._fh.flush()

    def close(self) -> None:
        if self._own and self._fh is not None:
            self._fh.close()
            self._fh = None


@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    """Knobs of one campaign; everything downstream is derived from these
    (same config => bit-identical aggregates and distributions)."""

    clusters: int = 64
    n: int = 64
    ticks: int = 240
    seed: int = 0
    fleet_size: int = 64
    headroom: int = 16          # dormant slots per cluster for churn joins
    weights: Optional[ScenarioWeights] = None
    spot_checks: int = 0
    settings: Optional[Settings] = None
    # Route partition/flip-flop members through the per-receiver engine;
    # False runs them on the shared engine (latency members stay
    # per-receiver regardless).
    per_receiver: bool = True
    # Spot-check failures tolerated before the campaign aborts.
    max_spot_failures: int = 0
    # Where divergence artifacts land (default: the system temp dir).
    artifact_dir: Optional[str] = None
    # Two dispatches in flight (launch, then fence at fold time); False
    # fences each dispatch right after its launch. Every non-wall payload
    # field is the same either way.
    pipeline: bool = True
    # A device mesh over the fleet axis: refused (ROADMAP.md Queue 1
    # item 8).
    fleet_shard: Optional[int] = None
    # Flight-recorder window W: > 0 carries a [W, G] gauge ring through
    # every member's run and embeds the rings of triage exemplars.
    flight_recorder: int = 0
    # Protocol variant every member runs ("rapid", "ring" or "hier");
    # never feeds the scenario sampler.
    protocol_variant: str = "rapid"


def _receiver_eligible(sc: SampledScenario) -> bool:
    """Per-receiver dispatch eligibility: link-fault and latency members
    without churn or scripted proposes."""
    return (sc.kind in ("partition", "flip_flop") + DELAY_KINDS
            and not sc.wants_churn and not sc.schedule.proposes)


def _delay_member(sc: SampledScenario) -> bool:
    """True for members the shared engine cannot represent at all: any
    schedule carrying delay rules."""
    return bool(sc.schedule.delays)


def _member_seed(cfg: CampaignConfig, idx: int) -> int:
    """Deterministic per-member scenario seed from the campaign seed."""
    return hashing.hash64(idx, seed=cfg.seed & hashing.MASK64) & 0x7FFFFFFF


def _churn_draw(seed: int, headroom: int) -> Dict[str, int]:
    """The churn draw of a member that wants churn: the ``burst`` and
    ``start`` of its ``synthetic_churn_schedule``."""
    rng = random.Random(seed ^ 0xC4B0)
    burst = min(headroom, rng.choice((2, 4, 8)))
    return {"burst": burst, "start": rng.randint(5, 25)}


def _sample_scenario(cfg: CampaignConfig, idx: int) -> SampledScenario:
    """Draw member ``idx``'s scenario (seeded by the campaign seed),
    bounded by the settings' delivery-ring depth."""
    ring = (cfg.settings or Settings()).delivery_ring_depth
    return sample_adversary_schedule(cfg.n, _member_seed(cfg, idx),
                                     cfg.ticks,
                                     cfg.weights or DEFAULT_SCENARIO_WEIGHTS,
                                     ring_depth=ring)


def _lower_shared(cfg: CampaignConfig, settings: Settings, idx: int,
                  sc: SampledScenario, device="cuda"):
    """Lower one shared-state member on ``device``."""
    from rapid_tpu_torch.engine import churn as churn_mod
    from rapid_tpu_torch.engine.fleet import lower_schedule

    churn = id_fps = None
    if sc.wants_churn and cfg.headroom >= 2:
        churn, id_fps, _ = churn_mod.synthetic_churn_schedule(
            cfg.n + cfg.headroom, cfg.n, settings,
            **_churn_draw(_member_seed(cfg, idx), cfg.headroom))
    return lower_schedule(sc.schedule, settings, churn=churn,
                          id_fps=id_fps, device=device)


def _chunks(seq: List[int], size: int) -> List[List[int]]:
    return [seq[i:i + size] for i in range(0, len(seq), size)]


# --- kind-homogeneous dispatch pools --------------------------------------
#
# Stacking pads every member to the dispatch maxima; pools bucket members
# by which padded dimensions are live at all, so the maxima within a pool
# are tight. Signatures come from the sampled schedule alone, so the
# dispatch plan is known up front and deterministic in the campaign seed.

def _shared_dims(sc: SampledScenario) -> Tuple[int, int, int]:
    """(window_rows, fallback_instances, fallback_pids) a shared member
    lowers to (``fleet.lower_schedule``/``_compile_proposes``)."""
    values = {tuple(p.proposal) for p in sc.schedule.proposes}
    return (len(sc.schedule.windows), 1, max(1, len(values)))


def _rx_dims(sc: SampledScenario) -> Tuple[int, int]:
    """(window_rows, delay_rules) a per-receiver member lowers to."""
    return (len(sc.schedule.windows), len(sc.schedule.delays))


def _shared_pool_key(dims: Tuple[int, int, int]) -> Tuple[bool, bool]:
    """Shared shape signature: (has link windows, has contested pids)."""
    return (dims[0] > 0, dims[2] > 1)


def _rx_pool_key(dims: Tuple[int, int]) -> Tuple[bool, bool]:
    """Per-receiver shape signature: (has link windows, has delays)."""
    return (dims[0] > 0, dims[1] > 0)


def _pool_shape_dict(mode: str, shape: Tuple[int, ...]) -> Dict[str, int]:
    """A pool's stacking maxima in the padding-record key space."""
    if mode == "shared":
        return {"window_rows": shape[0], "fallback_instances": shape[1],
                "fallback_pids": shape[2], "delay_rules": 0}
    return {"window_rows": shape[0], "fallback_instances": 0,
            "fallback_pids": 0, "delay_rules": shape[1]}


def _build_pools(scenarios: List[SampledScenario], sh_idx: List[int],
                 rx_idx: List[int], f: int) -> List[Dict[str, object]]:
    """Group members into (mode, shape-signature) pools: shared first,
    then per-receiver, each by sorted signature, members in campaign
    index order; each pool's fleet size is capped at its membership."""
    pools: List[Dict[str, object]] = []

    def add(mode, idxs, dims_fn, key_fn):
        dims_map = {i: dims_fn(scenarios[i]) for i in idxs}
        groups: Dict[Tuple[bool, ...], List[int]] = {}
        for i in idxs:
            groups.setdefault(key_fn(dims_map[i]), []).append(i)
        for key in sorted(groups):
            members = groups[key]
            ndim = len(dims_map[members[0]])
            shape = tuple(max(dims_map[i][j] for i in members)
                          for j in range(ndim))
            pools.append({
                "pool_id": len(pools), "mode": mode, "members": members,
                "dims": {i: dims_map[i] for i in members},
                "shape": shape, "fleet_size": min(f, len(members)),
            })

    add("shared", sh_idx, _shared_dims, _shared_pool_key)
    add("per_receiver", rx_idx, _rx_dims, _rx_pool_key)
    return pools


def _plan(scenarios: List[SampledScenario], per_rx: bool, f: int):
    """Route the sampled members and plan the dispatches (shared with
    ``replay``): the per-receiver members, the pools and the ``(pool,
    chunk)`` dispatch plan."""
    rx_idx = [i for i, sc in enumerate(scenarios)
              if (per_rx and _receiver_eligible(sc)) or _delay_member(sc)]
    rx_set = set(rx_idx)
    sh_idx = [i for i in range(len(scenarios)) if i not in rx_set]
    pools = _build_pools(scenarios, sh_idx, rx_idx, f)
    plan = [(pool, chunk) for pool in pools
            for chunk in _chunks(pool["members"], pool["fleet_size"])]
    return rx_idx, pools, plan


def _spot_check(cfg: CampaignConfig, scenarios: List[SampledScenario],
                referee_settings: Settings, writer=None,
                progress: Optional[_ProgressWriter] = None,
                device="cuda") -> Dict[str, object]:
    """Replay a seeded member subset through the host referee:
    ``run_receiver_differential`` for per-receiver kinds (the engine on
    ``device``), ``run_adversarial_differential`` for the rest. Churn
    members are ineligible; a required kind missing from the campaign is
    drawn fresh from the campaign seed and checked as member ``-1``. A
    failing check writes a JSONL artifact and a ``passed=False`` record;
    the campaign aborts once failures exceed ``cfg.max_spot_failures``."""
    from rapid_tpu_torch.engine import diff
    from rapid_tpu_torch.engine.receiver import ReceiverEnvelopeError
    from rapid_tpu_torch.telemetry.forensics import DivergenceError
    from rapid_tpu_torch.telemetry.trace import wall_span

    requested = cfg.spot_checks
    block: Dict[str, object] = {"requested": requested, "run": 0,
                                "passed": 0, "failed": 0,
                                "max_failures": cfg.max_spot_failures,
                                "members": []}
    if requested <= 0:
        return block
    rng = random.Random(cfg.seed ^ 0x5EED)
    eligible = [i for i, sc in enumerate(scenarios) if not sc.wants_churn]
    chosen: List[Tuple[int, SampledScenario]] = []
    used = set()
    for kind in REQUIRED_SPOT_KINDS[:requested]:
        pool = [i for i in eligible
                if scenarios[i].kind == kind and i not in used]
        if pool:
            i = rng.choice(pool)
            used.add(i)
            chosen.append((i, scenarios[i]))
        else:  # tiny campaign without this kind: force one
            forced_seed = hashing.hash64(
                len(chosen), seed=(cfg.seed ^ 0xF0CE) & hashing.MASK64
            ) & 0x7FFFFFFF
            weights = ScenarioWeights(
                **{k: (1.0 if k == kind else 0.0)
                   for k in SCENARIO_KINDS})
            forced = sample_adversary_schedule(
                cfg.n, forced_seed, cfg.ticks, weights,
                ring_depth=referee_settings.delivery_ring_depth)
            chosen.append((-1, forced))
    rest = [i for i in eligible if i not in used]
    rng.shuffle(rest)
    for i in rest[:max(0, requested - len(chosen))]:
        chosen.append((i, scenarios[i]))

    art_dir = cfg.artifact_dir or tempfile.gettempdir()
    for idx, sc in chosen:
        per_rx = ((cfg.per_receiver and _receiver_eligible(sc))
                  or _delay_member(sc))
        artifact = os.path.join(
            art_dir, f"rapid_tpu_spot_m{idx}_{sc.kind}_"
                     f"{sc.schedule.seed}.jsonl")
        record: Dict[str, object] = {
            "member": idx, "kind": sc.kind, "seed": sc.schedule.seed,
            "mode": "per_receiver" if per_rx else "shared",
            "passed": True, "artifact": None, "error": None}
        block["run"] += 1
        try:
            with wall_span(writer, "spot_check",
                           {"member": idx, "kind": sc.kind,
                            "mode": record["mode"]}):
                if per_rx:
                    result = diff.run_receiver_differential(
                        sc.schedule, cfg.ticks, referee_settings,
                        device=device)
                else:
                    result = diff.run_adversarial_differential(
                        sc.schedule, cfg.ticks, referee_settings)
                result.assert_identical(artifact=artifact)
            block["passed"] += 1
        except (DivergenceError, ReceiverEnvelopeError) as err:
            record["passed"] = False
            record["artifact"] = artifact if os.path.exists(artifact) \
                else None
            record["error"] = str(err).splitlines()[0]
            block["failed"] += 1
        block["members"].append(record)
        if progress is not None:
            progress.emit({"record": "spot_check", "member": idx,
                           "kind": sc.kind, "passed": record["passed"],
                           "run": block["run"],
                           "requested": block["requested"],
                           "spot_failures": block["failed"]})
    if block["failed"] > cfg.max_spot_failures:
        bad = [m for m in block["members"] if not m["passed"]]
        raise RuntimeError(
            f"{block['failed']} spot-check divergence(s) exceed "
            f"--max-spot-failures={cfg.max_spot_failures}: "
            + "; ".join(
                f"member {m['member']} ({m['kind']}, seed {m['seed']}): "
                f"{m['error']}" + (f" [forensics: {m['artifact']}]"
                                   if m["artifact"] else "")
                for m in bad))
    return block


def _expected_block(s, meta: Dict[str, object]) -> Dict[str, object]:
    """The fields one member's replay must reproduce (``replay`` re-runs
    the member alone and diffs every field here against its fold)."""
    return {
        "ticks_to_first_announce": s.ticks_to_first_announce,
        "ticks_to_first_decide": s.ticks_to_first_decide,
        "announcements": s.announcements,
        "decisions": s.decisions,
        "invariant_violations": s.invariant_violations,
        "counter_totals": {
            "sent": s.total_sent, "delivered": s.total_delivered,
            "dropped": s.total_dropped, "timeouts": s.total_timeouts,
            "probes_sent": s.total_probes_sent,
            "probes_failed": s.total_probes_failed},
        "fallback_phase_sent": dict(s.fallback_phase_sent),
        "config_ids": list(meta["config_ids"]),
        "flags": meta["flags"],
    }


def _classic_rounds(s, n: int) -> int:
    """Estimated classic-Paxos rounds from phase-1a traffic (one round
    is one coordinator broadcast to n - 1 acceptors)."""
    p1a = int(s.fallback_phase_sent.get("phase1a", 0))
    return -(-p1a // max(1, n - 1)) if p1a else 0


def _triage(cfg: CampaignConfig, scenarios, summaries, member_order,
            member_meta, dists, spot) -> Dict[str, object]:
    """Classify every member into ``TRIAGE_CLASSES``; returns the
    ``campaign.triage`` block (the caller attaches recorder rings and
    lineage to the exemplars). Every field is seed-deterministic."""
    tail = dists.get("ticks_to_first_decide") or {}
    slow_thr = tail.get("p99")
    per_member_classes: Dict[int, List[str]] = {}

    def hits(s, meta, kind) -> List[str]:
        out = []
        if s.ticks_to_first_decide is None:
            out.append("no_decide_by_deadline")
        elif slow_thr is not None and s.ticks_to_first_decide > slow_thr:
            out.append("slow_decide")
        if s.invariant_violations:
            out.append("invariant_violations")
        if meta["flags"]:
            out.append("envelope_flags")
        classic = sum(int(s.fallback_phase_sent.get(p, 0))
                      for p in ("phase1a", "phase1b", "phase2a", "phase2b"))
        if classic and (kind not in EXPECTED_FALLBACK_KINDS
                        or _classic_rounds(s, cfg.n)
                        >= EXCESS_FALLBACK_ROUNDS):
            out.append("excess_fallback")
        return out

    classes: Dict[str, Dict[str, object]] = {
        name: {"count": 0, "by_kind": {}, "exemplars": []}
        for name in TRIAGE_CLASSES}
    for pos, i in enumerate(member_order):
        s, meta = summaries[pos], member_meta[pos]
        kind = scenarios[i].kind
        names = hits(s, meta, kind)
        if names:
            per_member_classes[i] = names
        for name in names:
            block = classes[name]
            block["count"] += 1
            block["by_kind"][kind] = block["by_kind"].get(kind, 0) + 1
            if len(block["exemplars"]) < MAX_TRIAGE_EXEMPLARS:
                block["exemplars"].append({
                    "dispatch": meta["dispatch"],
                    "member_index": meta["member_index"],
                    "member": i, "kind": kind, "mode": meta["mode"],
                    "seed": _member_seed(cfg, i),
                    "expected": _expected_block(s, meta),
                    "recorder": None,
                })

    ref_by_member = {i: (member_meta[pos]["dispatch"],
                         member_meta[pos]["member_index"],
                         member_meta[pos]["mode"])
                     for pos, i in enumerate(member_order)}
    sf = classes["spot_failures"]
    for rec in spot.get("members", ()):
        if rec["passed"]:
            continue
        i = rec["member"]
        d, j, mode = ref_by_member.get(i, (-1, -1, rec["mode"]))
        sf["count"] += 1
        sf["by_kind"][rec["kind"]] = sf["by_kind"].get(rec["kind"], 0) + 1
        if i >= 0:
            per_member_classes.setdefault(i, []).append("spot_failures")
        if len(sf["exemplars"]) < MAX_TRIAGE_EXEMPLARS:
            sf["exemplars"].append({
                "dispatch": d, "member_index": j, "member": i,
                "kind": rec["kind"], "mode": mode, "seed": rec["seed"],
                "expected": None, "recorder": None,
            })

    for block in classes.values():
        block["by_kind"] = dict(sorted(block["by_kind"].items()))
    recorder_cfg = None
    if cfg.flight_recorder:
        from rapid_tpu_torch.engine import recorder as recorder_lib

        recorder_cfg = {"window": cfg.flight_recorder,
                        "gauges": list(recorder_lib.GAUGE_NAMES)}
    return {
        "clusters": len(member_order),
        "flagged_members": len(per_member_classes),
        "thresholds": {"slow_decide_p99": slow_thr,
                       "excess_fallback_rounds": EXCESS_FALLBACK_ROUNDS},
        "recorder": recorder_cfg,
        "classes": classes,
    }


def _tensor_bytes(tree) -> int:
    """Bytes of every tensor leaf of a pytree, in the port's dtypes."""
    import torch
    from torch.utils import _pytree

    return sum(leaf.numel() * leaf.element_size()
               for leaf in _pytree.tree_leaves(tree)
               if torch.is_tensor(leaf))


def _host_copy(nt):
    """A NamedTuple of tensors with every leaf copied to the host."""
    return type(nt)(*[None if x is None else x.cpu() for x in nt])


def _memory(dev) -> Dict[str, object]:
    """The allocator's live bytes and peak on the card (0 and None on
    the CPU)."""
    import torch

    if dev.type != "cuda":
        return {"live_buffer_bytes": 0, "device_peak_bytes": None}
    return {"live_buffer_bytes": int(torch.cuda.memory_allocated(dev)),
            "device_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def _one_time_work(mode: str, dev) -> None:
    """The kernel build and load of a per-receiver pool's first dispatch
    on the card (a no-op once built)."""
    if mode == "per_receiver" and dev.type == "cuda":
        from rapid_tpu_torch.engine import rx_account

        rx_account._load()


def run_campaign(cfg: CampaignConfig, *, trace_path: Optional[str] = None,
                 progress_path: Optional[str] = None,
                 member_stats_out: Optional[List[Dict[str, object]]] = None,
                 device="cuda") -> Dict[str, object]:
    """Run one campaign on ``device``; returns the reference's schema-v12
    fleet run payload.

    The payload carries the fleet-merged ``telemetry``, the ``campaign``
    block (scenario-kind counts, pools, per-receiver block, spot checks,
    distributions, delay-regime tails, triage, lineage), one
    ``dispatch_timeline`` record per dispatch with its stage walls, the
    ``observatory`` and ``clusters_per_sec``. ``wall_s`` is the campaign
    wall without the spot checks (``spot_check_s``; ``total_s`` is the
    sum); the stage walls sum to it within
    ``schema.STAGE_SUM_TOLERANCE``. ``trace_path`` writes the stages as
    Perfetto wall-clock spans, ``progress_path`` a JSONL heartbeat
    (``-``: stderr); neither changes a non-wall field.
    """
    import torch

    from rapid_tpu_torch.device import resolve_device
    from rapid_tpu_torch.engine import receiver as receiver_mod
    from rapid_tpu_torch.engine import recorder as recorder_mod
    from rapid_tpu_torch.engine import rx_packed
    from rapid_tpu_torch.engine.fleet import (_require_no_mesh,
                                              check_receiver_budget,
                                              fleet_simulate,
                                              lower_receiver_schedule,
                                              member_of,
                                              receiver_fleet_simulate,
                                              stack_members,
                                              stack_receiver_members)
    from rapid_tpu_torch.telemetry.metrics import (fleet_summaries,
                                                   merge_summaries,
                                                   regime_distributions,
                                                   summarize,
                                                   summary_distributions)
    from rapid_tpu_torch.telemetry.schema import SCHEMA_VERSION
    from rapid_tpu_torch.telemetry.trace import TraceWriter, wall_span
    from rapid_tpu_torch.variants import VARIANTS

    dev = resolve_device(device)
    if cfg.protocol_variant not in VARIANTS:
        raise ValueError(f"protocol_variant must be one of {VARIANTS}, "
                         f"got {cfg.protocol_variant!r}")
    non_rapid = cfg.protocol_variant != "rapid"
    if non_rapid:
        w = cfg.weights or DEFAULT_SCENARIO_WEIGHTS
        hot = [k for k in DELAY_KINDS if getattr(w, k) > 0]
        if hot:
            raise ValueError(
                f"protocol_variant={cfg.protocol_variant!r} cannot run "
                f"latency-family members {hot}: delay schedules dispatch "
                f"through the per-receiver engine, which runs the "
                f"reference protocol only — zero the {DELAY_KINDS} "
                f"weights for variant campaigns")
        if cfg.spot_checks:
            raise ValueError(
                f"protocol_variant={cfg.protocol_variant!r} rejects "
                f"spot_checks={cfg.spot_checks}: the host referee replays "
                f"the reference protocol (use "
                f"engine.diff.run_variant_differential for variant "
                f"exactness)")
    if cfg.fleet_shard:
        _require_no_mesh(None, cfg.fleet_shard)

    base = cfg.settings or Settings()
    if base.protocol_variant != cfg.protocol_variant:
        base = base.with_(protocol_variant=cfg.protocol_variant)
    c = cfg.n + cfg.headroom
    settings = base if base.capacity == c else base.with_(capacity=c)
    referee_settings = base if base.capacity == 0 else base.with_(capacity=0)
    # Per-receiver members never churn, so they boot without the churn
    # headroom: the quadratic state is sized to N, not N + headroom.
    rx_settings = base if base.capacity == cfg.n \
        else base.with_(capacity=cfg.n)
    # The recorder rides the member settings only, not the referee's.
    if cfg.flight_recorder:
        settings = settings.with_(flight_recorder_window=cfg.flight_recorder)
        rx_settings = rx_settings.with_(
            flight_recorder_window=cfg.flight_recorder)
    f = max(1, cfg.fleet_size)
    # Sampled membership rounds up to whole fleets of f.
    total = -(-cfg.clusters // f) * f

    writer = TraceWriter() if trace_path else None
    progress = _ProgressWriter(progress_path)
    t_begin = time.perf_counter()

    # Stage walls are measured per member and attributed to each
    # member's dispatch, so the timeline shows what every dispatch cost.
    sample_s: Dict[int, float] = {}
    scenarios: List[SampledScenario] = []
    with wall_span(writer, "sample", {"clusters": total}):
        for i in range(total):
            t0 = time.perf_counter()
            scenarios.append(_sample_scenario(cfg, i))
            sample_s[i] = time.perf_counter() - t0
    # Non-rapid variants run the shared engine only.
    per_rx = cfg.per_receiver and not non_rapid
    rx_idx, pools, plan = _plan(scenarios, per_rx, f)

    # Spot checks run before any dispatch, outside ``wall_s``.
    t0 = time.perf_counter()
    spot = _spot_check(cfg, scenarios, referee_settings, writer=writer,
                       progress=progress, device=dev)
    spot_s = time.perf_counter() - t0
    # Budget refusal first: an oversized per-receiver fleet raises
    # ReceiverBudgetError before any member is lowered.
    fr = min(f, len(rx_idx)) if rx_idx else 0
    budget_s = 0.0
    if rx_idx:
        t0 = time.perf_counter()
        check_receiver_budget(max(rx_settings.capacity, cfg.n), fr,
                              rx_settings)
        # One-time work of the per-receiver mode (its first call counts
        # the layout's bytes on meta tensors): billed to the compile
        # stage of the first per-receiver dispatch.
        budget_s = time.perf_counter() - t0
    lower_s: Dict[int, float] = {}
    lowered: Dict[int, object] = {}
    timeline: List[Dict[str, object]] = []
    pool_compiles: Dict[int, Dict[str, object]] = {}
    summaries = []
    member_order: List[int] = []  # member index per summaries[] entry
    # Per-member triage inputs aligned with summaries: mode, (dispatch,
    # member_index) ref, sticky flags, final config ids; and the host copy
    # of each dispatch's recorder rings.
    member_meta: List[Dict[str, object]] = []
    dispatch_recs: Dict[int, object] = {}
    lineage_members: List[List[Dict[str, object]]] = []
    anomalies = {"no_decide_by_deadline": 0, "invariant_violations": 0,
                 "envelope_flags": 0}
    rx_dispatches = 0
    done = 0
    in_flight: List[Dict[str, object]] = []  # FIFO, launch order
    depth = PIPELINE_DEPTH if cfg.pipeline else 1
    peak_in_flight = 0
    launched = 0
    on_card = dev.type == "cuda"

    def _lower(mode, i, fsize):
        if mode == "shared":
            return _lower_shared(cfg, settings, i, scenarios[i], dev)
        return lower_receiver_schedule(scenarios[i].schedule, rx_settings,
                                       fleet_size=fsize, device=dev)

    def _launch(pool, chunk):
        """Lower and stack this dispatch and enqueue its run; the fence
        lives in ``_retire``."""
        nonlocal launched, peak_in_flight, budget_s
        mode, pid = pool["mode"], pool["pool_id"]
        fsize, shape, dims = pool["fleet_size"], pool["shape"], pool["dims"]
        d = launched
        launched += 1
        # Trailing partial chunks pad by cycling their own members so
        # every dispatch of a pool keeps the pool's shape; padded
        # members are dropped at fold.
        padded = chunk + [chunk[i % len(chunk)]
                          for i in range(fsize - len(chunk))]
        compile_s = 0.0
        compiled_now = pid not in pool_compiles
        if compiled_now:
            # The pool's one-time work: the kernel build on its first
            # per-receiver dispatch, and its first member's lowering,
            # which boots the pool's shape into the boot caches.
            if on_card:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            with wall_span(writer, "compile",
                           {"dispatch": d, "mode": mode, "pool": pid}):
                _one_time_work(mode, dev)
                lowered[chunk[0]] = _lower(mode, chunk[0], fsize)
                lower_s[chunk[0]] = 0.0
            compile_s = time.perf_counter() - t0
            if mode == "per_receiver":
                compile_s += budget_s
                budget_s = 0.0
            pool_compiles[pid] = {
                "pool_id": pid, "mode": mode, "lower_s": 0.0,
                "compile_s": compile_s,
                "base_bytes": (torch.cuda.memory_allocated(dev)
                               if on_card else 0)}
        with wall_span(writer, "lower",
                       {"dispatch": d, "mode": mode, "pool": pid,
                        "members": len(chunk)}):
            for i in chunk:
                if i in lowered:
                    continue
                t0 = time.perf_counter()
                lowered[i] = _lower(mode, i, fsize)
                lower_s[i] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with wall_span(writer, "stack",
                       {"dispatch": d, "mode": mode, "pool": pid}):
            if mode == "shared":
                fleet = stack_members([lowered[i] for i in padded],
                                      n_windows=shape[0],
                                      n_instances=shape[1],
                                      n_pids=shape[2])
            else:
                fleet = stack_receiver_members(
                    [lowered[i] for i in padded],
                    n_windows=shape[0], n_delay_rules=shape[1])
        stack_s = time.perf_counter() - t0
        # The lowered members are only inputs to the stack.
        for i in chunk:
            lowered.pop(i)
        if compiled_now:
            pool_compiles[pid]["argument_bytes"] = _tensor_bytes(fleet)
        t0 = time.perf_counter()
        if mode == "shared":
            result = fleet_simulate(fleet, cfg.ticks, settings, device=dev)
        else:
            result = receiver_fleet_simulate(fleet, cfg.ticks, rx_settings,
                                             device=dev)
        done_event = None
        if on_card:
            done_event = torch.cuda.Event()
            done_event.record()
        launch_s = time.perf_counter() - t0
        pad_dims = [dims[i] for i in padded]
        if mode == "shared":
            padding = {
                "window_rows": fsize * shape[0] - sum(
                    dd[0] for dd in pad_dims),
                "fallback_instances": fsize * shape[1] - sum(
                    dd[1] for dd in pad_dims),
                "fallback_pids": fsize * shape[2] - sum(
                    dd[2] for dd in pad_dims),
                "delay_rules": 0}
        else:
            padding = {
                "window_rows": fsize * shape[0] - sum(
                    dd[0] for dd in pad_dims),
                "fallback_instances": 0, "fallback_pids": 0,
                "delay_rules": fsize * shape[1] - sum(
                    dd[1] for dd in pad_dims)}
        in_flight.append({
            "index": d, "pool": pool, "chunk": chunk, "result": result,
            "fleet": fleet, "event": done_event,
            "compiled_now": compiled_now, "padding": padding,
            "stages": {"sample": sum(sample_s[i] for i in chunk),
                       "lower": sum(lower_s[i] for i in chunk),
                       "stack": stack_s, "compile": compile_s},
            "launch_s": launch_s})
        peak_in_flight = max(peak_in_flight, len(in_flight))

    def _retire(entry):
        """Wait for the oldest in-flight dispatch, fold it, and record
        it. Retirement is FIFO, so summaries, member order and timeline
        equal the serial loop's."""
        nonlocal rx_dispatches, done
        pool, chunk = entry["pool"], entry["chunk"]
        mode, pid, d = pool["mode"], pool["pool_id"], entry["index"]
        t0 = time.perf_counter()
        with wall_span(writer, "execute",
                       {"dispatch": d, "mode": mode, "pool": pid,
                        "fleet_size": pool["fleet_size"]}):
            if entry["event"] is not None:
                entry["event"].synchronize()
        wait_s = time.perf_counter() - t0
        entry.pop("fleet")
        result = entry.pop("result")
        if entry["compiled_now"]:
            info = pool_compiles[pid]
            info["output_bytes"] = _tensor_bytes(result)
            base = info.pop("base_bytes")
            peak = torch.cuda.max_memory_allocated(dev) - base \
                if on_card else 0
            info["peak_bytes"] = max(0, int(peak))
            info["temp_bytes"] = max(0, info["peak_bytes"]
                                     - info["argument_bytes"]
                                     - info["output_bytes"])
        if cfg.flight_recorder:
            finals, logs, recs = result
            # One host copy of the dispatch's recorder rings; triage
            # slices out the exemplars' rings at the end.
            dispatch_recs[d] = _host_copy(recs)
        else:
            finals, logs = result
        del result
        t0 = time.perf_counter()
        with wall_span(writer, "fold",
                       {"dispatch": d, "mode": mode, "pool": pid}):
            if mode == "shared":
                summaries.extend(fleet_summaries(logs)[:len(chunk)])
                cfg_hi = logs.config_hi[:len(chunk), -1].tolist()
                cfg_lo = logs.config_lo[:len(chunk), -1].tolist()
                fleet_cols = lineage_lib.engine_phase_columns(logs)
                for j in range(len(chunk)):
                    cid = int(cfg_hi[j]) << 32 | int(cfg_lo[j])
                    member_meta.append({
                        "dispatch": d, "member_index": j,
                        "mode": mode, "flags": 0,
                        "config_ids": [f"{cid:016x}"]})
                    lineage_members.append(
                        lineage_lib.fold_spans(fleet_cols.member(j)))
            else:
                rx_dispatches += 1
                # One host copy of the logs and of the finals' host-read
                # fields, then per member.
                view = _host_copy(receiver_mod.receiver_final_fields(finals))
                host_logs = _host_copy(logs)
                for j in range(len(chunk)):
                    mrs = member_of(view, j)
                    mlog = member_of(host_logs, j)
                    # A nonzero envelope flag voids the device-exact
                    # claim for this member; it lands in the triage
                    # ``envelope_flags`` class.
                    flags = int(mrs.flags)
                    cids = sorted(set(
                        receiver_mod.receiver_config_ids(mrs)[:cfg.n]))
                    member_meta.append({
                        "dispatch": d, "member_index": j,
                        "mode": mode, "flags": flags,
                        "config_ids": [f"{cid:016x}" for cid in cids]})
                    run = receiver_mod.receiver_run_payload(
                        mrs, mlog, cfg.n, cfg.ticks)
                    summaries.append(summarize(run.metrics()))
                    spans = lineage_lib.fold_spans(
                        lineage_lib.receiver_phase_columns(mlog))
                    sched = scenarios[chunk[j]].schedule
                    if sched.delays:
                        for sp in spans:
                            sp["critical_path"] = \
                                lineage_lib.receiver_critical_path(
                                    mlog, sp, sched)
                    lineage_members.append(spans)
            member_order.extend(chunk)
            for s, meta in zip(summaries[-len(chunk):],
                               member_meta[-len(chunk):]):
                if s.ticks_to_first_decide is None:
                    anomalies["no_decide_by_deadline"] += 1
                if s.invariant_violations:
                    anomalies["invariant_violations"] += 1
                if meta["flags"]:
                    anomalies["envelope_flags"] += 1
            memory = _memory(dev)
        fold_stage_s = time.perf_counter() - t0
        done += len(chunk)
        kinds: Dict[str, int] = {}
        for i in chunk:
            kinds[scenarios[i].kind] = kinds.get(scenarios[i].kind, 0) + 1
        stages = dict(entry["stages"])
        stages["execute"] = entry["launch_s"] + wait_s
        stages["fold"] = fold_stage_s
        wall = sum(stages.values())
        rec = {
            "index": len(timeline),
            "mode": mode,
            "pool_id": pid,
            "pool_shape": _pool_shape_dict(mode, pool["shape"]),
            "members": len(chunk),
            "pad_members": pool["fleet_size"] - len(chunk),
            "fleet_size": pool["fleet_size"],
            "kinds": dict(sorted(kinds.items())),
            "compiled": entry["compiled_now"],
            "stages": {k: round(v, 6) for k, v in stages.items()},
            "wall_s": round(wall, 6),
            "clusters_per_sec": _rate(len(chunk), wall),
            "host_blocked_frac": (
                (wall - stages["execute"]) / wall
                if wall >= MIN_MEASURABLE_WALL_S else None),
            "padding": entry["padding"],
            "memory": memory,
        }
        timeline.append(rec)
        events = sum(s.announcements + s.decisions
                     for s in summaries[-len(chunk):])
        progress.emit({"record": "dispatch", "index": rec["index"],
                       "mode": mode, "pool_id": pid,
                       "pool_shape": rec["pool_shape"],
                       "in_flight_dispatches": len(in_flight),
                       "clusters_done": done,
                       "clusters_total": total, "stages": rec["stages"],
                       "spot_failures": spot["failed"],
                       "anomalies": dict(anomalies),
                       "ticks_per_sec": _rate(len(chunk) * cfg.ticks, wall),
                       "events_per_sec": _rate(events, wall)})
        return rec

    # Launch each planned dispatch, retiring the oldest whenever the
    # in-flight queue is full (depth 1: serial; depth 2: double buffer).
    for pool, chunk in plan:
        _launch(pool, chunk)
        while len(in_flight) >= depth:
            _retire(in_flight.pop(0))
    while in_flight:
        _retire(in_flight.pop(0))

    boot_s = sum(sample_s.values()) + sum(lower_s.values())
    dispatches = len(plan)

    wall_s = time.perf_counter() - t_begin - spot_s
    compile_total = sum(r["stages"]["compile"] for r in timeline)
    device_busy_s = sum(r["stages"]["execute"] for r in timeline)
    fold_s = sum(r["stages"]["fold"] for r in timeline)
    host_blocked_s = max(0.0, wall_s - device_busy_s - compile_total)

    merged = merge_summaries(summaries)
    dists = summary_distributions(summaries)
    kinds: Dict[str, int] = {}
    for sc in scenarios:
        kinds[sc.kind] = kinds.get(sc.kind, 0) + 1

    # Ticks-to-first-decide tail per delay regime (its latency kind, or
    # "no_delay").
    regime_ticks: Dict[str, List[float]] = {}
    for i, s in zip(member_order, summaries):
        regime = scenarios[i].kind \
            if scenarios[i].kind in DELAY_KINDS else "no_delay"
        regime_ticks.setdefault(regime, [])
        if s.ticks_to_first_decide is not None:
            regime_ticks[regime].append(s.ticks_to_first_decide)
    delay_regimes = regime_distributions(regime_ticks)

    # Per-member tournament rows, sorted by campaign member index.
    if member_stats_out is not None:
        rows = []
        for pos, i in enumerate(member_order):
            s = summaries[pos]
            classic = sum(int(s.fallback_phase_sent.get(p, 0))
                          for p in ("phase1a", "phase1b",
                                    "phase2a", "phase2b"))
            rows.append({
                "member": i, "kind": scenarios[i].kind,
                "seed": _member_seed(cfg, i),
                "decided": s.ticks_to_first_decide is not None,
                "decide_tick": s.ticks_to_first_decide,
                "total_sent": s.total_sent,
                "fallback": classic > 0,
                "lineage_spans": lineage_members[pos],
            })
        rows.sort(key=lambda r: r["member"])
        member_stats_out.extend(rows)

    triage = _triage(cfg, scenarios, summaries, member_order, member_meta,
                     dists, spot)
    if cfg.flight_recorder:
        for block in triage["classes"].values():
            for ex in block["exemplars"]:
                recs = dispatch_recs.get(ex["dispatch"])
                if recs is not None and ex["member_index"] >= 0:
                    ex["recorder"] = recorder_mod.recorder_payload(
                        recorder_mod.member_recorder(
                            recs, ex["member_index"]))
    # Exemplars carry their member's lineage spans (null only for forced
    # spot-check refs that never ran in the fleet).
    lineage_by_ref = {
        (meta["dispatch"], meta["member_index"]): spans
        for meta, spans in zip(member_meta, lineage_members)}
    for block in triage["classes"].values():
        for ex in block["exemplars"]:
            ex["lineage"] = lineage_by_ref.get(
                (ex["dispatch"], ex["member_index"]))

    # Fleet-wide lineage tails plus per-kind and per-regime breakdowns.
    kind_spans: Dict[str, List[Dict[str, object]]] = {}
    regime_spans: Dict[str, List[Dict[str, object]]] = {}
    for pos, i in enumerate(member_order):
        kind = scenarios[i].kind
        regime = kind if kind in DELAY_KINDS else "no_delay"
        kind_spans.setdefault(kind, []).extend(lineage_members[pos])
        regime_spans.setdefault(regime, []).extend(lineage_members[pos])
    lineage_block = lineage_lib.lineage_summary(
        [sp for spans in lineage_members for sp in spans])
    lineage_block["by_kind"] = {
        k: lineage_lib.lineage_summary(v)
        for k, v in sorted(kind_spans.items())}
    lineage_block["by_regime"] = {
        k: lineage_lib.lineage_summary(v)
        for k, v in sorted(regime_spans.items())}

    progress.emit({"record": "campaign", "clusters_total": total,
                   "dispatches": len(timeline),
                   "wall_s": round(wall_s, 6),
                   "spot_failures": spot["failed"],
                   "anomalies": dict(anomalies),
                   "flagged_members": triage["flagged_members"]})
    progress.close()
    if writer is not None:
        writer.write(trace_path)

    pool_rows = [pool_compiles[pid] for pid in sorted(pool_compiles)]

    def _agg_compiles(mode):
        """Per-pool compile records of one mode summed; None when no pool
        of that mode ran."""
        rows = [p for p in pool_rows if p["mode"] == mode]
        if not rows:
            return None
        return {key: sum(r[key] for r in rows) for key in rows[0]
                if key not in ("pool_id", "mode")}

    compile_info: Dict[str, object] = {
        "shared": _agg_compiles("shared"),
        "per_receiver": _agg_compiles("per_receiver"),
        "pools": pool_rows,
    }

    pool_blocks = []
    for pool in pools:
        pkinds: Dict[str, int] = {}
        for i in pool["members"]:
            k = scenarios[i].kind
            pkinds[k] = pkinds.get(k, 0) + 1
        pool_blocks.append({
            "pool_id": pool["pool_id"],
            "mode": pool["mode"],
            "members": len(pool["members"]),
            "dispatches": -(-len(pool["members"]) // pool["fleet_size"]),
            "fleet_size": pool["fleet_size"],
            "kinds": dict(sorted(pkinds.items())),
            "shape": _pool_shape_dict(pool["mode"], pool["shape"]),
        })

    rx_kinds: Dict[str, int] = {}
    for i in rx_idx:
        k = scenarios[i].kind
        rx_kinds[k] = rx_kinds.get(k, 0) + 1
    rx_capacity = max(rx_settings.capacity, cfg.n)
    unpacked_bytes = receiver_mod.receiver_state_bytes(
        rx_capacity, base.K, ring_depth=base.delivery_ring_depth)
    rx_member_bytes = unpacked_bytes if base.rx_kernel == "xla" else \
        rx_packed.bundle_state_bytes(rx_capacity, rx_settings)
    per_receiver = {
        "enabled": per_rx,
        "members": len(rx_idx),
        "dispatches": rx_dispatches,
        "fleet_size": fr,
        "capacity": rx_capacity,
        "capacity_cap": base.receiver_capacity_cap,
        "ring_depth": base.delivery_ring_depth,
        "rx_kernel": base.rx_kernel,
        "member_state_bytes": rx_member_bytes,
        "member_state_bytes_unpacked": unpacked_bytes,
        "kinds": dict(sorted(rx_kinds.items())),
    }

    return {
        "bench": "engine_tick",
        "scenario": "fleet",
        "schema_version": SCHEMA_VERSION,
        "platform": "gpu" if on_card else "cpu",
        "n": cfg.n,
        "k": settings.K,
        "capacity": c,
        "ticks": cfg.ticks,
        "clusters": total,
        "fleet_size": f,
        "dispatches": dispatches,
        "boot_s": boot_s,
        "wall_s": wall_s,
        "fold_s": fold_s,
        "compile_s": compile_total,
        "device_busy_s": device_busy_s,
        "host_blocked_s": host_blocked_s,
        "spot_check_s": spot_s,
        "total_s": wall_s + spot_s,
        "ticks_per_sec": _rate(total * cfg.ticks, wall_s),
        "rounds_per_sec": _rate(merged.decisions, wall_s),
        "clusters_per_sec": _rate(total, wall_s),
        "announcements": merged.announcements,
        "decisions": merged.decisions,
        "telemetry": merged.as_dict(),
        "dispatch_timeline": timeline,
        "observatory": {
            "host_blocked_s": host_blocked_s,
            "device_busy_s": device_busy_s,
            "compile_s": compile_total,
            "host_blocked_frac": (host_blocked_s / wall_s
                                  if wall_s >= MIN_MEASURABLE_WALL_S
                                  else None),
            "device_busy_frac": (device_busy_s / wall_s
                                 if wall_s >= MIN_MEASURABLE_WALL_S
                                 else None),
            "overlap_headroom_s": min(host_blocked_s, device_busy_s),
            "min_measurable_wall_s": MIN_MEASURABLE_WALL_S,
            "compile": compile_info,
            "pipeline": {
                "enabled": cfg.pipeline,
                "max_in_flight": depth,
                "peak_in_flight": peak_in_flight,
            },
        },
        "campaign": {
            "seed": cfg.seed,
            "protocol_variant": cfg.protocol_variant,
            "clusters": total,
            # Everything ``replay`` needs to rebuild the sampled
            # schedules and the dispatch plan from this block alone.
            "n": cfg.n,
            "ticks": cfg.ticks,
            "headroom": cfg.headroom,
            "weights": dataclasses.asdict(
                cfg.weights or DEFAULT_SCENARIO_WEIGHTS),
            "flight_recorder": cfg.flight_recorder,
            "fleet_size": f,
            "dispatches": dispatches,
            "scenario_kinds": dict(sorted(kinds.items())),
            "pools": pool_blocks,
            "per_receiver": per_receiver,
            "spot_checks": spot,
            "distributions": dists,
            "delay_regimes": delay_regimes,
            "triage": triage,
            "lineage": lineage_block,
        },
    }


def run_tournament(cfg: CampaignConfig, variants: List[str], *,
                   trace_path: Optional[str] = None,
                   progress_path: Optional[str] = None,
                   device="cuda") -> Dict[str, object]:
    """A/B tournament: the same campaign once per protocol variant, on
    the same sampled members (the sampler never reads the variant).

    Returns the first variant's payload with a ``campaign.tournament``
    block: per variant its decide count, fallback members, total
    messages, decide-tick tail and lineage summary, and per kind the
    win/loss (the earlier first decide wins, any decide beats none, equal
    is a tie)."""
    from rapid_tpu_torch.telemetry.metrics import _dist

    if len(variants) < 2:
        raise ValueError(f"a tournament needs >= 2 variants, "
                         f"got {variants}")
    if len(set(variants)) != len(variants):
        raise ValueError(f"duplicate tournament variants: {variants}")

    payloads: Dict[str, Dict[str, object]] = {}
    stats: Dict[str, List[Dict[str, object]]] = {}
    for v in variants:
        vcfg = dataclasses.replace(cfg, protocol_variant=v)
        rows: List[Dict[str, object]] = []
        # Trace and progress ride the first variant only.
        first = v == variants[0]
        payloads[v] = run_campaign(
            vcfg, trace_path=trace_path if first else None,
            progress_path=progress_path if first else None,
            member_stats_out=rows, device=device)
        stats[v] = rows

    members = [r["member"] for r in stats[variants[0]]]
    for v in variants[1:]:
        assert [r["member"] for r in stats[v]] == members, \
            "tournament variants diverged on the sampled member set"

    per_variant: Dict[str, Dict[str, object]] = {}
    for v in variants:
        rows = stats[v]
        ticks = [r["decide_tick"] for r in rows if r["decided"]]
        per_variant[v] = {
            "decided": sum(r["decided"] for r in rows),
            "fallback_members": sum(r["fallback"] for r in rows),
            "total_messages": sum(r["total_sent"] for r in rows),
            "decide_ticks": _dist(ticks),
            "lineage": lineage_lib.lineage_summary(
                [sp for r in rows for sp in r["lineage_spans"]]),
        }

    win_loss: Dict[str, Dict[str, int]] = {}
    by_member: Dict[str, Dict[int, Dict[str, object]]] = {
        v: {r["member"]: r for r in stats[v]} for v in variants}
    for i, ref in zip(members, stats[variants[0]]):
        kind = ref["kind"]
        row = win_loss.setdefault(
            kind, {**{v: 0 for v in variants}, "tie": 0})
        keys = {v: ((0, by_member[v][i]["decide_tick"])
                    if by_member[v][i]["decided"] else (1, 0))
                for v in variants}
        best = min(keys.values())
        winners = [v for v in variants if keys[v] == best]
        if len(winners) == 1:
            row[winners[0]] += 1
        else:
            row["tie"] += 1

    payload = payloads[variants[0]]
    payload["campaign"]["tournament"] = {
        "variants": list(variants),
        "clusters": len(members),
        "per_variant": per_variant,
        "win_loss": dict(sorted(win_loss.items())),
    }
    return payload


def _parse_weights(text: str) -> ScenarioWeights:
    """``crash=1,partition=2,...`` -> ScenarioWeights (missing keys keep
    their defaults)."""
    kw = {}
    for part in text.split(","):
        if not part:
            continue
        key, _, val = part.partition("=")
        kw[key.strip()] = float(val)
    return ScenarioWeights(**kw)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Monte-Carlo fleet campaign over sampled fault "
                    "scenarios (see rapid_tpu_torch/campaign.py docstring)")
    parser.add_argument("--clusters", type=int, default=64,
                        help="sampled clusters (rounded up to a whole "
                             "number of dispatches)")
    parser.add_argument("--n", type=int, default=64,
                        help="initial members per cluster")
    parser.add_argument("--ticks", type=int, default=240)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--fleet-size", type=int, default=64,
                        help="clusters per dispatch (F)")
    parser.add_argument("--headroom", type=int, default=16,
                        help="dormant slots per cluster for churn joins")
    parser.add_argument("--spot-checks", type=int, default=0,
                        help="members replayed through the host referee "
                             "(run_adversarial_differential / "
                             "run_receiver_differential)")
    parser.add_argument("--max-spot-failures", type=int, default=0,
                        help="spot-check divergences tolerated before the "
                             "campaign aborts (default 0: any divergence "
                             "is fatal)")
    parser.add_argument("--spot-artifacts", type=str, default=None,
                        metavar="DIR",
                        help="directory for divergence forensics JSONL "
                             "artifacts (default: system temp dir)")
    parser.add_argument("--no-per-receiver", action="store_true",
                        help="run partition/flip-flop members on the "
                             "shared engine; latency members stay "
                             "per-receiver")
    parser.add_argument("--weights", type=_parse_weights, default=None,
                        metavar="K=W,...",
                        help="scenario mix over "
                             + ",".join(SCENARIO_KINDS)
                             + " (missing kinds keep their defaults)")
    parser.add_argument("--variant", type=str, default="rapid",
                        choices=("rapid", "ring", "hier"),
                        help="protocol variant every member runs; "
                             "non-rapid variants run the shared engine "
                             "only and reject latency weights and "
                             "--spot-checks")
    parser.add_argument("--tournament", type=str, default=None,
                        metavar="V1,V2[,...]",
                        help="A/B tournament over the listed variants "
                             "(e.g. 'rapid,ring'); overrides --variant")
    parser.add_argument("--out", type=str, default=None,
                        help="write the full payload JSON here")
    parser.add_argument("--trace", type=str, default=None, metavar="FILE",
                        help="write a Perfetto trace of the dispatch "
                             "stages")
    parser.add_argument("--progress", type=str, default=None,
                        metavar="FILE",
                        help="stream a JSONL heartbeat line per dispatch "
                             "(and per spot check); '-' streams to stderr")
    parser.add_argument("--pipeline", dest="pipeline", action="store_true",
                        default=True,
                        help="two dispatches in flight (default)")
    parser.add_argument("--no-pipeline", dest="pipeline",
                        action="store_false",
                        help="fence each dispatch before preparing the "
                             "next (same payload in every non-wall field)")
    parser.add_argument("--fleet-shard", type=int, default=None,
                        metavar="D",
                        help="shard each dispatch's fleet axis over D "
                             "devices (not supported by the port)")
    parser.add_argument("--flight-recorder", type=int, default=0,
                        metavar="W",
                        help="flight-recorder window: carry a [W, G] "
                             "gauge ring through every member's run and "
                             "embed the rings of triage exemplars")
    parser.add_argument("--rx-kernel", type=str, default="xla",
                        choices=("xla", "packed", "pallas"),
                        help="per-receiver carry layout: 'xla' (dense, "
                             "default) or 'packed'/'pallas' (bit-plane "
                             "carry); every layout delivers through the "
                             "CUDA kernel on the card")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; 'cpu' runs the "
                             "plain PyTorch path)")
    args = parser.parse_args(argv)

    settings = None
    if args.rx_kernel != "xla":
        settings = Settings(rx_kernel=args.rx_kernel)
    cfg = CampaignConfig(clusters=args.clusters, n=args.n, ticks=args.ticks,
                         seed=args.seed, fleet_size=args.fleet_size,
                         headroom=args.headroom, weights=args.weights,
                         spot_checks=args.spot_checks,
                         per_receiver=not args.no_per_receiver,
                         max_spot_failures=args.max_spot_failures,
                         artifact_dir=args.spot_artifacts,
                         pipeline=args.pipeline,
                         fleet_shard=args.fleet_shard,
                         flight_recorder=args.flight_recorder,
                         settings=settings,
                         protocol_variant=args.variant)
    if args.tournament:
        variants = [v.strip() for v in args.tournament.split(",")
                    if v.strip()]
        payload = run_tournament(cfg, variants, trace_path=args.trace,
                                 progress_path=args.progress,
                                 device=args.device)
    else:
        payload = run_campaign(cfg, trace_path=args.trace,
                               progress_path=args.progress,
                               device=args.device)
    if args.out:
        from rapid_tpu_torch.telemetry import write_json_artifact

        write_json_artifact(args.out, payload, indent=2)
    # The last stdout line is the machine-readable payload.
    print(json.dumps(payload), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
