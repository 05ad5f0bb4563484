"""Resident engine: the shared tick loop as a long-lived, chunked service.

The port of the reference's ``service.resident``. Rapid itself
(``Cluster.Builder``) is a resident process serving live join and leave
traffic; this module runs the engine that way:

- the stream runs as fixed-size chunks (``Settings.stream_chunk_ticks``)
  through ``engine.step.simulate_chunk``, each from the previous chunk's
  final carry, the flight recorder carried across;
- dispatch keeps the reference's order: chunk ``k`` is dispatched
  *before* chunk ``k-1``'s logs are drained (folded into metrics, JSONL,
  SLO and lineage, status frames), so records and the live-buffer
  watermark mean what they mean there. The port's tick loop reads the
  card on every tick it branches on, so a dispatch returns when its
  chunk has almost run: the two overlap little. A chunk's ``wall_s`` is
  therefore counted as its dispatch, its fence wait and the previous
  drain's host folding (``_Resident._drain``), which is what the
  reference's drain-to-drain wall holds. ``timing`` keeps per chunk the
  host seconds of the dispatch, the CUDA-event span of its device work
  and the seconds the drain waited on its fence;
- there is no donation in PyTorch: each chunk's carry is new tensors and
  the old one is freed when the service drops it. The watermark
  (``torch.cuda.memory_allocated`` on the card; on the CPU the bytes of
  the live carry, recorder and pending logs) is the check that memory
  stays flat;
- an attached :class:`~rapid_tpu_torch.service.traffic.TrafficGenerator`
  lowers its next window of arrivals into each chunk's ``ChurnSchedule``
  (quiet windows reuse one inert all-``I32_MAX`` schedule);
- :meth:`ResidentEngine.save` / :meth:`ResidentEngine.restore` move the
  whole service through ``service.checkpoint`` (engine state, recorder
  ring mid-fill, and the traffic, servo, SLO and lineage state in the
  ``host`` blob), and :meth:`verify_round_trip` proves a restore exact:
  restored tensors equal the live ones, and one continuation chunk run
  from both gives equal ``StepLog`` columns, finals and recorder rings.

The metrics stream is JSONL: one ``TickMetrics`` row per tick
(optional), one ``record: "chunk"`` heartbeat per chunk, one final
``record: "stream_summary"`` line, in the reference's keys, validated by
``telemetry.schema.validate_streaming_stream``. ``compile_s`` (chunk 0
and the summary) is the first dispatch's one-time work: the port builds
no program, so it is the boot caches' and, on the receiver, the kernel
build's seconds.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from rapid_tpu_torch.campaign import _rate
from rapid_tpu_torch.convert import from_reference
from rapid_tpu_torch.device import read_arrays, resolve_device
from rapid_tpu_torch.engine import churn as churn_mod
from rapid_tpu_torch.engine.state import (I32_MAX, EngineFaults, EngineState,
                                          crash_faults, init_state)
from rapid_tpu_torch.engine.step import simulate_chunk
from rapid_tpu_torch.identity import synthetic_uids
from rapid_tpu_torch.service import checkpoint as checkpoint_mod
from rapid_tpu_torch.service.servo import LoadServo
from rapid_tpu_torch.service.status import StatusPublisher
from rapid_tpu_torch.service.traffic import TrafficConfig, TrafficGenerator
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry import (engine_metrics, json_artifact_line,
                                       summarize)
from rapid_tpu_torch.telemetry.lineage import LineageFold, lineage_summary
from rapid_tpu_torch.telemetry.metrics import _dist
from rapid_tpu_torch.telemetry.slo import SloWindows, ViewChangeFold

__all__ = ["ResidentEngine", "boot_resident", "synthetic_uids"]


def _leaves(tree) -> list:
    """The tensors of a NamedTuple tree in field order (None skipped)."""
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [tree]
    out = []
    for x in tree:
        out.extend(_leaves(x))
    return out


def _tree_equal(a, b) -> bool:
    """Bitwise equality of two NamedTuple trees of tensors."""
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and bool(torch.equal(x, y.to(x.device)))
        for x, y in zip(la, lb))


def _tree_bytes(*trees) -> int:
    return sum(t.numel() * t.element_size() for tree in trees
               for t in _leaves(tree))


class _Fence:
    """Stands in for ``jax.block_until_ready``: on the card a CUDA event
    recorded after a chunk's work (and one before it, so the chunk's
    device span can be read); on the CPU the work is done on return."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.start = self.end = None
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(device))

    def close(self) -> "_Fence":
        if self.cuda:
            self.end = torch.cuda.Event(enable_timing=True)
            self.end.record(torch.cuda.current_stream(device=self.device))
        return self

    def wait(self) -> float:
        """Block until the chunk's work is done; returns the seconds
        waited."""
        if not self.cuda:
            return 0.0
        t0 = time.perf_counter()
        self.end.synchronize()
        return time.perf_counter() - t0

    def device_s(self) -> Optional[float]:
        """Seconds from the chunk's first to its last device work (after
        ``wait``); None on the CPU."""
        if not self.cuda:
            return None
        return self.start.elapsed_time(self.end) / 1e3


class _Resident:
    """What the shared and the per-receiver resident services share: the
    sink, the dispatch-before-drain loop, the fences, the per-chunk
    timing and the live-buffer watermark."""

    def _init_stream(self, device, sink: Optional[str]) -> None:
        self.device = device
        self._sink = open(sink, "w") if sink else None
        self._pending = None
        self._draining = None
        self.chunk_records: list = []
        self.timing: list = []
        self.chunks = 0
        self.ticks = 0
        self.checkpoint_block: Optional[dict] = None
        self.compile_s: Optional[float] = None
        self._dispatches = 0
        self._wall0 = time.perf_counter()
        self._fold_s = 0.0
        self._watermarks: list = []

    def _emit(self, record: dict) -> None:
        if self._sink is not None:
            self._sink.write(json_artifact_line(record, sort_keys=True))
            self._sink.flush()

    def _one_time(self) -> Optional[float]:
        """Seconds of the first dispatch's one-time work (``_warm``),
        None on every later dispatch."""
        self._dispatches += 1
        if self._dispatches > 1:
            return None
        t0 = time.perf_counter()
        self._warm()
        self.compile_s = time.perf_counter() - t0
        return self.compile_s

    def _warm(self) -> None:
        """One-time work before the first chunk (nothing by default)."""

    def _live_buffer_bytes(self) -> int:
        if self.device.type == "cuda":
            return int(torch.cuda.memory_allocated(self.device))
        pending = self._pending["logs"] if self._pending else None
        draining = self._draining["logs"] if self._draining else None
        return _tree_bytes(self._carry_tree(), self._rec, pending, draining)

    def _drain(self, pending: dict) -> None:
        """Wait for ``pending``'s chunk and fold it (``_record``).

        A chunk's ``wall_s`` is its dispatch (the tick loop, the device
        work included, the one-time work not), its fence wait, and the
        host folding of the chunk drained before it: what the reference's
        drain-to-drain wall holds, where a dispatch returns at once and
        the drain waits for the device."""
        waited = pending["fence"].wait()
        wall = pending["dispatch_s"] + waited + self._fold_s
        t0 = time.perf_counter()
        self.timing.append({"index": pending["index"],
                            "dispatch_s": pending["dispatch_s"],
                            "fence_s": waited,
                            "device_s": pending["fence"].device_s()})
        self._record(pending, wall)
        self._fold_s = time.perf_counter() - t0

    def flush(self) -> None:
        """Drain the in-flight chunk, if any."""
        if self._pending is not None:
            self._draining, self._pending = self._pending, None
            self._drain(self._draining)
            self._draining = None

    def run(self, n_chunks: int) -> None:
        """Run ``n_chunks`` chunks: chunk ``k`` is dispatched before chunk
        ``k-1``'s host I/O runs."""
        for _ in range(int(n_chunks)):
            dispatched = self._dispatch()
            self._draining, self._pending = self._pending, dispatched
            if self._draining is not None:
                self._drain(self._draining)
                self._draining = None
        self.flush()

    def _watermark_block(self) -> dict:
        marks = self._watermarks
        return {
            "first": marks[0] if marks else None,
            "max": max(marks) if marks else None,
            # ``steady_max`` leaves out verify-round-trip chunks, which
            # hold the live and the restored branch at once; the
            # flat-memory gate reads it.
            "steady_max": max(
                (r["live_buffer_bytes"] for r in self.chunk_records
                 if not r["checkpoint"]), default=None),
            "last": marks[-1] if marks else None,
        }

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None
        if self.status is not None:
            self.status.close()
            self.status = None


class ResidentEngine(_Resident):
    """One resident shared-state engine plus its I/O loop.

    ``sink`` (a path or None) receives the JSONL metrics stream;
    ``write_ticks=False`` keeps only chunk heartbeats and the summary.
    The engine runs on the device its state lives on. ``donate`` is
    accepted for the reference's callers; nothing is donated.
    """

    def __init__(self, state: EngineState, faults: EngineFaults,
                 settings: Settings, *,
                 traffic: Optional[TrafficGenerator] = None,
                 servo: Optional[LoadServo] = None,
                 slo: Optional[SloWindows] = None,
                 status: Optional[StatusPublisher] = None,
                 sink: Optional[str] = None, write_ticks: bool = True,
                 donate: bool = True, n_initial: Optional[int] = None):
        del donate
        self.settings = settings
        self.capacity = int(state.member.shape[0])
        self.n_initial = (int(read_arrays(state.member)[0].sum())
                          if n_initial is None else int(n_initial))
        self._state = state
        self._rec = None
        self._faults = faults
        self.traffic = traffic
        if servo is not None and traffic is None:
            raise ValueError("a servo needs an attached traffic generator")
        self.servo = servo
        self.slo = slo
        self._vc_fold = ViewChangeFold(0) if slo is not None else None
        # Lineage rides the same drained gauge rows as the SLO fold; the
        # rolling window matches the SLO window so a heartbeat's lineage
        # block decomposes the same chunks the slo block summarises.
        self._lineage = LineageFold(0)
        self.lineage_spans: list = []
        self._lineage_window: deque = deque(
            maxlen=slo.window_chunks if slo is not None else 8)
        self.status = status
        self._inert_schedule = (
            from_reference(churn_mod.empty_schedule(self.capacity),
                           state.member.device)
            if traffic is not None else None)
        self._write_ticks = write_ticks
        self.metrics: list = []
        self._init_stream(state.member.device, sink)

    @property
    def state(self) -> EngineState:
        """The current carry (chunk-boundary accurate after ``flush``)."""
        return self._state

    def _carry_tree(self):
        return self._state

    # --- internals --------------------------------------------------------

    def _next_schedule(self):
        if self.traffic is None:
            return None, None
        if self.servo is not None:
            # The committed rate from the last drained heartbeat drives
            # this whole chunk; closed-loop sampling keeps the rng
            # stream advancement identical whatever the rate.
            self.traffic.set_join_rate(self.servo.rate_per_ktick)
        schedule, tinfo = self.traffic.next_chunk(
            self.settings.stream_chunk_ticks)
        if schedule is None:
            return self._inert_schedule, tinfo
        return from_reference(schedule, self.device), tinfo

    def _chunk(self, state, rec, schedule):
        out = simulate_chunk(state, self._faults,
                             self.settings.stream_chunk_ticks, self.settings,
                             churn=schedule, rec=rec, device=self.device)
        if self.settings.flight_recorder_window:
            return out
        return out[0], out[1], None

    def _dispatch(self) -> dict:
        compile_s = self._one_time()
        schedule, tinfo = self._next_schedule()
        applied_rate = (self.servo.rate_per_ktick
                        if self.servo is not None else None)
        t0 = time.perf_counter()
        fence = _Fence(self.device)
        self._state, logs, self._rec = self._chunk(self._state, self._rec,
                                                   schedule)
        pending = {"index": self.chunks, "logs": logs, "tinfo": tinfo,
                   "checkpoint": None, "compile_s": compile_s,
                   "servo_rate": applied_rate, "fence": fence.close(),
                   "dispatch_s": time.perf_counter() - t0}
        self.chunks += 1
        self.ticks += self.settings.stream_chunk_ticks
        return pending

    def _record(self, pending: dict, wall: float) -> None:
        compile_s = pending["compile_s"]
        rows = engine_metrics(pending["logs"])
        self.metrics.extend(rows)
        if self._write_ticks:
            for row in rows:
                self._emit(row.as_dict())
        live = self._live_buffer_bytes()
        self._watermarks.append(live)
        tinfo = pending["tinfo"]
        backlog = ((tinfo["backlog_joins"] + tinfo["backlog_leaves"])
                   if tinfo else None)
        servo_block = None
        if self.servo is not None:
            self.servo.observe(ticks=self.settings.stream_chunk_ticks,
                               wall_s=wall, backlog=backlog or 0)
            servo_block = self.servo.chunk_block(pending["servo_rate"])
        slo_block = None
        if self.slo is not None:
            slo_block = self.slo.fold_chunk(self._vc_fold.fold(rows))
        new_spans = self._lineage.fold(rows)
        self.lineage_spans.extend(new_spans)
        self._lineage_window.append(new_spans)
        lineage_block = lineage_summary(
            [sp for chunk in self._lineage_window for sp in chunk])
        record = {
            "record": "chunk",
            "index": pending["index"],
            "tick": rows[-1].tick if rows else self.ticks,
            "ticks": self.settings.stream_chunk_ticks,
            "wall_s": wall,
            "compile_s": compile_s,
            "ticks_per_sec": _rate(self.settings.stream_chunk_ticks, wall),
            "events_per_sec": _rate(tinfo["events"], wall) if tinfo else None,
            "announces": sum(r.announce for r in rows),
            "decides": sum(r.decide for r in rows),
            "live_buffer_bytes": live,
            "traffic": tinfo,
            "servo": servo_block,
            "slo": slo_block,
            "lineage": lineage_block,
            "checkpoint": pending["checkpoint"],
        }
        self.chunk_records.append(record)
        self._emit(record)
        if self.status is not None:
            self.status.publish(self._status_snapshot(record, rows))

    def _status_snapshot(self, record: dict, rows) -> dict:
        """The chunk-boundary ``status_snapshot`` block, built from
        already-drained host data only, so publishing can never perturb
        the protocol stream."""
        from rapid_tpu_torch.telemetry.schema import SCHEMA_VERSION

        last = rows[-1] if rows else None
        tinfo = record["traffic"]
        backlog = ((tinfo["backlog_joins"] + tinfo["backlog_leaves"])
                   if tinfo else None)
        return {
            "record": "status_snapshot",
            "schema_version": SCHEMA_VERSION,
            "source": "resident",
            "tick": record["tick"],
            "chunks": self.chunks,
            "epoch": int(last.epoch) if last is not None else -1,
            "n_members": (int(last.n_member)
                          if last is not None else self.n_initial),
            "ticks_per_sec": record["ticks_per_sec"],
            "events_per_sec": record["events_per_sec"],
            "backlog": backlog,
            "live_buffer_bytes": record["live_buffer_bytes"],
            "servo": record["servo"],
            "slo": record["slo"],
            "lineage": record["lineage"],
            "checkpoint": self.checkpoint_block,
            "wall_s": time.perf_counter() - self._wall0,
        }

    # --- checkpoint/restore ----------------------------------------------

    def _host_blob(self) -> dict:
        blob = {"chunks": self.chunks, "ticks": self.ticks,
                "n_initial": self.n_initial}
        if self.traffic is not None:
            blob["traffic"] = self.traffic.state_dict()
        if self.servo is not None:
            blob["servo"] = self.servo.state_dict()
        if self.slo is not None:
            blob["slo"] = self.slo.state_dict()
            blob["vc_fold"] = self._vc_fold.state_dict()
        blob["lineage"] = {"fold": self._lineage.state_dict(),
                           "spans": self.lineage_spans,
                           "window": [list(c) for c in self._lineage_window]}
        return blob

    def save(self, path: str) -> dict:
        """Checkpoint the whole service (engine carry, recorder ring,
        traffic generator); drains the in-flight chunk first so the
        saved carry is a chunk boundary."""
        self.flush()
        return checkpoint_mod.save_engine(
            path, self._state, self.settings, rec=self._rec,
            host=self._host_blob())

    @classmethod
    def restore(cls, path: str, faults: EngineFaults, settings: Settings,
                device="cuda", **kw) -> "ResidentEngine":
        """The service from a checkpoint of either package, on
        ``device`` (where ``faults`` must live)."""
        cp = checkpoint_mod.load_checkpoint(path, settings, device=device)
        if cp.family != "engine":
            raise checkpoint_mod.CheckpointError(
                f"ResidentEngine.restore needs an engine checkpoint, "
                f"got family {cp.family!r}")
        host = cp.host or {}
        traffic = kw.pop("traffic", None)
        if traffic is None and "traffic" in host:
            traffic = TrafficGenerator.from_state(host["traffic"], settings)
        servo = kw.pop("servo", None)
        if servo is None and "servo" in host:
            servo = LoadServo.from_state(host["servo"])
        slo = kw.pop("slo", None)
        if slo is None and "slo" in host:
            slo = SloWindows.from_state(host["slo"])
        eng = cls(cp.parts["state"], faults, settings, traffic=traffic,
                  servo=servo, slo=slo,
                  n_initial=host.get("n_initial"), **kw)
        if eng.slo is not None and "vc_fold" in host:
            eng._vc_fold = ViewChangeFold.from_state(host["vc_fold"])
        if "lineage" in host:
            lin = host["lineage"]
            eng._lineage = LineageFold.from_state(lin["fold"])
            eng.lineage_spans = list(lin["spans"])
            for chunk in lin["window"]:
                eng._lineage_window.append(list(chunk))
        eng._rec = cp.parts.get("recorder")
        eng.chunks = int(host.get("chunks", 0))
        eng.ticks = int(host.get("ticks", cp.tick))
        return eng

    def verify_round_trip(self, path: str) -> dict:
        """Save, restore, and prove the restore exact; returns the
        ``checkpoint`` block the summary embeds.

        Two layers of proof: (a) every restored tensor equals its live
        twin; (b) one continuation chunk run from the live carry and from
        the restored carry (the same traffic window) gives equal
        ``StepLog`` columns, final states and recorder rings. The
        restored branch then becomes the stream, so a stream that passes
        through this is itself evidence that a restore loses nothing.
        """
        self.flush()
        t0 = time.perf_counter()
        fence = _Fence(self.device)
        self.save(path)
        cp = checkpoint_mod.load_checkpoint(path, self.settings,
                                            device=self.device)
        r_state = cp.parts["state"]
        r_rec = cp.parts.get("recorder")
        state_identical = _tree_equal(self._state, r_state)
        recorder_identical = (_tree_equal(self._rec, r_rec)
                              if self._rec is not None else None)

        schedule, tinfo = self._next_schedule()
        l_final, l_logs, l_rec = self._chunk(self._state, self._rec,
                                             schedule)
        r_final, r_logs, r_rec2 = self._chunk(r_state, r_rec, schedule)
        dispatch_s = time.perf_counter() - t0
        cont_rec_ok = (_tree_equal(l_rec, r_rec2)
                       if self.settings.flight_recorder_window else None)
        block = {
            "version": checkpoint_mod.CHECKPOINT_VERSION,
            "tick": cp.tick,
            "state_identical": bool(state_identical),
            "recorder_identical": recorder_identical,
            "logs_identical": bool(_tree_equal(l_logs, r_logs)),
            "final_identical": bool(_tree_equal(l_final, r_final)),
            "continuation_recorder_identical": cont_rec_ok,
        }
        # Adopt the restored branch as the continuing carry.
        self._state, self._rec = r_final, r_rec2
        del l_final, l_logs, l_rec
        pending = {"index": self.chunks, "logs": r_logs, "tinfo": tinfo,
                   "checkpoint": block, "compile_s": None,
                   "servo_rate": (self.servo.rate_per_ktick
                                  if self.servo is not None else None),
                   "fence": fence.close(), "dispatch_s": dispatch_s}
        self.chunks += 1
        self.ticks += self.settings.stream_chunk_ticks
        self._draining = pending
        self._drain(pending)
        self._draining = None
        self.checkpoint_block = block
        return block

    # --- summary ----------------------------------------------------------

    def summary(self) -> dict:
        """The final ``record: "stream_summary"`` line (also written to
        the sink): protocol totals, sustained rates, decide-latency
        tails, the live-buffer watermark, and the checkpoint proof."""
        from rapid_tpu_torch.telemetry.schema import SCHEMA_VERSION

        self.flush()
        s = summarize(self.metrics) if self.metrics else None
        ttvc = [vc["ticks_to_decide"] for vc in s.view_changes] if s else []
        wall = time.perf_counter() - self._wall0
        record = {
            "record": "stream_summary",
            "schema_version": SCHEMA_VERSION,
            "source": "resident",
            "n": self.n_initial,
            "capacity": self.capacity,
            "ticks": self.ticks,
            "chunks": self.chunks,
            "chunk_ticks": self.settings.stream_chunk_ticks,
            "events_injected": self.traffic.events if self.traffic else 0,
            "joins": self.traffic.joins if self.traffic else 0,
            "leaves": self.traffic.leaves if self.traffic else 0,
            "bursts": self.traffic.bursts if self.traffic else 0,
            "announcements": s.announcements if s else 0,
            "decisions": s.decisions if s else 0,
            "wall_s": wall,
            "compile_s": self.compile_s,
            "ticks_per_sec": _rate(self.ticks, wall),
            "events_per_sec": _rate(
                self.traffic.events if self.traffic else 0, wall),
            "ticks_to_view_change": _dist(ttvc),
            "lineage": lineage_summary(self.lineage_spans),
            "servo": ({"config": self.servo.config.as_dict(),
                       "final": self.servo.chunk_block(
                           self.servo.rate_per_ktick)}
                      if self.servo is not None else None),
            "slo": self.slo.block() if self.slo is not None else None,
            "live_buffer_bytes": self._watermark_block(),
            "traffic": self.traffic.config.as_dict() if self.traffic
            else None,
            "checkpoint": self.checkpoint_block,
        }
        self._emit(record)
        return record


def boot_resident(settings: Settings, capacity: int, n_initial: int, *,
                  seed: int = 0,
                  traffic_config: Optional[TrafficConfig] = None,
                  servo: Optional[LoadServo] = None,
                  slo: Optional[SloWindows] = None,
                  status: Optional[StatusPublisher] = None,
                  sink: Optional[str] = None, write_ticks: bool = True,
                  donate: bool = True, device="cuda") -> ResidentEngine:
    """Boot a converged ``n_initial``-member cluster with a dormant
    joiner pool and (optionally) an attached traffic generator, on
    ``device``."""
    dev = resolve_device(device)
    traffic = None
    id_fps = None
    if traffic_config is not None:
        traffic = TrafficGenerator(traffic_config, settings, capacity,
                                   n_initial)
        id_fps = traffic.boot_id_fps()
    uids = synthetic_uids(capacity, seed)
    member = np.zeros(capacity, bool)
    member[:n_initial] = True
    state = init_state(uids, id_fp_sum=0, settings=settings, member=member,
                       id_fps=id_fps, device=dev)
    faults = crash_faults([I32_MAX] * capacity, device=dev)
    return ResidentEngine(state, faults, settings, traffic=traffic,
                          servo=servo, slo=slo, status=status,
                          sink=sink, write_ticks=write_ticks, donate=donate,
                          n_initial=n_initial)
