"""Receiver-resident service: the per-receiver loop as a chunked stream.

The port of the reference's ``service.rx_resident``, the per-receiver
twin of ``ResidentEngine`` (it shares the chunk loop, the fences and
the watermark of ``service.resident``):

- the stream runs as fixed-size chunks over the layout-preserving carry
  (``engine.receiver.receiver_simulate_chunk``): a dense
  ``ReceiverState`` under ``rx_kernel="xla"``, an
  ``rx_packed.PackedReceiverBundle`` under the packed layouts, fed back
  as it is every chunk, so a soak holds one working set on the card;
- every chunk delivers through the CUDA kernel ``rx_deliver``, 6
  launches a tick, under every layout;
- chunk heartbeats are ``record: "chunk"`` with ``traffic``/``servo``
  null (the receiver wire has no churn generator), carrying the rolling
  ``slo`` block folded per slot by ``telemetry.slo
  .ReceiverViewChangeFold``;
- :meth:`verify_round_trip` checkpoints mid-soak through the
  ``receiver_dense``/``receiver_packed`` families and proves the restore
  exact the same two ways as ``ResidentEngine``, then adopts the restored
  branch as the continuing carry.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Optional

from rapid_tpu_torch.device import read_arrays
from rapid_tpu_torch.engine.receiver import receiver_simulate_chunk
from rapid_tpu_torch.faults import two_zone_schedule
from rapid_tpu_torch.service import checkpoint as checkpoint_mod
from rapid_tpu_torch.service.resident import (_Fence, _Resident, _rate,
                                              _tree_equal)
from rapid_tpu_torch.service.status import StatusPublisher
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry.lineage import (LineageFold, lineage_summary,
                                               receiver_phase_columns)
from rapid_tpu_torch.telemetry.metrics import _dist
from rapid_tpu_torch.telemetry.slo import ReceiverViewChangeFold, SloWindows


def _carry_device(carry):
    return (carry.packed.member.device if hasattr(carry, "packed")
            else carry.member.device)


class ResidentReceiver(_Resident):
    """One resident per-receiver member plus its I/O loop.

    ``chunk_ticks`` is the receiver's chunk length, a service parameter
    rather than a layout setting: per-receiver ticks at large C cost far
    more wall than shared ticks. The member runs on the device its carry
    lives on. ``donate`` is accepted for the reference's callers.
    """

    def __init__(self, carry, faults, settings: Settings, *,
                 capacity: int, chunk_ticks: int,
                 slo: Optional[SloWindows] = None,
                 status: Optional[StatusPublisher] = None,
                 sink: Optional[str] = None, donate: bool = True):
        del donate
        if chunk_ticks < 1:
            raise ValueError(f"chunk_ticks must be >= 1, got {chunk_ticks}")
        self.settings = settings
        self.capacity = int(capacity)
        self.chunk_ticks = int(chunk_ticks)
        self._carry = carry
        self._faults = faults
        self._rec = None
        self.slo = slo
        self._vc_fold = (ReceiverViewChangeFold(self.capacity)
                         if slo is not None else None)
        self._lineage = LineageFold(0)
        self.lineage_spans: list = []
        self._lineage_window: deque = deque(
            maxlen=slo.window_chunks if slo is not None else 8)
        self.status = status
        self.announces = 0
        self.decides = 0
        self._ttvc: list = []
        self._init_stream(_carry_device(carry), sink)

    @property
    def carry(self):
        """The current carry (chunk-boundary accurate after ``flush``)."""
        return self._carry

    def _carry_tree(self):
        return self._carry

    # --- internals --------------------------------------------------------

    def _warm(self) -> None:
        """The kernel build and load on the card: the port's one-time
        work, billed as the first chunk's ``compile_s``."""
        if self.device.type == "cuda":
            from rapid_tpu_torch.engine import rx_account

            rx_account._load()

    def _chunk(self, carry, rec):
        out = receiver_simulate_chunk(carry, self._faults, self.chunk_ticks,
                                      self.settings, rec=rec)
        if self.settings.flight_recorder_window:
            return out
        return out[0], out[1], None

    def _dispatch(self) -> dict:
        compile_s = self._one_time()
        t0 = time.perf_counter()
        fence = _Fence(self.device)
        self._carry, logs, self._rec = self._chunk(self._carry, self._rec)
        pending = {"index": self.chunks, "logs": logs,
                   "checkpoint": None, "compile_s": compile_s,
                   "fence": fence.close(),
                   "dispatch_s": time.perf_counter() - t0}
        self.chunks += 1
        self.ticks += self.chunk_ticks
        return pending

    def _record(self, pending: dict, wall: float) -> None:
        compile_s = pending["compile_s"]
        logs = pending["logs"]
        ticks_col, announce_tc, decide_tc = read_arrays(
            logs.tick, logs.announce, logs.decide)
        announce_tc = announce_tc.astype(bool)
        decide_tc = decide_tc.astype(bool)
        announces = int(announce_tc.sum())
        decides = int(decide_tc.sum())
        self.announces += announces
        self.decides += decides
        live = self._live_buffer_bytes()
        self._watermarks.append(live)
        slo_block = None
        if self.slo is not None:
            samples = self._vc_fold.fold(ticks_col, announce_tc, decide_tc)
            self._ttvc.extend(samples["ticks_to_view_change"])
            slo_block = self.slo.fold_chunk(samples)
        new_spans = self._lineage.fold_columns(receiver_phase_columns(logs))
        self.lineage_spans.extend(new_spans)
        self._lineage_window.append(new_spans)
        lineage_block = lineage_summary(
            [sp for chunk in self._lineage_window for sp in chunk])
        record = {
            "record": "chunk",
            "index": pending["index"],
            "tick": (int(ticks_col[-1]) if ticks_col.size else self.ticks),
            "ticks": self.chunk_ticks,
            "wall_s": wall,
            "compile_s": compile_s,
            "ticks_per_sec": _rate(self.chunk_ticks, wall),
            "events_per_sec": None,
            "announces": announces,
            "decides": decides,
            "live_buffer_bytes": live,
            "traffic": None,
            "servo": None,
            "slo": slo_block,
            "lineage": lineage_block,
            "checkpoint": pending["checkpoint"],
        }
        self.chunk_records.append(record)
        self._emit(record)
        if self.status is not None:
            # One frame per chunk, unconditionally: the watch cadence
            # matches the chunk cadence even when a chunk closes no view
            # change.
            self.status.publish(self._status_snapshot(record))

    def _status_snapshot(self, record: dict) -> dict:
        """Chunk-boundary ``status_snapshot`` (receiver flavour), built
        from drained host data only."""
        from rapid_tpu_torch.telemetry.schema import SCHEMA_VERSION

        return {
            "record": "status_snapshot",
            "schema_version": SCHEMA_VERSION,
            "source": "resident_receiver",
            "tick": record["tick"],
            "chunks": self.chunks,
            "epoch": -1,
            "n_members": self.capacity,
            "ticks_per_sec": record["ticks_per_sec"],
            "events_per_sec": None,
            "backlog": None,
            "live_buffer_bytes": record["live_buffer_bytes"],
            "servo": None,
            "slo": record["slo"],
            "lineage": record["lineage"],
            "checkpoint": self.checkpoint_block,
            "wall_s": time.perf_counter() - self._wall0,
        }

    # --- checkpoint/restore ----------------------------------------------

    def _host_blob(self) -> dict:
        blob = {"chunks": self.chunks, "ticks": self.ticks,
                "capacity": self.capacity,
                "chunk_ticks": self.chunk_ticks,
                "announces": self.announces, "decides": self.decides}
        if self.slo is not None:
            blob["slo"] = self.slo.state_dict()
            blob["vc_fold"] = self._vc_fold.state_dict()
        blob["lineage"] = {"fold": self._lineage.state_dict(),
                           "spans": self.lineage_spans,
                           "window": [list(c) for c in self._lineage_window]}
        return blob

    def save(self, path: str) -> dict:
        """Checkpoint the receiver carry in whichever layout it runs
        (``receiver_dense`` or ``receiver_packed`` family); drains the
        in-flight chunk first so the saved carry is a chunk boundary."""
        self.flush()
        return checkpoint_mod.save_receiver(
            path, self._carry, self.settings, tick=self.ticks,
            rec=self._rec, host=self._host_blob())

    @classmethod
    def restore(cls, path: str, faults, settings: Settings, device="cuda",
                **kw) -> "ResidentReceiver":
        """The member from a checkpoint of either package, on ``device``
        (where ``faults`` must live)."""
        cp = checkpoint_mod.load_checkpoint(path, settings, device=device)
        carry = checkpoint_mod.restore_receiver_carry(cp, settings)
        host = cp.host or {}
        slo = kw.pop("slo", None)
        if slo is None and "slo" in host:
            slo = SloWindows.from_state(host["slo"])
        rx = cls(carry, faults, settings,
                 capacity=int(host["capacity"]),
                 chunk_ticks=kw.pop("chunk_ticks",
                                    int(host["chunk_ticks"])),
                 slo=slo, **kw)
        if rx.slo is not None and "vc_fold" in host:
            rx._vc_fold = ReceiverViewChangeFold.from_state(host["vc_fold"])
        if "lineage" in host:
            lin = host["lineage"]
            rx._lineage = LineageFold.from_state(lin["fold"])
            rx.lineage_spans = list(lin["spans"])
            for chunk in lin["window"]:
                rx._lineage_window.append(list(chunk))
        rx._rec = cp.parts.get("recorder")
        rx.chunks = int(host.get("chunks", 0))
        rx.ticks = int(host.get("ticks", cp.tick))
        rx.announces = int(host.get("announces", 0))
        rx.decides = int(host.get("decides", 0))
        return rx

    def verify_round_trip(self, path: str) -> dict:
        """Save, restore, and prove the restore exact (the receiver twin
        of ``ResidentEngine.verify_round_trip``); returns the
        ``checkpoint`` block the summary embeds, and adopts the restored
        branch as the continuing carry."""
        self.flush()
        t0 = time.perf_counter()
        fence = _Fence(self.device)
        self.save(path)
        cp = checkpoint_mod.load_checkpoint(path, self.settings,
                                            device=self.device)
        restored = checkpoint_mod.restore_receiver_carry(cp, self.settings)
        r_rec = cp.parts.get("recorder")
        state_identical = _tree_equal(self._carry, restored)
        recorder_identical = (_tree_equal(self._rec, r_rec)
                              if self._rec is not None else None)

        l_final, l_logs, l_rec = self._chunk(self._carry, self._rec)
        r_final, r_logs, r_rec2 = self._chunk(restored, r_rec)
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
        self._carry, self._rec = r_final, r_rec2
        del l_final, l_logs, l_rec, restored
        pending = {"index": self.chunks, "logs": r_logs,
                   "checkpoint": block, "compile_s": None,
                   "fence": fence.close(), "dispatch_s": dispatch_s}
        self.chunks += 1
        self.ticks += self.chunk_ticks
        self._draining = pending
        self._drain(pending)
        self._draining = None
        self.checkpoint_block = block
        return block

    # --- summary ----------------------------------------------------------

    def summary(self) -> dict:
        """The final ``record: "stream_summary"`` line
        (``source: "resident_receiver"``, traffic and servo null)."""
        from rapid_tpu_torch.telemetry.schema import SCHEMA_VERSION

        self.flush()
        wall = time.perf_counter() - self._wall0
        record = {
            "record": "stream_summary",
            "schema_version": SCHEMA_VERSION,
            "source": "resident_receiver",
            "n": self.capacity,
            "capacity": self.capacity,
            "ticks": self.ticks,
            "chunks": self.chunks,
            "chunk_ticks": self.chunk_ticks,
            "events_injected": 0,
            "joins": 0,
            "leaves": 0,
            "bursts": 0,
            "announcements": self.announces,
            "decisions": self.decides,
            "wall_s": wall,
            "compile_s": self.compile_s,
            "ticks_per_sec": _rate(self.ticks, wall),
            "events_per_sec": None,
            "ticks_to_view_change": _dist(self._ttvc),
            "lineage": lineage_summary(self.lineage_spans),
            "servo": None,
            "slo": self.slo.block() if self.slo is not None else None,
            "live_buffer_bytes": self._watermark_block(),
            "traffic": None,
            "checkpoint": self.checkpoint_block,
        }
        self._emit(record)
        return record


def boot_resident_receiver(settings: Settings, n: int, *, seed: int = 0,
                           horizon_ticks: int, chunk_ticks: int,
                           slo: Optional[SloWindows] = None,
                           status: Optional[StatusPublisher] = None,
                           sink: Optional[str] = None,
                           donate: bool = True,
                           device="cuda") -> ResidentReceiver:
    """Boot the named two-zone deployment as a resident receiver member
    on ``device``: ``faults.two_zone_schedule`` lowered through
    ``fleet.lower_receiver_schedule``, the carry in whatever layout
    ``settings.rx_kernel`` selects. ``horizon_ticks`` bounds the fault
    schedule, not the run: chunks past the horizon tick on with the
    faults inert."""
    from rapid_tpu_torch.engine.fleet import lower_receiver_schedule

    sched = two_zone_schedule(n, seed, int(horizon_ticks),
                              ring_depth=settings.delivery_ring_depth)
    member = lower_receiver_schedule(sched, settings, device=device)
    return ResidentReceiver(member.state, member.faults, settings,
                            capacity=n, chunk_ticks=chunk_ticks, slo=slo,
                            status=status, sink=sink, donate=donate)
