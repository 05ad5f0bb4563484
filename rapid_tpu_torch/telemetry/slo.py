"""Rolling SLO windows: bounded per-chunk histograms of protocol tails.

Own copy of the reference's ``telemetry.slo``:

- :data:`DEFAULT_BUCKET_EDGES`: power-of-two upper-inclusive tick
  edges; a sample lands in the first bucket whose edge is >= the sample,
  and the last edge is large enough that nothing overflows;
- :class:`SloWindows`: a deque of per-chunk count vectors per metric
  (``decide_latency``: announce -> decide ticks;
  ``ticks_to_view_change``: previous decide -> decide ticks, the
  windowing of ``metrics.summarize``). Percentiles are nearest-rank over
  bucket upper edges, so two hosts folding one stream agree byte for
  byte;
- :class:`ViewChangeFold` / :class:`ReceiverViewChangeFold`: the
  host-side carries that turn chunked per-tick streams into window
  samples. Each round-trips through ``state_dict``.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from rapid_tpu_torch.device import read_arrays

#: Upper-inclusive bucket edges, in ticks. Power-of-two spacing keeps
#: the vector short while resolving both the fast path (a few ticks)
#: and pathological tails; the final edge is an effective +inf so no
#: sample ever overflows the histogram.
DEFAULT_BUCKET_EDGES = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
                        2048, 4096, 1 << 30)

#: The two windowed metrics every resident stream reports.
SLO_METRICS = ("decide_latency", "ticks_to_view_change")


def _bucket_index(edges: Sequence[int], sample: int) -> int:
    for i, edge in enumerate(edges):
        if sample <= edge:
            return i
    return len(edges) - 1


def _percentile_edge(edges: Sequence[int], counts: Sequence[int],
                     pct: float) -> Optional[int]:
    """Nearest-rank percentile as a bucket upper edge (None when the
    window holds no samples). Deterministic: no interpolation, so the
    committed artifacts diff exactly."""
    total = sum(counts)
    if total == 0:
        return None
    rank = max(1, -(-int(pct * total) // 100))
    cum = 0
    for edge, count in zip(edges, counts):
        cum += count
        if cum >= rank:
            return int(edge)
    return int(edges[-1])


class SloWindows:
    """Bounded rolling histograms over the last ``window_chunks`` chunks.

    ``fold_chunk`` appends one chunk's samples per metric (evicting the
    oldest chunk once the window is full) and returns the refreshed
    ``slo`` block for that chunk's heartbeat.
    """

    def __init__(self, window_chunks: int = 8,
                 edges: Sequence[int] = DEFAULT_BUCKET_EDGES):
        if window_chunks < 1:
            raise ValueError(
                f"window_chunks must be >= 1, got {window_chunks}")
        self.window_chunks = int(window_chunks)
        self.edges = tuple(int(e) for e in edges)
        self._ring: Dict[str, deque] = {
            m: deque(maxlen=self.window_chunks) for m in SLO_METRICS}

    def fold_chunk(self, samples: Dict[str, Sequence[int]]) -> dict:
        for metric in SLO_METRICS:
            counts = [0] * len(self.edges)
            for s in samples.get(metric, ()):
                counts[_bucket_index(self.edges, int(s))] += 1
            self._ring[metric].append(counts)
        return self.block()

    def _metric_block(self, metric: str) -> dict:
        folded = [0] * len(self.edges)
        for counts in self._ring[metric]:
            for i, c in enumerate(counts):
                folded[i] += c
        return {
            "count": sum(folded),
            "counts": folded,
            "p50": _percentile_edge(self.edges, folded, 50),
            "p95": _percentile_edge(self.edges, folded, 95),
            "p99": _percentile_edge(self.edges, folded, 99),
        }

    def block(self) -> dict:
        """The heartbeat ``slo`` block (``telemetry.schema
        .SLO_WINDOW_SPEC``)."""
        return {
            "window_chunks": self.window_chunks,
            "chunks": len(self._ring[SLO_METRICS[0]]),
            "bucket_edges": list(self.edges),
            "metrics": {m: self._metric_block(m) for m in SLO_METRICS},
        }

    # --- checkpoint host blob --------------------------------------------

    def state_dict(self) -> dict:
        return {
            "kind": "slo_windows",
            "window_chunks": self.window_chunks,
            "bucket_edges": list(self.edges),
            "ring": {m: [list(c) for c in self._ring[m]]
                     for m in SLO_METRICS},
        }

    @classmethod
    def from_state(cls, state: dict) -> "SloWindows":
        slo = cls(window_chunks=state["window_chunks"],
                  edges=state["bucket_edges"])
        for metric in SLO_METRICS:
            for counts in state["ring"].get(metric, ()):
                slo._ring[metric].append([int(c) for c in counts])
        return slo


class ViewChangeFold:
    """Chunk-boundary-safe fold of a ``TickMetrics`` stream into SLO
    samples, carrying the open view-change window across chunks.

    The windowing matches ``telemetry.metrics.summarize`` exactly:
    ``ticks_to_view_change`` measures from the run start (or the
    previous decide) to the decide; ``decide_latency`` measures from
    the window's latest announce to the decide.
    """

    def __init__(self, start_tick: int = 0):
        self.window_start = int(start_tick)
        self.window_announce: Optional[int] = None

    def fold(self, rows) -> Dict[str, List[int]]:
        ttvc: List[int] = []
        latency: List[int] = []
        for m in rows:
            if m.announce:
                self.window_announce = m.tick
            if m.decide:
                ttvc.append(m.tick - self.window_start)
                if self.window_announce is not None:
                    latency.append(m.tick - self.window_announce)
                self.window_start = m.tick
                self.window_announce = None
        return {"ticks_to_view_change": ttvc, "decide_latency": latency}

    def state_dict(self) -> dict:
        return {"kind": "view_change_fold",
                "window_start": self.window_start,
                "window_announce": self.window_announce}

    @classmethod
    def from_state(cls, state: dict) -> "ViewChangeFold":
        fold = cls(start_tick=state["window_start"])
        wa = state.get("window_announce")
        fold.window_announce = None if wa is None else int(wa)
        return fold


class ReceiverViewChangeFold:
    """The per-slot twin for receiver-resident streams: every live slot
    of a per-receiver member runs its own protocol instance, so the
    window carry is per slot (``[C]`` start ticks, ``[C]`` open
    announce ticks, -1 = none). Samples come out in (tick, slot) order,
    so the fold is deterministic in the log alone. The columns may be
    tensors on any device (read to the host in one transfer)."""

    def __init__(self, capacity: int, start_tick: int = 0):
        self.capacity = int(capacity)
        self.window_start = np.full(capacity, int(start_tick), np.int64)
        self.announce_tick = np.full(capacity, -1, np.int64)

    def fold(self, ticks, announce_tc, decide_tc) -> Dict[str, List[int]]:
        cols = [ticks, announce_tc, decide_tc]
        if any(torch.is_tensor(c) for c in cols):
            cols = read_arrays(*[torch.as_tensor(c) for c in cols])
        ticks = np.asarray(cols[0])
        announce_tc = np.asarray(cols[1]).astype(bool)
        decide_tc = np.asarray(cols[2]).astype(bool)
        ttvc: List[int] = []
        latency: List[int] = []
        for i in range(ticks.shape[0]):
            t = int(ticks[i])
            ann = announce_tc[i]
            if ann.any():
                self.announce_tick[ann] = t
            dec = decide_tc[i]
            if not dec.any():
                continue
            ttvc.extend(int(v) for v in (t - self.window_start[dec]))
            opened = dec & (self.announce_tick >= 0)
            latency.extend(int(v) for v in (t - self.announce_tick[opened]))
            self.window_start[dec] = t
            self.announce_tick[dec] = -1
        return {"ticks_to_view_change": ttvc, "decide_latency": latency}

    def state_dict(self) -> dict:
        return {"kind": "receiver_view_change_fold",
                "capacity": self.capacity,
                "window_start": [int(v) for v in self.window_start],
                "announce_tick": [int(v) for v in self.announce_tick]}

    @classmethod
    def from_state(cls, state: dict) -> "ReceiverViewChangeFold":
        fold = cls(state["capacity"])
        fold.window_start = np.array(state["window_start"], np.int64)
        fold.announce_tick = np.array(state["announce_tick"], np.int64)
        return fold
