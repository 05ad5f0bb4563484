"""First-divergence reports, as the reference's forensics builds them.

Own copies of ``Divergence``, ``DivergenceReport``, ``DivergenceError``,
the finders and ``build_report``: a located divergence (tick, field, our
value, the reference side's value) with the trailing context records
before it, rendered as an ``AssertionError`` message and optionally
written as a JSONL artifact (context records first, the divergence
record last). The finders (``events_divergence``,
``counters_divergence``, ``scalar_divergence``) return ``Divergence``
records; ``earliest`` picks the one with the smallest tick, list order
breaking ties.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

#: Event fields compared in order; the first mismatch names the field.
_EVENT_FIELDS = ("tick", "kind", "slots", "config_id")


def _jsonable(v):
    if isinstance(v, (set, frozenset)):
        return sorted(v)
    if isinstance(v, tuple):
        return list(v)
    return v


@dataclass
class Divergence:
    """The first disagreeing (tick, field) pair between two streams."""

    tick: int
    field: str
    engine: object  # our side's value
    oracle: object  # the reference side's value


@dataclass
class DivergenceReport:
    """A located divergence plus trailing context records."""

    tick: int
    field: str
    engine: object
    oracle: object
    context: List[Dict[str, object]] = field(default_factory=list)

    def as_dict(self) -> Dict[str, object]:
        return {"record": "divergence", "tick": self.tick,
                "field": self.field,
                "engine": _jsonable(self.engine),
                "oracle": _jsonable(self.oracle)}

    def render(self) -> str:
        lines = [
            f"engine diverged from oracle at tick {self.tick}, "
            f"field {self.field!r}:",
            f"  engine: {self.engine!r}",
            f"  oracle: {self.oracle!r}",
        ]
        if self.context:
            lines.append(f"last {len(self.context)} records before the "
                         f"divergence:")
            for rec in self.context:
                lines.append("  " + json.dumps(rec, sort_keys=True,
                                               default=str))
        return "\n".join(lines)

    def write_jsonl(self, path) -> None:
        """Context records first, the divergence record last."""
        from rapid_tpu_torch.telemetry import write_jsonl_artifact

        write_jsonl_artifact(path, [*self.context, self.as_dict()],
                             default=str)


class DivergenceError(AssertionError):
    """A located first divergence, as an ``AssertionError``."""

    def __init__(self, report: DivergenceReport,
                 artifact: Optional[str] = None) -> None:
        self.report = report
        self.artifact = artifact
        msg = report.render()
        if artifact:
            msg += f"\nforensics artifact: {artifact}"
        super().__init__(msg)


def events_divergence(engine_events: Sequence, oracle_events: Sequence,
                      prefix: str = "events") -> Optional[Divergence]:
    """First field-level mismatch between two ViewEvent streams."""
    for i, (ev, ov) in enumerate(zip(engine_events, oracle_events)):
        for f in _EVENT_FIELDS:
            evf, ovf = getattr(ev, f), getattr(ov, f)
            if evf != ovf:
                return Divergence(min(ev.tick, ov.tick),
                                  f"{prefix}[{i}].{f}", evf, ovf)
    if len(engine_events) != len(oracle_events):
        i = min(len(engine_events), len(oracle_events))
        longer = engine_events if len(engine_events) > len(oracle_events) \
            else oracle_events
        return Divergence(longer[i].tick, f"{prefix}.length",
                          len(engine_events), len(oracle_events))
    return None


def counters_divergence(engine_counters: Sequence[Dict[str, int]],
                        oracle_counters: Sequence[Dict[str, int]],
                        start_tick: int = 0) -> Optional[Divergence]:
    """First per-tick counter mismatch (tick = start_tick + 1 + i)."""
    for i, (eng, orc) in enumerate(zip(engine_counters, oracle_counters)):
        for key in sorted(set(eng) | set(orc)):
            ev, ov = eng.get(key), orc.get(key)
            if ev != ov:
                return Divergence(start_tick + 1 + i, f"counters.{key}",
                                  ev, ov)
    return None


def scalar_divergence(name: str, engine_value, oracle_value,
                      tick: int) -> Optional[Divergence]:
    """End-of-run scalar comparison (config ids, final memberships)."""
    if engine_value != oracle_value:
        return Divergence(tick, name, engine_value, oracle_value)
    return None


def earliest(candidates: Sequence[Optional[Divergence]]
             ) -> Optional[Divergence]:
    """The divergence with the smallest tick; list order breaks ties."""
    found = [d for d in candidates if d is not None]
    if not found:
        return None
    best = found[0]
    for d in found[1:]:
        if d.tick < best.tick:
            best = d
    return best


def build_report(div: Divergence,
                 engine_metrics: Optional[Sequence] = None,
                 oracle_metrics: Optional[Sequence] = None,
                 events: Sequence = (),
                 context_n: int = 4) -> DivergenceReport:
    """The report of ``div`` with the last ``context_n`` records at or
    before its tick: metrics rows of each stream given (``"record":
    "tick_metrics"``, objects with ``tick`` and ``as_dict()``) and view
    events (``"record": "view_event"``)."""
    context: List[Dict[str, object]] = []
    for stream in (engine_metrics, oracle_metrics):
        if not stream:
            continue
        for m in [m for m in stream if m.tick <= div.tick][-context_n:]:
            rec = {"record": "tick_metrics"}
            rec.update(m.as_dict())
            context.append(rec)
    for e in [e for e in events if e.tick <= div.tick][-context_n:]:
        rec = {"record": "view_event"}
        rec.update(e.as_dict() if hasattr(e, "as_dict")
                   else dataclasses.asdict(e))
        rec["slots"] = _jsonable(rec.get("slots"))
        context.append(rec)
    return DivergenceReport(tick=div.tick, field=div.field,
                            engine=div.engine, oracle=div.oracle,
                            context=context)
