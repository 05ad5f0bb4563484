"""Telemetry over the port's logs: metrics, lineage, SLO windows, traces,
divergence forensics and payload validation.

Own copies of the reference's ``rapid_tpu.telemetry``: host code that
folds a run's logs into the same records, summaries, spans and Perfetto
JSON. A fold takes the port's logs (tensors on any device, a ``StepLog``
or ``ReceiverStepLog`` with a leading tick axis, ``[F, T, ...]`` for
fleets) or numpy columns, reads the fields it needs to the host in one
transfer (``metrics.host_log``), then works in numpy as the reference
does.

- ``metrics``: ``TickMetrics``, ``engine_metrics``, ``summarize``,
  ``fleet_summaries``, ``merge_summaries``, the campaign distributions;
- ``lineage``: phase-attributed view-change spans;
- ``slo``: rolling SLO windows and the view-change folds that feed them;
- ``trace``: Chrome/Perfetto trace events and ``wall_span``. The
  reference's ``jax_profiler_trace`` has no PyTorch form:
  ``rapid_tpu_torch.profile`` (``torch.profiler``) stands in for it;
- ``forensics``: first-divergence reports;
- ``schema``: the validators of what the port writes.

Every JSON artifact goes through the writers below, so each file ends
with exactly one trailing newline.
"""
import json as _json


def json_artifact_line(payload, *, sort_keys: bool = False, indent=None,
                       separators=None, default=None) -> str:
    """One JSON document as a newline-terminated string."""
    return _json.dumps(payload, sort_keys=sort_keys, indent=indent,
                       separators=separators, default=default) + "\n"


def write_json_artifact(path, payload, *, sort_keys: bool = False,
                        indent=None, default=None) -> None:
    """Write one JSON artifact, newline-terminated."""
    with open(path, "w") as fh:
        fh.write(json_artifact_line(payload, sort_keys=sort_keys,
                                    indent=indent, default=default))


def write_jsonl_artifact(path, records, *, sort_keys: bool = True,
                         default=None) -> None:
    """Write records as JSONL, one newline-terminated line each."""
    with open(path, "w") as fh:
        for rec in records:
            fh.write(json_artifact_line(rec, sort_keys=sort_keys,
                                        default=default))


# The writers come first: the submodules import them during package init.
from rapid_tpu_torch.telemetry.forensics import (  # noqa: E402
    Divergence,
    DivergenceError,
    DivergenceReport,
)
from rapid_tpu_torch.telemetry.metrics import (  # noqa: E402
    COUNTER_FIELDS,
    UNOBSERVED,
    RunSummary,
    TickMetrics,
    counters_equal,
    engine_metrics,
    fleet_summaries,
    merge_summaries,
    oracle_metrics,
    read_jsonl,
    summarize,
    summary_distributions,
    write_jsonl,
)
from rapid_tpu_torch.telemetry.trace import (  # noqa: E402
    TraceWriter,
    trace_from_logs,
    wall_span,
)

__all__ = [
    "COUNTER_FIELDS",
    "Divergence",
    "DivergenceError",
    "DivergenceReport",
    "RunSummary",
    "TickMetrics",
    "TraceWriter",
    "UNOBSERVED",
    "counters_equal",
    "engine_metrics",
    "fleet_summaries",
    "json_artifact_line",
    "merge_summaries",
    "oracle_metrics",
    "read_jsonl",
    "summarize",
    "summary_distributions",
    "trace_from_logs",
    "wall_span",
    "write_json_artifact",
    "write_jsonl",
    "write_jsonl_artifact",
]
