"""Run one cell as ``run.py`` does, with the program's spans on.

    python3 portbench/span_run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

``--trace 1``: spans on for set-up and for the profiled dispatch, which
runs under ``spans.profiled`` in place of ``profiling.profiled``; the
result line is ``run.py``'s (its per-layer metrics read from a device
list without the spans' annotations) with ``spans`` added: the readings
of ``spans.READINGS``, ``idle_by_span``, the window's span counts and
summed ms by name, set-up's summed ms a member by name, and the device
operations no span owns. ``--trace 0``: spans on
for the whole run, so its ``sim_ticks_per_s`` against ``run.py``'s own
on the same card is what the spans cost. Needs a CUDA device, as
``run.py`` does.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import profiling, run, spans  # noqa: E402


def _ms_by_name(entries, per: int) -> dict:
    """Summed span time by name, ms, over ``per``."""
    out = Counter()
    for name, start, end, _ in entries:
        if end is not None:
            out[name] += (end - start) * 1e-6 / per
    return dict(out)


def run_with_spans(workload: dict, config: dict, traffic: dict, seed: int,
                   seconds: float, trace: bool, dev, bench: dict,
                   start: float) -> dict:
    """``run.run_cell`` with the program's spans on (module docstring)."""
    from rapid_tpu_torch.telemetry import trace as program

    got = {}

    def traced(fn):
        got["setup"] = program.take_spans()
        try:
            out, record = spans.profiled(fn)
        finally:
            program.disable_spans()
        got["profile"] = record
        return out, record

    program.take_spans()
    program.enable_spans()
    plain = profiling.profiled
    if trace:
        profiling.profiled = traced
    try:
        result = run.run_cell(workload, config, traffic, seed, seconds,
                              trace, dev, bench, start=start)
    finally:
        profiling.profiled = plain
        program.disable_spans()
        program.take_spans()
    if trace:
        prof = got["profile"]
        rec = {"members": workload["members"], "setup_spans": got["setup"],
               "profile": prof}
        readings = {name: read(rec) for name, read in
                    spans.READINGS.items()}
        readings.update(
            idle_by_span=spans.idle_by_span(prof),
            span_counts=dict(Counter(s[0] for s in prof["spans"])),
            window_ms_by_span=_ms_by_name(prof["spans"], 1),
            setup_ms_per_member_by_span=_ms_by_name(got["setup"],
                                                    workload["members"]),
            unowned_device_ops=sum(i < 0 for i in prof["device_span"]),
            device_ops=len(prof["device"]))
        result = dict(result, spans=readings)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    workload, config, traffic = run.load_cell(args.workload)
    bench = run.load_json(ROOT / "BENCHMARK.json")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < workload["chips"]:
        print("span_run: the cell needs a CUDA device (no fallback to the "
              "CPU)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result = run_with_spans(workload, config, traffic, args.seed,
                            args.seconds, bool(args.trace), dev, bench, T0)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
