"""Run one cell of the port's benchmark once, on the CUDA device it finds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<name>.json``), a traffic mix (``traffic/<name>.json``) and the
fleet size F. Set-up draws every member's faults from ``--seed``, lowers
and stacks the F members into one fleet through the configuration's
engine module (``engines/<engine>.py``) and runs one warm dispatch (the
first run in a checkout also builds the program's CUDA kernels into
``build/``). The window then repeats one dispatch (every member for the
scenario's ticks, then the telemetry fold of every member) while time
remains, and closes when the last dispatch started has been folded.
Afterwards the last dispatch's outputs and every dispatch's folded
summaries are compared with the plain reference of the same engine
(``reference/<engine>.py``), exactly.

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (``metrics/<name>.py``, as ``BENCHMARK.json`` lists
them for the cell), read from the first dispatch of the window run under
``torch.profiler``. The last line of standard output is one JSON object;
the numbers compared and their limits are also the last lines of
standard error. Without a CUDA device, or with fewer than the cell asks
for, the run exits with 2 and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import compare, profiling, reference, system  # noqa: E402
from portbench.traffic import generate  # noqa: E402

#: Top-level module names that no run may hold once its window closes.
FORBIDDEN = ("jax", "jaxlib", "flax", "rapid_tpu")


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    return json.loads(path.read_text())


def load_cell(name: str):
    """``(workload, config, traffic)`` of a cell, found by name."""
    workload = load_json(HERE / "workloads" / f"{name}.json")
    config = load_json(HERE / "configs" / f"{workload['config']}.json")
    return workload, config, generate.load(workload["traffic"])


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of ``bench[kind]`` the cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reference_of(config: dict):
    """The reference module of the configuration's engine."""
    return importlib.import_module(
        f"portbench.reference.{config['engine']}")


def reference_outputs(config: dict, descs: list, ticks: int, dev) -> list:
    model = reference_of(config)
    uni = model.universe(config, dev)
    return [model.simulate(config, d, ticks, uni) for d in descs]


def run_cell(workload: dict, config: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, dev, bench: dict,
             start: float = None) -> dict:
    """One run of a cell on ``dev``; returns the result line's object.
    ``start`` is the host clock the set-up is counted from."""
    from rapid_tpu_torch import device as port_device

    start = T0 if start is None else start
    ticks = config["scenario_ticks"]
    members = workload["members"]
    descs = generate.fleet(traffic, config["nodes"], members, seed)
    fleet = system.build(config, descs, ticks, dev)
    lower_s = fleet.lower_s
    warm = fleet.dispatch()
    fleet.fold(warm)
    del warm
    _sync(dev)
    setup_s = time.perf_counter() - start

    def one():
        out = fleet.dispatch()
        t = time.perf_counter()
        sums = fleet.fold(out)
        return out, sums, time.perf_counter() - t

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reads = port_device.host_reads
    folds, summaries, walls, profile = [], [], [], None
    out = None
    t_open = time.perf_counter()
    while not summaries or time.perf_counter() - t_open < seconds:
        out = None
        walls.append(time.perf_counter())
        if trace and profile is None:
            (out, sums, profiled_fold_s), profile = profiling.profiled(one)
        else:
            out, sums, fold_s = one()
            folds.append(fold_s)
        summaries.append(sums)
    _sync(dev)
    window_s = time.perf_counter() - t_open
    reads = port_device.host_reads - reads
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise ForbiddenModules("modules of JAX or the JAX package are "
                               "loaded: " + ", ".join(found))

    # The comparison, once the window has closed and the program's state
    # is freed.
    got = fleet.outputs(out)
    del out, fleet
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    refused = ""
    model = reference_of(config)
    try:
        want = reference_outputs(config, descs, ticks, dev)
    except reference.OutOfScope as err:
        refused, want = str(err), None
    if want is None:
        mism, sum_mism = [], []
    else:
        mism = compare.outputs(got, want)
        ref_sums = [model.member_summary(w) for w in want]
        sum_mism = [(d, m, key) for d, sums in enumerate(summaries)
                    for m, key in compare.summaries(sums, ref_sums)]
    failed = ({(d, m) for d, m, _ in sum_mism}
              | {(len(summaries) - 1, m) for m, _, _ in mism})
    checks = {
        "output_mismatches": {"value": len(mism), "limit": 0},
        "summary_mismatches": {"value": len(sum_mism), "limit": 0},
        "reference_refusals": {"value": int(bool(refused)), "limit": 0},
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    if trace:
        rec = {"workload": workload["name"], "engine": config["engine"],
               "members": members, "ticks": ticks,
               "capacity": config["capacity"], "lower_s": lower_s,
               "host_reads": reads, "timed_ticks": len(summaries) * ticks,
               "fold_s": folds or [profiled_fold_s],
               "profile": dict(profile, ticks=ticks)}
        metrics = {}
        for m in cell_metrics(bench, workload["name"], "per_layer"):
            reader = importlib.import_module(f"portbench.metrics.{m['name']}")
            value = reader.read(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s,
                  "sim_ticks_per_s": len(summaries) * members * ticks
                  / window_s,
                  "peak_mem_gib": peak / 2**30}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, workload["name"],
                                         "end_to_end")}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": workload["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct,
              "attempted": len(summaries) * members,
              "failed": len(failed), "metrics": metrics, "device": device}
    if trace:
        from portbench.metrics import _trace

        busy = _trace.busy_ns(profile) * 1e-9
        device.update(busy_s=busy, window_s=(profile["end_ns"]
                                             - profile["start_ns"]) * 1e-9)
        result["breakdown"] = {
            "device_ops": profiling.top_device_ops(profile),
            "idle_gaps": profiling.gap_labels(profile,
                                              *_trace.idle_gaps(profile))}
    result["details"] = {
        "dispatches": len(summaries), "window_s": window_s,
        "dispatch_s": [b - a for a, b in zip(walls, walls[1:] + [
            t_open + window_s])],
        "first_mismatches": [list(x) for x in mism[:8]],
        "first_summary_mismatches": [list(x) for x in sum_mism[:8]],
        "reference_refused": refused}
    result["checks"] = checks
    return result


class ForbiddenModules(RuntimeError):
    """Modules of JAX or the JAX package are loaded in the run."""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    workload, config, traffic = load_cell(args.workload)
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no fallback to the CPU)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        result = run_cell(workload, config, traffic, args.seed, args.seconds,
                          bool(args.trace), dev, bench)
    except ForbiddenModules as err:
        print(f"portbench: {err}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
