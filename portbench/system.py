"""The system under test: the port's fleet entry points, driven from a
cell's member descriptions (``traffic.generate``).

A configuration's ``engine`` names the module ``engines/<engine>.py``
that holds what the harness does with that engine of the port
(``engines/__init__.py`` lists it). ``build`` finds that module once and
lowers and stacks every member through it (the benchmark's set-up);
``Fleet.dispatch`` is the unit of work the window repeats: every member
for the scenario's ticks, from the stacked boot state. ``Fleet.fold`` is
the telemetry fold of every member; ``Fleet.outputs`` reads what the
comparison judges to the host, in the form ``reference`` produces.
"""
from __future__ import annotations

import importlib
import time

import torch


def settings_of(config: dict):
    from rapid_tpu_torch.settings import Settings

    keys = ("K", "H", "L", "tick_ms", "batching_window_ticks",
            "fd_interval_ticks", "fd_failure_threshold",
            "fallback_base_delay_ticks", "protocol_variant", "capacity",
            "rx_kernel", "delivery_ring_depth")
    return Settings(**{k: config[k] for k in keys if k in config})


def engine_of(config: dict):
    """The engine module the configuration names."""
    return importlib.import_module(f"portbench.engines.{config['engine']}")


def build(config: dict, descs: list, ticks: int, device) -> "Fleet":
    """Lower and stack every member on ``device``; the fleet records the
    seconds the lowering and the stacking took (``lower_s``)."""
    engine = engine_of(config)
    settings = settings_of(config)
    start = time.perf_counter()
    stacked = engine.lower(config, settings, descs, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return Fleet(engine, config, settings, stacked, ticks, len(descs),
                 device, time.perf_counter() - start)


class Fleet:
    """One stacked fleet and the calls the window makes on it."""

    def __init__(self, engine, config, settings, stacked, ticks, members,
                 device, lower_s):
        self.engine = engine
        self.config = config
        self.settings = settings
        self.stacked = stacked
        self.ticks = ticks
        self.members = members
        self.device = device
        self.lower_s = lower_s

    def dispatch(self):
        """One run of every member for the scenario's ticks:
        ``(finals, logs)``, member axis first."""
        return self.engine.dispatch(self)

    def fold(self, out) -> list:
        """Each member's run summary (a dict), through the program's own
        telemetry fold."""
        return [_summary_dict(s.as_dict())
                for s in self.engine.fold(self, out)]

    def outputs(self, out) -> list:
        """Per member, what the comparison judges, on the host, in the
        form the engine's reference gives."""
        return self.engine.outputs(self, out)


def _summary_dict(d: dict) -> dict:
    d = dict(d)
    d.pop("source", None)
    return d
