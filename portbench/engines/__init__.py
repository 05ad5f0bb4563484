"""The program's engines, one module for each ``engine`` a configuration
names, found by that name (``system.engine_of``).

An engine module ``engines/<engine>.py`` holds all that the harness does
with that engine of the port:

- ``lower(config, settings, descs, device)``: every member's description
  (``traffic.generate``) lowered and stacked into one fleet;
- ``dispatch(fleet)``: one run of every member of a ``system.Fleet`` for
  the scenario's ticks, ``(finals, logs, ...)`` with the member axis
  first;
- ``fold(fleet, out)``: each member's run summary through the program's
  own telemetry fold (objects with ``as_dict``);
- ``outputs(fleet, out)``: per member, what the comparison judges, on the
  host, in the form ``reference/<engine>.py``'s ``simulate`` gives;
- ``TICK_FUNCTIONS``: ``(module, attribute)`` of each of the port's tick
  functions that the engine's dispatch runs (each returns ``(state,
  log)``), which the ``unchanged`` fault freezes;
- ``ALTERED_COLUMN``: the log column the ``altered`` fault changes.

This package holds what the engines share. An engine module imports the
program when ``system.build`` finds it, before the lowering's span
opens, so that ``lower_ms_per_member`` times the lowering alone.
"""
from __future__ import annotations

import numpy as np
import torch
from rapid_tpu_torch.faults import (AdversarySchedule, LinkWindow,
                                    ScriptedPropose)


def schedule_of(desc: dict, n: int):
    """The port's ``AdversarySchedule`` of a description's crashes, link
    windows and scripted proposes."""
    windows = tuple(
        LinkWindow(src_slots=frozenset(w["src"]),
                   dst_slots=frozenset(w["dst"]),
                   start_tick=w["start"], end_tick=w["end"],
                   period_ticks=w["period"], two_way=w["two_way"])
        for w in desc["windows"])
    proposes = ()
    if desc.get("proposes"):
        prop = desc["proposes"]
        victims = [(int(v),) for v in prop["victims"]]
        proposes = tuple(
            ScriptedPropose(slot=s, tick=prop["tick"], proposal=victims[c],
                            delay_ticks=int(d))
            for s, (c, d) in enumerate(zip(prop["camp"].tolist(),
                                           prop["delay"].tolist())))
    return AdversarySchedule(
        n=n, crashes=tuple((int(s), int(t)) for s, t in desc["crashes"]),
        windows=windows, proposes=proposes, seed=int(desc["seed"]))


def u64(hi, lo) -> np.ndarray:
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(lo).astype(np.uint64)


def rows(flags, planes):
    """``(index arrays, rows, bits)``: the ``[C]`` rows of ``planes``
    (``[T, ..., C]``) where ``flags`` (``[T, ...]``) is set, and the
    count of set bits anywhere in ``planes`` (so that none may lie
    elsewhere). The reference gives its rows in the same order."""
    idx = torch.nonzero(flags, as_tuple=True)
    return ([i.cpu().numpy() for i in idx], planes[idx].cpu().numpy(),
            int(planes.sum()))
