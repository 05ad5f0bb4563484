"""The shared engine under Rapid's join and graceful leave: the universe
holds ``capacity`` slots, the first ``nodes`` of them boot the view and
the rest boot dormant (``fleet.lower_schedule(member=...)``), and each
member's ``churn`` description becomes its ``ChurnSchedule`` of join and
leave enqueue ticks with the epochs they expect. The dormant slots'
identifier fingerprints are ``hash64(slot, seed=0x6964)``, the rule of
the port's ``churn.synthetic_churn_schedule``. Dispatch, fold and
outputs are the shared engine's."""
from __future__ import annotations

import numpy as np
from rapid_tpu_torch import hashing
from rapid_tpu_torch.engine import churn, fleet

from portbench.engines import schedule_of
# The shared engine's dispatch, fold, outputs and tick function.
from portbench.engines.shared import (  # noqa: F401
    TICK_FUNCTIONS, dispatch, fold, outputs)

ALTERED_COLUMN = "churn_injected"
#: The seed of a dormant slot's identifier fingerprint.
SEED_JOINER = 0x6964


def schedule(desc: dict, c: int) -> churn.ChurnSchedule:
    """The host ``ChurnSchedule`` of a description's ``churn`` entry."""
    sched = churn.empty_schedule(c)
    for key in ("join", "leave"):
        rows = np.asarray(desc["churn"][key], np.int64).reshape(-1, 3)
        getattr(sched, f"{key}_tick")[rows[:, 0]] = rows[:, 1]
        getattr(sched, f"{key}_epoch")[rows[:, 0]] = rows[:, 2]
    return sched


def lower(config: dict, settings, descs: list, device):
    n, c = config["nodes"], config["capacity"]
    id_fps = np.zeros(c, np.uint64)
    id_fps[n:] = hashing.hash64_np(np.arange(n, c, dtype=np.uint64),
                                   SEED_JOINER)
    member = np.arange(c) < n
    return fleet.stack_members([
        fleet.lower_schedule(schedule_of(d, n), settings,
                             churn=schedule(d, c), id_fps=id_fps,
                             member=member, device=device)
        for d in descs])
