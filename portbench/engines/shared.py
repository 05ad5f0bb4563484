"""The shared engine: every alive process of a member sees one alert
stream. A fleet is lowered by ``engine.fleet.lower_schedule`` and
``stack_members`` and runs through ``fleet_simulate``; its summaries are
``telemetry.metrics.fleet_summaries`` of the stacked logs."""
from __future__ import annotations

import torch
from rapid_tpu_torch.engine import fleet
from rapid_tpu_torch.telemetry.metrics import fleet_summaries

from portbench.engines import rows, schedule_of, u64
from portbench.reference.shared import COLUMNS

TICK_FUNCTIONS = (("rapid_tpu_torch.engine.step", "_fleet_step"),)
ALTERED_COLUMN = "probes_sent"


def lower(config: dict, settings, descs: list, device):
    n = config["nodes"]
    schedules = [schedule_of(d, n) for d in descs]
    return fleet.stack_members([
        fleet.lower_schedule(s, settings, device=device) for s in schedules])


def dispatch(f):
    return fleet.fleet_simulate(f.stacked, f.ticks, f.settings,
                                device=f.device)


def fold(f, out) -> list:
    return fleet_summaries(out[1])


def outputs(f, out) -> list:
    finals, logs = out[0], out[1]
    got = []
    for i in range(finals.member.shape[0]):
        cols = {name: getattr(logs, name)[i].to(torch.int64).cpu().numpy()
                for name in COLUMNS}
        (at,), props, n_prop = rows(logs.announce_now[i], logs.proposal[i])
        (dt,), decs, n_dec = rows(logs.decide_now[i], logs.decision[i])
        got.append({
            "columns": cols,
            "announce_ticks": at, "proposals": props, "proposal_bits": n_prop,
            "decide_ticks": dt, "decisions": decs, "decision_bits": n_dec,
            "member": finals.member[i].cpu().numpy(),
            "config": u64(cols["config_hi"][-1:], cols["config_lo"][-1:]),
        })
    return got
