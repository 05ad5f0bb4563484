"""The per-receiver engine: every process of a member keeps its own view
and receives only what its links let through. A fleet is lowered by
``engine.fleet.lower_receiver_schedule`` and ``stack_receiver_members``
and runs through ``receiver_fleet_simulate`` on the dense carry; each
member's summary is ``summarize`` of its ``receiver_run_payload``."""
from __future__ import annotations

import torch
from rapid_tpu_torch.engine import fleet
from rapid_tpu_torch.engine.receiver import (receiver_final_view,
                                             receiver_run_payload)
from rapid_tpu_torch.telemetry.metrics import summarize

from portbench.engines import rows, schedule_of, u64
from portbench.reference.receiver import COLUMNS

TICK_FUNCTIONS = (("rapid_tpu_torch.engine.receiver", "fleet_step"),)
ALTERED_COLUMN = "sent"


def lower(config: dict, settings, descs: list, device):
    n = config["nodes"]
    schedules = [schedule_of(d, n) for d in descs]
    return fleet.stack_receiver_members([
        fleet.lower_receiver_schedule(s, settings, fleet_size=len(descs),
                                      device=device)
        for s in schedules])


def dispatch(f):
    return fleet.receiver_fleet_simulate(f.stacked, f.ticks, f.settings,
                                         device=f.device)


def fold(f, out) -> list:
    finals, logs = out[0], out[1]
    return [summarize(receiver_run_payload(
        fleet.member_of(finals, i), fleet.member_of(logs, i),
        f.config["nodes"], f.ticks).metrics()) for i in range(f.members)]


def outputs(f, out) -> list:
    finals, logs = out[0], out[1]
    view = receiver_final_view(finals)
    got = []
    for i in range(view.member.shape[0]):
        cols = {name: getattr(logs, name)[i].to(torch.int64).cpu().numpy()
                for name in COLUMNS}
        ann = logs.announce[i]
        dec = logs.decide[i]
        (at, ar), props, n_prop = rows(ann, logs.ann_prop[i])
        (dt, dr), hosts, n_host = rows(dec, logs.dec_hosts[i])
        got.append({
            "columns": cols,
            "announce": ann.cpu().numpy(), "ann_props": props,
            "ann_prop_bits": n_prop,
            "ann_cfg": u64(logs.ann_cfg_hi[i][at, ar].cpu(),
                           logs.ann_cfg_lo[i][at, ar].cpu()),
            "decide": dec.cpu().numpy(), "dec_hosts": hosts,
            "dec_host_bits": n_host,
            "dec_cfg": u64(logs.dec_cfg_hi[i][dt, dr].cpu(),
                           logs.dec_cfg_lo[i][dt, dr].cpu()),
            "member": view.member[i].cpu().numpy(),
            "config": u64(view.cfg_hi[i].cpu(), view.cfg_lo[i].cpu()),
            "stopped": view.stopped[i].cpu().numpy(),
        })
    return got
