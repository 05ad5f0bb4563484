"""The system under test: the port's fleet entry points, driven from a
cell's member descriptions (``traffic.generate``).

``build`` lowers every member and stacks them into one fleet (the
benchmark's set-up); ``Fleet.dispatch`` is the unit of work the window
repeats: the fleet's ``fleet_simulate`` (shared engine) or
``receiver_fleet_simulate`` (per-receiver engine, dense carry) from the
stacked boot state, for the scenario's ticks. ``Fleet.fold`` is the
telemetry fold of every member; ``Fleet.outputs`` reads what the
comparison judges to the host, in the form ``reference`` produces.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench.reference import receiver, shared

def settings_of(config: dict):
    from rapid_tpu_torch.settings import Settings

    keys = ("K", "H", "L", "tick_ms", "batching_window_ticks",
            "fd_interval_ticks", "fd_failure_threshold",
            "fallback_base_delay_ticks", "protocol_variant", "capacity",
            "rx_kernel", "delivery_ring_depth")
    return Settings(**{k: config[k] for k in keys if k in config})


def schedule_of(desc: dict, n: int):
    from rapid_tpu_torch.faults import (AdversarySchedule, LinkWindow,
                                        ScriptedPropose)

    windows = tuple(
        LinkWindow(src_slots=frozenset(w["src"]), dst_slots=frozenset(w["dst"]),
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


def build(config: dict, descs: list, ticks: int, device) -> "Fleet":
    """Lower and stack every member on ``device``; the fleet records the
    seconds the lowering and the stacking took (``lower_s``)."""
    from rapid_tpu_torch.engine import fleet

    settings = settings_of(config)
    n = config["nodes"]
    start = time.perf_counter()
    schedules = [schedule_of(d, n) for d in descs]
    if config["engine"] == "shared":
        stacked = fleet.stack_members([
            fleet.lower_schedule(s, settings, device=device)
            for s in schedules])
    else:
        stacked = fleet.stack_receiver_members([
            fleet.lower_receiver_schedule(s, settings, fleet_size=len(descs),
                                          device=device)
            for s in schedules])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return Fleet(config, settings, stacked, ticks, len(descs), device,
                 time.perf_counter() - start)


class Fleet:
    """One stacked fleet and the calls the window makes on it."""

    def __init__(self, config, settings, stacked, ticks, members, device,
                 lower_s):
        self.config = config
        self.settings = settings
        self.stacked = stacked
        self.ticks = ticks
        self.members = members
        self.device = device
        self.lower_s = lower_s
        self.shared = config["engine"] == "shared"

    def dispatch(self):
        """One run of every member for the scenario's ticks:
        ``(finals, logs)``, member axis first."""
        from rapid_tpu_torch.engine import fleet

        if self.shared:
            return fleet.fleet_simulate(self.stacked, self.ticks,
                                        self.settings, device=self.device)
        return fleet.receiver_fleet_simulate(self.stacked, self.ticks,
                                             self.settings,
                                             device=self.device)

    def fold(self, out) -> list:
        """Each member's run summary (a dict), through the program's own
        telemetry fold."""
        from rapid_tpu_torch.telemetry.metrics import (fleet_summaries,
                                                       summarize)

        finals, logs = out[0], out[1]
        if self.shared:
            sums = fleet_summaries(logs)
        else:
            from rapid_tpu_torch.engine.fleet import member_of
            from rapid_tpu_torch.engine.receiver import receiver_run_payload

            sums = [summarize(receiver_run_payload(
                member_of(finals, i), member_of(logs, i),
                self.config["nodes"], self.ticks).metrics())
                for i in range(self.members)]
        return [_summary_dict(s.as_dict()) for s in sums]

    def outputs(self, out) -> list:
        """Per member, what the comparison judges, on the host, in the
    form ``reference.shared.simulate`` / ``receiver.simulate`` give."""
        if self.shared:
            return _shared_outputs(out[0], out[1])
        return _receiver_outputs(out[0], out[1])


def _summary_dict(d: dict) -> dict:
    d = dict(d)
    d.pop("source", None)
    return d


def _u64(hi, lo) -> np.ndarray:
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(lo).astype(np.uint64)


def _rows(flags, planes):
    """``(index arrays, rows, bits)``: the ``[C]`` rows of ``planes``
    (``[T, ..., C]``) where ``flags`` (``[T, ...]``) is set, and the
    count of set bits anywhere in ``planes`` (so that none may lie
    elsewhere). The reference gives its rows in the same order."""
    idx = torch.nonzero(flags, as_tuple=True)
    return ([i.cpu().numpy() for i in idx], planes[idx].cpu().numpy(),
            int(planes.sum()))


def _shared_outputs(finals, logs) -> list:
    out = []
    for i in range(finals.member.shape[0]):
        cols = {name: getattr(logs, name)[i].to(torch.int64).cpu().numpy()
                for name in shared.COLUMNS}
        (at,), props, n_prop = _rows(logs.announce_now[i], logs.proposal[i])
        (dt,), decs, n_dec = _rows(logs.decide_now[i], logs.decision[i])
        out.append({
            "columns": cols,
            "announce_ticks": at, "proposals": props, "proposal_bits": n_prop,
            "decide_ticks": dt, "decisions": decs, "decision_bits": n_dec,
            "member": finals.member[i].cpu().numpy(),
            "config": _u64(cols["config_hi"][-1:], cols["config_lo"][-1:]),
        })
    return out


def _receiver_outputs(finals, logs) -> list:
    from rapid_tpu_torch.engine.receiver import receiver_final_view

    view = receiver_final_view(finals)
    out = []
    for i in range(view.member.shape[0]):
        cols = {name: getattr(logs, name)[i].to(torch.int64).cpu().numpy()
                for name in receiver.COLUMNS}
        ann = logs.announce[i]
        dec = logs.decide[i]
        (at, ar), props, n_prop = _rows(ann, logs.ann_prop[i])
        (dt, dr), hosts, n_host = _rows(dec, logs.dec_hosts[i])
        out.append({
            "columns": cols,
            "announce": ann.cpu().numpy(), "ann_props": props,
            "ann_prop_bits": n_prop,
            "ann_cfg": _u64(logs.ann_cfg_hi[i][at, ar].cpu(),
                            logs.ann_cfg_lo[i][at, ar].cpu()),
            "decide": dec.cpu().numpy(), "dec_hosts": hosts,
            "dec_host_bits": n_host,
            "dec_cfg": _u64(logs.dec_cfg_hi[i][dt, dr].cpu(),
                            logs.dec_cfg_lo[i][dt, dr].cpu()),
            "member": view.member[i].cpu().numpy(),
            "config": _u64(view.cfg_hi[i].cpu(), view.cfg_lo[i].cpu()),
            "stopped": view.stopped[i].cpu().numpy(),
        })
    return out
