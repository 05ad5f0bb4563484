"""The port's campaign runner (``rapid_tpu_torch.campaign``) against the
reference's, field by field after a JSON round trip.

Each campaign runs in both packages on the CPU; the payloads, with the
machine-dependent keys of ``tests/test_campaign.py`` left out, must
serialise to the same JSON. Also: spot checks (a forced member ``-1``,
failures recorded through ``max_spot_failures``), the pipelined and the
serial loop, a tournament, the campaign validators, the per-receiver
state bytes, and ``chip_smoke.py``'s copy of ``bench_compare``'s exact
checks.

Run as a script, the file writes
``rapid_tpu_torch/testdata/campaign_4096_reference.json`` from the
reference (about 300 s)::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_campaign.py
"""
import copy
import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from rapid_tpu import campaign as ref_campaign
from rapid_tpu import faults as ref_faults
from rapid_tpu.engine import diff as ref_diff
from rapid_tpu.engine import receiver as ref_receiver
from rapid_tpu.engine import rx_packed as ref_rx_packed
from rapid_tpu.settings import Settings as RefSettings
from rapid_tpu.telemetry import schema as ref_schema
from rapid_tpu.telemetry.forensics import DivergenceError as RefDivergence

from rapid_tpu_torch import campaign, faults, golden
from rapid_tpu_torch.engine import diff, receiver, rx_packed
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry import schema
from rapid_tpu_torch.telemetry.forensics import DivergenceError

ROOT = Path(__file__).resolve().parents[1]

#: ``tests/test_campaign.py``'s TINY (seed 9 of the default mix: latency
#: members only) and STRADDLE (two crash and two partition members, both
#: dispatch modes); STRADDLE with two spot checks picks its partition
#: member and forces a contested one (member -1).
CONFIGS = {
    "tiny": dict(clusters=6, n=16, ticks=80, seed=9, fleet_size=3,
                 headroom=8, spot_checks=0),
    "straddle": dict(clusters=4, n=16, ticks=60, seed=1, fleet_size=2,
                     headroom=8, weights=("crash", "partition")),
    "straddle_spot": dict(clusters=4, n=16, ticks=60, seed=1, fleet_size=2,
                          headroom=8, weights=("crash", "partition"),
                          spot_checks=2),
}

#: A tournament at N=16 with a per-receiver kind, so "rapid" runs both
#: modes and "ring" routes every member to the shared engine.
TOURNAMENT = dict(clusters=4, n=16, ticks=60, seed=3, fleet_size=2,
                  headroom=8, weights=("crash", "partition", "contested",
                                       "churn"))


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def configs(kw: dict):
    """The reference's and the port's ``CampaignConfig`` of ``kw`` (its
    ``weights`` a tuple of the kinds at weight 1)."""
    kw = dict(kw)
    kinds = kw.pop("weights", None)
    out = []
    for mod, fmod in ((ref_campaign, ref_faults), (campaign, faults)):
        weights = None if kinds is None else fmod.ScenarioWeights(
            **{k: float(k in kinds) for k in fmod.SCENARIO_KINDS})
        out.append(mod.CampaignConfig(weights=weights, **kw))
    return out


_RUNS = {}


def runs(name: str):
    """The reference's and the port's payloads of ``CONFIGS[name]``, run
    once per session."""
    if name not in _RUNS:
        ref_cfg, port_cfg = configs(CONFIGS[name])
        _RUNS[name] = (ref_campaign.run_campaign(ref_cfg),
                       campaign.run_campaign(port_cfg, device="cpu"))
    return _RUNS[name]


def same_json(a, b) -> bool:
    return json.dumps(a) == json.dumps(b)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_campaign_equals_reference(name):
    ref, port = runs(name)
    assert same_json(golden.campaign_record(port),
                     golden.campaign_record(ref)), golden.differences(
        golden.campaign_record(port), golden.campaign_record(ref))
    assert port["platform"] == "cpu"
    assert schema.validate_bench_payload(json.loads(json.dumps(port))) == []
    assert ref_schema.validate_bench_payload(
        json.loads(json.dumps(port))) == []
    timeline = port["dispatch_timeline"]
    assert sum(r["members"] for r in timeline) == port["clusters"]
    assert {p["pool_id"] for p in port["observatory"]["compile"]["pools"]} \
        == {r["pool_id"] for r in timeline if r["compiled"]}
    for row in port["observatory"]["compile"]["pools"]:
        assert set(row) == set(schema.AOT_COMPILE_SPEC) | {"pool_id", "mode"}
    if name == "straddle_spot":
        spot = port["campaign"]["spot_checks"]
        assert spot["run"] == 2 and spot["passed"] == 2
        assert [m["member"] for m in spot["members"]][1] == -1
        assert [m["kind"] for m in spot["members"]] == ["partition",
                                                        "contested"]


def test_pipelined_run_matches_serial():
    _, port = runs("tiny")
    _, port_cfg = configs(CONFIGS["tiny"])
    serial = campaign.run_campaign(
        dataclasses.replace(port_cfg, pipeline=False), device="cpu")
    assert same_json(golden.campaign_record(serial),
                     golden.campaign_record(port))
    assert serial["observatory"]["pipeline"] == {
        "enabled": False, "max_in_flight": 1, "peak_in_flight": 1}
    assert port["observatory"]["pipeline"]["max_in_flight"] == 2


class _Diverging:
    """A differential result that always diverges, as the reference's
    graceful-degradation test forces one."""

    def __init__(self, error_cls):
        self.error_cls = error_cls

    def assert_identical(self, artifact=None):
        from types import SimpleNamespace

        if artifact:
            with open(artifact, "w") as fh:
                fh.write('{"synthetic": true}\n')
        report = SimpleNamespace(render=lambda: "synthetic divergence")
        raise self.error_cls(report, artifact)


def test_spot_failures_recorded_as_the_reference(monkeypatch, tmp_path):
    ref_run = lambda schedule, n_ticks, settings=None: _Diverging(
        RefDivergence)
    port_run = lambda schedule, n_ticks, settings=None, device=None: \
        _Diverging(DivergenceError)
    for name in ("run_receiver_differential", "run_adversarial_differential"):
        monkeypatch.setattr(ref_diff, name, ref_run)
        monkeypatch.setattr(diff, name, port_run)
    kw = dict(CONFIGS["straddle_spot"], max_spot_failures=2)
    ref_cfg, port_cfg = configs(kw)
    for sub in ("ref", "port", "ref2", "port2"):
        (tmp_path / sub).mkdir()
    ref = ref_campaign.run_campaign(dataclasses.replace(
        ref_cfg, artifact_dir=str(tmp_path / "ref")))
    port = campaign.run_campaign(dataclasses.replace(
        port_cfg, artifact_dir=str(tmp_path / "port")), device="cpu")
    blocks = []
    for payload, sub in ((ref, "ref"), (port, "port")):
        block = json.loads(json.dumps(payload["campaign"]))
        for rec in block["spot_checks"]["members"]:
            assert rec["artifact"].startswith(str(tmp_path / sub))
            assert Path(rec["artifact"]).read_text() == \
                '{"synthetic": true}\n'
            rec["artifact"] = Path(rec["artifact"]).name
        blocks.append(block)
    assert same_json(blocks[1], blocks[0])
    spot = blocks[1]["spot_checks"]
    assert (spot["run"], spot["failed"], spot["max_failures"]) == (2, 2, 2)
    assert blocks[1]["triage"]["classes"]["spot_failures"]["count"] == 2
    assert schema.validate_bench_payload(json.loads(json.dumps(port))) == []

    messages = []
    for mod, cfg, sub in ((ref_campaign, ref_cfg, "ref2"),
                          (campaign, port_cfg, "port2")):
        kwargs = {} if mod is ref_campaign else {"device": "cpu"}
        with pytest.raises(RuntimeError, match="spot-check divergence") \
                as err:
            mod.run_campaign(dataclasses.replace(
                cfg, max_spot_failures=0, artifact_dir=str(tmp_path / sub)),
                **kwargs)
        messages.append(str(err.value).replace(str(tmp_path / sub), "DIR"))
    assert messages[1] == messages[0]


def test_tournament_equals_reference():
    ref_cfg, port_cfg = configs(TOURNAMENT)
    ref = ref_campaign.run_tournament(ref_cfg, ["rapid", "ring"])
    port = campaign.run_tournament(port_cfg, ["rapid", "ring"],
                                   device="cpu")
    assert same_json(golden.campaign_record(port),
                     golden.campaign_record(ref))
    block = port["campaign"]["tournament"]
    assert block["variants"] == ["rapid", "ring"]
    assert schema.validate_tournament(block) == []
    assert schema.validate_bench_payload(json.loads(json.dumps(port))) == []


def test_tournament_and_variant_refusals_match_the_reference():
    for kw in (dict(CONFIGS["tiny"], protocol_variant="ring"),
               dict(CONFIGS["tiny"], protocol_variant="bogus"),
               dict(CONFIGS["straddle"], protocol_variant="hier",
                    spot_checks=1)):
        ref_cfg, port_cfg = configs(kw)
        with pytest.raises(ValueError) as want:
            ref_campaign.run_campaign(ref_cfg)
        with pytest.raises(ValueError) as got:
            campaign.run_campaign(port_cfg, device="cpu")
        assert str(got.value) == str(want.value)
    ref_cfg, port_cfg = configs(CONFIGS["tiny"])
    for variants in (["rapid"], ["rapid", "rapid"]):
        with pytest.raises(ValueError) as want:
            ref_campaign.run_tournament(ref_cfg, variants)
        with pytest.raises(ValueError) as got:
            campaign.run_tournament(port_cfg, variants, device="cpu")
        assert str(got.value) == str(want.value)


def test_fleet_shard_is_refused(monkeypatch):
    """``fleet_shard`` beyond the visible cards is refused with their
    count before anything is sampled or placed."""
    _, port_cfg = configs(CONFIGS["tiny"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 devices for the fleet "
                                         "mesh, have 1"):
        campaign.run_campaign(dataclasses.replace(port_cfg, fleet_shard=2),
                              device="cuda")


@pytest.mark.parametrize("fleet_shard", [1, 2])
def test_fleet_shard_equals_reference(fleet_shard):
    """STRADDLE with each dispatch split over a fleet mesh of CPU entries
    (both dispatch modes, one member a shard at 2): the payload equals
    the reference's unsharded one on every non-wall field, as the
    reference's ``fleet_shard`` promises."""
    ref, _ = runs("straddle")
    _, port_cfg = configs(CONFIGS["straddle"])
    port = campaign.run_campaign(
        dataclasses.replace(port_cfg, fleet_shard=fleet_shard), device="cpu")
    assert same_json(golden.campaign_record(port),
                     golden.campaign_record(ref)), golden.differences(
        golden.campaign_record(port), golden.campaign_record(ref))


def _broken(payload: dict, how: str) -> dict:
    """``payload`` with one defect of the kinds the validators check."""
    p = copy.deepcopy(payload)
    camp = p["campaign"]
    if how == "no_lineage":
        del camp["lineage"]
    elif how == "pool_id":
        camp["pools"][0]["pool_id"] = 7
    elif how == "unknown_stage":
        p["dispatch_timeline"][0]["stages"]["warmup"] = 0.5
    elif how == "triage_class":
        del camp["triage"]["classes"]["slow_decide"]
    elif how == "exemplar_field":
        ex = next(ex for b in camp["triage"]["classes"].values()
                  for ex in b["exemplars"])
        ex["expected"]["flags"] = "0"
    elif how == "regime":
        camp["delay_regimes"]["warp"] = camp["delay_regimes"]["no_delay"]
    elif how == "variant":
        camp["protocol_variant"] = "gossip"
    elif how == "per_receiver":
        camp["per_receiver"]["members"] = 2.0
    elif how == "observatory":
        del p["observatory"]["compile"]["pools"]
    elif how == "stage_sum":
        p["wall_s"] = 10 * max(p["wall_s"], 1.0)
    elif how == "distribution":
        del camp["distributions"]["total_sent"]
    elif how == "tournament":
        camp["tournament"] = {"variants": ["rapid", "gossip"],
                              "clusters": 1, "per_variant": {},
                              "win_loss": {"crash": {"rapid": 1}}}
    return p


BROKEN = ("none", "no_lineage", "pool_id", "unknown_stage", "triage_class",
          "exemplar_field", "regime", "variant", "per_receiver",
          "observatory", "stage_sum", "distribution", "tournament")


@pytest.mark.parametrize("how", BROKEN)
def test_validators_match_the_reference(how):
    """The port's validators accept the reference's payload and reject
    each broken copy with the reference's own messages."""
    ref, _ = runs("straddle")
    payload = _broken(json.loads(json.dumps(ref)), how)
    want = ref_schema.validate_bench_payload(payload)
    assert schema.validate_bench_payload(payload) == want
    assert (want == []) == (how == "none")


def test_progress_stream_validates_as_the_reference(tmp_path):
    _, port_cfg = configs(CONFIGS["straddle"])
    path = tmp_path / "progress.jsonl"
    payload = campaign.run_campaign(port_cfg, progress_path=str(path),
                                    trace_path=str(tmp_path / "t.json"),
                                    device="cpu")
    lines = path.read_text().splitlines()
    assert schema.validate_progress_stream(lines) == []
    assert ref_schema.validate_progress_stream(lines) == []
    beats = [json.loads(ln) for ln in lines]
    assert [b["record"] for b in beats] == \
        ["dispatch"] * payload["dispatches"] + ["campaign"]
    broken = [json.dumps(dict(beats[0], anomalies={"warp": 1.5}))]
    assert schema.validate_progress_stream(broken) == \
        ref_schema.validate_progress_stream(broken) != []
    trace = json.loads((tmp_path / "t.json").read_text())
    assert {"sample", "lower", "stack", "compile", "execute", "fold"} <= \
        {e.get("name") for e in trace["traceEvents"]}


@pytest.mark.parametrize("c", [16, 32, 64, 4096])
def test_state_bytes_equal_the_reference(c):
    assert receiver.receiver_state_bytes(c, 10) == \
        ref_receiver.receiver_state_bytes(c, 10)
    for kernel in ("packed", "pallas"):
        assert rx_packed.bundle_state_bytes(
            c, Settings(rx_kernel=kernel, capacity=c)) == \
            ref_rx_packed.bundle_state_bytes(
                c, RefSettings(rx_kernel=kernel, capacity=c))


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


PERTURB = ("none", "telemetry", "run_count", "campaign", "timeline",
           "timeline_length", "config")


@pytest.mark.parametrize("how", PERTURB)
def test_chip_smoke_exact_checks_match_bench_compare(how):
    """``chip_smoke.exact_errors`` (a copy, since ``bench_compare.py``
    imports the reference) reports what ``compare_run`` reports."""
    chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    bench_compare = _load("bench_compare", ROOT / "scripts" /
                          "bench_compare.py")
    base = golden.load(golden.CAMPAIGN_PATH)
    cur = copy.deepcopy(base)
    if how == "telemetry":
        cur["telemetry"]["total_sent"] += 1
    elif how == "run_count":
        cur["decisions"] += 1
    elif how == "campaign":
        cur["campaign"]["triage"]["classes"]["slow_decide"]["count"] += 1
    elif how == "timeline":
        cur["dispatch_timeline"][3]["padding"]["window_rows"] += 1
    elif how == "timeline_length":
        cur["dispatch_timeline"].pop()
    elif how == "config":
        cur["fleet_size"] += 1
    want, _ = bench_compare.compare_run(cur, base, "campaign_4096", 0.3)
    assert chip_smoke.exact_errors(cur, base, "campaign_4096") == want
    assert (want == []) == (how == "none")


def test_golden_campaign_matches_the_committed_payload():
    """Phase 25 holds the card's payload to the golden file and to
    ``benchmarks/campaign_4096.json``; the two agree on every key the
    committed file has but ``per_receiver.capacity_cap`` (raised from
    1,024 to 4,096 after the file was written)."""
    chip_smoke = _load("chip_smoke", ROOT / "chip_smoke.py")
    want = golden.load(golden.CAMPAIGN_PATH)
    file_campaign = json.loads(
        (ROOT / "benchmarks" / "campaign_4096.json").read_text())["campaign"]
    cap = ".per_receiver.capacity_cap"
    assert chip_smoke.committed_errors(file_campaign, want["campaign"]) == \
        [cap]
    assert chip_smoke.committed_errors(file_campaign, want["campaign"],
                                       skip=(cap,)) == []
    assert want["campaign"]["per_receiver"]["capacity_cap"] == 4096
    assert (want["clusters"], want["dispatches"]) == (4096, 18)
    assert want["campaign"]["per_receiver"]["dispatches"] * 120 * 6 == \
        chip_smoke.CAMPAIGN_LAUNCHES == 7920


def reference_record() -> dict:
    """The reference's payload at ``golden.CAMPAIGN_4096`` without its wall
    keys."""
    return golden.campaign_record(ref_campaign.run_campaign(
        ref_campaign.CampaignConfig(**golden.CAMPAIGN_4096)))


@pytest.mark.slow
def test_campaign_golden_file_is_current():
    assert reference_record() == golden.load(golden.CAMPAIGN_PATH)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["fleet", "tournament"])
def test_reference_reproduces_committed_payload(name):
    """Phase 27's targets are reachable: the reference reproduces
    ``baseline.json``'s ``fleet`` entry and ``campaign_tournament.json``
    with no error from ``compare_run``."""
    bench_compare = _load("bench_compare", ROOT / "scripts" /
                          "bench_compare.py")
    if name == "fleet":
        want = json.loads((ROOT / "benchmarks" / "baseline.json")
                          .read_text())["fleet"]
        got = ref_campaign.run_campaign(ref_campaign.CampaignConfig(
            clusters=128, n=64, ticks=120, seed=0, fleet_size=64))
    else:
        want = json.loads((ROOT / "benchmarks" /
                           "campaign_tournament.json").read_text())
        camp = want["campaign"]
        got = ref_campaign.run_tournament(ref_campaign.CampaignConfig(
            clusters=camp["clusters"], n=camp["n"], ticks=camp["ticks"],
            seed=camp["seed"], fleet_size=camp["fleet_size"],
            headroom=camp["headroom"],
            weights=ref_faults.ScenarioWeights(**camp["weights"])),
            ["rapid", "ring"])
    errors, _ = bench_compare.compare_run(json.loads(json.dumps(got)), want,
                                          name, 0.3)
    assert errors == []


if __name__ == "__main__":
    golden.CAMPAIGN_PATH.write_text(golden.dumps(reference_record()))
    print("wrote", golden.CAMPAIGN_PATH,
          golden.CAMPAIGN_PATH.stat().st_size, "bytes")
