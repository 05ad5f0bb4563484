"""The port's single-member replay (``rapid_tpu_torch.replay``) against
the reference's: every triage exemplar of the reference's replay
campaign (``tests/test_replay.py``) replays, in either mode, to the
reference's own replay record, verified against the exemplar; tampered
exemplars fail; bad refs raise the reference's errors; the CLI round
trips; and exemplars of the committed ``benchmarks/campaign_4096.json``
verify on the CPU, with ``--oracle`` verdicts pinned to the
reference's."""
import copy
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from rapid_tpu import campaign as ref_campaign
from rapid_tpu import replay as ref_replay

from rapid_tpu_torch import campaign, golden, replay

ROOT = Path(__file__).resolve().parents[1]

#: ``tests/test_replay.py``'s campaign: seed 0 of the default mix with a
#: 24-row recorder flags churn members (shared) and slow_asym members
#: (per-receiver), so triage carries exemplars in both modes.
CFG = dict(clusters=8, n=24, ticks=120, fleet_size=4, spot_checks=0,
           flight_recorder=24)

#: Its exemplar refs (dispatch, member_index, mode).
EXEMPLARS = [(0, 1, "shared"), (0, 2, "shared"), (1, 1, "per_receiver"),
             (1, 3, "per_receiver")]


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def payload():
    """The reference's campaign payload, after a JSON round trip."""
    return json.loads(json.dumps(ref_campaign.run_campaign(
        ref_campaign.CampaignConfig(**CFG))))


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def committed(name: str = "campaign_4096.json") -> dict:
    return json.loads((ROOT / "benchmarks" / name).read_text())


def test_campaign_at_replay_config_equals_reference(payload):
    port = campaign.run_campaign(campaign.CampaignConfig(**CFG),
                                 device="cpu")
    assert json.dumps(golden.campaign_record(port)) == \
        json.dumps(golden.campaign_record(payload))
    refs = sorted({(ex["dispatch"], ex["member_index"], ex["mode"])
                   for block in payload["campaign"]["triage"]["classes"]
                   .values() for ex in block["exemplars"]
                   if ex["expected"] is not None})
    assert refs == EXEMPLARS


@pytest.mark.parametrize("d,j,mode", EXEMPLARS)
def test_exemplar_replays_as_the_reference(payload, d, j, mode):
    got = replay.replay_member(payload, d, j, lineage=True, device="cpu")
    want = ref_replay.replay_member(payload, d, j, lineage=True)
    assert json.dumps(got) == json.dumps(json.loads(json.dumps(want)))
    assert got["mode"] == mode
    assert (got["match"], got["recorder_match"], got["lineage_match"]) == \
        (True, True, True)
    assert got["mismatches"] is None
    assert got["recorder"]["window"] == CFG["flight_recorder"]


@pytest.mark.parametrize("what", ["expected", "recorder"])
def test_tampered_exemplar_fails_verification(payload, what):
    bad = copy.deepcopy(payload)
    ex = next(ex for block in bad["campaign"]["triage"]["classes"].values()
              for ex in block["exemplars"] if ex["mode"] == "shared")
    if what == "expected":
        ex["expected"]["counter_totals"]["sent"] += 1
    else:
        ex["recorder"]["stamps"]["first_announce"] += 1
    rec = replay.replay_member(bad, ex["dispatch"], ex["member_index"],
                               device="cpu")
    if what == "expected":
        assert rec["match"] is False
        assert set(rec["mismatches"]) == {"counter_totals"}
    else:
        assert rec["match"] is True and rec["recorder_match"] is False


@pytest.mark.parametrize("case", ["dispatch", "member", "pre_v8"])
def test_bad_refs_raise_the_reference_errors(payload, case):
    p, d, j = payload, 0, 1
    if case == "dispatch":
        d = 99
    elif case == "member":
        j = 99
    else:
        p = copy.deepcopy(payload)
        del p["campaign"]["weights"]
    with pytest.raises(ValueError) as want:
        ref_replay.replay_member(p, d, j)
    with pytest.raises(ValueError) as got:
        replay.replay_member(p, d, j, device="cpu")
    assert str(got.value) == str(want.value)


def test_cli_round_trip(payload, tmp_path, capsys):
    path = tmp_path / "campaign.json"
    path.write_text(json.dumps(payload))
    d, j, _ = EXEMPLARS[2]
    out = tmp_path / "replay.json"
    args = ["--payload", str(path), "--member", f"{d}:{j}", "--lineage",
            "--metrics", str(tmp_path / "m.jsonl"), "--out", str(out),
            "--device", "cpu"]
    assert replay.main(args) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert json.loads(out.read_text()) == record
    assert out.read_bytes().endswith(b"\n")
    assert record["match"] is True and record["lineage_match"] is True
    rows = (tmp_path / "m.jsonl").read_text().splitlines()
    assert len(rows) == CFG["ticks"]
    trace = tmp_path / "t.json"
    assert replay.main(["--payload", str(path), "--member", "0:1",
                        "--trace", str(trace), "--device", "cpu"]) == 0
    capsys.readouterr()
    assert "membership" in {
        e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    bad = copy.deepcopy(payload)
    for block in bad["campaign"]["triage"]["classes"].values():
        for ex in block["exemplars"]:
            if (ex["dispatch"], ex["member_index"]) == (d, j):
                ex["expected"]["decisions"] += 1
    path.write_text(json.dumps(bad))
    assert replay.main(args) == 1
    with pytest.raises(SystemExit):
        replay.main(["--payload", str(path), "--member", "x"])


@pytest.mark.parametrize("d,j", [(0, 1), (7, 58)])
def test_committed_exemplar_verifies(d, j):
    """``benchmarks/campaign_4096.json``'s exemplars 0:1 (shared churn)
    and 7:58 (per-receiver delay) replay verified on the CPU, their
    lineage equal to the reference's payload's (the golden file)."""
    rec = replay.replay_member(committed(), d, j, lineage=True,
                               device="cpu")
    assert (rec["match"], rec["recorder_match"]) == (True, True)
    want = golden.load(golden.CAMPAIGN_PATH)
    lineage = {(ex["dispatch"], ex["member_index"]): ex["lineage"]
               for block in want["campaign"]["triage"]["classes"].values()
               for ex in block["exemplars"]}
    assert rec["lineage"] == lineage[(d, j)]


@pytest.mark.parametrize("ref", ["5:0", "7:58"])
def test_oracle_verdicts_are_the_pinned_ones(ref):
    """The port's ``--oracle`` verdict on the committed exemplar is the
    reference's, as ``chip_smoke.REPLAY_ORACLE_VERDICTS`` pins it."""
    d, j = map(int, ref.split(":"))
    rec = replay.replay_member(committed(), d, j, oracle=True, device="cpu")
    assert rec["oracle"]["run"] is True
    assert rec["oracle"]["passed"] is chip_smoke().REPLAY_ORACLE_VERDICTS[ref]


@pytest.mark.slow
@pytest.mark.parametrize("ref", ["5:0", "7:58"])
def test_reference_oracle_verdicts(ref):
    """The pinned verdicts come from the reference's own replay."""
    d, j = map(int, ref.split(":"))
    rec = ref_replay.replay_member(committed(), d, j, oracle=True)
    assert rec["oracle"]["passed"] is chip_smoke().REPLAY_ORACLE_VERDICTS[ref]
