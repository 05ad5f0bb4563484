"""The port stands alone: it imports neither JAX nor the reference
package, and its entry points run on the card unless asked otherwise."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import rapid_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rapid_tpu_torch.__path__,
                                               "rapid_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "rapid_tpu" or m.startswith("rapid_tpu."))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    assert "rapid_tpu_torch.engine.receiver" in result["modules"]
    assert "rapid_tpu_torch.engine.rx_account" in result["modules"]
    assert "rapid_tpu_torch.engine.step" in result["modules"]
    assert "rapid_tpu_torch.engine.churn" in result["modules"]
    assert "rapid_tpu_torch.engine.sharding" in result["modules"]
    assert "rapid_tpu_torch.multichip" in result["modules"]
    assert "rapid_tpu_torch.telemetry.metrics" in result["modules"]
    assert "rapid_tpu_torch.telemetry.lineage" in result["modules"]
    for name in ("events", "engine.adversary", "engine.diff",
                 "variants.oracle", "oracle.interfaces", "oracle.metadata",
                 "oracle.failure_detector", "oracle.testkit", "oracle.paxos",
                 "oracle.service", "oracle.simulation", "oracle.cluster",
                 "campaign", "replay", "variants", "service",
                 "service.checkpoint", "service.traffic", "service.servo",
                 "service.status", "service.resident", "service.rx_resident",
                 "service.__main__", "telemetry.profile",
                 "telemetry.schema"):
        assert f"rapid_tpu_torch.{name}" in result["modules"], name


def _entry_points():
    from rapid_tpu_torch import campaign, golden, replay, service
    from rapid_tpu_torch.service import __main__ as service_main
    from rapid_tpu_torch.convert import from_reference
    from rapid_tpu_torch.engine import (churn, diff, paxos, receiver,
                                        sharding, state, step)
    from rapid_tpu_torch.faults import crash_window_delay_schedule
    from rapid_tpu_torch.identity import default_identities
    from rapid_tpu_torch.settings import Settings
    from rapid_tpu_torch.telemetry import profile

    settings = Settings(rx_kernel="pallas")
    uids, id_fp_sum = default_identities(8)
    return {
        "lower_receiver_schedule": lambda: receiver.lower_receiver_schedule(
            crash_window_delay_schedule(16), settings),
        "init_receiver_state": lambda: receiver.init_receiver_state(
            uids, id_fp_sum, settings, seed=1),
        "link_faults": lambda: state.link_faults([5] * 8, (), 8),
        "crash_faults": lambda: state.crash_faults([5] * 8),
        "from_reference": lambda: from_reference(state.EngineFaults(
            crash_tick=[1, 2])),
        "init_state": lambda: state.init_state(uids, id_fp_sum, settings),
        "from_reference(ChurnSchedule)": lambda: from_reference(
            churn.empty_schedule(8)),
        "from_reference(FallbackSchedule)": lambda: from_reference(
            paxos.empty_fallback_schedule(8)),
        "SharedScenario.boot": lambda: golden.SHARED[
            "shared_n1000_churn"].boot(),
        "run_differential": lambda: diff.run_differential(8, {2: 3}, 10),
        "run_churn_differential": lambda: diff.run_churn_differential(
            8, 9, 10, joins={8: 2}),
        "run_fallback_differential": lambda: diff.run_fallback_differential(
            8, [[0], [1]], {s: (6, s % 2) for s in range(8)},
            {s: 10 + s for s in range(8)}, 10),
        "run_variant_differential": lambda: diff.run_variant_differential(
            8, {2: 3}, 10, "ring"),
        "run_receiver_differential": lambda: diff.run_receiver_differential(
            crash_window_delay_schedule(16), 10, settings),
        "run_lineage_differential": lambda: diff.run_lineage_differential(
            "steady", 8, 10),
        "run_campaign": lambda: campaign.run_campaign(
            campaign.CampaignConfig(clusters=2, n=8, ticks=10,
                                    fleet_size=2)),
        "run_tournament": lambda: campaign.run_tournament(
            campaign.CampaignConfig(clusters=2, n=8, ticks=10,
                                    fleet_size=2), ["rapid", "ring"]),
        "replay_member": lambda: replay.replay_member(
            golden.load(golden.CAMPAIGN_PATH), 0, 1),
        "simulate": lambda: step.simulate(
            state.init_state(uids, id_fp_sum, settings, device="cpu"),
            state.crash_faults([5] * 8, device="cpu"), 1, settings),
        "simulate_chunk": lambda: step.simulate_chunk(
            state.init_state(uids, id_fp_sum, settings, device="cpu"),
            state.crash_faults([5] * 8, device="cpu"), 1, settings),
        "boot_resident": lambda: service.boot_resident(
            Settings(), 24, 10),
        "boot_resident_receiver": lambda: service.boot_resident_receiver(
            Settings(), 16, horizon_ticks=32, chunk_ticks=16),
        "load_checkpoint": lambda: service.load_checkpoint(
            str(golden.CHECKPOINT_DIR / "engine")),
        "ResidentEngine.restore": lambda: service.ResidentEngine.restore(
            str(golden.CHECKPOINT_DIR / "engine"),
            state.crash_faults([state.I32_MAX] * 96, device="cpu"),
            Settings(stream_chunk_ticks=512, flight_recorder_window=8)),
        "service --soak": lambda: service_main.main(
            ["--soak", "--ticks", "64", "--chunk", "32"]),
        "telemetry.profile": lambda: profile.main(["--sizes", "64"]),
        "dominance_report": lambda: profile.dominance_report(
            [64], Settings()),
        "slot_mesh": lambda: sharding.slot_mesh(1),
        "fleet_axis_mesh": lambda: sharding.fleet_axis_mesh(1),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_default_device_is_cuda_and_raises_without_one(name, monkeypatch):
    from rapid_tpu_torch.device import NoCudaDeviceError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        _entry_points()[name]()


def test_chip_smoke_alone_fails_without_result(tmp_path):
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
