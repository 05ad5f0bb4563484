"""The port's kernel-cost observatory against the JAX reference.

``votes.scan_vote_count`` against the reference's and against the port's
``count_fast_round``; the per-member byte counts of both carry layouts;
``telemetry.profile.synthetic_state`` and the nine sub-kernels of
``kernel_cases`` at N=256 against the reference's closures, output by
output; the receiver-memory and variant blocks, and a whole payload at
N=256, against the committed ``benchmarks/dominance_report.json`` (both
packages' validators, ``scripts/bench_compare.py`` and the port's copy of
its rules, ``golden.profile_sweep_errors``); the schema CLI of both
packages on every committed payload. Everything compared is integer or
bool: the tolerance is exact. Walls, temp and peak bytes are not
compared: they are the machine's.
"""
import copy
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_tpu.engine import paxos as ref_paxos
from rapid_tpu.engine import rx_packed as ref_rx_packed
from rapid_tpu.engine import votes as ref_votes
from rapid_tpu.settings import Settings as RefSettings
from rapid_tpu.telemetry import profile as ref_profile
from rapid_tpu.telemetry import schema as ref_schema

from rapid_tpu_torch import golden
from rapid_tpu_torch.convert import from_reference, to_numpy
from rapid_tpu_torch.device import NoCudaDeviceError
from rapid_tpu_torch.engine import paxos, rx_packed, votes
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry import profile, schema

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "benchmarks" / "dominance_report.json"
N = 256


def _committed() -> dict:
    return json.loads(COMMITTED.read_text())


def _bench_compare():
    spec = importlib.util.spec_from_file_location(
        "bench_compare", ROOT / "scripts" / "bench_compare.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ---------------------------------------------------------------------------
# scan_vote_count
# ---------------------------------------------------------------------------

_ref_scan = jax.jit(lambda hi, lo, valid: ref_votes.scan_vote_count(
    jnp, hi, lo, valid))


def _votes_equal(hi: np.ndarray, lo: np.ndarray, valid: np.ndarray) -> None:
    want = np.asarray(_ref_scan(hi, lo, valid))
    args = (torch.from_numpy(hi.astype(np.int64)),
            torch.from_numpy(lo.astype(np.int64)), torch.from_numpy(valid))
    got = votes.scan_vote_count(*args)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, votes.segmented_vote_count(*args))
    _, winner = votes.count_fast_round(*args, torch.tensor(len(hi)))
    assert int(winner) == int(want.max())


@pytest.mark.parametrize("c", [1, 7, 64, 257])
def test_scan_vote_count_equals_the_reference(c):
    rng = np.random.default_rng(c)
    for _ in range(50):
        pool = rng.integers(0, 2**32, (rng.integers(1, 5), 2),
                            dtype=np.uint64).astype(np.uint32)
        votes_ = pool[rng.integers(0, len(pool), c)]
        valid = rng.random(c) < rng.random()
        _votes_equal(votes_[:, 0], votes_[:, 1], valid)


@pytest.mark.parametrize("case", ["all_invalid", "all_equal"])
def test_scan_vote_count_edge_cases(case):
    rng = np.random.default_rng(5)
    for c in (1, 7, 64, 257):
        if case == "all_invalid":
            hi = rng.integers(0, 3, c).astype(np.uint32)
            lo = rng.integers(0, 3, c).astype(np.uint32)
            valid = np.zeros(c, bool)
        else:
            hi = np.full(c, 0xDEADBEEF, np.uint32)
            lo = np.full(c, 7, np.uint32)
            valid = rng.random(c) < 0.8
        _votes_equal(hi, lo, valid)


# ---------------------------------------------------------------------------
# per-member bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [64, 256, 1024, 4096])
def test_state_bytes_equal_the_reference(c):
    dense, packed = Settings(), Settings(rx_kernel="packed")
    ref_dense, ref_packed = RefSettings(), RefSettings(rx_kernel="packed")
    assert rx_packed.dense_state_bytes(c, dense) == \
        ref_rx_packed.dense_state_bytes(c, ref_dense)
    assert rx_packed.packed_state_bytes(c, packed) == \
        ref_rx_packed.packed_state_bytes(c, ref_packed)
    assert rx_packed.bundle_state_bytes(c, packed) == \
        ref_rx_packed.bundle_state_bytes(c, ref_packed)


# ---------------------------------------------------------------------------
# the snapshot and the nine sub-kernels at N=256
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_cases():
    state, faults = ref_profile.synthetic_state(N, RefSettings())
    c = int(state.member.shape[0])
    cases = ref_profile.kernel_cases(
        state, faults, RefSettings(),
        fallback=ref_paxos.empty_fallback_schedule(c))
    return state, faults, {name: (fn, args) for name, fn, args in cases}


@pytest.fixture(scope="module")
def port_cases():
    state, faults = profile.synthetic_state(N, Settings(), device="cpu")
    fallback = from_reference(paxos.empty_fallback_schedule(N), "cpu")
    cases = profile.kernel_cases(state, faults, Settings(), fallback)
    return state, faults, {name: (fn, args) for name, fn, args in cases}


def _flat(tree, port: bool):
    """Leaves as ``(path, numpy array)`` in the reference's dtypes."""
    if hasattr(tree, "_fields"):
        fields = to_numpy(tree) if port else tree
        return [(f"{type(tree).__name__}.{name}", np.asarray(leaf))
                for name, leaf in zip(tree._fields, fields)]
    if isinstance(tree, dict):  # a jitted result has its keys sorted
        return [(f"{k}.{p}", a) for k, v in sorted(tree.items())
                for p, a in _flat(v, port)]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}].{p}", a) for i, v in enumerate(tree)
                for p, a in _flat(v, port)]
    return [("", np.asarray(tree.numpy() if port else tree))]


def _assert_same(got, want) -> None:
    got, want = _flat(got, True), _flat(want, False)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_synthetic_state_equals_the_reference(ref_cases, port_cases):
    _assert_same(port_cases[0], ref_cases[0])
    assert to_numpy(port_cases[1])["crash_tick"].tolist() == \
        np.asarray(ref_cases[1].crash_tick).tolist()


@pytest.mark.parametrize("name", profile.KERNEL_ORDER)
def test_kernel_case_outputs_equal_the_reference(name, ref_cases,
                                                 port_cases):
    fn, args = port_cases[2][name]
    ref_fn, ref_args = ref_cases[2][name]
    got = fn(*args)
    if name == "cut_aggregate":
        assert got[-1] is bool(got[2])  # the port's one read: announce
        got = got[:-1]
    elif name == "paxos_phase1a_deliver":  # the port's one count is bare
        got = (got[0], {"px1b_senders": got[1]})
    _assert_same(got, jax.jit(ref_fn)(*ref_args))


def test_kernel_cases_cover_the_reference_order(port_cases):
    assert list(port_cases[2]) == list(profile.KERNEL_ORDER)
    state, faults, _ = port_cases
    lean = profile.kernel_cases(state, faults, Settings())
    assert [name for name, _, _ in lean] == [
        "topology_rebuild", "monitor", "cut_aggregate", "vote_count",
        "full_step"]


# ---------------------------------------------------------------------------
# the blocks and the payload against the committed report
# ---------------------------------------------------------------------------


def test_receiver_memory_block_equals_the_committed_report():
    got = profile.receiver_memory_block(Settings(), n=64,
                                        fleet_sizes=(4, 64), device="cpu")
    want = _committed()["receiver_memory"]
    for key in ("n", "capacity", "k", "member_state_bytes",
                "member_state_bytes_packed", "bytes_per_member_curve"):
        assert got[key] == want[key], key
    for layout in ("fleets", "packed_fleets"):
        for fleet, base in zip(got[layout], want[layout], strict=True):
            assert fleet["fleet_size"] == base["fleet_size"]
            for key in ("argument_bytes", "output_bytes"):
                assert fleet[key] == base[key], (layout, fleet["fleet_size"])
            # The CPU has no card allocator: 0, "not measured".
            assert fleet["temp_bytes"] == fleet["peak_bytes"] == 0


def test_variant_block_equals_the_committed_report():
    want = _committed()["variants"]
    got = profile.variant_sweep_block(Settings(), want["sizes"], repeats=1,
                                      device="cpu")
    assert got["sizes"] == want["sizes"]
    assert got["budget_bytes"] == want["budget_bytes"]
    assert got["refusals"] == want["refusals"]
    assert [(k["kernel"], k["n"], k["argument_bytes"], k["output_bytes"])
            for k in got["kernels"]] == \
        [(k["kernel"], k["n"], k["argument_bytes"], k["output_bytes"])
         for k in want["kernels"]]


@pytest.fixture(scope="module")
def payload_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("profile") / "report.json"
    assert profile.main(["--device", "cpu", "--sizes", str(N), "--repeats",
                         "1", "--variant-sizes", "4096", "1000000",
                         "--out", str(path)]) == 0
    return path


def test_payload_passes_both_validators_and_bench_compare(payload_path):
    payload = json.loads(payload_path.read_text())
    assert payload["platform"] == "cpu" and payload["multichip"] is None
    assert schema.validate_bench_payload(payload) == []
    assert ref_schema.validate_bench_payload(payload) == []
    errors, _ = golden.profile_sweep_errors(payload, _committed())
    assert errors == []
    out = subprocess.run([sys.executable, "scripts/bench_compare.py",
                          str(payload_path)], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "bench_compare: ok" in out.stdout


def _corrupt(payload: dict, how: str) -> dict:
    bad = copy.deepcopy(payload)
    run = bad["runs"][0]
    if how == "unknown_dominant":
        run["dominant"]["wall_clock"] = "warp_drive"
    elif how == "schema_version_up":
        bad["schema_version"] += 1
    elif how == "schema_version_missing":
        del bad["schema_version"]
    elif how == "missing_flops":
        del run["kernels"][0]["flops"]
    elif how == "missing_kernel":
        del run["kernels"][3]
    elif how == "slow_walls":
        for k in run["kernels"] + bad["variants"]["kernels"]:
            k["wall_median_s"] = 1e3
    elif how == "k_mismatch":
        run["k"] = 3
    elif how == "unknown_n":
        run["n"] = 12345
    elif how == "member_bytes":
        bad["receiver_memory"]["member_state_bytes"] += 4
    elif how == "fleet_bytes":
        bad["receiver_memory"]["fleets"][0]["argument_bytes"] -= 4
        bad["receiver_memory"]["packed_fleets"] = []
        bad["receiver_memory"]["fleets"][1]["fleet_size"] = 3
    elif how == "fleet_peak":
        bad["receiver_memory"]["fleets"][0]["peak_bytes"] = 10**12
    elif how == "curve":
        bad["receiver_memory"]["bytes_per_member_curve"][2][
            "packed_carry_bytes"] += 1
    elif how == "refusal_attempted":
        bad["variants"]["refusals"] = []
    elif how == "refusal_bytes":
        bad["variants"]["refusals"][0]["bytes_required"] -= 1
    elif how == "variant_sizes":
        bad["variants"]["sizes"] = [4096]
    elif how == "multichip_mesh":
        bad["multichip"] = {"n_devices": 4, "axis": "slots", "kernels": []}
    return bad


@pytest.mark.parametrize("how", [
    "none", "unknown_dominant", "schema_version_up", "schema_version_missing",
    "missing_flops", "missing_kernel", "slow_walls", "k_mismatch",
    "unknown_n", "member_bytes", "fleet_bytes", "fleet_peak", "curve",
    "refusal_attempted", "refusal_bytes", "variant_sizes",
    "multichip_mesh"])
def test_profile_sweep_errors_agree_with_bench_compare(how, payload_path):
    payload = _corrupt(json.loads(payload_path.read_text()), how)
    base = _committed()
    got = golden.profile_sweep_errors(payload, base)
    want = _bench_compare().compare_profile_sweeps(payload, base, 0.50)
    assert got == want
    if how in ("none", "unknown_dominant", "schema_version_up",
               "schema_version_missing", "missing_flops", "slow_walls",
               "unknown_n", "fleet_peak"):
        assert got[0] == []
    else:
        assert got[0]


# ---------------------------------------------------------------------------
# the schema CLI and the entry point
# ---------------------------------------------------------------------------

_CLI_CASES = sorted(p.name for p in (ROOT / "benchmarks").glob("*.json"))


def _cli(main, argv, capsys):
    code = main(argv)
    out = capsys.readouterr()
    return code, out.out.replace("rapid_tpu_torch.", "rapid_tpu."), \
        out.err.replace("rapid_tpu_torch.", "rapid_tpu.")


@pytest.mark.parametrize("name", _CLI_CASES + ["corrupt", "load_sweep_flag",
                                               "usage"])
def test_schema_cli_agrees_with_the_reference(name, tmp_path, capsys):
    if name == "corrupt":
        bad = _corrupt(_committed(), "missing_flops")
        path = tmp_path / "bad.json"
        path.write_text(json.dumps(bad) + "\n")
        argv = [str(path)]
    elif name == "load_sweep_flag":
        argv = ["--load-sweep", str(ROOT / "benchmarks" / "load_sweep.json")]
    elif name == "usage":
        argv = ["a", "b", "c"]
    else:
        argv = [str(ROOT / "benchmarks" / name)]
    got = _cli(schema.main, argv, capsys)
    want = _cli(ref_schema.main, argv, capsys)
    assert got == want
    if name in ("corrupt", "usage"):
        assert got[0] != 0


def test_dominance_report_payload_is_schema_valid_and_committed_one_too():
    assert schema.validate_bench_payload(_committed()) == []
    assert profile.multichip_comparison([N], Settings()) is None


def test_main_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(NoCudaDeviceError, match="device='cpu'"):
        profile.main(["--sizes", "64", "--out", str(tmp_path / "r.json")])
