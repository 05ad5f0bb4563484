"""The port's invariant monitor against the JAX reference.

Every corruption case of ``tests/test_invariants.py``, run through both
engines with ``invariant_checks=True``: the same bits at the same ticks,
and every other ``StepLog`` field and the final state equal too. The
direct ``check_step`` cases give the reference's bits. Clean N=256 crash
and contested runs log 0 everywhere; ``check_run`` names the first tick;
with the flag off ``check_step`` is never called. Everything is integer
or bool: the tolerance is exact.
"""
import importlib
import json
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_tpu import hashing as ref_hashing
from rapid_tpu.engine import invariants as ref_inv
from rapid_tpu.engine import paxos as ref_paxos
from rapid_tpu.engine.state import crash_faults as ref_crash_faults
from rapid_tpu.engine.state import init_state as ref_init_state
from rapid_tpu.settings import Settings as RefSettings

from rapid_tpu_torch.telemetry import forensics
from rapid_tpu_torch.convert import from_reference, to_numpy
from rapid_tpu_torch.engine import invariants, step
from rapid_tpu_torch.engine.state import I32_MAX
from rapid_tpu_torch.identity import synthetic_uids
from rapid_tpu_torch.settings import Settings

ref_step = importlib.import_module("rapid_tpu.engine.step")
SETTINGS = RefSettings(invariant_checks=True, seed=7001)


def _port_settings(settings):
    return Settings(invariant_checks=settings.invariant_checks,
                    seed=settings.seed)


def _assert_same(port_nt, ref_nt):
    port_np = to_numpy(port_nt)
    for name in ref_nt._fields:
        want = np.asarray(getattr(ref_nt, name))
        got = getattr(port_np, name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if not np.array_equal(got, want):
            first = (np.argwhere(got != want)[0].tolist()
                     if got.ndim else [])
            pytest.fail(f"{name} differs first at {first}")


def boot(n, settings=SETTINGS, member=None):
    return ref_init_state(synthetic_uids(n), 0, settings, member=member)


def bit(name: str) -> int:
    return 1 << invariants.BIT_OF[name]


def both(state, n_ticks, settings, crash=None, fallback=None):
    """The reference's and the port's runs of ``state``; asserts every
    log field at every tick and the final state equal, and returns the
    port's logs."""
    n = int(state.member.shape[0])
    faults = ref_crash_faults(crash or [I32_MAX] * n)
    want_final, want_logs = ref_step.simulate(state, faults, n_ticks,
                                              settings, fallback=fallback)
    got_final, got_logs = step.simulate(
        from_reference(state, device="cpu"),
        from_reference(faults, device="cpu"), n_ticks,
        _port_settings(settings),
        fallback=None if fallback is None else from_reference(
            fallback, device="cpu"), device="cpu")
    _assert_same(got_logs, want_logs)
    _assert_same(got_final, want_final)
    assert invariants.expand_violations(got_logs) == \
        ref_inv.expand_violations(want_logs)
    return got_logs


def test_bit_registry_and_decoding_equal_the_reference():
    assert invariants.INVARIANT_BITS == ref_inv.INVARIANT_BITS
    assert invariants.ALL_BITS == ref_inv.ALL_BITS == 0b1111111
    for mask in (0, bit("memsum") | bit("ring_degree"), invariants.ALL_BITS):
        assert invariants.describe_bits(mask) == ref_inv.describe_bits(mask)


# ---------------------------------------------------------------------------
# clean runs
# ---------------------------------------------------------------------------


def test_clean_run_n256_logs_zero_everywhere():
    n = 256
    crash = [I32_MAX] * n
    for slot in range(0, n, 64):
        crash[slot] = 5
    logs = both(boot(n), 130, SETTINGS, crash=crash)
    assert int(logs.inv_bits.abs().max()) == 0
    assert int(logs.decide_now.sum()) >= 1
    invariants.check_run(logs)


def test_clean_contested_run_logs_zero_everywhere():
    n = 64
    settings = replace(SETTINGS, seed=7002)
    uids = synthetic_uids(n)
    sched, info = ref_paxos.synthetic_contested_schedule(n, settings, 48,
                                                         uids=uids)
    logs = both(ref_init_state(uids, 0, settings), 48, settings,
                fallback=sched)
    assert info["instances"] >= 1
    assert int(logs.inv_bits.abs().max()) == 0
    assert int(logs.px2b_senders.sum()) > 0


# ---------------------------------------------------------------------------
# injected corruptions: the same bit at the same tick as the reference
# ---------------------------------------------------------------------------


def _memsum(state):
    return state._replace(memsum_lo=(state.memsum_lo + jnp.uint32(1))
                          & jnp.uint32(0xFFFFFFFF))


def _ring_edge(state):
    return state._replace(obs_idx=state.obs_idx.at[5, 0].set(5))


def _dormant_row(state):
    return state._replace(subj_idx=state.subj_idx.at[63, 0].set(0))


def _rank(state):
    return state._replace(px_vrnd_r=state.px_vrnd_r.at[3].set(5))


def _empty_proposal(state):
    return state._replace(announced=jnp.asarray(True),
                          vote_pending=jnp.asarray(True),
                          voters=state.member,
                          announce_tick=state.tick)


# name: (corruption, seed, ticks, member mask or None, first row)
CORRUPTIONS = {
    "memsum": (_memsum, 7003, 4, None, (1, bit("memsum"), ["memsum"])),
    "ring_edge": (_ring_edge, 7004, 3, None,
                  (1, bit("ring_degree"), ["ring_degree"])),
    "dormant_row": (_dormant_row, 7005, 3, np.arange(64) < 56,
                    (1, bit("ring_degree"), ["ring_degree"])),
    "rank": (_rank, 7006, 3, None, (1, bit("rank_order"), ["rank_order"])),
    "empty_proposal": (_empty_proposal, 7007, 2, None, None),
}


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_corruption_flags_the_reference_bits(case):
    corrupt, seed, ticks, member, first = CORRUPTIONS[case]
    settings = replace(SETTINGS, seed=seed)
    logs = both(corrupt(boot(64, settings, member)), ticks, settings)
    rows = invariants.expand_violations(logs)
    if first is not None:
        assert rows[0] == first
    else:
        tick, bits, names = rows[0]
        assert tick == 1 and bits & bit("unique_decide")
    if case == "memsum":
        assert len(rows) == 4  # the corrupted sum persists every tick


def _step_bits(pre, post, decide=False, fast=False, classic=False,
               classic_mask=None):
    """``check_step`` of both packages on the same reference states."""
    n = pre.member.shape[0]
    mask = jnp.zeros(n, bool) if classic_mask is None else classic_mask
    want = int(ref_inv.check_step(
        jnp, pre, post, decide_now=jnp.asarray(decide),
        fast_decide=jnp.asarray(fast), classic_decide=jnp.asarray(classic),
        fast_mask=pre.proposal, classic_mask=mask, settings=SETTINGS))
    port_pre = from_reference(pre, device="cpu")
    got = invariants.check_step(
        port_pre, from_reference(post, device="cpu"),
        decide_now=torch.tensor(decide), fast_decide=torch.tensor(fast),
        classic_decide=torch.tensor(classic),
        fast_mask=port_pre.proposal,
        classic_mask=torch.from_numpy(np.array(mask)),
        settings=_port_settings(SETTINGS))
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == want
    return want


def test_check_step_epoch_cases_equal_the_reference():
    pre = boot(8)
    assert _step_bits(pre, pre._replace(epoch=pre.epoch - 1)) \
        & bit("epoch_monotone")
    assert _step_bits(pre, pre, decide=True) & bit("epoch_monotone")
    assert not _step_bits(pre, pre._replace(epoch=pre.epoch + 1),
                          decide=True) & bit("epoch_monotone")


def test_check_step_report_cases_equal_the_reference():
    base = boot(8)
    pre = base._replace(reports=base.reports.at[0, 0].set(True))
    post = pre._replace(reports=jnp.zeros_like(pre.reports))
    assert _step_bits(pre, post) & bit("report_monotone")
    assert not _step_bits(pre, post._replace(epoch=pre.epoch + 1),
                          decide=True, fast=True) & bit("report_monotone")


def test_check_step_decide_cases_equal_the_reference():
    pre = boot(8)
    pre = pre._replace(announced=jnp.asarray(True),
                       proposal=pre.proposal.at[0].set(True))
    post = pre._replace(epoch=pre.epoch + 1)
    assert _step_bits(pre, post, decide=True, fast=True, classic=True,
                      classic_mask=pre.proposal) & bit("unique_decide")
    ghost = pre._replace(announced=jnp.asarray(False))
    assert _step_bits(ghost, ghost._replace(epoch=ghost.epoch + 1),
                      decide=True, fast=True) & bit("unique_decide")
    assert not _step_bits(pre, post, decide=True, fast=True) \
        & bit("unique_decide")
    assert not _step_bits(pre, post, decide=True, classic=True,
                          classic_mask=pre.proposal) & bit("unique_decide")


def test_check_step_ghost_cases_equal_the_reference():
    base = boot(8)
    post = base._replace(reports=base.reports.at[0, 0].set(True))
    assert _step_bits(base, post) == bit("ghost_reports")
    obs0 = int(np.asarray(base.obs_idx)[0, 0])
    pre = base._replace(
        pending_deliver=base.pending_deliver.at[obs0, 0].set(True))
    assert not _step_bits(pre, post._replace(
        pending_deliver=pre.pending_deliver)) & bit("ghost_reports")
    obs4 = int(np.asarray(base.obs_idx)[0, 4])
    reports = base.reports.at[0, :4].set(True).at[obs4, :4].set(True)
    pre = base._replace(reports=reports)
    assert not _step_bits(pre, pre._replace(
        reports=reports.at[0, 4].set(True))) & bit("ghost_reports")


# ---------------------------------------------------------------------------
# escalation, and the disabled path
# ---------------------------------------------------------------------------


def test_check_run_raises_naming_tick_and_invariants(tmp_path):
    settings = replace(SETTINGS, seed=7011)
    logs = both(_memsum(boot(64, settings)), 4, settings)
    artifact = str(tmp_path / "inv.jsonl")
    with pytest.raises(invariants.InvariantViolationError) as exc:
        invariants.check_run(logs, artifact=artifact)
    err = exc.value
    assert isinstance(err, forensics.DivergenceError)
    assert isinstance(err, AssertionError)
    assert err.report.tick == 1
    assert err.report.field == "invariants.memsum"
    assert err.report.engine == bit("memsum")
    assert "tick 1" in str(err) and "memsum" in str(err)
    records = [json.loads(line) for line in
               (tmp_path / "inv.jsonl").read_text().splitlines()]
    assert records[-1] == {"record": "divergence", "tick": 1,
                           "field": "invariants.memsum",
                           "engine": bit("memsum"), "oracle": 0}
    assert [r["tick"] for r in records[:-1]] == [1, 2, 3, 4]


def test_disabled_monitor_never_calls_check_step(monkeypatch):
    def spy(*args, **kwargs):
        raise AssertionError("check_step called with invariant_checks off")

    monkeypatch.setattr(invariants, "check_step", spy)
    settings = replace(SETTINGS, invariant_checks=False, seed=7012)
    logs = both(_memsum(boot(64, settings)), 4, settings)
    assert int(logs.inv_bits.abs().sum()) == 0
    invariants.check_run(logs)


def test_build_report_equals_the_reference():
    from rapid_tpu.telemetry import forensics as ref_forensics

    div = (7, "events[0].tick", 9, 8)
    want = ref_forensics.build_report(ref_forensics.Divergence(*div))
    got = forensics.build_report(forensics.Divergence(*div))
    assert got.as_dict() == want.as_dict()
    assert got.render() == want.render()
    assert str(forensics.DivergenceError(got, "a.jsonl")) == \
        str(ref_forensics.DivergenceError(want, "a.jsonl"))


def test_memsum_limb_wraps_like_the_reference():
    """The corrupted limb stays a 32-bit value on both sides."""
    state = _memsum(boot(8))
    port = from_reference(state, device="cpu")
    assert int(port.memsum_lo) == int(np.asarray(state.memsum_lo))
    assert ref_hashing.MASK32 >= int(port.memsum_lo) >= 0
