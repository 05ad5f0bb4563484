"""The port's resident chunking and checkpoints against the reference.

Chained ``simulate_chunk`` and ``receiver_simulate_chunk`` calls equal
one uninterrupted run (split between an announce and its decide, with
churn, the classic fallback and the recorder); a checkpoint of each
family round-trips in the port, its leaf table is the reference's, and
its three errors carry the reference's messages; and checkpoints cross
between the packages both ways: the reference's committed checkpoints
(``rapid_tpu_torch/testdata/checkpoints``) restore in the port and
continue equal to the reference's uninterrupted run
(``continuations.json``), and checkpoints the port writes load in the
reference's ``load_checkpoint`` and continue equal to it too.

``RefService`` is the reference's twin of ``golden.PortService``, so
the golden runners run the same code over either package. Run as a
script, the file writes the golden files from the reference on the CPU
(the checkpoints and ``continuations.json``, ``stream_servo.json``; with
``--n100k`` also ``stream_n100k.json``, several minutes)::

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_service.py
"""
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rapid_tpu_torch import golden
from rapid_tpu_torch.convert import checkpoint_from_reference, from_reference
from rapid_tpu_torch.engine import churn, paxos, receiver, rx_packed, step
from rapid_tpu_torch.engine.fleet import lower_receiver_schedule
from rapid_tpu_torch.engine.state import I32_MAX, crash_faults, init_state
from rapid_tpu_torch.faults import two_zone_schedule
from rapid_tpu_torch.identity import synthetic_uids
from rapid_tpu_torch.service import checkpoint
from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.telemetry import schema

CPU = "cpu"


class RefService:
    """The reference's service entry points in ``golden.PortService``'s
    shape (the reference runs on JAX's CPU backend here)."""

    def __init__(self):
        from rapid_tpu import service
        from rapid_tpu.settings import Settings as RefSettings
        from rapid_tpu.telemetry.slo import SloWindows

        self.service, self.Settings = service, RefSettings
        self.SloWindows = SloWindows

    def boot_resident(self, settings, capacity, n, **kw):
        return self.service.boot_resident(settings, capacity, n, **kw)

    def boot_resident_receiver(self, settings, n, **kw):
        return self.service.boot_resident_receiver(settings, n, **kw)

    def load_checkpoint(self, path, settings):
        return self.service.load_checkpoint(str(path), settings)

    def engine_faults(self, capacity):
        from rapid_tpu.engine.state import crash_faults as ref_crash_faults

        return ref_crash_faults([I32_MAX] * capacity)

    def receiver_faults(self, settings):
        from rapid_tpu.engine.fleet import lower_receiver_schedule as lower
        from rapid_tpu.faults import two_zone_schedule as ref_two_zone

        rc = golden.RX_CHECKPOINT
        sched = ref_two_zone(rc["n"], rc["seed"], rc["horizon"],
                             ring_depth=settings.delivery_ring_depth)
        return lower(sched, settings).faults

    def engine_chunk(self, state, faults, n_ticks, settings, schedule, rec):
        from rapid_tpu.engine.churn import empty_schedule
        from rapid_tpu.engine.step import simulate_chunk

        if schedule is None:
            schedule = empty_schedule(state.member.shape[0])
        return simulate_chunk(state, faults, n_ticks, settings,
                              churn=schedule, rec=rec, donate=False)

    def receiver_chunk(self, carry, faults, n_ticks, settings, rec):
        from rapid_tpu.engine.receiver import receiver_simulate_chunk

        return receiver_simulate_chunk(carry, faults, n_ticks, settings,
                                       rec=rec, donate=False)

    def to_numpy(self, tree):
        if type(tree).__name__ == "PackedReceiverBundle":
            return type(tree)(packed=self.to_numpy(tree.packed),
                              delay_table=np.asarray(tree.delay_table))
        return type(tree)(*[np.asarray(x) for x in tree])

    def array(self, name, leaf):
        return np.asarray(leaf)


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def continuations():
    return golden.load(golden.CHECKPOINT_PATH)


def _equal(a, b) -> bool:
    la, lb = list(a), list(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if x is None or y is None:
            if x is not y:
                return False
        elif torch.is_tensor(x):
            if x.shape != y.shape or not torch.equal(x, y):
                return False
        elif not _equal(x, y):
            return False
    return True


# ---------------------------------------------------------------------------
# chained chunks equal one run
# ---------------------------------------------------------------------------

def _shared_case(name):
    """A small port boot with churn or a fallback schedule, the recorder
    on: ``(state, faults, settings, churn, fallback, ticks)``."""
    settings = Settings(flight_recorder_window=8)
    if name == "churn":
        sched, id_fps, _ = churn.synthetic_churn_schedule(80, 64, settings,
                                                          start=10)
        member = np.zeros(80, bool)
        member[:64] = True
        state = init_state(synthetic_uids(80), 0, settings, member=member,
                           id_fps=id_fps, device=CPU)
        faults = crash_faults([I32_MAX] * 80, device=CPU)
        return (state, faults, settings, from_reference(sched, CPU), None,
                60)
    uids = synthetic_uids(32)
    sched, _ = paxos.synthetic_contested_schedule(32, settings, 60,
                                                  uids=uids)
    state = init_state(uids, 0, settings, device=CPU)
    faults = crash_faults([I32_MAX] * 32, device=CPU)
    return state, faults, settings, None, from_reference(sched, CPU), 60


@pytest.mark.parametrize("name", ["churn", "contested"])
def test_chained_chunks_equal_one_simulate(name):
    """Chunks that end on every announce tick (so each decide falls on
    the next chunk's first tick) equal one uninterrupted run: logs, the
    final state and the recorder."""
    state, faults, settings, ch, fb, ticks = _shared_case(name)
    final, logs, rec = step.simulate(state, faults, ticks, settings,
                                     churn=ch, fallback=fb, device=CPU)
    cuts = sorted({int(t) for t in logs.tick[logs.announce_now.bool()]})
    if name == "contested":
        # Classic rounds decide without a fast announce: cut inside each
        # instance instead, between its 1a and its decide.
        cuts = sorted({int(t) - 2 for t in logs.tick[logs.decide_now.bool()]})
    assert cuts, "the scenario must decide"
    bounds = [0] + [c for c in cuts if 0 < c < ticks] + [ticks]
    s, r, parts = state, None, []
    for a, b in zip(bounds, bounds[1:]):
        s, lg, r = step.simulate_chunk(s, faults, b - a, settings, churn=ch,
                                       fallback=fb, rec=r, donate=False,
                                       device=CPU)
        parts.append(lg)
    chained = type(logs)(*[torch.cat(col) for col in zip(*parts)])
    assert _equal(chained, logs)
    assert _equal(s, final)
    assert _equal(r, rec)


@pytest.mark.parametrize("layout", ["xla", "packed", "pallas"])
def test_receiver_chunks_equal_one_run(layout):
    """The two-zone N=64 member in chunks of 16 across its decide at tick
    128 equals one ``receiver_simulate``; the packed layouts carry the
    packed state as it is (base and sticky flags), equal to the packed
    loop's own final."""
    settings = Settings(rx_kernel=layout, flight_recorder_window=8)
    member = lower_receiver_schedule(two_zone_schedule(64, 0, 192), settings,
                                     device=CPU)
    final, logs, rec = receiver.receiver_simulate(member.state,
                                                  member.faults, 144,
                                                  settings)
    carry, r, parts = member.state, None, []
    for _ in range(9):
        carry, lg, r = receiver.receiver_simulate_chunk(
            carry, member.faults, 16, settings, rec=r, donate=False)
        parts.append(lg)
    chained = type(logs)(*[torch.cat(col) for col in zip(*parts)])
    assert int(chained.decide.sum()) == 56
    assert _equal(chained, logs)
    assert _equal(r, rec)
    if layout == "xla":
        assert isinstance(carry, type(member.state))
        assert _equal(carry, final)
    else:
        assert isinstance(carry, rx_packed.PackedReceiverBundle)
        whole = rx_packed.simulate_chunk(member.state, member.faults, 144,
                                         settings)[0]
        assert _equal(carry.packed, whole.packed)
        assert _equal(rx_packed.unpack_receiver_state(
            carry.packed, carry.delay_table, settings), final)


def test_receiver_chunk_refuses_the_other_layout():
    """A packed bundle under ``"xla"`` raises; a dense boot under
    ``"packed"`` is packed on entry and comes back a bundle."""
    packed = Settings(rx_kernel="packed")
    bundle = lower_receiver_schedule(two_zone_schedule(16, 0, 32), packed,
                                     device=CPU)
    with pytest.raises(TypeError, match="dense"):
        receiver.receiver_simulate_chunk(bundle.state, bundle.faults, 1,
                                         Settings())
    dense = lower_receiver_schedule(two_zone_schedule(16, 0, 32),
                                    Settings(), device=CPU)
    out = receiver.receiver_simulate_chunk(dense.state, dense.faults, 2,
                                           packed)[0]
    assert isinstance(out, rx_packed.PackedReceiverBundle)


# ---------------------------------------------------------------------------
# checkpoints in the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", golden.CHECKPOINT_FAMILIES)
def test_checkpoint_round_trip_and_leaf_table(family, tmp_path):
    """The port's checkpoint of each family loads back equal, its
    manifest validates, and its leaf table (names, dtypes, shapes) is the
    one of the reference's committed checkpoint."""
    svc = golden.PortService(CPU)
    golden.write_checkpoint(svc, family, tmp_path / "ck")
    settings = golden.family_settings(svc, family)
    cp = checkpoint.load_checkpoint(str(tmp_path / "ck"), settings,
                                    device=CPU)
    ref_manifest = json.loads((golden.CHECKPOINT_DIR / family
                               / "manifest.json").read_text())
    assert cp.manifest["leaves"] == ref_manifest["leaves"]
    assert cp.manifest["statics"] == ref_manifest["statics"]
    assert cp.manifest["tick"] == ref_manifest["tick"]
    assert cp.manifest["host"] == ref_manifest["host"]
    assert schema.validate_checkpoint_manifest(cp.manifest) == []
    again = tmp_path / "again"
    if family == "engine":
        checkpoint.save_engine(str(again), cp.parts["state"], settings,
                               rec=cp.parts["recorder"], host=cp.host)
    else:
        checkpoint.save_receiver(
            str(again), checkpoint.restore_receiver_carry(cp, settings),
            settings, tick=cp.tick, rec=cp.parts["recorder"], host=cp.host)
    cp2 = checkpoint.load_checkpoint(str(again), settings, device=CPU)
    assert sorted(cp2.parts) == sorted(cp.parts)
    for part in cp.parts:
        a, b = cp.parts[part], cp2.parts[part]
        assert _equal(a, b) if hasattr(a, "_fields") else torch.equal(a, b)


def _corrupt(tmp_path, how):
    src = golden.CHECKPOINT_DIR / "receiver_packed"
    dst = tmp_path / how
    shutil.copytree(src, dst)
    manifest = json.loads((dst / "manifest.json").read_text())
    if how == "version":
        manifest["checkpoint_version"] = 99
    elif how == "leaves":
        manifest["leaves"] = manifest["leaves"][:-1]
    elif how == "dtype":
        manifest["leaves"][0]["dtype"] = "float64"
    elif how == "record":
        manifest["record"] = "something_else"
    (dst / "manifest.json").write_text(json.dumps(manifest))
    return dst


@pytest.mark.parametrize("how,kernel,error", [
    ("version", "packed", "CheckpointVersionError"),
    ("clean", "pallas", "CheckpointCompatError"),
    ("clean", "xla", "CheckpointCompatError"),
    ("leaves", "packed", "CheckpointError"),
    ("dtype", "packed", "CheckpointError"),
    ("record", "packed", "CheckpointError"),
])
def test_checkpoint_errors_carry_the_reference_messages(tmp_path, how,
                                                        kernel, error):
    from rapid_tpu.service import checkpoint as ref_checkpoint
    from rapid_tpu.settings import Settings as RefSettings

    path = (_corrupt(tmp_path, how) if how != "clean"
            else golden.CHECKPOINT_DIR / "receiver_packed")
    kw = dict(rx_kernel=kernel, flight_recorder_window=8)
    with pytest.raises(getattr(checkpoint, error)) as got:
        checkpoint.load_checkpoint(str(path), Settings(**kw), device=CPU)
    with pytest.raises(getattr(ref_checkpoint, error)) as want:
        ref_checkpoint.load_checkpoint(str(path), RefSettings(**kw))
    assert type(got.value).__name__ == error
    assert str(got.value).replace(str(tmp_path), "") == \
        str(want.value).replace(str(tmp_path), "")
    if error == "CheckpointVersionError":
        assert (got.value.saved, got.value.expected) == (99, 1)
    if error == "CheckpointCompatError":
        assert got.value.mismatches == want.value.mismatches
        assert "rx_kernel" in got.value.mismatches


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", golden.CHECKPOINT_FAMILIES)
def test_reference_checkpoint_continues_in_the_port(family, tmp_path,
                                                    continuations):
    """The reference's checkpoint restores in the port and the port's two
    continuation chunks (the second after its own save and load) equal
    the reference's uninterrupted run."""
    got = golden.continue_checkpoint(golden.PortService(CPU), family,
                                     golden.CHECKPOINT_DIR / family,
                                     tmp_path / "next")
    assert golden.differences(got, continuations[family]) == []
    cp = json.loads((tmp_path / "next" / "manifest.json").read_text())
    assert schema.validate_checkpoint_manifest(cp) == []


@pytest.mark.parametrize("family", golden.CHECKPOINT_FAMILIES)
def test_port_checkpoint_continues_in_the_reference(family, tmp_path,
                                                    continuations):
    """A checkpoint the port writes at the same point loads in the
    reference's ``load_checkpoint`` and continues there equal to the
    reference's uninterrupted run."""
    golden.write_checkpoint(golden.PortService(CPU), family, tmp_path / "ck")
    got = golden.continue_checkpoint(RefService(), family, tmp_path / "ck",
                                     tmp_path / "next")
    assert golden.differences(got, continuations[family]) == []


def test_reference_checkpoint_converts_in_memory(continuations):
    """``convert.checkpoint_from_reference`` carries a loaded reference
    checkpoint's parts across equal to the port's own load."""
    from rapid_tpu.service import checkpoint as ref_checkpoint

    path = str(golden.CHECKPOINT_DIR / "receiver_packed")
    settings = golden.family_settings(golden.PortService(CPU),
                                      "receiver_packed")
    ref_cp = ref_checkpoint.load_checkpoint(path)
    got = checkpoint_from_reference(ref_cp, device=CPU)
    want = checkpoint.load_checkpoint(path, settings, device=CPU)
    assert (got.family, got.tick, got.host) == (want.family, want.tick,
                                                want.host)
    assert _equal(got.parts["packed"], want.parts["packed"])
    assert _equal(got.parts["recorder"], want.parts["recorder"])
    assert torch.equal(got.parts["delay_table"], want.parts["delay_table"])


# ---------------------------------------------------------------------------
# the golden files
# ---------------------------------------------------------------------------

def write_checkpoint_goldens(svc, scratch: Path) -> dict:
    """Write the three reference checkpoints and return their
    continuations, each checked equal to the reference's uninterrupted
    run before it is kept."""
    out = {}
    for family in golden.CHECKPOINT_FAMILIES:
        path = golden.CHECKPOINT_DIR / family
        shutil.rmtree(path, ignore_errors=True)
        golden.write_checkpoint(svc, family, path)
        rec = golden.continue_checkpoint(svc, family, path,
                                         scratch / family)
        assert rec == uninterrupted(svc, family, rec), family
        out[family] = rec
    return out


def uninterrupted(svc, family, restored: dict) -> dict:
    """``restored`` with its continuations replaced by the same two
    chunks run straight on from the live run, with no checkpoint."""
    settings = golden.family_settings(svc, family)
    out = dict(restored, continuations=[])
    if family == "engine":
        eng = golden.boot_soak(svc)
        eng.run(golden.ENGINE_CHECKPOINT_CHUNKS)
        state, rec, gen = eng.state, eng._rec, eng.traffic
        faults = svc.engine_faults(golden.SOAK["capacity"])
        for _ in range(2):
            schedule, _ = gen.next_chunk(golden.SOAK["chunk"])
            state, logs, rec = svc.engine_chunk(state, faults,
                                                golden.SOAK["chunk"],
                                                settings, schedule, rec)
            out["continuations"].append(dict(
                golden.continuation_record(svc, state, logs, rec),
                traffic=gen.state_dict()))
        return json.loads(json.dumps(out))
    rc = golden.RX_CHECKPOINT
    rx = svc.boot_resident_receiver(settings, rc["n"], seed=rc["seed"],
                                    horizon_ticks=rc["horizon"],
                                    chunk_ticks=rc["chunk"])
    rx.run(rc["chunks"])
    carry, rec = rx.carry, rx._rec
    faults = svc.receiver_faults(settings)
    for _ in range(2):
        carry, logs, rec = svc.receiver_chunk(carry, faults, rc["chunk"],
                                              settings, rec)
        out["continuations"].append(
            golden.continuation_record(svc, carry, logs, rec))
    return json.loads(json.dumps(out))


@pytest.mark.slow
def test_checkpoint_goldens_are_current(tmp_path, continuations):
    """The reference rewrites the same checkpoints and continuations."""
    svc = RefService()
    for family in golden.CHECKPOINT_FAMILIES:
        golden.write_checkpoint(svc, family, tmp_path / family)
        got = golden.continue_checkpoint(svc, family, tmp_path / family,
                                         tmp_path / f"{family}_next")
        assert got == continuations[family]


@pytest.mark.slow
def test_servo_golden_is_current(tmp_path):
    assert golden.servo_stream_record(RefService(), tmp_path) == \
        golden.load(golden.SERVO_PATH)


@pytest.mark.slow
def test_n100k_golden_is_current(tmp_path):
    """The reference's N=100,000 resident (several minutes here)."""
    assert golden.n100k_stream_record(RefService(), tmp_path) == \
        golden.load(golden.STREAM_N100K_PATH)


if __name__ == "__main__":
    import tempfile

    svc = RefService()
    with tempfile.TemporaryDirectory() as tmp:
        scratch = Path(tmp)
        golden.CHECKPOINT_PATH.write_text(golden.dumps(
            write_checkpoint_goldens(svc, scratch)))
        golden.SERVO_PATH.write_text(golden.dumps(
            golden.servo_stream_record(svc, scratch)))
        if "--n100k" in sys.argv:
            golden.STREAM_N100K_PATH.write_text(golden.dumps(
                golden.n100k_stream_record(svc, scratch)))
