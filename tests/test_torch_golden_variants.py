"""The ring and hier variants' golden files against the JAX reference.

``testdata/shared_n100k_crash_ring.json`` and ``..._hier.json`` hold the
reference's ``shared_n100k_crash`` (a 1 % crash burst at 100k members)
under ``protocol_variant`` "ring" and "hier": the same events and config
ids as the "rapid" file, since both decide the burst at tick 113, and
their own message factors. ``chip_smoke.py`` phases 11 and 12 hold the
card to them. Here the port's CPU runs equal the files, and the
reference regenerates them unchanged. Regenerate with
``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_golden_variants.py``.
Tolerance: exact.
"""
import pytest
import torch

from rapid_tpu_torch import golden

NAMES = ("shared_n100k_crash_ring", "shared_n100k_crash_hier")


@pytest.fixture
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", NAMES)
def test_port_cpu_run_equals_the_variant_golden(name, few_threads):
    sc = golden.OPTIONS[name]
    want = golden.load(sc.path)
    assert golden.differences(golden.run_scenario(sc, device="cpu"),
                              want) == []
    plain = golden.load(golden.SHARED["shared_n100k_crash"].path)
    # A transport variant decides what "rapid" decides ...
    assert want["events"] == plain["events"]
    assert want["config_id"] == plain["config_id"]
    # ... and logs its own message factors on the announce tick.
    announce = want["log"]["announce_now"].index(1)
    assert want["log"]["vote_senders"][announce] != \
        plain["log"]["vote_senders"][announce]
    if sc.variant == "ring":
        assert want["log"]["vote_senders"][announce] == 2
    else:
        assert want["log"]["vote_recipients"][announce] == 1


@pytest.mark.parametrize("name", NAMES)
def test_variant_golden_matches_reference(name):
    from test_torch_engine_golden import reference_record

    rec = reference_record(golden.OPTIONS[name])
    assert golden.dumps(rec) == golden.OPTIONS[name].path.read_text()


if __name__ == "__main__":
    from test_torch_engine_golden import reference_record

    for name in NAMES:
        sc = golden.OPTIONS[name]
        sc.path.write_text(golden.dumps(reference_record(sc)))
        print("wrote", sc.path)
