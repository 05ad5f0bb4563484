"""The metric readers on small recorded event lists: the union of device
intervals, idle gaps, kernels per tick, and rx_deliver's bytes against
the byte bound the port's records give at C = 1,024 and 4,096."""
import pytest

from portbench import profiling
from portbench.metrics import (_rx_deliver, _trace, device_idle_pct,
                               fold_ms_per_dispatch, host_reads_per_tick,
                               kernels_per_tick, lower_ms_per_member,
                               rx_deliver_roofline)


def _profile():
    # window 0..100 ns; kernels overlapping at 10..30 and 20..40, one at
    # 60..70, a copy at 80..90
    return {"start_ns": 0, "end_ns": 100, "ticks": 2,
            "device": [("k_a", 10, 20, "kernel"), ("k_b", 20, 20, "kernel"),
                       ("k_a", 60, 10, "kernel"), ("Memcpy DtoH", 80, 10,
                                                   "memcpy")],
            "host": [("aten::add", 0, 12, ), ("portbench.window", 0, 100),
                     ("aten::item", 45, 10)]}


def test_union_counts_overlap_once():
    prof = _profile()
    assert _trace.busy_ns(prof) == 30 + 10 + 10
    assert device_idle_pct.read({"profile": prof}) == pytest.approx(50.0)


def test_idle_gaps_and_their_labels():
    prof = _profile()
    starts, lengths = _trace.idle_gaps(prof)
    assert starts.tolist() == [0, 40, 70, 90]
    assert lengths.tolist() == [10, 20, 10, 10]
    labels = profiling.gap_labels(prof, starts, lengths, top=2)
    assert labels[0][0] == "portbench.window"
    assert labels[0][1] == pytest.approx(20e-9)
    name, secs = profiling.top_device_ops(prof)[0]
    assert name == "k_a" and secs == pytest.approx(30e-9)


def test_kernels_per_tick_leaves_copies_out():
    assert kernels_per_tick.read({"profile": _profile()}) == 1.5
    assert kernels_per_tick.read({}) is None


def test_counts_and_spans():
    assert host_reads_per_tick.read({"host_reads": 330,
                                     "timed_ticks": 320}) == 330 / 320
    assert fold_ms_per_dispatch.read({"fold_s": [0.1, 0.3]}) == \
        pytest.approx(200.0)
    assert lower_ms_per_member.read({"lower_s": 2.0, "members": 8}) == 250.0


@pytest.mark.parametrize("c,bound_us", [(1024, 0.665), (4096, 10.64)])
def test_rx_deliver_bytes_match_the_recorded_bound(c, bound_us):
    secs = _rx_deliver.least_seconds(1, c, 1)
    assert secs * 1e6 == pytest.approx(bound_us, abs=5e-3)
    # two planes, two members: the planes twice, the rest per member
    assert _rx_deliver.launch_bytes(2, c, 2) == 2 * (
        _rx_deliver.launch_bytes(1, c, 1) + 2 * c * c)


def test_roofline_share_of_a_recorded_tick():
    c, f = 1000, 8
    least = [_rx_deliver.least_seconds(f, c, p)
             for p in _rx_deliver.PLANES_PER_LAUNCH]
    # each launch measured at twice its least time
    device = [("rx_deliver_kernel(...)", i * 1000, int(2e9 * s), "kernel")
              for i, s in enumerate(least)]
    device.append(("other", 0, 5, "kernel"))
    rec = {"members": f, "capacity": c,
           "profile": {"start_ns": 0, "end_ns": 10**6, "ticks": 1,
                       "device": device, "host": []}}
    assert rx_deliver_roofline.read(rec) == pytest.approx(50.0, rel=1e-3)
    rec["profile"]["device"] = device[-1:]
    assert rx_deliver_roofline.read(rec) is None
