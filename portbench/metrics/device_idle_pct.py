"""Share of the profiled dispatch's wall time with nothing running on
the device: 100 * (1 - union of device intervals / window)."""
from portbench.metrics import _trace


def read(rec: dict):
    prof = rec.get("profile")
    if not prof or not prof["device"]:
        return None
    wall = prof["end_ns"] - prof["start_ns"]
    return 100.0 * (1.0 - _trace.busy_ns(prof) / wall)
