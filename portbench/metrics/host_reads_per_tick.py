"""Device-to-host reads of the tick loop (``rapid_tpu_torch.device``'s
counter) over the window's dispatches, per fleet tick."""


def read(rec: dict):
    if not rec.get("timed_ticks"):
        return None
    return rec["host_reads"] / rec["timed_ticks"]
