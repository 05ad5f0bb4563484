"""Set-up's lowering and stacking of the fleet, ms per member (the
harness's own span around ``lower_schedule``/``lower_receiver_schedule``
and the stacking)."""


def read(rec: dict):
    if not rec.get("members"):
        return None
    return rec["lower_s"] * 1e3 / rec["members"]
