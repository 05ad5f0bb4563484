"""``rx_deliver``'s share of its roofline over the profiled dispatch:
the least time of its launches (their bytes at the HBM peak, bytes
counted as ``_rx_deliver`` says) over their measured device time."""
from portbench.metrics import _rx_deliver


def read(rec: dict):
    prof = rec.get("profile")
    if not prof:
        return None
    launches = sorted((e for e in prof["device"]
                       if e[3] == "kernel" and "rx_deliver" in e[0]),
                      key=lambda e: e[1])
    if not launches:
        return None
    pattern = _rx_deliver.PLANES_PER_LAUNCH
    least = sum(_rx_deliver.least_seconds(rec["members"], rec["capacity"],
                                          pattern[i % len(pattern)])
                for i in range(len(launches)))
    measured = sum(e[2] for e in launches) * 1e-9
    return 100.0 * least / measured
