"""The telemetry fold of every member after a dispatch, ms (the
harness's span around the fold call), averaged over the window's
unprofiled dispatches."""


def read(rec: dict):
    folds = rec.get("fold_s") or []
    if not folds:
        return None
    return 1e3 * sum(folds) / len(folds)
