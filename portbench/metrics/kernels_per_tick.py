"""CUDA kernels launched per fleet tick over the profiled dispatch
(``torch.profiler``'s kernel events, copies and sets left out)."""


def read(rec: dict):
    prof = rec.get("profile")
    if not prof or not prof["ticks"]:
        return None
    kernels = sum(1 for e in prof["device"] if e[3] == "kernel")
    return kernels / prof["ticks"] if kernels else None
