"""The plain reference of the test-only engine ``blocks``: the shared
reference, with a ``crash_block`` spelled out as its crashes."""
from portbench.reference import shared

universe, member_summary = shared.universe, shared.member_summary


def simulate(config: dict, desc: dict, ticks: int, uni) -> dict:
    desc = dict(desc)
    block = desc.pop("crash_block", None)
    if block:
        slots = (block["start"] + k for k in range(block["count"]))
        desc["crashes"] = desc["crashes"] + [
            [s % config["nodes"], block["tick"]] for s in slots]
    return shared.simulate(config, desc, ticks, uni)
