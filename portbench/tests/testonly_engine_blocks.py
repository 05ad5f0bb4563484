"""A test-only engine, ``blocks``: the port's shared fleet path for
descriptions whose crashes come as a block (``crash_block``)."""
from portbench.engines import shared

TICK_FUNCTIONS = shared.TICK_FUNCTIONS
ALTERED_COLUMN = shared.ALTERED_COLUMN
dispatch, fold, outputs = shared.dispatch, shared.fold, shared.outputs


def lower(config: dict, settings, descs: list, device):
    n = config["nodes"]
    plain = []
    for desc in descs:
        block = desc["crash_block"]
        crashes = [[(block["start"] + i) % n, block["tick"]]
                   for i in range(block["count"])]
        plain.append(dict({k: v for k, v in desc.items()
                           if k != "crash_block"},
                          crashes=desc["crashes"] + crashes))
    return shared.lower(config, settings, plain, device)
