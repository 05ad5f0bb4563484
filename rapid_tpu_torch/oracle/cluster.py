"""The rng a cluster member draws its node ids from."""
from __future__ import annotations

import random

from rapid_tpu_torch.settings import Settings
from rapid_tpu_torch.types import Endpoint


def default_rng(settings: Settings, listen_address) -> random.Random:
    """The reference cluster's default rng for ``listen_address`` (an
    ``Endpoint`` or a ``(hostname, port)`` pair).

    It is seeded from ``hash((settings.seed, "host:port"))``, and Python
    salts ``str`` hashes per process: the same endpoint draws the same
    node ids in two processes only under the same ``PYTHONHASHSEED``."""
    address = str(Endpoint.of(listen_address))
    return random.Random(hash((settings.seed, address)) & 0xFFFFFFFF)
