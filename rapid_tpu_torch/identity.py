"""The default identity universe of an n-slot scenario.

Own copies of the reference's endpoint and node-id conventions
(``nX.sim:5000`` endpoints, ``NodeId(i + 1, (i + 1) * 7919)``) and of the
hashes that turn them into slot uids and the identifier-fingerprint sum
that configuration ids fold in; and the synthetic uids of large
benchmark universes. Endpoints and node ids are plain tuples
here: ``(hostname, port)`` and ``(high, low)``.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from rapid_tpu_torch import hashing

MASK64 = hashing.MASK64

# Seeds of the hash domains (shared with the reference).
SEED_ID_HIGH = 0x6964_6869
SEED_ID_LOW = 0x6964_6C6F
SEED_MEMBER = 0x6D656D62
SEED_HOST = 0x686F7374
SEED_PORT = 0x706F7274


def default_endpoints(n: int) -> List[Tuple[str, int]]:
    """Deterministic distinct endpoints for an n-node scenario."""
    return [(f"n{i}.sim", 5000) for i in range(n)]


def default_node_ids(n: int) -> List[Tuple[int, int]]:
    return [(i + 1, (i + 1) * 7919) for i in range(n)]


def endpoint_uid(endpoint: Tuple[str, int]) -> int:
    """64-bit identity of an endpoint."""
    hostname, port = endpoint
    return (hashing.fingerprint_bytes(hostname.encode(), seed=SEED_HOST)
            ^ hashing.hash64(port, seed=SEED_PORT))


uid_of = functools.lru_cache(maxsize=None)(endpoint_uid)


def id_fingerprint(node_id: Tuple[int, int]) -> int:
    """Per-identifier contribution to the configuration id."""
    high, low = node_id
    return hashing.splitmix64(
        (hashing.hash64(high & MASK64, SEED_ID_HIGH)
         + hashing.hash64(low & MASK64, SEED_ID_LOW)) & MASK64)


@functools.lru_cache(maxsize=None)
def _default_identities(n: int) -> Tuple[Tuple[int, ...], int]:
    uids = tuple(uid_of(e) for e in default_endpoints(n))
    id_fp_sum = sum(id_fingerprint(nid)
                    for nid in default_node_ids(n)) & MASK64
    return uids, id_fp_sum


def default_identities(n: int) -> Tuple[List[int], int]:
    """``(uids, id_fp_sum)`` of the default n-slot universe."""
    uids, id_fp_sum = _default_identities(n)
    return list(uids), id_fp_sum


def synthetic_uids(n: int, seed: int = 0) -> np.ndarray:
    """Distinct 64-bit identities without hashing n hostnames: the hash
    of ``1..n`` under seed ``0xBEEF ^ (seed & 0xFFFF)``, as the reference's
    engine benchmark boots its clusters (uint64 numpy)."""
    ids = torch.arange(1, n + 1, dtype=torch.int64)
    hi, lo = hashing.hash64_limbs(ids >> 32, ids & hashing.MASK32,
                                  seed=0xBEEF ^ (seed & 0xFFFF))
    return ((hi.numpy().astype(np.uint64) << np.uint64(32))
            | lo.numpy().astype(np.uint64))
