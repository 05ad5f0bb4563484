"""Identities and 64-bit hashes of a Rapid scenario, in numpy uint64.

Rapid names a node by its endpoint (``n<i>.sim:5000`` for slot ``i``)
and its node id ``(i + 1, (i + 1) * 7919)``. A configuration id is
``splitmix64(splitmix64(id_sum) + member_sum)`` over the identifier
fingerprints of every node ever admitted and the member fingerprints of
the current view. Ring ``j`` of the K-ring overlay orders the nodes by
``hash64(uid, seed=j)``, the uid breaking ties.
"""
from __future__ import annotations

import numpy as np

U64 = np.uint64
MASK64 = (1 << 64) - 1

GAMMA = U64(0x9E3779B97F4A7C15)
MIX1 = U64(0xBF58476D1CE4E5B9)
MIX2 = U64(0x94D049BB133111EB)

SEED_ID_HIGH = 0x69646869
SEED_ID_LOW = 0x69646C6F
SEED_MEMBER = 0x6D656D62
SEED_HOST = 0x686F7374
SEED_PORT = 0x706F7274
SEED_PROPOSAL = 0x70726F70

PORT = 5000
FNV_OFFSET = 0xCBF29CE484222325
FNV_PRIME = U64(0x100000001B3)


def splitmix64(x):
    """The splitmix64 finaliser, elementwise on uint64 (wrapping)."""
    with np.errstate(over="ignore"):
        z = np.asarray(x, dtype=U64) + GAMMA
        z = (z ^ (z >> U64(30))) * MIX1
        z = (z ^ (z >> U64(27))) * MIX2
    return z ^ (z >> U64(31))


def hash64(x, seed: int):
    """Seeded 64-bit hash: ``splitmix64(x ^ splitmix64(seed))``."""
    return splitmix64(np.asarray(x, dtype=U64)
                      ^ splitmix64(U64(seed & MASK64)))


def _fnv_names(n: int):
    """FNV-1a 64 over the bytes of ``n<i>.sim`` for every slot, seeded
    as the endpoint hash is, then finalised."""
    names = [f"n{i}.sim".encode() for i in range(n)]
    width = max((len(b) for b in names), default=0)
    buf = np.zeros((n, width), np.uint8)
    lens = np.zeros(n, np.int64)
    for i, b in enumerate(names):
        buf[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    h = np.full(n, U64(FNV_OFFSET) ^ hash64(U64(SEED_HOST), 0), U64)
    with np.errstate(over="ignore"):
        for p in range(width):
            live = lens > p
            h = np.where(live, (h ^ buf[:, p].astype(U64)) * FNV_PRIME, h)
    return splitmix64(h)


def universe(n: int):
    """``(uids, id_sum)``: slot uids (uint64 ``[n]``) and the sum of the
    identifier fingerprints of all ``n`` nodes (a Python int)."""
    uids = _fnv_names(n) ^ hash64(U64(PORT), SEED_PORT)
    i = np.arange(1, n + 1, dtype=U64)
    with np.errstate(over="ignore"):
        fp = splitmix64(hash64(i, SEED_ID_HIGH) + hash64(i * U64(7919),
                                                         SEED_ID_LOW))
    id_sum = int(fp.astype(object).sum()) & MASK64
    return uids, id_sum


def wrap_sum(values) -> int:
    """Sum of uint64 values modulo 2**64, as a Python int."""
    return int(np.asarray(values, dtype=U64).astype(object).sum()) & MASK64


def config_id(id_sum: int, member_sum: int) -> int:
    inner = int(splitmix64(U64(id_sum & MASK64)))
    return int(splitmix64(U64((inner + member_sum) & MASK64)))


def ring_orders(uids, k: int) -> np.ndarray:
    """int64 ``[k, n]``: ring ``j``'s slots in order of
    ``(hash64(uid, seed=j), uid)``."""
    return np.stack([np.lexsort((uids, hash64(uids, j))) for j in range(k)])
