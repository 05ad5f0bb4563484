"""Classic-Paxos helpers of the per-receiver engine.

Rank indices and ring-0 positions on tensors, and the host table of
fallback-timer delays each slot can draw. All randomness of a run is the
host's per-slot ``random.Random`` streams of ``adversary_rngs``, the same
streams the reference's host referee draws from.
"""
from __future__ import annotations

import math
import random
from typing import List

import numpy as np
import torch

from rapid_tpu_torch import hashing
from rapid_tpu_torch.engine.state import I32_MAX
from rapid_tpu_torch.settings import Settings

RANK_SEED = 0x72616E6B


def adversary_rngs(seed: int, n: int) -> List[random.Random]:
    """Per-slot jitter rngs, as the reference's host referee builds them."""
    return [random.Random(seed * 1000003 + slot) for slot in range(n)]


def classic_rank_index(uid_hi, uid_lo):
    """i32 [C]: the low 31 bits of ``hash64(uid, seed=RANK_SEED)``."""
    _, lo = hashing.hash64_limbs(uid_hi, uid_lo, seed=RANK_SEED)
    return (lo & 0x7FFFFFFF).to(torch.int32)


def ring0_positions(member, ring_order, ring_rank):
    """i32 ``[..., C]``: each member's position in ring-0 order among the
    members of its view; non-members read ``I32_MAX``."""
    member = member.to(torch.bool)
    order0 = ring_order[:, 0].to(torch.int64)
    rank0 = ring_rank[:, 0].to(torch.int64)
    mrank_s = torch.cumsum(member[..., order0].to(torch.int32), dim=-1) - 1
    mpos = mrank_s[..., rank0].to(torch.int32)
    return torch.where(member, mpos, I32_MAX).to(torch.int32)


def expovariate_delay_ticks(u: float, n: int, settings: Settings) -> int:
    """The oracle's fallback delay for uniform draw ``u`` and instance
    size ``n``: base delay plus expovariate jitter with rate 1/N."""
    jitter_ms = -1000.0 * math.log(1.0 - u) * n
    return settings.fallback_base_delay_ticks + max(
        0, round(jitter_ms / settings.tick_ms))


def build_delay_table(seed: int, capacity: int, n_draws: int,
                      settings: Settings) -> np.ndarray:
    """``table[slot, draw, m]``: the delay of each slot's ``draw``-th
    uniform at every instance size ``m`` in ``0..capacity`` (int32 numpy).

    Vectorised over ``m`` only, with the same float64 arithmetic as
    ``expovariate_delay_ticks``: one ``math.log`` per draw (numpy's log
    may differ in the last ulp), ``(-1000.0 * log) * m``, then ``np.rint``
    (half to even, like Python's ``round``) and the clamp at 0."""
    rngs = adversary_rngs(seed, capacity)
    m = np.arange(capacity + 1, dtype=np.float64)
    table = np.zeros((capacity, n_draws, capacity + 1), np.int32)
    for s in range(capacity):
        for d in range(n_draws):
            scale = -1000.0 * math.log(1.0 - rngs[s].random())
            ticks = np.rint((scale * m) / settings.tick_ms)
            table[s, d] = settings.fallback_base_delay_ticks + np.maximum(
                0.0, ticks).astype(np.int64)
    return table
