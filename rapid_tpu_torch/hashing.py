"""Seeded 64-bit hashing: host helpers and the limb math on tensors.

The reference shares one splitmix64-style hash between its host oracle and
its device kernels, on ``(hi, lo)`` uint32 limb pairs. The port keeps the
limb form, because configuration ids, ring order and jitter draws must be
bit-identical to the reference, but carries each 32-bit limb in an
``int64`` tensor holding a value in ``[0, 2**32)``: PyTorch has no
``uint32`` arithmetic (``>>``, ``+`` and ``<`` raise on ``uint32``
tensors). Every ``+``, ``*``, ``~`` and ``<<`` below is masked back to 32
bits, and products keep the reference's 16-bit split, because a full
32x32 product can exceed ``2**63``.

All Python-int helpers treat values as unsigned 64-bit.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MASK64 = (1 << 64) - 1
MASK32 = (1 << 32) - 1

# splitmix64 constants
_GAMMA = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


# ---------------------------------------------------------------------------
# Pure-Python reference (host-side scalars)
# ---------------------------------------------------------------------------


def splitmix64(x: int) -> int:
    """The splitmix64 finalizer on a python int (unsigned 64-bit)."""
    z = (x + _GAMMA) & MASK64
    z = ((z ^ (z >> 30)) * _MIX1) & MASK64
    z = ((z ^ (z >> 27)) * _MIX2) & MASK64
    return z ^ (z >> 31)


def hash64(x: int, seed: int = 0) -> int:
    """Seeded 64-bit hash of a 64-bit value."""
    return splitmix64((x ^ splitmix64(seed & MASK64)) & MASK64)


def fingerprint_bytes(data: bytes, seed: int = 0) -> int:
    """64-bit fingerprint of a byte string (FNV-1a 64 + splitmix finalize)."""
    h = 0xCBF29CE484222325 ^ hash64(seed)
    for b in data:
        h = ((h ^ b) * 0x100000001B3) & MASK64
    return splitmix64(h)


def to_limbs(x: int) -> Tuple[int, int]:
    x &= MASK64
    return (x >> 32) & MASK32, x & MASK32


def from_limbs(hi: int, lo: int) -> int:
    return ((int(hi) & MASK32) << 32) | (int(lo) & MASK32)


def np_to_limbs(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    arr = arr.astype(np.uint64)
    return ((arr >> np.uint64(32)).astype(np.uint32),
            (arr & np.uint64(MASK32)).astype(np.uint32))


# ---------------------------------------------------------------------------
# Limb math on int64 tensors holding 32-bit values
# ---------------------------------------------------------------------------


def _lo32_product(a, b):
    """``(a * b) mod 2**32`` for limbs, without a product above 2**49."""
    return ((a & 0xFFFF) * b + (((a >> 16) * (b & 0xFFFF)) << 16)) & MASK32


def mul32_wide(a, b):
    """32x32 -> 64 multiply on limbs, returning (hi, lo)."""
    a0 = a & 0xFFFF
    a1 = a >> 16
    b0 = b & 0xFFFF
    b1 = b >> 16
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = p01 + (p00 >> 16)
    mid2 = mid + p10                      # < 2**33: bit 32 is the carry
    carry = mid2 >> 32
    mid2 = mid2 & MASK32
    lo = (p00 & 0xFFFF) | ((mid2 << 16) & MASK32)
    hi = (p11 + (mid2 >> 16) + (carry << 16)) & MASK32
    return hi, lo


def add64(ahi, alo, bhi, blo):
    lo = alo + blo
    carry = lo >> 32
    return (ahi + bhi + carry) & MASK32, lo & MASK32


def xor64(ahi, alo, bhi, blo):
    return ahi ^ bhi, alo ^ blo


def neg64(hi, lo):
    """Two's-complement negation on (hi, lo) limbs."""
    return add64(~hi & MASK32, ~lo & MASK32,
                 torch.zeros_like(hi), torch.ones_like(lo))


def sub64(ahi, alo, bhi, blo):
    """a - b mod 2**64 on (hi, lo) limbs."""
    nhi, nlo = neg64(bhi, blo)
    return add64(ahi, alo, nhi, nlo)


def sum64_axis(hi, lo):
    """Sum (hi, lo) limbs mod 2**64 along the LAST axis.

    The reference folds pairwise in uint32 because JAX has no 64-bit
    integers by default; int64 holds the exact limb sums for fewer than
    2**31 terms, so one carry fold gives the same residue."""
    slo = lo.sum(dim=-1)
    shi = hi.sum(dim=-1) + (slo >> 32)
    return shi & MASK32, slo & MASK32


def shr64(hi, lo, n: int):
    """Logical right shift by constant 0 < n < 64."""
    assert 0 < n < 64
    if n < 32:
        new_lo = (lo >> n) | ((hi << (32 - n)) & MASK32)
        new_hi = hi >> n
    else:
        new_lo = hi >> (n - 32) if n > 32 else hi
        new_hi = torch.zeros_like(hi)
    return new_hi, new_lo


def mul64(ahi, alo, bhi, blo):
    """Low 64 bits of a 64x64 multiply, on (hi, lo) limbs."""
    hi_ll, lo_ll = mul32_wide(alo, blo)
    hi = (hi_ll + _lo32_product(alo, bhi) + _lo32_product(ahi, blo)) & MASK32
    return hi, lo_ll


def _mul64_const(hi, lo, c: int):
    return mul64(hi, lo, (c >> 32) & MASK32, c & MASK32)


def splitmix64_limbs(hi, lo):
    """splitmix64 finalizer on limbs; matches splitmix64()."""
    hi, lo = add64(hi, lo, (_GAMMA >> 32) & MASK32, _GAMMA & MASK32)
    shi, slo = shr64(hi, lo, 30)
    hi, lo = xor64(hi, lo, shi, slo)
    hi, lo = _mul64_const(hi, lo, _MIX1)
    shi, slo = shr64(hi, lo, 27)
    hi, lo = xor64(hi, lo, shi, slo)
    hi, lo = _mul64_const(hi, lo, _MIX2)
    shi, slo = shr64(hi, lo, 31)
    return xor64(hi, lo, shi, slo)


def hash64_limbs(hi, lo, seed: int = 0):
    """Seeded hash on limbs; matches hash64()."""
    s = splitmix64(seed & MASK64)
    return splitmix64_limbs(hi ^ ((s >> 32) & MASK32), lo ^ (s & MASK32))


def hash64_limbs_dynseed(hi, lo, seed_hi, seed_lo):
    """``hash64_limbs`` with the seed as limb tensors (a tick, a rule seed);
    matches ``hash64(x, seed)`` bit for bit."""
    seed_hi = torch.as_tensor(seed_hi, dtype=torch.int64, device=hi.device)
    seed_lo = torch.as_tensor(seed_lo, dtype=torch.int64, device=lo.device)
    shi, slo = splitmix64_limbs(seed_hi, seed_lo)
    return splitmix64_limbs(hi ^ shi, lo ^ slo)
