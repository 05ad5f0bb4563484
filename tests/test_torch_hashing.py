"""Limb hashing of the PyTorch port against the reference's numpy form.

Exact equality: the limb math is integer arithmetic. Inputs are random
uint64 values from a seeded numpy generator plus the edge values 0,
2**32 - 1, 2**32 and 2**64 - 1, in both operand positions.
"""
import numpy as np
import pytest
import torch

from rapid_tpu import hashing as ref

from rapid_tpu_torch import hashing as port

EDGES = np.array([0, 2**32 - 1, 2**32, 2**64 - 1, 1, 2**63], dtype=np.uint64)


def _values(seed, n=512):
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, 2**64, size=n, dtype=np.uint64)
    return np.concatenate([EDGES, rand])


def _operands(seed):
    a = _values(seed)
    b = np.roll(_values(seed + 1), 3)
    # every edge value against every edge value
    ea, eb = np.meshgrid(EDGES, EDGES)
    a = np.concatenate([a, ea.ravel()])
    b = np.concatenate([b, eb.ravel()])
    ahi, alo = ref.np_to_limbs(a)
    bhi, blo = ref.np_to_limbs(b)
    return ahi, alo, bhi, blo


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w).astype(np.int64)
        assert g.dtype == torch.int64
        assert np.array_equal(g.numpy(), w)


BINARY = {
    "mul32_wide": (lambda a, b: port.mul32_wide(a[1], b[1]),
                   lambda a, b: ref.mul32_wide(np, a[1], b[1])),
    "add64": (lambda a, b: port.add64(*a, *b),
              lambda a, b: ref.add64(np, *a, *b)),
    "sub64": (lambda a, b: port.sub64(*a, *b),
              lambda a, b: ref.sub64(np, *a, *b)),
    "mul64": (lambda a, b: port.mul64(*a, *b),
              lambda a, b: ref.mul64(np, *a, *b)),
    "hash64_limbs_dynseed": (
        lambda a, b: port.hash64_limbs_dynseed(*a, *b),
        lambda a, b: ref.hash64_limbs_dynseed(np, *a, *b)),
}


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_limb_functions(name):
    ahi, alo, bhi, blo = _operands(seed=len(name))
    port_fn, ref_fn = BINARY[name]
    with np.errstate(over="ignore"):
        want = ref_fn((ahi, alo), (bhi, blo))
    _same(port_fn((_t(ahi), _t(alo)), (_t(bhi), _t(blo))), want)


@pytest.mark.parametrize("name", ["neg64", "splitmix64_limbs"])
def test_unary_limb_functions(name):
    hi, lo, _, _ = _operands(seed=5)
    with np.errstate(over="ignore"):
        want = getattr(ref, name)(np, hi, lo)
    _same(getattr(port, name)(_t(hi), _t(lo)), want)


@pytest.mark.parametrize("n", [1, 27, 30, 31, 32, 33, 40, 63])
def test_shr64(n):
    hi, lo, _, _ = _operands(seed=n)
    _same(port.shr64(_t(hi), _t(lo), n), ref.shr64(np, hi, lo, n))


@pytest.mark.parametrize("seed", [0, 0x6D656D62, 0x72616E6B, 2**64 - 1])
def test_hash64_limbs(seed):
    hi, lo, _, _ = _operands(seed=seed % 97)
    with np.errstate(over="ignore"):
        want = ref.hash64_limbs(np, hi, lo, seed=seed)
    _same(port.hash64_limbs(_t(hi), _t(lo), seed=seed), want)


@pytest.mark.parametrize("width", [1, 2, 7, 64, 1000])
def test_sum64_axis(width):
    vals = _values(seed=width, n=3 * width)[:3 * width].reshape(3, width)
    hi, lo = ref.np_to_limbs(vals)
    _same(port.sum64_axis(_t(hi), _t(lo)), ref.sum64_axis(np, hi, lo))


def test_host_helpers_match():
    for x in [0, 1, 2**32 - 1, 2**64 - 1, 0x1234567890ABCDEF]:
        assert port.splitmix64(x) == ref.splitmix64(x)
        assert port.hash64(x, seed=x ^ 77) == ref.hash64(x, seed=x ^ 77)
        assert port.to_limbs(x) == ref.to_limbs(x)
        assert port.from_limbs(*port.to_limbs(x)) == x
    for data in [b"", b"n0.sim", b"n4095.sim"]:
        assert port.fingerprint_bytes(data, 0x686F7374) == \
            ref.fingerprint_bytes(data, 0x686F7374)
    vals = _values(seed=9)
    for a, b in zip(port.np_to_limbs(vals), ref.np_to_limbs(vals)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
