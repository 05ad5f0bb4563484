"""The port's fused delivery (``rx_account.account_into``) against the
reference's ``rx_pallas.account`` and the dense ``receiver._account``.

On the CPU ``account_into`` runs ``rx_deliver``'s plain version; the
reference's Pallas kernel runs in interpret mode, as the reference's own
tests run it. Batches of one and two planes are checked plane by plane,
the counters accumulate onto nonzero values with and without a phase
slot, and the kernel's entry refuses what the kernel does not take.
Inputs come from seeded numpy. Tolerance: exact. The kernel itself runs
only on the card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rapid_tpu.engine import receiver as ref_receiver
from rapid_tpu.engine import rx_pallas

from rapid_tpu_torch.engine import rx_account, rx_packed

WIDTHS = [13, 64, 96, 200]
START = [7, -3, 11, 0, 5, 2]      # nonzero counters the call adds onto


def _inputs(c, planes, seed):
    rng = np.random.default_rng(seed)
    msgs = rng.random((planes, c, c)) < 0.4
    blocked = rng.random((c, c)) < 0.25
    crashed = rng.random(c) < 0.15
    return msgs, blocked, crashed


@pytest.mark.parametrize("phase", [None, 4])
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("c", WIDTHS)
def test_account_into_matches_pallas_and_dense(c, planes, phase):
    msgs, blocked, crashed = _inputs(c, planes, seed=100 * c + planes)
    pe = np.packbits(blocked, axis=-1, bitorder="little")
    acc = torch.tensor(START, dtype=torch.int32)
    batch = torch.from_numpy(msgs if planes == 2 else msgs[0])
    before = rx_account.deliver_launches
    deliv = rx_account.account_into(batch, torch.from_numpy(crashed),
                                    torch.from_numpy(pe), acc, phase)
    assert rx_account.deliver_launches == before
    assert deliv.dtype == torch.bool and deliv.shape == batch.shape
    deliv = deliv.reshape(planes, c, c).numpy()
    want = np.array(START, dtype=np.int64)
    for p in range(planes):
        pallas = rx_pallas.account(jnp.asarray(msgs[p]), jnp.asarray(crashed),
                                   jnp.asarray(pe))
        dense = ref_receiver._account(jnp, jnp.asarray(msgs[p]),
                                      jnp.asarray(crashed),
                                      jnp.asarray(blocked))
        for ref in (pallas, dense):
            assert np.array_equal(deliv[p], np.asarray(ref[0]))
            assert [int(x) for x in ref[1:]] == [int(x) for x in pallas[1:]]
        want[:3] += [int(x) for x in pallas[1:]]
        if phase is not None:
            want[phase] += int(pallas[1])
    assert acc.dtype == torch.int32
    assert acc.tolist() == want.tolist()


def test_account_into_plain_equals_packed_composition():
    """The plain version and ``account`` (the packed kernel's plain
    version on the CPU) give the same masks and counts."""
    msgs, blocked, crashed = _inputs(64, 2, seed=5)
    pe = torch.from_numpy(np.packbits(blocked, axis=-1, bitorder="little"))
    a = torch.tensor(START, dtype=torch.int32)
    b = a.clone()
    args = (torch.from_numpy(msgs), torch.from_numpy(crashed), pe)
    got = rx_account.account_into_plain(*args, a, 3)
    want = rx_account.account_into_composed(*args, b, 3)
    assert torch.equal(got, want) and torch.equal(a, b)


def _kernel_args(c=16, planes=1):
    msgs = torch.zeros((planes, c, c), dtype=torch.bool)
    crashed = torch.zeros(c, dtype=torch.bool)
    pe = torch.zeros((c, -(-c // 8)), dtype=torch.uint8)
    acc = torch.zeros(4, dtype=torch.int32)
    return msgs, crashed, pe, acc


@pytest.mark.parametrize("bad, match", [
    (lambda a: (a[0].to(torch.uint8),) + a[1:], "msgs must be torch.bool"),
    (lambda a: (a[0], a[1].to(torch.uint8)) + a[2:],
     "crashed must be torch.bool"),
    (lambda a: a[:2] + (a[2].to(torch.int32), a[3]),
     "pemat must be torch.uint8"),
    (lambda a: a[:3] + (a[3].to(torch.int64),), "acc must be torch.int32"),
    (lambda a: (a[0][..., :15],) + a[1:], r"msgs must be \[C, C\]"),
    (lambda a: (a[0][0, 0],) + a[1:], r"msgs must be \[C, C\]"),
    (lambda a: (a[0], a[1][:15]) + a[2:], "crashed must have shape"),
    (lambda a: a[:2] + (a[2][:, :1], a[3]), "pemat must have shape"),
    (lambda a: a[:3] + (a[3][:2],), "acc must have shape"),
    (lambda a: a[:3] + (a[3].reshape(2, 2),), "acc must have shape"),
    (lambda a: (a[0].transpose(1, 2),) + a[1:], "msgs must be contiguous"),
    (lambda a: a[:2] + (torch.zeros((2, 16), dtype=torch.uint8).T, a[3]),
     "pemat must be contiguous"),
    (lambda a: a[:3] + (torch.zeros(8, dtype=torch.int32)[::2],),
     "acc must be contiguous"),
    (lambda a: a, "must be on one CUDA device"),
])
def test_kernel_entry_refuses(bad, match):
    before = rx_account.deliver_launches
    with pytest.raises(ValueError, match=match):
        rx_account.account_into_kernel(*bad(_kernel_args()))
    assert rx_account.deliver_launches == before


@pytest.mark.parametrize("phase", [-1, 4])
def test_kernel_entry_refuses_phase_outside_acc(phase):
    with pytest.raises(ValueError, match="phase slot"):
        rx_account.account_into_kernel(*_kernel_args(), phase)


def test_bit_weights_cached_with_the_same_values():
    rx_packed._WEIGHTS.clear()
    first = rx_packed._bit_weights(torch.device("cpu"))
    again = rx_packed._bit_weights("cpu")
    assert again is first
    assert first.dtype == torch.uint8
    assert first.tolist() == [1, 2, 4, 8, 16, 32, 64, 128]
    x = torch.from_numpy(np.random.default_rng(3).random((5, 21)) < 0.5)
    packed = rx_packed.pack_bits(x)
    assert rx_packed._bit_weights("cpu") is first
    assert first.tolist() == [1, 2, 4, 8, 16, 32, 64, 128]
    assert np.array_equal(packed.numpy(),
                          np.packbits(x.numpy(), axis=-1, bitorder="little"))
    assert torch.equal(rx_packed.unpack_bits(packed, 21), x)
