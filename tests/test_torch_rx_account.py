"""The port's delivery accounting against the reference's Pallas kernel.

``account_plain`` (the CUDA kernel's plain version) and the port's
``account`` wrapper run on the CPU; the reference's ``rx_pallas.account``
runs its Pallas kernel in interpret mode, as the reference's own tests
do, and the dense ``receiver._account`` is the second yardstick. Inputs
are random planes and crashed masks from seeded numpy. Tolerance: exact.
The kernel itself runs only on the card: ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold it against its plain version there.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from rapid_tpu.engine import receiver as ref_receiver
from rapid_tpu.engine import rx_pallas

from rapid_tpu_torch.engine import rx_account
from rapid_tpu_torch.engine.rx_packed import pack_bits, unpack_bits

WIDTHS = [13, 64, 96, 200]


def _inputs(c, seed):
    rng = np.random.default_rng(seed)
    msgs = rng.random((c, c)) < 0.4
    blocked = rng.random((c, c)) < 0.25
    crashed = rng.random(c) < 0.15
    return msgs, blocked, crashed


@pytest.fixture(params=WIDTHS)
def case(request):
    c = request.param
    msgs, blocked, crashed = _inputs(c, seed=c)
    pe = np.packbits(blocked, axis=-1, bitorder="little")
    return c, msgs, blocked, crashed, pe


def test_account_matches_pallas_and_dense(case):
    c, msgs, blocked, crashed, pe = case
    got = rx_account.account(torch.from_numpy(msgs),
                             torch.from_numpy(crashed),
                             torch.from_numpy(pe))
    pallas = rx_pallas.account(jnp.asarray(msgs), jnp.asarray(crashed),
                               jnp.asarray(pe))
    dense = ref_receiver._account(jnp, jnp.asarray(msgs),
                                  jnp.asarray(crashed), jnp.asarray(blocked))
    assert got[0].dtype == torch.bool
    for want in (pallas, dense):
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:], want[1:]):
            assert g.dtype == torch.int32 and g.dim() == 0
            assert int(g) == int(w)


def test_account_plain_matches_the_pallas_kernel_program(case):
    """The plain version on the kernel's own packed operands equals the
    Pallas kernel body run in interpret mode: dv and all four count
    columns."""
    from jax.experimental import pallas as pl
    import jax

    c, msgs, _blocked, crashed, pe = case
    pm = np.packbits(msgs, axis=-1, bitorder="little")
    src = np.where(crashed, 0, 0xFF).astype(np.uint8)[:, None]
    pd = np.packbits(~crashed, bitorder="little")[None, :]
    dv_ref, cnt_ref = pl.pallas_call(
        rx_pallas._account_kernel,
        out_shape=(jax.ShapeDtypeStruct(pm.shape, jnp.uint8),
                   jax.ShapeDtypeStruct((c, 4), jnp.int32)),
        interpret=True)(pm, pe, src, pd)
    dv, cnt = rx_account.account_plain(*(torch.from_numpy(a) for a in
                                         (pm, pe, src, pd)))
    assert dv.dtype == torch.uint8 and cnt.dtype == torch.int32
    assert np.array_equal(dv.numpy(), np.asarray(dv_ref))
    assert np.array_equal(cnt.numpy(), np.asarray(cnt_ref))


@pytest.mark.parametrize("c", WIDTHS + [1, 8, 1000])
def test_pack_bits_matches_numpy(c):
    rng = np.random.default_rng(c)
    x = rng.random((3, c)) < 0.5
    packed = pack_bits(torch.from_numpy(x))
    assert packed.dtype == torch.uint8
    assert np.array_equal(packed.numpy(),
                          np.packbits(x, axis=-1, bitorder="little"))
    assert np.array_equal(unpack_bits(packed, c).numpy(), x)


def test_cpu_tensors_take_the_plain_version_without_counting():
    msgs, _blocked, crashed = _inputs(64, seed=1)
    before = rx_account.launches
    rx_account.account(torch.from_numpy(msgs), torch.from_numpy(crashed),
                       torch.zeros((64, 8), dtype=torch.uint8))
    assert rx_account.launches == before


def test_kernel_refuses_cpu_tensors():
    pm = torch.zeros((8, 1), dtype=torch.uint8)
    with pytest.raises(ValueError, match="must be on"):
        rx_account.account_kernel(pm, pm, pm, pm[:1])

