"""Delivery accounting of the per-receiver engine: two hand-written CUDA
kernels, their plain PyTorch versions, and the wrappers.

``account_into`` is what the step calls, once per delivery group (6
times per tick): the whole of the reference's ``rx_pallas.account`` for a
batch of dense bool message planes ``msgs[p, src, dst]``, in one launch
of ``csrc/rx_deliver.cu``. It returns the delivery mask and adds
(delivered, dropped, link_dropped) into slots 0-2 of an int32 vector,
and delivered into a phase's slot when one is given.

The packed kernel (``csrc/rx_account.cu``) computes only the middle of
that function, over packed operands (little-endian along the receiver
axis, as ``rx_packed.pack_bits``): ``pm`` and ``pe`` uint8 ``[C, ceil(C/8)]``
(the message plane and the link-blocked plane), ``src`` uint8 ``[C, 1]``
(0xFF for a live sender), ``pd`` uint8 ``[1, ceil(C/8)]`` (live-receiver
bits); it computes ``ok = pm & src & pd``, ``dv = ok & ~pe`` and per-row
popcounts of ``pm``, ``dv`` and ``ok & pe`` as int32 ``[C, 4]`` (column 3
is padding). Pad bits are zero in every operand, so the counts equal the
dense ``.sum()`` counts. ``account`` wraps it with the packing around it
(the packed composition); it is off the main path and kept as the
yardstick the fused kernel is timed against.

Each wrapper takes the plain version only for tensors on the CPU; a CUDA
tensor launches the kernel or raises. ``deliver_launches`` and
``launches`` count the launches of each kernel. Both kernels are
compiled with ``nvcc`` into one shared library at first use, in
``build/`` at the repository root, keyed on a hash of the sources and
flags, and bound through ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from rapid_tpu_torch.engine.rx_packed import pack_bits, unpack_bits

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "rx_account.cu", CSRC / "rx_deliver.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: Launches of each kernel so far (its wrapper adds one per launch, and
#: nowhere else): ``rx_account_kernel`` and ``rx_deliver_kernel``.
launches = 0
deliver_launches = 0

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def build() -> Path:
    """Compile both kernels into one shared library if it is not built
    yet and return its path. The file name carries a hash of the sources
    and flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in SOURCES:
        digest.update(path.read_bytes())
    out = BUILD_DIR / f"rx_kernels-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}"
                           f"\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.rx_account_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn = lib.rx_deliver_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _popcount_rows(planes):
    """Per-row popcount of uint8 planes (along the last axis) via the
    SWAR ladder."""
    v = planes
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    v = (v + (v >> 4)) & 0x0F
    return v.sum(dim=-1, dtype=torch.int32)


def account_plain(pm, pe, src, pd):
    """The kernel's function in PyTorch ops: ``(dv, cnt)``. The operands
    broadcast, so leading plane and member axes ride along."""
    ok = pm & src & pd
    dv = ok & ~pe
    pad = torch.zeros(dv.shape[:-1], dtype=torch.int32, device=pm.device)
    cnt = torch.stack([_popcount_rows(pm.expand_as(dv)), _popcount_rows(dv),
                       _popcount_rows(ok & pe), pad], dim=-1)
    return dv, cnt


def account_kernel(pm, pe, src, pd):
    """Launch the CUDA kernel on the current stream: ``(dv, cnt)``."""
    global launches
    rows, cb = pm.shape
    for name, t, shape in (("pm", pm, (rows, cb)), ("pe", pe, (rows, cb)),
                           ("src", src, (rows, 1)), ("pd", pd, (1, cb))):
        if t.device.type != "cuda" or t.device != pm.device:
            raise ValueError(f"{name} must be on {pm.device}, got {t.device}")
        if t.dtype != torch.uint8:
            raise ValueError(f"{name} must be uint8, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = _load()
    dv = torch.empty_like(pm)
    cnt = torch.empty((rows, 4), dtype=torch.int32, device=pm.device)
    stream = torch.cuda.current_stream(pm.device).cuda_stream
    err = lib.rx_account_launch(pm.data_ptr(), pe.data_ptr(),
                                src.data_ptr(), pd.data_ptr(),
                                dv.data_ptr(), cnt.data_ptr(), rows, cb,
                                stream)
    if err != 0:
        raise RuntimeError(f"rx_account kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return dv, cnt


def account_packed(pm, pe, src, pd):
    """The plain version for CPU tensors; the kernel for CUDA tensors."""
    if pm.device.type == "cpu":
        return account_plain(pm, pe, src, pd)
    return account_kernel(pm, pe, src, pd)


def _compose(msgs, crashed, pemat, packed):
    """One ``[C, C]`` plane through ``packed`` (``account_plain`` or
    ``account_packed``) with the packing around it: the delivery mask and
    the (delivered, dropped, link_dropped) int32 counts."""
    c = msgs.shape[0]
    pm = pack_bits(msgs)
    src = torch.where(crashed, 0, 0xFF).to(torch.uint8)[:, None]
    pd = pack_bits(~crashed)[None, :]
    dv, cnt = packed(pm, pemat.contiguous(), src.contiguous(), pd)
    deliv = unpack_bits(dv, c)
    total = cnt[:, 0].sum(dtype=torch.int32)
    delivered = cnt[:, 1].sum(dtype=torch.int32)
    linkd = cnt[:, 2].sum(dtype=torch.int32)
    return deliv, delivered, total - delivered, linkd


def account(msgs, crashed, pemat):
    """Delivery mask plus (delivered, dropped, link_dropped) int32 counts
    for one message set ``msgs[src, dst]`` (bool ``[C, C]``), with the
    oracle's drop precedence: a crashed sender first, then a crashed
    receiver or a link block (``link_dropped`` counts only blocks whose
    endpoints are both alive). ``pemat`` is the packed blocked plane
    (``monitor.link_blocked_packed``). The packed composition around
    ``account_packed``."""
    return _compose(msgs, crashed, pemat, account_packed)


def _compose_into(msgs, crashed, pemat, acc, phase, packed):
    out = []
    for plane in msgs.reshape((-1,) + tuple(msgs.shape[-2:])):
        deliv, delivered, dropped, linkd = _compose(plane, crashed, pemat,
                                                    packed)
        acc[:3] += torch.stack([delivered, dropped, linkd])
        if phase is not None:
            acc[phase] += delivered
        out.append(deliv)
    return torch.stack(out).reshape(msgs.shape)


def account_into_plain(msgs, crashed, pemat, acc, phase=None):
    """``rx_deliver``'s function in PyTorch ops, on any device: the planes
    of every member at once through ``pack_bits``, ``account_plain``,
    ``unpack_bits`` and the sums, added into ``acc`` (``account_into``
    has the contract)."""
    members, planes, c = _layout(msgs, crashed, pemat, acc)
    lead = tuple(crashed.shape[:-1])
    pm = pack_bits(msgs.reshape(lead + (planes, c, c)))
    src = torch.where(crashed, 0, 0xFF).to(torch.uint8)[..., None, :, None]
    pd = pack_bits(~crashed)[..., None, None, :]
    dv, cnt = account_plain(pm, pemat[..., None, :, :], src, pd)
    sums = cnt.sum(dim=(-3, -2), dtype=torch.int32)    # [..., 4]
    delivered = sums[..., 1]
    acc[..., :3] += torch.stack([delivered, sums[..., 0] - delivered,
                                 sums[..., 2]], dim=-1)
    if phase is not None:
        acc[..., phase] += delivered
    return unpack_bits(dv, c).reshape(msgs.shape)


def account_into_composed(msgs, crashed, pemat, acc, phase=None):
    """The same through ``account`` (on a CUDA tensor, the packed kernel
    once per plane plus the packing around it): the yardstick."""
    return _compose_into(msgs, crashed, pemat, acc, phase, account_packed)


def _layout(msgs, crashed, pemat, acc):
    """``(members, planes, c)`` of one delivery call, its dtypes and shapes
    checked. One member: ``msgs`` ``[C, C]`` or ``[B, C, C]``, ``crashed``
    ``[C]``, ``acc`` ``[n]``; a fleet of F: ``msgs`` ``[F, C, C]`` or
    ``[F, B, C, C]``, ``crashed`` ``[F, C]``, ``pemat`` ``[F, C,
    ceil(C/8)]``, ``acc`` ``[F, n]``."""
    lead = tuple(crashed.shape[:-1])[:1]
    c = msgs.shape[-1]
    if (msgs.dim() not in (len(lead) + 2, len(lead) + 3)
            or tuple(msgs.shape[:len(lead)]) != lead
            or msgs.shape[-2] != c):
        raise ValueError(f"msgs must be [C, C] or [B, C, C], after the "
                         f"member axis of crashed when it has one; got "
                         f"{tuple(msgs.shape)}")
    if acc.dim() != len(lead) + 1 or tuple(acc.shape[:-1]) != lead or \
            acc.shape[-1] < 3:
        raise ValueError(f"acc must have shape {lead + ('n >= 3',)}, got "
                         f"{tuple(acc.shape)}")
    for name, t, dtype, shape in (
            ("msgs", msgs, torch.bool, tuple(msgs.shape)),
            ("crashed", crashed, torch.bool, lead + (c,)),
            ("pemat", pemat, torch.uint8, lead + (c, -(-c // 8))),
            ("acc", acc, torch.int32, tuple(acc.shape))):
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
    members = lead[0] if lead else 1
    return members, msgs.numel() // max(1, members * c * c), c


def account_into_kernel(msgs, crashed, pemat, acc, phase=None):
    """Launch ``rx_deliver`` on the current stream, one launch for every
    member (``account_into`` has the contract). Dtypes, shapes and
    contiguity are checked before the device, so each refusal can be
    seen on any device."""
    global deliver_launches
    members, planes, c = _layout(msgs, crashed, pemat, acc)
    for name, t in (("msgs", msgs), ("crashed", crashed), ("pemat", pemat),
                    ("acc", acc)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if phase is not None and not 0 <= phase < acc.shape[-1]:
        raise ValueError(f"phase slot {phase} is outside acc "
                         f"({acc.shape[-1]} slots)")
    for name, t in (("msgs", msgs), ("crashed", crashed), ("pemat", pemat),
                    ("acc", acc)):
        if t.device.type != "cuda" or t.device != msgs.device:
            raise ValueError(f"{name} must be on one CUDA device, got "
                             f"{t.device}")
    lib = _load()
    deliv = torch.empty_like(msgs)
    stream = torch.cuda.current_stream(msgs.device).cuda_stream
    err = lib.rx_deliver_launch(msgs.data_ptr(), crashed.data_ptr(),
                                pemat.data_ptr(), deliv.data_ptr(),
                                acc.data_ptr(), members, planes, c,
                                acc.shape[-1],
                                -1 if phase is None else phase, stream)
    if err != 0:
        raise RuntimeError(f"rx_deliver kernel launch failed: CUDA error "
                           f"{err}")
    deliver_launches += 1
    return deliv


def account_into(msgs, crashed, pemat, acc, phase=None):
    """Delivery of ``msgs`` (bool ``[C, C]`` or ``[B, C, C]``, planes of
    ``msgs[src, dst]``) with ``receiver._account``'s precedences: returns
    the delivery mask (same shape) and adds, summed over the planes,
    delivered into ``acc[0]``, dropped into ``acc[1]``, link_dropped into
    ``acc[2]`` and, when ``phase`` is a slot index, delivered into
    ``acc[phase]`` (``acc``: int32 ``[n >= 3]``). ``crashed`` is bool
    ``[C]``, ``pemat`` the packed blocked plane. A fleet puts a member
    axis first on every operand (``_layout``) and each member's counts go
    into its row of ``acc``. The plain version for CPU tensors;
    ``rx_deliver`` for CUDA tensors."""
    if msgs.device.type == "cpu":
        return account_into_plain(msgs, crashed, pemat, acc, phase)
    return account_into_kernel(msgs, crashed, pemat, acc, phase)
