"""Delivery accounting of the per-receiver engine: the hand-written CUDA
kernel (``csrc/rx_account.cu``), its plain PyTorch version, and the
wrapper the step calls once per delivery group (7 times per tick).

Over packed operands (little-endian along the receiver axis, as
``rx_packed.pack_bits``): ``pm`` and ``pe`` uint8 ``[C, ceil(C/8)]`` (the
message plane and the link-blocked plane), ``src`` uint8 ``[C, 1]``
(0xFF for a live sender), ``pd`` uint8 ``[1, ceil(C/8)]`` (live-receiver
bits), it computes ``ok = pm & src & pd``, ``dv = ok & ~pe`` and per-row
popcounts of ``pm``, ``dv`` and ``ok & pe`` as int32 ``[C, 4]`` (column 3
is padding). Pad bits are zero in every operand, so the counts equal the
dense ``.sum()`` counts.

``account_packed`` takes the plain version only for tensors on the CPU;
a CUDA tensor launches the kernel or raises. ``launches`` counts kernel
launches. The kernel is compiled with ``nvcc`` at first use into
``build/`` at the repository root, keyed on a hash of the source and
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

SOURCE = Path(__file__).resolve().parent / "csrc" / "rx_account.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: Kernel launches so far (the wrapper adds one per launch, nowhere else).
launches = 0

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(cuda_home) / "bin" / "nvcc")


def build() -> Path:
    """Compile the kernel's shared library if it is not built yet and
    return its path. The file name carries a hash of source and flags."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"rx_account-{key[:16]}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
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
        _lib = lib
    return _lib


def _popcount_rows(planes):
    """Per-row popcount of a uint8 plane via the SWAR ladder."""
    v = planes
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    v = (v + (v >> 4)) & 0x0F
    return v.sum(dim=1, dtype=torch.int32)


def account_plain(pm, pe, src, pd):
    """The kernel's function in PyTorch ops: ``(dv, cnt)``."""
    ok = pm & src & pd
    dv = ok & ~pe
    pad = torch.zeros(pm.shape[:1], dtype=torch.int32, device=pm.device)
    cnt = torch.stack([_popcount_rows(pm), _popcount_rows(dv),
                       _popcount_rows(ok & pe), pad], dim=1)
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


def account(msgs, crashed, pemat):
    """Delivery mask plus (delivered, dropped, link_dropped) int32 counts
    for one message set ``msgs[src, dst]`` (bool ``[C, C]``), with the
    oracle's drop precedence: a crashed sender first, then a crashed
    receiver or a link block (``link_dropped`` counts only blocks whose
    endpoints are both alive). ``pemat`` is the packed blocked plane
    (``monitor.link_blocked_packed``)."""
    c = msgs.shape[0]
    pm = pack_bits(msgs)
    src = torch.where(crashed, 0, 0xFF).to(torch.uint8)[:, None]
    pd = pack_bits(~crashed)[None, :]
    dv, cnt = account_packed(pm, pemat.contiguous(), src.contiguous(), pd)
    deliv = unpack_bits(dv, c)
    total = cnt[:, 0].sum(dtype=torch.int32)
    delivered = cnt[:, 1].sum(dtype=torch.int32)
    linkd = cnt[:, 2].sum(dtype=torch.int32)
    return deliv, delivered, total - delivered, linkd
