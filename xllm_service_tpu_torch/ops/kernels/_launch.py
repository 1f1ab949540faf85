"""Argument checks and ctypes plumbing shared by the kernel wrappers."""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check(name: str, t: torch.Tensor, ndim: int,
          dtype: Optional[torch.dtype] = None) -> None:
    """``t`` is a contiguous tensor of ``ndim`` dims (and ``dtype``)."""
    require(isinstance(t, torch.Tensor), f"{name} must be a tensor")
    require(t.dim() == ndim, f"{name} must have {ndim} dims, got "
            f"{tuple(t.shape)}")
    if dtype is not None:
        require(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    require(t.is_contiguous(), f"{name} must be contiguous")


def on_cuda(tensors: Sequence[torch.Tensor]) -> bool:
    """True when every tensor lies on the same CUDA device, False when
    all lie on the CPU; raises on a mix or another device type."""
    devices = {t.device for t in tensors}
    require(len(devices) == 1,
            f"tensors must share one device, got {sorted(map(str, devices))}")
    dev = devices.pop()
    require(dev.type in ("cpu", "cuda"),
            f"unsupported device {dev} (the kernels run on CUDA, their "
            f"plain versions on the CPU)")
    return dev.type == "cuda"


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def raise_on_error(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
