"""Argument checks shared by the CUDA wrappers: every tensor handed to a
kernel lies on the current CUDA device, has the kernel's dtype (and
shape, where given) and is contiguous."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def check_cuda(kernel: str,
               **tensors: Tuple[torch.Tensor, torch.dtype,
                                Optional[tuple]]) -> None:
    for name, (ten, dtype, shape) in tensors.items():
        if ten.device.type != "cuda":
            raise ValueError(f"{kernel}: {name} must be a CUDA tensor, "
                             f"got {ten.device}")
        if ten.device.index != torch.cuda.current_device():
            raise ValueError(f"{kernel}: {name} is on {ten.device}, not "
                             f"the current device "
                             f"cuda:{torch.cuda.current_device()}")
        if ten.dtype != dtype:
            raise TypeError(f"{kernel}: {name} must be {dtype}, got "
                            f"{ten.dtype}")
        if shape is not None and tuple(ten.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} must have shape {shape}, "
                             f"got {tuple(ten.shape)}")
        if not ten.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
