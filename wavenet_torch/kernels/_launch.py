"""Checks shared by the wrappers of the training kernels (``fused_stack``,
``fused_stack_carry``, ``dilated_layer``): where a call runs, and what a
kernel takes."""

from __future__ import annotations

import torch


def use_kernel(op: str, t: torch.Tensor) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain version (a
    CPU tensor); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{op}: unsupported device {t.device}")
    return True


def check(op: str, name: str, t: torch.Tensor, shape, device,
          dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if (t.dtype != dtype or t.device != device
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(
            f"{op}: {name} must be {str(dtype).split('.')[-1]} "
            f"{tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")


def stream(device) -> int:
    """The current CUDA stream of ``device``, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream
