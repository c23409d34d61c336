"""Hand-written CUDA kernels for the hot ops, each beside its plain PyTorch version.

Dispatch is by the device of the inputs, with no switch: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel (built at first use,
see :mod:`._build`) or raises. Each kernel wrapper carries ``launches``, a
plain count of the kernel launches it made.

The kernels are forward only: on CUDA the wrappers raise on inputs that
require grad while autograd is on, so serving runs under
``torch.inference_mode()``.
"""

from __future__ import annotations

import threading

import torch

# serialises the ``launches += 1`` of wrappers called from several threads
launch_count_lock = threading.Lock()


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kernel_device(*tensors: torch.Tensor) -> str:
    """'cpu' or 'cuda' for inputs that all lie on one device; raises otherwise,
    and on CUDA inputs that would need a gradient."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r}")
    if kind == "cuda" and torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("the CUDA kernels are forward only: call under "
                           "torch.inference_mode() or torch.no_grad()")
    return kind


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
