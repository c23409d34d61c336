"""Hand-written CUDA kernels for the hot ops, each beside its plain PyTorch version.

Dispatch is by the device of the inputs, with no switch: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel (built at first use,
see :mod:`._build`) or raises. Each kernel wrapper carries ``launches``, a
plain count of the kernel launches it made.

The cross stack, the FM second order, the fused lookup + pool and the fused
Transformer block are ``torch.autograd.Function``s whose backward is a
kernel too. The row scatter writes in place, so on CUDA its wrapper raises
on inputs that require grad while autograd is on (:func:`forward_only`).

Each kernel also states its cost, the FLOPs and bytes its bound counts and
the units its products run on, in a ``*_cost`` function of its shapes
(:class:`KernelCost`). While a cost
counter is open (``utils/roofline.py``: ``step_cost``), each wrapper adds
its kernel's cost to it (:func:`kernel_scope`) on the card and on the CPU
alike, and hides the aten ops of its body from it, so that a step counts
the same on both devices. With no counter open the wrappers do nothing more
than launch.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, NamedTuple

import torch

# serialises the ``launches += 1`` of wrappers called from several threads
launch_count_lock = threading.Lock()


class KernelCost(NamedTuple):
    """What a kernel's bound counts for one call: its float32 operations, the
    bytes it must move (each input read once, each output written once), and
    the units its operations run on, whose peak bounds them: ``"float32"``
    outside the tensor cores, or ``"tf32"`` on them (``utils/roofline.py``'s
    names of the card's peaks)."""
    flops: int
    bytes: int
    units: str = "float32"


# the open cost counter (an object with ``add_kernel_cost(name, flops,
# bytes, units)``), or None; set by ``utils.roofline.step_cost`` alone
_counter = None
_hidden = threading.local()         # depth of kernel scopes on this thread
_NOTHING = contextlib.nullcontext()


def open_counter():
    """The open cost counter, or None."""
    return _counter


def set_counter(counter) -> None:
    """Open ``counter`` (None closes it); one at a time."""
    global _counter
    if counter is not None and _counter is not None:
        raise RuntimeError("a cost counter is already open")
    _counter = counter


def hidden() -> bool:
    """True inside a kernel's scope on this thread: the counter skips the
    aten ops it sees there."""
    return getattr(_hidden, "depth", 0) > 0


class _Hide:
    def __enter__(self):
        _hidden.depth = getattr(_hidden, "depth", 0) + 1

    def __exit__(self, *exc):
        _hidden.depth -= 1


def add_kernel_cost(name: str, flops: int, nbytes: int, units: str = "float32") -> None:
    """Add one call of kernel ``name`` to the open counter, if any."""
    counter = _counter
    if counter is not None:
        counter.add_kernel_cost(name, flops, nbytes, units)


def kernel_scope(name: str, cost: Callable[[], KernelCost]):
    """The scope of one call of kernel ``name``, or of its plain version on
    the CPU: with a counter open, adds ``cost()`` to it and hides the aten
    ops run inside from it, the cost's own among them; with none, nothing
    (``cost`` is not called)."""
    if _counter is None:
        return _NOTHING
    hide = _Hide()
    with hide:                      # the cost's own ops (distinct rows) are not counted
        add_kernel_cost(name, *cost())
    return hide


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
    """'cpu' or 'cuda' for inputs that all lie on one device; raises otherwise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device type {kind!r}")
    return kind


def forward_only(*tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through a kernel that has none."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError("this CUDA kernel is forward only: call under "
                           "torch.inference_mode() or torch.no_grad()")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it, at an address that kernels' 16-byte copies take."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
