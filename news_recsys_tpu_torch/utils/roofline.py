"""Roofline accounting for a training step on the card: its FLOPs and the
bytes it moves, against the card's peak rate and HBM bandwidth.

Port of :mod:`news_recsys_tpu.utils.roofline`. The JAX module reads a step's
FLOPs and bytes from XLA's cost analysis of the compiled step. Eager PyTorch
has no such analysis, so :func:`step_cost` runs the step once under a
counting mode (:class:`CostCounter`) and counts:

- FLOPs: ``torch.utils.flop_counter``'s own formulas for the aten ops it
  knows (the matmuls: 2MNK), plus each hand-written kernel's count of its
  own arithmetic (its ``*_cost`` function in :mod:`..ops`). Elementwise ops
  count nothing. XLA's count also holds elementwise work, so the port's
  count of a step lies below XLA's count of the same step. Each FLOP is
  tallied by the units it runs on (``flops_by_units``): an aten matmul's by
  its operands' type (:func:`matmul_units`), a kernel's by its cost
  function; :func:`step_utilisation` weighs each by its units' peak;
- bytes: each input byte read once and each output byte written once, op by
  op, by the rules of :data:`BYTE_RULES`; a kernel counts what its bound
  counts.

The kernels are C entry points called through ``ctypes``, which no aten-level
counter sees; while the counter is open each kernel's wrapper reports its
cost and hides the aten ops of its body (:func:`..ops.kernel_scope`), so a
step counts the same on the card and on the CPU, where the wrappers run
their plain versions.

Where the reference's ``compiled_cost`` returns None on any failure, a count
here raises.
"""

from __future__ import annotations

import logging
import math
import threading
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from .. import ops

logger = logging.getLogger(__name__)

# Published peaks of the cards the port knows, by the name the card reports
# (``torch.cuda.get_device_name``): NVIDIA's H100 SXM data sheet, dense rates
# without sparsity, at the 700 W power limit. FLOP/s by the units a matmul
# runs on, and HBM bytes/s.
H100 = "NVIDIA H100 80GB HBM3"
_PEAKS = {
    H100: {"bf16": 989e12, "tf32": 495e12, "float32": 67e12, "hbm": 3.35e12},
}

# How an aten op's bytes are counted, by the op's name (its overload packet):
# "none": a view or metadata, or an allocation that writes nothing;
# "all": every distinct input tensor read once, every output written once;
#   an in-place op (a name ending in "_") writes its first argument (a tensor,
#   or a list of them), which is also an input: read once, written once;
# "gather": rows read from the table (the first argument) and written out:
#   the other inputs read, the output counted twice, the table not at all;
# "write_rows": rows written into the table (the first argument): the other
#   inputs read, the written rows read once and written once, the rest of the
#   table not at all.
# An op not named here is counted by "all" and logged once.
BYTE_RULES = {
    **dict.fromkeys((
        "view", "_unsafe_view", "_reshape_alias", "expand", "t", "transpose", "permute",
        "slice", "select", "as_strided", "detach", "alias", "unsqueeze", "squeeze", "split",
        "split_with_sizes", "unbind", "narrow", "lift_fresh", "empty", "empty_like",
        "new_empty", "empty_strided", "_record_function_enter_new", "_record_function_exit",
        # a scalar read by the host (``.item()``): AdamW's for-loop reads a
        # step count once a parameter, its foreach form twice
        "_local_scalar_dense"), "none"),
    **dict.fromkeys(("index_select", "embedding", "index", "gather"), "gather"),
    # a gather's backward writes the table's whole dense gradient (zeros but
    # for the gathered rows), which AdamW then reads whole: the output counts,
    # as the pool backward's cost counts its (V, D) gradient
    "embedding_dense_backward": "all",
    **dict.fromkeys((
        "index_put_", "index_put", "_index_put_impl_", "index_copy_", "index_copy",
        "index_add_", "index_add", "scatter", "scatter_", "scatter_add", "scatter_add_",
        "scatter_reduce", "scatter_reduce_"), "write_rows"),
    # the ops the port's training steps run besides (its rankers, the DSSM,
    # the optimizer variants), counted by the general rule
    **dict.fromkeys((
        "add", "add_", "sub", "rsub", "mul", "mul_", "div", "neg", "sqrt", "clamp",
        "clamp_min", "sigmoid", "relu", "leaky_relu", "leaky_relu_backward",
        "threshold_backward", "select_backward", "slice_backward", "bitwise_and",
        "bitwise_and_", "bitwise_or", "eq", "ne", "lt", "le", "gt", "ge", "where",
        "masked_fill", "masked_fill_", "addcmul_", "addcdiv_", "lerp_",
        "binary_cross_entropy_with_logits", "mm", "addmm", "bmm", "sum", "mean", "cumsum",
        "sort", "linalg_vector_norm", "_softmax", "_softmax_backward_data", "_log_softmax",
        "_log_softmax_backward_data", "clone", "copy_", "_to_copy", "cat", "stack",
        "constant_pad_nd", "zero_", "zeros_like", "ones_like", "scalar_tensor", "randint",
        # AdamW's foreach form, which it takes on the card
        "_foreach_add_", "_foreach_mul_", "_foreach_lerp_", "_foreach_addcmul_",
        "_foreach_sqrt", "_foreach_div_", "_foreach_addcdiv_"), "all"),
}


def device_kind(device) -> str:
    """The name a device reports: a CUDA device's ``torch.cuda.get_device_name``,
    ``"cpu"`` for the CPU, or a stand-in's ``device_kind``."""
    if isinstance(device, (str, torch.device)):
        device = torch.device(device)
        if device.type != "cuda":
            return device.type
        return torch.cuda.get_device_name(device)
    return str(getattr(device, "device_kind", ""))


def device_peaks(device=None) -> Optional[Dict]:
    """The card's published peaks: ``{"device_kind", "peak_flops"`` (bf16 on
    the tensor cores), ``"peak_hbm_bw"`` (bytes/s), ``"peak_flops_by_units"``
    (``bf16``, ``tf32``, ``float32``)``}``, or None for a device the port does
    not know, the CPU among them. ``device`` defaults to the current CUDA
    device, or the CPU where there is none."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    kind = device_kind(device)
    peaks = _PEAKS.get(kind)
    if peaks is None:
        return None
    return {"device_kind": kind, "peak_flops": peaks["bf16"], "peak_hbm_bw": peaks["hbm"],
            "peak_flops_by_units": {k: peaks[k] for k in ("bf16", "tf32", "float32")}}


def matmul_units(dtype: torch.dtype = torch.float32) -> str:
    """The units an aten matmul of ``dtype`` runs on: ``bf16`` for bfloat16
    operands; ``float32`` outside the tensor cores for float32 ones (the
    port turns TF32 off at import), or ``tf32`` where
    ``torch.backends.cuda.matmul.allow_tf32`` is on."""
    if dtype == torch.bfloat16:
        return "bf16"
    return "tf32" if torch.backends.cuda.matmul.allow_tf32 else "float32"


def step_utilisation(flops_per_step: float, bytes_per_step: float, step_time_s: float,
                     device=None, dtype: torch.dtype = torch.float32,
                     flops_by_units: Optional[Dict[str, float]] = None) -> Dict:
    """MFU and HBM-bandwidth utilisation percentages for a measured step.

    Always ``flops_per_step``, ``hbm_bytes_per_step`` and ``step_time_us``;
    for a card :func:`device_peaks` knows also ``device``, ``mfu_pct`` (3
    decimals), ``mfu_pct_by_units``, ``hbm_bw_util_pct`` (1 decimal),
    ``peak_flops`` and ``peak_units``.

    Each FLOP is held to the peak of the units it runs on:
    ``flops_by_units`` (``step_cost``'s tally, summing to
    ``flops_per_step``), or, where it is None, all of them on the units of
    a matmul of ``dtype`` (:func:`matmul_units`). ``mfu_pct`` is the least
    time of the step's FLOPs, the sum of each units' FLOPs over its peak,
    over the step time: the sum of ``mfu_pct_by_units``. ``peak_flops`` is
    the one rate that gives the same least time, and ``peak_units`` names
    the units it weighs (``"+"``-joined). The reference always divides by
    the MXU's bf16 peak, because a float32 matmul at default precision runs
    there in bf16 passes; on the H100 a float32 matmul with TF32 off does
    not run on the tensor cores, so its peak is the float32 rate."""
    out = {"flops_per_step": flops_per_step, "hbm_bytes_per_step": bytes_per_step,
           "step_time_us": step_time_s * 1e6}
    if flops_by_units is None:
        flops_by_units = {matmul_units(dtype): flops_per_step}
    elif sum(flops_by_units.values()) != flops_per_step:
        raise ValueError(f"flops_by_units {flops_by_units} does not sum to {flops_per_step}")
    peaks = device_peaks(device)
    if peaks is not None and step_time_s > 0:
        by_units = peaks["peak_flops_by_units"]
        least_s = {u: f / by_units[u] for u, f in sorted(flops_by_units.items())}
        total_s = sum(least_s.values())
        units = "+".join(least_s)
        peak = flops_per_step / total_s if total_s else by_units[matmul_units(dtype)]
        out.update(device=peaks["device_kind"], peak_flops=peak, peak_units=units,
                   mfu_pct=round(100.0 * total_s / step_time_s, 3),
                   mfu_pct_by_units={u: round(100.0 * t / step_time_s, 3)
                                     for u, t in least_s.items()},
                   hbm_bw_util_pct=round(
                       100.0 * bytes_per_step / step_time_s / peaks["peak_hbm_bw"], 1))
    return out


def _bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a view spans: a broadcast (stride 0)
    dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(tree) -> list:
    """The distinct tensors of a pytree of arguments, by identity."""
    seen, out = set(), []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor) and id(x) not in seen:
            seen.add(id(x))
            out.append(x)
    return out


def _written_rows(name: str, args) -> int:
    """Elements a row write puts into its table (the first argument)."""
    if name.startswith(("index_put", "_index_put")):
        indices, values = args[1], args[2]
        if any(i is None or i.dtype == torch.bool for i in indices):
            return values.numel()
        slots = torch.broadcast_shapes(*(i.shape for i in indices)).numel()
        return slots * math.prod(args[0].shape[len(indices):])
    if name.startswith("scatter"):
        return args[2].numel()                   # the index: an element a slot
    return args[3].numel()                       # index_copy / index_add: the source


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes an aten op moves by :data:`BYTE_RULES` (unknown ops by
    ``"all"``, logged once)."""
    name = func._overloadpacket.__name__
    rule = BYTE_RULES.get(name)
    if rule is None:
        if name not in _UNLISTED:
            _UNLISTED.add(name)
            logger.warning("roofline: aten op %s is not in BYTE_RULES; counted by the general "
                           "rule (each input read once, each output written once)", name)
        rule = "all"
    if rule == "none":
        return 0
    outs = _tensors(args[0] if name.endswith("_") else out)
    if rule == "all":
        return sum(map(_bytes, _tensors((args, kwargs)))) + sum(map(_bytes, outs))
    others = [t for t in _tensors((args[1:], kwargs)) if t is not args[0]]
    read = sum(map(_bytes, others))
    if rule == "gather":
        return read + 2 * sum(map(_bytes, outs))
    return read + 2 * _written_rows(name, args) * args[0].element_size()


_UNLISTED: set = set()


def _op_units(args) -> str:
    """The units an aten op's FLOPs run on: :func:`matmul_units` of its first
    floating-point operand."""
    for t in tree_flatten(args)[0]:
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            return matmul_units(t.dtype)
    return matmul_units()


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs and bytes of every aten op dispatched while it is on
    (but inside a kernel's scope), and the kernels' own costs, by name, and
    the FLOPs by the units they run on."""

    def __init__(self):
        super().__init__()
        self.lock = threading.Lock()
        self.ops = defaultdict(lambda: [0, 0, 0])          # name: [calls, flops, bytes]
        self.kernels = defaultdict(lambda: [0, 0, 0])
        self.flops_by_units = defaultdict(int)

    def _add(self, table, name: str, flops: int, nbytes: int, units: str) -> None:
        with self.lock:
            tally = table[name]
            tally[0] += 1
            tally[1] += int(flops)
            tally[2] += int(nbytes)
            if flops:
                self.flops_by_units[units] += int(flops)

    def add_kernel_cost(self, name: str, flops: int, nbytes: int,
                        units: str = "float32") -> None:
        self._add(self.kernels, name, flops, nbytes, units)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if ops.hidden():
            return out
        packet = func._overloadpacket
        flops = flop_registry[packet](*args, **kwargs, out_val=out) \
            if packet in flop_registry else 0
        self._add(self.ops, packet.__name__, flops, op_bytes(func, args, kwargs, out),
                  _op_units(args) if flops else "")
        return out

    def totals(self) -> Dict:
        tallies = (*self.ops.values(), *self.kernels.values())
        return {"flops": sum(t[1] for t in tallies), "bytes": sum(t[2] for t in tallies),
                "flops_by_units": dict(sorted(self.flops_by_units.items())),
                "kernels": {k: dict(zip(("calls", "flops", "bytes"), v))
                            for k, v in sorted(self.kernels.items())},
                "ops": {k: dict(zip(("calls", "flops", "bytes"), v))
                        for k, v in sorted(self.ops.items())}}


def step_cost(fn, *args, **kwargs) -> Dict:
    """``{"flops", "bytes", "flops_by_units", "kernels", "ops"}`` of one call
    of ``fn(*args, **kwargs)``: the counterpart of the reference's
    ``compiled_cost``, by the rules of this module's docstring;
    ``flops_by_units`` splits the FLOPs by the units they run on (for
    :func:`step_utilisation`), ``kernels`` and ``ops`` tally calls, FLOPs and
    bytes by name.

    It RUNS ``fn``: a training step updates its state. A caller that wants
    its state unchanged passes a copy (``copy.deepcopy`` of the state, whose
    model the step reads). On the card it waits for the device where a
    kernel's cost depends on its data (distinct rows). Raises whatever
    ``fn`` or the count raises."""
    counter = CostCounter()
    ops.set_counter(counter)
    try:
        with counter:
            fn(*args, **kwargs)
    finally:
        ops.set_counter(None)
    return counter.totals()
