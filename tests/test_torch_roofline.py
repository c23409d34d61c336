"""The port's roofline accounting (``news_recsys_tpu_torch/utils/roofline.py``)
on the CPU, against the JAX package's (``news_recsys_tpu/utils/roofline.py``).

The JAX module reads XLA's cost analysis of a compiled step; the port runs
the step once under a counting mode, with each hand-written kernel's own
count of its work. These tests hold:

- the counterparts of ``tests/test_roofline.py``'s four cases (a 64 x 64
  matmul, the CPU as an unknown device, the H100's ratios, no shares on an
  unknown device);
- each kernel counted alone: its plain version under the counter equals its
  cost function exactly, forward and backward, and no aten op of its body
  is counted;
- each byte rule on one op, against a count by hand;
- a narrow DCN step and a narrow all-dense step against a count by hand,
  FLOPs and bytes: each op family that moves a table, a parameter or an
  optimizer's moments, and each kernel, exactly; every other op's call
  under a bound of three of the step's widest activations. The DCN step's
  bytes also lie under one pass over its arena, where a naive sum of every
  op's operands lies above it;
- the divergence of the reference's use of its module: XLA counts a
  ``lax.scan``'s body once, whatever its length, while the port's count of
  two steps is twice its count of one;
- a count repeats itself, and with no counter open a step runs what it
  runs without the module.

The full-width DCN step against XLA's count is in
``tests/test_torch_roofline_xla.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from news_recsys_tpu.utils.roofline import compiled_cost
from news_recsys_tpu_torch import ops
from news_recsys_tpu_torch.config import build_schema, table_specs
from news_recsys_tpu_torch.models.embedding import offset_ids
from news_recsys_tpu_torch.models.rankers import DCNRanker, build_ranker
from news_recsys_tpu_torch.ops.dcn_kernel import (cross_bwd_cost, cross_cost, dcn_cross_bwd,
                                                  dcn_cross_stack)
from news_recsys_tpu_torch.ops.fm_kernel import fm_bwd_cost
from news_recsys_tpu_torch.ops.fused_attention import block_bwd_cost, fused_transformer_block
from news_recsys_tpu_torch.ops.fused_lookup_pool import (fused_lookup_pool, pool_bwd_cost,
                                                         pool_cost, pooled_rows)
from news_recsys_tpu_torch.ops.scatter_rows import scatter_cost, scatter_rows_set
from news_recsys_tpu_torch.training import sparse_step as tss
from news_recsys_tpu_torch.training.dense_step import init_dense_state, make_train_step
from news_recsys_tpu_torch.training.trainer import AucHist, BatchPacker, unpack_batch
from news_recsys_tpu_torch.utils import roofline
from news_recsys_tpu_torch.utils.roofline import device_peaks, step_cost, step_utilisation

from tests.test_torch_cuda import (block_inputs, counted_kernel_cases, pool_inputs, train_cfg,
                                   train_dataset)

torch.set_num_threads(2)
H100 = "NVIDIA H100 80GB HBM3"


class StandIn:
    """A device that reports a name, as a card does."""

    def __init__(self, kind):
        self.device_kind = kind


# -- the counterparts of tests/test_roofline.py ---------------------------------


def test_step_cost_matmul():
    a = np.ones((64, 64), np.float32)
    jax_cost = compiled_cost(jax.jit(lambda x, y: (x @ y).sum()), jnp.asarray(a), jnp.asarray(a))
    cost = step_cost(lambda x, y: (x @ y).sum(), torch.from_numpy(a), torch.from_numpy(a.copy()))
    assert cost["flops"] == 2 * 64 ** 3
    assert jax_cost["flops"] >= cost["flops"]
    # the mm reads both operands and writes 64 x 64; the sum reads that and writes a scalar
    assert cost["bytes"] == 4 * (3 * 64 * 64) + 4 * (64 * 64 + 1)
    assert cost["kernels"] == {}


def test_device_peaks_unknown_on_cpu():
    assert device_peaks(torch.device("cpu")) is None
    assert device_peaks("cpu") is None
    assert device_peaks(StandIn("NVIDIA A100-SXM4-80GB")) is None      # a card it does not know


@pytest.mark.parametrize("dtype, tf32, peak, units", [
    (torch.float32, False, 67e12, "float32"), (torch.float32, True, 495e12, "tf32"),
    (torch.bfloat16, False, 989e12, "bf16")])
def test_step_utilisation_known_card(monkeypatch, dtype, tf32, peak, units):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", tf32)
    # 1 GFLOP + 1 MB in 1 ms: mfu = 1e9/1e-3/peak, bw = 1e6/1e-3/3.35e12
    out = step_utilisation(1e9, 1e6, 1e-3, device=StandIn(H100), dtype=dtype)
    assert out["device"] == H100
    assert out["peak_flops"] == peak and out["peak_units"] == units
    assert out["mfu_pct"] == round(100 * 1e12 / peak, 3)
    assert out["hbm_bw_util_pct"] == round(100 * 1e9 / 3.35e12, 1)
    assert out["step_time_us"] == 1000.0
    assert device_peaks(StandIn(H100))["peak_hbm_bw"] == 3.35e12


def test_step_utilisation_weighs_each_units_by_its_peak():
    """FLOPs on two kinds of units: the least time is each one's FLOPs over
    its peak, summed; the share is that over the step time."""
    by_units = {"float32": 1e9, "tf32": 4.95e9}
    out = step_utilisation(5.95e9, 1e6, 1e-3, device=StandIn(H100), flops_by_units=by_units)
    least_s = 1e9 / 67e12 + 4.95e9 / 495e12
    assert out["mfu_pct"] == round(100 * least_s / 1e-3, 3)
    assert out["mfu_pct_by_units"] == {"float32": round(100 * 1e9 / 67e12 / 1e-3, 3),
                                       "tf32": round(100 * 4.95e9 / 495e12 / 1e-3, 3)}
    assert out["peak_flops"] == pytest.approx(5.95e9 / least_s)
    assert out["peak_units"] == "float32+tf32"
    with pytest.raises(ValueError, match="does not sum"):
        step_utilisation(1e9, 1e6, 1e-3, device=StandIn(H100), flops_by_units=by_units)


def test_step_utilisation_unknown_device():
    out = step_utilisation(1e9, 1e6, 1e-3, device=torch.device("cpu"))
    assert "mfu_pct" not in out and "device" not in out and "peak_flops" not in out
    assert out["flops_per_step"] == 1e9 and out["hbm_bytes_per_step"] == 1e6


# -- each byte rule on one op -----------------------------------------------------------


def _rule_cases() -> dict:
    """Each byte rule on one op: (the op's name, its inputs, the op, its bytes
    by hand). Tables of 1,000 x 4 float32; ids of 7 slots, int64 unless said."""
    f, emb = torch.ones, torch.nn.functional.embedding
    ids, idx2 = torch.tensor([3, 1, 4, 1, 5, 9, 2]), torch.zeros(10, 2).long()
    rows = 2 * 4 * 7 * 4                      # 7 rows of 4 floats, read and written
    return {
        # (4, 8) @ (8, 3): both operands read, the (4, 3) product written
        "mm": ("mm", (f(4, 8), f(8, 3)), torch.mm, 4 * (32 + 24 + 12)),
        # in place: the written tensor read and written, the other read
        "add_": ("add_", (f(5, 6), f(5, 6)), torch.Tensor.add_, 4 * 3 * 30),
        # a broadcast operand counts its own elements once
        "broadcast": ("add", (f(5, 6), f(6).expand(5, 6)), torch.add, 4 * (30 + 6 + 30)),
        "views": ("view", (f(5, 6),), lambda x: x.view(30).unsqueeze(0)[:, 1:3].t().detach(),
                  0),
        # gathers: the ids read, the rows read and written; the table not at all
        "embedding": ("embedding", (ids, f(1000, 4)), emb, 8 * 7 + rows),
        "index_select": ("index_select", (f(1000, 4), 0, ids.to(torch.int32)),
                         torch.index_select, 4 * 7 + rows),
        "index": ("index", (f(1000, 4), ids), lambda t, i: t[i], 8 * 7 + rows),
        "gather": ("gather", (f(10, 6), 1, idx2), torch.gather, 8 * 20 + 2 * 4 * 20),
        # a gather's backward: the gradient and ids read, the (V, D) table written
        "embedding_dense_backward": (
            "embedding_dense_backward", (f(7, 4), ids, 1000, -1, False),
            torch.ops.aten.embedding_dense_backward, 4 * 7 * 4 + 8 * 7 + 4 * 1000 * 4),
        # row writes: the ids and values read, the written rows read and written
        "index_put_": ("index_put_", (f(1000, 4), (ids,), f(7, 4)), torch.Tensor.index_put_,
                       8 * 7 + 4 * 7 * 4 + rows),
        "index_add_": ("index_add_", (f(1000, 4), 0, ids, f(7, 4)), torch.Tensor.index_add_,
                       8 * 7 + 4 * 7 * 4 + rows),
        "index_copy_": ("index_copy_", (f(1000, 4), 0, ids, f(7, 4)),
                        torch.Tensor.index_copy_, 8 * 7 + 4 * 7 * 4 + rows),
        "scatter_": ("scatter_", (f(10, 6), 1, idx2, f(10, 2)), torch.Tensor.scatter_,
                     8 * 20 + 4 * 20 + 2 * 4 * 20),
        # a list in place: each of its tensors read and written, the others read
        "_foreach_add_": ("_foreach_add_", ([f(5), f(3)], [f(5), f(3)]),
                          torch._foreach_add_, 4 * (5 + 3) * 3),
    }


RULE_CASES = _rule_cases()


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_a_byte_rule_on_one_op_is_its_hand_count(case):
    name, args, op, want = RULE_CASES[case]
    cost = step_cost(op, *args)
    assert name in cost["ops"]
    assert cost["bytes"] == want, cost["ops"]


# -- each kernel counted alone ---------------------------------------------------------


KERNEL_CASES = counted_kernel_cases(torch.device("cpu"))


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_a_kernel_counted_alone_is_its_cost(case):
    """The plain version under the counter counts the kernel's cost function
    exactly, and none of its own aten ops."""
    name, call, want = KERNEL_CASES[case]()
    cost = step_cost(call)
    assert cost["kernels"] == {name: {"calls": 1, "flops": want.flops, "bytes": want.bytes}}
    assert cost["ops"] == {}
    assert (cost["flops"], cost["bytes"]) == (want.flops, want.bytes)
    assert cost["flops_by_units"] == ({want.units: want.flops} if want.flops else {})
    assert ops.open_counter() is None


@pytest.mark.parametrize("case", ["cross_grad", "fm_grad", "pool_grad", "block_grad"])
def test_a_kernels_backward_counts_its_cost_through_autograd(case):
    """Forward and backward under one counter: each kernel once, and of the
    aten ops only the loss's sum, the backward's seed (``ones_like``), its
    expansion, the copy of it that a wrapper takes contiguous and the leaves'
    gradients stored (``detach``)."""
    name, call, want = KERNEL_CASES[case]()
    bwd = {"dcn_cross_stack": ("dcn_cross_bwd", cross_bwd_cost(48, 24, 3)),
           "fm_second_order": ("fm_second_order_bwd", fm_bwd_cost(40, 5, 15)),
           "fused_lookup_pool": ("fused_lookup_pool_bwd", pool_bwd_cost(24, 6, 8, 200)),
           "fused_transformer_block": ("fused_transformer_block_bwd",
                                       block_bwd_cost(6, 10, 16, 24))}[name]
    cost = step_cost(lambda: call().sum().backward())
    assert cost["kernels"] == {name: {"calls": 1, "flops": want.flops, "bytes": want.bytes},
                               bwd[0]: {"calls": 1, "flops": bwd[1].flops,
                                        "bytes": bwd[1].bytes}}
    assert set(cost["ops"]) <= {"sum", "ones_like", "expand", "clone", "detach"}


def test_wrappers_count_nothing_with_no_counter_open():
    calls = []
    for case in KERNEL_CASES.values():
        name, call, _ = case()
        call()
        calls.append(name)
    assert ops.open_counter() is None and not ops.hidden()
    assert len(calls) == len(KERNEL_CASES)


def test_a_failed_count_raises_and_closes_the_counter():
    def broken():
        torch.ones(3) @ torch.ones(4)

    with pytest.raises(RuntimeError):
        step_cost(broken)
    assert ops.open_counter() is None
    ops.set_counter(object())
    try:
        with pytest.raises(RuntimeError, match="already open"):
            step_cost(lambda: None)
    finally:
        ops.set_counter(None)


# -- a narrow DCN step -------------------------------------------------------------

NARROW_HIDDEN = (16, 1)
NARROW_NL = 2


def narrow_dcn():
    """(cfg, model, state, step, batch): a DCN of two MLP layers and NL 2 whose
    user and item tables (50,000 ids each, D 8) pack into an arena of
    ~100,000 x 8, at batch 64: 128 slots, far under an eighth of the arena's
    rows (the sorted route). One warm step taken."""
    cfg = train_cfg(True)
    raw_sizes = cfg.embeddings.embedding_table_size
    raw_sizes.update(user_id=50000, item_id=50000)
    cfg.embeddings.embedding_size.update(user_id=8, item_id=8)
    model = DCNRanker(tables=table_specs(cfg), schema=build_schema(cfg), cross_layers=NARROW_NL,
                      hidden=NARROW_HIDDEN, generator=torch.Generator().manual_seed(0))
    state = tss.init_sparse_state(model, cfg)
    step = tss.make_sparse_train_step(model, cfg)
    packer = BatchPacker(train_dataset(cfg, 256, seed=3))
    batches = [unpack_batch(torch.from_numpy(packer.int_mat[rows]),
                            torch.from_numpy(packer.float_mat[rows]), torch.ones(64),
                            packer.layout_key()) for rows in (np.arange(64), np.arange(64, 128))]
    step(state, batches[0], AucHist.zeros("cpu"))
    return cfg, model, state, step, batches[1]


class OperandSum(TorchDispatchMode):
    """The naive count: every op's tensor operands and outputs, whole."""

    def __init__(self):
        super().__init__()
        self.bytes, self.names = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.names.append(func._overloadpacket.__name__)
        self.bytes += sum(t.numel() * t.element_size() for t in
                          roofline._tensors((args, kwargs, out)))
        return out


def mlp_hand_count(B: int, dims) -> dict:
    """The tower's matmuls by hand, ``{op: (calls, bytes)}``: a forward
    ``addmm`` a layer (bias, input and weight read, output written) and two
    backward ``mm``s (the input's gradient and the weight's: the three
    operands of each), every layer's input needing its gradient."""
    layers = list(zip(dims, dims[1:]))
    return {"addmm": (len(layers), sum(4 * (o + B * i + i * o + B * o) for i, o in layers)),
            "mm": (2 * len(layers), sum(2 * 4 * (B * o + i * o + B * i) for i, o in layers))}


def adamw_hand_count(opt) -> dict:
    """torch's AdamW (its for-loop form, the CPU's) by hand, ``{op: (calls,
    bytes)}``: for a parameter of P bytes, the step count's ``add_`` (a 0-d
    float32 read and written) and the eps ``add_`` (2P), the decay's and the
    second moment's ``mul_`` (2P each), ``lerp_`` and ``addcmul_`` (3P each),
    ``sqrt`` and ``div`` (2P each) and ``addcdiv_`` (4P)."""
    sizes = [4 * p.numel() for g in opt.param_groups for p in g["params"]]
    n, P = len(sizes), sum(sizes)
    return {"add_": (2 * n, 8 * n + 2 * P), "mul_": (2 * n, 4 * P), "lerp_": (n, 3 * P),
            "addcmul_": (n, 3 * P), "sqrt": (n, 2 * P), "div": (n, 2 * P),
            "addcdiv_": (n, 4 * P)}


def auc_hand_count(B: int) -> dict:
    """The AUC histogram's two ``index_add_``s: int32 bins and float32 values
    of B slots read, B bins read and written."""
    return {"index_add_": (2, 2 * (4 * B + 4 * B + 2 * 4 * B))}


def check_hand_count(cost: dict, hand: dict, kernels: dict, bound: int) -> None:
    """Each op the hand count names moves what it says in the calls it
    counts (all of that op's calls, where it counts them all: then exactly);
    each other call moves at most ``bound`` bytes; the kernels count their
    cost functions, and the bytes sum to the total."""
    assert set(hand) <= set(cost["ops"])
    for name, tally in cost["ops"].items():
        calls, nbytes = hand.get(name, (0, 0))
        rest_calls, rest = tally["calls"] - calls, tally["bytes"] - nbytes
        assert rest_calls >= 0 and 0 <= rest <= rest_calls * bound, (name, tally, hand.get(name))
    assert cost["kernels"] == {k: {"calls": 1, "flops": c.flops, "bytes": c.bytes}
                               for k, c in kernels.items()}
    assert cost["bytes"] == (sum(t["bytes"] for t in cost["ops"].values())
                             + sum(c.bytes for c in kernels.values()))


def test_narrow_dcn_step_counts_the_hand_count():
    """FLOPs: the tower's matmuls and the cross stack's formulas. Bytes, op by
    op: the three fields' gathers, the category table's dense gradient, the
    rowwise update's sort-dedup of the S = 2B arena slots (its segment sum
    is an ``embedding_dense_backward`` of S rows; it gathers the summed
    gradients, the accumulator's and the arena's rows, and writes the
    accumulator's), the tower's matmuls, AdamW over the dense parameters,
    the AUC histogram, and the kernels; every other op a call within three
    of the tower's (B, 2 * dim) inputs."""
    cfg, model, state, step, batch = narrow_dcn()
    arena = model.embedder.tables["arena_d8"]
    V, D = arena.shape
    Vc, Dc = model.embedder.tables["category"].shape
    assert V >= 100000 and 2 * 64 < V * tss.DENSE_UPDATE_MIN_SHARE
    cost = step_cost(step, copy.deepcopy(state), batch, AucHist.zeros("cpu"))
    B, S, dim = 64, 2 * 64, model.schema.total_dim
    dims = (2 * dim, *NARROW_HIDDEN)
    mlp = 2 * B * sum(i * o for i, o in zip(dims, dims[1:]))
    cross, cross_bwd = cross_cost(B, dim, NARROW_NL, True), cross_bwd_cost(B, dim, NARROW_NL)
    # forward, and the backward's two products a layer (the MLP's input, the
    # gathered rows and the cross stack's output, needs its gradient)
    assert cost["flops"] == 3 * mlp + cross.flops + cross_bwd.flops
    assert cost["flops_by_units"] == {"float32": cost["flops"]}

    specs = {sp.name: sp for sp in model.schema.specs}
    slots = torch.cat([offset_ids(specs[f], batch[f]) for f in ("user_id", "item_id")])
    hand = {"embedding": (3, 3 * (8 * B + 2 * 4 * B * D)),
            "embedding_dense_backward": (2, (4 * B * Dc + 8 * B + 4 * Vc * Dc)
                                         + (4 * S * D + 8 * S + 4 * S * D)),
            "index": (4, 3 * (8 * S + 2 * 4 * S * D) + (8 * S + 2 * 4 * S)),
            "index_put_": (1, 8 * S + 4 * S + 2 * 4 * S),
            **mlp_hand_count(B, dims), **adamw_hand_count(state.dense_opt), **auc_hand_count(B)}
    kernels = {"dcn_cross_stack": cross, "dcn_cross_bwd": cross_bwd,
               "scatter_rows_set": scatter_cost(S, D, int(torch.unique(slots).numel()))}
    check_hand_count(cost, hand, kernels, bound=3 * 4 * B * 2 * dim)
    # the arena's rows moved, not the arena: under one pass over it, where
    # summing every op's operands counts it whole
    naive = OperandSum()
    with naive:
        step(copy.deepcopy(state), batch, AucHist.zeros("cpu"))
    assert cost["bytes"] < 4 * V * D < naive.bytes


def test_narrow_dense_step_counts_the_hand_count():
    """The all-dense AdamW step of a narrow DCN with a pooled click history
    (``train_cfg(False)``: user 16 wide, item and category 8, ``hist`` of 5
    pooled over the item table): FLOPs, the tower's matmuls and the kernels'
    formulas; bytes, op by op: the three fields' gathers and their tables'
    dense gradients, the item table's two gradients summed (its own and the
    pool backward's), the tower, AdamW over every parameter, the tables
    whole, the AUC histogram and the kernels; every other op a call within
    three of the tower's widest (B, 128) activations."""
    cfg = train_cfg(False, embedding_optimizer="adamw")
    model = build_ranker(cfg, seed=0, device="cpu")
    state, step = init_dense_state(model, cfg), make_train_step(model, cfg)
    packer = BatchPacker(train_dataset(cfg, 256, seed=3))
    warm, batch = (unpack_batch(torch.from_numpy(packer.int_mat[rows]),
                                torch.from_numpy(packer.float_mat[rows]), torch.ones(64),
                                packer.layout_key()) for rows in (np.arange(64), np.arange(64, 128)))
    step(state, warm, AucHist.zeros("cpu"))
    cost = step_cost(step, copy.deepcopy(state), batch, AucHist.zeros("cpu"))

    B, L, NL = 64, 5, model.cross.ws.shape[0]
    tables = {f: model.embedder.tables[f].shape for f in ("user_id", "item_id", "category")}
    dim = model.schema.total_dim
    dims = (2 * dim, *(layer.out_features for layer in model.tower.layers))
    Vi, Di = tables["item_id"]
    hist = batch["hist"]
    kernels = {"dcn_cross_stack": cross_cost(B, dim, NL, True),
               "dcn_cross_bwd": cross_bwd_cost(B, dim, NL),
               "fused_lookup_pool": pool_cost(B, L, Di, pooled_rows(hist, (hist != 0).float())),
               "fused_lookup_pool_bwd": pool_bwd_cost(B, L, Di, Vi)}
    mlp = 2 * B * sum(i * o for i, o in zip(dims, dims[1:]))
    assert cost["flops"] == 3 * mlp + sum(k.flops for k in kernels.values())
    hand = {"embedding": (3, sum(8 * B + 2 * 4 * B * D for _, D in tables.values())),
            "embedding_dense_backward": (3, sum(4 * B * D + 8 * B + 4 * V * D
                                                for V, D in tables.values())),
            "add": (1, 3 * 4 * Vi * Di),
            **mlp_hand_count(B, dims), **adamw_hand_count(state.opt), **auc_hand_count(B)}
    check_hand_count(cost, hand, kernels, bound=3 * 4 * B * max(dims[1:]))


def test_narrow_dcn_step_counts_the_same_twice_and_two_steps_twice():
    _, _, state, step, batch = narrow_dcn()
    one = step_cost(step, copy.deepcopy(state), batch, AucHist.zeros("cpu"))
    assert step_cost(step, copy.deepcopy(state), batch, AucHist.zeros("cpu")) == one
    s, hist = copy.deepcopy(state), AucHist.zeros("cpu")

    def two_steps():
        step(s, batch, hist)
        step(s, batch, hist)

    two = step_cost(two_steps)
    assert (two["flops"], two["bytes"]) == (2 * one["flops"], 2 * one["bytes"])


def test_xla_counts_a_scan_body_once():
    """The reference's ``bench.py`` divides XLA's count of a 16-step scan of
    the step by 16; XLA counts a loop's body once, whatever its length, so
    that gives 1/16 of a step. The port counts each step it runs."""
    def scanned(n):
        def f(c, w):
            return jax.lax.scan(lambda c, _: (jnp.tanh(c @ w), None), c, None, length=n)[0]
        return compiled_cost(jax.jit(f), jnp.ones((64, 64)), jnp.ones((64, 64)))

    assert scanned(2) == scanned(8)
    c, w = torch.ones(64, 64), torch.ones(64, 64)

    def steps(n):
        for _ in range(n):
            c2 = torch.tanh(c @ w)
        return c2

    assert step_cost(steps, 2)["flops"] == 2 * step_cost(steps, 1)["flops"] == 4 * 64 ** 3


def test_with_no_counter_a_step_runs_its_own_ops():
    """A step outside ``step_cost`` runs the same aten ops before and after a
    count, no kernel scope is left open, and the plain route launches
    nothing; the CPU's pool and block take their plain versions' autograd
    (no kernel Function) with no counter open."""
    _, _, state, step, batch = narrow_dcn()
    launches = {f: f.launches for f in (dcn_cross_stack, dcn_cross_bwd, scatter_rows_set)}

    def op_names():
        mode = OperandSum()
        with mode:
            step(copy.deepcopy(state), batch, AucHist.zeros("cpu"))
        return mode.names

    before = op_names()
    step_cost(step, copy.deepcopy(state), batch, AucHist.zeros("cpu"))
    assert op_names() == before
    assert {f: f.launches for f in launches} == launches
    assert ops.open_counter() is None and not ops.hidden()
    x, mask, params, _ = block_inputs(6, 10, 16, 24)
    params = [torch.from_numpy(p).requires_grad_() for p in params]
    y = fused_transformer_block(params, torch.from_numpy(x), torch.from_numpy(mask), 2)
    assert "FusedBlock" not in type(y.grad_fn).__name__
    table, ids, pmask = pool_inputs(200, 8, 24, 6)
    pooled = fused_lookup_pool(torch.from_numpy(table).requires_grad_(), torch.from_numpy(ids),
                               torch.from_numpy(pmask))
    assert "Pool" not in type(pooled.grad_fn).__name__
