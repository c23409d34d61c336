"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs a CUDA GPU and skips without one. This file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the kernels sum in another order than PyTorch's ops; the
pooled mean of float32 rows holds to rtol = atol = 1e-5, the cross stack,
whose values grow over the layers, to rtol 1e-5 and atol 1e-4. Its
backward sums the batch's terms (up to ~500 each at these inputs, cancelling
to order 1 in places) in per-block partials, so it holds to rtol 1e-5 and an
atol of 1e-5 of the largest gradient. The row scatter moves bits and is
held to equality. The FM second order and its backward sum F products per
column (and D columns) in another order than PyTorch: rtol 1e-5 and an atol
of 1e-5 of the largest value. Training on the card against the CPU: rtol 1e-5, atol 5e-5
after 4 steps (cuBLAS and the CPU sum the matmuls in other orders, and Adam
divides each step by ``|g| + 1e-8``, which amplifies those differences in
weights whose gradient cancels near 1e-8). A checkpoint moves between the
card and the CPU with every tensor's bits; a state restored on the card and
trained on is held to the CPU's continuation with the same TRAIN_TOL.
"""

import copy
import json

import numpy as np
import pytest
import torch

from news_recsys_tpu_torch.config import config_from_dict
from news_recsys_tpu_torch.data.packed_dataset import BatchPacker, PackedDataset, unpack_batch
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.ops.dcn_kernel import (_cross_fwd_kernel, cross_bwd_rebuild_plain,
                                                  cross_fwd_plain, cross_plain, dcn_cross_bwd,
                                                  dcn_cross_stack)
from news_recsys_tpu_torch.ops.fm_kernel import (fm_bwd_plain, fm_plain, fm_second_order,
                                                 fm_second_order_bwd, plan_fm_bwd, plan_fm_fwd)
from news_recsys_tpu_torch.ops.fused_attention import (PARAM_NAMES, _general_ws_floats,
                                                       block_bwd_plain, block_plain,
                                                       fused_transformer_block,
                                                       fused_transformer_block_bwd,
                                                       layer_norm_plain, mhsa_plain,
                                                       param_floats, plan_shape)
from news_recsys_tpu_torch.ops.fused_lookup_pool import (fused_lookup_pool,
                                                         fused_lookup_pool_bwd, pool_bwd_plain,
                                                         reference_lookup_pool)
from news_recsys_tpu_torch.ops.scatter_rows import scatter_rows_plain, scatter_rows_set
from news_recsys_tpu_torch.training.checkpoint import load_state, state_dict
from news_recsys_tpu_torch.training.sparse_step import init_sparse_state, make_sparse_train_step
from news_recsys_tpu_torch.training.trainer import AucHist, Trainer

POOL_TOL = dict(rtol=1e-5, atol=1e-5)
DCN_TOL = dict(rtol=1e-5, atol=1e-4)
TRAIN_TOL = dict(rtol=1e-5, atol=5e-5)


def cross_inputs(B, D, NL, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((B, D)).astype(np.float32)
    ws = rng.uniform(-0.2, 0.2, (NL, D)).astype(np.float32)
    bs = rng.standard_normal((NL, D)).astype(np.float32) * 0.1
    return x0, ws, bs


def pool_inputs(V, D, B, L, seed=0):
    """Ragged masks, padding id 0, one all-zero mask row, one all-padding row."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    table[0] = 0.0
    ids = rng.integers(0, V, (B, L)).astype(np.int32)
    lengths = rng.integers(0, L + 1, B)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    ids[mask == 0] = 0
    ids[1] = 0
    mask[2] = 0.0
    return table, ids, mask


def scatter_inputs(V, D, S, seed=0):
    """A table and S sorted rows with duplicates, equal rows carrying equal
    values (the scatter's contract)."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    rows = np.sort(rng.integers(0, V, S)).astype(np.int32)
    if S > 7:
        rows[7] = rows[6]
    vals = rng.standard_normal((S, D)).astype(np.float32)
    return table, rows, vals[np.searchsorted(rows, rows)]


def train_cfg(arena: bool, batch_size: int = 64, mesh=None, **train):
    """A narrow DCN whose user and item tables (5,000 and 4,500 ids) are
    large enough for the rowwise path; ``category`` stays on AdamW. With
    ``arena`` the two pack into one ``arena_d16`` table; without, they are
    two tables of different widths (the joint dedup) and a click history
    ``hist`` of 5 is pooled over the item table. The lr is the MIND
    recipe's 1e-3: Adam's first step divides by ``|g| + 1e-8``, so a
    parameter whose gradient cancels to ~1e-8 moves by up to ``lr`` on a
    1e-3 relative change of that gradient; at lr 1e-2 such a parameter
    differed from the JAX package's by more than 1e-5."""
    feats = ["user_id", "item_id", "category"]
    raw = {
        "name": "dcn",
        "features": {"sparse_feature_names": feats,
                     "item_feature_names": ["item_id", "category"],
                     "user_feature_names": ["user_id"]},
        "embeddings": {"embedding_size": {"user_id": 16, "item_id": 16 if arena else 8,
                                          "category": 8},
                       "embedding_table_size": {"user_id": 5000, "item_id": 4500,
                                                "category": 10},
                       "arena_tables": arena},
        "dataset": {"batch_size": batch_size},
        "mesh": mesh or {},
        "train_hparams": {"lr": 1e-3, "min_lr": 1e-4, "lr_milestones": [2, 6],
                          "max_step": 10000, "max_epoch": 2,
                          "embedding_optimizer": "rowwise_adagrad", **train},
        "dcn_cfg": {"num_layers": 2},
    }
    if not arena:
        raw["features"].update(array_feature_names=["hist"], array_max_length={"hist": 5},
                               user_feature_names=["user_id", "hist"])
        raw["embeddings"]["share_emb_table_features"] = {"hist": "item_id"}
    return config_from_dict(raw)


def zoo_train_cfg(name: str, arena: bool = True, batch_size: int = 64, **train):
    """A narrow config for a ranker of the zoo (``lr``, ``deep``,
    ``widedeep``, ``fm``, ``deepfm``, ``dcn``, ``dcn@v2``): large user and
    item tables (5,000 and 4,500 ids, rowwise AdaGrad), small ``category``
    and ``subcategory`` tables (AdamW). Dims 1 for LR and 8 for FM and
    DeepFM everywhere (equal dims); otherwise 16 for the large tables (8 for
    the item table without ``arena``) and 8 for the small ones, with 9 for
    Wide&Deep's wide ``category`` and ``subcategory`` (column 0 wide). As in
    :func:`train_cfg`, ``arena`` packs the large tables into one and its
    absence adds a click history ``hist`` of 5 pooled over the item table.
    The shallow models take the scoreboard's ``init_scale`` 0.03."""
    model = name.split("@")[0]
    shallow = model in ("lr", "fm", "deepfm")
    big, small = {"lr": (1, 1), "fm": (8, 8), "deepfm": (8, 8)}.get(model, (16, 8))
    wide = small + 1 if model == "widedeep" else small
    feats = ["user_id", "item_id", "category", "subcategory"]
    raw = {
        "name": model,
        "features": {"sparse_feature_names": feats,
                     "item_feature_names": ["item_id", "category", "subcategory"],
                     "user_feature_names": ["user_id"]},
        "embeddings": {"embedding_size": {"user_id": big,
                                          "item_id": big if arena or shallow else big // 2,
                                          "category": wide, "subcategory": wide},
                       "embedding_table_size": {"user_id": 5000, "item_id": 4500,
                                                "category": 10, "subcategory": 30},
                       "arena_tables": arena, "init_scale": 0.03 if shallow else 1.0},
        "dataset": {"batch_size": batch_size},
        "train_hparams": {"lr": 1e-3, "min_lr": 1e-4, "lr_milestones": [2, 6],
                          "max_step": 10000, "max_epoch": 2,
                          "embedding_optimizer": "rowwise_adagrad", **train},
        "wide_and_deep_cfg": {"wide_feature_names": ["category", "subcategory"]},
        "dcn_cfg": {"num_layers": 2, "version": 2 if name == "dcn@v2" else 1},
    }
    if not arena:
        raw["features"].update(array_feature_names=["hist"], array_max_length={"hist": 5},
                               user_feature_names=["user_id", "hist"])
        raw["embeddings"]["share_emb_table_features"] = {"hist": "item_id"}
    return config_from_dict(raw)


def fm_inputs(B, F, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, F, D)).astype(np.float32),
            rng.standard_normal(B).astype(np.float32))


def train_dataset(cfg, n: int, seed: int) -> PackedDataset:
    rng = np.random.default_rng(seed)
    sizes = cfg.embeddings.embedding_table_size
    arrays = {f: rng.integers(1, sizes[f], n).astype(np.int32)
              for f in cfg.features.sparse_feature_names}
    if "hist" in cfg.features.array_feature_names:
        hist = rng.integers(1, sizes["item_id"], (n, 5)).astype(np.int32)
        hist[np.arange(5)[None, :] >= rng.integers(0, 6, n)[:, None]] = 0
        arrays["hist"] = hist
    arrays["label"] = (rng.random(n) < 0.3).astype(np.float32).reshape(-1, 1)
    return PackedDataset(arrays)


def assert_close_to_scale(got, want, name=""):
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * max(1.0, float(want.abs().max())), msg=name)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def profiler_ready():
    """Sets up ``torch.profiler`` on the card before a test reads a trace.

    A process's first profiler session must be short. On an H100 (torch
    2.11, CUPTI 26; ``scripts/profiler_probe_torch.py``), after a first
    session of 15-22 s (the kernel library built inside it by ``nvcc``, as
    when the FM plan tests ran first in a process without a build) every
    later session of the process lost its kernel: Kineto counted the record
    outside the session's window ("Out-of-range" in its record counts) and
    the trace held none. With the build before the first session, no later
    session lost its kernel. So the library is built and loaded here,
    outside any session, and one short session traces one small kernel,
    paying the profiler's start-up where no trace is read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from news_recsys_tpu_torch.ops import _build

    _build.library()
    x = torch.zeros(1, device="cuda")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        x.add_(1)
        torch.cuda.synchronize()


def on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


def off_by_one_float(dev, a):
    """``a`` on ``dev`` as a contiguous view one float into its storage, so
    not 16-byte aligned: the cross stack's kernels take their scalar path."""
    base = torch.zeros(a.size + 1, dtype=torch.float32, device=dev)
    t = base[1:].view(a.shape)
    t.copy_(torch.from_numpy(a))
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    return t


# the cross stack's kernels: the ranker's shapes (a request's B 6,400, a
# step's B 512, a large-batch step's 8,192), one row, one past a warp's rows
# or a block's, D off the float4 grid, the widest D with 6 layers, and tiny rows
CROSS_SHAPES = [(6400, 112, 3), (512, 112, 3), (1000, 24, 2), (37, 200, 4), (5, 1, 1),
                (1, 112, 3), (513, 112, 3), (6401, 113, 3), (512, 256, 6), (7, 3, 1),
                (300, 24, 12), (8192, 112, 3)]


def cross_case(dev, B, D, NL, aligned, seed=0):
    """(x0, ws, bs, g) on ``dev``; x0 and g one float off alignment unless ``aligned``."""
    x0, ws, bs = cross_inputs(B, D, NL, seed)
    g = np.random.default_rng(seed + 1).standard_normal((B, D)).astype(np.float32)
    place = (lambda a: torch.from_numpy(a).to(dev)) if aligned else \
        (lambda a: off_by_one_float(dev, a))
    return place(x0), *on(dev, ws, bs), place(g)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "off-by-one-float"])
@pytest.mark.parametrize("B,D,NL", CROSS_SHAPES)
def test_dcn_kernel_matches_plain(cuda, B, D, NL, aligned):
    """The serving forward and the training one, which also writes ss."""
    x0, ws, bs, _ = cross_case(cuda, B, D, NL, aligned)
    with torch.inference_mode():
        n = dcn_cross_stack.launches
        got = dcn_cross_stack(x0, ws, bs)
        assert dcn_cross_stack.launches == n + 1
        torch.testing.assert_close(got, cross_plain(x0, ws, bs), **DCN_TOL)
        out, ss = _cross_fwd_kernel(x0, ws, bs, residuals=True)
        want_out, _, want_ss = cross_fwd_plain(x0, ws, bs)
        torch.testing.assert_close(out, want_out, **DCN_TOL)
        torch.testing.assert_close(ss, want_ss, **DCN_TOL)
        assert torch.equal(out, got)


@pytest.mark.cuda
@pytest.mark.parametrize("V,D,B,L", [(65280, 16, 1024, 30), (500, 40, 33, 7),
                                     (300, 128, 16, 50), (50, 3, 9, 4), (80, 256, 8, 2)])
def test_pool_kernel_matches_plain(cuda, V, D, B, L):
    table, ids, mask = on(cuda, *pool_inputs(V, D, B, L))
    with torch.inference_mode():
        n = fused_lookup_pool.launches
        got = fused_lookup_pool(table, ids, mask)
        assert fused_lookup_pool.launches == n + 1
        torch.testing.assert_close(got, reference_lookup_pool(table, ids, mask), **POOL_TOL)
        assert (got[1] == 0).all() and (got[2] == 0).all()


@pytest.mark.cuda
def test_pool_kernel_ids_out_of_range_give_nan(cuda):
    table, ids, mask = pool_inputs(50, 8, 8, 4)
    ids[3, 1], mask[3, 1] = 50, 1.0
    ids[5, 2], mask[5, 2] = 1000, 0.0
    ids[6, 0], mask[6, 0] = -2, 1.0
    args = on(cuda, table, ids, mask)
    with torch.inference_mode():
        got = fused_lookup_pool(*args).cpu()
    want = reference_lookup_pool(*map(torch.from_numpy, (table, ids, mask)))
    assert got[[3, 5, 6]].isnan().all()
    torch.testing.assert_close(got, want, equal_nan=True, **POOL_TOL)


@pytest.mark.cuda
def test_kernels_refuse_grad(cuda):
    """The scatter writes in place and has no backward: on CUDA it refuses
    inputs that need a gradient while autograd is on. (The cross stack, the
    FM second order, the pool and the fused block train.)"""
    table = torch.zeros(10, 4, device=cuda, requires_grad=True)
    rows = torch.tensor([1, 2], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="forward only"):
        scatter_rows_set(table, rows, torch.ones(2, 4, device=cuda))
    with torch.no_grad():
        scatter_rows_set(table, rows, torch.ones(2, 4, device=cuda))
    assert (table[1:3] == 1).all() and (table[0] == 0).all()


@pytest.mark.cuda
def test_kernels_reject_mixed_devices(cuda):
    with pytest.raises(ValueError, match="different devices"):
        dcn_cross_stack(torch.zeros(4, 8, device=cuda), torch.zeros(2, 8), torch.zeros(2, 8))


@pytest.mark.cuda
def test_dcn_ranker_on_cuda_matches_cpu(cuda):
    cfg = config_from_dict({
        "name": "dcn",
        "features": {"sparse_feature_names": ["user_id", "item_id", "category"],
                     "item_feature_names": ["item_id", "category"],
                     "user_feature_names": ["user_id"]},
        "embeddings": {"embedding_size": {"user_id": 16, "item_id": 16, "category": 16},
                       "embedding_table_size": {"user_id": 64, "item_id": 128,
                                                "category": 8}},
        "dcn_cfg": {"num_layers": 2},
    })
    rng = np.random.default_rng(0)
    batch = {"user_id": rng.integers(1, 64, 256), "item_id": rng.integers(1, 128, 256),
             "category": rng.integers(1, 8, 256)}
    cpu_model = build_ranker(cfg, seed=3, device="cpu")
    gpu_model = build_ranker(cfg, seed=3, device=cuda)
    with torch.inference_mode():
        want = cpu_model({k: torch.from_numpy(v.astype(np.int32)) for k, v in batch.items()})
        n = dcn_cross_stack.launches
        got = gpu_model({k: torch.from_numpy(v.astype(np.int32)).to(cuda)
                         for k, v in batch.items()})
        assert dcn_cross_stack.launches == n + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("V,D,S", [(159360, 32, 1024), (5000, 16, 300), (700, 24, 100),
                                   (500, 18, 64), (100, 5, 0)])
def test_scatter_kernel_matches_plain(cuda, V, D, S):
    """D = 32, 16 and 24 take the float4 path, D = 18 and 5 one float a
    thread; every untouched row stays bit-identical."""
    table, rows, vals = scatter_inputs(V, D, S)
    got = torch.from_numpy(table).to(cuda)
    n = scatter_rows_set.launches
    assert scatter_rows_set(got, *on(cuda, rows, vals)) is got
    assert scatter_rows_set.launches == n + (S > 0)
    want = scatter_rows_plain(torch.from_numpy(table.copy()), *map(torch.from_numpy, (rows, vals)))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_scatter_kernel_drops_out_of_range_rows(cuda):
    table, rows, vals = scatter_inputs(300, 16, 40)
    rows[:2] = -5
    rows[-3:] = (300, 300, 2 ** 30)
    got = torch.from_numpy(table).to(cuda)
    scatter_rows_set(got, *on(cuda, rows, vals))
    want = scatter_rows_plain(torch.from_numpy(table.copy()), *map(torch.from_numpy, (rows, vals)))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_scatter_kernel_unaligned_table(cuda):
    """A table view 4 bytes off a 16-byte boundary takes the float path."""
    table, rows, vals = scatter_inputs(400, 32, 50)
    base = torch.zeros(400 * 32 + 1, device=cuda)
    got = base[1:].view(400, 32)
    got.copy_(torch.from_numpy(table))
    scatter_rows_set(got, *on(cuda, rows, vals))
    want = scatter_rows_plain(torch.from_numpy(table.copy()), *map(torch.from_numpy, (rows, vals)))
    assert torch.equal(got.cpu(), want)


def scatter_on_card(dev, table, rows, vals, aligned=True):
    """The kernel's table and the plain version's (on the CPU) from the same
    start; with ``aligned`` False the table and vals lie one float off a
    16-byte boundary, so the kernel takes its scalar path."""
    if aligned:
        got, r, v = on(dev, table, rows, vals)
    else:
        got, v, (r,) = off_by_one_float(dev, table), off_by_one_float(dev, vals), on(dev, rows)
    n = scatter_rows_set.launches
    assert scatter_rows_set(got, r, v) is got
    assert scatter_rows_set.launches == n + 1
    want = scatter_rows_plain(torch.from_numpy(table.copy()), *map(torch.from_numpy, (rows, vals)))
    return got.cpu(), want


def runs_of(V, D, S, run, seed=0):
    """S sorted slots over V rows in runs of ``run`` equal rows (the last
    run shorter), equal rows carrying equal values."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    n = -(-S // run)
    rows = np.repeat(np.sort(rng.choice(V, n, replace=False)), run)[:S].astype(np.int32)
    vals = rng.standard_normal((S, D)).astype(np.float32)
    return table, rows, vals[np.searchsorted(rows, rows)]


@pytest.mark.cuda
def test_scatter_kernel_one_run_of_15872_slots(cuda):
    """The sparse attention step's user table: 15,872 slots at row 0, then
    512 rows of their own; one write for the run."""
    table, rows, vals = runs_of(94080, 32, 512, 1, seed=5)
    rows = np.concatenate([np.zeros(15872, np.int32), np.sort(rows % 94079 + 1)])
    vals = np.concatenate([np.repeat(vals[:1], 15872, axis=0), vals])
    vals = vals[np.searchsorted(rows, rows)]
    got, want = scatter_on_card(cuda, table, rows, vals)
    assert torch.equal(got, want)
    assert torch.equal(got[0], torch.from_numpy(vals[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "off-by-one-float"])
@pytest.mark.parametrize("S,run", [(1024, 2), (1024, 7), (1024, 8), (1024, 9), (1024, 33),
                                   (16384, 31), (16384, 32), (16384, 33), (16384, 1000),
                                   (16384, 16384)])
def test_scatter_kernel_runs_across_blocks(cuda, S, run, aligned):
    """Runs that cross the blocks' edges (256 threads: 32 slots a block at D
    32, a float4 a thread; 8 slots a block a float a thread off the float4
    grid), the last run cut short."""
    table, rows, vals = runs_of(max(2 * S // run, 64), 32, S, run, seed=run)
    got, want = scatter_on_card(cuda, table, rows, vals, aligned)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 18])
def test_scatter_kernel_run_of_one_at_the_last_slot(cuda, D):
    table, rows, vals = runs_of(5000, D, 1023, 3, seed=6)
    rows = np.append(rows, 4999).astype(np.int32)
    vals = np.concatenate([vals, np.full((1, D), 7.0, np.float32)])
    got, want = scatter_on_card(cuda, table, rows, vals)
    assert torch.equal(got, want)
    assert torch.equal(got[4999], torch.full((D,), 7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "off-by-one-float"])
def test_scatter_kernel_drops_runs_out_of_range(cuda, aligned):
    """Runs of rows below 0 and at or past V at both ends, the first and
    last crossing a block's edge, next to in-range runs of the same length."""
    V = 3000
    table, rows, vals = runs_of(V - 1, 32, 2048, 40, seed=7)
    rows[:100] = -5
    rows[100:140] = -1
    rows[-140:-100] = V
    rows[-100:] = 2 ** 30
    rows.sort()
    vals = vals[np.searchsorted(rows, rows)]
    table = np.concatenate([table, table[:1]])
    got, want = scatter_on_card(cuda, table, rows, vals, aligned)
    assert torch.equal(got, want)
    assert torch.equal(got[V - 1], torch.from_numpy(table[V - 1]))


@pytest.mark.cuda
def test_scatter_kernel_on_the_attention_steps_layout(cuda):
    """Both tables of the sparse attention step (``attention_config()``,
    batch 512): all 16,384 slots of one seeded batch through the port's own
    ``_joint_dedup``, as ``chip_smoke.py`` times them."""
    from news_recsys_tpu_torch.training.scatter_layouts import attention_scatter_layouts
    from news_recsys_tpu_torch.zoo import attention_arrays, attention_config
    layouts = attention_scatter_layouts(attention_config(batch_size=512),
                                        attention_arrays(512, seed=3), 3)
    assert sorted(layouts) == ["item_id", "user_id"]
    for table, rows, vals in layouts.values():
        assert rows.shape == (16384,)
        got, want = scatter_on_card(cuda, table, rows, vals)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "off-by-one-float"])
def test_scatter_kernel_off_contract_last_slot_wins(cuda, aligned):
    """Duplicates with different values: the last slot of each run is what
    the table keeps, as the Pallas grid's order has it, on every run."""
    table, rows, vals = runs_of(4000, 32, 4096, 5, seed=8)
    vals = np.random.default_rng(9).standard_normal(vals.shape).astype(np.float32)
    first = None
    for _ in range(3):
        got, want = scatter_on_card(cuda, table, rows, vals, aligned)
        assert torch.equal(got, want)
        assert first is None or torch.equal(got, first)
        first = got
    last = np.flatnonzero(np.append(rows[1:] != rows[:-1], True))
    assert torch.equal(got[rows[last]], torch.from_numpy(vals[last]))


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "off-by-one-float"])
def test_scatter_kernel_past_2_to_the_31_floats(cuda, aligned):
    """S * D past 2**31 (8 GiB of values; a float a thread off the float4
    grid, so past 2**31 threads too): every touched row, the last slots'
    among them, holds its value, and the others are untouched."""
    V, D, S = 4096, 32, 2 ** 26 + 5
    gen = torch.Generator(device=cuda).manual_seed(11)
    table = torch.randn(V, D, device=cuda, generator=gen)
    source = torch.randn(V, D, device=cuda, generator=gen)
    rows = torch.randint(0, V - 1, (S,), device=cuda, generator=gen, dtype=torch.int32)
    rows = rows.sort().values
    rows[-1] = V - 1
    base = torch.empty(S * D + (0 if aligned else 1), device=cuda)
    vals = base[base.numel() - S * D:].view(S, D)
    torch.index_select(source, 0, rows.long(), out=vals)
    assert (vals.data_ptr() % 16 == 0) == aligned
    want = table.clone()
    touched = rows.long().unique()
    want[touched] = source[touched]
    got = scatter_rows_set(table, rows, vals)
    del base, vals
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "off-by-one-float"])
@pytest.mark.parametrize("B,D,NL", CROSS_SHAPES)
def test_dcn_bwd_kernel_matches_plain(cuda, B, D, NL, aligned):
    x0, ws, bs, g = cross_case(cuda, B, D, NL, aligned)
    _, ss = _cross_fwd_kernel(x0, ws, bs, residuals=True)      # the forward kernel's ss
    n = dcn_cross_bwd.launches
    got = dcn_cross_bwd(x0, ws, bs, ss, g)
    assert dcn_cross_bwd.launches == n + 1
    for name, a, b in zip(("dx0", "dws", "dbs"), got, cross_bwd_rebuild_plain(x0, ws, bs, ss, g)):
        assert_close_to_scale(a, b, name)


@pytest.mark.cuda
def test_dcn_bwd_graphs_on_one_capture_stream_run_at_once(cuda):
    """Every graph ``torch.cuda.graph`` captures without a stream is captured
    on one class-wide stream; two such graphs replayed at once on two
    streams give the answers a call alone gives, replay after replay (each
    call's partials are its own)."""
    cases = [cross_case(cuda, B, 112, 3, True, seed=B) for B in (512, 6400)]
    args = [(x0, ws, bs, cross_fwd_plain(x0, ws, bs)[2], g) for x0, ws, bs, g in cases]
    want = [dcn_cross_bwd(*a) for a in args]
    graphs, outs = [torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()], []
    for graph, a in zip(graphs, args):
        with torch.cuda.graph(graph):
            outs.append(dcn_cross_bwd(*a))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for _ in range(20):
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())
        for graph, s in zip(graphs, streams):
            with torch.cuda.stream(s):
                graph.replay()
        for s in streams:
            torch.cuda.current_stream().wait_stream(s)
        torch.cuda.synchronize()
        for got, w in zip(outs, want):
            for a, b in zip(got, w):
                assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.usefixtures("profiler_ready")
@pytest.mark.parametrize("B", [512, 6400, 8192])
def test_dcn_bwd_kernel_is_deterministic(cuda, B):
    """Two calls, and a CUDA graph of a call replayed three times, give the
    same bits; a replay runs the two kernels, once each, and no memset."""
    x0, ws, bs, g = cross_case(cuda, B, 112, 3, True, seed=2)
    ss = cross_fwd_plain(x0, ws, bs)[2]
    args = (x0, ws, bs, ss, g)
    first, second = dcn_cross_bwd(*args), dcn_cross_bwd(*args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dcn_cross_bwd(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = dcn_cross_bwd(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(first, replayed):
            assert torch.equal(a, b)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    ran = {e.key: e.count for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA}
    assert len(ran) == 2 and list(ran.values()) == [1, 1], ran
    for part in ("dcn_cross_bwd_rows_kernel", "dcn_cross_bwd_sum_kernel"):
        assert any(part in k for k in ran), ran
    for a, b in zip(first, replayed):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,NL", [(512, 112, 3), (6401, 113, 3), (1, 112, 3)])
def test_dcn_bwd_eager_calls_and_a_graph_replay_repeat_the_first_bits(cuda, B, D, NL):
    """Nothing carries from one call to the next: 50 eager calls and a
    CUDA-graph replay each give the bits of the first call (two launches,
    or one with one block)."""
    x0, ws, bs, g = cross_case(cuda, B, D, NL, True, seed=3)
    args = (x0, ws, bs, cross_fwd_plain(x0, ws, bs)[2], g)
    first = dcn_cross_bwd(*args)
    calls = [dcn_cross_bwd(*args) for _ in range(50)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dcn_cross_bwd(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = dcn_cross_bwd(*args)
    graph.replay()
    torch.cuda.synchronize()
    for result in [*calls, replayed]:
        for a, b in zip(result, first):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_dcn_bwd_on_two_streams_at_once(cuda):
    """Calls on two streams at once each get the answer a call alone gives."""
    cases = [cross_case(cuda, B, 112, 3, True, seed=B) for B in (512, 6400)]
    args = [(x0, ws, bs, cross_fwd_plain(x0, ws, bs)[2], g) for x0, ws, bs, g in cases]
    want = [dcn_cross_bwd(*a) for a in args]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(20):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(dcn_cross_bwd(*args[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for result in got[i]:
            for a, b in zip(result, want[i]):
                assert torch.equal(a, b)


@pytest.mark.cuda
def test_cross_stack_autograd_on_cuda(cuda):
    """The forward kernel writes the residuals the backward kernel reads;
    the gradients equal the CPU path's."""
    arrays = cross_inputs(512, 112, 3)
    g = np.random.default_rng(3).standard_normal((512, 112)).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        args = [torch.from_numpy(a).to(dev).requires_grad_() for a in arrays]
        n = dcn_cross_stack.launches, dcn_cross_bwd.launches
        dcn_cross_stack(*args).backward(torch.from_numpy(g).to(dev))
        launched = (dcn_cross_stack.launches - n[0], dcn_cross_bwd.launches - n[1])
        assert launched == ((0, 0) if dev == "cpu" else (1, 1))
        grads[str(dev)] = [a.grad.cpu() for a in args]
    for name, a, b in zip(("dx0", "dws", "dbs"), grads["cuda"], grads["cpu"]):
        assert_close_to_scale(a, b, name)


@pytest.mark.cuda
@pytest.mark.parametrize("arena", [True, False], ids=["arena", "tables"])
def test_training_steps_on_cuda_match_cpu(cuda, arena):
    """4 sparse steps on the card and on the CPU from the same state and
    batches: tables (every row: both take the sorted route), accumulators
    and dense parameters; the step goes through the backward and scatter
    kernels."""
    cfg = train_cfg(arena)
    ds = train_dataset(cfg, 256, seed=3)
    packer = BatchPacker(ds)
    cpu_model = build_ranker(cfg, seed=0, device="cpu")
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to(cuda)}
    states = {d: init_sparse_state(m, cfg) for d, m in models.items()}
    steps = {d: make_sparse_train_step(m, cfg) for d, m in models.items()}
    idx = np.random.default_rng(0).permutation(256).reshape(4, 64)
    before = (dcn_cross_bwd.launches, scatter_rows_set.launches)
    for rows in idx:
        for d in ("cpu", "cuda"):
            dev = torch.device(d)
            batch = unpack_batch(torch.from_numpy(packer.int_mat[rows]).to(dev),
                                 torch.from_numpy(packer.float_mat[rows]).to(dev),
                                 torch.ones(64, device=dev), packer.layout_key())
            steps[d](states[d], batch, AucHist.zeros(dev))
    assert dcn_cross_bwd.launches - before[0] == 4
    assert scatter_rows_set.launches - before[1] >= 4
    want = dict(models["cpu"].named_parameters())
    for name, p in models["cuda"].named_parameters():
        torch.testing.assert_close(p.detach().cpu(), want[name].detach(), msg=name, **TRAIN_TOL)
    for name, acc in states["cuda"].emb_acc.items():
        torch.testing.assert_close(acc.cpu(), states["cpu"].emb_acc[name], msg=name, **TRAIN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 37, 511, 512, 6400, 6401])
@pytest.mark.parametrize("F", [1, 2, 5, 39])
@pytest.mark.parametrize("D", [1, 15, 16, 33, 64])
def test_fm_kernels_match_plain(cuda, B, F, D):
    """Both forward paths (5 x 15 staged, every other shape general); B 1,
    37, 511, 6,401 end on a part-filled block (32 rows a block staged); a
    second forward gives the same bits."""
    v, g = on(cuda, *fm_inputs(B, F, D))
    with torch.inference_mode():
        n = fm_second_order.launches, fm_second_order_bwd.launches
        got, dv = fm_second_order(v), fm_second_order_bwd(v, g)
        assert (fm_second_order.launches - n[0], fm_second_order_bwd.launches - n[1]) == (1, 1)
        assert torch.equal(fm_second_order(v), got)
    assert_close_to_scale(got, fm_plain(v), "fm forward")
    assert_close_to_scale(dv, fm_bwd_plain(v, g), "fm backward")


@pytest.mark.cuda
@pytest.mark.parametrize("F,D", [(5, 15), (5, 16), (5, 14), (4, 15), (15, 5), (1, 75)])
def test_fm_forward_at_the_edge_of_its_paths(cuda, F, D):
    """5 x 15 takes the staged path; its neighbours, its transpose and a row
    of the same 75 floats the general one."""
    from news_recsys_tpu_torch.ops.fm_kernel import plan_fm_fwd
    v, _ = on(cuda, *fm_inputs(700, F, D, seed=3))
    assert plan_fm_fwd(700, F, D).path == ("staged" if (F, D) == (5, 15) else "general")
    with torch.inference_mode():
        got = fm_second_order(v)
        assert torch.equal(fm_second_order(v), got)
    assert_close_to_scale(got, fm_plain(v), "fm forward")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 37, 512, 6400])
def test_fm_forward_unaligned_rows(cuda, B):
    """``v`` one float off a 16-byte boundary: every block's span starts and
    ends off the float4 grid, so the staged copy takes its scalar head and
    tail."""
    v_np, _ = fm_inputs(B, 5, 15, seed=4)
    v = off_by_one_float(cuda, v_np)
    with torch.inference_mode():
        got = fm_second_order(v)
        assert torch.equal(fm_second_order(v), got)
    assert_close_to_scale(got, fm_plain(v), "fm forward")


@pytest.mark.cuda
@pytest.mark.usefixtures("profiler_ready")
@pytest.mark.parametrize("F,D", [(5, 15), (5, 16)])
@pytest.mark.parametrize("B", [1, 512, 6401])
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_fm_plans_are_the_launches(cuda, tmp_path, backward, B, F, D):
    """``plan_fm_fwd`` / ``plan_fm_bwd`` restate the choice the C entries
    make: a ``torch.profiler`` trace of one call shows one kernel of the
    plan's path, with its blocks, threads and shared memory (the staged
    kernels have no static shared memory, so all of it is the plan's)."""
    v, g = on(cuda, *fm_inputs(B, F, D, seed=9))
    plan = (plan_fm_bwd if backward else plan_fm_fwd)(B, F, D)
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fm_second_order_bwd(v, g) if backward else fm_second_order(v)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    kernels = [e for e in trace if e.get("cat") == "kernel"]
    assert len(kernels) == 1, kernels
    name, args = kernels[0]["name"], kernels[0]["args"]
    assert f"fm_{'bwd' if backward else 'fwd'}_{plan.path}_kernel" in name, name
    assert args["grid"] == [plan.blocks, 1, 1], args
    assert args["block"] == [plan.threads, 1, 1], args
    assert args["shared memory"] == plan.smem_bytes, args


@pytest.mark.cuda
def test_fm_kernels_are_deterministic(cuda):
    v, g = on(cuda, *fm_inputs(6400, 5, 15, seed=1))
    assert torch.equal(fm_second_order(v), fm_second_order(v))
    assert torch.equal(fm_second_order_bwd(v, g), fm_second_order_bwd(v, g))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 511, 512, 6401])
def test_fm_backward_staged_ragged_last_block(cuda, B):
    """5 x 15 takes the backward's staged path; B 1, 3, 511 and 6,401 end on
    a part-filled block, whose span ends off the float4 grid; reruns repeat
    the bits."""
    v, g = on(cuda, *fm_inputs(B, 5, 15, seed=5))
    assert plan_fm_bwd(B, 5, 15).path == "staged"
    n = fm_second_order_bwd.launches
    dv = fm_second_order_bwd(v, g)
    assert fm_second_order_bwd.launches == n + 1
    assert torch.equal(fm_second_order_bwd(v, g), dv)
    assert_close_to_scale(dv, fm_bwd_plain(v, g), "fm backward")


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("B", [1, 37, 512, 6400])
def test_fm_backward_unaligned_rows(cuda, B, offset):
    """``v`` and ``g`` 1-3 floats off a 16-byte boundary: every block's span
    is staged with a scalar head and tail; ``dv`` (a fresh tensor) and a
    view into a buffer ``offset`` floats in get the same bits."""
    v_np, g_np = fm_inputs(B, 5, 15, seed=6)
    base = torch.zeros(v_np.size + offset, device=cuda)
    v = base[offset:].view(v_np.shape)
    v.copy_(torch.from_numpy(v_np))
    gbase = torch.zeros(B + offset, device=cuda)
    g = gbase[offset:]
    g.copy_(torch.from_numpy(g_np))
    assert v.data_ptr() % 16 != 0 and g.data_ptr() % 16 != 0
    dv = fm_second_order_bwd(v, g)
    assert_close_to_scale(dv, fm_bwd_plain(v, g), "fm backward")
    aligned = fm_second_order_bwd(*on(cuda, v_np, g_np))
    assert torch.equal(dv, aligned)


@pytest.mark.cuda
def test_deepfm_at_full_width_trains_through_the_staged_backward(cuda):
    """2 sparse steps of the full-width DeepFM (5 fields of 16: the FM
    kernels at 5 x 15), card against CPU; each step launches the staged
    backward once."""
    from news_recsys_tpu_torch.zoo import mind_ranker_config
    cfg = mind_ranker_config("deepfm")
    ds = train_dataset(cfg, 1024, seed=8)
    packer = BatchPacker(ds)
    cpu_model = build_ranker(cfg, seed=2, device="cpu")
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to(cuda)}
    states = {d: init_sparse_state(m, cfg) for d, m in models.items()}
    steps = {d: make_sparse_train_step(m, cfg) for d, m in models.items()}
    idx = np.random.default_rng(2).permutation(1024).reshape(2, 512)
    before = fm_second_order_bwd.launches
    for rows in idx:
        for d in ("cpu", "cuda"):
            dev = torch.device(d)
            batch = unpack_batch(torch.from_numpy(packer.int_mat[rows]).to(dev),
                                 torch.from_numpy(packer.float_mat[rows]).to(dev),
                                 torch.ones(512, device=dev), packer.layout_key())
            steps[d](states[d], batch, AucHist.zeros(dev))
    assert fm_second_order_bwd.launches - before == 2
    assert plan_fm_bwd(512, 5, 15).path == "staged"
    want = dict(models["cpu"].named_parameters())
    for name, p in models["cuda"].named_parameters():
        torch.testing.assert_close(p.detach().cpu(), want[name].detach(), msg=name, **TRAIN_TOL)


@pytest.mark.cuda
def test_fm_autograd_on_cuda(cuda):
    """The Function's forward and backward kernels against plain autograd
    through ``fm_plain`` on the same card."""
    v_np, g_np = fm_inputs(512, 5, 15, seed=2)
    g = torch.from_numpy(g_np).to(cuda)
    grads = {}
    for name, fn in (("kernel", fm_second_order), ("plain", fm_plain)):
        v = torch.from_numpy(v_np).to(cuda).requires_grad_()
        n = fm_second_order.launches, fm_second_order_bwd.launches
        fn(v).backward(g)
        launched = (fm_second_order.launches - n[0], fm_second_order_bwd.launches - n[1])
        assert launched == ((1, 1) if name == "kernel" else (0, 0))
        grads[name] = v.grad
    assert_close_to_scale(grads["kernel"], grads["plain"], "dv")


@pytest.mark.cuda
def test_deepfm_training_steps_on_cuda_match_cpu(cuda):
    """4 sparse steps of a narrow DeepFM, card against CPU; the step goes
    through both FM kernels and the scatter."""
    cfg = zoo_train_cfg("deepfm")
    ds = train_dataset(cfg, 256, seed=4)
    packer = BatchPacker(ds)
    cpu_model = build_ranker(cfg, seed=1, device="cpu")
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to(cuda)}
    states = {d: init_sparse_state(m, cfg) for d, m in models.items()}
    steps = {d: make_sparse_train_step(m, cfg) for d, m in models.items()}
    idx = np.random.default_rng(1).permutation(256).reshape(4, 64)
    before = (fm_second_order.launches, fm_second_order_bwd.launches, scatter_rows_set.launches)
    for rows in idx:
        for d in ("cpu", "cuda"):
            dev = torch.device(d)
            batch = unpack_batch(torch.from_numpy(packer.int_mat[rows]).to(dev),
                                 torch.from_numpy(packer.float_mat[rows]).to(dev),
                                 torch.ones(64, device=dev), packer.layout_key())
            steps[d](states[d], batch, AucHist.zeros(dev))
    assert fm_second_order.launches - before[0] == 4
    assert fm_second_order_bwd.launches - before[1] == 4
    assert scatter_rows_set.launches - before[2] >= 4
    want = dict(models["cpu"].named_parameters())
    for name, p in models["cuda"].named_parameters():
        torch.testing.assert_close(p.detach().cpu(), want[name].detach(), msg=name, **TRAIN_TOL)
    for name, acc in states["cuda"].emb_acc.items():
        torch.testing.assert_close(acc.cpu(), states["cpu"].emb_acc[name], msg=name, **TRAIN_TOL)


# -- the fused Transformer block -----------------------------------------------

# kernel vs plain on the card, float32 with other summation orders: the JAX
# package's own tolerances for its kernel (2e-5 forward; rtol 2e-4 and an
# atol of 2e-5 of the largest value for gradients, which are sums over B*L rows)
BLOCK_FWD_TOL = dict(rtol=2e-5, atol=2e-5)


def block_inputs(B, L, D, F, seed=0, scale=0.3):
    """x, a mask with ~25% invalid keys, an all-zero row and an all-one row,
    the 12 parameters (LayerNorm scales around 1) and an upstream gradient."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = (rng.random((B, L)) > 0.25).astype(np.float32)
    mask[0] = 1.0
    if B > 1:
        mask[1] = 0.0
    shapes = ((D, 3 * D), (3 * D,), (D, D), (D,), (D,), (D,), (D, F), (F,), (F, D), (D,), (D,),
              (D,))
    params = [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    for i in (4, 10):
        params[i] = params[i] + 1.0
    dy = rng.standard_normal((B, L, D)).astype(np.float32)
    return x, mask, params, dy


def assert_grads_close(got, want, name):
    torch.testing.assert_close(got, want, rtol=2e-4,
                               atol=2e-5 * max(1.0, float(want.abs().max())), msg=name)


BLOCK_SHAPES = [(6400, 30, 32, 64, 2), (512, 30, 32, 64, 2), (24, 30, 32, 64, 2),
                (7, 12, 16, 24, 1), (130, 50, 64, 96, 4), (3, 128, 128, 512, 8),
                (5, 33, 24, 40, 3), (1, 1, 4, 4, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,D,F,H", BLOCK_SHAPES)
def test_fused_block_forward_matches_plain(cuda, B, L, D, F, H):
    """(3, 128, 128, 512) is the edge of the Pallas kernel's domain: the
    workspace no longer fits shared memory and lies in device memory."""
    x, mask, params, _ = block_inputs(B, L, D, F)
    x, mask, *params = on(cuda, x, mask, *params)
    with torch.inference_mode():
        n = fused_transformer_block.launches
        got = fused_transformer_block(params, x, mask, H)
        assert fused_transformer_block.launches == n + 1
        want = block_plain(x, mask, *params, num_heads=H)
    torch.testing.assert_close(got, want, **BLOCK_FWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,D,F,H", BLOCK_SHAPES[1:])
def test_fused_block_backward_matches_plain(cuda, B, L, D, F, H):
    x, mask, params, dy = block_inputs(B, L, D, F, seed=1)
    x, mask, dy, *params = on(cuda, x, mask, dy, *params)
    n = fused_transformer_block_bwd.launches
    dx, dparams = fused_transformer_block_bwd(params, x, mask, dy, H)
    assert fused_transformer_block_bwd.launches == n + 1
    want_dx, want_dparams = block_bwd_plain(params, x, mask, dy, H)
    assert_grads_close(dx, want_dx, "dx")
    for name, a, b in zip(PARAM_NAMES, dparams, want_dparams):
        assert_grads_close(a, b, name)
    again_dx, again = fused_transformer_block_bwd(params, x, mask, dy, H)
    assert torch.equal(dx, again_dx) and all(torch.equal(a, b) for a, b in zip(dparams, again))


@pytest.mark.cuda
def test_fused_block_autograd_on_cuda(cuda):
    """The Function's forward and backward kernels against autograd through
    ``block_plain`` on the CPU."""
    x_np, mask_np, params_np, dy_np = block_inputs(64, 30, 32, 64, seed=2)
    grads = {}
    for dev in ("cpu", cuda):
        x, mask, dy, *params = on(dev, x_np, mask_np, dy_np, *params_np)
        leaves = [t.requires_grad_() for t in (x, *params)]
        n = fused_transformer_block.launches, fused_transformer_block_bwd.launches
        fused_transformer_block(leaves[1:], leaves[0], mask, 2).backward(dy)
        launched = (fused_transformer_block.launches - n[0],
                    fused_transformer_block_bwd.launches - n[1])
        assert launched == ((0, 0) if dev == "cpu" else (1, 1))
        grads[str(dev)] = [t.grad.cpu() for t in leaves]
    for name, a, b in zip(("dx", *PARAM_NAMES), grads["cuda"], grads["cpu"]):
        assert_grads_close(a, b, name)


@pytest.mark.cuda
def test_fused_block_rejects_what_it_does_not_take(cuda):
    x, mask, params, _ = block_inputs(2, 4, 8, 8)
    x, mask, *params = on(cuda, x, mask, *params)
    with pytest.raises(ValueError, match="multiple of num_heads"):
        fused_transformer_block(params, x, mask, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fused_transformer_block(params, x.transpose(0, 1), mask.t(), 2)
    big = torch.zeros(1, 129, 8, device=cuda)
    with pytest.raises(ValueError, match="L <= 128"):
        fused_transformer_block(params, big, torch.ones(1, 129, device=cuda), 2)


# -- the block's two routes at the attention ranker's widths ----------------------

RANKER_L, RANKER_D, RANKER_F, RANKER_H = 30, 32, 64, 2
# odd batches leave the last tile half filled; 2,048 a large-batch step's
ROUTE_BATCHES = [1, 2, 3, 511, 512, 513, 2048, 6400]


def ranker_block_inputs(B, seed):
    """:func:`block_inputs` at the ranker's widths with examples that have no
    valid key first, last and paired in one tile of two (examples 4 and 5)."""
    x, mask, params, dy = block_inputs(B, RANKER_L, RANKER_D, RANKER_F, seed=seed)
    if B > 1:
        mask[1] = 1.0
    mask[0] = 0.0
    mask[-1] = 0.0
    if B >= 6:
        mask[4:6] = 0.0
    return x, mask, params, dy


KINK_MARGIN = 1e-5


def relu_kinks(params, x, mask, margin=KINK_MARGIN):
    """(the feed-forward's pre-activations (B, L, F) as the plain version
    computes them, the mask of those within ``margin`` of the ReLU's kink)."""
    wqkv, bqkv, wo, bo, g1, b1, w1, c1 = params[:8]
    y1 = layer_norm_plain(x + mhsa_plain(x, mask, wqkv, bqkv, wo, bo, RANKER_H), g1, b1)
    z = y1 @ w1 + c1
    return z, z.abs() < margin


def mute_relu_kinks(params, x, mask, dy, margin=KINK_MARGIN):
    """``dy`` with the examples zeroed in which a pre-activation of the
    feed-forward lies within ``margin`` of the ReLU's kink. There rounding
    decides the gate (a kernel recomputes the forward in another order than
    the plain version), and with the gate a whole row's gradient; at batch
    6,400 the block has 12 M pre-activations and a few always land there.
    ``test_block_routes_hold_kink_rows_to_their_own_gate`` holds these
    examples to the plain gradient with the kernel's gate."""
    near = relu_kinks(params, x, mask, margin)[1].flatten(1).any(dim=1)
    assert int(near.sum()) <= max(1, x.shape[0] // 20)
    return torch.where(near[:, None, None], torch.zeros_like(dy), dy)


@pytest.mark.cuda
def test_planner_mirrors_the_kernels_sizes(cuda):
    """The pure-Python planner states the sizes that the sources compute."""
    from news_recsys_tpu_torch.ops._build import library
    lib = library()
    for backward in (False, True):
        plan = plan_shape(512, RANKER_L, RANKER_D, RANKER_F, RANKER_H, 132, backward)
        fn = lib.nrt_fused_block_tiled_bwd_smem_bytes if backward else \
            lib.nrt_fused_block_tiled_fwd_smem_bytes
        assert plan.smem_bytes == fn()
        for _, L, D, F, _ in BLOCK_SHAPES:
            assert _general_ws_floats(L, D, F, backward) == \
                lib.nrt_fused_block_ws_floats(L, D, F, int(backward))
            assert param_floats(D, F) == lib.nrt_fused_block_param_floats(D, F)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["general", "tiled"])
@pytest.mark.parametrize("B", ROUTE_BATCHES)
def test_block_routes_forward_match_plain(cuda, B, route):
    x, mask, params, _ = ranker_block_inputs(B, seed=3)
    x, mask, *params = on(cuda, x, mask, *params)
    with torch.inference_mode():
        n = fused_transformer_block.launches
        got = fused_transformer_block(params, x, mask, RANKER_H, route=route)
        assert fused_transformer_block.launches == n + 1
        want = block_plain(x, mask, *params, num_heads=RANKER_H)
    torch.testing.assert_close(got, want, **BLOCK_FWD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["general", "tiled"])
@pytest.mark.parametrize("B", ROUTE_BATCHES)
def test_block_routes_backward_match_plain(cuda, B, route):
    """Random ``dy``: a padding row that leaked into a gradient would show.
    Two runs give the same bits."""
    x, mask, params, dy = ranker_block_inputs(B, seed=4)
    x, mask, dy, *params = on(cuda, x, mask, dy, *params)
    dy = mute_relu_kinks(params, x, mask, dy)
    n = fused_transformer_block_bwd.launches
    dx, dparams = fused_transformer_block_bwd(params, x, mask, dy, RANKER_H, route=route)
    assert fused_transformer_block_bwd.launches == n + 1
    want_dx, want_dparams = block_bwd_plain(params, x, mask, dy, RANKER_H)
    assert_grads_close(dx, want_dx, "dx")
    for name, a, b in zip(PARAM_NAMES, dparams, want_dparams):
        assert_grads_close(a, b, name)
    again_dx, again = fused_transformer_block_bwd(params, x, mask, dy, RANKER_H, route=route)
    assert torch.equal(dx, again_dx) and all(torch.equal(a, b) for a, b in zip(dparams, again))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["general", "tiled"])
@pytest.mark.parametrize("B", [512, 6400])
def test_block_routes_hold_kink_rows_to_their_own_gate(cuda, B, route):
    """The examples that :func:`mute_relu_kinks` mutes, unmuted: for each, the
    gate the kernel took is the one of the 2^k gates of its k pre-activations
    near the kink whose plain gradient its dx matches; then dx and the 12
    parameter gradients of the whole batch equal ``block_bwd_plain`` with
    those gates, at the tolerances of the other tests: the mute hides no
    other error."""
    x, mask, params, dy = ranker_block_inputs(B, seed=4)
    x, mask, dy, *params = on(cuda, x, mask, dy, *params)
    z, near = relu_kinks(params, x, mask)
    dx, dparams = fused_transformer_block_bwd(params, x, mask, dy, RANKER_H, route=route)
    gate = (z > 0).float()
    for i in near.flatten(1).any(dim=1).nonzero().flatten().tolist():
        at = near[i].nonzero().tolist()
        assert len(at) <= 4, at
        errs = {}
        for flips in range(2 ** len(at)):
            gi = gate[i:i + 1].clone()
            for bit, (l, f) in enumerate(at):
                if flips >> bit & 1:
                    gi[0, l, f] = 1.0 - gi[0, l, f]
            want, _ = block_bwd_plain(params, x[i:i + 1], mask[i:i + 1], dy[i:i + 1], RANKER_H,
                                      gate=gi)
            errs[flips] = (float((dx[i] - want[0]).abs().max()), gi)
        gate[i] = min(errs.values(), key=lambda e: e[0])[1][0]
    want_dx, want_dparams = block_bwd_plain(params, x, mask, dy, RANKER_H, gate=gate)
    assert_grads_close(dx, want_dx, "dx")
    for name, a, b in zip(PARAM_NAMES, dparams, want_dparams):
        assert_grads_close(a, b, name)


@pytest.mark.cuda
@pytest.mark.parametrize("B", ROUTE_BATCHES)
def test_block_routes_agree_and_the_default_is_tiled(cuda, B):
    """The two routes against each other, and the route taken with no keyword
    against the tiled one, bit for bit."""
    x, mask, params, dy = ranker_block_inputs(B, seed=5)
    x, mask, dy, *params = on(cuda, x, mask, dy, *params)
    dy = mute_relu_kinks(params, x, mask, dy)
    out, grads = {}, {}
    for route in (None, "general", "tiled"):
        with torch.no_grad():
            out[route] = fused_transformer_block(params, x, mask, RANKER_H, route=route)
        dx, dparams = fused_transformer_block_bwd(params, x, mask, dy, RANKER_H, route=route)
        grads[route] = (dx, *dparams)
    assert torch.equal(out[None], out["tiled"])
    assert all(torch.equal(a, b) for a, b in zip(grads[None], grads["tiled"]))
    torch.testing.assert_close(out["tiled"], out["general"], **BLOCK_FWD_TOL)
    for name, a, b in zip(("dx", *PARAM_NAMES), grads["tiled"], grads["general"]):
        assert_grads_close(a, b, name)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [17, 24, 32])
def test_tiled_route_takes_every_length_of_its_slot(cuda, L):
    x, mask, params, dy = block_inputs(37, L, RANKER_D, RANKER_F, seed=6)
    x, mask, dy, *params = on(cuda, x, mask, dy, *params)
    dy = mute_relu_kinks(params, x, mask, dy)
    with torch.no_grad():
        got = fused_transformer_block(params, x, mask, RANKER_H, route="tiled")
    torch.testing.assert_close(got, block_plain(x, mask, *params, num_heads=RANKER_H),
                               **BLOCK_FWD_TOL)
    dx, dparams = fused_transformer_block_bwd(params, x, mask, dy, RANKER_H, route="tiled")
    want_dx, want_dparams = block_bwd_plain(params, x, mask, dy, RANKER_H)
    for name, a, b in zip(("dx", *PARAM_NAMES), (dx, *dparams), (want_dx, *want_dparams)):
        assert_grads_close(a, b, name)


@pytest.mark.cuda
def test_tiled_route_autograd_and_unaligned_views(cuda):
    """Through the ``autograd.Function`` with the route named, on inputs that
    are views at addresses off the 16-byte grid."""
    x_np, mask_np, params_np, dy_np = ranker_block_inputs(9, seed=7)
    x, mask, dy, *params = on(cuda, x_np, mask_np, dy_np, *params_np)
    x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(x.shape)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    leaves = [t.requires_grad_() for t in (x, *params)]
    fused_transformer_block(leaves[1:], leaves[0], mask, RANKER_H, route="tiled").backward(dy)
    want_dx, want_dparams = block_bwd_plain(params, x.detach(), mask, dy, RANKER_H)
    for name, t, b in zip(("dx", *PARAM_NAMES), leaves, (want_dx, *want_dparams)):
        assert_grads_close(t.grad, b, name)


@pytest.mark.cuda
def test_tiled_route_refuses_other_shapes(cuda):
    x, mask, params, dy = block_inputs(3, 128, 128, 512)
    x, mask, dy, *params = on(cuda, x, mask, dy, *params)
    with pytest.raises(ValueError, match="tiled route takes"):
        fused_transformer_block(params, x, mask, 8, route="tiled")
    with pytest.raises(ValueError, match="tiled route takes"):
        fused_transformer_block_bwd(params, x, mask, dy, 8, route="tiled")


# -- the pool's backward ---------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("V,D,B,L", [(30080, 16, 512, 5), (65280, 16, 512, 30), (500, 40, 33, 7),
                                     (50, 3, 9, 4), (80, 256, 8, 2)])
def test_pool_bwd_kernel_matches_plain(cuda, V, D, B, L):
    """Duplicates inside and across examples, padding id 0, masked slots, an
    all-zero mask row; two runs bit-identical."""
    _, ids, mask = pool_inputs(V, D, B, L)
    ids[:, 0] = ids[0, 0]                                   # one id in every example
    g = np.random.default_rng(1).standard_normal((B, D)).astype(np.float32)
    ids, mask, g = on(cuda, ids, mask, g)
    n = fused_lookup_pool_bwd.launches
    got = fused_lookup_pool_bwd(ids, mask, g, V)
    assert fused_lookup_pool_bwd.launches == n + 1
    assert_close_to_scale(got, pool_bwd_plain(ids, mask, g, V), "grad_table")
    assert not got[0].any()
    assert torch.equal(got, fused_lookup_pool_bwd(ids, mask, g, V))


@pytest.mark.cuda
def test_pool_bwd_kernel_drops_out_of_range_ids(cuda):
    _, ids, mask = pool_inputs(50, 8, 8, 4)
    mask[:] = 1.0
    ids[3, 1], ids[5, 2], ids[6, 0] = 50, 1000, -2
    g = np.random.default_rng(2).standard_normal((8, 8)).astype(np.float32)
    got = fused_lookup_pool_bwd(*on(cuda, ids, mask, g), 50).cpu()
    want = pool_bwd_plain(*map(torch.from_numpy, (ids, mask, g)), 50)
    assert torch.isfinite(got).all()
    assert_close_to_scale(got, want, "grad_table")


@pytest.mark.cuda
def test_pool_autograd_on_cuda(cuda):
    table_np, ids_np, mask_np = pool_inputs(300, 16, 64, 6)
    g_np = np.random.default_rng(3).standard_normal((64, 16)).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        table, ids, mask, g = on(dev, table_np, ids_np, mask_np, g_np)
        table.requires_grad_()
        n = fused_lookup_pool.launches, fused_lookup_pool_bwd.launches
        fused_lookup_pool(table, ids, mask).backward(g)
        launched = (fused_lookup_pool.launches - n[0], fused_lookup_pool_bwd.launches - n[1])
        assert launched == ((0, 0) if dev == "cpu" else (1, 1))
        grads[str(dev)] = table.grad.cpu()
    assert_close_to_scale(grads["cuda"], grads["cpu"], "grad_table")


# -- the pool's kernels on skewed ids, runs of one id and odd widths ---------------
#
# The backward adds every term as an integer scaled by its row's largest term,
# warps of 32 slots (blocks of 128) summing the slots of one id before one
# atomic a column: runs of one id are placed to fill a warp, to overflow it by
# one and to outrun a block.


def zipf_pool_ids(V, B, L, seed, a=1.05):
    """(ids, mask) with ids from a Zipf law folded into [1, V), ragged
    lengths (the first example empty, the third full) and the sixth example
    masked out: the most frequent id takes about one valid slot in 20."""
    rng = np.random.default_rng(seed)
    ids = (1 + (rng.zipf(a, (B, L)) - 1) % (V - 1)).astype(np.int32)
    lengths = rng.integers(0, L + 1, B)
    lengths[:3] = (0, 1, L)[:B]
    ids[np.arange(L)[None, :] >= lengths[:, None]] = 0
    mask = (ids != 0).astype(np.float32)
    if B > 5:
        mask[5] = 0.0
    return ids, mask


def check_pool_bwd(dev, ids, mask, g, V):
    """The kernel's gradient against ``pool_bwd_plain`` in float64 on the CPU
    (the kernel adds exactly to a grain of 2^-31 of a row's largest term or
    finer; a float32 sum of 15,360 terms in one row is not that close), and
    a second run bit-identical; returns the gradient."""
    want = pool_bwd_plain(torch.from_numpy(ids), torch.from_numpy(mask).double(),
                          torch.from_numpy(g).double(), V).float()
    ids, mask, g = on(dev, ids, mask, g)
    n = fused_lookup_pool_bwd.launches
    got = fused_lookup_pool_bwd(ids, mask, g, V)
    assert fused_lookup_pool_bwd.launches == n + 1
    assert_close_to_scale(got.cpu(), want, "grad_table")
    assert not got[0].any()
    assert torch.equal(got, fused_lookup_pool_bwd(ids, mask, g, V))
    return got


def pool_grad(B, D, seed):
    return np.random.default_rng(seed).standard_normal((B, D)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("V,L", [(30080, 5), (65280, 30)])
def test_pool_bwd_kernel_on_zipf_ids(cuda, V, L):
    """The two training shapes at batch 512, D 16, ids as skewed as MIND's."""
    ids, mask = zipf_pool_ids(V, 512, L, seed=L)
    assert np.bincount(ids[mask > 0]).max() > 50
    check_pool_bwd(cuda, ids, mask, pool_grad(512, 16, L), V)


@pytest.mark.cuda
@pytest.mark.parametrize("V,B,L,D", [(500, 512, 30, 16), (50, 1, 4, 3), (9, 70, 33, 40)])
def test_pool_bwd_kernel_one_id_in_every_slot(cuda, V, B, L, D):
    ids = np.full((B, L), V - 2, np.int32)
    mask = np.ones((B, L), np.float32)
    got = check_pool_bwd(cuda, ids, mask, pool_grad(B, D, 3), V)
    assert torch.count_nonzero(got.abs().sum(dim=1)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("run", [32, 33, 128, 129, 1000])
def test_pool_bwd_kernel_runs_of_one_id(cuda, run):
    """A run of one id in consecutive slots, from slot 17 (across warps),
    among uniform ids; every example fully valid."""
    B, L, V = 64, 30, 1000
    rng = np.random.default_rng(run)
    ids = rng.integers(1, V, (B, L)).astype(np.int32)
    ids.reshape(-1)[17:17 + run] = 321
    mask = np.ones((B, L), np.float32)
    check_pool_bwd(cuda, ids, mask, pool_grad(B, 16, run), V)


@pytest.mark.cuda
@pytest.mark.parametrize("hot", ["first", "last"])
def test_pool_bwd_kernel_hot_id_at_the_table_edges(cuda, hot):
    """A third of the slots hold id 1, or id V - 1."""
    B, L, V = 256, 20, 4000
    rng = np.random.default_rng(7)
    ids = rng.integers(1, V, (B, L)).astype(np.int32)
    ids[rng.random((B, L)) < 1 / 3] = 1 if hot == "first" else V - 1
    _, mask = zipf_pool_ids(V, B, L, seed=8)
    mask = np.where(mask > 0, mask, (rng.random((B, L)) < 0.5).astype(np.float32))
    check_pool_bwd(cuda, ids, mask, pool_grad(B, 16, 9), V)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 3, 17, 256])
def test_pool_bwd_kernel_widths(cuda, D):
    ids, mask = zipf_pool_ids(2000, 64, 12, seed=D)
    check_pool_bwd(cuda, ids, mask, pool_grad(64, D, D), 2000)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [1, 7, 40])
def test_pool_bwd_kernel_batch_of_one(cuda, L):
    """B 1; L 40 takes the scan's second chunk of 32 slots. Weights other
    than 0 and 1 and a repeated id."""
    rng = np.random.default_rng(L)
    ids = rng.integers(1, 100, (1, L)).astype(np.int32)
    ids[0, L // 2] = ids[0, 0]
    mask = rng.uniform(0.2, 2.0, (1, L)).astype(np.float32)
    check_pool_bwd(cuda, ids, mask, pool_grad(1, 16, L), 100)


@pytest.mark.cuda
def test_pool_bwd_kernel_non_finite_gradients(cuda):
    """NaN and +-inf in g: the columns they reach read what an IEEE sum
    gives (NaN, +inf, -inf; +inf and -inf in one column: NaN), every other
    value stays exact; examples fully valid, so that the plain version adds
    no masked slot."""
    B, L, V, D = 8, 4, 50, 8
    rng = np.random.default_rng(4)
    ids = rng.integers(1, V, (B, L)).astype(np.int32)
    ids[4, 0] = ids[5, 0] = ids[6, 0] = 7
    mask = np.ones((B, L), np.float32)
    g = pool_grad(B, D, 5)
    g[3, 2] = np.nan
    g[4, 5], g[5, 5], g[6, 6] = np.inf, -np.inf, np.inf
    got = fused_lookup_pool_bwd(*on(cuda, ids, mask, g), V).cpu()
    want = pool_bwd_plain(*map(torch.from_numpy, (ids, mask, g)), V)
    assert got[7, 5].isnan() and got[7, 6] == np.inf
    torch.testing.assert_close(got, want, equal_nan=True, rtol=1e-5, atol=1e-5)
    assert torch.equal(got.isnan(), want.isnan())


@pytest.mark.cuda
@pytest.mark.parametrize("skewed", [False, True], ids=["uniform", "zipf"])
@pytest.mark.parametrize("V,B,L", [(65280, 64, 30), (30080, 512, 5), (65280, 1024, 30)])
def test_pool_kernel_on_the_main_path_shapes(cuda, V, B, L, skewed):
    """The forward at a 64- and a 1,024-user request's ``hist`` and the
    dense step's ``entities``, D 16 (16-byte loads), on uniform and Zipf
    ids; two runs bit-identical."""
    rng = np.random.default_rng(B + L)
    table = rng.standard_normal((V, 16)).astype(np.float32)
    table[0] = 0.0
    if skewed:
        ids, mask = zipf_pool_ids(V, B, L, seed=B)
    else:
        _, ids, mask = pool_inputs(V, 16, B, L, seed=B)
    table, ids, mask = on(cuda, table, ids, mask)
    with torch.inference_mode():
        got = fused_lookup_pool(table, ids, mask)
        torch.testing.assert_close(got, reference_lookup_pool(table, ids, mask), **POOL_TOL)
        assert torch.equal(got, fused_lookup_pool(table, ids, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 12])
def test_pool_kernel_unaligned_table(cuda, D):
    """A table view off the 16-byte grid takes the 4-byte loads; D 12 is a
    multiple of 4 whose rows need not start on the grid either."""
    table, ids, mask = pool_inputs(700, D, 40, 9)
    table, ids, mask = on(cuda, table, ids, mask)
    view = torch.cat([table.new_zeros(1), table.reshape(-1)])[1:].view(table.shape)
    assert view.data_ptr() % 16 != 0 and view.is_contiguous()
    with torch.inference_mode():
        torch.testing.assert_close(fused_lookup_pool(view, ids, mask),
                                   reference_lookup_pool(view, ids, mask), **POOL_TOL)


# -- checkpoints between the card and the CPU ------------------------------------


CKPT_STEPS = {"sparse": {}, "dense": {"embedding_optimizer": "adamw"}}


def checkpoint_tensors(blob, path="state"):
    """{path: tensor} of a checkpoint dict, every tensor on the CPU."""
    if isinstance(blob, torch.Tensor):
        return {path: blob.detach().cpu()}
    out = {}
    if isinstance(blob, dict):
        for k, v in blob.items():
            out.update(checkpoint_tensors(v, f"{path}/{k}"))
    return out


def assert_same_checkpoint(a, b):
    a, b = checkpoint_tensors(a), checkpoint_tensors(b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("step", list(CKPT_STEPS))
def test_checkpoint_moves_between_the_card_and_the_cpu(cuda, tmp_path, step):
    """A checkpoint written on the card loads into a state on the CPU, and
    one written on the CPU into a state on the card: every tensor arrives
    with its bits, AdamW's step counts on the CPU."""
    cfg = train_cfg(False, **CKPT_STEPS[step])
    ds = train_dataset(cfg, 128, seed=21)                        # 2 steps
    for src, dst in ((cuda, torch.device("cpu")), (torch.device("cpu"), cuda)):
        trainer = Trainer(cfg, build_ranker(cfg, seed=1, device=src),
                          workdir=str(tmp_path / f"{src.type}_src"), device=src)
        state, _ = trainer.train_epoch(trainer.init_state(), ds, 0)
        path = trainer.save_checkpoint(state, 0)
        other = Trainer(cfg, build_ranker(cfg, seed=2, device=dst),
                        workdir=str(tmp_path / f"{dst.type}_dst"), device=dst)
        loaded = other.load_checkpoint(other.init_state(), path)
        assert other.global_step == loaded.step == 2
        assert all(p.device.type == dst.type for p in loaded.model.parameters())
        assert_same_checkpoint(state_dict(loaded), state_dict(state))
        opt = loaded.dense_opt if step == "sparse" else loaded.opt
        assert all(s["step"].device.type == "cpu" and s["exp_avg"].device.type == dst.type
                   for s in opt.state.values())
        assert_same_checkpoint(load_state(path), state_dict(state))


def load_script(name: str):
    """``scripts/<name>.py`` as a module."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def harness_cfg(name: str):
    """The MIND parity harness's config of ``name``
    (``scripts/mind_parity_torch.py``: the reference recipe at full width,
    batch 512), with user and item tables of 5,000 and 4,500 ids."""
    fullscale = load_script("fullscale_rankers_torch")
    raw = fullscale.tighten(fullscale.base_config_dict("/unused", "/unused", 5000, 4500),
                            {"category": [{}, 19], "subcategory": [{}, 99],
                             "user_click_category": [{}, 19], "entities": [{}, 999]})
    return config_from_dict(load_script("mind_parity_torch").model_config_dict(raw, name))


def harness_dataset(cfg, n: int, seed: int) -> PackedDataset:
    """Rows of ``cfg``'s features: ids of every table, and ``hist`` and
    ``entities`` of ragged lengths (some empty) where the config reads them."""
    rng = np.random.default_rng(seed)
    sizes, lengths = cfg.embeddings.embedding_table_size, cfg.features.array_max_length
    arrays = {f: rng.integers(1, sizes[f], n).astype(np.int32)
              for f in cfg.features.sparse_feature_names}
    for f in cfg.features.array_feature_names:
        table = "item_id" if f == "hist" else f
        ids = rng.integers(1, sizes[table], (n, lengths[f])).astype(np.int32)
        mask = np.arange(lengths[f])[None, :] < rng.integers(0, lengths[f] + 1, n)[:, None]
        ids[~mask] = 0
        arrays[f], arrays[f"{f}_mask"] = ids, mask.astype(np.float32)
    arrays["label"] = (rng.random(n) < 0.2).astype(np.float32).reshape(-1, 1)
    return PackedDataset(arrays)


# the kernels of a harness model's forward (a launch a batch)
HARNESS_KERNELS = {"deep": (), "dcn": (dcn_cross_stack,),
                   "attention": (fused_transformer_block, fused_lookup_pool)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(HARNESS_KERNELS))
def test_predict_on_the_card_equals_the_cpu_on_one_checkpoint(cuda, tmp_path, name):
    """The MIND parity harness's scoring: a checkpoint written on the CPU,
    loaded into a trainer on the card; ``Trainer.predict`` of 1,300 rows (two
    batches of 512 and a padded third) equals the CPU's within the scores'
    1e-5, through the forward kernels, once a batch."""
    cfg = harness_cfg(name)
    ds = harness_dataset(cfg, 1300, seed=31)
    cpu = Trainer(cfg, build_ranker(cfg, name, seed=5, device="cpu"),
                  workdir=str(tmp_path / "cpu"), device="cpu")
    state, _ = cpu.train_epoch(cpu.init_state(), harness_dataset(cfg, 1024, seed=32), 0)
    path = cpu.save_checkpoint(state, 0)
    card = Trainer(cfg, build_ranker(cfg, name, seed=6, device=cuda),
                   workdir=str(tmp_path / "card"), device=cuda)
    card.load_checkpoint(card.init_state(), path)
    before = [k.launches for k in HARNESS_KERNELS[name]]
    got = card.predict(ds)
    assert [k.launches - n for k, n in zip(HARNESS_KERNELS[name], before)] == \
        [3] * len(HARNESS_KERNELS[name])
    want = cpu.predict(ds)
    assert got.shape == want.shape == (1300,) and np.std(want) > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("step", list(CKPT_STEPS))
def test_adamw_restored_on_the_card_takes_steps(cuda, tmp_path, step):
    """A state written on the CPU, loaded on the card, trains on (a
    non-capturable AdamW refuses step counts on the card) and stays with
    the CPU's continuation of the same state within TRAIN_TOL."""
    cfg = train_cfg(False, **CKPT_STEPS[step])
    ds = train_dataset(cfg, 256, seed=22)                        # 4 steps an epoch
    cpu = Trainer(cfg, build_ranker(cfg, seed=3, device="cpu"), workdir=str(tmp_path / "cpu"),
                  device="cpu")
    state, _ = cpu.train_epoch(cpu.init_state(), ds, 0)
    path = cpu.save_checkpoint(state, 0)
    card = Trainer(cfg, build_ranker(cfg, seed=4, device=cuda), workdir=str(tmp_path / "card"),
                   device=cuda)
    on_card = card.load_checkpoint(card.init_state(), path)
    on_card, metrics = card.train_epoch(on_card, ds, 1)
    state, want = cpu.train_epoch(state, ds, 1)
    assert metrics["steps"] == want["steps"] == 4 and on_card.step == state.step == 8
    assert np.isfinite(metrics["train_loss"])
    got, want = checkpoint_tensors(state_dict(on_card)), checkpoint_tensors(state_dict(state))
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], msg=k, **TRAIN_TOL)



# -- the optimizer variants ------------------------------------------------------


def shared_noise(seed: int):
    """One rounding-noise function for both devices: drawn on the CPU and
    copied, so the card and the CPU round with the same bits."""
    from news_recsys_tpu_torch.training.sparse_step import rounding_noise
    cpu = rounding_noise(seed)
    return lambda step, index, shape, device: cpu(step, index, shape, "cpu").to(device)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bfloat16 ulps between two bfloat16 tensors."""
    def ordered(t):
        u = t.cpu().view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(u >= 0x8000, -(u & 0x7FFF), u)
    return int((ordered(a) - ordered(b)).abs().max())


VARIANTS = {"sparse_adamw": (dict(embedding_optimizer="sparse_adamw"), None),
            "K4": (dict(embedding_update_period=4), None),
            "bf16": ({}, {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"})}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_variant_steps_on_cuda_match_cpu(cuda, variant):
    """6 steps of a sparse variant on the card and on the CPU from the same
    state, batches and rounding noise: ``sparse_adamw`` (3 scatter launches
    a step: the table and both moments), K = 4 (a combined update after 4
    steps and a flush after 6) and bfloat16 tables and towers (the
    unique-row layout and a plain write: no scatter launch). Float32 state
    within TRAIN_TOL; a bfloat16 table within one ulp on its addressable
    rows; bfloat16 towers within 2e-2 (their matmuls round to 8 bits)."""
    train, mesh = VARIANTS[variant]
    cfg = train_cfg(True, mesh=mesh, **train)
    ds = train_dataset(cfg, 384, seed=5)
    packer = BatchPacker(ds)
    cpu_model = build_ranker(cfg, seed=1, device="cpu")
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to(cuda)}
    devices = {"cpu": torch.device("cpu"), "cuda": cuda}
    states = {d: init_sparse_state(m, cfg) for d, m in models.items()}
    steps = {d: make_sparse_train_step(m, cfg, noise=shared_noise(7))
             for d, m in models.items()}
    before = scatter_rows_set.launches
    for rows in np.random.default_rng(1).permutation(384).reshape(6, 64):
        for d, dev in devices.items():
            batch = unpack_batch(torch.from_numpy(packer.int_mat[rows]).to(dev),
                                 torch.from_numpy(packer.float_mat[rows]).to(dev),
                                 torch.ones(64, device=dev), packer.layout_key())
            steps[d](states[d], batch, AucHist.zeros(dev))
            if variant == "K4" and states[d].step % 4 == 0:
                steps[d].flush(states[d])
    for d in ("cpu", "cuda"):
        steps[d].flush(states[d])
    launches = scatter_rows_set.launches - before
    assert launches == {"sparse_adamw": 18, "K4": 2, "bf16": 0}[variant]
    assert states["cuda"].applies == states["cpu"].applies
    n = 5000 + 4500 - 1                                     # the arena's addressable rows
    tol = dict(rtol=2e-2, atol=2.5e-3) if variant == "bf16" else TRAIN_TOL
    want = dict(models["cpu"].named_parameters())
    for name, p in models["cuda"].named_parameters():
        if p.dtype == torch.bfloat16:
            assert bf16_ulps(p.detach()[:n], want[name].detach()[:n]) <= 1, name
        else:
            torch.testing.assert_close(p.detach().cpu(), want[name].detach(), msg=name, **tol)
    for key in ("emb_acc", "emb_mu", "emb_nu"):
        for name, t in getattr(states["cuda"], key).items():
            torch.testing.assert_close(t.cpu()[:n], getattr(states["cpu"], key)[name][:n],
                                       msg=f"{key} {name}", **TRAIN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [512, 4096, 16384])
def test_dedup_and_dense_route_repeat_their_bits_on_cuda(cuda, n):
    """The duplicate sums (``segment_sum``, embedding's backward) and the
    dense AdaGrad route give the same bits on every run on the card (runs of
    up to n / 8 equal ids), and the CPU's values within rtol 1e-5 and an
    atol of 1e-5 of the largest value (sums of up to 2,048 terms in another
    order)."""
    from news_recsys_tpu_torch.training.sparse_step import (_dedup_rows,
                                                            dense_rowwise_adagrad_update)
    rng = np.random.default_rng(n)
    ids = rng.integers(1, 2000, n).astype(np.int32)
    ids[: n // 8] = 17
    g = rng.standard_normal((n, 16)).astype(np.float32)
    table = rng.standard_normal((2048, 16)).astype(np.float32)
    out = []
    for dev in (torch.device("cpu"), cuda, cuda):
        i, gg, t = on(dev, ids, g, table.copy())
        acc = torch.full((2048,), 0.1, device=dev)
        rows, sums = _dedup_rows(i, gg, 2047, max_id=1999)
        dense_rowwise_adagrad_update(t, acc, i, gg, 0.05, max_id=1999)
        out.append([x.cpu() for x in (rows, sums, t, acc)])
    cpu, first, again = out
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert torch.equal(first[0], cpu[0])
    for name, a, b in zip(("sums", "table", "accumulators"), first[1:], cpu[1:]):
        assert_close_to_scale(a, b, name)


# -- the training runtime: slabs, the metric engine, the host backend

@pytest.mark.cuda
@pytest.mark.parametrize("n,ties", [(200_000, False), (2_600_000, True)])
def test_device_metric_engine_repeats_its_bits_on_cuda(cuda, n, ties):
    """The device engine on the card: the same block twice, bit for bit, and
    the host engine's within abs 2e-5 (``User_Count`` exact); users of about
    37 rows, ties in the scores where ``ties``."""
    from news_recsys_tpu_torch.training.metrics import compute_user_metrics
    from news_recsys_tpu_torch.training.metrics_device import compute_user_metrics_device
    rng = np.random.default_rng(n)
    uids = rng.integers(1, n // 37 + 1, n)
    scores = rng.random(n).astype(np.float32)
    if ties:
        scores = np.round(scores * 5000) / 5000
    labels = (rng.random(n) < 0.08).astype(np.float32)
    warm = set(range(1, n // 74))
    first, again = (compute_user_metrics_device(uids, scores, labels, warm, device=cuda)
                    for _ in range(2))
    assert json.dumps(first, sort_keys=True) == json.dumps(again, sort_keys=True)
    want = compute_user_metrics(uids, scores, labels, warm)
    for cohort in want:
        for key, val in want[cohort].items():
            assert first[cohort][key] == (val if key == "User_Count" else
                                          pytest.approx(val, abs=2e-5)), (cohort, key)


@pytest.mark.cuda
def test_slab_path_equals_the_resident_path_on_cuda(cuda, tmp_path):
    """The DCN's sparse step for an epoch of 7 steps, slabs of 3 batches
    against the whole dataset on the card: the same states and scores bit
    for bit."""
    import dataclasses
    cfg = train_cfg(True)
    ds = train_dataset(cfg, 7 * 64 + 5, seed=50)
    packer = BatchPacker(ds)
    row = (packer.int_mat.nbytes + packer.float_mat.nbytes) / len(ds)
    slab = dataclasses.replace(cfg, train_hparams=dataclasses.replace(
        cfg.train_hparams, device_resident_bytes=int(row * 64 * 3) + 1))
    out = {}
    for name, c in (("resident", cfg), ("slab", slab)):
        t = Trainer(c, build_ranker(c, seed=2, device=cuda), workdir=str(tmp_path / name),
                    device=cuda)
        state = t.fit(ds, max_epochs=1)
        out[name] = ({k: v.cpu() for k, v in state.model.state_dict().items()},
                     {k: v.cpu() for k, v in state.emb_acc.items()}, t.predict(ds))
        assert (t._packer(ds)[1] is None) == (name == "slab")
    for a, b in zip(out["slab"][:2], out["resident"][:2]):
        for k in b:
            assert torch.equal(a[k], b[k]), k
    np.testing.assert_array_equal(out["slab"][2], out["resident"][2])


def backend_recommenders(cuda) -> tuple:
    """A small DSSM's ``Recommender`` on the card, once a backend, over 399
    items (ids 1..399), and the generator that drew the items."""
    from news_recsys_tpu_torch.models.dssm import build_dssm
    from news_recsys_tpu_torch.serving import Recommender
    raw = {"name": "dssm",
           "features": {"sparse_feature_names": ["user_id", "item_id", "category"],
                        "array_feature_names": ["hist"],
                        "item_feature_names": ["item_id", "category"],
                        "user_feature_names": ["user_id", "hist"],
                        "array_max_length": {"hist": 6}},
           "embeddings": {"embedding_size": {"user_id": 16, "item_id": 16, "category": 16},
                          "embedding_table_size": {"user_id": 64, "item_id": 400,
                                                   "category": 8},
                          "share_emb_table_features": {"hist": "item_id"}}}
    cfg = config_from_dict(raw)
    rng = np.random.default_rng(51)
    items = PackedDataset({"item_id": np.arange(1, 400, dtype=np.int32),
                           "category": rng.integers(1, 8, 399).astype(np.int32),
                           "label": np.zeros((399, 1), np.float32)})
    return {b: Recommender(cfg, build_dssm(cfg, seed=3, device=cuda), items, device=cuda,
                           backend=b) for b in ("auto", "host", "device")}, rng


def assert_same_but_near_ties(host, device, k):
    """The host backend's ids are the device backend's but where a score is
    within 1e-5 of a neighbour's; the scores within 1e-5."""
    (hi, hs), (di, ds_) = host, device
    assert len(hi) == len(di)
    for r in range(len(di)):
        np.testing.assert_allclose(hs[r], ds_[r], rtol=0, atol=1e-5)
        gaps = np.abs(np.diff(ds_[r]))
        for j in range(len(di[r])):
            near = (j > 0 and gaps[j - 1] <= 1e-5) or (j < k - 1 and gaps[j] <= 1e-5)
            assert near or hi[r][j] == di[r][j], (r, j)


@pytest.mark.cuda
def test_host_backend_on_a_card_recommender(cuda):
    """A Recommender on the card with ``backend="host"``: the user tower on
    the card, the search in C++ on a CPU copy of the corpus; the device
    backend's ids but for near ties, scores within 1e-5."""
    recs, rng = backend_recommenders(cuda)
    assert recs["auto"].backend == "device" and recs["host"].searcher.corpus is not None
    hist = rng.integers(1, 400, (32, 6)).astype(np.int32)
    batch = {"user_id": rng.integers(1, 64, 32).astype(np.int32), "hist": hist,
             "hist_mask": (hist != 0).astype(np.float32), "label": np.zeros((32, 1), np.float32)}
    hists = [[int(i) for i in row if i] for row in hist]
    assert_same_but_near_ties(*(recs[b].recommend(batch, k=10, histories=hists)
                                for b in ("host", "device")), k=10)


@pytest.mark.cuda
def test_backends_exclude_ragged_histories_alike(cuda):
    """Histories of 0-20 ids, some outside the corpus (0, 400 and above), a
    few repeated: the history exclusion on the card's tensors keeps the host
    backend's ids but for near ties, and both count the same ``recall.fetched``
    and ``recall.kept``."""
    from news_recsys_tpu_torch.utils import profiling

    recs, _ = backend_recommenders(cuda)
    rng = np.random.default_rng(53)
    n = 64
    hist = rng.integers(1, 400, (n, 6)).astype(np.int32)
    batch = {"user_id": rng.integers(1, 64, n).astype(np.int32), "hist": hist,
             "hist_mask": (hist != 0).astype(np.float32), "label": np.zeros((n, 1), np.float32)}
    top = recs["device"].recommend(batch, k=40)[0]
    hists = [[] if r % 7 == 0 else
             (rng.choice(top[r][:30], int(rng.integers(0, 16)), replace=False).tolist()
              + rng.choice([0, 400, 401, 10**9], int(rng.integers(0, 4))).tolist())
             for r in range(n)]
    hists[1] = top[1][:17] + [0, 400, top[1][3]]
    assert max(map(len, hists)) == 20 and min(map(len, hists)) == 0
    got, counts = {}, {}
    for b in ("host", "device"):
        profiling.clear()
        with profiling.recording():
            got[b] = recs[b].recommend(batch, k=10, histories=hists)
        counts[b] = next(s.counts for s in profiling.recorded().spans if s.name == "serve.recall")
    profiling.clear()
    assert counts["host"] == counts["device"]
    assert counts["device"]["recall.fetched"] == n * 30
    assert counts["device"]["recall.kept"] == n * 10
    assert_same_but_near_ties(got["host"], got["device"], k=10)
    for ids, h in zip(got["device"][0], hists):
        assert len(ids) == 10 and not set(ids) & set(h)


# -- the program's spans and counters ------------------------------------------


@pytest.mark.cuda
def test_recorded_steps_add_no_device_sync(cuda):
    """20 recorded sparse steps of the attention ranker at batch 512 raise
    no more sync warnings than 20 unrecorded ones: a count
    (``utils.profiling.count``) never waits for the card."""
    import contextlib
    import warnings

    from news_recsys_tpu_torch import zoo
    from news_recsys_tpu_torch.utils import profiling

    cfg = zoo.attention_config()
    model = build_ranker(cfg, seed=0, device=cuda)
    step, state = make_sparse_train_step(model, cfg), init_sparse_state(model, cfg)
    arrays = zoo.attention_arrays(cfg.dataset.batch_size, seed=1)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in arrays.items()}
    hist = AucHist.zeros(cuda)
    for _ in range(3):
        step(state, batch, hist)
    torch.cuda.synchronize()
    profiling.clear()
    found = []
    for on in (False, True):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with profiling.recording() if on else contextlib.nullcontext():
                    for _ in range(20):
                        step(state, batch, hist)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        found.append(sum("synchroniz" in str(w.message) for w in caught))
    spans = profiling.recorded().spans
    profiling.clear()
    assert sum(s.name == "train.step" for s in spans) == 20
    assert found[1] <= found[0], found


# -- multi-process training on the card -----------------------------------------------


def sharded_slots(rng, V, D, n=300):
    """Sorted global slots of a sharded step: below the table (-1), real rows
    (duplicates with equal gradients), out of every shard (2**29)."""
    ids = np.sort(rng.integers(1, V - 1, n))
    ids[1::9] = ids[0::9][: len(ids[1::9])]
    ids.sort()
    g = rng.standard_normal((n, D)).astype(np.float32)[np.searchsorted(ids, ids)]
    rows = np.concatenate([[-1] * 3, ids, [2 ** 29] * 4]).astype(np.int32)
    grads = np.concatenate([rng.standard_normal((3, D)), g,
                            rng.standard_normal((4, D))]).astype(np.float32)
    return rows, grads


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["rowwise_adagrad", "sparse_adamw"])
def test_sharded_update_kernel_matches_plain(cuda, opt):
    """Each shard of a model axis of 2 writes its rows on the card through the
    row scatter kernel, one launch a table (three on ``sparse_adamw``), bit
    for bit what the plain write gives there; foreign slots are dropped."""
    from news_recsys_tpu_torch.parallel.mesh import Mesh
    from news_recsys_tpu_torch.training import sparse_step as tss

    rng = np.random.default_rng(61)
    V, D = 4096, 32
    rows, grads = sharded_slots(rng, V, D)
    table = rng.standard_normal((V, D)).astype(np.float32)
    moments = [np.abs(rng.standard_normal((V, D))).astype(np.float32) * 0.01 for _ in range(2)]
    for s in range(2):
        mesh = Mesh(1, 2, rank=s, world=2)
        part = slice(*mesh.row_range(V))
        outs = []
        for write in (scatter_rows_set, scatter_rows_plain):
            if opt == "rowwise_adagrad":
                args = on(cuda, table[part].copy(), np.full(V // 2, 0.1, np.float32))
                update, hp = tss.make_sharded_adagrad_update(mesh), (0.05,)
            else:
                args = on(cuda, table[part].copy(), *(m[part].copy() for m in moments))
                update, hp = tss.make_sharded_rowwise_update(mesh), (1e-3, 2, 0.9, 0.999,
                                                                     1e-8, 0.01)
            before = scatter_rows_set.launches
            with torch.no_grad():
                update(*args, *on(cuda, rows, grads), *hp, write=write)
            torch.cuda.synchronize()
            launched = scatter_rows_set.launches - before
            assert launched == (0 if write is scatter_rows_plain
                                else 1 if opt == "rowwise_adagrad" else 3)
            outs.append([a.cpu() for a in args])
        for k, p in zip(*outs):
            assert torch.equal(k, p)
        local = rows.astype(np.int64) - part.start
        untouched = np.setdiff1d(np.arange(V // 2), local[(local >= 0) & (local < V // 2)])
        assert torch.equal(outs[0][0][untouched], torch.from_numpy(table[part][untouched]))


def gloo_worker(rank):
    """Collectives of CUDA tensors over gloo (staged through the host) and
    the id exchange on the card, two ranks on one card."""
    from news_recsys_tpu_torch.parallel.mesh import Mesh
    from news_recsys_tpu_torch.parallel.sharded_embedding import sharded_lookup

    dev = torch.device("cuda", 0)
    mesh = Mesh(1, 2)
    sends = [1, 2] if rank == 0 else [3, 0]
    x = (torch.arange(sum(sends), device=dev) + 10 * rank).float()
    a2a = mesh.all_to_all(x, [1, 3] if rank == 0 else [2, 0], sends, "model")
    gathered = mesh.all_gather(torch.full((2, 3), float(rank), device=dev), "model")
    summed = mesh.all_reduce_(torch.full((4,), rank + 1.0, device=dev), "model")
    table = torch.arange(512 * 4, dtype=torch.float32).view(512, 4)
    shard = table[slice(*mesh.row_range(512))].to(dev)
    ids = torch.tensor([0, 5, 300, 511, 256, 255, 512], device=dev)
    rows = sharded_lookup(shard, ids, mesh)
    return {"devices": [str(t.device) for t in (a2a, gathered, summed, rows)],
            "a2a": a2a.cpu(), "gathered": gathered.cpu(), "summed": summed.cpu(),
            "rows": rows.cpu(), "copies": mesh.stats.host_copies,
            "bytes": mesh.stats.host_bytes, "calls": mesh.stats.calls}


@pytest.mark.cuda
def test_gloo_stages_cuda_collectives_through_the_host(cuda, tmp_path):
    """Gloo takes CUDA tensors for all_reduce only: the helpers carry an
    all-to-all and an all-gather through the host (counted), and the
    results, the exchange's rows too, come back on the card with the
    values one process computes."""
    from news_recsys_tpu_torch.parallel.distributed import spawn_ranks

    got = spawn_ranks(gloo_worker, 2, init_method=f"file://{tmp_path}/store", backend="gloo",
                      device="cuda:0", timeout=240, group_timeout=120)
    assert torch.equal(got[0]["a2a"], torch.tensor([0.0, 10.0, 11.0, 12.0]))
    assert torch.equal(got[1]["a2a"], torch.tensor([1.0, 2.0]))
    table = torch.arange(512 * 4, dtype=torch.float32).view(512, 4)
    for r in got:
        assert set(r["devices"]) == {"cuda:0"}
        assert torch.equal(r["gathered"], torch.tensor([[0.0] * 3] * 2 + [[1.0] * 3] * 2))
        assert torch.equal(r["summed"], torch.full((4,), 3.0))
        want = table[[0, 5, 300, 511, 256, 255, 0]]
        assert torch.equal(r["rows"][:6], want[:6]) and r["rows"][6].isnan().all()
        # an all-to-all and an all-gather a copy down and one up each; the
        # exchange's three all-to-alls the same
        assert r["copies"] == 2 * 5 and r["bytes"] > 0 and r["calls"] == 6


def nccl_worker(rank):
    import torch.distributed as dist

    t = torch.full((8,), 2.0, device="cuda:0")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return dist.get_backend(), t.cpu()


@pytest.mark.cuda
def test_one_rank_nccl_group(cuda, tmp_path):
    """The default backend on the card: a one-rank NCCL group starts and
    all-reduces a tensor on the card. (Two ranks need two cards: NCCL
    refuses two ranks on one.)"""
    from news_recsys_tpu_torch.parallel.distributed import default_backend, spawn_ranks

    assert default_backend("cuda") == "nccl"
    (backend, t), = spawn_ranks(nccl_worker, 1, init_method=f"file://{tmp_path}/store",
                                backend="nccl", device="cuda:0", timeout=240,
                                group_timeout=120)
    assert backend == "nccl" and torch.equal(t, torch.full((8,), 2.0))


# -- the roofline counter: each kernel's cost, on the card as on the CPU ------------


def counted_kernel_cases(dev) -> dict:
    """Each kernel's wrapper on small inputs on ``dev``, by case: a callable
    that builds (the kernel's name, a call of the wrapper, its cost function's
    count of that call). ``_grad`` cases take inputs that require grad (the
    cross stack's forward then writes its residuals); ``block_tiled`` cases
    take the ranker's widths, the tiled route, whose products run in TF32."""
    from news_recsys_tpu_torch.ops.dcn_kernel import cross_bwd_cost, cross_cost
    from news_recsys_tpu_torch.ops.fm_kernel import fm_bwd_cost, fm_cost
    from news_recsys_tpu_torch.ops.fused_attention import block_bwd_cost, block_cost
    from news_recsys_tpu_torch.ops.fused_lookup_pool import pool_bwd_cost, pool_cost
    from news_recsys_tpu_torch.ops.scatter_rows import scatter_cost

    def t(*arrays, grad=False):
        return [torch.from_numpy(np.asarray(a)).to(dev).requires_grad_(grad) for a in arrays]

    def cross(grad):
        x0, ws, bs = t(*cross_inputs(48, 24, 3), grad=grad)
        return "dcn_cross_stack", lambda: dcn_cross_stack(x0, ws, bs), cross_cost(48, 24, 3, grad)

    def cross_bwd():
        rng = np.random.default_rng(1)
        x0, ws, bs, ss, g = t(*cross_inputs(48, 24, 3), rng.standard_normal((3, 48), np.float32),
                              rng.standard_normal((48, 24), np.float32))
        return "dcn_cross_bwd", lambda: dcn_cross_bwd(x0, ws, bs, ss, g), cross_bwd_cost(48, 24, 3)

    def fm(grad):
        (v,) = t(fm_inputs(40, 5, 15)[0], grad=grad)
        return "fm_second_order", lambda: fm_second_order(v), fm_cost(40, 5, 15)

    def fm_bwd():
        v, g = t(*fm_inputs(40, 5, 15))
        return "fm_second_order_bwd", lambda: fm_second_order_bwd(v, g), fm_bwd_cost(40, 5, 15)

    def scatter():
        table, rows, vals = scatter_inputs(300, 8, 64)
        rows[-3:] = 400                             # outside the table: dropped, not counted
        distinct = int(np.unique(rows[rows < 300]).size)
        table, rows, vals = t(table, rows, vals)
        return ("scatter_rows_set", lambda: scatter_rows_set(table, rows, vals),
                scatter_cost(64, 8, distinct))

    def pool(grad):
        table, ids, mask = pool_inputs(200, 8, 24, 6)
        rows = int(np.unique(ids[(mask * (ids != 0)) > 0]).size)
        (table,), (ids, mask) = t(table, grad=grad), t(ids, mask)
        return ("fused_lookup_pool", lambda: fused_lookup_pool(table, ids, mask),
                pool_cost(24, 6, 8, rows))

    def pool_bwd():
        _, ids, mask = pool_inputs(200, 8, 24, 6)
        ids, mask, g = t(ids, mask, np.random.default_rng(2).standard_normal((24, 8), np.float32))
        return ("fused_lookup_pool_bwd", lambda: fused_lookup_pool_bwd(ids, mask, g, 200),
                pool_bwd_cost(24, 6, 8, 200))

    def block(grad, shape=(6, 10, 16, 24), units="float32"):
        x, mask, params, _ = block_inputs(*shape)
        params, (x,), (mask,) = t(*params, grad=grad), t(x, grad=grad), t(mask)
        return ("fused_transformer_block", lambda: fused_transformer_block(params, x, mask, 2),
                block_cost(*shape, units))

    def block_bwd(shape=(6, 10, 16, 24), units="float32"):
        x, mask, params, dy = block_inputs(*shape)
        params, (x, mask, dy) = t(*params), t(x, mask, dy)
        return ("fused_transformer_block_bwd",
                lambda: fused_transformer_block_bwd(params, x, mask, dy, 2),
                block_bwd_cost(*shape, units))

    tiled = dict(shape=(4, 30, 32, 64), units="tf32")

    return {"cross": lambda: cross(False), "cross_grad": lambda: cross(True),
            "cross_bwd": cross_bwd, "fm": lambda: fm(False), "fm_grad": lambda: fm(True),
            "fm_bwd": fm_bwd, "scatter": scatter, "pool": lambda: pool(False),
            "pool_grad": lambda: pool(True), "pool_bwd": pool_bwd,
            "block": lambda: block(False), "block_grad": lambda: block(True),
            "block_bwd": block_bwd, "block_tiled": lambda: block(False, **tiled),
            "block_tiled_bwd": lambda: block_bwd(**tiled)}


COUNTED_CASES = ("cross", "cross_grad", "cross_bwd", "fm", "fm_grad", "fm_bwd", "scatter",
                 "pool", "pool_grad", "pool_bwd", "block", "block_grad", "block_bwd",
                 "block_tiled", "block_tiled_bwd")


@pytest.mark.cuda
@pytest.mark.parametrize("case", COUNTED_CASES)
def test_a_kernel_launch_adds_its_cost_only_under_a_counter(cuda, case):
    """A launch with no counter open counts nothing; under ``step_cost`` it
    adds its cost function's count and no aten op, as its plain version does
    on the CPU."""
    from news_recsys_tpu_torch import ops
    from news_recsys_tpu_torch.utils.roofline import step_cost

    name, call, want = counted_kernel_cases(cuda)[case]()
    wrapper = {f.__name__: f for f in (dcn_cross_stack, dcn_cross_bwd, fm_second_order,
                                       fm_second_order_bwd, scatter_rows_set,
                                       fused_lookup_pool, fused_lookup_pool_bwd,
                                       fused_transformer_block,
                                       fused_transformer_block_bwd)}[name]
    before = wrapper.launches
    call()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and ops.open_counter() is None
    cost = step_cost(call)
    assert wrapper.launches == before + 2
    assert cost["kernels"] == {name: {"calls": 1, "flops": want.flops, "bytes": want.bytes}}
    assert cost["flops_by_units"] == ({want.units: want.flops} if want.flops else {})
    assert cost["ops"] == {}
    assert step_cost(counted_kernel_cases(torch.device("cpu"))[case]()[1]) == cost


@pytest.mark.cuda
def test_dcn_step_counts_on_cuda_as_on_cpu(cuda):
    """One warm sparse step of the narrow DCN, counted on the card and on the
    CPU from the same state and batch: the same FLOPs (all on the float32
    units), kernels and bytes, op by op. The CPU's AdamW takes the foreach form the card takes by default
    (its for-loop reads no 0-d tensor 1 for the step counts: 4 bytes)."""
    from news_recsys_tpu_torch.utils.roofline import step_cost

    cfg = train_cfg(True)
    packer = BatchPacker(train_dataset(cfg, 256, seed=3))
    cpu_model = build_ranker(cfg, seed=0, device="cpu")
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to(cuda)}
    costs = {}
    for d, model in models.items():
        dev = torch.device(d)
        state = init_sparse_state(model, cfg)
        for group in state.dense_opt.param_groups:
            group["foreach"] = True
        step = make_sparse_train_step(model, cfg)
        warm, counted = (unpack_batch(torch.from_numpy(packer.int_mat[rows]).to(dev),
                                      torch.from_numpy(packer.float_mat[rows]).to(dev),
                                      torch.ones(64, device=dev), packer.layout_key())
                         for rows in (np.arange(64), np.arange(64, 128)))
        step(state, warm, AucHist.zeros(dev))
        costs[d] = step_cost(step, copy.deepcopy(state), counted, AucHist.zeros(dev))
    assert costs["cuda"]["flops"] == costs["cpu"]["flops"] > 0
    assert costs["cuda"]["kernels"] == costs["cpu"]["kernels"]
    assert sorted(costs["cuda"]["kernels"]) == ["dcn_cross_bwd", "dcn_cross_stack",
                                                "scatter_rows_set"]
    assert costs["cuda"]["ops"] == costs["cpu"]["ops"]
    assert costs["cuda"]["bytes"] == costs["cpu"]["bytes"]
    assert costs["cuda"]["flops_by_units"] == costs["cpu"]["flops_by_units"] == {
        "float32": costs["cpu"]["flops"]}


@pytest.mark.cuda
def test_nrms_step_on_cuda_matches_cpu(cuda):
    """NRMS at its published widths (a title table over 2,000 articles,
    batch 16 of 1 + 4 candidates): the card's logits, loss and gradients
    against the CPU's, then one AdamW step through the all-dense step on
    each. Each gradient and each change is held, as in
    ``tests/test_torch_nrms.py``, against the larger of its leaf's size and
    the median leaf's: a cancelling leaf (an additive pooling's bias) keeps
    only the rounding of its terms, and Adam's first step is near
    ``lr sign(g)``, which that rounding flips where g is near 0."""
    import statistics

    from news_recsys_tpu_torch import zoo
    from news_recsys_tpu_torch.config import config_to_dict
    from news_recsys_tpu_torch.training import dense_step

    raw = config_to_dict(zoo.mind_nrms_config(batch_size=16))
    raw["nrms_cfg"]["articles"] = 2000
    cfg = config_from_dict(raw)
    rng = np.random.default_rng(4)
    titles = rng.integers(1, 40000, (2000, 30)).astype(np.int32)
    titles[np.arange(30)[None, :] >= rng.integers(1, 31, 2000)[:, None]] = 0
    titles[0] = 0
    hist = rng.integers(1, 2000, (16, 50)).astype(np.int32)
    hist[np.arange(50)[None, :] >= rng.integers(0, 51, 16)[:, None]] = 0
    label = np.zeros((16, 5), np.float32)
    label[:, 0] = 1
    arrays = {"hist": hist, "item_id": rng.integers(1, 2000, (16, 5)).astype(np.int32),
              "label": label}
    out = {}
    for dev in ("cpu", cuda):
        model = build_ranker(cfg, seed=7, device=dev)
        model.set_titles(torch.from_numpy(titles))
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        batch = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        loss, logits, _, _ = dense_step.loss_fn(model, batch, kind="listwise")
        grads = dict(zip(p0, torch.autograd.grad(loss, list(model.parameters()))))
        state = dense_step.init_dense_state(model, cfg)
        dense_step.make_train_step(model, cfg)(state, batch, AucHist.zeros(dev))
        out[str(dev)] = {"loss": float(loss), "logits": logits.detach().cpu(),
                         "grads": {n: g.cpu() for n, g in grads.items()},
                         "change": {n: (p.detach() - p0[n]).cpu()
                                    for n, p in model.named_parameters()}}

    def gaps(got, want, size):
        sizes = {n: float(size(w)) for n, w in want.items()}
        floor = statistics.median(sizes.values())
        return {n: float(size(got[n] - want[n])) / max(sizes[n], floor) for n in want}

    card, cpu = out["cuda"], out["cpu"]
    assert_close_to_scale(card["logits"], cpu["logits"], "logits")
    assert abs(card["loss"] - cpu["loss"]) <= 1e-5 * abs(cpu["loss"])
    assert max(gaps(card["grads"], cpu["grads"], lambda t: t.abs().max()).values()) <= 2e-5
    assert max(gaps(card["change"], cpu["change"], torch.linalg.vector_norm).values()) <= 1e-2


# NRMS's masked attention (ops/mhsa.py): the news encoder's and the user
# encoder's shapes, the domain's corners (L 128 with head_dim 64, L 1), a
# row of 33 (two warps a head) with 3 heads of 8
MHSA_SHAPES = [(3520, 30, 16, 16), (64, 50, 16, 16), (6, 128, 4, 64), (9, 1, 16, 16),
               (7, 33, 3, 8)]


def mhsa_inputs(N, L, H, hd, dev, seed=0):
    """qkv N(0, 1) (scores of order 1), dO, and a mask with trailing padding,
    interior padding (row 2) and a row with no kept key (row 3)."""
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((N, L, 3 * H * hd)).astype(np.float32)
    g = rng.standard_normal((N, L, H * hd)).astype(np.float32)
    n = rng.integers(1, L + 1, N)
    n[0] = L
    mask = np.arange(L)[None, :] < n[:, None]
    if N > 3:
        mask[2] = rng.random(L) < 0.5
        mask[2, 0] = True
        mask[3] = False
    qkv, g = on(dev, qkv, g)
    return qkv, torch.from_numpy(mask).to(dev), g


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MHSA_SHAPES)
def test_mhsa_kernels_match_plain(cuda, shape):
    """Forward and backward against the plain chain on the card, each twice
    with the same bits, one launch each."""
    from news_recsys_tpu_torch.ops.mhsa import (masked_mhsa, masked_mhsa_bwd,
                                                masked_mhsa_bwd_plain, masked_mhsa_plain)

    N, L, H, hd = shape
    qkv, mask, g = mhsa_inputs(*shape, cuda)
    n = masked_mhsa.launches, masked_mhsa_bwd.launches
    with torch.no_grad():
        out = masked_mhsa(qkv, mask, H)
    dqkv = masked_mhsa_bwd(qkv, mask, g, H)
    assert (masked_mhsa.launches - n[0], masked_mhsa_bwd.launches - n[1]) == (1, 1)
    assert_close_to_scale(out, masked_mhsa_plain(qkv, mask, H), "out")
    assert_close_to_scale(dqkv, masked_mhsa_bwd_plain(qkv, mask, g, H), "dqkv")
    with torch.no_grad():
        assert torch.equal(masked_mhsa(qkv, mask, H), out)
    assert torch.equal(masked_mhsa_bwd(qkv, mask, g, H), dqkv)


@pytest.mark.cuda
def test_mhsa_module_adds_no_wait(cuda):
    """``SelfAttention``'s forward and backward on the card, the kernels'
    path, under the sync debug mode's errors: nothing waits for the device."""
    from news_recsys_tpu_torch.models.nrms import SelfAttention

    attn = SelfAttention(300, 16, 16, torch.Generator().manual_seed(0)).to(cuda)
    rng = np.random.default_rng(1)
    (x,) = on(cuda, rng.standard_normal((64, 30, 300)).astype(np.float32))
    mask = torch.from_numpy(rng.random((64, 30)) < 0.6).to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        attn(x, mask).square().sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert attn.wqkv.grad is not None and bool(torch.isfinite(attn.wqkv.grad).all())


@pytest.mark.cuda
def test_mhsa_refuses_what_the_kernels_do_not_take(cuda):
    from news_recsys_tpu_torch.ops.mhsa import masked_mhsa

    for shape in ((2, 129, 2, 16), (2, 30, 2, 12)):
        qkv, mask, _ = mhsa_inputs(*shape, cuda)
        with pytest.raises(ValueError):
            masked_mhsa(qkv, mask, shape[2])
    qkv, mask, _ = mhsa_inputs(2, 30, 2, 16, cuda)
    with pytest.raises(TypeError):
        masked_mhsa(qkv.double(), mask, 2)


@pytest.mark.cuda
def test_nrms_step_launches_mhsa_twice(cuda):
    """One NRMS training step on the card: the attention's forward and
    backward once for each encoder, and no bmm or softmax in the step."""
    from news_recsys_tpu_torch import zoo
    from news_recsys_tpu_torch.config import config_to_dict
    from news_recsys_tpu_torch.ops.mhsa import masked_mhsa, masked_mhsa_bwd
    from news_recsys_tpu_torch.training import dense_step

    raw = config_to_dict(zoo.mind_nrms_config(batch_size=8))
    raw["nrms_cfg"]["articles"] = 500
    cfg = config_from_dict(raw)
    rng = np.random.default_rng(2)
    titles = rng.integers(1, 40000, (500, 30)).astype(np.int32)
    titles[np.arange(30)[None, :] >= rng.integers(1, 31, 500)[:, None]] = 0
    titles[0] = 0
    label = np.zeros((8, 5), np.float32)
    label[:, 0] = 1
    batch = {"hist": rng.integers(0, 500, (8, 50)).astype(np.int32),
             "item_id": rng.integers(1, 500, (8, 5)).astype(np.int32), "label": label}
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()}
    model = build_ranker(cfg, seed=3, device=cuda)
    model.set_titles(torch.from_numpy(titles))
    state = dense_step.init_dense_state(model, cfg)
    step = dense_step.make_train_step(model, cfg)
    step(state, batch, AucHist.zeros(cuda))                 # warm-up
    torch.cuda.synchronize()
    n = masked_mhsa.launches, masked_mhsa_bwd.launches
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        step(state, batch, AucHist.zeros(cuda))
        torch.cuda.synchronize()
    assert (masked_mhsa.launches - n[0], masked_mhsa_bwd.launches - n[1]) == (2, 2)
    # the chain's scores were (N, 16, L, L) and its products (16 N, L, L):
    # no op of the step sees an L x L tensor of either encoder
    scores = [(e.name, e.input_shapes) for e in prof.events()
              if any(len(s) >= 3 and s[-2:] in ([30, 30], [50, 50]) for s in e.input_shapes)]
    assert not scores, scores
