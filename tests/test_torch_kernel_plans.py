"""The FM kernels' launch plans, and the row scatter's and the FM forward's
plain versions against the JAX package on the layouts the main paths give
them.

The CUDA kernels cannot run here. What surrounds them can: the pure-Python
plans that ``csrc/fm_second_order.cu`` follows (the path, rows a block and
shared memory), the scatter's layouts, and the plain versions, which are the
kernels' oracles on the card.
JAX runs its Pallas kernels in interpret mode (``interpret=True`` or
``NRT_PALLAS=interpret``) and its XLA fallbacks. The scatter moves bits and
is held to equality; the FM second order sums in another order than XLA:
rtol 1e-6 and an atol of 1e-6 of the largest value.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recsys_tpu.ops import fm_kernel as jfm
from news_recsys_tpu.ops import scatter_rows as jscatter
from news_recsys_tpu_torch.config import config_from_dict, config_to_dict
from news_recsys_tpu_torch.ops.fm_kernel import (FM_BWD_ROWS, FM_GENERAL_ROWS, FM_LANES, FM_ROWS,
                                                 FmPlan, fm_plain, plan_fm_bwd, plan_fm_fwd)
from news_recsys_tpu_torch.ops.scatter_rows import last_of_run, scatter_rows_plain
from news_recsys_tpu_torch.training.scatter_layouts import (arena_scatter_case,
                                                            attention_scatter_layouts,
                                                            scatter_layout_stats)
from news_recsys_tpu_torch.zoo import attention_config

torch.set_num_threads(2)
FM_TOL = 1e-6


# -- the row scatter -------------------------------------------------------------


def small_attention_config():
    """``attention_config()`` at batch 512 with user and item tables of
    5,000 and 4,500 ids (large enough for the rowwise path; padded to 5,120
    and 4,608 rows, multiples of the Pallas kernel's 8-row slab)."""
    raw = config_to_dict(attention_config(batch_size=512))
    raw["embeddings"]["embedding_table_size"].update(user_id=5000, item_id=4500)
    return config_from_dict(raw)


def small_attention_arrays(seed: int) -> dict:
    """One batch of 512 shaped like ``zoo.attention_arrays`` over the small
    tables: ``hist`` of 30 with padding id 0, every 7th history emptied."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 4500, (512, 30)).astype(np.int32)
    hist[::7] = 0
    return {"user_id": rng.integers(1, 5000, 512).astype(np.int32),
            "item_id": rng.integers(1, 4500, 512).astype(np.int32),
            "category": rng.integers(1, 10, 512).astype(np.int32),
            "hist": hist, "hist_mask": (hist != 0).astype(np.float32),
            "label": (rng.random(512) < 0.1).astype(np.float32).reshape(-1, 1)}


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_plain_on_the_attention_layout_matches_jax_pallas(seed):
    """The sparse attention step's two scatters, laid out by the port's own
    ``_joint_dedup`` (16,384 slots each, the other table's clamped to row 0
    or the spare row): the plain version equals JAX's Pallas kernel
    interpreted, bit for bit."""
    layouts = attention_scatter_layouts(small_attention_config(), small_attention_arrays(seed),
                                        seed)
    assert sorted(layouts) == ["item_id", "user_id"]
    for name, (table, rows, vals) in layouts.items():
        assert rows.shape == (16384,) and table.shape[0] in (4608, 5120)
        stats = scatter_layout_stats(rows, table.shape[0])
        assert stats["out_of_range"] == 0 and stats["longest_run"] > 500
        want = pallas_scatter(table, rows, vals)
        got = scatter_rows_plain(torch.from_numpy(table.copy()), torch.from_numpy(rows),
                                 torch.from_numpy(vals))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_scatter_plain_off_contract_keeps_the_last_slot_as_pallas_does():
    """Duplicates with different values: the plain version keeps each run's
    last slot, as the Pallas grid's order does."""
    rng = np.random.default_rng(2)
    table = rng.standard_normal((256, 16)).astype(np.float32)
    rows = np.sort(rng.integers(0, 256, 300)).astype(np.int32)
    vals = rng.standard_normal((300, 16)).astype(np.float32)
    got = scatter_rows_plain(torch.from_numpy(table.copy()), torch.from_numpy(rows),
                             torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), pallas_scatter(table, rows, vals))
    last = np.flatnonzero(last_of_run(torch.from_numpy(rows)).numpy())
    np.testing.assert_array_equal(got.numpy()[rows[last]], vals[last])


def pallas_scatter(table, rows, vals):
    return np.asarray(jscatter.scatter_rows_set(jnp.array(table), jnp.asarray(rows),
                                                jnp.asarray(vals), use_pallas=True,
                                                interpret=True))


@pytest.mark.parametrize("contract", [True, False], ids=["contract", "off-contract"])
@pytest.mark.parametrize("run", [1, 2, 7, 8, 9, 33, 200])
def test_scatter_plain_matches_jax_pallas_over_runs(run, contract):
    """200 slots in runs of ``run`` equal rows over a table of 512 (the last
    run cut short); under the contract each run carries one value, off it
    every slot its own, and the last slot of a run wins in both."""
    rng = np.random.default_rng(run)
    table = rng.standard_normal((512, 8)).astype(np.float32)
    rows = np.repeat(np.sort(rng.choice(512, -(-200 // run), replace=False)), run)[:200]
    rows = rows.astype(np.int32)
    vals = rng.standard_normal((200, 8)).astype(np.float32)
    if contract:
        vals = vals[np.searchsorted(rows, rows)]
    got = scatter_rows_plain(torch.from_numpy(table.copy()), torch.from_numpy(rows),
                             torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), pallas_scatter(table, rows, vals))


def test_arena_scatter_case_is_the_dedup_layout():
    """The DCN arena's case: sorted in-range rows, a duplicate every 7th
    slot, equal rows carrying equal values."""
    table, rows, vals = arena_scatter_case(0)
    assert table.shape == (159360, 32) and rows.shape == (1024,) and vals.shape == (1024, 32)
    assert (np.diff(rows) >= 0).all()
    stats = scatter_layout_stats(rows, table.shape[0])
    assert stats["out_of_range"] == 0 and 1024 - stats["distinct_rows"] >= 1024 // 7 - 1
    np.testing.assert_array_equal(vals, vals[np.searchsorted(rows, rows)])


@pytest.mark.parametrize("rows,want", [
    ([], []), ([3], [True]), ([3, 3], [False, True]), ([0, 0, 1, 2, 2, 2], [0, 1, 1, 0, 0, 1]),
    ([-1, -1, 5, 9, 9], [0, 1, 1, 0, 1])])
def test_last_of_run(rows, want):
    got = last_of_run(torch.tensor(rows, dtype=torch.long))
    assert got.tolist() == [bool(w) for w in want]


# -- the FM forward ----------------------------------------------------------------


@pytest.mark.parametrize("B,plan", [
    (6400, FmPlan("staged", 32, 256, 200, 9616)),         # a DeepFM request
    (512, FmPlan("staged", 32, 256, 16, 9616)),           # a DeepFM step, a validation batch
    (1, FmPlan("staged", 32, 256, 1, 9616)),
    (511, FmPlan("staged", 32, 256, 16, 9616)),
    (6401, FmPlan("staged", 32, 256, 201, 9616)),
])
def test_plan_fm_fwd_at_the_deepfm_shapes(B, plan):
    assert plan_fm_fwd(B, 5, 15) == plan


@pytest.mark.parametrize("B", [1, 37, 511, 512, 6400, 6401, 100000])
@pytest.mark.parametrize("F,D", [(1, 15), (5, 15), (5, 16), (5, 33), (5, 64), (1, 64), (16, 16),
                                 (4, 15), (1, 75), (15, 5), (5, 14), (39, 64), (0, 15),
                                 (200, 1), (64, 3)])
def test_plan_fm_fwd_fits_its_kernel(B, F, D):
    """DeepFM's 5 x 15 takes the staged path, every other shape the general
    one; a staged block is 32 rows of 8 lanes, 256 threads, whose span (and
    3 floats in front) fits in 48 KB of shared memory, so it needs no
    attribute, and starts on 16 bytes when ``v`` does; the blocks cover B."""
    plan = plan_fm_fwd(B, F, D)
    assert (plan.blocks - 1) * plan.rows < B <= plan.blocks * plan.rows
    if (F, D) != (5, 15):
        assert plan == FmPlan("general", FM_GENERAL_ROWS, 32 * FM_GENERAL_ROWS,
                              -(-B // FM_GENERAL_ROWS), 0)
        return
    assert plan[:3] == ("staged", FM_ROWS, FM_ROWS * FM_LANES) == ("staged", 32, 256)
    assert plan.rows * F * D * 4 % 16 == 0
    assert plan.smem_bytes % 16 == 0 and 4 * (plan.rows * F * D + 3) <= plan.smem_bytes
    assert plan.smem_bytes < 4 * (plan.rows * F * D + 3) + 16 and plan.smem_bytes <= 48 * 1024


# -- the FM backward ---------------------------------------------------------------


@pytest.mark.parametrize("B,plan", [
    (6400, FmPlan("staged", 8, 160, 800, 2928)),         # a batch of 6,400
    (512, FmPlan("staged", 8, 160, 64, 2928)),           # a DeepFM step
    (1, FmPlan("staged", 8, 160, 1, 2928)),
    (3, FmPlan("staged", 8, 160, 1, 2928)),
])
def test_plan_fm_bwd_at_the_deepfm_shapes(B, plan):
    """The shipped block: 8 rows, 150 float4s of span on 160 threads; the
    span of 600 floats and 3 in front (2,416 bytes), g's 8 values and the
    table of 8 x 15 sums."""
    assert plan_fm_bwd(B, 5, 15) == plan


@pytest.mark.parametrize("B", [1, 3, 37, 511, 512, 6400, 6401, 100000])
@pytest.mark.parametrize("F,D", [(1, 15), (5, 15), (5, 16), (5, 33), (5, 64), (16, 16),
                                 (4, 15), (1, 75), (15, 5), (5, 14), (0, 15), (200, 1)])
def test_plan_fm_bwd_fits_its_kernel(B, F, D):
    """DeepFM's 5 x 15 takes the staged path, every other shape the general
    one (a warp a row, as the first design); a staged block's rows fill whole
    float4s, its threads hold a float4 of its span each in whole warps, its
    shared memory (span, 3 floats in front, g's values and the table of
    sums) fits 48 KB, so it needs no attribute; the blocks cover B."""
    plan = plan_fm_bwd(B, F, D)
    assert (plan.blocks - 1) * plan.rows < B <= plan.blocks * plan.rows
    if (F, D) != (5, 15):
        assert plan == FmPlan("general", FM_GENERAL_ROWS, 32 * FM_GENERAL_ROWS,
                              -(-B // FM_GENERAL_ROWS), 0)
        return
    assert plan.path == "staged" and plan.rows == FM_BWD_ROWS and plan.rows % 4 == 0
    span4 = plan.rows * F * D // 4
    assert plan.threads % 32 == 0 and plan.threads - 32 < span4 <= plan.threads
    want = 4 * (plan.rows * F * D + 3) + 4 * plan.rows * (1 + D)
    assert want <= plan.smem_bytes < want + 16 and plan.smem_bytes <= 48 * 1024


@pytest.mark.parametrize("name,value", [("kBwdRows", str(FM_BWD_ROWS)), ("kRows", str(FM_ROWS)),
                                        ("kLanes", str(FM_LANES))])
def test_fm_plans_follow_the_kernel_source(name, value):
    """The constants the plans state are the ones ``csrc/fm_second_order.cu``
    is built with."""
    src = (Path(__file__).parent.parent / "news_recsys_tpu_torch" / "csrc" /
           "fm_second_order.cu").read_text()
    assert re.findall(rf"constexpr \w+ {name} = (\w+);", src) == [value]


@pytest.mark.parametrize("mode", ["interpret", ""], ids=["pallas", "xla"])
@pytest.mark.parametrize("B", [300, 6401, 512])
def test_fm_plain_matches_jax_at_the_deepfm_width(monkeypatch, mode, B):
    """F 5, D 15: B 300 and 6,401 (not multiples of the Pallas tile of 256)
    take JAX's XLA fallback in both modes, B 512 its Pallas kernel
    interpreted."""
    monkeypatch.setenv("NRT_PALLAS", mode)
    v = np.random.default_rng(B).standard_normal((B, 5, 15)).astype(np.float32)
    want = np.asarray(jfm.fm_second_order(jnp.asarray(v)))
    got = fm_plain(torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=FM_TOL, atol=FM_TOL * np.abs(want).max())
