"""The port's kernel ops against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode (``NRT_PALLAS=interpret``,
set per test) and its XLA references. Tolerance rtol = atol = 1e-5: both
sides are float32, summed in a different order. The kernels themselves run in
tests/test_torch_cuda.py, on a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recsys_tpu.ops import dcn_kernel as jdcn
from news_recsys_tpu.ops import fused_lookup_pool as jpool
from news_recsys_tpu.ops import scatter_rows as jscatter
from news_recsys_tpu.ops.topk import TopKSearcher as JTopKSearcher
from news_recsys_tpu_torch.ops import _build
from news_recsys_tpu_torch.ops.dcn_kernel import (cross_plain, dcn_cross_stack,
                                                  reference_cross_stack)
from news_recsys_tpu_torch.ops.dcn_kernel import dcn_cross_bwd
from news_recsys_tpu_torch.ops.fused_lookup_pool import fused_lookup_pool
from news_recsys_tpu_torch.ops.scatter_rows import scatter_rows_plain, scatter_rows_set
from news_recsys_tpu_torch.ops.topk import TopKSearcher

from tests.test_torch_cuda import cross_inputs, pool_inputs, scatter_inputs

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("NRT_PALLAS", "interpret")


@pytest.mark.parametrize("B,D,NL", [(64, 112, 3), (32, 24, 2)])
def test_dcn_cross_stack_matches_jax(pallas_interpret, B, D, NL):
    x0, ws, bs = cross_inputs(B, D, NL)
    got = dcn_cross_stack(torch.from_numpy(x0), torch.from_numpy(ws), torch.from_numpy(bs))
    want = np.asarray(jdcn.dcn_cross_stack(x0, ws, bs))       # Pallas body, interpreted
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jdcn.reference_cross_stack(x0, ws, bs)), **TOL)
    np.testing.assert_allclose(
        reference_cross_stack(*map(torch.from_numpy, (x0, ws, bs))).numpy(), want, **TOL)


@pytest.mark.parametrize("V,D,B,L", [(300, 16, 32, 30), (64, 40, 16, 5)])
def test_fused_lookup_pool_matches_jax(pallas_interpret, V, D, B, L):
    table, ids, mask = pool_inputs(V, D, B, L)
    got = fused_lookup_pool(*map(torch.from_numpy, (table, ids, mask))).numpy()
    want = np.asarray(jpool.fused_lookup_pool(jnp.asarray(table), ids, mask))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jpool.reference_lookup_pool(table, ids, mask)), **TOL)
    np.testing.assert_array_equal(got[1], 0.0)      # all padding ids
    np.testing.assert_array_equal(got[2], 0.0)      # all-zero mask


def test_lookup_pool_ids_out_of_range_give_nan():
    """The port's contract: an id >= V makes the pooled row NaN whatever its
    mask, as the JAX package's XLA gather does. (The Pallas kernel in
    interpret mode clamps such ids instead.)"""
    table, ids, mask = pool_inputs(50, 8, 8, 4)
    ids[3, 1], mask[3, 1] = 50, 1.0
    ids[5, 2], mask[5, 2] = 1000, 0.0
    got = fused_lookup_pool(*map(torch.from_numpy, (table, ids, mask))).numpy()
    want = np.asarray(jpool.reference_lookup_pool(table, ids, mask))
    assert np.isnan(got[3]).all() and np.isnan(got[5]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], **TOL)


@pytest.mark.parametrize("fn,args,err", [
    (dcn_cross_stack, lambda: (torch.zeros(4, 8, dtype=torch.float64),
                               torch.zeros(2, 8), torch.zeros(2, 8)), TypeError),
    (dcn_cross_stack, lambda: (torch.zeros(4, 8), torch.zeros(2, 7), torch.zeros(2, 7)),
     ValueError),
    (dcn_cross_stack, lambda: (torch.zeros(8, 4).T, torch.zeros(2, 8), torch.zeros(2, 8)),
     ValueError),
    (fused_lookup_pool, lambda: (torch.zeros(10, 4), torch.zeros(2, 3, dtype=torch.int64),
                                 torch.zeros(2, 3)), TypeError),
    (fused_lookup_pool, lambda: (torch.zeros(10, 4), torch.zeros(2, 3, dtype=torch.int32),
                                 torch.zeros(2, 4)), ValueError),
    (fused_lookup_pool, lambda: (torch.zeros(10, 4), torch.zeros(3, dtype=torch.int32),
                                 torch.zeros(3)), ValueError),
    (dcn_cross_stack, lambda: (torch.zeros(4, 8, device="meta"),
                               torch.zeros(2, 8, device="meta"),
                               torch.zeros(2, 8, device="meta")), ValueError),
    (scatter_rows_set, lambda: (torch.zeros(10, 4), torch.zeros(3, dtype=torch.int64),
                                torch.zeros(3, 4)), TypeError),
    (scatter_rows_set, lambda: (torch.zeros(10, 4), torch.zeros(3, dtype=torch.int32),
                                torch.zeros(3, 5)), ValueError),
    (dcn_cross_bwd, lambda: (torch.zeros(4, 8), torch.zeros(2, 8), torch.zeros(2, 4, 7),
                             torch.zeros(2, 4), torch.zeros(4, 8)), ValueError),
    (dcn_cross_bwd, lambda: (torch.zeros(4, 8), torch.zeros(2, 8), torch.zeros(2, 7),
                             torch.zeros(2, 4), torch.zeros(4, 8)), ValueError),
    (dcn_cross_bwd, lambda: (torch.zeros(4, 8), torch.zeros(2, 8), torch.zeros(2, 8),
                             torch.zeros(2, 5), torch.zeros(4, 8)), ValueError),
], ids=["dcn-dtype", "dcn-shape", "dcn-noncontiguous", "pool-ids-dtype",
        "pool-mask-shape", "pool-ndim", "unsupported-device", "scatter-rows-dtype",
        "scatter-vals-shape", "dcn-bwd-residual-shape", "dcn-bwd-bias-shape",
        "dcn-bwd-scalars-shape"])
def test_kernel_wrappers_reject_bad_inputs(fn, args, err):
    with pytest.raises(err):
        fn(*args())


def test_cpu_path_launches_no_kernel():
    counted = (dcn_cross_stack, dcn_cross_bwd, fused_lookup_pool, scatter_rows_set)
    before = [f.launches for f in counted]
    x0, ws, bs = (torch.from_numpy(a).requires_grad_() for a in cross_inputs(8, 16, 2))
    dcn_cross_stack(x0, ws, bs).sum().backward()
    fused_lookup_pool(*map(torch.from_numpy, pool_inputs(20, 4, 8, 3)))
    scatter_rows_set(*map(torch.from_numpy, scatter_inputs(64, 8, 10)))
    assert [f.launches for f in counted] == before


def test_cross_plain_is_the_rank1_identity():
    x0, ws, bs = map(torch.from_numpy, cross_inputs(16, 12, 3, seed=1))
    torch.testing.assert_close(cross_plain(x0, ws, bs), reference_cross_stack(x0, ws, bs),
                               **TOL)


def test_build_command_targets_hopper(tmp_path):
    cmd = _build.nvcc_command("nvcc", tmp_path / _build.LIB_NAME, [tmp_path / "k.o"])
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    cmd = _build.compile_command("nvcc", _build.sources()[0], tmp_path / "k.o")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd
    names = {p.name for p in _build.sources()}
    assert {"dcn_cross.cu", "dcn_cross_bwd.cu", "lookup_pool.cu", "scatter_rows.cu"} <= names
    assert _build.library_path().parent.parent == _build.BUILD_DIR


def test_build_without_nvcc_fails_clearly(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_scatter_rows_matches_jax_pallas():
    """Sorted rows with duplicates (identical values): the port's scatter
    equals the Pallas kernel interpreted, bit for bit, and writes in place."""
    table, rows, vals = scatter_inputs(256, 32, 40)
    want = np.asarray(jscatter.scatter_rows_set(jnp.array(table), jnp.asarray(rows),
                                                jnp.asarray(vals), use_pallas=True,
                                                interpret=True))
    t = torch.from_numpy(table.copy())
    assert scatter_rows_set(t, torch.from_numpy(rows), torch.from_numpy(vals)) is t
    np.testing.assert_array_equal(t.numpy(), want)
    untouched = np.setdiff1d(np.arange(256), rows)
    np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])


def test_scatter_rows_drops_out_of_range_rows():
    """Rows >= V are dropped, as XLA's ``.at[].set`` drops them. A negative
    row is dropped too, where ``jnp`` wraps it to the end of the table (the
    sorted dedup never emits one)."""
    table, rows, vals = scatter_inputs(64, 8, 12)
    rows[-3:] = (64, 64, 1000)
    vals[-2] = vals[-3]
    want = np.asarray(jscatter.scatter_rows_set(jnp.array(table), jnp.asarray(rows),
                                                jnp.asarray(vals)))
    got = scatter_rows_set(*map(torch.from_numpy, (table.copy(), rows, vals))).numpy()
    np.testing.assert_array_equal(got, want)
    rows = np.array([-1, 3], np.int32)
    got = scatter_rows_plain(torch.from_numpy(table.copy()), torch.from_numpy(rows),
                             torch.ones(2, 8)).numpy()
    np.testing.assert_array_equal(got[-1], table[-1])
    np.testing.assert_array_equal(got[3], 1.0)


def test_scatter_rows_contract_on_the_cpu():
    table = torch.zeros(64, 16)
    with pytest.raises(ValueError, match="non-decreasing"):
        scatter_rows_set(table, torch.tensor([9, 3], dtype=torch.int32), torch.ones(2, 16))
    assert not table.any()
    out = scatter_rows_set(table, torch.zeros(0, dtype=torch.int32), torch.zeros(0, 16))
    assert out is table and not table.any()                        # S = 0


def test_topk_searcher_matches_jax():
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((500, 16)).astype(np.float32)
    queries = rng.standard_normal((32, 16)).astype(np.float32)
    searcher, jsearcher = TopKSearcher(device="cpu"), JTopKSearcher(normalize=False)
    searcher.update_embedding(corpus)
    jsearcher.update_embedding(corpus)
    idx, scores = searcher.search(queries, k=7, batch_size=10)      # 4 query chunks
    jidx, jscores = jsearcher.search(queries, k=7)
    np.testing.assert_allclose(scores, jscores, **TOL)
    np.testing.assert_array_equal(idx, jidx)    # random scores: no ties


def test_topk_searcher_cosine_matches_jax():
    """``normalize=True``: the corpus and the queries are L2-normalised as
    the JAX searcher does, a zero row included (its norm held at eps)."""
    from news_recsys_tpu.ops.topk import l2_normalize as jl2_normalize
    from news_recsys_tpu_torch.ops.topk import l2_normalize

    rng = np.random.default_rng(1)
    corpus = rng.standard_normal((500, 16)).astype(np.float32) * rng.uniform(
        0.1, 10.0, (500, 1)).astype(np.float32)
    corpus[17] = 0.0
    queries = rng.standard_normal((32, 16)).astype(np.float32)
    queries[5] = 0.0
    np.testing.assert_allclose(l2_normalize(torch.from_numpy(corpus)).numpy(),
                               np.asarray(jl2_normalize(jnp.asarray(corpus))), rtol=0, atol=1e-6)
    searcher, jsearcher = TopKSearcher(device="cpu", normalize=True), JTopKSearcher(normalize=True)
    searcher.update_embedding(corpus)
    jsearcher.update_embedding(corpus)
    idx, scores = searcher.search(queries, k=7, batch_size=10)
    jidx, jscores = jsearcher.search(queries, k=7)
    np.testing.assert_allclose(scores, jscores, rtol=0, atol=1e-6)
    assert np.all(scores[5] == 0.0)             # a zero query scores 0 everywhere
    keep = np.arange(len(queries)) != 5         # its top-k is a tie of all rows
    np.testing.assert_array_equal(idx[keep], jidx[keep])


@pytest.mark.parametrize("op",["pool at the DSSM's hist shape", "take of 4,096 ids"])
def test_cpu_gather_backward_repeats_its_bits(op):
    """The CPU paths' table gradients are the same bits every run: the
    pool's plain version at B 512, L 30 over 65,280 rows (the DSSM's
    ``hist``), and ``take`` over 4,096 ids with repeats. Gathered by
    ``table[ids]``, their backward (``index_put_`` with accumulate) summed
    in a run-dependent order on the CPU, so a resumed run could drift from
    a straight one."""
    from news_recsys_tpu_torch.models.embedding import take

    gen = torch.Generator().manual_seed(0)
    if op.startswith("pool"):
        ids = torch.randint(1, 65239, (512, 30), generator=gen).int()
        mask = (torch.rand(512, 30, generator=gen) < 0.7).float()
        g = torch.randn(512, 16, generator=gen)
        f = lambda t: (fused_lookup_pool(t, ids, mask) * g).sum()          # noqa: E731
    else:
        ids = torch.randint(1, 200, (4096,), generator=gen)
        g = torch.randn(4096, 16, generator=gen)
        f = lambda t: (take(t, ids) * g).sum()                             # noqa: E731
    table = torch.randn(65280, 16, generator=gen)
    grads = []
    for _ in range(8):
        t = table.clone().requires_grad_()
        f(t).backward()
        grads.append(t.grad)
    for grad in grads[1:]:
        assert torch.equal(grad, grads[0])
