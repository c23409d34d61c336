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
from news_recsys_tpu.ops.topk import TopKSearcher as JTopKSearcher
from news_recsys_tpu_torch.ops import _build
from news_recsys_tpu_torch.ops.dcn_kernel import (cross_plain, dcn_cross_stack,
                                                  reference_cross_stack)
from news_recsys_tpu_torch.ops.fused_lookup_pool import fused_lookup_pool
from news_recsys_tpu_torch.ops.topk import TopKSearcher

from tests.test_torch_cuda import cross_inputs, pool_inputs

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
], ids=["dcn-dtype", "dcn-shape", "dcn-noncontiguous", "pool-ids-dtype",
        "pool-mask-shape", "pool-ndim", "unsupported-device"])
def test_kernel_wrappers_reject_bad_inputs(fn, args, err):
    with pytest.raises(err):
        fn(*args())


def test_cpu_path_launches_no_kernel():
    before = (dcn_cross_stack.launches, fused_lookup_pool.launches)
    x0, ws, bs = cross_inputs(8, 16, 2)
    dcn_cross_stack(*map(torch.from_numpy, (x0, ws, bs)))
    fused_lookup_pool(*map(torch.from_numpy, pool_inputs(20, 4, 8, 3)))
    assert (dcn_cross_stack.launches, fused_lookup_pool.launches) == before


def test_cross_plain_is_the_rank1_identity():
    x0, ws, bs = map(torch.from_numpy, cross_inputs(16, 12, 3, seed=1))
    torch.testing.assert_close(cross_plain(x0, ws, bs), reference_cross_stack(x0, ws, bs),
                               **TOL)


def test_build_command_targets_hopper(tmp_path):
    cmd = _build.nvcc_command("nvcc", tmp_path / _build.LIB_NAME)
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    names = {p.name for p in _build.sources()}
    assert {"dcn_cross.cu", "lookup_pool.cu"} <= names
    assert _build.library_path().parent.parent == _build.BUILD_DIR


def test_build_without_nvcc_fails_clearly(monkeypatch):
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_topk_searcher_matches_jax():
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((500, 16)).astype(np.float32)
    queries = rng.standard_normal((32, 16)).astype(np.float32)
    searcher, jsearcher = TopKSearcher(), JTopKSearcher(normalize=False)
    searcher.update_embedding(corpus)
    jsearcher.update_embedding(corpus)
    idx, scores = searcher.search(queries, k=7, batch_size=10)      # 4 query chunks
    jidx, jscores = jsearcher.search(queries, k=7)
    np.testing.assert_allclose(scores, jscores, **TOL)
    np.testing.assert_array_equal(idx, jidx)    # random scores: no ties
