"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here needs a CUDA GPU and skips without one. This file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the kernels sum in another order than PyTorch's ops; the
pooled mean of float32 rows holds to rtol = atol = 1e-5, the cross stack,
whose values grow over the layers, to rtol 1e-5 and atol 1e-4.
"""

import numpy as np
import pytest
import torch

from news_recsys_tpu.config import config_from_dict
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.ops.dcn_kernel import cross_plain, dcn_cross_stack
from news_recsys_tpu_torch.ops.fused_lookup_pool import (fused_lookup_pool,
                                                         reference_lookup_pool)

POOL_TOL = dict(rtol=1e-5, atol=1e-5)
DCN_TOL = dict(rtol=1e-5, atol=1e-4)


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,NL", [(6400, 112, 3), (1000, 24, 2), (37, 200, 4), (5, 1, 1)])
def test_dcn_kernel_matches_plain(cuda, B, D, NL):
    x0, ws, bs = on(cuda, *cross_inputs(B, D, NL))
    with torch.inference_mode():
        n = dcn_cross_stack.launches
        got = dcn_cross_stack(x0, ws, bs)
        assert dcn_cross_stack.launches == n + 1
        torch.testing.assert_close(got, cross_plain(x0, ws, bs), **DCN_TOL)


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
    x0 = torch.zeros(4, 8, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        dcn_cross_stack(x0, torch.zeros(2, 8, device=cuda), torch.zeros(2, 8, device=cuda))
    with torch.no_grad():
        dcn_cross_stack(x0, torch.zeros(2, 8, device=cuda), torch.zeros(2, 8, device=cuda))


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
    cpu_model = build_ranker(cfg, seed=3)
    gpu_model = build_ranker(cfg, seed=3, device=cuda)
    with torch.inference_mode():
        want = cpu_model({k: torch.from_numpy(v.astype(np.int32)) for k, v in batch.items()})
        n = dcn_cross_stack.launches
        got = gpu_model({k: torch.from_numpy(v.astype(np.int32)).to(cuda)
                         for k, v in batch.items()})
        assert dcn_cross_stack.launches == n + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)
