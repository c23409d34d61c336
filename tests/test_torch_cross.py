"""The cross stack's residuals, plain backward and launch plan, on the CPU.

The port's forward keeps only each layer's scalar ``ss`` for the backward;
the backward rebuilds each layer's input ``x_l`` from x0, ``ss`` and the
biases by the forward's own recurrence (``rebuild_xs``; the CUDA kernel does
the same in registers). Here the rebuild equals the forward's ``xs`` bit for
bit, and the plain backward on the rebuilt inputs equals JAX's VJP of
``dcn_cross_stack`` (its Pallas body interpreted) at rtol 1e-5 and an atol of
1e-5 of the largest gradient, as ``tests/test_torch_training.py`` holds the
VJP on JAX's own residuals: both float32, summed in other orders, and dws
sums B terms of up to ~500 (the float32 grain at 500 is 3e-5, so a fixed
atol of 1e-5 would sit below one rounding). The plan (``plan_cross``) is Python, a pure
function of the shape; the kernels run in tests/test_torch_cuda.py.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from news_recsys_tpu.ops import dcn_kernel as jdcn
from news_recsys_tpu_torch.ops.dcn_kernel import (BWD_WARPS, FWD_SMEM_BYTES, MAX_D, MAX_LAYERS,
                                                  SMEM_BYTES, CrossPlan, _check_limits,
                                                  cross_bwd_plain, cross_bwd_rebuild_plain,
                                                  cross_fwd_plain, cross_partials, dcn_cross_bwd,
                                                  plan_cross, rebuild_xs)

from tests.test_torch_cuda import cross_inputs

H100_SMS = 132


@pytest.mark.parametrize("B,D,NL", [(64, 112, 3), (32, 24, 2)])
def test_rebuild_backward_matches_jax_vjp(monkeypatch, B, D, NL):
    monkeypatch.setenv("NRT_PALLAS", "interpret")
    x0, ws, bs = cross_inputs(B, D, NL)
    g = np.random.default_rng(1).standard_normal((B, D)).astype(np.float32)
    _, vjp = jax.vjp(jdcn.dcn_cross_stack, x0, ws, bs)
    want = [np.asarray(a) for a in vjp(g)]
    x0t, wst, bst, gt = map(torch.from_numpy, (x0, ws, bs, g))
    ss = cross_fwd_plain(x0t, wst, bst)[2]
    for got in (cross_bwd_rebuild_plain(x0t, wst, bst, ss, gt),
                dcn_cross_bwd(x0t, wst, bst, ss, gt)):            # the wrapper's CPU path
        for name, a, w in zip(("dx0", "dws", "dbs"), got, want):
            np.testing.assert_allclose(a.numpy(), w, err_msg=name, rtol=1e-5,
                                       atol=1e-5 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("B,D,NL", [(64, 112, 3), (33, 113, 4), (5, 1, 1), (16, 256, 8),
                                   (9, 24, 12)])
def test_rebuilt_xs_equal_the_forwards_bit_for_bit(B, D, NL):
    x0, ws, bs = map(torch.from_numpy, cross_inputs(B, D, NL, seed=B))
    _, xs, ss = cross_fwd_plain(x0, ws, bs)
    assert torch.equal(rebuild_xs(x0, bs, ss), xs)
    want = cross_bwd_plain(x0, ws, xs, ss, x0)
    for a, b in zip(cross_bwd_rebuild_plain(x0, ws, bs, ss, x0), want):
        assert torch.equal(a, b)


# (B, D, aligned, backward) -> the plan on the H100's 132 SMs, 3 layers. D
# 112 is 28 float4s. The forward puts a row on 8 lanes of 4 float4s (4 rows
# a warp, 4 warps a block); D 113 and a misaligned D 112 take the scalar
# path, 16 lanes of up to 8 floats. The backward puts one chunk on a lane
# (D 112: 32 lanes, 28 busy; the scalar path 4 floats a lane), 8 warps a
# block, at most two blocks an SM (more rows loop); each block writes a
# partial to device memory for the second launch to sum, none with one block.
PLANS = {
    (512, 112, True, False): CrossPlan(True, 8, 4, 4, 32, 0, 2688),
    (6400, 112, True, False): CrossPlan(True, 8, 4, 4, 400, 0, 2688),
    (1, 112, True, False): CrossPlan(True, 8, 4, 1, 1, 0, 2688),
    (512, 112, False, False): CrossPlan(False, 16, 8, 4, 64, 0, 2688),
    (6400, 113, True, False): CrossPlan(False, 16, 8, 4, 800, 0, 2712),
    (512, 112, True, True): CrossPlan(True, 32, 1, 8, 64, 64, 24192),
    (6400, 112, True, True): CrossPlan(True, 32, 1, 8, 264, 264, 24192),
    (1, 112, True, True): CrossPlan(True, 32, 1, 1, 1, 0, 5376),
    (512, 112, False, True): CrossPlan(False, 32, 4, 8, 64, 64, 24192),
    (6400, 113, True, True): CrossPlan(False, 32, 4, 8, 264, 264, 24408),
    (1, 113, False, True): CrossPlan(False, 32, 4, 1, 1, 0, 5424),
    (513, 112, True, True): CrossPlan(True, 32, 1, 8, 65, 65, 24192),
}


@pytest.mark.parametrize("B,D,aligned,backward", list(PLANS),
                         ids=[f"B{b}-D{d}-{'aligned' if a else 'misaligned'}-"
                              f"{'bwd' if k else 'fwd'}" for b, d, a, k in PLANS])
def test_plan_cross(B, D, aligned, backward):
    plan = plan_cross(B, D, 3, aligned, H100_SMS, backward)
    assert plan == PLANS[B, D, aligned, backward]
    chunks = D // 4 if plan.vector else D
    assert plan.group * plan.slots >= chunks > plan.group * plan.slots // 2
    rows_per_block = plan.warps * 32 // plan.group
    if backward:
        assert plan.group == min(32, 1 << (chunks - 1).bit_length())
        assert plan.partials == cross_partials(plan.blocks)
        assert plan.partials == (plan.blocks if plan.blocks > 1 else 0)
        assert plan.smem_bytes == 4 * 2 * 3 * D * (plan.warps + 1) <= SMEM_BYTES
        assert plan.blocks <= 2 * H100_SMS
    else:
        assert plan.slots <= (4 if plan.vector else 8)
        assert plan.blocks * rows_per_block >= B > (plan.blocks - 1) * rows_per_block


@pytest.mark.parametrize("B", [0, 1, 7, 37, 512, 513, 1000, 6400, 6401, 100000])
@pytest.mark.parametrize("D,NL", [(1, 1), (3, 1), (1, 12), (24, 2), (112, 3), (113, 3),
                                  (200, 4), (256, 6), (64, 32), (256, 24)])
def test_plan_cross_backward_fits_every_shape(B, D, NL):
    """Every shape of the kernels' domain: a row's lanes hold it and its NL
    scalars, shared memory fits a block, every block but a lone one writes a
    partial for the second launch, and the blocks' rows cover the batch
    where two blocks an SM hold it (more rows loop)."""
    for aligned in (True, False):
        plan = plan_cross(B, D, NL, aligned, H100_SMS, True)
        chunks = D // 4 if plan.vector else D
        assert plan.group * plan.slots >= chunks and NL <= plan.group <= 32
        assert plan.partials == (plan.blocks if plan.blocks > 1 else 0)
        assert 1 <= plan.blocks <= 2 * H100_SMS
        assert 1 <= plan.warps <= BWD_WARPS
        rows = plan.blocks * plan.warps * (32 // plan.group)
        assert rows >= B or plan.blocks == 2 * H100_SMS
        assert plan.smem_bytes <= SMEM_BYTES
        assert plan.vector == (aligned and D % 4 == 0)


@pytest.mark.parametrize("D,NL,backward", [(0, 3, False), (MAX_D + 1, 3, False),
                                           (112, MAX_LAYERS + 1, True), (112, 0, True)])
def test_kernel_limits_raise_value_error(D, NL, backward):
    with pytest.raises(ValueError):
        _check_limits(D, NL, backward)
    _check_limits(min(max(D, 1), MAX_D), min(max(NL, 1), MAX_LAYERS), backward)


def built_layouts(name: str) -> set:
    """The (vector, group, slots) layouts ``csrc/dcn_cross.cuh`` builds a kernel for."""
    text = (Path(__file__).parent.parent / "news_recsys_tpu_torch" / "csrc" /
            "dcn_cross.cuh").read_text()
    body = text.split(f"#define {name}(X)")[1].split("#define")[0]
    return {(vw == 4, g, s) for vw, g, s in
            (map(int, t) for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", body))}


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_plan_cross_picks_only_built_layouts(backward):
    """Every plan of the kernels' domain names a layout the kernel is built
    for, and every layout built is one some plan names."""
    built = built_layouts("NRT_CROSS_BWD_LAYOUTS" if backward else "NRT_CROSS_FWD_LAYOUTS")
    picked = {(p.vector, p.group, p.slots)
              for D in range(1, MAX_D + 1) for NL in range(1, MAX_LAYERS + 1)
              for aligned in (True, False)
              if 4 * 2 * NL * D <= FWD_SMEM_BYTES
              for p in [plan_cross(512, D, NL, aligned, H100_SMS, backward)]}
    assert picked == built
