"""NRMS's masked multi-head self-attention (``ops/mhsa.py``) on the CPU: the
plain version against the chain of library calls ``models/nrms.py`` ran
before the kernel, the masking cases, gradcheck in float64, the kernels'
autograd path with their plain bodies, the launch plan and the costs. The
kernels themselves run on the card (``tests/test_torch_cuda.py -k mhsa``).
Imports nothing of the JAX package.

The plain version is that chain, so it is held to it bit for bit; the
semantics the kernels follow (a masked key skipped, a row with no kept key
attending uniformly) are held to a loop over the kept keys within float32
rounding (rtol 1e-6 on values of order 1).
"""

import math

import numpy as np
import pytest
import torch

from news_recsys_tpu_torch.models import nrms
from news_recsys_tpu_torch.ops import mhsa
from news_recsys_tpu_torch.ops.mhsa import (MAX_LEN, _Mhsa, masked_mhsa, masked_mhsa_bwd,
                                            masked_mhsa_bwd_plain, masked_mhsa_plain,
                                            mhsa_bwd_cost, mhsa_cost, plan_mhsa)
from news_recsys_tpu_torch.utils.roofline import step_cost

torch.set_num_threads(2)

HEADS, HD = 16, 16              # NRMS's 16 heads of 16
SMEM_LIMIT = 227 * 1024         # the H100's shared memory a block


def chain(x, wqkv, mask, heads, hd):
    """``SelfAttention.forward`` as ``models/nrms.py`` wrote it before the kernel."""
    N, L, _ = x.shape
    q, k, v = (x @ wqkv).view(N, L, 3, heads, hd).permute(2, 0, 3, 1, 4)
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    alpha = nrms.masked_softmax(scores, mask[:, None, None, :])
    return (alpha @ v).transpose(1, 2).reshape(N, L, heads * hd)


def inputs(N, L, dim=32, heads=HEADS, hd=HD, seed=0, dtype=torch.float32):
    """x (N, L, dim), wqkv, and a mask of the three kinds of row: trailing
    padding (row 0 full, row 1 one key, the rest ragged), interior padding
    (row 2), and no kept key (row 3)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((N, L, dim))).to(dtype)
    wqkv = torch.from_numpy(rng.uniform(-1, 1, (dim, 3 * heads * hd)) / math.sqrt(dim)).to(dtype)
    n = rng.integers(1, L + 1, N)
    n[0], n[1] = L, 1
    mask = torch.from_numpy(np.arange(L)[None, :] < n[:, None])
    if N > 2 and L > 2:
        mask[2] = torch.from_numpy(rng.random(L) < 0.5)
        mask[2, 0] = True
    if N > 3:
        mask[3] = False
    return x, wqkv, mask


def kept_only(qkv, mask, heads):
    """The attention over each row's kept keys alone (uniform over all keys
    where none is kept), a row and a head at a time."""
    N, L, width = qkv.shape
    hd = width // (3 * heads)
    q, k, v = qkv.reshape(N, L, 3, heads, hd).permute(2, 0, 3, 1, 4)
    out = torch.empty(N, heads, L, hd, dtype=qkv.dtype)
    for i in range(N):
        keep = mask[i] if mask[i].any() else torch.ones(L, dtype=torch.bool)
        s = (q[i] @ k[i][:, keep].transpose(-1, -2)) / math.sqrt(hd)
        if not mask[i].any():
            s = torch.zeros_like(s)
        out[i] = torch.softmax(s, dim=-1) @ v[i][:, keep]
    return out.transpose(1, 2).reshape(N, L, heads * hd)


@pytest.mark.parametrize("L", [30, 50])
def test_plain_is_the_chain(L):
    """Output and the gradients of x and wqkv, through autograd, bit for bit."""
    x, wqkv, mask = inputs(12, L)
    g = torch.randn(12, L, HEADS * HD, generator=torch.Generator().manual_seed(1))
    got, want = [], []
    for f, out in ((lambda x, w: masked_mhsa(x @ w, mask, HEADS), got),
                   (lambda x, w: chain(x, w, mask, HEADS, HD), want)):
        xs, ws = x.clone().requires_grad_(True), wqkv.clone().requires_grad_(True)
        y = f(xs, ws)
        out += [y.detach(), *torch.autograd.grad(y, (xs, ws), g)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("L", [30, 50])
def test_kernels_autograd_path_with_plain_bodies(L):
    """``_Mhsa`` (the path the card takes) with its plain bodies: the same
    output, and a packed gradient equal to autograd's through the chain."""
    x, wqkv, mask = inputs(12, L, seed=2)
    qkv = (x @ wqkv).requires_grad_(True)
    g = torch.randn(12, L, HEADS * HD, generator=torch.Generator().manual_seed(3))
    y = _Mhsa.apply(qkv, mask, HEADS)
    (dqkv,) = torch.autograd.grad(y, qkv, g)
    want = masked_mhsa_plain(qkv, mask, HEADS)
    (want_d,) = torch.autograd.grad(want, qkv, g)
    assert torch.equal(y, want) and torch.equal(dqkv, want_d)
    assert torch.equal(masked_mhsa_bwd(qkv.detach(), mask, g, HEADS), want_d)
    assert torch.equal(masked_mhsa_bwd_plain(qkv.detach(), mask, g, HEADS), want_d)


@pytest.mark.parametrize("L", [1, 7, 30, 50])
def test_masked_keys_are_skipped(L):
    """Trailing and interior padding weigh exactly nothing beside a kept key,
    and a row with no kept key attends uniformly: the chain against the
    attention over the kept keys alone."""
    x, wqkv, mask = inputs(6, L, seed=L)
    qkv = x @ wqkv
    torch.testing.assert_close(masked_mhsa(qkv, mask, HEADS), kept_only(qkv, mask, HEADS),
                               rtol=1e-6, atol=1e-6)


def test_a_row_with_no_kept_key():
    """Its output is the mean of its values, its dQ and dK are 0 and its dV
    the mean of dO over the query rows, for every key (the masked ones too);
    a masked key of a row that keeps some gets no dK and no dV."""
    L = 30
    x, wqkv, mask = inputs(5, L, seed=4)
    qkv = (x @ wqkv).requires_grad_(True)
    g = torch.randn(5, L, HEADS * HD, generator=torch.Generator().manual_seed(5))
    y = masked_mhsa(qkv, mask, HEADS)
    (d,) = torch.autograd.grad(y, qkv, g)
    hh = HEADS * HD
    torch.testing.assert_close(y[3], qkv[3, :, 2 * hh:].mean(dim=0).expand(L, hh))
    assert torch.equal(d[3, :, :2 * hh], torch.zeros(L, 2 * hh))
    torch.testing.assert_close(d[3, :, 2 * hh:], g[3].mean(dim=0).expand(L, hh))
    masked = ~mask[2]
    assert masked.any()
    assert torch.equal(d[2][masked][:, hh:], torch.zeros(int(masked.sum()), 2 * hh))


def test_gradcheck_in_float64():
    """The plain version and the kernels' autograd path (plain bodies), in
    float64 on a small shape with every kind of row."""
    x, wqkv, mask = inputs(5, 6, dim=8, heads=2, hd=4, seed=6, dtype=torch.float64)
    qkv = (x @ wqkv).requires_grad_(True)
    assert torch.autograd.gradcheck(lambda t: masked_mhsa(t, mask, 2), (qkv,))
    assert torch.autograd.gradcheck(lambda t: _Mhsa.apply(t, mask, 2), (qkv,))


def test_the_model_attends_through_the_op(monkeypatch):
    """``SelfAttention`` hands ``x @ wqkv`` as it lies to ``masked_mhsa``."""
    seen = []
    real = mhsa.masked_mhsa

    def spy(qkv, mask, heads):
        seen.append((tuple(qkv.shape), qkv.is_contiguous(), heads))
        return real(qkv, mask, heads)

    monkeypatch.setattr(nrms, "masked_mhsa", spy)
    attn = nrms.SelfAttention(24, 4, 4, torch.Generator().manual_seed(0))
    x, _, mask = inputs(3, 9, dim=24, heads=4, hd=4)
    out = attn(x, mask)
    assert seen == [((3, 9, 48), True, 4)] and out.shape == (3, 9, 16)


@pytest.mark.parametrize("shape,plan", [
    ((3520, 30, 16, 16), (4, 1, 128, 14080)),       # the news encoder
    ((64, 50, 16, 16), (2, 2, 128, 512)),           # the user encoder
    ((10, 128, 16, 64), (1, 4, 128, 160)),
    ((10, 1, 16, 8), (4, 1, 128, 40)),
    ((7, 33, 3, 32), (1, 2, 64, 21)),
    ((7, 30, 6, 16), (3, 1, 96, 14)),
])
def test_plan(shape, plan):
    got = plan_mhsa(*shape)
    assert tuple(got)[:4] == plan
    assert got.threads <= 128 and got.bwd_smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("L", [1, 31, 32, 33, 64, 65, 127, MAX_LEN])
@pytest.mark.parametrize("hd", [8, 16, 32, 64])
def test_every_shape_of_the_domain_fits_a_block(L, hd):
    for H in (1, 2, 3, 4, 16):
        p = plan_mhsa(2, L, H, hd)
        assert H % p.heads_per_block == 0 and p.warps_per_head * 32 >= L
        assert p.threads <= 128 and p.fwd_smem_bytes <= p.bwd_smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("shape", [(4, 129, 16, 16), (4, 30, 16, 12), (4, 30, 16, 128),
                                   (4, 0, 16, 16), (4, 30, 0, 16)])
def test_the_plan_refuses_what_the_kernels_do_not_take(shape):
    with pytest.raises(ValueError):
        plan_mhsa(*shape)


def test_costs_at_the_news_encoder():
    """The bytes and FLOPs of the forward and backward at 3,520 titles of 30."""
    fwd, bwd = mhsa_cost(3520, 30, 16, 16), mhsa_bwd_cost(3520, 30, 16, 16)
    assert fwd.flops == 4 * 3520 * 16 * 30 * 30 * 16 and fwd.units == "float32"
    assert fwd.bytes == 3520 * 30 * (768 + 256) * 4 + 3520 * 30
    assert bwd.flops == 2 * fwd.flops
    assert bwd.bytes == 3520 * 30 * (768 + 256 + 768) * 4 + 3520 * 30
    assert round(fwd.bytes / 1e6) == 433 and round(bwd.bytes / 1e6) == 757


def test_an_open_counter_counts_the_kernels():
    """Under ``step_cost`` a forward and backward through the model counts
    one forward and one backward of each encoder's attention, at their
    shapes, and hides the plain bodies' ops; the gradients are the plain
    path's."""
    attn = nrms.SelfAttention(24, 4, 4, torch.Generator().manual_seed(0))
    x, _, mask = inputs(3, 9, dim=24, heads=4, hd=4)

    def step():
        attn.zero_grad()
        attn(x, mask).square().sum().backward()

    cost = step_cost(step)
    counted = attn.wqkv.grad.clone()
    assert cost["kernels"]["masked_mhsa"]["calls"] == 1
    assert cost["kernels"]["masked_mhsa_bwd"]["calls"] == 1
    assert cost["kernels"]["masked_mhsa"]["flops"] == mhsa_cost(3, 9, 4, 4).flops
    assert not any(k.startswith("aten::bmm") or k.startswith("aten::_softmax")
                   for k in cost["ops"])
    step()
    assert torch.equal(attn.wqkv.grad, counted)


def test_wrong_inputs_raise():
    x, wqkv, mask = inputs(3, 9, dim=24, heads=4, hd=4)
    qkv = x @ wqkv
    with pytest.raises(ValueError):
        masked_mhsa(qkv, mask, 5)                      # 48 is not 3 x 5 x head_dim
    with pytest.raises(TypeError):
        masked_mhsa(qkv, mask.float(), 4)
    with pytest.raises(ValueError):
        masked_mhsa(qkv, mask[:, :5].contiguous(), 4)
    with pytest.raises(ValueError):
        masked_mhsa_bwd(qkv, mask, torch.zeros(3, 9, 15), 4)
