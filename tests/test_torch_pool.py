"""The pool backward kernel's plan and arithmetic, on the CPU.

The kernel (``csrc/lookup_pool_bwd.cu``) adds every term of a table row as
an integer, ``round(term * 2^(P - e))`` with ``e`` the exponent of the row's
largest term, so that the order of its atomic additions cannot change the
result. Its plan (``fixed_point_bits``, ``pool_bwd_scratch``) is Python, and
its arithmetic is mirrored here in numpy (``integer_pool_bwd``), held to the
JAX package's gradient and to ``pool_bwd_plain`` at rtol = atol = 1e-5 (float32
on both sides, summed in other orders), and to itself, bit for bit, under any
order of the slots. The kernel itself runs in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recsys_tpu.ops import fused_lookup_pool as jpool
from news_recsys_tpu_torch.ops.fused_lookup_pool import (fixed_point_bits, pool_bwd_plain,
                                                         pool_bwd_scratch)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [1, 2, 3, 2560, 15360, 2 ** 20, 2 ** 31 - 1])
def test_fixed_point_bits_leave_room_for_every_slot(S):
    """S terms of at most 2^P each sum to at most 2^62 (63 bits and a sign),
    and P is the largest grain that does."""
    P = fixed_point_bits(S)
    assert S * 2 ** P <= 2 ** 62 < S * 2 ** (P + 1) * 2
    assert P >= 31


@pytest.mark.parametrize("B,L,D,V", [(512, 30, 16, 65280), (512, 5, 16, 30080), (3, 4, 7, 5),
                                     (1, 1, 256, 100)])
def test_pool_bwd_scratch_sizes(B, L, D, V):
    """The rows' exponents and accumulator indices; one coefficient a slot;
    an accumulator row a slot (B*L * D int64 and int32 flags), which the first
    slot to touch a table row lends that row."""
    state, coef, acc, flags = pool_bwd_scratch(B, L, D, V, "cpu")
    assert (state.shape, state.dtype) == ((2 * V,), torch.int32)
    assert (coef.shape, coef.dtype) == ((B * L,), torch.float32)
    assert (acc.shape, acc.dtype) == ((B * L * D,), torch.int64)
    assert (flags.shape, flags.dtype) == ((B * L * D,), torch.int32)


def integer_pool_bwd(ids, mask, g, V, order):
    """The kernel's arithmetic in numpy, its slots added in ``order``: each
    adding slot's coefficient ``w / (sum w + 1e-8)`` (float32), the row's
    exponent from ``|c| * max|g[b]|``, every float32 term ``c * g[b, d]``
    rounded to the grain ``2^(e - P)`` and added as an int64, the sum scaled
    back and rounded to float32 once."""
    B, L = ids.shape
    P = fixed_point_bits(B * L)
    w = np.where(ids != 0, mask, 0).astype(np.float32)
    denom = w.sum(axis=1, dtype=np.float32) + np.float32(1e-8)
    adds = (w != 0) & (ids > 0) & (ids < V)
    c = np.where(adds, w / denom[:, None], 0).astype(np.float32)
    t = np.abs(c).astype(np.float64) * np.abs(g).max(axis=1)[:, None]
    e = np.frexp(t)[1]                                   # t < 2^e
    emax = np.full(V, np.iinfo(np.int64).min)
    np.maximum.at(emax, ids[t > 0], e[t > 0])
    terms = (c[..., None] * g[:, None, :]).astype(np.float32).reshape(B * L, -1)
    flat, keep = ids.reshape(-1), (t > 0).reshape(-1)
    acc = np.zeros((V, g.shape[1]), np.int64)
    for s in order:
        if keep[s]:
            acc[flat[s]] += np.rint(np.ldexp(terms[s].astype(np.float64),
                                             P - emax[flat[s]])).astype(np.int64)
    touched = emax > np.iinfo(np.int64).min
    scale = np.where(touched, np.ldexp(1.0, np.where(touched, emax - P, 0)), 0.0)
    return (acc * scale[:, None]).astype(np.float32)


def zipf_case(V, B, L, seed):
    rng = np.random.default_rng(seed)
    ids = (1 + (rng.zipf(1.05, (B, L)) - 1) % (V - 1)).astype(np.int32)
    ids[np.arange(L)[None, :] >= rng.integers(0, L + 1, B)[:, None]] = 0
    mask = (ids != 0).astype(np.float32) * rng.uniform(0.5, 2.0, (B, L)).astype(np.float32)
    mask[1] = 0.0
    return ids, mask, rng.standard_normal((B, 8)).astype(np.float32)


@pytest.mark.parametrize("V,B,L", [(3000, 64, 30), (500, 400, 5)])
def test_integer_accumulation_matches_jax_in_any_order(V, B, L):
    """Zipf ids (runs of one id longer than a warp's 32 slots): the integer
    sums equal JAX's scatter-add and the plain version, and three orders of
    the slots give the same bits."""
    ids, mask, g = zipf_case(V, B, L, seed=V)
    assert np.bincount(ids[mask > 0]).max() > 32
    S = B * L
    got = integer_pool_bwd(ids, mask, g, V, range(S))
    rng = np.random.default_rng(1)
    for order in (range(S - 1, -1, -1), rng.permutation(S)):
        np.testing.assert_array_equal(integer_pool_bwd(ids, mask, g, V, order), got)
    table = np.zeros((V, g.shape[1]), np.float32)
    want = jax.grad(lambda t: jnp.sum(jpool.fused_lookup_pool(t, ids, mask) * g))(table)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    plain = pool_bwd_plain(*map(torch.from_numpy, (ids, mask, g)), V).numpy()
    np.testing.assert_allclose(got, plain, **TOL)
    assert not got[0].any()
