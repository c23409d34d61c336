"""The port's fused Transformer block, attention sequence ranker, its sparse
training step and the pool's backward against the JAX package's, on the CPU.

Same parameters (flax init, converted by ``news_recsys_tpu_torch.convert``)
and the same numpy inputs. The port runs its plain versions here
(``block_plain``, ``pool_bwd_plain``): a CPU tensor never launches a kernel.
The JAX side runs the flax ``TransformerBlock`` and, beside it, the Pallas
kernel in interpret mode (``fused_transformer_block(..., interpret=True)``).

Tolerances are the JAX package's own for its kernel
(tests/test_fused_attention.py): rtol = atol = 2e-5 forward; rtol 2e-4, atol
2e-5 for dx and the 12 parameter gradients, which are sums over B*L rows in
another order. Logits: 2e-5. Training states after 1-3 float32 steps: rtol =
atol = 1e-5, as in tests/test_torch_training.py.

An example whose mask is all zero: the flax block attends uniformly over
its L keys and the port follows it; the Pallas kernel leaves garbage rows
there (its documented contract), so such rows are held to the flax block
only.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recsys_tpu import serving as jserving
from news_recsys_tpu import zoo as jzoo
from news_recsys_tpu.data.packed_dataset import BatchPacker, PackedDataset
from news_recsys_tpu.models import layers as jlayers
from news_recsys_tpu.models.dssm import build_dssm as jbuild_dssm
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu.ops import fused_attention as jfa
from news_recsys_tpu.ops import fused_lookup_pool as jpool
from news_recsys_tpu.training import sparse_step as jss
from news_recsys_tpu_torch import serving as tserving
from news_recsys_tpu_torch import zoo as tzoo
from news_recsys_tpu_torch.config import config_from_dict
from news_recsys_tpu_torch.convert import (BLOCK_LEAVES, flatten, params_from_flax,
                                           params_to_flax)
from news_recsys_tpu_torch.models import layers as tlayers
from news_recsys_tpu_torch.models.dssm import build_dssm
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.models.seq_ranker import AttentionSeqRanker
from news_recsys_tpu_torch.ops.fused_attention import SMEM_BYTES, plan_shape, tiled_takes
from news_recsys_tpu_torch.ops.fused_attention import (PARAM_NAMES, block_bwd_plain, block_plain,
                                                       fused_transformer_block,
                                                       fused_transformer_block_bwd,
                                                       layer_norm_plain)
from news_recsys_tpu_torch.ops.fused_lookup_pool import (fused_lookup_pool,
                                                         fused_lookup_pool_bwd, pool_bwd_plain)
from news_recsys_tpu_torch.training import sparse_step as tss

from tests.test_torch_models import jax_init, small_dssm_raw, torch_batch
from tests.test_torch_serving import assert_same_answers, histories_of
from tests.test_torch_training import (TOL, assert_states_close, jax_train, port_state,
                                       port_train, step_indices)
from tests.test_torch_zoo import scoreboard_attention_arrays

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
SHAPES = [(24, 30, 2), (7, 12, 1), (130, 50, 4)]
EMPTY = (3,)                      # rows whose mask is all zero


# -- the block -----------------------------------------------------------------


def flax_block(B=24, L=30, D=32, H=2, F=64, seed=0, empty_rows=EMPTY):
    """tests/test_fused_attention.py's set-up: (flax block, its params, x, mask)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = (rng.random((B, L)) > 0.25).astype(np.float32)
    for r in empty_rows:
        mask[r] = 0.0
    blk = jlayers.TransformerBlock(embed_dim=D, num_heads=H, ff_dim=F)
    params = jax.device_get(blk.init(jax.random.PRNGKey(1), x, mask)["params"])
    # LayerNorm starts at scale 1, bias 0: move them, so that they are tested
    for i, ln in enumerate(("LayerNorm_0", "LayerNorm_1")):
        params[ln]["scale"] = params[ln]["scale"] + 0.1 * rng.standard_normal(D).astype(np.float32)
        params[ln]["bias"] = 0.1 * rng.standard_normal(D).astype(np.float32)
    return blk, params, x, mask


def port_params(params):
    """The flax block's tree as the fused op's 12 tensors, through ``convert``'s names."""
    flat = flatten(params)
    by_name = {BLOCK_LEAVES[k].split(".")[-1]: torch.from_numpy(np.array(v))
               for k, v in flat.items()}
    return [by_name[n] for n in PARAM_NAMES]


def port_block(params, D, H, F):
    blk = tlayers.TransformerBlock(D, H, F)
    holder = torch.nn.Module()
    holder.blocks = torch.nn.ModuleList([blk])
    params_from_flax({"blocks_0": params}, holder)
    return blk


@pytest.mark.parametrize("B,L,H", SHAPES)
def test_block_forward_matches_flax_and_pallas(B, L, H):
    blk, params, x, mask = flax_block(B=B, L=L, H=H)
    want = np.asarray(blk.apply({"params": params}, x, mask))
    pallas = np.asarray(jfa.fused_transformer_block(params, jnp.asarray(x), jnp.asarray(mask),
                                                    num_heads=H, interpret=True))
    tx, tmask = torch.from_numpy(x), torch.from_numpy(mask)
    plain = block_plain(tx, tmask, *port_params(params), num_heads=H).numpy()
    np.testing.assert_allclose(plain, want, **FWD_TOL)                 # every row, empty too
    valid = [r for r in range(B) if r not in EMPTY]
    np.testing.assert_allclose(plain[valid], pallas[valid], **FWD_TOL)
    with torch.no_grad():
        module = port_block(params, 32, H, 64)(tx, tmask).numpy()
    np.testing.assert_array_equal(module, plain)
    np.testing.assert_array_equal(
        fused_transformer_block(port_params(params), tx, tmask, H).numpy(), plain)
    # an empty example attends uniformly over its L keys: finite, and not the input
    assert np.isfinite(plain[list(EMPTY)]).all()


@pytest.mark.parametrize("masked_upstream", [True, False], ids=["pallas-contract", "all-rows"])
def test_block_gradients_match_flax_and_pallas(masked_upstream):
    """dx and all 12 parameter gradients at (24, 30, 2). With the upstream
    gradient masked to valid positions (how the ranker's pooling consumes
    the block; the Pallas kernel's contract) all three agree; with a
    gradient on every row, the empty example included, the port is held to
    the flax block."""
    blk, params, x, mask = flax_block()
    rng = np.random.default_rng(5)
    w = rng.standard_normal(x.shape).astype(np.float32)
    if masked_upstream:
        w = w * mask[..., None]

    def loss(fn):
        return lambda p, xx: jnp.sum(fn(p, xx) * w)

    refs = [jax.grad(loss(lambda p, xx: blk.apply({"params": p}, xx, mask)), argnums=(0, 1))]
    if masked_upstream:
        refs.append(jax.grad(loss(lambda p, xx: jfa.fused_transformer_block(
            p, xx, mask, num_heads=2, interpret=True)), argnums=(0, 1)))
    tparams = port_params(params)
    dx, dparams = fused_transformer_block_bwd(tparams, torch.from_numpy(x), torch.from_numpy(mask),
                                              torch.from_numpy(w), 2)
    again = block_bwd_plain(tparams, torch.from_numpy(x), torch.from_numpy(mask),
                            torch.from_numpy(w), 2)
    assert torch.equal(dx, again[0])
    for grad in refs:
        gp, gx = jax.device_get(grad(params, x))
        np.testing.assert_allclose(dx.numpy(), gx, **GRAD_TOL)
        want = port_params(gp)
        for name, got, w_ in zip(PARAM_NAMES, dparams, want):
            np.testing.assert_allclose(got.numpy(), w_.numpy(), err_msg=name, **GRAD_TOL)
    # autograd through the module gives the same gradients
    module = port_block(params, 32, 2, 64)
    tx = torch.from_numpy(x).requires_grad_()
    (module(tx, torch.from_numpy(mask)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), dx.numpy(), rtol=1e-6, atol=1e-6)
    for name, p, g in zip(PARAM_NAMES, module.fused_params(), dparams):
        np.testing.assert_allclose(p.grad.numpy(), g.numpy(), rtol=1e-6, atol=1e-6, err_msg=name)


def test_layer_norm_is_flax_layer_norm():
    """eps 1e-6 and var = E[z^2] - E[z]^2; torch's default eps 1e-5 misses
    the tolerance on a row of small variance."""
    import flax.linen as nn

    rng = np.random.default_rng(0)
    z = rng.standard_normal((6, 32)).astype(np.float32)
    z[0] = 0.03 * z[0]                             # variance ~1e-3
    scale, bias = (rng.standard_normal(32).astype(np.float32) for _ in range(2))
    want = np.asarray(nn.LayerNorm().apply({"params": {"scale": scale, "bias": bias}}, z))
    got = layer_norm_plain(*map(torch.from_numpy, (z, scale, bias))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    torch_default = torch.nn.functional.layer_norm(
        torch.from_numpy(z), (32,), torch.from_numpy(scale), torch.from_numpy(bias)).numpy()
    assert np.abs(torch_default[0] - want[0]).max() > 1e-3


def test_block_plain_takes_the_relu_gate():
    """The gate of the feed-forward's ReLU as an input: ``pre-activation > 0``
    gives the ReLU's output and gradients; flipping one pre-activation's gate
    changes the gradients of its own example only (the batch's parameter
    gradients through that example)."""
    from news_recsys_tpu_torch.ops.fused_attention import mhsa_plain
    from tests.test_torch_cuda import block_inputs

    x_np, mask_np, params_np, dy_np = block_inputs(4, 6, 8, 12, seed=3)
    x, mask, dy = map(torch.from_numpy, (x_np, mask_np, dy_np))
    params = [torch.from_numpy(p) for p in params_np]
    wqkv, bqkv, wo, bo, g1, b1, w1, c1 = params[:8]
    y1 = layer_norm_plain(x + mhsa_plain(x, mask, wqkv, bqkv, wo, bo, 2), g1, b1)
    gate = (y1 @ w1 + c1 > 0).float()
    assert torch.equal(block_plain(x, mask, *params, num_heads=2, gate=gate),
                       block_plain(x, mask, *params, num_heads=2))
    relu_dx, relu_dp = block_bwd_plain(params, x, mask, dy, 2)
    dx, dp = block_bwd_plain(params, x, mask, dy, 2, gate=gate)
    assert torch.equal(dx, relu_dx) and all(torch.equal(a, b) for a, b in zip(dp, relu_dp))
    gate[2, 3, 5] = 1.0 - gate[2, 3, 5]
    flipped, _ = block_bwd_plain(params, x, mask, dy, 2, gate=gate)
    changed = (flipped != dx).flatten(1).any(dim=1)
    assert changed.tolist() == [False, False, True, False]


def test_mhsa_matches_flax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 9, 16)).astype(np.float32)
    mask = (rng.random((5, 9)) > 0.3).astype(np.float32)
    mask[2] = 0.0
    jm = jlayers.MultiHeadSelfAttention(embed_dim=16, num_heads=4)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0), x, mask)["params"])
    tm = tlayers.MultiHeadSelfAttention(16, 4)
    with torch.no_grad():
        for name, leaf in (("wqkv", ("Linear_0", "kernel")), ("bqkv", ("Linear_0", "bias")),
                           ("wo", ("Linear_1", "kernel")), ("bo", ("Linear_1", "bias"))):
            getattr(tm, name).copy_(torch.from_numpy(np.array(params[leaf[0]]["Dense_0"][leaf[1]])))
        for m in (mask, None):
            want = np.asarray(jm.apply({"params": params}, x, m))
            got = tm(torch.from_numpy(x), None if m is None else torch.from_numpy(m)).numpy()
            np.testing.assert_allclose(got, want, **FWD_TOL)


def test_block_checks_its_input():
    _, params, x, mask = flax_block(B=4, L=6)
    tparams, tx, tmask = port_params(params), torch.from_numpy(x), torch.from_numpy(mask)
    with pytest.raises(ValueError, match="multiple of num_heads"):
        fused_transformer_block(tparams, tx, tmask, 5)
    with pytest.raises(ValueError, match="mask"):
        fused_transformer_block(tparams, tx, tmask[:, :3].contiguous(), 2)
    with pytest.raises(ValueError, match="12 parameters"):
        fused_transformer_block(tparams[:5], tx, tmask, 2)
    with pytest.raises(ValueError, match="wo"):
        fused_transformer_block(tparams[:2] + [tparams[2][:, :8].contiguous()] + tparams[3:],
                                tx, tmask, 2)
    with pytest.raises(TypeError, match="float32"):
        fused_transformer_block(tparams, tx.double(), tmask, 2)
    with pytest.raises(ValueError, match="dropout"):
        tlayers.TransformerBlock(32, 2, 64, dropout=0.1)
    with pytest.raises(ValueError, match="num_heads"):
        tlayers.MultiHeadSelfAttention(30, 4)


def test_block_init_is_seeded_and_torch_default():
    a, b, c = (tlayers.TransformerBlock(32, 2, 64, generator=torch.Generator().manual_seed(s))
               for s in (1, 1, 2))
    for p, q in zip(a.fused_params(), b.fused_params()):
        assert torch.equal(p, q)
    assert not torch.equal(a.w1, c.w1)
    assert float(a.attn.wqkv.detach().abs().max()) <= 1 / np.sqrt(32)
    assert float(a.w2.detach().abs().max()) <= 1 / np.sqrt(64) < float(a.w1.detach().abs().max())
    assert torch.equal(a.g1, torch.ones(32)) and not a.b2.any()


# -- the pool's backward -------------------------------------------------------


@pytest.mark.parametrize("V,D,B,L,zipf", [(640, 16, 64, 5, False), (300, 8, 33, 30, False),
                                          (50, 3, 9, 4, False), (2000, 16, 64, 30, True)])
def test_pool_bwd_matches_jax_grad(monkeypatch, V, D, B, L, zipf):
    """Duplicates inside and across examples, padding id 0, masked slots, an
    all-zero mask row, and ids >= V, which JAX's scatter-add drops; and Zipf
    ids, whose most frequent id runs longer than the 32 slots the backward
    kernel sums in one warp."""
    monkeypatch.setenv("NRT_PALLAS", "")
    rng = np.random.default_rng(V)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, V, (B, L)).astype(np.int32)
    if zipf:
        ids = ((rng.zipf(1.05, (B, L)) - 1) % V).astype(np.int32)
        assert np.bincount(ids[ids > 0]).max() > 32
    ids[:, 0] = 7                                    # one id in every example
    ids[4, 1:3] = ids[4, 0]                          # and several times in one
    mask = (rng.random((B, L)) > 0.3).astype(np.float32)
    mask[2] = 0.0
    g = rng.standard_normal((B, D)).astype(np.float32)
    safe = jax.grad(lambda t: jnp.sum(jpool.fused_lookup_pool(t, ids, mask) * g))(table)
    got = pool_bwd_plain(*map(torch.from_numpy, (ids, mask, g)), V)
    np.testing.assert_allclose(got.numpy(), np.asarray(safe), rtol=1e-5, atol=1e-5)
    assert not got[0].any()
    # through autograd of the wrapper, on the CPU
    t = torch.from_numpy(table).requires_grad_()
    fused_lookup_pool(t, torch.from_numpy(ids), torch.from_numpy(mask)).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(safe), rtol=1e-5, atol=1e-5)
    # ids past the table: dropped by JAX's VJP, and by the port's
    ids[5, 1], ids[6, 2] = V, V + 1000
    mask[5, 1] = mask[6, 2] = 1.0
    _, vjp = jax.vjp(lambda t: jpool.fused_lookup_pool(t, ids, mask), table)
    want = np.asarray(vjp(jnp.asarray(g))[0])
    got = fused_lookup_pool_bwd(*map(torch.from_numpy, (ids, mask, g)), V)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_pool_bwd_drops_negative_ids():
    """The port's contract for negative ids (JAX wraps them around): the
    forward reads NaN, the backward drops them."""
    ids = torch.tensor([[1, -2, 3], [3, 0, 1]], dtype=torch.int32)
    mask, g = torch.ones(2, 3), torch.ones(2, 4)
    got = pool_bwd_plain(ids, mask, g, 5)
    assert torch.isfinite(got).all() and not got[[0, 2, 4]].any()
    torch.testing.assert_close(got[1], torch.full((4,), 1 / 3 + 1 / 2))
    torch.testing.assert_close(got[3], torch.full((4,), 1 / 3 + 1 / 2))


# -- the ranker ----------------------------------------------------------------


def attention_batch(cfg, n, seed):
    """Rows for an attention config, with empty, short and full histories."""
    arrays = jzoo.attention_arrays(n, seed=seed)
    rng = np.random.default_rng(seed + 100)
    lengths = rng.integers(0, 31, n)
    lengths[:3] = (0, 1, 30)
    arrays["hist"][np.arange(30)[None, :] >= lengths[:, None]] = 0
    arrays["hist_mask"] = (arrays["hist"] != 0).astype(np.float32)
    if "entities" in cfg.features.array_feature_names:
        extra = scoreboard_attention_arrays(n, seed)
        arrays["entities"] = extra["entities"]
        for f in ("subcategory", "user_click_category"):
            arrays[f] = rng.integers(1, tzoo.MIND_TABLE_SIZE[f], n).astype(np.int32)
    return arrays


ATTENTION_CONFIGS = {"attention_config": tzoo.attention_config,
                     "scoreboard": lambda: tzoo.mind_ranker_config("attention"),
                     "scoreboard@adamw": lambda: tzoo.mind_ranker_config("attention@adamw")}


@pytest.mark.parametrize("which", list(ATTENTION_CONFIGS))
@pytest.mark.parametrize("fused", ["off", "interpret"])
def test_attention_ranker_logits_match_jax(monkeypatch, which, fused):
    """Full width, batch 64, empty histories included; JAX on its flax block
    and on its Pallas block in interpret mode (whose garbage rows for empty
    histories the pooling zeroes)."""
    monkeypatch.setenv("NRT_FUSED_ATTN", fused)
    monkeypatch.setenv("NRT_PALLAS", "")
    cfg = ATTENTION_CONFIGS[which]()
    batch = attention_batch(cfg, 64, seed=1)
    jmodel = jbuild_ranker(cfg, "attention")
    params = jax_init(jmodel, batch)
    model = params_from_flax(params, build_ranker(cfg, "attention", device="cpu"))
    assert isinstance(model, AttentionSeqRanker) and model.unpooled_arrays == ("hist",)
    assert model.tower.layers[0].in_features == model.schema.total_dim
    with torch.inference_mode():
        got = model(torch_batch(batch)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(params, batch)), **FWD_TOL)
    # no hist_mask in the batch: the mask is hist != 0, on both sides
    batch.pop("hist_mask")
    with torch.inference_mode():
        np.testing.assert_array_equal(model(torch_batch(batch)).numpy(), got)


def test_attention_ranker_params_round_trip():
    cfg = tzoo.mind_ranker_config("attention")
    batch = attention_batch(cfg, 8, seed=2)
    params = jax_init(jbuild_ranker(cfg, "attention"), batch)
    model = params_from_flax(params, build_ranker(cfg, device="cpu"))
    flat, want = params_to_flax(model), flatten(params)
    assert sorted(flat) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(flat[key], value, err_msg=key)
    assert sum(k.startswith("blocks_0/") for k in flat) == 12
    seeded = params_to_flax(build_ranker(cfg, seed=3, device="cpu"))
    assert {k: v.shape for k, v in seeded.items()} == {k: v.shape for k, v in want.items()}
    with pytest.raises(KeyError, match="no port parameter"):
        params_from_flax({**want, "blocks_0/Dropout_0/rate": np.zeros(1)},
                         build_ranker(cfg, device="cpu"))


@pytest.mark.parametrize("raw,match", [
    ({"user_feature_names": ["user_id"]}, "needs 'hist'"),
    ({"item_feature_names": ["category"]}, "needs 'item_id'"),
])
def test_attention_ranker_checks_its_features(raw, match):
    from news_recsys_tpu_torch.config import config_to_dict

    d = config_to_dict(tzoo.attention_config())
    d["features"].update(raw)
    with pytest.raises(ValueError, match=match):
        build_ranker(config_from_dict(d), "attention", device="cpu")


# -- the sparse step -----------------------------------------------------------


def attention_dataset(cfg, steps, seed):
    return PackedDataset(attention_batch(cfg, steps * cfg.dataset.batch_size, seed))


@pytest.mark.parametrize("steps", [1, 3])
def test_attention_sparse_steps_match_jax_at_full_width(monkeypatch, steps):
    """``attention_config()``, batch 512: 15,872 item-table slots a step
    (512 x 30 history + 512 targets, duplicates many) and 512 user slots.
    Both take their dense full-table route for the item table (the port's:
    15,872 slots of 65,280 rows, above ``DENSE_UPDATE_MIN_SHARE``) and their
    sorted route for the user table: the tables agree on every addressable
    row."""
    monkeypatch.setenv("NRT_FUSED_ATTN", "off")
    cfg = tzoo.attention_config()
    ds = attention_dataset(cfg, steps, seed=3)
    packer = BatchPacker(ds)
    params = jax_init(jbuild_ranker(cfg, "attention"), ds.take(np.arange(512)))
    idx = step_indices(ds, cfg, steps)
    assert 512 * 31 == 15872 >= jss.DENSE_UPDATE_MIN_SLOTS
    jstate, jhist, jloss = jax_train(cfg, params, packer, idx, monkeypatch)
    state = port_state(cfg, params)
    assert sorted(state.emb_acc) == ["item_id", "user_id"]
    state, hist, loss = port_train(cfg, state, packer, idx)
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert_states_close(state, jstate, cfg)
    np.testing.assert_allclose(float(hist.pos.sum() + hist.neg.sum()),
                               float(np.asarray(jhist.pos).sum() + np.asarray(jhist.neg).sum()))


def test_scoreboard_attention_sparse_step_matches_jax(monkeypatch):
    """The scoreboard recipe (entities pooled, five sparse features), batch 64."""
    monkeypatch.setenv("NRT_FUSED_ATTN", "off")
    from news_recsys_tpu_torch.config import config_to_dict

    raw = config_to_dict(tzoo.mind_ranker_config("attention"))
    raw["dataset"]["batch_size"] = 64
    cfg = config_from_dict(raw)
    ds = attention_dataset(cfg, 2, seed=4)
    packer = BatchPacker(ds)
    params = jax_init(jbuild_ranker(cfg, "attention"), ds.take(np.arange(64)))
    idx = step_indices(ds, cfg, 2)
    jstate, _, jloss = jax_train(cfg, params, packer, idx, monkeypatch)
    state, _, loss = port_train(cfg, port_state(cfg, params), packer, idx)
    assert sorted(state.emb_acc) == ["entities", "item_id", "user_id"]
    np.testing.assert_allclose(loss, jloss, **TOL)
    assert_states_close(state, jstate, cfg)


def test_sparse_step_refuses_the_dense_optimizer():
    cfg = tzoo.attention_config(embedding_optimizer="adamw")
    model = build_ranker(cfg, "attention", device="cpu")
    with pytest.raises(ValueError, match="all-dense step"):
        tss.make_sparse_train_step(model, cfg)
    with pytest.raises(ValueError, match="all-dense step"):
        tss.init_sparse_state(model, cfg)


# -- serving -------------------------------------------------------------------

N_ITEMS, HIST_LEN, FETCH = 96, 6, 40


def small_attention_raw():
    return {
        "name": "attention",
        "features": {"sparse_feature_names": ["user_id", "item_id", "category"],
                     "array_feature_names": ["hist"],
                     "item_feature_names": ["item_id", "category"],
                     "user_feature_names": ["user_id", "hist"],
                     "array_max_length": {"hist": HIST_LEN}},
        "embeddings": {"embedding_size": {"user_id": 16, "item_id": 16, "category": 8},
                       "embedding_table_size": {"user_id": 64, "item_id": 128, "category": 8},
                       "share_emb_table_features": {"hist": "item_id"}},
        "attention_cfg": {"hist_feature": "hist", "num_layers": 2, "num_heads": 4, "ff_dim": 24},
    }


def item_arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"item_id": np.arange(1, N_ITEMS + 1, dtype=np.int32),
            "category": rng.integers(1, 8, N_ITEMS).astype(np.int32),
            "label": np.zeros((N_ITEMS, 1), np.float32)}


def users(n, seed=1):
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, N_ITEMS + 1, (n, HIST_LEN)).astype(np.int32)
    lengths = rng.integers(0, HIST_LEN + 1, n)
    lengths[0] = 0                                   # a user without history
    hist[np.arange(HIST_LEN)[None, :] >= lengths[:, None]] = 0
    return {"user_id": rng.integers(1, 64, n).astype(np.int32), "hist": hist,
            "label": np.zeros((n, 1), np.float32)}


@pytest.fixture(scope="module")
def attention_stacks():
    """(JAX cascade, port cascade): a DSSM recall and a two-block attention
    ranker, which the cascade feeds each user's ``hist`` once per candidate."""
    dcfg, rcfg = config_from_dict(small_dssm_raw(HIST_LEN)), config_from_dict(
        small_attention_raw())
    sample = {**users(8), **{k: v[:8] for k, v in item_arrays().items()}}
    jdssm, jranker = jbuild_dssm(dcfg), jbuild_ranker(rcfg, "attention")
    dparams, rparams = jax_init(jdssm, sample, seed=0), jax_init(jranker, sample, seed=1)
    jrecall = jserving.Recommender(dcfg, jdssm, dparams, PackedDataset(item_arrays()),
                                   backend="device", batch_size=16)
    jcasc = jserving.CascadeRecommender(jrecall, rcfg, jranker, rparams,
                                        PackedDataset(item_arrays()), fetch=FETCH)
    trecall = tserving.Recommender(dcfg, params_from_flax(dparams, build_dssm(dcfg, device="cpu")),
                                   tserving.PackedDataset(item_arrays()), device="cpu",
                                   batch_size=16)
    tcasc = tserving.CascadeRecommender(trecall, rcfg,
                                        params_from_flax(rparams, build_ranker(rcfg, device="cpu")),
                                        tserving.PackedDataset(item_arrays()), fetch=FETCH)
    return jcasc, tcasc


def test_attention_cascade_matches_jax(monkeypatch, attention_stacks):
    monkeypatch.setenv("NRT_PALLAS", "")
    jcasc, tcasc = attention_stacks
    assert len(tcasc.ranker_model.blocks) == 2
    assert tcasc.user_feature_names == ("hist", "user_id")
    batch = users(16, seed=2)
    got = tcasc.recommend(batch, k=10, histories=histories_of(batch))
    assert_same_answers(got, jcasc.recommend(batch, k=10, histories=histories_of(batch)),
                        tol=2e-5)
    for ids, scores, hist in zip(*got, histories_of(batch)):
        assert len(ids) == 10 and not set(ids) & set(hist)
        assert scores == sorted(scores, reverse=True)


def test_attention_cascade_bundle_and_export(monkeypatch, attention_stacks, tmp_path):
    """The port's bundle round trip (``config.json`` carries ``attention_cfg``),
    and ``scripts/export_torch_bundle.py`` on the JAX cascade bundle."""
    monkeypatch.setenv("NRT_PALLAS", "")
    jcasc, tcasc = attention_stacks
    batch = users(8, seed=5)
    want = tcasc.recommend(batch, k=5, histories=histories_of(batch))
    path = tcasc.save(str(tmp_path / "bundle"))
    with open(os.path.join(path, "ranker", "config.json")) as f:
        assert '"attention_cfg"' in f.read()
    loaded = tserving.CascadeRecommender.load(path, device="cpu")
    assert isinstance(loaded.ranker_model, AttentionSeqRanker)
    assert loaded.recommend(batch, k=5, histories=histories_of(batch)) == want
    spec = importlib.util.spec_from_file_location(
        "export_torch_bundle", os.path.join(REPO, "scripts", "export_torch_bundle.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = script.export(jcasc.save(str(tmp_path / "jax")), str(tmp_path / "torch"))
    assert_same_answers(tserving.CascadeRecommender.load(out, device="cpu").recommend(batch, k=6),
                        jcasc.recommend(batch, k=6), tol=2e-5)


# -- the planner: which route a shape takes, and how its launch is laid out ------

H100_SMS = 132
RANKER_SHAPE = (30, 32, 64, 2)                     # L, D, F, H of zoo.attention_config()
# the shapes the GPU tests run (tests/test_torch_cuda.py::BLOCK_SHAPES)
PLANNED_SHAPES = [(6400, 30, 32, 64, 2), (512, 30, 32, 64, 2), (24, 30, 32, 64, 2),
                  (7, 12, 16, 24, 1), (130, 50, 64, 96, 4), (3, 128, 128, 512, 8),
                  (5, 33, 24, 40, 3), (1, 1, 4, 4, 1)]


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B", [1, 2, 3, 511, 512, 513, 6400])
def test_plan_ranker_shape_takes_the_tiled_route(B, backward):
    """With no keyword the ranker's widths go to the tiled kernels, in both
    directions, at every batch; the plan is the same at every call."""
    plan = plan_shape(B, *RANKER_SHAPE, H100_SMS, backward)
    assert plan == plan_shape(B, *RANKER_SHAPE, H100_SMS, backward)
    assert plan.route == "tiled" and plan.tile_examples == 2 and plan.workspace_floats == 0
    assert plan.tiles(B) == (B + 1) // 2 and 1 <= plan.blocks <= plan.tiles(B)
    # the forward keeps three blocks on a multiprocessor, the backward one
    per_sm = 1 if backward else 3
    assert plan.blocks <= H100_SMS * per_sm
    assert per_sm * (plan.smem_bytes + 1024) <= 228 * 1024 < (per_sm + 1) * plan.smem_bytes


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("B,L,D,F,H", PLANNED_SHAPES)
def test_plan_covers_every_tested_shape(B, L, D, F, H, backward):
    plan = plan_shape(B, L, D, F, H, H100_SMS, backward)
    assert plan.route == ("tiled" if tiled_takes(L, D, F, H) else "general")
    assert plan.route == ("tiled" if (L, D, F, H) == RANKER_SHAPE else "general")
    assert 0 <= plan.smem_bytes <= SMEM_BYTES == 227 * 1024
    # a workspace that does not fit shared memory lies in device memory
    assert (plan.smem_bytes == 0) == (plan.workspace_floats > 0)
    tiles = plan.tiles(B)
    assert 1 <= plan.blocks <= tiles
    per_block = np.bincount(np.arange(tiles) % plan.blocks, minlength=plan.blocks)
    assert per_block.sum() == tiles and per_block.max() - per_block.min() <= 1


def test_plan_backward_has_no_short_second_round():
    """Batch 512 is 256 tiles of two examples over 132 blocks: every block
    walks one or two tiles."""
    plan = plan_shape(512, *RANKER_SHAPE, H100_SMS, True)
    per_block = np.bincount(np.arange(plan.tiles(512)) % plan.blocks)
    assert plan.blocks == H100_SMS and set(per_block) == {1, 2}


@pytest.mark.parametrize("L,D,F,H,takes", [
    (30, 32, 64, 2, True), (32, 32, 64, 2, True), (17, 32, 64, 2, True),
    (16, 32, 64, 2, False), (33, 32, 64, 2, False), (30, 32, 64, 4, False),
    (30, 32, 64, 1, False), (30, 64, 64, 4, False), (30, 32, 128, 2, False)])
def test_tiled_route_rule(L, D, F, H, takes):
    assert tiled_takes(L, D, F, H) is takes
    assert plan_shape(8, L, D, F, H, H100_SMS, False).route == ("tiled" if takes else "general")


def test_plan_forced_routes():
    assert plan_shape(512, *RANKER_SHAPE, H100_SMS, True, route="general").route == "general"
    assert plan_shape(512, *RANKER_SHAPE, H100_SMS, False, route="tiled").route == "tiled"
    with pytest.raises(ValueError, match="tiled route takes"):
        plan_shape(3, 128, 128, 512, 8, H100_SMS, False, route="tiled")
    with pytest.raises(ValueError, match="route must be"):
        plan_shape(3, 128, 128, 512, 8, H100_SMS, False, route="fast")


def test_route_keyword_is_checked_on_every_device():
    """On CPU tensors both routes are ``block_plain``; a route that the shape
    does not take raises all the same, forward and backward."""
    rng = np.random.default_rng(0)
    shapes = ((8, 24), (24,), (8, 8), (8,), (8,), (8,), (8, 12), (12,), (12, 8), (8,), (8,), (8,))
    params = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    x, mask = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(np.float32)), torch.ones(2, 5)
    want = block_plain(x, mask, *params, num_heads=2)
    torch.testing.assert_close(fused_transformer_block(params, x, mask, 2, route="general"), want)
    with pytest.raises(ValueError, match="tiled route takes"):
        fused_transformer_block(params, x, mask, 2, route="tiled")
    with pytest.raises(ValueError, match="tiled route takes"):
        fused_transformer_block_bwd(params, x, mask, torch.ones_like(x), 2, route="tiled")
