"""bfloat16 tables and towers (``mesh.param_dtype`` / ``compute_dtype``) of
the port against the JAX package's, on the CPU.

JAX draws each stochastic rounding's 16-bit noise inside the step from
``fold_in(fold_in(PRNGKey(seed), step), ti)`` (``1000 + ti`` on the dense
route); the port takes it from a noise function. These tests rebuild JAX's
bits outside the JAX package (:func:`jax_noise`) and hand them to the port.

Tolerances: ``stochastic_round_bf16`` bit for bit given the same bits; a
bfloat16 table within one bfloat16 ulp on its addressable rows (rows whose
float32 update already differs by a float32 ulp may round the other way;
the spare row above the vocab is written once for every empty slot, each
time with other noise, in both packages), and equal bits on all but a
few; float32 towers and optimizer state at the float32 step tolerance
(rtol 1e-5 / atol 5e-5); bfloat16 towers at ``BF16_TOL`` (rtol 2e-2,
atol 2e-2 on logits and losses, bfloat16's 8 bits of mantissa through a
5-layer tower) and, after a step, at an atol of 2.5 lr on the parameters
AdamW moves (its first step is lr * g / (|g| + 1e-8): a gradient within
bfloat16 rounding of 0 may take either sign).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recsys_tpu.config import table_specs
from news_recsys_tpu.data.packed_dataset import BatchPacker
from news_recsys_tpu.models.layers import MLP as JMLP
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu.training import sparse_step as jss
from news_recsys_tpu_torch.convert import (flatten_sparse_state, params_from_flax,
                                           sparse_state_from_jax, sparse_state_to_jax)
from news_recsys_tpu_torch.models.embedding import SMALL_VOCAB_THRESHOLD
from news_recsys_tpu_torch.models.layers import MLP
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.training import sparse_step as tss
from news_recsys_tpu_torch.training.checkpoint import load_state, load_state_dict, save_state
from news_recsys_tpu_torch.training.trainer import AucHist

from tests.test_torch_cuda import train_cfg, train_dataset
from tests.test_torch_models import jax_init, torch_batch
from tests.test_torch_training import (dedup_inputs, jax_params, jax_train, port_batches,
                                       step_indices)

torch.set_num_threads(2)
STEP_TOL = dict(rtol=1e-5, atol=5e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
BF16 = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"}


def jax_bits(seed: int, step: int, index: int, shape) -> np.ndarray:
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), step), index)
    return np.asarray(jax.random.bits(key, tuple(shape), jnp.uint32) & 0xFFFF).astype(np.int32)


def jax_noise(seed: int):
    """The port's noise function giving the JAX package's bits."""
    return lambda step, index, shape, device: torch.from_numpy(
        jax_bits(seed, step, index, shape)).to(device)


def ordered(bits) -> np.ndarray:
    """bfloat16 bits (``ml_dtypes.bfloat16`` or uint16) as integers in the
    order of their values, so a difference counts ulps."""
    u = np.asarray(bits).view(np.uint16).astype(np.int64)
    return np.where(u & 0x8000, -(u & 0x7FFF), u & 0x7FFF)


def assert_within_an_ulp(got, want, name, exact_share=0.99):
    ulps = np.abs(ordered(got) - ordered(want))
    assert ulps.max() <= 1, f"{name}: {ulps.max()} ulps"
    assert (ulps == 0).mean() >= exact_share, f"{name}: {(ulps == 0).mean():.4f} exact"


# -- stochastic rounding and the dense route -----------------------------------


def test_stochastic_round_bf16_matches_jax():
    """Bit for bit with JAX's bits: random values over many binades, both
    signs, values bfloat16 holds (which pass through), zeros."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((257, 33)) * 10.0 ** rng.integers(-6, 6, (257, 1))).astype(
        np.float32)
    x[0] = np.asarray(jnp.asarray(x[0]).astype(jnp.bfloat16).astype(jnp.float32))
    x[1] = 0.0
    key = jax.random.fold_in(jax.random.PRNGKey(3), 7)
    want = np.asarray(jss.stochastic_round_bf16(jnp.asarray(x), key)).view(np.uint16)
    noise = torch.from_numpy(
        np.asarray(jax.random.bits(key, x.shape, jnp.uint32) & 0xFFFF).astype(np.int32))
    got = tss.stochastic_round_bf16(torch.from_numpy(x), noise)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)
    np.testing.assert_array_equal(got[0].float().numpy(), x[0])


def test_dense_rowwise_adagrad_update_bf16_matches_jax():
    """The dense route on a bfloat16 table with JAX's bits for the whole
    table: within one ulp, and bit for bit on all but a few values;
    untouched rows keep their bits, the accumulators stay float32."""
    rng = np.random.default_rng(2)
    V, D = 640, 16
    table = jnp.asarray(rng.standard_normal((V, D)).astype(np.float32)).astype(jnp.bfloat16)
    acc = rng.uniform(0.1, 2.0, V).astype(np.float32)
    ids, g = dedup_inputs(rng, 300, 600, D)
    key = jax.random.fold_in(jax.random.PRNGKey(5), 1000)
    want_t, want_acc = jss.dense_rowwise_adagrad_update(
        table, jnp.asarray(acc), jnp.asarray(ids), jnp.asarray(g), 0.05, key=key, max_id=599)
    before = np.asarray(table).view(np.uint16)
    t = torch.from_numpy(before.astype(np.int16)).view(torch.bfloat16).clone()
    a = torch.from_numpy(acc.copy())
    noise = torch.from_numpy(np.asarray(jax.random.bits(key, (V, D), jnp.uint32) & 0xFFFF)
                             .astype(np.int32))
    tss.dense_rowwise_adagrad_update(t, a, torch.from_numpy(ids), torch.from_numpy(g), 0.05,
                                     max_id=599, noise=noise)
    assert t.dtype == torch.bfloat16 and a.dtype == torch.float32
    got = t.view(torch.int16).numpy().view(np.uint16)
    assert_within_an_ulp(got, np.asarray(want_t), "table")
    np.testing.assert_allclose(a.numpy(), np.asarray(want_acc), rtol=1e-5, atol=1e-5)
    untouched = np.setdiff1d(np.arange(V), np.unique(ids[(ids > 0) & (ids <= 599)]))
    np.testing.assert_array_equal(got[untouched], before[untouched])


# -- the models ----------------------------------------------------------------


def test_bf16_tower_matches_flax():
    """``MLP`` with a bfloat16 compute dtype against flax's: float32
    parameters, bfloat16 matmuls, a float32 output."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 40)).astype(np.float32)
    jmlp = JMLP(dims=(128, 64, 1), dtype=jnp.bfloat16)
    params = jax.device_get(jmlp.init(jax.random.PRNGKey(0), x))
    want = np.asarray(jmlp.apply(params, x))
    mlp = MLP(40, (128, 64, 1), compute_dtype=torch.bfloat16)
    for i, layer in enumerate(mlp.layers):
        dense = params["params"][f"Linear_{i}"]["Dense_0"]
        layer.weight.data = torch.from_numpy(np.asarray(dense["kernel"]).T.copy())
        layer.bias.data = torch.from_numpy(np.array(dense["bias"]))
    got = mlp(torch.from_numpy(x))
    assert got.dtype == torch.float32 and layer.weight.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("arena", [True, False], ids=["arena", "tables"])
def test_bf16_ranker_forward_matches_jax(arena):
    """A DCN with bfloat16 tables and towers from the JAX package's
    parameters: the large tables stored as bfloat16 (``category`` stays
    float32), lookups in float32, and, without the arena, ``hist`` pooled
    over the bfloat16 item table in plain ops (no pool kernel)."""
    cfg = train_cfg(arena, mesh=BF16)
    ds = train_dataset(cfg, 64, seed=1)
    jmodel = jbuild_ranker(cfg, cfg.name)
    batch = ds.take(np.arange(64))
    params = jax_init(jmodel, batch)
    model = params_from_flax(params, build_ranker(cfg, device="cpu"))
    for name, (vocab, _) in table_specs(cfg).items():
        want = torch.bfloat16 if vocab >= SMALL_VOCAB_THRESHOLD else torch.float32
        assert model.embedder.tables[name].dtype == want, name
    with torch.inference_mode():
        got = model(torch_batch(batch)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(params, batch)), **BF16_TOL)


# -- the step ------------------------------------------------------------------


def port_steps(cfg, params, packer, idx, seed):
    state = tss.init_sparse_state(params_from_flax(params, build_ranker(cfg, device="cpu")), cfg)
    step = tss.make_sparse_train_step(state.model, cfg, noise=jax_noise(seed))
    hist, losses = AucHist.zeros("cpu"), []
    for batch in port_batches(packer, idx):
        losses.append(float(step(state, batch, hist)[0]))
    return state, losses


def assert_bf16_states_close(state, jstate, cfg, dense_tol):
    """Large bfloat16 tables within an ulp on addressable rows; every other
    parameter and AdamW's moments at ``dense_tol``; the rowwise optimizer's
    float32 state at the float32 step tolerance."""
    got, want = sparse_state_to_jax(state), flatten_sparse_state(jstate)
    vocab = {f"embedder/{t}": v for t, (v, d) in table_specs(cfg).items()
             if v >= SMALL_VOCAB_THRESHOLD}
    assert sorted(got["params"]) == sorted(want["params"])
    for path, w in want["params"].items():
        if path in vocab:
            assert got["params"][path].dtype == np.uint16, path
            assert_within_an_ulp(got["params"][path][:vocab[path]], w[:vocab[path]], path)
        else:
            np.testing.assert_allclose(got["params"][path], w, err_msg=path, **dense_tol)
    for section in ("emb_mu", "emb_nu"):
        for t, w in want[section].items():
            n = vocab[f"embedder/{t}"]
            np.testing.assert_allclose(got[section][t][:n], w[:n], err_msg=f"{section} {t}",
                                       **STEP_TOL)
    for key in ("mu", "nu"):
        for path, w in want["dense_opt"][key].items():
            np.testing.assert_allclose(got["dense_opt"][key][path], w, err_msg=path,
                                       rtol=dense_tol["rtol"], atol=dense_tol["atol"])


@pytest.mark.parametrize("optimizer", ["rowwise_adagrad", "sparse_adamw"])
def test_bf16_table_steps_match_jax(monkeypatch, optimizer):
    """Two steps with bfloat16 tables and float32 towers, JAX's bits handed
    to the port: the unique-row layout on both sides, each row rounded once."""
    cfg = train_cfg(True, mesh={"param_dtype": "bfloat16"}, embedding_optimizer=optimizer)
    ds = train_dataset(cfg, 128, seed=31)
    params = jax_params(cfg, ds, seed=2)
    idx = step_indices(ds, cfg, 2)
    jstate, _, jloss = jax_train(cfg, params, BatchPacker(ds), idx, monkeypatch)
    state, losses = port_steps(cfg, params, BatchPacker(ds), idx, cfg.train_hparams.seed)
    np.testing.assert_allclose(losses[-1], jloss, **STEP_TOL)
    assert_bf16_states_close(state, jstate, cfg, STEP_TOL)


def test_bf16_dcn_at_batch_512_matches_jax(monkeypatch):
    """``bench.py``'s bf16 line at batch 512 (1,024 arena slots): bfloat16
    tables and towers on ``rowwise_adagrad``, one step, JAX's bits."""
    cfg = train_cfg(True, batch_size=512, mesh=BF16)
    ds = train_dataset(cfg, 512, seed=32)
    params = jax_params(cfg, ds, seed=3)
    idx = step_indices(ds, cfg, 1)
    jstate, _, jloss = jax_train(cfg, params, BatchPacker(ds), idx, monkeypatch)
    state, losses = port_steps(cfg, params, BatchPacker(ds), idx, cfg.train_hparams.seed)
    np.testing.assert_allclose(losses[-1], jloss, **BF16_TOL)
    lr = cfg.train_hparams.lr
    assert_bf16_states_close(state, jstate, cfg, dict(rtol=2e-2, atol=2.5 * lr))


# -- checkpoints ---------------------------------------------------------------


def test_bf16_state_checkpoint_round_trips(monkeypatch, tmp_path):
    """JAX -> port -> JAX gives the bfloat16 table's bits back (as uint16);
    port -> port through a checkpoint keeps the table bfloat16 and its
    bits; a float32 table does not load into a bfloat16 state."""
    cfg = train_cfg(True, mesh={"param_dtype": "bfloat16"}, embedding_optimizer="sparse_adamw")
    ds = train_dataset(cfg, 64, seed=33)
    params = jax_params(cfg, ds, seed=4)
    jstate, _, _ = jax_train(cfg, params, BatchPacker(ds), step_indices(ds, cfg, 1),
                             monkeypatch)
    want = flatten_sparse_state(jstate)
    state = sparse_state_from_jax(jstate, build_ranker(cfg, device="cpu"), cfg)
    got = sparse_state_to_jax(state)
    for section in ("params", "emb_mu", "emb_nu"):
        for k, v in want[section].items():
            w = np.asarray(v).view(np.uint16) if v.dtype.name == "bfloat16" else v
            np.testing.assert_array_equal(got[section][k], w, err_msg=f"{section} {k}")
    path = save_state(str(tmp_path / "s.pt"), state)
    fresh = tss.init_sparse_state(build_ranker(cfg, seed=5, device="cpu"), cfg)
    loaded = load_state_dict(fresh, load_state(path))
    table = loaded.model.embedder.tables["arena_d16"]
    assert table.dtype == torch.bfloat16
    assert torch.equal(table, state.model.embedder.tables["arena_d16"])
    f32 = tss.init_sparse_state(build_ranker(train_cfg(True, embedding_optimizer="sparse_adamw"),
                                             device="cpu"),
                                train_cfg(True, embedding_optimizer="sparse_adamw"))
    with pytest.raises(ValueError, match="bfloat16"):
        load_state_dict(f32, load_state(path))
    with pytest.raises(ValueError, match="bfloat16"):
        params_from_flax(want["params"], build_ranker(train_cfg(True), device="cpu"))
