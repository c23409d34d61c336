"""The port's layers, embedding engine, DCN ranker and DSSM towers against
the JAX package's, on the same config, the same parameters (JAX init,
converted by ``news_recsys_tpu_torch.convert``) and the same numpy inputs.

The JAX Pallas kernels run in interpret mode. Tolerances: 1e-5 on layer
and embedding outputs, atol 1e-4 on logits (float32, different summation
order through several layers).
"""

import jax
import numpy as np
import pytest
import torch

from news_recsys_tpu import zoo as jzoo
from news_recsys_tpu.config import (ARRAY, DENSE, build_schema, config_from_dict,
                                    config_to_dict, load_config, table_specs)
from news_recsys_tpu.models import layers as jlayers
from news_recsys_tpu.models.dssm import build_dssm as jbuild_dssm
from news_recsys_tpu.models.embedding import EmbeddingCollection as JEmbeddingCollection
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu_torch import zoo as tzoo
from news_recsys_tpu_torch.convert import flatten, params_from_flax, params_to_flax
from news_recsys_tpu_torch.models import layers as tlayers
from news_recsys_tpu_torch.models.dssm import build_dssm
from news_recsys_tpu_torch.models.embedding import EmbeddingCollection, padded_vocab
from news_recsys_tpu_torch.models.rankers import build_ranker

torch.set_num_threads(2)


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("NRT_PALLAS", "interpret")


def small_dcn_raw(arena=False):
    """The ranker of the cascade tests (tests/test_cascade.py), 2 cross layers."""
    return {
        "name": "dcn",
        "features": {"sparse_feature_names": ["user_id", "item_id", "category"],
                     "item_feature_names": ["item_id", "category"],
                     "user_feature_names": ["user_id"]},
        "embeddings": {"embedding_size": {"user_id": 16, "item_id": 16, "category": 16},
                       "embedding_table_size": {"user_id": 64, "item_id": 128,
                                                "category": 8},
                       "arena_tables": arena},
        "dcn_cfg": {"num_layers": 2, "version": 1},
    }


def small_dssm_raw(hist_len=6):
    """A narrow DSSM whose user tower pools a click history over the item table."""
    return {
        "name": "dssm",
        "features": {"sparse_feature_names": ["user_id", "item_id", "category"],
                     "array_feature_names": ["hist"],
                     "item_feature_names": ["item_id", "category"],
                     "user_feature_names": ["user_id", "hist"],
                     "array_max_length": {"hist": hist_len}},
        "embeddings": {"embedding_size": {"user_id": 16, "item_id": 16, "category": 16},
                       "embedding_table_size": {"user_id": 64, "item_id": 128,
                                                "category": 8},
                       "share_emb_table_features": {"hist": "item_id"}},
    }


def jax_init(model, batch, seed=0, method=None):
    kwargs = {"method": method} if method is not None else {}
    return jax.device_get(model.init(jax.random.PRNGKey(seed), batch, **kwargs))


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items() if k != "label"}


def ranker_batch(rng, B, vocab):
    batch = {name: rng.integers(1, v, B).astype(np.int32) for name, v in vocab.items()}
    batch["label"] = np.zeros((B, 1), np.float32)
    return batch


def history(rng, B, L, vocab):
    hist = rng.integers(1, vocab, (B, L)).astype(np.int32)
    hist[np.arange(L)[None, :] >= rng.integers(0, L + 1, B)[:, None]] = 0
    return hist


# -- config ------------------------------------------------------------------


def _config_sources():
    return {"dcn.yaml": lambda: load_config("configs/dcn.yaml"),
            "dssm.yaml": lambda: load_config("configs/dssm.yaml"),
            "small-dcn-arena": lambda: config_from_dict(small_dcn_raw(arena=True))}


def schema_batch(cfg, B=2):
    """A zero batch with every feature of ``cfg``'s default schema."""
    batch = {}
    for spec in build_schema(cfg).specs:
        shape = (B, spec.max_length) if spec.kind == ARRAY else (B,)
        batch[spec.name] = np.zeros(shape, np.float32 if spec.kind == DENSE else np.int32)
    batch["label"] = np.zeros((B, 1), np.float32)
    return batch


@pytest.mark.parametrize("source", list(_config_sources()))
def test_config_schema_and_tables_match_jax(source):
    """A port model built from one of the JAX package's configs has the JAX
    model's parameter tree: the same flax paths, the tables of
    ``table_specs`` at their padded vocab (arena offsets included), and the
    same tower widths."""
    cfg = _config_sources()[source]()
    is_dssm = cfg.name == "dssm"
    jmodel = jbuild_dssm(cfg) if is_dssm else jbuild_ranker(cfg, cfg.name)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), schema_batch(cfg)))
    want = {k: v.shape for k, v in flatten(
        jax.tree.map(lambda s: np.empty(s.shape, s.dtype), shapes)).items()}
    model = build_dssm(cfg, device="cpu") if is_dssm else build_ranker(cfg, cfg.name, device="cpu")
    got = {k: v.shape for k, v in params_to_flax(model).items()}
    assert got == want
    assert {name: tuple(t.shape) for name, t in model.embedder.tables.items()} == {
        name: (padded_vocab(vocab), dim) for name, (vocab, dim) in table_specs(cfg).items()}


def test_zoo_configs_match_jax():
    """``mind_dssm_config`` equals ``configs/dssm.yaml`` field by field; the
    ranker config and table sizes equal the JAX package's (the port keeps
    its own copies: tests/test_torch_shared.py holds every one of them)."""
    got, want = config_to_dict(tzoo.mind_dssm_config()), config_to_dict(
        load_config("configs/dssm.yaml"))
    assert sorted(got) == sorted(want)
    for section in want:
        assert got[section] == want[section], section
    assert config_to_dict(tzoo.mind_config("dcn")) == config_to_dict(jzoo.mind_config("dcn"))
    assert tzoo.MIND_TABLE_SIZE == jzoo.MIND_TABLE_SIZE


# -- layers ------------------------------------------------------------------


def test_mlp_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 24)).astype(np.float32)
    jmlp = jlayers.MLP(dims=(32, 8, 1))
    params = jax_init(jmlp, x)
    want = np.asarray(jmlp.apply(params, x))
    holder = torch.nn.Module()
    holder.tower = tlayers.MLP(24, (32, 8, 1))
    params_from_flax({"tower": params["params"]}, holder)
    np.testing.assert_allclose(holder.tower(torch.from_numpy(x)).detach().numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_linear_init_is_torch_default_and_seeded():
    a = tlayers.Linear(50, 20, torch.Generator().manual_seed(3))
    b = tlayers.Linear(50, 20, torch.Generator().manual_seed(3))
    bound = 1 / np.sqrt(50)
    assert a.weight.shape == (20, 50)
    assert a.weight.abs().max() <= bound and a.bias.abs().max() <= bound
    assert a.weight.std() > 0.5 * bound / np.sqrt(3)
    torch.testing.assert_close(a.weight, b.weight)


# -- embeddings --------------------------------------------------------------


def test_embedding_collection_matches_jax(pallas_interpret):
    """Arena offsets and clamp, padding row 0, NaN for ids past a table, and
    the pooled array feature."""
    raw = {
        "features": {"sparse_feature_names": ["user_id", "item_id", "category"],
                     "array_feature_names": ["cat_hist"],
                     "array_max_length": {"cat_hist": 5}},
        "embeddings": {"embedding_size": {"user_id": 8, "item_id": 8, "category": 8},
                       "embedding_table_size": {"user_id": 5000, "item_id": 4500,
                                                "category": 10},
                       "share_emb_table_features": {"cat_hist": "category"},
                       "arena_tables": True},
    }
    cfg = config_from_dict(raw)
    names = ["cat_hist", "category", "item_id", "user_id"]
    schema = build_schema(cfg, names)
    assert table_specs(cfg) == {"arena_d8": (9499, 8), "category": (10, 8)}
    rng = np.random.default_rng(0)
    B = 16
    batch = {"user_id": rng.integers(0, 5000, B).astype(np.int32),
             "item_id": rng.integers(0, 4500, B).astype(np.int32),
             "category": rng.integers(0, 10, B).astype(np.int32),
             "cat_hist": history(rng, B, 5, 10)}
    batch["user_id"][:4] = [0, 4999, 5000, -3]          # padding, last, past member, < 0
    batch["item_id"][:3] = [0, 4500, 9000]
    batch["category"][5] = 500                          # past the padded table: NaN
    jec = JEmbeddingCollection.from_config(cfg)
    params = jax_init(jec, batch, method=lambda m, b: m.embed_batch(b, schema))
    want = np.asarray(jec.apply(params, batch, schema,
                                method=JEmbeddingCollection.embed_batch))
    holder = torch.nn.Module()
    holder.embedder = EmbeddingCollection(table_specs(cfg))
    params_from_flax({"embedder": params["params"]}, holder)
    got = holder.embedder.embed_batch(torch_batch(batch), schema).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)   # NaNs in the same places
    assert np.isnan(got[5]).any() and not np.isnan(np.delete(got, 5, axis=0)).any()
    user = schema["user_id"]
    np.testing.assert_array_equal(got[[0, 2, 3], user.offset:user.offset + 8], 0.0)


def test_embedding_init_and_padding():
    ec = EmbeddingCollection({"t": (1000, 4)}, init_scale=0.5,
                             generator=torch.Generator().manual_seed(0))
    table = ec.tables["t"]
    assert table.shape == (padded_vocab(1000), 4) == (1024, 4)
    assert (table[0] == 0).all() and 0.4 < table[1:].std() < 0.6
    pooled = EmbeddingCollection.pool(torch.ones(2, 3, 4), torch.tensor([[1., 1, 0], [0, 0, 0]]))
    torch.testing.assert_close(pooled, torch.tensor([[1.0] * 4, [0.0] * 4]), rtol=1e-6,
                               atol=1e-6)


# -- rankers -----------------------------------------------------------------


def test_dcn_logits_match_jax(pallas_interpret):
    cfg = config_from_dict(small_dcn_raw())
    rng = np.random.default_rng(1)
    batch = ranker_batch(rng, 64, {"user_id": 64, "item_id": 128, "category": 8})
    jmodel = jbuild_ranker(cfg, "dcn")
    params = jax_init(jmodel, batch)
    model = params_from_flax(params, build_ranker(cfg, "dcn", device="cpu"))
    assert model.cross.ws.shape == (2, 48)
    with torch.inference_mode():
        got = model(torch_batch(batch)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(params, batch)), atol=1e-4)


def test_dcn_logits_match_jax_at_full_mind_width(pallas_interpret):
    """zoo.mind_config("dcn"): arena_d32 159,360 x 32, concat 112, 3 cross
    layers, MLP 224 -> 128-128-128-64-1, batch 64."""
    cfg = tzoo.mind_config("dcn")
    batch = jzoo.synthetic_batch(64, seed=2)
    batch.pop("_valid")
    jmodel = jbuild_ranker(cfg, "dcn")
    params = jax_init(jmodel, batch)
    model = params_from_flax(params, build_ranker(cfg, "dcn", device="cpu"))
    assert model.embedder.tables["arena_d32"].shape == (159360, 32)
    assert model.schema.total_dim == 112 and model.cross.ws.shape == (3, 112)
    with torch.inference_mode():
        got = model(torch_batch(batch)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(params, batch)), atol=1e-4)


@pytest.mark.parametrize("name,extra,err", [
    ("nope", {}, ValueError),
], ids=["nope-extra1-ValueError"])       # the id it had beside the bf16 case
def test_build_ranker_names_what_is_not_ported(name, extra, err):
    cfg = config_from_dict({**small_dcn_raw(), **extra})
    with pytest.raises(err, match="ROADMAP" if err is NotImplementedError else "Unknown"):
        build_ranker(cfg, name, device="cpu")


def test_build_ranker_is_seeded():
    cfg = config_from_dict(small_dcn_raw())
    a, b, c = (build_ranker(cfg, seed=s, device="cpu") for s in (7, 7, 8))
    torch.testing.assert_close(a.tower.layers[0].weight, b.tower.layers[0].weight)
    assert not torch.equal(a.cross.ws, c.cross.ws)


# -- DSSM --------------------------------------------------------------------


def test_dssm_towers_match_jax(pallas_interpret):
    dssm_towers_match_jax(config_from_dict(small_dssm_raw()), B=32, seed=3)


def test_dssm_towers_match_jax_at_full_mind_width(pallas_interpret):
    """``mind_dssm_config()`` (configs/dssm.yaml): user 94,058 x 16, item
    65,239 x 16, ``hist`` of 30 pooled over the item table, batch 64."""
    dssm_towers_match_jax(tzoo.mind_dssm_config(), B=64, seed=4)


def dssm_towers_match_jax(cfg, B, seed):
    rng = np.random.default_rng(seed)
    sizes = cfg.embeddings.embedding_table_size
    batch = ranker_batch(rng, B, {n: sizes[n] for n in build_schema(cfg).names
                                  if n != "hist"})
    batch["hist"] = history(rng, B, cfg.features.array_max_length["hist"],
                            sizes["item_id"])
    jmodel = jbuild_dssm(cfg)
    params = jax_init(jmodel, batch)
    model = params_from_flax(params, build_dssm(cfg, device="cpu"))
    tb = torch_batch(batch)
    with torch.inference_mode():
        got_u, got_i = model.user_embedding(tb).numpy(), model.item_embedding(tb).numpy()
    want_u = np.asarray(jmodel.apply(params, batch, method=type(jmodel).user_embedding))
    want_i = np.asarray(jmodel.apply(params, batch, method=type(jmodel).item_embedding))
    np.testing.assert_allclose(got_u, want_u, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_i, want_i, rtol=1e-5, atol=1e-5)


# -- conversion --------------------------------------------------------------


def test_params_round_trip_through_flax_paths():
    cfg = config_from_dict(small_dcn_raw())
    batch = ranker_batch(np.random.default_rng(0), 8, {"user_id": 64, "item_id": 128,
                                                       "category": 8})
    params = jax_init(jbuild_ranker(cfg, "dcn"), batch)
    flat = params_to_flax(params_from_flax(params, build_ranker(cfg, device="cpu")))
    want = flatten(params)
    assert sorted(flat) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(flat[key], value, err_msg=key)


def test_params_from_flax_is_strict():
    model = build_ranker(config_from_dict(small_dcn_raw()), device="cpu")
    flat = params_to_flax(model)
    with pytest.raises(KeyError, match="no port parameter"):
        params_from_flax({**flat, "head/scale": np.zeros(1)}, model)
    flat.pop("cross/w_1")
    with pytest.raises(RuntimeError):
        params_from_flax(flat, model)
