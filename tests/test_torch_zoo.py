"""The port's ranking zoo (LR, Deep, Wide&Deep, FM, DeepFM, DCN-v2) and its
FM second order against the JAX package's, on the CPU.

Same configs, same parameters (JAX init, converted by
``news_recsys_tpu_torch.convert``) and the same numpy inputs. JAX's FM runs
on its Pallas path in interpret mode (``NRT_PALLAS=interpret``) and on its
XLA path. Tolerances: rtol = atol = 1e-5 on the FM second order and its
gradient (float32, F products summed per column in another order); atol
1e-4 on logits, as for DCN in tests/test_torch_models.py (several layers of
float32 sums in other orders). The autograd backward on the CPU is
``fm_bwd_plain`` itself, bit for bit.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from news_recsys_tpu.config import config_from_dict, config_to_dict, load_config
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu.ops import fm_kernel as jfm
from news_recsys_tpu_torch.convert import flatten, params_from_flax, params_to_flax
from news_recsys_tpu_torch.models.embedding import padded_vocab
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.ops.fm_kernel import fm_bwd_plain, fm_plain, fm_second_order
from news_recsys_tpu_torch.zoo import RANKER_RECIPES, mind_ranker_config

from tests.test_torch_cuda import fm_inputs, train_dataset, zoo_train_cfg
from tests.test_torch_models import jax_init, torch_batch

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = ("lr", "deep", "widedeep", "fm", "deepfm", "dcn@v2")
FM_TOL = dict(rtol=1e-5, atol=1e-5)


# -- the FM second order -------------------------------------------------------


@pytest.mark.parametrize("mode", ["", "interpret"], ids=["xla", "pallas"])
@pytest.mark.parametrize("shape", [(256, 5, 15), (512, 5, 15), (37, 3, 7), (1, 1, 4)])
def test_fm_second_order_matches_jax(monkeypatch, mode, shape):
    """(256, 5, 15) and (512, 5, 15) take JAX's Pallas kernel in interpret
    mode, (37, 3, 7) and (1, 1, 4) its XLA fallback (B not a multiple of
    the tile) in both modes."""
    monkeypatch.setenv("NRT_PALLAS", mode)
    v, g = fm_inputs(*shape, seed=sum(shape))
    want = np.asarray(jfm.fm_second_order(v))
    want_dv = np.asarray(jax.grad(lambda x: jax.numpy.dot(jfm.fm_second_order(x), g))(v))
    tv = torch.from_numpy(v).requires_grad_()
    got = fm_second_order(tv)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), want, **FM_TOL)
    np.testing.assert_allclose(tv.grad.numpy(), want_dv, **FM_TOL)
    assert torch.equal(tv.grad, fm_bwd_plain(torch.from_numpy(v), torch.from_numpy(g)))
    assert torch.equal(got.detach(), fm_plain(torch.from_numpy(v)))


def test_fm_second_order_checks_its_input():
    with pytest.raises(TypeError, match="float32"):
        fm_second_order(torch.zeros(4, 2, 3, dtype=torch.float64))
    with pytest.raises(ValueError, match="3-D"):
        fm_second_order(torch.zeros(4, 6))
    with pytest.raises(ValueError, match="contiguous"):
        fm_second_order(torch.zeros(4, 3, 2).transpose(1, 2))


# -- the rankers ---------------------------------------------------------------


def scoreboard_attention_arrays(n, seed):
    """``hist`` (n, 30) with ragged lengths (row 0 empty, row 1 full) and its
    mask, and ``entities`` (n, 5) with padding, for the scoreboard attention
    recipe."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, 65239, (n, 30)).astype(np.int32)
    lengths = rng.integers(0, 31, n)
    lengths[:2] = (0, 30)
    hist[np.arange(30)[None, :] >= lengths[:, None]] = 0
    entities = rng.integers(1, 30000, (n, 5)).astype(np.int32)
    entities[np.arange(5)[None, :] >= rng.integers(0, 6, n)[:, None]] = 0
    return {"hist": hist, "hist_mask": (hist != 0).astype(np.float32), "entities": entities}


def init_both(cfg, n=64, seed=1):
    """(JAX model, its init params, port model with those params, batch)."""
    batch = train_dataset(cfg, n, seed=seed).take(np.arange(n))
    jmodel = jbuild_ranker(cfg, cfg.name)
    params = jax_init(jmodel, batch, seed=seed)
    return jmodel, params, params_from_flax(params, build_ranker(cfg, device="cpu")), batch


@pytest.mark.parametrize("arena", [True, False], ids=["arena", "tables"])
@pytest.mark.parametrize("name", ZOO)
def test_ranker_logits_match_jax(monkeypatch, name, arena):
    monkeypatch.setenv("NRT_PALLAS", "interpret")
    jmodel, params, model, batch = init_both(zoo_train_cfg(name, arena))
    with torch.inference_mode():
        got = model(torch_batch(batch)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(params, batch)), atol=1e-4)


@pytest.mark.parametrize("name", RANKER_RECIPES)
def test_ranker_logits_match_jax_at_scoreboard_width(monkeypatch, name):
    """``mind_ranker_config(name)``: the arena table at its scoreboard width
    (159,360 rows of 1, 16 or 32), the small tables, batch 64. The attention
    recipes form no arena (the item table backs ``hist``): user 94,080 x 32,
    item 65,280 x 32 and entities 30,080 x 16, with empty histories."""
    from news_recsys_tpu.zoo import synthetic_batch

    monkeypatch.setenv("NRT_PALLAS", "interpret")
    cfg = mind_ranker_config(name)
    batch = synthetic_batch(64, seed=5)
    batch.pop("_valid")
    if cfg.name == "attention":
        batch.update(scoreboard_attention_arrays(64, seed=6))
    jmodel = jbuild_ranker(cfg, cfg.name)
    params = jax_init(jmodel, batch)
    model = params_from_flax(params, build_ranker(cfg, device="cpu"))
    if cfg.name == "attention":
        assert {t: tuple(p.shape) for t, p in model.embedder.tables.items()
                if p.shape[0] > 4096} == {"user_id": (94080, 32), "item_id": (65280, 32),
                                          "entities": (30080, 16)}
    else:
        dim = {"lr": 1, "fm": 16, "deepfm": 16}.get(cfg.name, 32)
        assert model.embedder.tables[f"arena_d{dim}"].shape == (padded_vocab(159296), dim) == (
            159360, dim)
    with torch.inference_mode():
        got = model(torch_batch(batch)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(params, batch)), atol=1e-4)


@pytest.mark.parametrize("name", ZOO + ("dcn",))
def test_params_round_trip_through_flax_paths(name):
    _, params, model, _ = init_both(zoo_train_cfg(name, arena=False), n=8)
    flat, want = params_to_flax(model), flatten(params)
    assert sorted(flat) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(flat[key], value, err_msg=key)
    seeded = params_to_flax(build_ranker(zoo_train_cfg(name, arena=False), seed=3, device="cpu"))
    assert {k: v.shape for k, v in seeded.items()} == {k: v.shape for k, v in want.items()}


def test_param_names_map_one_to_one():
    """``bias``, ``tower.layers.<i>`` and DCN-v2's ``cross.layers.<i>``."""
    names = {n: dict(build_ranker(zoo_train_cfg(n), device="cpu").named_parameters()) for n in ZOO}
    assert set(names["lr"]) == {f"embedder.tables.{t}" for t in
                                ("arena_d1", "category", "subcategory")}
    assert names["deepfm"]["bias"].shape == names["fm"]["bias"].shape == (1,)
    assert names["widedeep"]["tower.layers.0.weight"].shape == (128, 16 + 16 + 8 + 8)
    assert "bias" not in names["deep"] and "bias" not in names["dcn@v2"]
    assert names["dcn@v2"]["cross.layers.1.weight"].shape == (48, 48)
    flat = params_to_flax(build_ranker(zoo_train_cfg("dcn@v2"), device="cpu"))
    assert "cross/Linear_1/Dense_0/kernel" in flat and "tower/Linear_4/Dense_0/bias" in flat


def test_params_from_flax_is_strict_for_the_zoo():
    model = build_ranker(zoo_train_cfg("deepfm"), device="cpu")
    flat = params_to_flax(model)
    with pytest.raises(KeyError, match="no port parameter"):
        params_from_flax({**flat, "wide/bias": np.zeros(1)}, model)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        params_from_flax({**flat, "cross/w_0": np.zeros((40, 1))}, model)
    flat.pop("bias")
    with pytest.raises(RuntimeError):
        params_from_flax(flat, model)


def test_fm_models_require_equal_dims():
    cfg = zoo_train_cfg("deep")                  # 16-wide large tables, 8-wide small
    batch = torch_batch(train_dataset(cfg, 4, seed=0).take(np.arange(4)))
    for name, what in (("fm", "FM"), ("deepfm", "DeepFM")):
        with pytest.raises(AssertionError, match=f"{what} requires equal embedding dims"):
            build_ranker(cfg, name, device="cpu")(batch)


def test_widedeep_needs_a_wide_feature_in_the_schema():
    raw = config_to_dict(zoo_train_cfg("widedeep"))
    raw["wide_and_deep_cfg"] = {"wide_feature_names": ["hist", "nope"]}
    cfg = config_from_dict(raw)
    for build in (jbuild_ranker, build_ranker):
        with pytest.raises(ValueError, match="widedeep requires wide_and_deep_cfg"):
            build(cfg, "widedeep")


def test_build_ranker_builds_the_zoo():
    for name in ZOO + ("dcn",):
        cfg = zoo_train_cfg(name)
        model = build_ranker(cfg, seed=2, device="cpu")
        assert type(model).__name__ == type(jbuild_ranker(cfg, cfg.name)).__name__
    v2 = build_ranker(zoo_train_cfg("dcn@v2"), device="cpu")
    assert type(v2.cross).__name__ == "CrossNetV2" and len(v2.cross.layers) == 2


# -- the scoreboard configs ----------------------------------------------------


def fullscale_config(name: str, tmp_path, monkeypatch) -> dict:
    """The config ``scripts/fullscale_rankers.py`` writes for ``name``
    from ``configs/<model>.yaml``; its training subprocess is not started."""
    spec = importlib.util.spec_from_file_location(
        "fullscale_rankers", os.path.join(REPO, "scripts", "fullscale_rankers.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)

    class Stop(Exception):
        pass

    def stop(*args, **kwargs):
        raise Stop

    monkeypatch.setattr(script.subprocess, "run", stop)
    model = name.split("@")[0]
    with pytest.raises(Stop):
        script.run_model(name, os.path.join(REPO, "configs", f"{model}.yaml"), 1,
                         str(tmp_path), "auto")
    return config_to_dict(load_config(str(tmp_path / f"{name.replace('@', '_')}.yaml")))


@pytest.mark.parametrize("name", RANKER_RECIPES)
def test_mind_ranker_config_is_the_scoreboard_recipe(name, tmp_path, monkeypatch):
    want = fullscale_config(name, tmp_path, monkeypatch)
    got = config_to_dict(mind_ranker_config(name))
    assert sorted(got) == sorted(want)
    for section in want:
        assert got[section] == want[section], section
    assert got["train_hparams"]["embedding_optimizer"] == (
        "adamw" if name.endswith("@adamw") else "rowwise_adagrad")
    with pytest.raises(ValueError, match="no scoreboard recipe"):
        mind_ranker_config("dssm")
