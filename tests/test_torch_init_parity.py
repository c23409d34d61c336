"""The law of every initial parameter, port against the JAX package.

The port draws its weights from torch generators, the JAX package from
``jax.random``, so no test can hold the bits equal; the step tests start
both sides from the same (JAX-drawn) weights. A parameter whose law
differed would move the full-scale AUC without any step test seeing it.
For each model of the full-scale campaign, built by both packages from the
campaign's recipe (``scripts/fullscale_rankers_torch.py::model_config_dict``)
at small table sizes, every parameter (the JAX one through
``convert.params_from_flax``) must match the port's:

- in name, shape and dtype;
- a constant one (zero biases, LayerNorm scales and biases) exactly;
- a bias of one element (a logit's) inside its layer's weight bound;
- a table's all-zero rows (row 0 of each table, the padding id) exactly;
- otherwise in law: mean and standard deviation within six standard errors
  of sampling, a two-sample Kolmogorov-Smirnov test at p > 1e-6, and the
  largest |w| within 20/n of each other for every law the JAX package draws
  uniformly (everything outside the embedding tables, whose law is normal).
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
from scipy import stats

from news_recsys_tpu.models.dssm import build_dssm as jbuild_dssm
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu_torch.config import ARRAY, build_schema, config_from_dict
from news_recsys_tpu_torch.convert import params_from_flax
from news_recsys_tpu_torch.models.dssm import build_dssm
from news_recsys_tpu_torch.models.rankers import build_ranker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAMPAIGN = ("lr", "fm", "deepfm", "dcn@v2", "deep", "widedeep", "dcn", "attention",
            "dssm@aug+logq+ns8")
SIGMAS = 6.0
KS_P = 1e-6


def campaign_config(name: str):
    spec = importlib.util.spec_from_file_location(
        "_fullscale_rankers_torch", os.path.join(REPO, "scripts", "fullscale_rankers_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    base = script.base_config_dict("/nonexistent", "/nonexistent/Data/MIND",
                                   n_users=4000, n_news=3000)
    base = script.tighten(base, {"category": [{}, 63], "subcategory": [{}, 511],
                                 "user_click_category": [{}, 63], "entities": [{}, 1999]})
    return config_from_dict(script.model_config_dict(base, name))


def init_batch(cfg, B: int = 8) -> dict:
    rng = np.random.default_rng(0)
    batch = {}
    for spec in build_schema(cfg).specs:
        if spec.kind == ARRAY:
            ids = rng.integers(1, 10, (B, spec.max_length)).astype(np.int32)
            ids[np.arange(spec.max_length)[None, :] >= rng.integers(0, spec.max_length + 1,
                                                                    B)[:, None]] = 0
            batch[spec.name] = ids
            batch[f"{spec.name}_mask"] = (ids != 0).astype(np.float32)
        else:
            batch[spec.name] = rng.integers(1, 10, B).astype(np.int32)
    batch["label"] = np.zeros((B, 1), np.float32)
    return batch


def both_inits(name: str, seed: int = 0):
    """({name: JAX-drawn array}, {name: port-drawn array}) in the port's layout."""
    cfg = campaign_config(name)
    if cfg.name == "dssm":
        jmodel, build = jbuild_dssm(cfg), build_dssm
    else:
        jmodel = jbuild_ranker(cfg, cfg.name)
        build = lambda c, **kw: build_ranker(c, c.name, **kw)          # noqa: E731
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), init_batch(cfg)))
    want = params_from_flax(params, build(cfg, device="cpu")).state_dict()
    got = build(cfg, seed=seed, device="cpu").state_dict()
    assert sorted(got) == sorted(want)
    return ({k: v.double().numpy() for k, v in want.items()},
            {k: v.double().numpy() for k, v in got.items()}, {k: v.dtype for k, v in got.items()},
            {k: v.dtype for k, v in want.items()})


def same_law(key: str, a: np.ndarray, b: np.ndarray, uniform: bool) -> None:
    n = a.size
    ma, mb, sa, sb = a.mean(), b.mean(), a.std(), b.std()
    assert abs(ma - mb) <= SIGMAS * np.sqrt((sa ** 2 + sb ** 2) / n), (key, ma, mb)
    # the sample std's relative error is sqrt((kurtosis - 1) / 4n) <= sqrt(1/2n) for
    # the normal and uniform laws; two samples
    assert abs(sa / sb - 1) <= SIGMAS * np.sqrt(1.0 / n), (key, sa, sb)
    p = stats.ks_2samp(a, b).pvalue
    assert p > KS_P, (key, p)
    if uniform:             # U(-c, c): each sample's largest |w| within c(1 - 20/n) of c
        ca, cb = np.abs(a).max(), np.abs(b).max()
        assert abs(ca - cb) <= 20.0 / n * max(ca, cb), (key, ca, cb)


@pytest.mark.parametrize("name", CAMPAIGN)
def test_initial_parameters_follow_the_jax_law(name):
    want, got, got_dtypes, want_dtypes = both_inits(name)
    tables = 0
    for key in sorted(want):
        a, b = want[key], got[key]
        assert a.shape == b.shape and got_dtypes[key] == want_dtypes[key], key
        if a.size == 1 and key.endswith(".bias"):
            # one draw of U(-c, c) (a logit's bias): inside its layer's weight bound
            weight = key[:-len("bias")] + "weight"
            assert abs(a.item()) <= np.abs(want[weight]).max() * (1 + 20.0 / want[weight].size)
            assert abs(b.item()) <= np.abs(got[weight]).max() * (1 + 20.0 / got[weight].size)
            continue
        if np.all(a == a.flat[0]):                           # a constant: exactly
            np.testing.assert_array_equal(b, a, err_msg=key)
            continue
        is_table = key.startswith("embedder.tables.")
        if is_table:
            tables += 1
            zero_a, zero_b = ~a.any(axis=1), ~b.any(axis=1)
            assert zero_a[0] and zero_b[0], key                 # the padding row
            np.testing.assert_array_equal(zero_b, zero_a, err_msg=key)
            a, b = a[~zero_a], b[~zero_b]
        same_law(key, a.ravel(), b.ravel(), uniform=not is_table)
    assert tables >= 1


@pytest.mark.parametrize("case", ["normal for uniform", "uniform 10% wide", "normal 10% wide",
                                  "normal shifted", "uniform for normal"])
def test_the_check_tells_laws_apart(case):
    """What an init fault would look like is refused, at the sizes of the
    campaign's parameters (a bias of 256, a weight or table of 16,384 or
    more), while two draws of one law pass."""
    rng = np.random.default_rng(0)
    s = 0.05
    c = s * np.sqrt(3.0)                        # U(-c, c) has the variance of N(0, s)
    n, uniform, want, bad = {
        "normal for uniform": (256, True, rng.uniform(-c, c, 256), rng.normal(0, s, 256)),
        "uniform 10% wide": (256, True, rng.uniform(-c, c, 256),
                             rng.uniform(-1.1 * c, 1.1 * c, 256)),
        "normal 10% wide": (16384, False, rng.normal(0, s, 16384),
                            rng.normal(0, 1.1 * s, 16384)),
        "normal shifted": (16384, False, rng.normal(0, s, 16384),
                           rng.normal(0.1 * s, s, 16384)),
        "uniform for normal": (65536, False, rng.normal(0, s, 65536),
                               rng.uniform(-c, c, 65536)),
    }[case]
    fresh = rng.uniform(-c, c, n) if uniform else rng.normal(0, s, n)
    same_law(case, want, fresh, uniform=uniform)
    with pytest.raises(AssertionError):
        same_law(case, want, bad, uniform=uniform)
