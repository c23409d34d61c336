"""The port's ItemCF baseline against the JAX package's, on the CPU.

The port keeps its own copy of ``news_recsys_tpu/models/itemcf.py`` (pure
numpy); its ``interactions_from_behaviors`` takes the behaviors file's
columns as numpy arrays where the original takes a pandas DataFrame, and
``cmd_itemcf`` replaces ``DataFrame.sample(n=, random_state=0)`` with the
call pandas makes (``RandomState(0).choice(len, size=n, replace=False)``,
``pandas/core/sample.py``). Every result here is held equal, not close.
"""

import numpy as np
import pandas as pd
import pytest

from news_recsys_tpu.models import itemcf as jitemcf
from news_recsys_tpu_torch.data.feature_extraction import read_behaviors
from news_recsys_tpu_torch.data.preprocess import run_preprocess
from news_recsys_tpu_torch.data.synthetic import generate_mind
from news_recsys_tpu_torch.models import itemcf as titemcf

BEHAVIOR_COLS = ["impression_id", "user_id", "time", "history", "item_id", "label"]


def interactions(seed, users=40, items=90, n=900):
    """Flat (user, item) pairs in time order, with repeats of a pair."""
    rng = np.random.default_rng(seed)
    uids = rng.integers(1, users + 1, n)
    its = rng.zipf(1.3, n) % items + 1
    its[5::11] = its[4::11][: len(its[5::11])]
    return uids.astype(np.int64), its.astype(np.int64)


@pytest.mark.parametrize("max_history,max_neighbors,pair_chunk", [
    (200, 200, 4_000_000), (5, 3, 50), (1, 10, 4_000_000)])
def test_itemcf_equals_jax(max_history, max_neighbors, pair_chunk):
    """``fit_pairs`` (the CSR and the counts), ``recall_batch``, ``recall``
    and ``hit_rate``, with small caps and a pair budget that cuts the
    co-occurrence count into many chunks."""
    uids, items = interactions(0)
    kw = dict(max_history=max_history, max_neighbors=max_neighbors, pair_chunk=pair_chunk)
    got, want = titemcf.ItemCF(**kw).fit_pairs(uids, items), \
        jitemcf.ItemCF(**kw).fit_pairs(uids, items)
    for attr in ("_item_ids", "_indptr", "_nbr", "_wgt"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr), err_msg=attr)
    assert got.item_count == want.item_count
    rng = np.random.default_rng(1)
    histories = [list(rng.integers(0, 100, rng.integers(0, 8))) for _ in range(50)]
    for k in (1, 10, 50):
        np.testing.assert_array_equal(got.recall_batch(histories, k),
                                      want.recall_batch(histories, k))
    assert got.recall(histories[3], 10) == want.recall(histories[3], 10)
    cases = [(h, int(rng.integers(1, 90))) for h in histories]
    assert got.hit_rate(cases, 10) == want.hit_rate(cases, 10)
    user_items = {1: [3, 4, 5, 3], 2: [4, 5], 3: [9]}
    a, b = titemcf.ItemCF().fit(user_items), jitemcf.ItemCF().fit(user_items)
    np.testing.assert_array_equal(a._wgt, b._wgt)


def test_itemcf_of_nothing_equals_jax():
    empty = np.zeros(0, np.int64)
    got, want = titemcf.ItemCF().fit_pairs(empty, empty), jitemcf.ItemCF().fit_pairs(empty, empty)
    np.testing.assert_array_equal(got.recall_batch([[1, 2]], 5), want.recall_batch([[1, 2]], 5))
    assert got.hit_rate([], 10) == want.hit_rate([], 10) == 0.0


@pytest.fixture(scope="module")
def behaviors(tmp_path_factory):
    """The port's synth + preprocess: processed train and dev behaviors, and
    each read as the JAX package's ``cmd_itemcf`` reads it (pandas)."""
    tmp = tmp_path_factory.mktemp("itemcf")
    generate_mind(str(tmp / "Data"), n_news=150, n_users=80, n_impressions_train=400,
                  n_impressions_dev=120, seed=2, adversarial=True)
    run_preprocess(str(tmp / "Data"), str(tmp / "out"))
    pre = tmp / "out" / "preprocess"
    return {split: (read_behaviors(pre / f"{split}_behaviors_processed.csv"),
                    pd.read_csv(pre / f"{split}_behaviors_processed.csv", sep="\t",
                                names=BEHAVIOR_COLS, quoting=3))
            for split in ("train", "dev")}


def test_interactions_from_behaviors_equal_the_dataframe_version(behaviors):
    for split, (cols, df) in behaviors.items():
        assert (df["history"].isna()).any(), split          # empty histories are there
        got = titemcf.interactions_from_behaviors(cols["history"], cols["user_id"],
                                                  cols["item_id"], cols["label"])
        want = jitemcf.interactions_from_behaviors(df)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int64
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [1, 17, 50])
def test_query_draw_equals_dataframe_sample(behaviors, n):
    """``cmd_itemcf``'s draw of ``--max-queries`` dev positives picks the
    rows ``DataFrame.sample(n=, random_state=0)`` picks, in its order."""
    cols, df = behaviors["dev"]
    pos = np.flatnonzero(cols["label"] == 1)
    assert len(pos) > n
    want = df[df["label"] == 1].sample(n=n, random_state=0).index.to_numpy()
    got = pos[np.random.RandomState(0).choice(len(pos), size=n, replace=False)]
    np.testing.assert_array_equal(got, want)


def test_read_behaviors_equals_pandas(behaviors):
    for cols, df in behaviors.values():
        for c in ("impression_id", "user_id", "time", "item_id", "label"):
            np.testing.assert_array_equal(cols[c], df[c].to_numpy(np.int64), err_msg=c)
        assert cols["history"].tolist() == df["history"].fillna("").astype(str).tolist()
