"""The port's own copies of the JAX package's backend-free modules, held to
the originals on the CPU: ``config``, ``zoo``, ``data.packed_dataset``,
``data.synthetic``, ``data.text_format``, ``data.hist_pairs``,
``training.metrics``, ``utils.logging``, ``utils.feature_id_mapper``,
``utils.tensorboard`` and ``utils.log_analysis``; the numpy parts of the
retrieval slice: ``models.itemcf``, ``models.dssm.item_log_q`` and
``training.retrieval.dedup_hit_rate``; and the two C++ sources the port
builds (``native/*.cpp``).

The port imports nothing of the JAX package, so it keeps a copy of what the
two share. The reference is frozen; these tests are what keeps a copy from
drifting. A config crosses between the packages as the plain dict of
``config_to_dict`` / ``config_from_dict``. Everything here is compared for
equality: nothing is summed in another order.
"""

import dataclasses
import glob
import json
import logging
import os

import numpy as np
import pytest

from news_recsys_tpu import config as jconfig
from news_recsys_tpu import zoo as jzoo
from news_recsys_tpu.data import hist_pairs as jpairs
from news_recsys_tpu.data import packed_dataset as jpacked
from news_recsys_tpu.data import synthetic as jsynth
from news_recsys_tpu.data import text_format as jtext
from news_recsys_tpu.models import dssm as jdssm
from news_recsys_tpu.models import itemcf as jitemcf
from news_recsys_tpu.training import retrieval as jretrieval
from news_recsys_tpu.training import metrics as jmetrics
from news_recsys_tpu.utils import feature_id_mapper as jmapper
from news_recsys_tpu.utils import log_analysis as jlog
from news_recsys_tpu.utils import logging as jlogging
from news_recsys_tpu.utils import tensorboard as jtb
from news_recsys_tpu_torch import config as tconfig
from news_recsys_tpu_torch import zoo as tzoo
from news_recsys_tpu_torch.data import hist_pairs as tpairs
from news_recsys_tpu_torch.data import packed_dataset as tpacked
from news_recsys_tpu_torch.data import synthetic as tsynth
from news_recsys_tpu_torch.data import text_format as ttext
from news_recsys_tpu_torch.models import dssm as tdssm
from news_recsys_tpu_torch.models import itemcf as titemcf
from news_recsys_tpu_torch.training import retrieval as tretrieval
from news_recsys_tpu_torch.training import metrics as tmetrics
from news_recsys_tpu_torch.utils import feature_id_mapper as tmapper
from news_recsys_tpu_torch.utils import log_analysis as tlog
from news_recsys_tpu_torch.utils import logging as tlogging
from news_recsys_tpu_torch.utils import tensorboard as ttb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(REPO, "configs", "*.yaml")))


def to_jax(cfg):
    """A port config as the JAX package's, through its plain dict."""
    return jconfig.config_from_dict(tconfig.config_to_dict(cfg))


def config_pairs():
    """name -> a function giving (the port's config, the JAX package's)."""
    pairs = {y: (lambda y=y: (tconfig.load_config(os.path.join(REPO, "configs", y)),
                              jconfig.load_config(os.path.join(REPO, "configs", y))))
             for y in YAMLS}
    pairs["mind_config"] = lambda: (tzoo.mind_config("dcn"), jzoo.mind_config("dcn"))
    pairs["mind_config(rowwise, no arena, equal dims)"] = lambda: (
        tzoo.mind_config("fm", batch_size=64, equal_dims=True,
                         embedding_optimizer="rowwise_adagrad", arena_tables=False),
        jzoo.mind_config("fm", batch_size=64, equal_dims=True,
                         embedding_optimizer="rowwise_adagrad", arena_tables=False))
    pairs["attention_config"] = lambda: (tzoo.attention_config(), jzoo.attention_config())
    pairs["attention_config(adamw, hist 12)"] = lambda: (
        tzoo.attention_config(batch_size=64, hist_len=12, embedding_optimizer="adamw"),
        jzoo.attention_config(batch_size=64, hist_len=12, embedding_optimizer="adamw"))
    pairs["mind_dssm_config"] = lambda: (
        tzoo.mind_dssm_config(), jconfig.load_config(os.path.join(REPO, "configs", "dssm.yaml")))
    for name in tzoo.RANKER_RECIPES:
        pairs[f"mind_ranker_config({name})"] = lambda name=name: (
            tzoo.mind_ranker_config(name), to_jax(tzoo.mind_ranker_config(name)))
    return pairs


PAIRS = config_pairs()


def schema_rows(schema):
    return [dataclasses.asdict(s) for s in schema.specs]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_config_copy_equals_the_original(name):
    tcfg, jcfg = PAIRS[name]()
    assert tconfig.config_to_dict(tcfg) == jconfig.config_to_dict(jcfg)
    # and the dict round-trips in both directions
    assert jconfig.config_to_dict(to_jax(tcfg)) == jconfig.config_to_dict(jcfg)
    assert tconfig.config_to_dict(tconfig.config_from_dict(jconfig.config_to_dict(jcfg))) == \
        tconfig.config_to_dict(tcfg)
    assert tconfig.table_specs(tcfg) == jconfig.table_specs(jcfg)
    assert tconfig.arena_layout(tcfg) == jconfig.arena_layout(jcfg)
    f = jcfg.features
    for names in (None, sorted(f.user_feature_names), sorted(f.item_feature_names)):
        got, want = tconfig.build_schema(tcfg, names), jconfig.build_schema(jcfg, names)
        assert schema_rows(got) == schema_rows(want)       # names, kinds, tables, dims,
        assert got.names == want.names                     # offsets, id_offset, member_vocab
        assert got.dims == want.dims and got.total_dim == want.total_dim
        assert schema_rows(got.subset(got.names[:2])) == schema_rows(want.subset(want.names[:2]))


@pytest.mark.parametrize("raw,match", [
    ({"features": {"array_feature_names": ["hist"]}}, "max_length not defined"),
    ({"features": {"sparse_feature_names": ["a"]}}, "Embedding size"),
    ({"train_hparams": {"lr_milestones": [1]}}, "lr_milestones"),
    ({"embeddings": {"init_scale": 0}}, "init_scale"),
    ({"mesh": {"param_dtype": "float16"}}, "param_dtype"),
    ({"train_hparams": {"embedding_optimizer": "sgd"}}, "embedding_optimizer"),
    ({"train_hparams": {"embedding_update_period": 0}}, "embedding_update_period"),
    ({"train_hparams": {"embedding_update_period": 2}}, "requires"),
    ({"mesh": {"param_dtype": "bfloat16"}}, "requires a rowwise"),
])
def test_config_copy_validates_as_the_original(raw, match):
    for module in (tconfig, jconfig):
        with pytest.raises(ValueError, match=match):
            module.config_from_dict(raw)


def test_config_constants_equal():
    for name in ("SPARSE", "DENSE", "ARRAY", "DENSE_FEATURE_DIM", "ARENA_MIN_VOCAB"):
        assert getattr(tconfig, name) == getattr(jconfig, name), name
    assert tzoo.MIND_FEATURES == jzoo.MIND_FEATURES
    assert tzoo.MIND_TABLE_SIZE == jzoo.MIND_TABLE_SIZE
    assert tzoo.MIND_EMB_SIZE == jzoo.MIND_EMB_SIZE
    assert tzoo.ATTENTION_HIST_LEN == jzoo.ATTENTION_HIST_LEN
    with pytest.raises(FileNotFoundError):
        tconfig.load_config("no/such.yaml")


@pytest.mark.parametrize("rows,hist_len,seed", [(64, 30, 0), (7, 12, 3), (512, 30, 11)])
def test_attention_arrays_equal(rows, hist_len, seed):
    got, want = tzoo.attention_arrays(rows, hist_len, seed), jzoo.attention_arrays(
        rows, hist_len, seed)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the packed dataset --------------------------------------------------------


def packed_arrays(n, seed):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 50, (n, 6)).astype(np.int32)
    return {"user_id": rng.integers(1, 99, n).astype(np.int64),
            "item_id": rng.integers(1, 50, n).astype(np.int32),
            "hist": hist, "hist_mask": (hist != 0).astype(np.float32),
            "price": rng.random(n).astype(np.float64),
            "label": (rng.random((n, 1)) < 0.3).astype(np.float32)}


def assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n,seed", [(37, 0), (128, 1)])
def test_batch_packer_and_unpack_equal(n, seed):
    arrays = packed_arrays(n, seed)
    tds, jds = tpacked.PackedDataset(dict(arrays)), jpacked.PackedDataset(dict(arrays))
    assert len(tds) == len(jds) == n
    tp, jp = tpacked.BatchPacker(tds), jpacked.BatchPacker(jds)
    assert tp.layout_key() == jp.layout_key() and tp.n == jp.n
    np.testing.assert_array_equal(tp.int_mat, jp.int_mat)
    np.testing.assert_array_equal(tp.float_mat, jp.float_mat)
    for shuffle in (True, False):
        got = list(tp.iterate(16, shuffle, seed=5, epoch=2))
        want = list(jp.iterate(16, shuffle, seed=5, epoch=2))
        assert len(got) == len(want) == tpacked.num_batches(n, 16, drop_last=shuffle)
        for (gi, gf, gv), (wi, wf, wv) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gf, wf)
            np.testing.assert_array_equal(gv, wv)
            assert_batches_equal(tpacked.unpack_batch(gi, gf, gv, tp.layout_key()),
                                 jpacked.unpack_batch(wi, wf, wv, jp.layout_key()))
    idx = np.array([3, 0, 5])
    assert_batches_equal(tds.take(idx), jds.take(idx))


@pytest.mark.parametrize("shuffle,drop_last", [(True, None), (False, None), (False, True)])
def test_iterate_batches_equal(shuffle, drop_last):
    arrays = packed_arrays(53, 2)
    got = list(tpacked.iterate_batches(tpacked.PackedDataset(dict(arrays)), 8, shuffle, seed=4,
                                       epoch=1, drop_last=drop_last))
    want = list(jpacked.iterate_batches(jpacked.PackedDataset(dict(arrays)), 8, shuffle, seed=4,
                                        epoch=1, drop_last=drop_last))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_batches_equal(g, w)


def test_packed_dataset_load_and_checks_equal(tmp_path):
    arrays = packed_arrays(20, 3)
    arrays["hist_mask"] = arrays["hist_mask"].astype(np.uint8)     # masks at rest
    path = str(tmp_path / "split.npz")
    np.savez(path, **arrays)
    got, want = tpacked.PackedDataset.load(path), jpacked.PackedDataset.load(path)
    assert got.arrays["hist_mask"].dtype == np.float32
    assert_batches_equal(got.arrays, want.arrays)
    for module in (tpacked, jpacked):
        with pytest.raises(ValueError, match="Empty"):
            module.PackedDataset({})
        with pytest.raises(ValueError, match="Inconsistent"):
            module.PackedDataset({"a": np.zeros(3), "b": np.zeros(4)})
    # open_split finds the split's npz under the config's out_basedir
    base = tmp_path / "extractored_feature"
    base.mkdir()
    np.savez(str(base / "train_features.npz"), **arrays)
    cfg = tconfig.config_from_dict({"paths": {"out_basedir": str(tmp_path)}})
    assert_batches_equal(tpacked.PackedDataset.open_split(cfg, "train").arrays,
                         jpacked.PackedDataset.open_split(to_jax(cfg), "train").arrays)
    with pytest.raises(FileNotFoundError):
        tpacked.PackedDataset.open_split(cfg, "dev")


# -- the metric engine ---------------------------------------------------------


def metric_inputs(n, users, seed, ties=False):
    rng = np.random.default_rng(seed)
    scores = rng.random(n).astype(np.float32)
    if ties:
        scores = np.round(scores, 1)
    return (rng.integers(1, users, n), scores, (rng.random(n) < 0.2).astype(np.float32))


@pytest.mark.parametrize("n,users,k,warm,ties", [
    (2000, 60, 10, "half", False), (2000, 60, 10, "none", True), (500, 200, 5, "half", True),
    (300, 4, 10, "all", False), (0, 5, 10, "none", False)])
def test_user_metrics_equal(n, users, k, warm, ties):
    uid, scores, labels = metric_inputs(n, users, seed=n + k, ties=ties)
    warm_set = {"none": None, "all": set(range(users)),
                "half": {u for u in range(users) if u % 2}}[warm]
    got = tmetrics.compute_user_metrics(uid, scores, labels, warm_set, k=k)
    want = jmetrics.compute_user_metrics(uid, scores, labels, warm_set, k=k)
    assert got == want
    assert tmetrics.format_validation_block(got, 3, k=k) == jmetrics.format_validation_block(
        want, 3, k=k)
    assert tmetrics.pooled_auc(labels, scores) == jmetrics.pooled_auc(labels, scores)
    assert tmetrics.pooled_logloss(labels, scores) == jmetrics.pooled_logloss(labels, scores)


def test_logger_copy():
    got, want = tlogging.get_logger("shared_test"), jlogging.get_logger("shared_test")
    assert got.name == "news_recsys_tpu_torch.shared_test"
    assert want.name == "news_recsys_tpu.shared_test"
    assert tlogging.get_logger("shared_test") is got and len(got.handlers) == 1
    assert got.propagate is want.propagate is False and got.level == want.level
    record = logging.LogRecord("x", logging.WARNING, "f", 1, "hello", None, None)
    for colour in (True, False):
        assert tlogging.ColoredFormatter(colour).format(record) == \
            jlogging.ColoredFormatter(colour).format(record)


# -- the data pipeline's shared modules ------------------------------------------


@pytest.mark.parametrize("kwargs", [
    dict(n_news=300, n_users=120, n_impressions_train=400, n_impressions_dev=150, seed=0),
    dict(n_news=500, n_users=200, n_impressions_train=900, n_impressions_dev=300, seed=3,
         adversarial=True),
    dict(n_news=20, n_users=5, n_impressions_train=30, n_impressions_dev=10, max_history=3,
         max_candidates=2, seed=7)])
def test_synthetic_files_equal(tmp_path, kwargs):
    tsynth.generate_mind(str(tmp_path / "port"), **kwargs)
    jsynth.generate_mind(str(tmp_path / "jax"), **kwargs)
    for sub in ("MINDsmall_train", "MINDsmall_dev"):
        for name in ("news.tsv", "behaviors.tsv"):
            got = (tmp_path / "port" / sub / name).read_bytes()
            assert got == (tmp_path / "jax" / sub / name).read_bytes(), (sub, name)
    assert tsynth.CATEGORIES == jsynth.CATEGORIES
    assert (tsynth.L_BIAS, tsynth.L_LATENT, tsynth.L_CATMATCH, tsynth.L_ITEM) == (
        jsynth.L_BIAS, jsynth.L_LATENT, jsynth.L_CATMATCH, jsynth.L_ITEM)


def text_features(n, seed, multi_label=False):
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, 40, (n, 5)).astype(np.int32)
    hist[np.arange(5)[None, :] >= rng.integers(0, 6, n)[:, None]] = 0
    return {"user_id": rng.integers(1, 50, n).astype(np.int32),
            "item_id": rng.integers(1, 40, n).astype(np.int32),
            "price": np.round(rng.random(n), 2).astype(np.float32),
            "hist": hist, "hist_mask": (hist != 0).astype(np.float32),
            "label": (np.round(rng.random((n, 3)), 2) if multi_label
                      else (rng.random((n, 1)) < 0.3)).astype(np.float32)}


@pytest.mark.parametrize("multi_label", [False, True])
def test_text_format_equal(tmp_path, multi_label):
    feats = text_features(33, 4, multi_label)
    names = ["user_id", "item_id", "price", "hist"]
    ttext.write_text_features(tmp_path / "port.txt", feats, names)
    jtext.write_text_features(tmp_path / "jax.txt", feats, names)
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


def pair_datasets(module, n, seed):
    """(train, item) datasets of ``module``'s PackedDataset: users with
    histories over a 60-item corpus, some ids outside it."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, 70, (n, 6)).astype(np.int32)
    hist[np.arange(6)[None, :] >= rng.integers(0, 7, n)[:, None]] = 0
    train = {"user_id": rng.integers(1, 15, n).astype(np.int32),
             "item_id": rng.integers(1, 61, n).astype(np.int32),
             "category": rng.integers(1, 9, n).astype(np.int32),
             "hist": hist, "hist_mask": (hist != 0).astype(np.float32),
             "label": (rng.random((n, 1)) < 0.3).astype(np.float32)}
    items = {"item_id": np.arange(1, 61, dtype=np.int32),
             "category": rng.integers(1, 9, 60).astype(np.int32),
             "label": np.full((60, 1), -1.0, np.float32)}
    return module.PackedDataset(train), module.PackedDataset(items)


def test_hist_pairs_equal():
    cfg = tconfig.config_from_dict({
        "features": {"sparse_feature_names": ["user_id", "item_id", "category"],
                     "array_feature_names": ["hist"], "array_max_length": {"hist": 6},
                     "item_feature_names": ["item_id", "category"],
                     "user_feature_names": ["user_id", "hist"]},
        "embeddings": {"embedding_size": {"user_id": 4, "item_id": 4, "category": 4},
                       "embedding_table_size": {"user_id": 15, "item_id": 61, "category": 9},
                       "share_emb_table_features": {"hist": "item_id"}}})
    (ttrain, titems), (jtrain, jitems) = (pair_datasets(m, 90, 6) for m in (tpacked, jpacked))
    assert_batches_equal(tpairs.positives_only(ttrain).arrays,
                         jpairs.positives_only(jtrain).arrays)
    assert_batches_equal(tpairs.concat_datasets(ttrain, ttrain).arrays,
                         jpairs.concat_datasets(jtrain, jtrain).arrays)
    assert_batches_equal(tpairs.random_negative_rows(cfg, ttrain, titems, 3, seed=2).arrays,
                         jpairs.random_negative_rows(to_jax(cfg), jtrain, jitems, 3,
                                                     seed=2).arrays)
    assert_batches_equal(tpairs.hist_augmented_pairs(cfg, ttrain, titems).arrays,
                         jpairs.hist_augmented_pairs(to_jax(cfg), jtrain, jitems).arrays)
    for module, train in ((tpairs, ttrain), (jpairs, jtrain)):
        with pytest.raises(ValueError, match="Column mismatch"):
            module.concat_datasets(train, type(train)({"label": train.arrays["label"]}))


@pytest.mark.parametrize("copy", ["itemcf", "item_log_q", "dedup_hit_rate"])
def test_retrieval_copies_equal(copy):
    """``ItemCF`` and ``dedup_hit_rate`` are the originals line for line;
    ``item_log_q`` (its docstring reworded) gives the original's table. Each
    also on seeded inputs."""
    import inspect

    rng = np.random.default_rng(12)
    if copy == "itemcf":
        assert inspect.getsource(titemcf.ItemCF) == inspect.getsource(jitemcf.ItemCF)
        uids, items = rng.integers(1, 30, 600), rng.integers(1, 80, 600)
        got = titemcf.ItemCF(max_history=20, max_neighbors=15).fit_pairs(uids, items)
        want = jitemcf.ItemCF(max_history=20, max_neighbors=15).fit_pairs(uids, items)
        hists = [list(rng.integers(1, 90, rng.integers(0, 9))) for _ in range(40)]
        np.testing.assert_array_equal(got.recall_batch(hists, 12), want.recall_batch(hists, 12))
    elif copy == "item_log_q":
        ds = tpacked.PackedDataset({"item_id": rng.integers(0, 200, 5000).astype(np.int32),
                                    "label": np.zeros((5000, 1), np.float32)})
        np.testing.assert_array_equal(tdssm.item_log_q(ds, 150), jdssm.item_log_q(ds, 150))
    else:
        assert inspect.getsource(tretrieval.dedup_hit_rate) == \
            inspect.getsource(jretrieval.dedup_hit_rate)
        retrieved = rng.integers(1, 50, (70, 15))
        hists = [list(rng.integers(1, 50, rng.integers(0, 5))) for _ in range(70)]
        targets = rng.integers(1, 50, 70)
        assert tretrieval.dedup_hit_rate(retrieved, targets, hists, 10) == \
            jretrieval.dedup_hit_rate(retrieved, targets, hists, 10)


def test_feature_id_mapper_equal(tmp_path):
    idx2val = {"category": {"1": "news", "2": "sports"}, "user_id": {}}
    val2idx = {"category": [{"news": 1, "sports": 2}, 2], "user_id": [{}, 0], "plain": {"7": 3}}
    for name, obj in (("embedding_idx_2_original_val_dict.json", idx2val),
                      ("original_val_2_embedding_idx_dict.json", val2idx)):
        (tmp_path / name).write_text(json.dumps(obj))
    got, want = (m.FeatureIdMapper.from_dir(str(tmp_path)) for m in (tmapper, jmapper))
    for feature, value in (("category", "sports"), ("category", "nope"), ("plain", 7),
                           ("missing", "x")):
        assert got.get_emb_idx(feature, value) == want.get_emb_idx(feature, value)
    for feature, idx in (("category", 2), ("category", 9), ("user_id", 1), ("missing", 1)):
        assert got.get_real_val(feature, idx) == want.get_real_val(feature, idx)
    with pytest.raises(FileNotFoundError):
        tmapper.FeatureIdMapper(str(tmp_path / "no.json"), str(tmp_path / "no.json"))


def test_tensorboard_records_equal(tmp_path, monkeypatch):
    """Same scalars at the same clock: the same bytes in the events file."""
    for module in (ttb, jtb):
        monkeypatch.setattr(module.time, "time", lambda: 1700000000.25)
        monkeypatch.setattr(module.socket, "gethostname", lambda: "host")
    data = bytes(range(256)) * 3
    assert ttb.crc32c(data) == jtb.crc32c(data) and ttb._masked_crc(data) == jtb._masked_crc(data)
    assert ttb._event(2 ** 40, "val_auc", 0.625) == jtb._event(2 ** 40, "val_auc", 0.625)
    for module, tag in ((ttb, "port"), (jtb, "jax")):
        writer = module.SummaryWriter(str(tmp_path / tag))
        for step, (key, value) in enumerate([("train_loss", 0.5), ("epoch", 3.0),
                                             ("val_auc", float("inf"))]):
            writer.add_scalar(key, value, step)
        writer.flush()
        writer.close()
    (port,), (jax,) = (os.listdir(tmp_path / t) for t in ("port", "jax"))
    assert port == jax == "events.out.tfevents.1700000000.host"
    assert (tmp_path / "port" / port).read_bytes() == (tmp_path / "jax" / jax).read_bytes()


LOGS = {
    "ranking": "".join(tmetrics.format_validation_block(
        {"Overall": {"AUC": 0.71 + e / 100, "LogLoss": 0.4, "GAUC": 0.6, "NDCG@10": 0.3,
                     "HR@10": 0.5, "MRR@10": 0.2},
         "Warm_Start": {"AUC": [0.7, 0.74, 0.73][e], "LogLoss": 0.41, "GAUC": 0.61,
                        "NDCG@10": 0.31, "HR@10": 0.51, "MRR@10": 0.21, "User_Count": 120},
         "Cold_Start": {"AUC": 0.0, "LogLoss": 0.0, "GAUC": 0.0, "NDCG@10": 0.0,
                        "HR@10": 0.0, "MRR@10": 0.0, "User_Count": 0}}, e) for e in range(3)),
    "retrieval": "".join(tretrieval.format_retrieval_block(
        {"HR@10": 0.1 * e, "HR@50": 0.3, "num_queries": 4096}, e) for e in range(3)),
    "garbled": "noise\n==== Epoch 2 Validation Results ====\nOverall:\n  AUC:  x1\n",
    # a value that does not parse reads as nan, and the report of a best
    # epoch holding one raises in both (``_fmt``'s ``int(nan)``; ROADMAP
    # queue 3, the reference's open faults): the copy keeps the original
    "unparsed_value": "==== Epoch 0 Validation Results ====\nWarm Start Users (3):\n"
                      "  AUC:      0.7\n  LogLoss:  n/a\n",
    "empty": "",
}


@pytest.mark.parametrize("log", list(LOGS))
def test_log_analysis_equal(tmp_path, log):
    """The port's ``log_analysis`` is the original but for its docstring:
    the same functions line for line, the same parse and report of a log."""
    import inspect

    for name in ("_canon_section", "_parse_block", "parse_log", "_retrieval_criterion",
                 "best_epoch", "_md_table", "_fmt", "format_best_epoch", "model_name_from_dir",
                 "main"):
        assert inspect.getsource(getattr(tlog, name)) == inspect.getsource(getattr(jlog, name))
    for name in ("EPOCH_HEADER", "SECTION_HEADER", "METRIC_LINE", "SECTIONS"):
        assert getattr(tlog, name) == getattr(jlog, name)
    path = tmp_path / "dcn_20261017-101500" / "val_log.log"
    path.parent.mkdir()
    path.write_text(LOGS[log])
    got, want = tlog.parse_log(str(path)), jlog.parse_log(str(path))
    assert json.dumps(got) == json.dumps(want)
    name = tlog.model_name_from_dir(str(path))
    assert name == jlog.model_name_from_dir(str(path)) == "dcn"
    if log == "unparsed_value":
        for module, parsed in ((tlog, got), (jlog, want)):
            with pytest.raises(ValueError, match="NaN"):
                module.format_best_epoch(parsed, name)
    else:
        assert tlog.format_best_epoch(got, name) == jlog.format_best_epoch(want, name)


@pytest.mark.parametrize("source", ["ann_topk.cpp", "text_parser.cpp"])
def test_native_sources_byte_equal(source):
    """The port builds its host libraries from its own copies of the C++
    sources, byte for byte the JAX package's."""
    with open(os.path.join(REPO, "native", source), "rb") as a, \
            open(os.path.join(REPO, "news_recsys_tpu_torch", "native", source), "rb") as b:
        assert a.read() == b.read()


def test_read_text_features_equal():
    import inspect

    assert inspect.getsource(ttext.read_text_features) == inspect.getsource(
        jtext.read_text_features)
    assert inspect.getsource(tpacked.PackedDataset._sniff_n_labels) == inspect.getsource(
        jpacked.PackedDataset._sniff_n_labels)
