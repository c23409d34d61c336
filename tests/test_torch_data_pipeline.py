"""The port's pandas-free ``preprocess`` and ``fe`` against the JAX
package's (which run on pandas), on the CPU.

On the same raw files both write the same files: ``preprocess``'s byte for
byte, ``fe``'s ``.npz`` with equal arrays (same keys, dtypes and values)
and every other file (vocab JSONs, ``dataset_extract_info.yaml``, the text
format) byte for byte. Three kinds of raw data: plain synthetic, the
generator's ``--adversarial`` quirks, and a crafted file with what the
generator never writes: fields equal to pandas' NA strings, a missing
category, many impressions at one time (pandas sorts with an unstable
quicksort), histories that are empty, a lone space, or padded with
spaces, malformed entity JSON. Both packages run in one process, so even
``train_user_ids.json``, in the iteration order of a set of strings,
compares byte for byte.
"""

import filecmp
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import yaml

from news_recsys_tpu.config import load_config as jload_config
from news_recsys_tpu.data import preprocess as jpre
from news_recsys_tpu.data.feature_extraction import FeatureExtractionPipeline as JPipeline
from news_recsys_tpu.data.synthetic import generate_mind
from news_recsys_tpu_torch.config import load_config
from news_recsys_tpu_torch.data import preprocess as tpre
from news_recsys_tpu_torch.data.feature_extraction import FeatureExtractionPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMES = ["11/11/2019 9:05:00 AM", "11/11/2019 12:30:10 PM", "11/12/2019 12:00:01 AM",
         "11/12/2019 7:45:59 PM"]


def crafted_news(dev: bool) -> str:
    rows = [
        ["N1", "news", "newsus", "Plain title", "An abstract", "https://x/1",
         '[{"Label": "A", "Type": "P", "WikidataId": "Q1"}]', "[]"],
        ["N2", "sports", "NA", '"Quoted start, never closed', "null", "https://x/2", "[]", "[]"],
        ["N3", "NA", "subx", 'He said "x", then left', "None", "https://x/3",
         '[{"WikidataId": "Q2"}, {"WikidataId": "Q1"}, {"Label": "no id"}]', "[]"],
        ["N4", "finance", "fin", "nan", "N/A", "https://x/4", "not json", "#N/A"],
        ["N5", "news", "newsus", "#N/A", "", "https://x/5", "[{]", "[]"],
        ["N6", "null", "n/a", "Title 6", '""', "NULL", '[{"WikidataId": "Q3"}]', "-nan"],
        ["N7", "lifestyle", "<NA>", "It's 50% off \\ more", "NaN", "https://x/7", "[]", "[]"],
    ]
    if dev:   # a dev copy that differs (first appearance wins), and news only dev has
        rows = [["N1", "news", "newsus", "DEV title", "", "https://x/1", "[]", "[]"]] + rows[1:]
        rows += [["N8", "tv", "tvshow", "Dev only", "Dev abstract", "https://x/8",
                  '[{"WikidataId": "Q9"}]', "[]"],
                 ["N9", "NA", "NA", "NA", "NA", "NA", "NA", "NA"]]
    return "".join("\t".join(r) + "\n" for r in rows)


def crafted_behaviors(n: int, n_news: int, users: int, seed: int) -> str:
    """``n`` impressions over len(TIMES) distinct times (hundreds of ties),
    histories of every awkward form, 1-4 candidates each."""
    rng = np.random.default_rng(seed)
    lines = []
    for imp in range(n):
        hist = " ".join(f"N{i}" for i in rng.integers(1, 8, rng.integers(1, 6)))
        form = imp % 6
        if form == 0:
            hist = ""
        elif form == 1:
            hist = " "
        elif form == 2:
            hist += " "
        elif form == 3:
            hist = " " + hist
        cands = " ".join(f"N{i}-{rng.integers(0, 2)}"
                         for i in rng.integers(1, n_news + 1, rng.integers(1, 5)))
        lines.append(f"{imp + 1}\tU{rng.integers(1, users + 1)}\t{TIMES[rng.integers(0, 4)]}\t"
                     f"{hist}\t{cands}\n")
    if n_news > 7:                      # dev: a blank line and a line of spaces are skipped
        lines[5:5] = ["\n", "   \n"]
    return "".join(lines)


def write_crafted(root: str) -> str:
    for sub, dev in (("MINDsmall_train", False), ("MINDsmall_dev", True)):
        os.makedirs(os.path.join(root, sub))
        with open(os.path.join(root, sub, "news.tsv"), "w") as f:
            f.write(crafted_news(dev))
        with open(os.path.join(root, sub, "behaviors.tsv"), "w") as f:
            f.write(crafted_behaviors(120 if dev else 400, 9 if dev else 7, 40 if dev else 30,
                                      seed=2 if dev else 1))
    return root


DATA = {
    "plain": lambda root: generate_mind(root, n_news=400, n_users=150, n_impressions_train=800,
                                        n_impressions_dev=200, seed=4),
    "adversarial": lambda root: generate_mind(root, n_news=400, n_users=150,
                                              n_impressions_train=800, n_impressions_dev=200,
                                              seed=5, adversarial=True),
    "crafted": write_crafted,
}


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """kind -> (raw data root, the JAX package's preprocess output dir)."""
    base = tmp_path_factory.mktemp("raw")
    out = {}
    for kind, make in DATA.items():
        root = str(base / kind / "Data")
        make(root)
        jpre.run_preprocess(root, str(base / kind / "jax"))
        out[kind] = (root, str(base / kind / "jax" / "preprocess"))
    return out


def same_files(a: str, b: str) -> None:
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in sorted(os.listdir(a)):
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                assert za.files == zb.files, name
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, (name, k)
                    np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{name} {k}")
        else:
            assert filecmp.cmp(pa, pb, shallow=False), name


@pytest.mark.parametrize("kind", list(DATA))
def test_preprocess_writes_the_jax_packages_files(raw, tmp_path, kind):
    root, jax_dir = raw[kind]
    tpre.run_preprocess(root, str(tmp_path))
    same_files(jax_dir, str(tmp_path / "preprocess"))


def test_crafted_file_has_what_it_is_for(raw):
    """The crafted behaviors tie on time in an order the unstable sort
    changes, and NA strings reach the news file as empty fields."""
    root, jax_dir = raw["crafted"]
    times = tpre.parse_times([r[2] for r in tpre.read_tsv(
        os.path.join(root, "MINDsmall_train", "behaviors.tsv"), 5)])
    assert len(np.unique(times)) == len(TIMES) < len(times)
    assert not np.array_equal(times.argsort(kind="quicksort"), times.argsort(kind="stable"))
    news = open(os.path.join(jax_dir, "all_news_preprocess.csv")).read().splitlines()
    assert news[2].split("\t")[1:3] == ["", "subx"] and "DEV title" not in "".join(news)
    behaviors = open(os.path.join(jax_dir, "train_behaviors_processed.csv")).read()
    assert "\t\t" in behaviors                                   # empty histories


def test_read_tsv_and_times_as_pandas_reads_them(raw):
    root, _ = raw["crafted"]
    for sub in ("MINDsmall_train", "MINDsmall_dev"):
        path = os.path.join(root, sub, "news.tsv")
        want = pd.read_csv(path, sep="\t", names=tpre.NEWS_COLS, quoting=3)
        got = tpre.read_tsv(path, len(tpre.NEWS_COLS))
        assert len(got) == len(want)
        for row, (_, w) in zip(got, want.iterrows()):
            assert row == [None if pd.isna(v) else v for v in w.tolist()]
        path = os.path.join(root, sub, "behaviors.tsv")
        want = pd.read_csv(path, sep="\t", names=tpre.BEHAVIOR_COLS, quoting=3)
        times = tpre.parse_times([r[2] for r in tpre.read_tsv(path, 5)])
        np.testing.assert_array_equal(times, pd.to_datetime(want["time"],
                                                            format=tpre.TIME_FORMAT).to_numpy())
        assert tpre.read_tsv(path, 5, usecols=[1], nrows=3) == [[u] for u in want["user_id"][:3]]
    assert set(tpre.NA_STRINGS) == set(pd._libs.parsers.STR_NA_VALUES)


def fe_dirs(raw, tmp_path, kind: str, config: str):
    """(the JAX package's config, the port's): ``configs/<config>.yaml`` with
    paths into two output dirs, each holding a copy of ``kind``'s
    preprocessed files."""
    root, jax_dir = raw[kind]
    with open(os.path.join(REPO, "configs", f"{config}.yaml")) as f:
        doc = yaml.safe_load(f)
    cfgs = []
    for tag, load in (("jax", jload_config), ("port", load_config)):
        shutil.copytree(jax_dir, tmp_path / tag / "preprocess")
        doc["paths"] = {"data_path": root, "out_basedir": str(tmp_path / tag)}
        (tmp_path / f"{tag}.yaml").write_text(yaml.safe_dump(doc))
        cfgs.append(load(str(tmp_path / f"{tag}.yaml")))
    return cfgs


# (data, config, --text, --limit-rows): every config the repo ships that
# extracts the MIND features, the attention one with hist and entities
FE_CASES = [(kind, config, config == "attention", 0) for kind in DATA
            for config in ("dcn", "attention")]
# limits that cut an impression, fall on a boundary, or pass the file's end
FE_CASES += [("plain", "attention", False, 777), ("crafted", "attention", True, 101),
             ("crafted", "dcn", False, 40), ("adversarial", "dcn", False, 10 ** 6)]


@pytest.mark.parametrize("kind,config,text,limit", FE_CASES)
def test_fe_writes_the_jax_packages_files(raw, tmp_path, kind, config, text, limit):
    jcfg, cfg = fe_dirs(raw, tmp_path, kind, config)
    JPipeline(jcfg, write_text=text, limit_rows=limit).run()
    FeatureExtractionPipeline(cfg, write_text=text, limit_rows=limit).run()
    same_files(str(tmp_path / "jax" / "extractored_feature"),
               str(tmp_path / "port" / "extractored_feature"))
    if limit:
        n = len(np.load(tmp_path / "port" / "extractored_feature" / "train_features.npz")["label"])
        assert n <= limit


def test_limit_rows_snaps_to_an_impression(raw, tmp_path):
    """A cut inside an impression drops that impression's head."""
    jcfg, cfg = fe_dirs(raw, tmp_path, "plain", "dcn")
    rows = tpre.read_tsv(os.path.join(cfg.paths.out_basedir, "preprocess",
                                      "train_behaviors_processed.csv"), 6)
    imp = [int(r[0]) for r in rows]
    cut = next(i for i in range(50, len(imp)) if imp[i] == imp[i - 1])  # inside an impression
    FeatureExtractionPipeline(cfg, limit_rows=cut).run()
    n = len(np.load(os.path.join(cfg.paths.out_basedir, "extractored_feature",
                                 "train_features.npz"))["label"])
    assert n == imp.index(imp[cut]) < cut


def test_fe_refuses_a_negative_limit_and_an_unknown_feature(raw, tmp_path):
    _, cfg = fe_dirs(raw, tmp_path, "plain", "dcn")
    with pytest.raises(ValueError, match="limit_rows must be >= 0"):
        FeatureExtractionPipeline(cfg, limit_rows=-1)
    pipe = FeatureExtractionPipeline(cfg)
    pipe.feature_names = ["user_id", "no_such_feature"]
    with pytest.raises(NotImplementedError, match="no_such_feature"):
        pipe.run()


def test_preprocess_refuses_unknown_ids(tmp_path):
    root = write_crafted(str(tmp_path / "Data"))
    with open(os.path.join(root, "MINDsmall_dev", "behaviors.tsv"), "a") as f:
        f.write(f"999\tU1\t{TIMES[0]}\tN1 N404\tN1-1\n")
    for pre in (jpre, tpre):
        with pytest.raises(KeyError, match="Unknown IDs in column 'history'.*N404"):
            pre.run_preprocess(root, str(tmp_path / pre.__name__.split(".")[0]))
