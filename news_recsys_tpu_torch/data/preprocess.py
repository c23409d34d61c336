"""MIND preprocessing: global ID maps, merged news, exploded behaviors.

The port's own version of :mod:`news_recsys_tpu.data.preprocess`, on numpy
and the standard library: the JAX package's reads and writes through
pandas, which the port does not depend on. On the same raw files it writes
the same files, byte for byte (``tests/test_torch_data_pipeline.py``),
which means keeping what pandas did to them:

- fields are split on tabs and quotes are literal (``quoting=3``); lines
  of nothing but spaces are skipped;
- a field equal to one of pandas' default NA strings (:data:`NA_STRINGS`,
  ``""`` among them) is missing, and is written back empty;
- ids number from 1 in first-appearance order (``pd.unique``);
  ``train_user_ids.json`` lists them in the iteration order of a set of
  the raw train ids filled in that order, as the reference's does (so it
  varies with Python's string hash seed, in both packages);
- impressions are ordered by time with numpy's quicksort on the parsed
  ``datetime64[us]`` times, which is what ``sort_values(by="time")`` runs:
  the sort is not stable, so tied times keep no input order;
- the written time is the parsed time's int64 value floor-divided by
  ``10**9`` (``astype("int64") // 10**9``). pandas 3 parses these times
  at microsecond resolution, so the column holds units of 1,000 s
  (:data:`TIME_RESOLUTION`); nothing downstream reads it.

Output columns of the behaviors files: impression_id, user_id, time,
history (space-joined mapped ids), item_id, label, one row per impression
item.
"""

from __future__ import annotations

import datetime
import json
import os
import re
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.logging import get_logger

logger = get_logger("preprocess")

SUB_DATASETS = ("MINDsmall_train", "MINDsmall_dev")
NEWS_COLS = ["news_id", "category", "subcategory", "title", "abstract", "url",
             "title_entities", "abstract_entities"]
BEHAVIOR_COLS = ["impression_id", "user_id", "time", "history", "impressions"]
# pandas' default ``na_values`` (``pandas._libs.parsers.STR_NA_VALUES``)
NA_STRINGS = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                        "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                        "nan", "null"})
TIME_FORMAT = "%m/%d/%Y %I:%M:%S %p"
TIME_RESOLUTION = "us"           # the unit pandas 3 parses TIME_FORMAT to
_EPOCH = datetime.datetime(1970, 1, 1)
_LINE_END = re.compile(r"\r\n|\r|\n")


def read_tsv(path, ncols: int, usecols: Optional[Sequence[int]] = None,
             nrows: Optional[int] = None) -> List[List[Optional[str]]]:
    """Rows of a headerless tab-separated file as ``read_csv(sep="\\t",
    quoting=3)`` reads them: every field text or None (missing), short rows
    padded with None; ``usecols`` keeps those columns in that order,
    ``nrows`` stops after that many rows."""
    with open(path, encoding="utf-8-sig", newline="") as f:
        lines = _LINE_END.split(f.read())
    rows = []
    for line in lines:
        if not line.strip(" "):           # pandas skips lines of nothing but spaces
            continue
        if nrows is not None and len(rows) == nrows:
            break
        fields = line.split("\t")
        if len(fields) > ncols:
            raise ValueError(f"{path}: expected {ncols} fields, saw {len(fields)} in {line!r}")
        fields += [None] * (ncols - len(fields))
        row = [None if v is None or v in NA_STRINGS else v for v in fields]
        rows.append(row if usecols is None else [row[c] for c in usecols])
    return rows


def write_tsv(path, rows) -> None:
    """Rows as ``to_csv(sep="\\t", header=False, index=False, quoting=3)``
    writes them: None as an empty field, nothing quoted or escaped."""
    Path(os.path.dirname(path)).mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8", newline="") as f:
        f.writelines("\t".join("" if v is None else str(v) for v in row) + "\n" for row in rows)


def strict_map(values, mapping: Dict[str, int], col_name: str) -> List[int]:
    """Map values; raise on any unknown ID (``preprocess.py:80-88``)."""
    try:
        return [mapping[v] for v in values]
    except KeyError:
        unknown = list(dict.fromkeys(v for v in values if v not in mapping))
        raise KeyError(f"Unknown IDs in column '{col_name}' not in global map. "
                       f"Examples: {unknown[:5]}") from None


def build_id_maps(data_root: str, subsets=SUB_DATASETS):
    """First-appearance-order contiguous IDs from 1 for news and users."""
    news: List[str] = []
    users: List[str] = []
    train_raw_users: set = set()
    found_news = False
    for sub in subsets:
        news_path = os.path.join(data_root, sub, "news.tsv")
        if os.path.exists(news_path):
            found_news = True
            news += [r[0] for r in read_tsv(news_path, len(NEWS_COLS), usecols=[0])]
        beh_path = os.path.join(data_root, sub, "behaviors.tsv")
        if os.path.exists(beh_path):
            sub_users = [r[0] for r in read_tsv(beh_path, len(BEHAVIOR_COLS), usecols=[1])]
            users += sub_users
            if "train" in sub:
                # a list, not a dict: set.update sizes its table up front for
                # a dict, which changes the iteration order
                train_raw_users.update(list(dict.fromkeys(sub_users)))
    if not found_news:
        raise FileNotFoundError(f"No news.tsv found under {data_root}")

    news_map = {nid: i + 1 for i, nid in enumerate(dict.fromkeys(news))}
    user_map = {uid: i + 1 for i, uid in enumerate(dict.fromkeys(users))}
    train_user_ids = [user_map[u] for u in train_raw_users if u in user_map]
    logger.info(f"Global news: {len(news_map)}, users: {len(user_map)}, "
                f"train users: {len(train_user_ids)}")
    return news_map, user_map, train_user_ids


def process_all_news(data_root: str, subsets, output_path: str,
                     news_map: Dict[str, int]) -> int:
    """Merge, dedup (first appearance wins), ID-map all news; write a
    headerless TSV. Returns the number of news written."""
    rows: Dict[Optional[str], list] = {}
    for sub in subsets:
        path = os.path.join(data_root, sub, "news.tsv")
        if os.path.exists(path):
            for row in read_tsv(path, len(NEWS_COLS)):
                rows.setdefault(row[0], row)
    ids = strict_map(list(rows), news_map, "news_id")
    write_tsv(output_path, ([nid] + row[1:] for nid, row in zip(ids, rows.values())))
    return len(ids)


def parse_times(values) -> np.ndarray:
    """``pd.to_datetime(values, format=TIME_FORMAT)``: datetime64 at
    :data:`TIME_RESOLUTION`."""
    one_us = datetime.timedelta(microseconds=1)
    us = [(datetime.datetime.strptime(v, TIME_FORMAT) - _EPOCH) // one_us for v in values]
    return np.array(us, dtype=np.int64).astype(f"datetime64[{TIME_RESOLUTION}]")


def process_behaviors(input_path: str, output_path: str,
                      user_map: Dict[str, int], news_map: Dict[str, int]) -> int:
    """Time-sort, strict-map, explode impressions; write a headerless TSV.
    Returns the number of rows written (0 and no file when the input is
    missing)."""
    if not os.path.exists(input_path):
        return 0
    raw = read_tsv(input_path, len(BEHAVIOR_COLS))
    times = parse_times([r[2] for r in raw])
    order = times.argsort(kind="quicksort")            # as sort_values(by="time")
    raw = [raw[i] for i in order]
    times = times[order].astype(np.int64) // 10**9

    users = strict_map([r[1] for r in raw], user_map, "user_id")
    hist_tokens = [(r[3] or "").split(" ") for r in raw]
    mapped = strict_map([t for toks in hist_tokens for t in toks if t], news_map, "history")
    mapped_iter = iter(mapped)
    histories = [" ".join(str(next(mapped_iter)) if t else "" for t in toks).strip()
                 for toks in hist_tokens]

    impressions = [[tok.rsplit("-", 1) for tok in r[4].split(" ")] if r[4] is not None else [[None]]
                   for r in raw]
    items = strict_map([p[0] for imps in impressions for p in imps], news_map,
                       "impression_item_id")
    item_iter = iter(items)
    out = []
    for r, uid, t, hist, imps in zip(raw, users, times.tolist(), histories, impressions):
        head = [str(int(r[0])), str(uid), str(t), hist]
        out += [head + [str(next(item_iter)), str(int(p[1]))] for p in imps]
    write_tsv(output_path, out)
    return len(out)


def run_preprocess(data_root: str, out_basedir: str, subsets=SUB_DATASETS) -> None:
    """Full pipeline; wipes and rebuilds ``<out_basedir>/preprocess``."""
    pre_dir = os.path.join(out_basedir, "preprocess")
    if os.path.exists(pre_dir):
        shutil.rmtree(pre_dir)
    os.makedirs(pre_dir)

    news_map, user_map, train_user_ids = build_id_maps(data_root, subsets)
    for name, obj in (("news_id_map.json", news_map), ("user_id_map.json", user_map),
                      ("train_user_ids.json", train_user_ids)):
        with open(os.path.join(pre_dir, name), "w", encoding="utf-8") as f:
            json.dump(obj, f)

    process_all_news(data_root, subsets, os.path.join(pre_dir, "all_news_preprocess.csv"),
                     news_map)
    for sub in subsets:
        suffix = sub.split("_")[-1]  # train | dev
        process_behaviors(os.path.join(data_root, sub, "behaviors.tsv"),
                          os.path.join(pre_dir, f"{suffix}_behaviors_processed.csv"),
                          user_map, news_map)
    logger.info(f"Preprocess complete -> {pre_dir}")
