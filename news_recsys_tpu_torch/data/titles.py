"""MIND news titles as NRMS reads them: a vocabulary built from the
training split's titles and the (articles, ``title_len``) word-id table
that ``models/nrms.py`` holds on the device.

The tokenisation is Microsoft Recommenders' (``word_tokenize``): the
matches of ``[\\w]+|[.,!?;|]`` in the title, lowercased. Word ids number
from 1 in order of first appearance over the training titles (0 pads); a
word outside them reads 0, which the model masks as it masks padding. A
title keeps its first ``title_len`` tokens. Row ``i`` of the table is the
article whose preprocessed item id is ``i`` (``news_id_map.json`` of
:mod:`.preprocess`); row 0 and articles without a title stay empty.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np

from .preprocess import NEWS_COLS, read_tsv

TOKEN = re.compile(r"[\w]+|[.,!?;|]")
TITLE_COL = NEWS_COLS.index("title")


def tokenize(title: Optional[str]) -> List[str]:
    return [w.lower() for w in TOKEN.findall(title or "")]


def read_titles(path: str) -> Dict[str, str]:
    """news id -> title of a MIND ``news.tsv`` (first appearance wins)."""
    out: Dict[str, str] = {}
    for row in read_tsv(path, len(NEWS_COLS)):
        out.setdefault(row[0], row[TITLE_COL] or "")
    return out


def build_vocab(titles: Iterable[str]) -> Dict[str, int]:
    """word -> id (1, 2, ...) over ``titles`` in first-appearance order."""
    vocab: Dict[str, int] = {}
    for title in titles:
        for w in tokenize(title):
            vocab.setdefault(w, len(vocab) + 1)
    return vocab


def title_table(titles: Mapping[str, str], news_map: Mapping[str, int], vocab: Mapping[str, int],
                title_len: int = 30) -> np.ndarray:
    """The (largest mapped id + 1, ``title_len``) int32 word-id table: row
    ``news_map[id]`` holds the first ``title_len`` tokens of ``titles[id]``
    (0 for a word outside ``vocab`` and after the title)."""
    out = np.zeros((max(news_map.values(), default=0) + 1, title_len), np.int32)
    for nid, title in titles.items():
        row = news_map.get(nid)
        if row is None:
            continue
        ids = [vocab.get(w, 0) for w in tokenize(title)[:title_len]]
        out[row, :len(ids)] = ids
    return out


def mind_title_table(train_news: str, news_paths: Sequence[str], news_map: Mapping[str, int],
                     title_len: int = 30) -> tuple:
    """(table, vocab) from MIND files: the vocabulary of ``train_news``'s
    titles, the table over every ``news_paths`` file's titles (the first
    file that names an article wins)."""
    vocab = build_vocab(read_titles(train_news).values())
    titles: Dict[str, str] = {}
    for path in news_paths:
        for nid, title in read_titles(path).items():
            titles.setdefault(nid, title)
    return title_table(titles, news_map, vocab, title_len), vocab
