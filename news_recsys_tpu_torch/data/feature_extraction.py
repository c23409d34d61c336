"""Feature extraction: pluggable, vectorized extractors, packed-array output.

The port's own version of :mod:`news_recsys_tpu.data.feature_extraction`,
on numpy, json and yaml: the JAX package's runs on pandas, which the port
does not depend on. On the same preprocessed files it writes the same
files (``tests/test_torch_data_pipeline.py``): equal ``.npz`` arrays, and
byte for byte the vocab JSONs, ``dataset_extract_info.yaml`` and, with
``write_text``, the reference text format. Files are read as
:func:`.preprocess.read_tsv` reads them (pandas' ``quoting=3`` and NA
strings); a missing item attribute becomes ``"unknown"``.

- each feature is a vectorized extractor registered under the feature name
  (:func:`register_extractor`) and called once per split with the whole
  split (:class:`ExtractionContext`); outputs are packed int32 / float32
  arrays (``.npz``, masks stored as uint8);
- auto-growing value -> index vocabularies per feature, new ids from 1 with
  0 reserved, shared tables aliased (``share_emb_table_features``), ids
  assigned in first-encounter order over train rows, then dev rows, then
  the item table;
- the same persisted artifacts: ``original_val_2_embedding_idx_dict.json``,
  ``embedding_idx_2_original_val_dict.json``, ``dataset_extract_info.yaml``,
  and the item-only features for the item tower.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import yaml

from ..config import Config
from ..utils.logging import get_logger
from .preprocess import NEWS_COLS, read_tsv

logger = get_logger("feature_extraction")

BEHAVIOR_COLS = ["impression_id", "user_id", "time", "history", "item_id", "label"]
UNKNOWN = "unknown"


def behaviors_columns(rows) -> Dict[str, np.ndarray]:
    """The columns of ``<split>_behaviors_processed.csv`` rows (as
    :func:`.preprocess.read_tsv` reads them): int64 ids, times and labels,
    and ``history`` as its raw click string ("" for none)."""
    cols = dict(zip(BEHAVIOR_COLS, zip(*rows))) if rows else {c: () for c in BEHAVIOR_COLS}
    out = {c: np.array([int(v) for v in cols[c]], dtype=np.int64)
           for c in ("impression_id", "user_id", "time", "item_id", "label")}
    out["history"] = np.array([v or "" for v in cols["history"]], dtype=object)
    return out


def read_behaviors(path) -> Dict[str, np.ndarray]:
    """:func:`behaviors_columns` of a whole processed behaviors file."""
    return behaviors_columns(read_tsv(path, len(BEHAVIOR_COLS)))


# ---------------------------------------------------------------------------
# Vocab management (reference: feature_extractor_base.py:140-172, 272-287)
# ---------------------------------------------------------------------------


class VocabManager:
    """Per-feature value->index maps, auto-growing from 1 (0 = padding)."""

    def __init__(self, feature_names, share_map: Optional[Dict[str, str]] = None):
        self.share_map = dict(share_map or {})
        self.val2idx: Dict[str, Dict[Any, int]] = {f: {} for f in feature_names}
        self.idx2val: Dict[str, Dict[int, Any]] = {f: {} for f in feature_names}

    def _target(self, feature_name: str) -> str:
        return self.share_map.get(feature_name, feature_name)

    def get_idx(self, feature_name: str, value: Any) -> int:
        name = self._target(feature_name)
        vmap = self.val2idx[name]
        idx = vmap.get(value)
        if idx is None:
            idx = len(vmap) + 1
            vmap[value] = idx
            self.idx2val[name][idx] = value
        return idx

    def bulk_assign(self, feature_name: str, values_in_order) -> None:
        """Assign ids to values in first-occurrence order."""
        name = self._target(feature_name)
        for v in dict.fromkeys(values_in_order):
            self.get_idx(name, v)

    def map_values(self, feature_name: str, values) -> np.ndarray:
        name = self._target(feature_name)
        vmap = self.val2idx[name]
        try:
            return np.fromiter((vmap[v] for v in values), dtype=np.int32, count=len(values))
        except KeyError:
            missing = list(dict.fromkeys(v for v in values if v not in vmap))[:5]
            raise KeyError(f"Values not in vocab '{name}': {missing}") from None

    def save(self, out_dir: str) -> None:
        # reference format: {feature: [ {val: idx}, max_idx ]}
        v2i = {f: [m, len(m)] for f, m in self.val2idx.items()}
        with open(os.path.join(out_dir, "original_val_2_embedding_idx_dict.json"), "w",
                  encoding="utf-8") as f:
            json.dump(v2i, f, indent=2)
        with open(os.path.join(out_dir, "embedding_idx_2_original_val_dict.json"), "w",
                  encoding="utf-8") as f:
            json.dump(self.idx2val, f, indent=2)
        if self.share_map:
            with open(os.path.join(out_dir, "vocab_share_map.json"), "w", encoding="utf-8") as f:
                json.dump(self.share_map, f, indent=2)


# ---------------------------------------------------------------------------
# Extraction context + registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ItemTable:
    """The preprocessed news: ``ids`` (N,) int64 news ids, and per column of
    :data:`NEWS_COLS` after the first an (N,) object array of its text (None
    where missing)."""

    ids: np.ndarray
    cols: Dict[str, np.ndarray]

    def __post_init__(self):
        size = int(self.ids.max()) + 1 if len(self.ids) else 1
        self._pos = np.full(size, -1, dtype=np.int64)
        self._pos[self.ids] = np.arange(len(self.ids))

    def __len__(self) -> int:
        return len(self.ids)

    def positions(self, item_ids: np.ndarray) -> np.ndarray:
        """Row of each id in the table, -1 for an id the table lacks."""
        item_ids = np.asarray(item_ids, dtype=np.int64)
        ok = (item_ids >= 0) & (item_ids < len(self._pos))
        return np.where(ok, self._pos[np.where(ok, item_ids, 0)], -1)

    def filled(self, col: str) -> np.ndarray:
        """The column with missing values as ``"unknown"``."""
        vals = self.cols[col].copy()
        vals[np.equal(vals, None)] = UNKNOWN
        return vals


class ExtractionContext:
    """Column-level view of one behaviors split + the global item data.

    ``behaviors`` maps each column of :data:`BEHAVIOR_COLS` to an array of
    the split's rows; ``behaviors["history"]`` holds the raw space-joined
    id strings, which sequence extractors read through
    :meth:`history_exploded`.
    """

    def __init__(self, behaviors: Dict[str, np.ndarray], items: ItemTable, vocab: VocabManager,
                 array_max_length: Optional[Dict[str, int]] = None):
        self.behaviors = behaviors
        self.items = items
        self.vocab = vocab
        self.array_max_length = dict(array_max_length or {})
        self._hist_cache = None
        self._code_cache: Dict[str, tuple] = {}

    def __len__(self) -> int:
        return len(self.behaviors["item_id"])

    def vocab_max_len(self, feature: str) -> int:
        if feature not in self.array_max_length:
            raise ValueError(f"array_max_length for '{feature}' missing in config")
        return self.array_max_length[feature]

    def history_exploded(self):
        """(row_idx (M,), values (M,), lengths (N,)): all histories parsed in
        one C pass (a join and ``np.fromstring``)."""
        if self._hist_cache is None:
            hist = self.behaviors["history"]
            lengths = np.fromiter(((s.count(" ") + 1 if s else 0) for s in hist),
                                  dtype=np.int64, count=len(hist))
            joined = " ".join(hist)
            if joined.strip():
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", DeprecationWarning)
                    values = np.fromstring(joined, dtype=np.int64, sep=" ")
            else:
                values = np.array([], dtype=np.int64)
            if len(values) != int(lengths.sum()):
                raise ValueError(
                    "history parse mismatch: "
                    f"{len(values)} ids vs lengths sum {int(lengths.sum())} "
                    "(non-numeric history token?)")
            row_idx = np.repeat(np.arange(len(hist)), lengths)
            self._hist_cache = (row_idx, values, lengths)
        return self._hist_cache

    def item_col(self, col: str, item_ids: np.ndarray) -> np.ndarray:
        """Item attribute for each id (missing ids and values -> 'unknown')."""
        pos = self.items.positions(item_ids)
        out = np.full(len(pos), UNKNOWN, dtype=object)
        ok = pos >= 0
        out[ok] = self.items.filled(col)[pos[ok]]
        return out

    def item_code_lookup(self, col: str):
        """Dense news-id -> code lookup for ``col`` (``pd.factorize``'s codes:
        values numbered in first-appearance order over the item table).

        ``(lookup, values)``: ``lookup[news_id]`` is the code of the item's
        value in ``values``; ids outside the item table get the sentinel
        code ``len(values)`` meaning 'unknown'.
        """
        if col not in self._code_cache:
            vals = self.items.filled(col)
            values = list(dict.fromkeys(vals))
            code_of = {v: i for i, v in enumerate(values)}
            codes = np.fromiter((code_of[v] for v in vals), dtype=np.int64, count=len(vals))
            ids = self.items.ids
            size = int(ids.max()) + 1 if len(ids) else 1
            lookup = np.full(size, len(values), dtype=np.int64)
            lookup[ids] = codes
            self._code_cache[col] = (lookup, values)
        return self._code_cache[col]


# Vectorized extractor: ctx -> int32/float32 array of shape (N,) or (N, L),
# or a dict of such arrays (an array feature's ids and mask)
ExtractorFn = Callable[[ExtractionContext], Any]
EXTRACTORS: Dict[str, ExtractorFn] = {}


def register_extractor(name: str):
    def deco(fn: ExtractorFn):
        EXTRACTORS[name] = fn
        return fn
    return deco


@register_extractor("user_id")
def _extract_user_id(ctx: ExtractionContext) -> np.ndarray:
    # pass-through of the preprocessor's int IDs (feature_extractor.py:15-18)
    return np.asarray(ctx.behaviors["user_id"], dtype=np.int32)


@register_extractor("item_id")
def _extract_item_id(ctx: ExtractionContext) -> np.ndarray:
    return np.asarray(ctx.behaviors["item_id"], dtype=np.int32)


@register_extractor("category")
def _extract_category(ctx: ExtractionContext) -> np.ndarray:
    vals = ctx.item_col("category", ctx.behaviors["item_id"])
    ctx.vocab.bulk_assign("category", vals)
    return ctx.vocab.map_values("category", vals)


@register_extractor("subcategory")
def _extract_subcategory(ctx: ExtractionContext) -> np.ndarray:
    vals = ctx.item_col("subcategory", ctx.behaviors["item_id"])
    ctx.vocab.bulk_assign("subcategory", vals)
    return ctx.vocab.map_values("subcategory", vals)


@register_extractor("user_click_category")
def _extract_user_click_category(ctx: ExtractionContext) -> np.ndarray:
    """Argmax-count category over the user's click history.

    Parity with ``feature_extractor.py:35-55`` including id-assignment order
    (vocab ids assigned while streaming each row's history; empty-history
    rows assign/use 'unknown') and tie-breaking (first category-id reaching
    the max count in history order wins).
    """
    row_idx, flat_news, lengths = ctx.history_exploded()
    n_rows = len(ctx)

    # per-news category codes through one dense lookup; out-of-table ids
    # share the 'unknown' sentinel with empty-history rows
    lookup, code_values = ctx.item_code_lookup("category")
    outside = (flat_news < 0) | (flat_news >= len(lookup))
    codes = lookup[np.where(outside, 0, flat_news)]
    codes[outside] = len(code_values)
    unknown_code = len(code_values)

    # vocab id assignment order: per row, history categories in order; empty
    # rows contribute 'unknown' at their stream position
    empty_rows = lengths == 0
    stream_rows = np.concatenate([row_idx, np.flatnonzero(empty_rows)])
    stream_codes = np.concatenate([codes, np.full(int(empty_rows.sum()), unknown_code,
                                                  dtype=np.int64)])
    stream_codes = stream_codes[np.argsort(stream_rows, kind="stable")]
    uniq_codes, first_pos = np.unique(stream_codes, return_index=True)
    code_to_vocab = np.zeros(unknown_code + 1, dtype=np.int32)
    for code in uniq_codes[np.argsort(first_pos)]:
        val = UNKNOWN if code == unknown_code else code_values[code]
        code_to_vocab[code] = ctx.vocab.get_idx("user_click_category", val)

    # 'unknown' enters the vocab only if some row needs it
    unknown_idx = ctx.vocab.get_idx("user_click_category", UNKNOWN) if empty_rows.any() else 0
    out = np.full(n_rows, unknown_idx, dtype=np.int32)
    if len(codes):
        # count per (row, code); ties go to the first position in history
        base = unknown_code + 1
        keys = row_idx * base + codes
        uniq_keys, first_idx, counts = np.unique(keys, return_index=True, return_counts=True)
        rows = (uniq_keys // base).astype(np.int64)
        key_codes = (uniq_keys % base).astype(np.int64)
        win_order = np.lexsort((first_idx, -counts, rows))
        rows_sorted = rows[win_order]
        is_winner = np.concatenate([[True], rows_sorted[1:] != rows_sorted[:-1]])
        out[rows_sorted[is_winner]] = code_to_vocab[key_codes[win_order][is_winner]]
    return out


def _pad_lists(lists, max_len: int):
    """List of int-lists -> (N, L) int32 padded + (N, L) float32 mask,
    keeping the FIRST max_len entries (``data_reader.py:101-107``)."""
    n = len(lists)
    ids = np.zeros((n, max_len), dtype=np.int32)
    mask = np.zeros((n, max_len), dtype=np.float32)
    for i, lst in enumerate(lists):
        ln = min(len(lst), max_len)
        if ln:
            ids[i, :ln] = lst[:ln]
            mask[i, :ln] = 1.0
    return ids, mask


@register_extractor("hist")
def _extract_hist(ctx: ExtractionContext) -> Dict[str, np.ndarray]:
    """User click-history as a padded item-id sequence (array feature),
    sharing the item_id table through ``share_emb_table_features``;
    truncation keeps the FIRST max_len entries."""
    max_len = int(ctx.vocab_max_len("hist"))
    row_idx, values, lengths = ctx.history_exploded()
    n = len(lengths)
    ids = np.zeros((n, max_len), dtype=np.int32)
    mask = np.zeros((n, max_len), dtype=np.float32)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    pos = np.arange(len(values)) - starts[row_idx]
    keep = pos < max_len
    ids[row_idx[keep], pos[keep]] = values[keep]
    mask[row_idx[keep], pos[keep]] = 1.0
    return {"hist": ids, "hist_mask": mask}


def _wikidata_ids(raw) -> list:
    try:
        ents = json.loads(raw) if raw and raw not in ("[]", UNKNOWN) else []
    except Exception:
        ents = []
    return [e.get("WikidataId") for e in ents if isinstance(e, dict) and e.get("WikidataId")]


@register_extractor("entities")
def _extract_entities(ctx: ExtractionContext) -> Dict[str, np.ndarray]:
    """Candidate item's title entities (WikidataId) as an array feature,
    from the MIND ``title_entities`` JSON column; ids auto-vocab from 1."""
    max_len = int(ctx.vocab_max_len("entities"))
    parsed: Dict[Any, list] = {}
    lists = []
    for raw in ctx.item_col("title_entities", ctx.behaviors["item_id"]):
        if raw not in parsed:
            parsed[raw] = _wikidata_ids(raw)
        lists.append(parsed[raw])
    ctx.vocab.bulk_assign("entities", (w for wids in lists for w in wids))
    vmap = ctx.vocab.val2idx[ctx.vocab._target("entities")]
    ids, mask = _pad_lists([[vmap[w] for w in wids] for wids in lists], max_len)
    return {"entities": ids, "entities_mask": mask}


def default_label_extractor(ctx: ExtractionContext) -> np.ndarray:
    """The click label as (N, 1) float32 (``feature_extractor.py:60-61``)."""
    return np.asarray(ctx.behaviors["label"], dtype=np.float32).reshape(-1, 1)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


class FeatureExtractionPipeline:
    """Run the configured extractors over train/dev behaviors + items.

    Outputs into ``<out_basedir>/extractored_feature/``:
    ``{train,dev}_features.npz``, ``item_features.npz``, the two vocab JSONs,
    ``dataset_extract_info.yaml``; optionally the reference text format.
    """

    def __init__(self, cfg: Config, write_text: bool = False, limit_rows: int = 0):
        self.cfg = cfg
        self.write_text = write_text
        # sampling path for first real-data runs: keep only the first N
        # exploded behavior rows per split (time-sorted head, so history
        # prefixes stay self-consistent); 0 = full extraction
        self.limit_rows = int(limit_rows)
        if self.limit_rows < 0:
            raise ValueError(f"limit_rows must be >= 0, got {limit_rows}")
        self.feature_names = list(cfg.features.feature_names) or sorted(
            set(cfg.features.sparse_feature_names)
            | set(cfg.features.dense_feature_names)
            | set(cfg.features.array_feature_names)
        )
        self.item_feature_names = list(cfg.features.item_feature_names)
        self.vocab = VocabManager(self.feature_names, cfg.embeddings.share_emb_table_features
                                  if cfg.embeddings else {})
        base = Path(cfg.paths.out_basedir)
        self.pre_dir = base / "preprocess"
        self.out_dir = base / "extractored_feature"

    def _load_items(self) -> ItemTable:
        rows = read_tsv(self.pre_dir / "all_news_preprocess.csv", len(NEWS_COLS))
        cols = list(zip(*rows)) if rows else [()] * len(NEWS_COLS)
        ids = np.array([int(v) for v in cols[0]], dtype=np.int64)
        return ItemTable(ids, {c: np.array(v, dtype=object)
                               for c, v in zip(NEWS_COLS[1:], cols[1:])})

    def _load_behaviors(self, split: str) -> Optional[Dict[str, np.ndarray]]:
        path = self.pre_dir / f"{split}_behaviors_processed.csv"
        if not path.exists():
            return None
        # read one extra row so an nrows cut can be detected and snapped to an
        # impression boundary (a truncated final candidate list would bias the
        # per-impression grouped dev metrics)
        rows = read_tsv(path, len(BEHAVIOR_COLS),
                        nrows=(self.limit_rows + 1) if self.limit_rows else None)
        if self.limit_rows and len(rows) > self.limit_rows:
            extra_imp = int(rows[self.limit_rows][0])
            rows = rows[: self.limit_rows]
            if int(rows[-1][0]) == extra_imp:
                # the cut split an impression: drop its partial head entirely
                rows = [r for r in rows if int(r[0]) != extra_imp]
            logger.warning(f"{split}: --limit-rows {self.limit_rows} sampling "
                           f"active ({len(rows)} rows kept, cut on an "
                           "impression boundary)")
        return behaviors_columns(rows) if rows else None

    def _extract_split(self, behaviors, items: ItemTable, names: List[str],
                       with_label: bool) -> Dict[str, np.ndarray]:
        ctx = ExtractionContext(behaviors, items, self.vocab,
                                self.cfg.features.array_max_length)
        out: Dict[str, np.ndarray] = {}
        for name in names:
            if name not in EXTRACTORS:
                raise NotImplementedError(
                    f"No extractor registered for feature '{name}'. "
                    f"Register one with @register_extractor({name!r}).")
            result = EXTRACTORS[name](ctx)
            if isinstance(result, dict):    # array extractors: ids + mask
                out.update(result)
            else:
                out[name] = result
        if with_label:
            out["label"] = default_label_extractor(ctx)
        return out

    @staticmethod
    def _save_npz(path, feats: Dict[str, np.ndarray]) -> None:
        """Uncompressed npz; masks stored uint8 (0/1), which
        ``PackedDataset.load`` restores to float32."""
        np.savez(path, **{k: (v.astype(np.uint8) if k.endswith("_mask") else v)
                          for k, v in feats.items()})

    def _write_split(self, name: str, feats: Dict[str, np.ndarray], names: List[str]) -> None:
        self._save_npz(self.out_dir / f"{name}_features.npz", feats)
        if self.write_text:
            from .text_format import write_text_features
            write_text_features(self.out_dir / f"{name}_features.txt", feats, names)

    def run(self) -> None:
        if self.out_dir.exists():
            logger.warning(f"Cleaning existing output directory: {self.out_dir}")
            shutil.rmtree(self.out_dir)
        self.out_dir.mkdir(parents=True)

        items = self._load_items()
        for split in ("train", "dev"):
            behaviors = self._load_behaviors(split)
            if behaviors is None:
                logger.warning(f"No behaviors for split {split}")
                continue
            self._write_split(split, self._extract_split(behaviors, items, self.feature_names,
                                                         with_label=True), self.feature_names)
            logger.info(f"{split}: {len(behaviors['item_id'])} rows extracted")

        # Item-only features (for the item tower / ANN index): the reference
        # extracts item_feature_names only (feature_extractor_base.py:253-270),
        # label placeholder -1.
        n = len(items)
        item_behaviors = {"user_id": np.zeros(n, dtype=np.int64),
                          "time": np.zeros(n, dtype=np.int64),
                          "history": np.full(n, "", dtype=object),
                          "item_id": items.ids,
                          "label": np.full(n, -1, dtype=np.int64)}
        item_names = [f for f in self.item_feature_names if f in EXTRACTORS]
        self._write_split("item", self._extract_split(item_behaviors, items, item_names,
                                                      with_label=True), item_names)

        self.vocab.save(str(self.out_dir))
        with open(self.out_dir / "dataset_extract_info.yaml", "w", encoding="utf-8") as f:
            yaml.safe_dump({"name": self.cfg.name,
                            "features": dataclasses.asdict(self.cfg.features)}, f)
        logger.info(f"Feature extraction complete -> {self.out_dir}")
