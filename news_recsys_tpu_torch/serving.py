"""Serving: DSSM recall, the recall -> rank cascade, bundles and the HTTP shim.

Port of :mod:`news_recsys_tpu.serving` on PyTorch. A :class:`Recommender`
encodes the item corpus once on its ``device`` and serves batched
user -> top-k queries with per-user history dedup; a
:class:`CascadeRecommender` re-scores the recall stage's ``fetch``
candidates with any ranker of the port's zoo (LR, Deep, Wide&Deep, FM,
DeepFM, DCN v1/v2) and serves the top-k by ranker score. On a CUDA device
the user tower's history pooling, DCN-v1's cross stack and the FM second
order run in the port's CUDA kernels. The recall's top-k search runs on the
Recommender's device (``backend="device"``, :class:`~.ops.topk.TopKSearcher`)
or on the host (``"host"``, the C++ :class:`~.native.HostTopKSearcher` over a
CPU copy of the corpus); ``"auto"`` takes the device on a card and the host
on the CPU, as the JAX package does. :func:`build_cascade` composes a
cascade from a recall bundle and a ranker's training checkpoint.

Bundles are directories of plain files, so no flax is needed to read them:
``config.json``, ``params.npz`` (numpy arrays keyed by flax path, see
:mod:`news_recsys_tpu_torch.convert`), ``corpus.npz`` and ``meta.json``; a
cascade bundle nests ``recall/`` and adds ``ranker/`` and
``item_features.npz``. ``scripts/export_torch_bundle.py`` writes them from
the JAX package's bundles.
"""

from __future__ import annotations

import itertools
import json
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import DENSE, Config, config_from_dict, config_to_dict, load_config
from .convert import params_from_flax, params_to_flax
from .data.packed_dataset import Batch, PackedDataset
from .models.dssm import DSSM, _l2, build_dssm
from .models.rankers import build_ranker
from .native import HostTopKSearcher
from .ops.topk import TopKSearcher
from .training.checkpoint import load_state, resolve_ckpt
from .utils.logging import get_logger
from .utils.profiling import active, count, span

logger = get_logger("torch_serving")

BUNDLE_FORMAT_VERSION = 1
_VOCAB_FILES = ("original_val_2_embedding_idx_dict.json",
                "embedding_idx_2_original_val_dict.json")


def _tensors(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items() if k != "label"}


def _save_model(path: str, cfg: Config, model: torch.nn.Module) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_dict(cfg), f, indent=1)
    np.savez(os.path.join(path, "params.npz"), **params_to_flax(model))


def _load_config(path: str) -> Config:
    cfg_path = os.path.join(path, "config.json")
    if not os.path.exists(cfg_path):
        hint = (" (it holds config.yaml: a JAX bundle; convert it with "
                "scripts/export_torch_bundle.py)"
                if os.path.exists(os.path.join(path, "config.yaml")) else "")
        raise ValueError(f"{path} is not a bundle of this package: no config.json{hint}")
    with open(cfg_path) as f:
        return config_from_dict(json.load(f))


def _load_params(path: str, model: torch.nn.Module) -> torch.nn.Module:
    with np.load(os.path.join(path, "params.npz")) as z:
        return params_from_flax({k: z[k] for k in z.files}, model)


def _read_meta(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["format_version"] > BUNDLE_FORMAT_VERSION:
        raise ValueError(f"Bundle format {meta['format_version']} is newer "
                         f"than supported {BUNDLE_FORMAT_VERSION}")
    return meta


BACKENDS = ("auto", "device", "host")
_NO_ITEM = np.iinfo(np.int64).max       # pads a history row: equals no item id, sorts last


def _history_lengths(histories, n_users: int) -> np.ndarray:
    """(n_users,) int64 lengths of ``histories`` (all 0 where there are none)."""
    if not histories:
        return np.zeros(n_users, np.int64)
    if len(histories) != n_users:
        raise ValueError(f"histories has {len(histories)} rows for {n_users} users")
    try:
        return np.fromiter(map(len, histories), np.int64, n_users)
    except TypeError as e:
        raise ValueError(f"histories must be lists of item ids: {e}") from None


def _history_matrix(histories, lens: np.ndarray) -> np.ndarray:
    """(len(lens), H) int64, H the longest history (at least 1): row r holds
    ``histories[r]`` sorted, then ``_NO_ITEM``."""
    out = np.full((len(lens), max(int(lens.max(initial=0)), 1)), _NO_ITEM, np.int64)
    if histories:
        try:
            flat = np.fromiter(itertools.chain.from_iterable(histories), np.int64,
                               int(lens.sum()))
        except (TypeError, ValueError, OverflowError) as e:
            raise ValueError(f"histories must hold int64 item ids: {e}") from None
        out[np.arange(out.shape[1]) < lens[:, None]] = flat
        out.sort(axis=1)
    return out


def first_unseen(ids: torch.Tensor, scores: torch.Tensor, hist: torch.Tensor,
                 k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each row's first ``k`` candidates of ``ids`` (B, F), in their order,
    whose id its row of ``hist`` (B, H), sorted, lacks: (ids, scores), each
    (B, k) with a row's kept candidates first, and how many a row kept (B,);
    ``k`` at most F. One binary search a candidate, so memory is O(B (F + H));
    nothing waits for the device."""
    pos = torch.searchsorted(hist, ids).clamp_(max=hist.shape[1] - 1)
    keep = hist.gather(1, pos) != ids
    rank = keep.cumsum(1)
    keep &= rank <= k
    slot = torch.where(keep, rank - 1, k)         # column k takes the dropped ones
    kept_ids = ids.new_zeros(len(ids), k + 1).scatter_(1, slot, ids)[:, :k]
    kept_scores = scores.new_zeros(len(ids), k + 1).scatter_(1, slot, scores)[:, :k]
    return kept_ids, kept_scores, keep.sum(1)


class Recommender:
    """DSSM recall: exact top-k over the L2-normalised item corpus, searched
    on the device or on the host (``backend``, module docstring)."""

    def __init__(self, cfg: Config, model: DSSM, item_ds: Optional[PackedDataset] = None,
                 device="cuda", batch_size: int = 1024, backend: str = "auto",
                 _corpus: Optional[np.ndarray] = None,
                 _item_ids: Optional[np.ndarray] = None):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        if _corpus is not None:
            corpus = torch.as_tensor(np.asarray(_corpus, np.float32), device=self.device)
            self.item_ids = np.asarray(_item_ids, np.int64)
        else:
            if item_ds is None:
                raise ValueError("Recommender needs item_ds (or a saved corpus)")
            corpus = _l2(self._encode(item_ds, self.model.item_embedding))
            self.item_ids = item_ds.arrays["item_id"].astype(np.int64)
        self.corpus = corpus.cpu().numpy()                       # L2-normed
        if backend == "auto":
            backend = "host" if self.device.type == "cpu" else "device"
        self.backend = backend
        if backend == "host":
            self.searcher = HostTopKSearcher(normalize=False)
            self.searcher.update_embedding(self.corpus)
        else:
            self.searcher = TopKSearcher(device=self.device)
            self.searcher.update_embedding(corpus)
        # corpus row -> item id, where the search leaves its results
        self._item_of_row = torch.as_tensor(self.item_ids, device=self.searcher.device)
        logger.info(f"Recommender ready: {len(self.item_ids)} items on {self.device}, "
                    f"search backend {self.backend}")

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> str:
        """Bundle: ``config.json``, ``params.npz``, ``corpus.npz``,
        ``meta.json`` and, when feature extraction left them, ``vocab/*.json``."""
        _save_model(path, self.cfg, self.model)
        np.savez(os.path.join(path, "corpus.npz"), corpus=self.corpus, item_ids=self.item_ids)
        fe_dir = os.path.join(self.cfg.paths.out_basedir, "extractored_feature")
        copied = []
        for fname in _VOCAB_FILES:
            src = os.path.join(fe_dir, fname)
            if os.path.exists(src):
                os.makedirs(os.path.join(path, "vocab"), exist_ok=True)
                shutil.copy(src, os.path.join(path, "vocab", fname))
                copied.append(fname)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"format_version": BUNDLE_FORMAT_VERSION,
                       "n_items": int(len(self.item_ids)),
                       "dim": int(self.corpus.shape[1]),
                       "vocab_files": copied}, f, indent=2)
        logger.info(f"Bundle saved -> {path}")
        return path

    @classmethod
    def load(cls, path: str, device="cuda", batch_size: int = 1024,
             backend: str = "auto") -> "Recommender":
        """Restore a bundle saved by :meth:`save`; no item re-encode."""
        _read_meta(path)
        cfg = _load_config(path)
        model = _load_params(path, build_dssm(cfg, device=device))
        with np.load(os.path.join(path, "corpus.npz")) as z:
            corpus, item_ids = z["corpus"], z["item_ids"]
        return cls(cfg, model, device=device, batch_size=batch_size, backend=backend,
                   _corpus=corpus, _item_ids=item_ids)

    # -- serving -------------------------------------------------------------

    def _encode(self, ds: PackedDataset, fn) -> torch.Tensor:
        """``fn`` over ``ds`` in order, ``batch_size`` rows at a time -> (len(ds), D)."""
        with torch.inference_mode():
            return torch.cat([fn(_tensors({k: v[s:s + self.batch_size]
                                           for k, v in ds.arrays.items()}, self.device))
                              for s in range(0, len(ds), self.batch_size)])

    def recommend(self, user_batch: Batch, k: int = 10,
                  histories: Optional[Sequence[Sequence[int]]] = None
                  ) -> Tuple[List[List[int]], List[List[float]]]:
        """Top-k news ids per user row (history items excluded)."""
        with span("serve.recall"):
            return self._recommend(user_batch, k, histories)

    def _recommend(self, user_batch: Batch, k: int, histories) -> tuple:
        users = PackedDataset(dict(user_batch))
        lens = _history_lengths(histories, len(users))
        if not len(users):
            return [], []
        with span("serve.recall.tower"), torch.inference_mode():
            emb = _l2(self._encode(users, self.model.user_embedding))
        fetch = min(k + int(lens.max()), len(self.item_ids))
        k = min(k, fetch)                                   # no row keeps more than it fetched
        with span("serve.recall.search"):
            idx, scores = self.searcher.search_tensors(emb, fetch)
        with span("serve.recall.dedup"), torch.inference_mode():
            # pageable memory is staged before the call returns: the copy waits for nothing
            hist = torch.from_numpy(_history_matrix(histories, lens)).to(idx.device,
                                                                          non_blocking=True)
            ids, scores, kept = first_unseen(self._item_of_row[idx], scores, hist, k)
            # one copy: ids, the count kept, the scores' float32 bits, all int64
            packed = torch.cat([ids, kept[:, None], scores.view(torch.int32).long()], 1)
            with span("serve.recall.search.wait"):
                packed = packed.cpu().numpy()
            n_kept = packed[:, k].tolist()
            rec_ids = packed[:, :k].tolist()
            rec_scores = packed[:, k + 1:].astype(np.int32).view(np.float32).tolist()
            for ids_row, scores_row, n in zip(rec_ids, rec_scores, n_kept):
                del ids_row[n:], scores_row[n:]
        if active():
            count("recall.fetched", len(users) * fetch)
            count("recall.kept", sum(n_kept))
        return rec_ids, rec_scores


class CascadeRecommender:
    """Recall -> rank cascade: the recall stage narrows the corpus to
    ``fetch`` candidates, the ranker re-scores each (user, candidate) pair
    with the candidate's item features joined from ``item_ds``, and the
    top-k by ranker score is served with sigmoid scores.

    A candidate id missing from ``item_ds`` becomes an invalid slot (never
    served); the JAX cascade joins it to item row 0 instead.
    """

    def __init__(self, recall: Recommender, ranker_cfg: Config, ranker_model,
                 item_ds: PackedDataset, fetch: int = 100):
        self.recall = recall
        self.device = recall.device
        self.ranker_cfg = ranker_cfg
        self.ranker_model = ranker_model.to(self.device).eval()
        self.fetch = fetch

        f = ranker_cfg.features
        self.item_feature_names = tuple(sorted(f.item_feature_names))
        self.user_feature_names = tuple(
            n for n in sorted(set(f.user_feature_names))
            if n not in set(f.item_feature_names))
        self.item_arrays = {k: np.asarray(v) for k, v in item_ds.arrays.items()}
        # item-id -> corpus row join table; -1 marks ids the corpus lacks
        ids = self.item_arrays["item_id"].astype(np.int64)
        self._pos = np.full(int(ids.max()) + 2, -1, np.int64)
        self._pos[ids] = np.arange(ids.size)
        joined = [n for n in self.item_arrays
                  if n in self.item_feature_names
                  or n.removesuffix("_mask") in self.item_feature_names]
        self._items = _tensors({n: self.item_arrays[n] for n in joined}, self.device)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> str:
        """Bundle: ``recall/`` (a :class:`Recommender` bundle),
        ``ranker/{config.json, params.npz}``, ``item_features.npz``, ``meta.json``."""
        os.makedirs(path, exist_ok=True)
        self.recall.save(os.path.join(path, "recall"))
        _save_model(os.path.join(path, "ranker"), self.ranker_cfg, self.ranker_model)
        np.savez(os.path.join(path, "item_features.npz"), **self.item_arrays)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"format_version": BUNDLE_FORMAT_VERSION,
                       "kind": "cascade", "fetch": self.fetch,
                       "ranker": self.ranker_cfg.name}, f, indent=2)
        logger.info(f"Cascade bundle saved -> {path}")
        return path

    @classmethod
    def load(cls, path: str, device="cuda", fetch: Optional[int] = None,
             backend: str = "auto") -> "CascadeRecommender":
        meta = _read_meta(path)
        if meta.get("kind") != "cascade":
            raise ValueError(f"{path} is not a cascade bundle")
        recall = Recommender.load(os.path.join(path, "recall"), device=device, backend=backend)
        rdir = os.path.join(path, "ranker")
        rcfg = _load_config(rdir)
        model = _load_params(rdir, build_ranker(rcfg, rcfg.name, device=device))
        item_ds = PackedDataset.load(os.path.join(path, "item_features.npz"))
        return cls(recall, rcfg, model, item_ds, fetch=fetch or int(meta.get("fetch", 100)))

    # -- the cascade ---------------------------------------------------------

    def recommend(self, user_batch: Batch, k: int = 10,
                  histories: Optional[Sequence[Sequence[int]]] = None
                  ) -> Tuple[List[List[int]], List[List[float]]]:
        """Top-k per user row by ranker score over the recall stage's
        ``fetch`` candidates (history already excluded by recall)."""
        with span("serve.cascade"):
            return self._recommend(user_batch, k, histories)

    def _recommend(self, user_batch: Batch, k: int, histories) -> tuple:
        cand_ids, _ = self.recall.recommend(user_batch, k=self.fetch, histories=histories)
        with span("serve.cascade.join"):
            n_users, F = len(cand_ids), self.fetch
            flat = np.zeros((n_users, F), np.int64)
            valid = np.zeros((n_users, F), bool)
            for r, ids_row in enumerate(cand_ids):
                flat[r, :len(ids_row)] = ids_row
                valid[r, :len(ids_row)] = True
            rows = np.full((n_users, F), -1, np.int64)
            known = valid & (flat < len(self._pos))
            rows[known] = self._pos[flat[known]]
            valid &= rows >= 0
            rows_t = torch.from_numpy(np.where(valid, rows, 0).reshape(-1)).to(self.device)

            users = _tensors({n: user_batch[n] for n in user_batch
                              if n.removesuffix("_mask") in self.user_feature_names},
                             self.device)
            batch = {n: v.repeat_interleave(F, dim=0) for n, v in users.items()}
            batch.update({n: v[rows_t] for n, v in self._items.items()})
        with span("serve.cascade.rank"), torch.inference_mode():
            logits = self.ranker_model(batch).reshape(n_users, F)
            with span("serve.cascade.rank.wait"):
                logits = logits.cpu().numpy()
        with span("serve.cascade.order"):
            scores = np.where(valid, logits, -np.inf)
            order = np.argsort(-scores, axis=1, kind="stable")

        rec_ids, rec_scores = [], []
        with span("serve.cascade.lists"):
            for r in range(n_users):
                ids_row, sc_row = [], []
                for j in order[r][:k]:
                    if not valid[r, j]:
                        break
                    ids_row.append(int(flat[r, j]))
                    sc_row.append(float(1 / (1 + np.exp(-scores[r, j]))))
                rec_ids.append(ids_row)
                rec_scores.append(sc_row)
        return rec_ids, rec_scores


def build_cascade(recall_bundle: str, ranker_ckpt: str, ranker_config: str,
                  fetch: int = 100, backend: str = "auto", device="cuda") -> CascadeRecommender:
    """A cascade from a saved recall bundle, a ranker's training checkpoint
    (an ``epoch_*.pt`` or an experiment dir, whose newest one is taken) and
    the ranker's YAML config; the item features come from the config's
    extracted item split. A cascade bundle is refused before anything loads
    (the JAX package's ``serve`` reads ``--ranker-ckpt`` first and fails
    later on such a bundle)."""
    if _read_meta(recall_bundle).get("kind") == "cascade":
        raise ValueError(f"{recall_bundle} is a cascade bundle, which brings its own ranker: "
                         "serve it without --ranker-ckpt, or pass the recall bundle "
                         "(<dssm run>/bundle) with it")
    recall = Recommender.load(recall_bundle, device=device, backend=backend)
    rcfg = load_config(ranker_config)
    model = build_ranker(rcfg, rcfg.name, device=device)
    model.load_state_dict(load_state(resolve_ckpt(ranker_ckpt))["model"], strict=True)
    item_ds = PackedDataset.open_split(rcfg, "item")
    return CascadeRecommender(recall, rcfg, model, item_ds, fetch=fetch)


# ---------------------------------------------------------------------------
# HTTP shim — dependency-free JSON API over a loaded Recommender
# ---------------------------------------------------------------------------


def _http_user_specs(rec) -> list:
    """User-side feature specs a request must supply: the recall tower's
    schema, plus (cascade) any ranker user features not already in it."""
    if isinstance(rec, CascadeRecommender):
        specs = list(rec.recall.model.user_schema.specs)
        have = {s.name for s in specs}
        ranker_schema = rec.ranker_model.schema
        for name in rec.user_feature_names:
            if name not in have and name in ranker_schema:
                specs.append(ranker_schema[name])
        return specs
    return list(rec.model.user_schema.specs)


def _user_batch_from_json(rec, users: dict) -> Batch:
    """JSON feature lists -> typed arrays for the user-side schema; rejects
    negative ids."""
    specs = _http_user_specs(rec)
    batch: Batch = {}
    n = None
    for spec in specs:
        if spec.name not in users:
            raise ValueError(f"missing user feature '{spec.name}' "
                             f"(required: {[s.name for s in specs]})")
        vals = users[spec.name]
        arr = (np.asarray(vals, np.float32) if spec.kind == DENSE
               else np.asarray(vals, np.int32))
        if spec.kind != DENSE and arr.size and arr.min() < 0:
            raise ValueError(f"feature '{spec.name}' holds negative ids")
        if n is None:
            n = len(arr)
        elif len(arr) != n:
            raise ValueError(f"feature '{spec.name}' length {len(arr)} != {n}")
        batch[spec.name] = arr
    if n is None:
        raise ValueError("no user features supplied")
    batch["label"] = np.zeros((n, 1), np.float32)
    return batch


def make_http_handler(rec):
    """Request handler class bound to ``rec``.

    - ``GET /healthz`` -> ``{"status": "ok", "items": N, "backend": ...}``
    - ``POST /recommend`` with body
      ``{"users": {<feature>: [..], ...}, "k": 10, "histories": [[..], ...]}``
      -> ``{"ids": [[..]], "scores": [[..]]}``
    """
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                base = rec.recall if isinstance(rec, CascadeRecommender) else rec
                info = {"status": "ok", "items": int(len(base.item_ids)),
                        "backend": base.backend}
                if isinstance(rec, CascadeRecommender):
                    info.update(cascade=True, ranker=rec.ranker_cfg.name, fetch=rec.fetch)
                self._reply(200, info)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/recommend":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            with span("serve.request"):
                try:
                    with span("serve.parse"):
                        length = int(self.headers.get("Content-Length", 0))
                        req = json.loads(self.rfile.read(length) or b"{}")
                        batch = _user_batch_from_json(rec, req.get("users") or {})
                    k = int(req.get("k", 10))
                    if k <= 0:
                        raise ValueError(f"k must be positive, got {k}")
                    histories = req.get("histories")
                    if histories is not None and len(histories) != len(batch["label"]):
                        raise ValueError(f"histories has {len(histories)} rows for "
                                         f"{len(batch['label'])} users")
                    ids, scores = rec.recommend(batch, k=k, histories=histories)
                    code, out = 200, {"ids": ids, "scores": scores}
                except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
                    code, out = 400, {"error": str(e)}
                with span("serve.reply"):
                    self._reply(code, out)

        def log_message(self, fmt, *args):
            logger.info("http: " + fmt % args)

    return Handler


def serve_http(rec, host: str = "127.0.0.1", port: int = 8321):
    """An HTTP server for ``rec`` (not yet serving: call ``serve_forever``,
    e.g. on a thread, and ``shutdown``)."""
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer((host, port), make_http_handler(rec))
    logger.info(f"Serving on http://{host}:{server.server_address[1]} "
                f"(POST /recommend, GET /healthz)")
    return server
