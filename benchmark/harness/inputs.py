"""The benchmark's inputs, made from the run's seed with numpy alone (the
load generator's process imports this module and no torch).

The traffic follows the click law of the port's synthetic MIND generator
(``news_recsys_tpu_torch/data/synthetic.py``, the data the full-scale
scoreboard runs train on), copied here with its constants in each cell's
file (``params.law``), at the scale of the configuration's tables: 65,238
news and 94,057 users, MIND-small's.

- A news item: a category (uniform), a subcategory within it, 0 to
  ``max_entities`` entities over ``entity_share`` x news ids; a latent
  vector around its category's centre, a bias, and an exposure weight
  exp(``popularity_sigma`` N(0, 1)), its popularity.
- A user: a favourite category, a latent vector around its centre, and a
  click history: ``3 max_history`` exposures (at least 24), ``taste_share``
  of them from the favourite category and the rest from every news item the
  training split shows (its first ``train_news_share``), each by
  popularity; the clicked ones, the first ``max_history`` of them.
- P(click) = sigmoid(bias + latent (u . w) / sqrt(dim) + catmatch
  [category = favourite] + item x item bias).
- An impression: a user, uniform over the first ``train_user_share`` of the
  users (training) or over all (serving), a window of 0 to ``max_history``
  of the user's clicks, and (training) 2 to ``max_candidates`` candidates
  by popularity, each a row, labelled by the law.

Ids: news i is item id i + 1, user u user id u + 1, category c id c + 1,
subcategory s id s + 1, entity e id e + 1; id 0 pads. A row's
``user_click_category`` is the most frequent category of its history (ties
to the lowest id), 0 for an empty one.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed % 2 ** 64, stream]))


def _pad(ids: np.ndarray, length: int) -> np.ndarray:
    out = np.zeros((len(ids), length), np.int32)
    w = min(length, ids.shape[1])
    out[:, :w] = ids[:, :w]
    return out


class World:
    """The news, users and click histories of one seed, as the law draws them."""

    CHUNK = 1 << 20

    def __init__(self, config: dict, seed: int, law: dict):
        tables = {**config["recall"]["tables"], **config["ranker"]["tables"]}
        self.law = law
        n, m = tables["item_id"][0] - 1, tables["user_id"][0] - 1
        self.n_news, self.n_users = n, m
        lat, cats = law["latent"], law["categories"]
        g = rng(seed, 0)
        self.cats = g.integers(0, cats, n)
        self.subcats = self.cats * law["subcats_per_cat"] + g.integers(0, law["subcats_per_cat"], n)
        centres = g.standard_normal((cats, lat["dim"]))
        self.w = (lat["centre"] * centres[self.cats]
                  + lat["noise"] * g.standard_normal((n, lat["dim"]))).astype(np.float32)
        self.fav = g.integers(0, cats, m)
        self.u = (lat["centre"] * centres[self.fav]
                  + lat["noise"] * g.standard_normal((m, lat["dim"]))).astype(np.float32)
        self.item_bias = g.standard_normal(n)
        self.pop = np.exp(law["popularity_sigma"] * g.standard_normal(n))
        n_ent = max(20, int(n * law["entity_share"]))
        if "entities" in tables and n_ent >= tables["entities"][0]:
            raise ValueError(f"{n_ent} entities do not fit the table {tables['entities']}")
        count = g.integers(0, law["max_entities"] + 1, n)
        ent = g.integers(1, n_ent + 1, (n, law["max_entities"])).astype(np.int32)
        ent[np.arange(law["max_entities"])[None, :] >= count[:, None]] = 0
        self.entities = ent
        self.n_train_news = int(n * law["train_news_share"])
        self._histories(g)

    def click_prob(self, users: np.ndarray, items: np.ndarray) -> np.ndarray:
        c, out = self.law["logit"], np.empty(len(users))
        for i in range(0, len(users), self.CHUNK):
            u, it = users[i:i + self.CHUNK], items[i:i + self.CHUNK]
            latent = np.einsum("ij,ij->i", self.u[u], self.w[it]) / np.sqrt(self.u.shape[1])
            logit = (c["bias"] + c["latent"] * latent
                     + c["catmatch"] * (self.cats[it] == self.fav[u])
                     + c["item"] * self.item_bias[it])
            out[i:i + self.CHUNK] = 1.0 / (1.0 + np.exp(-logit))
        return out

    def popular(self, g, size, within=None) -> np.ndarray:
        """News drawn by popularity, from ``within`` (default: the training split's)."""
        items = np.arange(self.n_train_news) if within is None else within
        cdf = np.cumsum(self.pop[items])
        pick = np.searchsorted(cdf, g.random(size) * cdf[-1], side="right")
        return items[np.minimum(pick, len(items) - 1)]

    def _histories(self, g) -> None:
        law, m = self.law, self.n_users
        h = law["max_history"]
        pool = max(3 * h, 24)
        taste = g.random((m, pool)) < law["taste_share"]
        exposed = np.empty((m, pool), np.int64)
        train_cats = self.cats[:self.n_train_news]
        for c in range(law["categories"]):
            items_c, users_c = np.flatnonzero(train_cats == c), np.flatnonzero(self.fav == c)
            if not len(items_c):
                taste[users_c] = False
            elif len(users_c):
                block, sel = exposed[users_c], taste[users_c]
                block[sel] = self.popular(g, int(sel.sum()), items_c)
                exposed[users_c] = block
        exposed[~taste] = self.popular(g, int((~taste).sum()))
        clicked = g.random(m * pool) < self.click_prob(np.repeat(np.arange(m), pool),
                                                       exposed.reshape(-1))
        clicked = clicked.reshape(m, pool)
        order = np.argsort(~clicked, axis=1, kind="stable")[:, :h]
        self.hist_n = np.minimum(clicked.sum(axis=1), h)
        kept = np.arange(h)[None, :] < self.hist_n[:, None]
        self.hist = np.where(kept, np.take_along_axis(exposed, order, 1) + 1, 0).astype(np.int32)
        # the click category of each prefix of each history
        counts = np.zeros((m, law["categories"]), np.int32)
        self.click_cat = np.zeros((m, h + 1), np.int32)
        for j in range(h):
            rows = np.flatnonzero(kept[:, j])
            counts[rows, self.cats[self.hist[rows, j] - 1]] += 1
            self.click_cat[:, j + 1] = np.where(kept[:, j], counts.argmax(axis=1) + 1,
                                                self.click_cat[:, j])

    def windows(self, g, users: np.ndarray) -> np.ndarray:
        """Each impression's history window: 0 to ``max_history`` clicks."""
        return np.minimum(g.integers(0, self.law["max_history"] + 1, len(users)),
                          self.hist_n[users])

    def user_features(self, users: np.ndarray, win: np.ndarray, names, lengths) -> dict:
        out = {}
        for name in names:
            if name == "user_id":
                out[name] = (users + 1).astype(np.int32)
            elif name == "user_click_category":
                out[name] = self.click_cat[users, win]
            elif name == "hist":
                ids = self.hist[users]
                ids[np.arange(ids.shape[1])[None, :] >= win[:, None]] = 0
                out[name] = _pad(ids, lengths[name])
            else:
                raise KeyError(f"the law makes no user feature {name!r}")
        return out

    def item_features(self, items: np.ndarray, names, lengths) -> dict:
        make = {"item_id": lambda: (items + 1).astype(np.int32),
                "category": lambda: (self.cats[items] + 1).astype(np.int32),
                "subcategory": lambda: (self.subcats[items] + 1).astype(np.int32),
                "entities": lambda: _pad(self.entities[items], lengths.get("entities", 0))}
        unknown = set(names) - set(make)
        if unknown:
            raise KeyError(f"the law makes no item features {sorted(unknown)}")
        return {n: make[n]() for n in names}


def _lengths(fields) -> Dict[str, int]:
    return {f[0]: f[3] for f in fields if f[3]}


def training_rows(world: World, model: dict, rows: int, seed: int) -> Dict[str, np.ndarray]:
    """``rows`` rows of the training split's impressions, one a candidate."""
    g, law = rng(seed, 1), world.law
    n_cand = g.integers(2, law["max_candidates"] + 1, rows // 2 + 1)
    n_imp = int(np.searchsorted(np.cumsum(n_cand), rows)) + 1
    users = g.integers(0, int(world.n_users * law["train_user_share"]), n_imp)
    win = world.windows(g, users)
    users, win = np.repeat(users, n_cand[:n_imp])[:rows], np.repeat(win, n_cand[:n_imp])[:rows]
    items = world.popular(g, rows)
    lengths = _lengths(model["fields"])
    out = world.user_features(users, win, model["user_features"], lengths)
    out.update(world.item_features(items, model["item_features"], lengths))
    out["label"] = (g.random(rows) < world.click_prob(users, items)).astype(np.float32)[:, None]
    return out


def items(world: World, config: dict) -> Dict[str, np.ndarray]:
    """Every item feature of the ranker and the recall, indexed by item id
    (row 0 the padding id)."""
    names = sorted(set(config["ranker"]["item_features"])
                   | {f[0] for f in config["recall"]["item_fields"]})
    lengths = _lengths(config["ranker"]["fields"] + config["recall"]["item_fields"])
    out = world.item_features(np.arange(world.n_news), names, lengths)
    return {n: np.concatenate([np.zeros((1,) + v.shape[1:], v.dtype), v]) for n, v in out.items()}


def user_feature_names(config: dict) -> List[str]:
    return sorted({f[0] for f in config["recall"]["user_fields"]}
                  | set(config["ranker"]["user_features"]))


def requests(world: World, config: dict, seed: int, n: int, users: int) -> Dict[str, np.ndarray]:
    """(n, users[, L]) arrays of each user feature of ``n`` requests: users
    uniform over all, each with a window of its history."""
    g = rng(seed, 3)
    who = g.integers(0, world.n_users, n * users)
    lengths = _lengths(config["recall"]["user_fields"] + config["ranker"]["fields"])
    out = world.user_features(who, world.windows(g, who), user_feature_names(config), lengths)
    return {k: v.reshape(n, users, *v.shape[1:]) for k, v in out.items()}


def body(reqs: Dict[str, np.ndarray], i: int, k: int) -> bytes:
    """The JSON body of ``POST /recommend`` for request ``i``."""
    hist = reqs["hist"][i]
    return json.dumps({"users": {n: v[i].tolist() for n, v in reqs.items()}, "k": k,
                       "histories": [row[row > 0].tolist() for row in hist]}).encode()
