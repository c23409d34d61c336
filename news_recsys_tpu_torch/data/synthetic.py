"""Synthetic MIND-format data generator for tests and benchmarks.

The port's own copy of :mod:`news_recsys_tpu.data.synthetic` (numpy only;
``tests/test_torch_shared.py`` holds its files to the original's on the same
seed).

The real MIND-small dataset must be downloaded by the user (reference
``README.md:25-37``); this module fabricates raw ``news.tsv`` /
``behaviors.tsv`` files with the same schema and statistics shape so the full
pipeline (preprocess -> feature extraction -> training -> validation) can be
exercised end-to-end without the download.

The click model is LEARNABLE with the reference's implicit model ordering
(deep/DCN/FM > LR, ``README.md:91-97`` scoreboard): the click logit is

    bias + a * (u . w) / sqrt(k) + b * [category match] + c * item_bias

where ``u``/``w`` are per-user/per-item latent vectors clustered around
per-category centers. LR (dim-1 embeddings = per-id biases) can only learn
the bias terms; the latent dot product and the user-taste x item-category
cross require feature interactions (FM second order, DCN crosses, deep
MLP). Histories are drawn from the same click model, so user_click_category
and the DSSM history tower carry real signal and ItemCF's co-click
similarity concentrates within taste clusters.

Fully vectorized: MIND-small scale (65k news / 94k users / 220k
impressions, ~2-3M exploded rows) generates in tens of seconds.
"""

from __future__ import annotations

import datetime
from pathlib import Path

import numpy as np

_EPOCH = datetime.datetime(2019, 11, 11, 0, 0, 0)

CATEGORIES = [
    "news", "sports", "finance", "travel", "lifestyle", "video", "foodanddrink",
    "weather", "autos", "health", "entertainment", "tv", "music", "movies",
    "kids", "middleeast", "northamerica",
]
SUBCATS_PER_CAT = 8

LATENT_DIM = 8
# click-logit coefficients. Calibrated (at MIND scale, seed 3) for:
#   - ~7-9% positive rate;
#   - DECISIVE preferences: ~55-60% of positives fall in the user's taste
#     cluster (matched click ~0.75 vs unmatched ~0.03), so retrieval
#     (ItemCF co-click similarity, DSSM two-tower) has recoverable signal —
#     with soft preferences most positives are popularity-lottery wins that
#     NO recall model can rank into a top-50 of 65k items;
#   - oracle dev AUC ~0.85 vs item-bias-only (the LR ceiling) ~0.6, so the
#     reference's implicit model ordering (deep/DCN/FM >> LR) is testable.
L_BIAS = -3.6
L_LATENT = 1.6
L_CATMATCH = 2.2
L_ITEM = 0.45


def generate_mind(
    root: str,
    n_news: int = 300,
    n_users: int = 120,
    n_impressions_train: int = 400,
    n_impressions_dev: int = 150,
    max_history: int = 20,
    max_candidates: int = 8,
    seed: int = 0,
    adversarial: bool = False,
) -> str:
    """Write MINDsmall_{train,dev}/{news.tsv,behaviors.tsv} under ``root``.

    ``adversarial=True`` injects the text quirks the *real* MIND download is
    known to contain, so the pipeline's TSV handling is exercised before the
    first real-data run: titles with embedded double quotes (including
    fields that *start* with a quote — fatal unless readers use
    ``quoting=3``), empty abstracts, apostrophes/commas/backslashes in text,
    news ids duplicated across splits with *differing* fields (dedup must
    keep first appearance), guaranteed empty-history rows, and entity JSON
    with quoted labels.
    """
    rng = np.random.default_rng(seed)
    n_cats = len(CATEGORIES)
    news_ids = np.array([f"N{i + 1}" for i in range(n_news)])
    cats = rng.integers(0, n_cats, n_news)
    subcats = cats * SUBCATS_PER_CAT + rng.integers(0, SUBCATS_PER_CAT, n_news)

    # ---- latent click model -------------------------------------------------
    k = LATENT_DIM
    centers = rng.standard_normal((n_cats, k))
    W = 0.75 * centers[cats] + 0.65 * rng.standard_normal((n_news, k))
    fav_cat = rng.integers(0, n_cats, n_users)
    U = 0.75 * centers[fav_cat] + 0.65 * rng.standard_normal((n_users, k))
    item_bias = rng.standard_normal(n_news)
    # popularity-skewed exposure (what candidates get shown)
    pop = np.exp(1.2 * rng.standard_normal(n_news))

    def click_prob(users: np.ndarray, items: np.ndarray) -> np.ndarray:
        """Vectorized P(click) for parallel (user, item) index arrays."""
        latent = np.einsum("ij,ij->i", U[users], W[items]) / np.sqrt(k)
        match = (cats[items] == fav_cat[users]).astype(np.float64)
        logit = L_BIAS + L_LATENT * latent + L_CATMATCH * match + L_ITEM * item_bias[items]
        return 1.0 / (1.0 + np.exp(-logit))

    # MIND-style entity annotations: a couple of Wikidata ids per item
    n_entities = max(20, n_news // 10)
    ent_count = rng.integers(0, 4, n_news)
    ent_ids = rng.integers(0, n_entities, (n_news, 3))

    def ent_json(i: int) -> str:
        return "[" + ", ".join(
            f'{{"Label": "entity {w}", "Type": "P", "WikidataId": "Q{w}"}}'
            for w in ent_ids[i, : ent_count[i]]
        ) + "]"

    def news_text(i: int, sub: str):
        title, abstract = f"Title of item {i}", f"Abstract text {i}"
        if adversarial:
            m = i % 7
            if m == 0:
                title = f'"Quoted" start title {i}'     # field STARTS with a quote
            elif m == 5:
                # UNBALANCED leading quote: without QUOTE_NONE this swallows
                # tabs+newlines across rows (the fatal real-MIND case)
                title = f'"Unquoted start, never closed {i}'
            elif m == 1:
                title = f'He said "word {i}", then left'
            elif m == 2:
                title = f"It's item {i}, 50% off \\ more"
            elif m == 3:
                abstract = ""                            # real MIND: empty abstracts
            elif m == 4:
                abstract = f'"{i}"'                      # whole field quoted-looking
            # dev copies of shared news differ from the train copies for a
            # slice of items: first-appearance dedup must win
            if sub == "MINDsmall_dev" and i % 11 == 0:
                title = f"DEV-DIVERGED title {i}"
        return title, abstract

    def write_news(sub: str, lo: int, hi: int):
        d = Path(root) / sub
        d.mkdir(parents=True, exist_ok=True)
        with open(d / "news.tsv", "w", encoding="utf-8") as f:
            for i in range(lo, hi):
                title, abstract = news_text(i, sub)
                f.write(
                    f"{news_ids[i]}\t{CATEGORIES[cats[i]]}\tsubcat{subcats[i]}\t"
                    f"{title}\t{abstract}\thttps://example.com/{i}\t{ent_json(i)}\t[]\n"
                )

    # train sees the first 90%, dev all (so dev has some train-unseen news)
    n_train_news = int(n_news * 0.9)
    write_news("MINDsmall_train", 0, n_train_news)
    write_news("MINDsmall_dev", 0, n_news)

    user_ids = np.array([f"U{i + 1}" for i in range(n_users)])

    # ---- per-user click-history pools (drawn from the SAME click model).
    # Exposure is TASTE-BIASED (60% from the user's favorite category, by
    # within-category popularity; 40% global popularity) — real feeds are
    # personalized, and without this the decisive click model leaves ~6
    # clicks per user: too sparse for co-click CF or history towers.
    POOL = max(max_history * 3, 24)
    p_train = pop[:n_train_news] / pop[:n_train_news].sum()
    exposed = rng.choice(n_train_news, size=(n_users, POOL), p=p_train)
    in_taste = rng.random((n_users, POOL)) < 0.6
    for c in range(n_cats):
        items_c = np.flatnonzero(cats[:n_train_news] == c)
        users_c = np.flatnonzero(fav_cat == c)
        if len(items_c) == 0 or len(users_c) == 0:
            continue
        p_c = pop[items_c] / pop[items_c].sum()
        sel = in_taste[users_c]
        block = exposed[users_c]             # fancy indexing copies
        block[sel] = rng.choice(items_c, size=int(sel.sum()), p=p_c)
        exposed[users_c] = block
    u_rep = np.repeat(np.arange(n_users), POOL)
    clicked = rng.random(n_users * POOL) < click_prob(u_rep, exposed.reshape(-1))
    clicked = clicked.reshape(n_users, POOL)
    hist_pool = [exposed[u][clicked[u]][:max_history] for u in range(n_users)]

    def write_behaviors(sub: str, n_impr: int, users_lo: int, users_hi: int, base_min: int):
        d = Path(root) / sub
        d.mkdir(parents=True, exist_ok=True)
        avail = n_train_news if "train" in sub else n_news
        p_avail = pop[:avail] / pop[:avail].sum()

        users = rng.integers(users_lo, users_hi, n_impr)
        n_cand = rng.integers(2, max_candidates + 1, n_impr)
        cands = rng.choice(avail, size=(n_impr, max_candidates), p=p_avail)
        u_flat = np.repeat(users, max_candidates)
        probs = click_prob(u_flat, cands.reshape(-1)).reshape(n_impr, max_candidates)
        labels = rng.random((n_impr, max_candidates)) < probs
        # per-impression history window length (0 allowed: cold rows exist)
        hist_len = rng.integers(0, max_history + 1, n_impr)
        secs = rng.integers(0, 60, n_impr)

        with open(d / "behaviors.tsv", "w", encoding="utf-8") as f:
            for imp in range(n_impr):
                u = users[imp]
                hl = int(hist_len[imp])
                if adversarial and imp % 13 == 0:
                    hl = 0  # guaranteed empty-history rows (NaN field)
                hist = hist_pool[u][:hl]
                hist_str = " ".join(news_ids[h] for h in hist)
                nc = int(n_cand[imp])
                impr_str = " ".join(
                    f"{news_ids[c]}-{int(l)}"
                    for c, l in zip(cands[imp, :nc], labels[imp, :nc])
                )
                dt = _EPOCH + datetime.timedelta(minutes=base_min + imp,
                                                 seconds=int(secs[imp]))
                t = dt.strftime("%m/%d/%Y %I:%M:%S %p")
                f.write(f"{imp + 1}\t{user_ids[u]}\t{t}\t{hist_str}\t{impr_str}\n")

    # train: first 80% of users; dev: all users (tail 20% are cold-start)
    write_behaviors("MINDsmall_train", n_impressions_train, 0, int(n_users * 0.8), 0)
    write_behaviors("MINDsmall_dev", n_impressions_dev, 0, n_users, 10000)
    return root
