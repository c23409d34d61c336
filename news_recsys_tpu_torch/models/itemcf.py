"""Item-based collaborative filtering baseline (non-neural), array-native.

The port's own copy of :mod:`news_recsys_tpu.models.itemcf` (numpy only;
``tests/test_torch_shared.py`` holds it to the original), except that
:func:`interactions_from_behaviors` takes numpy columns where the original
takes a pandas DataFrame.

Capability parity with ``src/model/recall/ItemCF/itemCF_base.py``
(MovieLens-era), re-targeted to MIND interactions and fully vectorized:

- cosine-style similarity ``co(i,j) / sqrt(n_i * n_j)`` from user->item
  co-occurrence (``itemCF_base.py:18-40``);
- candidate scoring by summed similarity to the user's history, history
  dedup, top-k (``:43-58``); HitRate@k eval (``:61-74``).

Unlike the reference's dict-of-dict similarity built with nested Python
loops, the similarity table here is built by chunked pair-key counting
(``np.unique`` over ``i * I + j`` keys, bounded by ``pair_chunk`` pairs in
flight) and stored CSR-style with per-item top-``max_neighbors`` pruning,
so it runs on full MIND-scale behaviors (millions of exploded rows) in
minutes with bounded memory.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from ..utils.logging import get_logger

logger = get_logger("itemcf")


class ItemCF:
    """CSR-backed item-item similarity with bounded-memory fitting.

    Parameters
    ----------
    max_history: per-user interaction cap when counting co-occurrence
        (keeps the most recent ``max_history`` interactions).
    max_neighbors: per-item similarity-row prune (top-N by weight).
    pair_chunk: max ordered pairs materialized at once during fit.
    """

    def __init__(self, max_history: int = 200, max_neighbors: int = 200,
                 pair_chunk: int = 4_000_000):
        self.max_history = max_history
        self.max_neighbors = max_neighbors
        self.pair_chunk = pair_chunk
        # CSR over compact item indices; populated by fit.
        self._item_ids = np.zeros(0, np.int64)   # compact idx -> original id
        self._indptr = np.zeros(1, np.int64)
        self._nbr = np.zeros(0, np.int64)        # neighbor compact idx
        self._wgt = np.zeros(0, np.float32)
        self.item_count: Dict[int, int] = {}

    # ------------------------------------------------------------------ fit

    def fit(self, user_items: Dict[int, Sequence[int]]) -> "ItemCF":
        """Build the similarity table from user -> interacted-item lists."""
        uids, items = [], []
        for u, its in user_items.items():
            for it in its:
                uids.append(int(u))
                items.append(int(it))
        return self.fit_pairs(np.asarray(uids, np.int64),
                              np.asarray(items, np.int64))

    def fit_pairs(self, uids: np.ndarray, items: np.ndarray) -> "ItemCF":
        """Vectorized fit from flat (user, item) interaction arrays.

        Interactions should be in time order per user; only the most recent
        ``max_history`` *distinct* items per user enter co-occurrence.
        """
        uids = np.asarray(uids, np.int64)
        items = np.asarray(items, np.int64)
        if uids.size == 0:
            self._item_ids = np.zeros(0, np.int64)
            self._indptr = np.zeros(1, np.int64)
            self._nbr = np.zeros(0, np.int64)
            self._wgt = np.zeros(0, np.float32)
            self.item_count = {}
            return self

        # Dedup (user, item) keeping the LAST occurrence (most recent), then
        # cap each user's list to the most recent max_history items.
        # Stable-sort by user; within a user keep original (time) order.
        order = np.argsort(uids, kind="stable")
        u_s, it_s = uids[order], items[order]
        # last-occurrence dedup per (user,item): mark duplicates scanning
        # from the end. Key on (user,item) pairs via lexsort.
        pair_order = np.lexsort((it_s, u_s))
        pu, pi = u_s[pair_order], it_s[pair_order]
        first_of_run = np.ones(pu.size, bool)
        first_of_run[1:] = (pu[1:] != pu[:-1]) | (pi[1:] != pi[:-1])
        # within each (u,i) run, keep the entry with the greatest time index
        run_id = np.cumsum(first_of_run) - 1
        # position (in time order) within the user = pair_order itself; take
        # max pair_order per run = the last (most recent) occurrence:
        max_pos = np.zeros(run_id[-1] + 1, np.int64)
        np.maximum.at(max_pos, run_id, pair_order)
        keep_idx = max_pos  # indices into (u_s, it_s) of kept entries
        u_d, it_d = u_s[keep_idx], it_s[keep_idx]
        t_d = keep_idx  # time rank within the sorted-by-user layout
        # re-sort kept entries by (user, time)
        o2 = np.lexsort((t_d, u_d))
        u_d, it_d = u_d[o2], it_d[o2]

        # cap: keep the LAST max_history entries of each user segment
        seg_start = np.flatnonzero(np.r_[True, u_d[1:] != u_d[:-1]])
        seg_end = np.r_[seg_start[1:], u_d.size]
        h = seg_end - seg_start
        pos_in_seg = np.arange(u_d.size) - np.repeat(seg_start, h)
        keep = pos_in_seg >= np.repeat(h - self.max_history, h)
        u_d, it_d = u_d[keep], it_d[keep]
        seg_start = np.flatnonzero(np.r_[True, u_d[1:] != u_d[:-1]])
        seg_end = np.r_[seg_start[1:], u_d.size]
        h = seg_end - seg_start

        # compact item index space
        self._item_ids, it_c = np.unique(it_d, return_inverse=True)
        n_items = self._item_ids.size
        cnt = np.bincount(it_c, minlength=n_items).astype(np.int64)
        self.item_count = dict(zip(self._item_ids.tolist(), cnt.tolist()))

        # chunked ordered-pair counting: for each user segment of length h,
        # all h*(h-1) ordered (i,j) pairs; key = i * n_items + j.
        tot = h * h
        chunks_k: List[np.ndarray] = []
        chunks_c: List[np.ndarray] = []
        u_lo = 0
        n_seg = h.size
        while u_lo < n_seg:
            u_hi = u_lo
            budget = 0
            while u_hi < n_seg and (budget + tot[u_hi] <= self.pair_chunk or u_hi == u_lo):
                budget += tot[u_hi]
                u_hi += 1
            hs = h[u_lo:u_hi]
            if budget == 0 or hs.max(initial=0) < 2:
                u_lo = u_hi
                continue
            starts = seg_start[u_lo:u_hi]
            ts = tot[u_lo:u_hi]
            pair_off = np.r_[0, np.cumsum(ts)[:-1]]
            g = np.arange(int(ts.sum()))
            u_of = np.repeat(np.arange(hs.size), ts)
            local = g - pair_off[u_of]
            hh = hs[u_of]
            ii = it_c[starts[u_of] + local // hh]
            jj = it_c[starts[u_of] + local % hh]
            m = ii != jj
            keys, counts = np.unique(ii[m] * n_items + jj[m], return_counts=True)
            chunks_k.append(keys)
            chunks_c.append(counts)
            u_lo = u_hi

        if not chunks_k:
            self._indptr = np.zeros(n_items + 1, np.int64)
            self._nbr = np.zeros(0, np.int64)
            self._wgt = np.zeros(0, np.float32)
            return self

        all_k = np.concatenate(chunks_k)
        all_c = np.concatenate(chunks_c)
        uk = np.unique(all_k)
        co = np.zeros(uk.size, np.int64)
        np.add.at(co, np.searchsorted(uk, all_k), all_c)

        i_idx = uk // n_items
        j_idx = uk % n_items
        w = (co / np.sqrt(cnt[i_idx] * cnt[j_idx])).astype(np.float32)

        # top-max_neighbors prune per source item: sort by (i, -w) and keep
        # the first max_neighbors of each i-run.
        o3 = np.lexsort((-w, i_idx))
        i_o, j_o, w_o = i_idx[o3], j_idx[o3], w[o3]
        row_start = np.flatnonzero(np.r_[True, i_o[1:] != i_o[:-1]])
        row_len = np.diff(np.r_[row_start, i_o.size])
        rank = np.arange(i_o.size) - np.repeat(row_start, row_len)
        keep = rank < self.max_neighbors
        i_o, j_o, w_o = i_o[keep], j_o[keep], w_o[keep]
        self._nbr = j_o
        self._wgt = w_o
        self._indptr = np.zeros(n_items + 1, np.int64)
        np.add.at(self._indptr, i_o + 1, 1)
        self._indptr = np.cumsum(self._indptr)

        logger.info(f"ItemCF: {n_items} items, {self._nbr.size} similarity "
                    f"entries (pruned to <= {self.max_neighbors}/item)")
        return self

    # --------------------------------------------------------------- recall

    def _ids_to_idx(self, ids: np.ndarray) -> np.ndarray:
        """Map original item ids to compact indices, dropping unknowns."""
        ids = np.asarray(ids, np.int64)
        if self._item_ids.size == 0 or ids.size == 0:
            return np.zeros(0, np.int64)
        pos = np.searchsorted(self._item_ids, ids)
        pos = np.clip(pos, 0, self._item_ids.size - 1)
        ok = self._item_ids[pos] == ids
        return pos[ok]

    def recall(self, history: Sequence[int], k: int = 10) -> List[int]:
        """Top-k items by summed similarity to history (history excluded)."""
        out = self.recall_batch([list(history)], k)[0]
        return [int(x) for x in out if x >= 0]

    def recall_batch(self, histories: Sequence[Sequence[int]], k: int = 10) -> np.ndarray:
        """Batched recall: (Q, k) array of item ids, -1-padded.

        Per query the work is pure vectorized numpy (gather neighbor CSR
        slices, scatter-add into a reusable dense score buffer, masked
        argpartition); only the outer loop is Python.
        """
        n_items = self._item_ids.size
        out = np.full((len(histories), k), -1, np.int64)
        if n_items == 0:
            return out
        buf = np.zeros(n_items, np.float32)
        for q, hist in enumerate(histories):
            hidx = self._ids_to_idx(np.asarray(list(hist), np.int64))
            if hidx.size == 0:
                continue
            lens = self._indptr[hidx + 1] - self._indptr[hidx]
            total = int(lens.sum())
            if total == 0:
                continue
            # gather all neighbor slices: starts repeated + within-run offset
            g = np.arange(total)
            off = np.r_[0, np.cumsum(lens)[:-1]]
            src = np.repeat(self._indptr[hidx], lens) + (g - np.repeat(off, lens))
            cand = self._nbr[src]
            np.add.at(buf, cand, self._wgt[src])
            buf[hidx] = 0.0  # history dedup
            uniq = np.unique(cand)
            uniq = uniq[buf[uniq] > 0]
            if uniq.size:
                kk = min(k, uniq.size)
                top = uniq[np.argpartition(-buf[uniq], kk - 1)[:kk]]
                top = top[np.argsort(-buf[top], kind="stable")]
                out[q, :kk] = self._item_ids[top]
            buf[cand] = 0.0  # reset touched entries only
        return out

    def hit_rate(self, test_cases: Iterable[Tuple[Sequence[int], int]], k: int = 10) -> float:
        """test_cases: (history, target_item) pairs."""
        cases = list(test_cases)
        if not cases:
            return 0.0
        topk = self.recall_batch([h for h, _ in cases], k)
        targets = np.asarray([t for _, t in cases], np.int64)
        return float((topk == targets[:, None]).any(axis=1).mean())


def interactions_from_behaviors(history, user_id, item_id, label
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Flat (user_ids, item_ids) interaction arrays from the columns of an
    exploded behaviors file (history clicks + positive impressions, time
    order): ``history`` the space-separated click strings ("" or None for
    none), ``user_id``, ``item_id`` and ``label`` one value a row.

    Vectorized: per user takes the longest ``history`` string (histories are
    cumulative in MIND, so the longest is the most complete), tokenizes all
    of them with a single join+split, and appends positive impressions in
    row order via a groupby-free sort. The arrays equal the original's from
    the same rows as a DataFrame.
    """
    hv = np.asarray(["" if h is None else str(h) for h in history], dtype=str)
    hlen = np.where(hv == "", 0, np.char.count(hv, " ") + 1)
    uid = np.asarray(user_id, np.int64)

    # longest-history row per user
    o = np.lexsort((hlen, uid))
    u_o = uid[o]
    last = np.r_[u_o[1:] != u_o[:-1], True]
    sel = o[last]                      # row index of longest history per user
    sel_u = uid[sel]
    sel_h = hv[sel]
    nonempty = sel_h != ""
    tok_counts = np.where(nonempty, np.char.count(sel_h, " ") + 1, 0)
    if nonempty.any():
        tokens = np.array(" ".join(sel_h[nonempty]).split(), np.int64)
    else:
        tokens = np.zeros(0, np.int64)
    hist_u = np.repeat(sel_u, tok_counts)

    # positive impressions, in time (row) order per user
    pos = np.asarray(label) == 1
    pos_u = uid[pos]
    pos_i = np.asarray(item_id, np.int64)[pos]
    po = np.argsort(pos_u, kind="stable")

    # history first, then positives (fit keeps the most recent on cap)
    out_u = np.concatenate([hist_u, pos_u[po]])
    out_i = np.concatenate([tokens, pos_i[po]])
    o2 = np.argsort(out_u, kind="stable")
    return out_u[o2], out_i[o2]
