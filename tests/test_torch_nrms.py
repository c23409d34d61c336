"""NRMS in the port (``models/nrms.py`` on the all-dense step's listwise
loss, through ``Trainer``) against the plain reference
(``tests/nrms_reference.py``) on seeded weights, at a small size on the
CPU: logits, loss, every parameter's gradient, three Adam steps through
``Trainer.train_epoch``; the masking cases; one-candidate scoring through
``Trainer.predict``. Imports nothing of the JAX package.

Tolerances. The port and the reference compute the same float32 sums in
other orders: one (in, 3 heads head_dim) product against a product a head,
``einsum`` against a broadcast sum, a soft-label cross-entropy against
``F.cross_entropy``. Each sum of K float32 terms then differs by about
K x 2^-24 of its scale: here under 1e-7 relative. So logits and the loss
are held to 2e-6 of their scale. A gradient is held to 2e-5 of the larger
of its leaf's largest element and the median leaf's (the benchmark's
``grad_gap`` floors a leaf so too): a leaf whose gradient cancels, such as
an additive pooling's bias, whose terms sum to nearly 0 since the softmax
ignores a shift, keeps only its terms' rounding, up to 1e-3 of its own
size (measured). Three Adam steps are held by each leaf's change, to 1e-2
of the larger of its norm and the median leaf's: Adam divides by
sqrt(v), so a cancelling leaf's direction carries that 1e-3 into its step
(2.3e-3 measured). The same comparisons in bfloat16 (2^-8 a rounding) miss
every one of these (``test_the_tolerances_reject_bfloat16``).
"""

import statistics

import numpy as np
import pytest
import torch

import nrms_reference as ref
from news_recsys_tpu_torch import zoo
from news_recsys_tpu_torch.config import config_from_dict, config_to_dict
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.training.dense_step import loss_fn
from news_recsys_tpu_torch.training.trainer import PackedDataset, Trainer

torch.set_num_threads(2)

DIMS = dict(articles=60, title_len=12, vocab=200, word_dim=24, num_heads=4, head_dim=4,
            query_dim=10)
HEADS, HD = DIMS["num_heads"], DIMS["head_dim"]
H, C, B = 10, 5, 16
LOGIT_TOL = 2e-6
GRAD_TOL = 2e-5
CHANGE_TOL = 1e-2


def small_cfg(batch_size: int = B):
    raw = config_to_dict(zoo.mind_nrms_config(batch_size=batch_size))
    raw["nrms_cfg"].update(DIMS, history_len=H)
    return config_from_dict(raw)


def title_table(seed: int = 0) -> np.ndarray:
    """Titles of 0 to ``title_len`` words (some empty), row 0 padding."""
    rng = np.random.default_rng(seed)
    L = DIMS["title_len"]
    words = rng.integers(1, DIMS["vocab"], (DIMS["articles"], L))
    n = rng.integers(0, L + 1, DIMS["articles"])
    n[1] = 0                                   # article 1 has an empty title
    n[2] = 1                                   # article 2 has one word
    words[np.arange(L)[None, :] >= n[:, None]] = 0
    words[0] = 0
    return words.astype(np.int32)


def rows(n: int, seed: int = 0, c: int = C) -> dict:
    """Training rows: histories of 0 to H articles (row 0 empty), ``c``
    candidates, the positive first."""
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, DIMS["articles"], (n, H))
    k = rng.integers(0, H + 1, n)
    k[0] = 0
    hist[np.arange(H)[None, :] >= k[:, None]] = 0
    label = np.zeros((n, c), np.float32)
    label[:, 0] = 1.0
    return {"hist": hist.astype(np.int32),
            "item_id": rng.integers(1, DIMS["articles"], (n, c)).astype(np.int32),
            "label": label, "user_id": np.arange(1, n + 1, dtype=np.int32)}


def model(seed: int = 3, titles_seed: int = 0, cfg=None):
    cfg = cfg or small_cfg()
    m = build_ranker(cfg, seed=seed, device="cpu")
    m.set_titles(title_table(titles_seed))
    return cfg, m


def params_of(m) -> dict:
    return {n: p.detach().clone() for n, p in m.named_parameters()}


def tensors(arrays: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def ref_logits(p, m, batch):
    return ref.logits(p, m.titles, batch["hist"], batch["item_id"], HEADS, HD)


def close(got, want, tol):
    """|got - want| <= tol x (1 + |want|'s largest element)."""
    return float((got - want).abs().max()) <= tol * (1.0 + float(want.abs().max()))


def leaf_gaps(got: dict, want: dict, size) -> dict:
    """Each leaf's ``size(got - want)`` over the larger of ``size(want)`` and
    the median leaf's."""
    sizes = {n: float(size(w)) for n, w in want.items()}
    floor = statistics.median(sizes.values())
    return {n: float(size(got[n].float() - want[n])) / max(sizes[n], floor) for n in want}


def largest(t):
    return t.abs().max()


def ref_grads(p, m, batch) -> dict:
    pr = {n: t.clone().requires_grad_() for n, t in p.items()}
    value = ref.loss(ref_logits(pr, m, batch).float(), batch["label"])
    return dict(zip(pr, torch.autograd.grad(value, list(pr.values()))))


def test_parameters_and_widths():
    cfg = zoo.mind_nrms_config()
    m = build_ranker(cfg, seed=0, device="cpu")
    shapes = {n: tuple(p.shape) for n, p in m.named_parameters()}
    assert shapes == {"news.words": (40000, 300), "news.attn.wqkv": (300, 768),
                      "news.pool.w": (256, 200), "news.pool.b": (200,), "news.pool.q": (200,),
                      "user.attn.wqkv": (256, 768), "user.pool.w": (256, 200),
                      "user.pool.b": (200,), "user.pool.q": (200,)}
    assert sum(p.numel() for p in m.parameters()) == 12_530_208
    assert tuple(m.titles.shape) == (65239, 30) and m.titles.dtype == torch.int32
    assert float(m.news.words.detach()[0].abs().max()) == 0.0
    assert cfg.train_hparams.embedding_optimizer == "adamw"
    assert cfg.train_hparams.weight_decay == 0.0 and cfg.dataset.batch_size == 64


def test_dropout_is_refused():
    raw = config_to_dict(small_cfg())
    raw["nrms_cfg"]["dropout"] = 0.2
    with pytest.raises(ValueError, match="without dropout"):
        build_ranker(config_from_dict(raw), device="cpu")


def test_forward_loss_and_gradients_match_the_reference():
    cfg, m = model()
    p = params_of(m)
    batch = tensors(rows(B, seed=1))
    loss, logits, _, _ = loss_fn(m, batch, kind="listwise")
    loss.backward()
    got = {n: q.grad for n, q in m.named_parameters()}
    want_logits = ref_logits(p, m, batch)
    want_loss = ref.loss(want_logits, batch["label"])
    want = ref_grads(p, m, batch)
    assert logits.shape == (B, C)
    assert close(logits.detach(), want_logits, LOGIT_TOL)
    assert abs(float(loss.detach()) - float(want_loss)) <= LOGIT_TOL * abs(float(want_loss))
    assert set(got) == set(want) and all(float(largest(w)) > 0 for w in want.values())
    gaps = leaf_gaps(got, want, largest)
    assert max(gaps.values()) <= GRAD_TOL, gaps


def test_the_tolerances_reject_bfloat16():
    """The same comparisons with the reference in bfloat16 fail, each."""
    cfg, m = model()
    p = params_of(m)
    low = {n: t.bfloat16() for n, t in p.items()}
    batch = tensors(rows(B, seed=1))
    want, got = ref_logits(p, m, batch), ref_logits(low, m, batch).float()
    assert not close(got, want, LOGIT_TOL)
    exact = float(ref.loss(want, batch["label"]))
    assert abs(float(ref.loss(got, batch["label"])) - exact) > LOGIT_TOL * exact
    gaps = leaf_gaps(ref_grads(low, m, batch), ref_grads(p, m, batch), largest)
    assert min(gaps.values()) > 10 * GRAD_TOL, gaps
    batches = [tensors(rows(B, seed=20 + i)) for i in range(3)]
    steps = {name: ref.adam_steps(q, m.titles, batches, HEADS, HD, lr=1e-4)["params"]
             for name, q in (("float32", p), ("bfloat16", low))}
    gaps = leaf_gaps({n: t.float() - p[n] for n, t in steps["bfloat16"].items()},
                     {n: t - p[n] for n, t in steps["float32"].items()}, torch.linalg.vector_norm)
    assert min(gaps.values()) > 10 * CHANGE_TOL, gaps


def test_three_adam_steps_through_train_epoch_match_the_reference(tmp_path):
    cfg, m = model(seed=5, titles_seed=2)
    p0 = params_of(m)
    t = Trainer(cfg, m, workdir=str(tmp_path), device="cpu")
    state = t.init_state()
    seen = []
    step = t.train_step

    def recording(st, batch, carry):
        seen.append({k: v.clone() for k, v in batch.items()})
        return step(st, batch, carry)

    t.train_step = recording
    _, metrics = t.train_epoch(state, PackedDataset(rows(3 * B, seed=4)), 0)
    assert metrics["steps"] == 3 and len(seen) == 3
    out = ref.adam_steps(p0, m.titles, seen, HEADS, HD, lr=cfg.train_hparams.lr,
                         b1=cfg.train_hparams.b1, b2=cfg.train_hparams.b2)
    assert abs(metrics["train_loss"] - out["losses"][-1]) <= LOGIT_TOL * out["losses"][-1]
    gaps = leaf_gaps({n: q.detach() - p0[n] for n, q in m.named_parameters()},
                     {n: t - p0[n] for n, t in out["params"].items()}, torch.linalg.vector_norm)
    assert max(gaps.values()) <= CHANGE_TOL, gaps
    # the AUC carry took every candidate of every row: 3 x B x C entries
    assert 0.0 < metrics["train_auc"] < 1.0


def test_an_empty_history_scores_zero_and_has_finite_gradients():
    cfg, m = model()
    batch = tensors(rows(4, seed=6))
    batch["hist"][0] = 0
    loss, logits, _, _ = loss_fn(m, batch, kind="listwise")
    loss.backward()
    assert torch.equal(logits[0].detach(), torch.zeros(C))
    assert all(torch.isfinite(q.grad).all() for q in m.parameters())
    assert close(logits.detach(), ref_logits(params_of(m), m, batch), LOGIT_TOL)


def test_a_one_word_title_is_its_value_projection():
    """One word attends to itself alone and pools with weight 1:
    ``r = e_w V`` (the heads' value columns)."""
    cfg, m = model()
    words = m.titles[2:3]
    assert int((words != 0).sum()) == 1
    w = int(words[words != 0])
    width = HEADS * HD
    with torch.no_grad():
        got = m.news(words)
        want = m.news.words[w] @ m.news.attn.wqkv[:, 2 * width:]
        torch.testing.assert_close(got[0], want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        torch.testing.assert_close(got, ref.news_vectors(params_of(m), words, HEADS, HD),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_padding_slots_and_empty_titles_change_nothing():
    """Padding history slots, wherever they sit, change no score; an article
    with an empty title scores 0 as a candidate and adds a zero vector to a
    history."""
    cfg, m = model()
    batch = tensors(rows(8, seed=7))
    with torch.no_grad():
        base = m(batch)
        wide = dict(batch, hist=torch.cat([torch.zeros(8, 3, dtype=torch.int32), batch["hist"],
                                           torch.zeros(8, 4, dtype=torch.int32)], dim=1))
        torch.testing.assert_close(m(wide), base, rtol=LOGIT_TOL, atol=LOGIT_TOL)
        empty = dict(batch, item_id=batch["item_id"].clone())
        empty["item_id"][:, 2] = 1                       # article 1: no word
        assert torch.equal(m(empty)[:, 2], torch.zeros(8))
        assert float(m.news(m.titles[1:2]).abs().max()) == 0.0
        assert close(m(empty), ref_logits(params_of(m), m, empty), LOGIT_TOL)


def test_predict_scores_one_candidate_a_row(tmp_path):
    """``Trainer.predict`` on (user, article) rows (``item_id`` (N,)) gives
    the sigmoid of the reference's score of that one candidate."""
    cfg, m = model(seed=8)
    arrays = rows(3 * B + 5, seed=9, c=1)
    arrays["item_id"] = arrays["item_id"][:, 0].copy()
    arrays["label"] = (np.arange(len(arrays["hist"])) % 3 == 0).astype(np.float32)[:, None]
    t = Trainer(cfg, m, workdir=str(tmp_path), device="cpu")
    got = t.predict(PackedDataset(arrays))
    batch = tensors(arrays)
    want = torch.sigmoid(ref.logits(params_of(m), m.titles, batch["hist"],
                                    batch["item_id"][:, None], HEADS, HD)[:, 0])
    assert got.shape == (3 * B + 5,)
    torch.testing.assert_close(torch.from_numpy(got), want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    results = t.validate(t.init_state(), PackedDataset(arrays), 0)
    assert 0.0 <= results["Overall"]["AUC"] <= 1.0


def test_checkpoint_carries_the_title_table(tmp_path):
    cfg, m = model(seed=2)
    t = Trainer(cfg, m, workdir=str(tmp_path), device="cpu")
    state = t.init_state()
    t.train_epoch(state, PackedDataset(rows(2 * B, seed=3)), 0)
    path = t.save_checkpoint(state, 0)
    cfg2, m2 = model(seed=9, titles_seed=5)
    t2 = Trainer(cfg2, m2, workdir=str(tmp_path / "b"), device="cpu")
    state2 = t2.load_checkpoint(t2.init_state(), path)
    assert torch.equal(m2.titles, m.titles) and state2.step == 2
    for (n, a), (_, b) in zip(m.named_parameters(), m2.named_parameters()):
        assert torch.equal(a, b), n
    info = open(tmp_path / "model_info.log").read()
    assert "params/news/attn/wqkv" in info and "titles" not in info


NEWS_TSV = ("N1\tnews\tworld\tStocks rally, markets cheer!\tabs\turl\t[]\t[]\n"
            "N2\tsports\tsoccer\tThe U.S. team wins; fans cheer\tabs\turl\t[]\t[]\n")


def test_mind_titles_become_the_word_table(tmp_path):
    """Recommenders' tokenisation (``[\\w]+|[.,!?;|]``, lowercased), ids in
    first-appearance order over the training titles, rows by item id, 0
    past the title and for a word outside the vocabulary."""
    from news_recsys_tpu_torch.data import titles as T

    train = tmp_path / "news.tsv"
    train.write_text(NEWS_TSV)
    dev = tmp_path / "dev_news.tsv"
    dev.write_text("N3\tnews\tworld\tMarkets fall? Stocks cheer\tabs\turl\t[]\t[]\n")
    assert T.tokenize("The U.S. team wins; fans cheer") == \
        ["the", "u", ".", "s", ".", "team", "wins", ";", "fans", "cheer"]
    table, vocab = T.mind_title_table(str(train), [str(train), str(dev)],
                                      {"N1": 2, "N2": 1, "N3": 3}, title_len=8)
    assert list(vocab) == ["stocks", "rally", ",", "markets", "cheer", "!", "the", "u", ".",
                           "s", "team", "wins", ";", "fans"]
    assert vocab["stocks"] == 1 and vocab["fans"] == 14
    assert table.shape == (4, 8) and table.dtype == np.int32
    assert table[0].tolist() == [0] * 8
    assert table[2].tolist() == [1, 2, 3, 4, 5, 6, 0, 0]
    assert table[1].tolist() == [7, 8, 9, 10, 9, 11, 12, 13]            # cut at 8 tokens
    assert table[3].tolist() == [4, 0, 0, 1, 5, 0, 0, 0]                # "fall", "?" unknown
