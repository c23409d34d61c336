"""A run with its timed path broken underneath comes out not correct: once
for each fault a cell can have (one card: no exchange between cards to
leave out). The runs skip the look for a card and run on the CPU, where the
program's kernels run their plain versions, at a size a test holds."""

import torch
import torch.nn.functional as F

from bench_cells import run_small


def _break_step(monkeypatch, broken):
    from news_recsys_tpu_torch.training import trainer

    make = trainer.Trainer._make_train_step

    def patched(self):
        step = make(self)
        out = broken(step)
        out.flush = step.flush
        return out

    monkeypatch.setattr(trainer.Trainer, "_make_train_step", patched)


def _unchanged(step):
    """A step that returns its state unchanged."""
    def frozen(state, batch, carry):
        with torch.no_grad():
            logits = state.model(batch)
            loss = F.binary_cross_entropy_with_logits(logits, batch["label"][:, 0])
        state.step += 1
        return loss, logits
    return frozen


def _half_batch(step):
    """Half of the batch left out, the mean taken over the rest."""
    def half(state, batch, carry):
        return step(state, {k: v[: len(v) // 2] for k, v in batch.items()}, carry)
    return half


def test_sound_training_runs_are_correct(monkeypatch):
    assert run_small(monkeypatch, "attention.train-b512")["correct"] is True


def test_training_state_left_unchanged_is_not_correct(monkeypatch):
    _break_step(monkeypatch, _unchanged)
    res = run_small(monkeypatch, "attention.train-b512")
    assert res["correct"] is False
    assert res["checks"]["change_gap"]["value"] == 1.0


def _carry_dropped(step):
    """The epoch's AUC carry altered where it is produced: no batch added."""
    def dropped(state, batch, carry):
        return step(state, batch, type(carry).zeros(batch["label"].device))
    return dropped


def test_training_auc_carry_dropped_is_not_correct(monkeypatch):
    _break_step(monkeypatch, _carry_dropped)
    res = run_small(monkeypatch, "attention.train-b512")
    assert res["correct"] is False
    assert res["checks"]["auc_gap"]["value"] > res["checks"]["auc_gap"]["limit"]


def test_training_half_batch_is_not_correct(monkeypatch):
    _break_step(monkeypatch, _half_batch)
    res = run_small(monkeypatch, "attention.train-b512")
    assert res["correct"] is False
    assert res["checks"]["loss_gap"]["value"] > res["checks"]["loss_gap"]["limit"]


def _break_serving(monkeypatch, broken):
    from news_recsys_tpu_torch import serving

    recommend = serving.CascadeRecommender.recommend
    monkeypatch.setattr(serving.CascadeRecommender, "recommend",
                        lambda self, batch, k=10, histories=None:
                        broken(recommend, self, batch, k, histories))


def _altered(recommend, self, batch, k, histories):
    """An answer altered where it is produced: one score a request."""
    ids, scores = recommend(self, batch, k=k, histories=histories)
    scores[0][0] = scores[0][0] * 0.999
    return ids, scores


def _half_users(recommend, self, batch, k, histories):
    """Half of the users left out."""
    n = len(batch["label"]) // 2
    return recommend(self, {f: v[:n] for f, v in batch.items()}, k=k,
                     histories=histories[:n] if histories else histories)


def test_sound_serving_runs_are_correct(monkeypatch):
    assert run_small(monkeypatch, "attention.serve-1024u", seconds=2.0)["correct"] is True


def test_served_answer_altered_is_not_correct(monkeypatch):
    _break_serving(monkeypatch, _altered)
    res = run_small(monkeypatch, "attention.serve-1024u", seconds=2.0)
    assert res["correct"] is False
    assert res["checks"]["score_err"]["value"] > res["checks"]["score_err"]["limit"]


def test_served_half_users_is_not_correct(monkeypatch):
    _break_serving(monkeypatch, _half_users)
    res = run_small(monkeypatch, "attention.serve-1024u", seconds=2.0)
    assert res["correct"] is False
    assert res["checks"]["bad_answers"]["value"] > 0
