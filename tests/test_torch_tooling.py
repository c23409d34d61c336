"""The port's tooling on the CPU against the JAX package's: checkpoint
layout conversion (``arena_convert``, ``convert-ckpt``), ``log`` and
``visualize-history``.

- ``convert_checkpoint_dict`` on a state converted from JAX
  (``news_recsys_tpu_torch.convert``) gives, converted back, JAX's
  ``convert_tree`` of the same state bit for bit: the rows move, nothing is
  computed.
- A converted checkpoint predicts as its source (rtol/atol 1e-6) and trains
  on as the target layout does (predictions within rtol 1e-5 / atol 1e-6
  after an epoch), the tolerances of JAX's tests/test_arena_convert.py.
- ``log`` prints JAX's report character for character, and
  ``visualize-history`` writes JAX's page byte for byte, tied impression
  times included (both sort with numpy's quicksort on this machine).
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from news_recsys_tpu import config as jconfig
from news_recsys_tpu.cli import main as jax_cli
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu.training.arena_convert import convert_tree as jconvert_tree
from news_recsys_tpu.training.trainer import Trainer as JTrainer
from news_recsys_tpu.utils.visualize_history import generate_html_report as jgenerate_html
from news_recsys_tpu_torch import config as tconfig
from news_recsys_tpu_torch.cli import main as cli
from news_recsys_tpu_torch.convert import (dense_state_from_jax, dense_state_to_jax,
                                           flatten_dense_state, flatten_sparse_state,
                                           sparse_state_from_jax, sparse_state_to_jax)
from news_recsys_tpu_torch.data.packed_dataset import PackedDataset
from news_recsys_tpu_torch.data.synthetic import generate_mind
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.training import arena_convert
from news_recsys_tpu_torch.training.checkpoint import load_state, load_state_dict, state_dict
from news_recsys_tpu_torch.training.metrics import format_validation_block
from news_recsys_tpu_torch.training.retrieval import format_retrieval_block
from news_recsys_tpu_torch.training.trainer import Trainer

torch.set_num_threads(2)
FEATS = ["user_id", "item_id", "category"]
VOCABS = {"user_id": 5000, "item_id": 4300, "category": 20}
OPTIMIZERS = ["rowwise_adagrad", "sparse_adamw", "adamw"]


def raw_cfg(arena: bool, optimizer: str = "rowwise_adagrad") -> dict:
    """tests/test_arena.py's config: two large tables (5,000 and 4,300 ids)
    that pack into ``arena_d16``, ``category`` on AdamW."""
    return {
        "name": "deep",
        "features": {"sparse_feature_names": FEATS,
                     "item_feature_names": ["item_id", "category"],
                     "user_feature_names": ["user_id"]},
        "embeddings": {"embedding_size": {k: 16 for k in FEATS},
                       "embedding_table_size": dict(VOCABS), "arena_tables": arena},
        "dataset": {"batch_size": 64},
        "train_hparams": {"max_epoch": 3, "lr": 5e-3, "min_lr": 1e-3,
                          "lr_milestones": [200, 600], "max_step": 100000,
                          "embedding_optimizer": optimizer},
    }


def arrays(n: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    users = rng.integers(1, VOCABS["user_id"], n).astype(np.int32)
    items = rng.integers(1, VOCABS["item_id"], n).astype(np.int32)
    labels = (((users % 2) == (items % 2)) ^ (rng.random(n) < 0.1)).astype(np.float32)
    return {"user_id": users, "item_id": items, "category": (items % 19 + 1).astype(np.int32),
            "label": labels.reshape(-1, 1)}


def to_jax_dict(state):
    return (dense_state_to_jax if hasattr(state, "opt") else sparse_state_to_jax)(state)


def from_jax(jstate, cfg):
    model = build_ranker(cfg, "deep", device="cpu")
    if cfg.train_hparams.embedding_optimizer == "adamw":
        return dense_state_from_jax(jstate, model, cfg)
    return sparse_state_from_jax(jstate, model, cfg)


def flat_jax(jstate, optimizer):
    return (flatten_dense_state if optimizer == "adamw" else flatten_sparse_state)(jstate)


def assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


@pytest.mark.parametrize("to_arena", [True, False])
@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_conversion_matches_jax_convert_tree(monkeypatch, tmp_path, optimizer, to_arena):
    """A JAX state after an epoch (8 steps) in the source layout; JAX's
    ``convert_tree`` of it, restored into a target-layout JAX state; the
    port's ``convert_checkpoint_dict`` of the same state taken through
    ``convert.py``: equal bit for bit, every parameter, moment,
    accumulator and count."""
    monkeypatch.setenv("NRT_PALLAS", "")
    src_raw, dst_raw = raw_cfg(not to_arena, optimizer), raw_cfg(to_arena, optimizer)
    jsrc, jdst = jconfig.config_from_dict(src_raw), jconfig.config_from_dict(dst_raw)
    tsrc, tdst = tconfig.config_from_dict(src_raw), tconfig.config_from_dict(dst_raw)
    from news_recsys_tpu.data.packed_dataset import PackedDataset as JPacked
    ds = JPacked(arrays(512, seed=1))
    jt = JTrainer(jsrc, jbuild_ranker(jsrc, "deep"), workdir=str(tmp_path / "src"),
                  use_mesh=False)
    jstate = jax.device_get(jt.fit(ds, max_epochs=1))
    arena_cfg = jdst if to_arena else jsrc
    tree = jconvert_tree(arena_cfg, serialization.to_state_dict(jstate), to_arena)
    jt_dst = JTrainer(jdst, jbuild_ranker(jdst, "deep"), workdir=str(tmp_path / "dst"),
                      use_mesh=False)
    template = jax.device_get(jt_dst.init_state(ds.take(np.arange(64))))
    want = flat_jax(serialization.from_state_dict(template, tree), optimizer)

    blob = arena_convert.convert_checkpoint_dict(tsrc, state_dict(from_jax(jstate, tsrc)),
                                                 to_arena)
    target = Trainer(tdst, build_ranker(tdst, "deep", device="cpu"), workdir=str(tmp_path / "t"),
                     device="cpu").init_state()
    got = to_jax_dict(load_state_dict(target, blob))
    assert_trees_equal(got, want)


def train_port(raw: dict, workdir, epochs: int = 2):
    cfg = tconfig.config_from_dict(raw)
    t = Trainer(cfg, build_ranker(cfg, "deep", seed=3, device="cpu"), workdir=str(workdir),
                device="cpu")
    ds = PackedDataset(arrays(512, seed=5))
    return t, t.fit(ds, max_epochs=epochs), ds


def write_yaml(path, raw: dict) -> str:
    path.write_text(yaml.safe_dump(raw))
    return str(path)


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_convert_ckpt_round_trip(tmp_path, optimizer):
    """``convert-ckpt --to arena`` then ``--to per-table``: every tensor of
    the checkpoint back as it was, the tables on their addressable rows (the
    rows above a table's vocab are never read; the arena keeps one table's)."""
    t, state, ds = train_port(raw_cfg(False, optimizer), tmp_path / "off")
    src = t.save_checkpoint(state, 1)
    cfg_path = write_yaml(tmp_path / "cfg.yaml", raw_cfg(True, optimizer))
    arena, back = str(tmp_path / "arena.pt"), str(tmp_path / "back.pt")
    cli(["convert-ckpt", "-c", cfg_path, "--input", src, "--output", arena, "--to", "arena"])
    cli(["convert-ckpt", "-c", cfg_path, "--input", arena, "--output", back,
         "--to", "per-table"])
    assert "embedder.tables.arena_d16" in load_state(arena)["model"]
    got, want = load_state(back), load_state(src)

    def rows(name: str, x: torch.Tensor) -> torch.Tensor:
        table = name.rsplit(".", 1)[-1]
        return x[:VOCABS[table]] if table in VOCABS and x.dim() and x.shape[0] > 128 else x

    def compare(g, w, path):
        if isinstance(w, dict):
            assert sorted(g, key=str) == sorted(w, key=str), path
            for k in w:
                compare(g[k], w[k], f"{path}.{k}")
        elif isinstance(w, list):
            assert len(g) == len(w), path
            for i, (a, b) in enumerate(zip(g, w)):
                compare(a, b, f"{path}.{i}")
        elif isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(rows(path, g), rows(path, w)), path
        else:
            assert g == w, path

    compare(got, want, "")


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_converted_checkpoint_predicts_and_trains_on(tmp_path, optimizer):
    """JAX's tests/test_arena_convert.py on the port: a per-table run's
    checkpoint converted to the arena predicts as the per-table model does,
    and an epoch more on each predicts alike."""
    t_off, s_off, ds = train_port(raw_cfg(False, optimizer), tmp_path / "off")
    src = t_off.save_checkpoint(s_off, 1)
    cfg_on = tconfig.config_from_dict(raw_cfg(True, optimizer))
    conv = arena_convert.convert_checkpoint(cfg_on, src, str(tmp_path / "conv.pt"), True)
    t_on = Trainer(cfg_on, build_ranker(cfg_on, "deep", device="cpu"), workdir=str(tmp_path / "on"),
                   device="cpu")
    s_on = t_on.load_checkpoint(t_on.init_state(), conv)
    assert t_on.global_step == t_off.global_step == s_on.step
    np.testing.assert_allclose(t_on.predict(ds), t_off.predict(ds), rtol=1e-6, atol=1e-6)
    s_off, _ = t_off.train_epoch(s_off, ds, epoch=2)
    s_on, _ = t_on.train_epoch(s_on, ds, epoch=2)
    np.testing.assert_allclose(t_on.predict(ds), t_off.predict(ds), rtol=1e-5, atol=1e-6)


def test_bf16_tables_stay_bf16(tmp_path):
    """A bfloat16 arena splits into bfloat16 tables (and back) row for row."""
    raw = raw_cfg(True)
    raw["mesh"] = {"param_dtype": "bfloat16"}
    cfg = tconfig.config_from_dict(raw)
    t = Trainer(cfg, build_ranker(cfg, "deep", seed=4, device="cpu"), workdir=str(tmp_path),
                device="cpu")
    blob = state_dict(t.init_state())
    split = arena_convert.convert_checkpoint_dict(cfg, blob, to_arena=False)
    for name in ("user_id", "item_id"):
        assert split["model"][f"embedder.tables.{name}"].dtype == torch.bfloat16
    back = arena_convert.convert_checkpoint_dict(cfg, split, to_arena=True)
    a, b = back["model"]["embedder.tables.arena_d16"], blob["model"]["embedder.tables.arena_d16"]
    n = VOCABS["user_id"] + VOCABS["item_id"] - 1
    assert a.dtype == torch.bfloat16 and torch.equal(a[:n], b[:n])


def test_convert_ckpt_refuses_msgpack(tmp_path):
    cfg_path = write_yaml(tmp_path / "cfg.yaml", raw_cfg(True))
    with pytest.raises(SystemExit, match="export_torch_checkpoint.py"):
        cli(["convert-ckpt", "-c", cfg_path, "--input", str(tmp_path / "epoch_000.msgpack"),
             "--output", str(tmp_path / "o.pt"), "--to", "per-table"])


# -- log -----------------------------------------------------------------------

def ranking_results(rng) -> dict:
    def cohort(count=None):
        out = {k: float(rng.random()) for k in ("AUC", "LogLoss", "GAUC", "NDCG@10", "HR@10",
                                                 "MRR@10")}
        return out if count is None else {**out, "User_Count": count}
    return {"Overall": cohort(), "Warm_Start": cohort(int(rng.integers(1, 500))),
            "Cold_Start": cohort(int(rng.integers(0, 500)))}


def write_val_log(path, blocks) -> None:
    with open(path, "w") as f:
        f.write("".join(blocks))


@pytest.mark.parametrize("kind", ["ranking", "retrieval", "empty"])
def test_log_prints_what_jax_prints(tmp_path, monkeypatch, capsys, kind):
    """``log`` of a file, of an experiment dir and of a model name (the
    newest ``experiments/<model>_20*``), against the JAX command."""
    rng = np.random.default_rng(3)
    exp = tmp_path / "experiments" / "dcn_20261017-120000"
    exp.mkdir(parents=True)
    (tmp_path / "experiments" / "dcn_20261016-120000").mkdir()
    if kind == "ranking":
        blocks = [format_validation_block(ranking_results(rng), e) for e in range(3)]
    elif kind == "retrieval":
        blocks = [format_retrieval_block({"HR@10": float(rng.random()), "HR@50": 0.5,
                                          "num_queries": 120}, e) for e in range(2)]
    else:
        blocks = []
    write_val_log(exp / "val_log.log", blocks)
    (tmp_path / "experiments" / "dcn_20261016-120000" / "val_log.log").write_text("")
    monkeypatch.chdir(tmp_path)
    for target in (str(exp / "val_log.log"), str(exp), "dcn", "nothing"):
        cli(["log", target])
        got = capsys.readouterr().out
        jax_cli(["log", target])
        assert got == capsys.readouterr().out, target


# -- visualize-history ---------------------------------------------------------

@pytest.fixture(scope="module")
def raw_mind(tmp_path_factory):
    """The port's adversarial synth (quotes, empty abstracts, empty
    histories), whose dev impressions are then given 5 distinct times, so
    that most times are tied."""
    out = tmp_path_factory.mktemp("mind")
    generate_mind(str(out), n_news=120, n_users=50, n_impressions_train=200,
                  n_impressions_dev=150, seed=4, adversarial=True)
    path = out / "MINDsmall_dev" / "behaviors.tsv"
    times = ["11/15/2019 8:00:00 AM", "11/15/2019 9:30:12 PM", "11/14/2019 12:00:00 PM",
             "11/15/2019 8:00:00 AM", "11/13/2019 1:02:03 AM"]
    lines = path.read_text().splitlines()
    tied = []
    for i, line in enumerate(lines):
        f = line.split("\t")
        f[2] = times[i % len(times)]
        tied.append("\t".join(f))
    path.write_text("\n".join(tied) + "\n")
    return out


@pytest.mark.parametrize("split,max_users", [("MINDsmall_train", 200), ("MINDsmall_dev", 200),
                                             ("MINDsmall_dev", 7)])
def test_visualize_history_writes_jax_page(raw_mind, tmp_path, split, max_users):
    news, beh = (str(raw_mind / split / f) for f in ("news.tsv", "behaviors.tsv"))
    want, got = str(tmp_path / "jax.html"), str(tmp_path / "port.html")
    jgenerate_html(news, beh, want, max_users)
    cli(["visualize-history", "--news", news, "--behaviors", beh, "--output", got,
         "--max-users", str(max_users)])
    with open(want, "rb") as a, open(got, "rb") as b:
        assert b.read() == a.read()


def test_visualize_history_keeps_pandas_missing_values(tmp_path):
    """A missing title and an NA string read as ``nan``, a missing history
    as none, an impression with no label gives no candidate; equal to JAX."""
    news = tmp_path / "news.tsv"
    news.write_text("N1\tsports\tsoccer\t\tabs\turl\t[]\t[]\n"
                    "N2\tNA\tnews\tA <b>title</b> & more\t\t\t\t\n"
                    "N3\tnews\tnews\tnull\tx\ty\t[]\t[]\n")
    beh = tmp_path / "behaviors.tsv"
    beh.write_text("1\tU1\t11/15/2019 8:00:00 AM\t\tN1-1 N2-0\n"
                   "2\tU2\t11/15/2019 7:00:00 AM\tN1 N3 N9\tN3-1 N4\n"
                   "3\tU1\t11/15/2019 8:00:00 AM\tN2\tNA\n")
    want, got = str(tmp_path / "jax.html"), str(tmp_path / "port.html")
    jgenerate_html(str(news), str(beh), want)
    cli(["visualize-history", "--news", str(news), "--behaviors", str(beh), "--output", got])
    with open(want, "rb") as a, open(got, "rb") as b:
        assert b.read() == a.read()
    assert open(got).read().count('class="user"') == 2
