"""Listwise training traffic for NRMS: whole epochs of
``Trainer.train_epoch`` on rows of impressions, one trainer.

The rows follow the click law of :mod:`harness.inputs` (``World``, with
the cell's ``params.law``): an impression is a training user, a window of
0 to ``max_history`` of the user's clicks, 2 to ``max_candidates``
candidates by popularity, each clicked by the law. Each clicked candidate
makes one row: its history, the candidate first, then ``npratio``
candidates of the same impression that were not clicked, drawn without
replacement; where the impression has fewer, the rest are drawn by the
law's popularity. Impressions are drawn until ``steps_per_epoch x
batch_size`` rows. The title table (article i + 1's words) is drawn from
the seed: 1 + Binomial(title_len - 1, (mean_words - 1) / (title_len - 1))
words, each a Zipf-distributed id over the vocabulary (id 1 the most
frequent).

Set-up and the window are those of :mod:`traffic.train_epochs`: the first
``check_steps`` steps through ``train_epoch`` (recording each batch, loss,
the first gradient from AdamW's first moment, each leaf's change and each
call's train AUC), warm-up to ``warmup_steps``, then whole epochs until
``--seconds``; ``train_examples_per_s`` counts rows (one row is 1 +
``npratio`` candidates). With ``--trace 1`` the last ``trace_steps`` steps
run under ``torch.profiler``, with the device time of the kernels launched
inside the program's ``train.step.news`` spans (:mod:`harness.launches`).

The run asks the program for its NRMS config first, so a program without
NRMS stops within seconds. After the window the reference
(:mod:`reference.nrms`) trains the same first steps on the same rows from
the same parameters.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

from harness import inputs, judge, launches, program, weights
from reference import nrms as ref
from traffic.train_epochs import _steps, _sync

NEWS_SPAN = "train.step.news"


def world(config: dict, seed: int, law: dict) -> inputs.World:
    m = config["model"]
    tables = {"item_id": [m["articles"], m["word_dim"]], "user_id": [m["users"], 0]}
    return inputs.World({"recall": {"tables": {}}, "ranker": {"tables": tables}}, seed, law)


def titles(config: dict, seed: int) -> np.ndarray:
    """The (articles, title_len) word-id table, row 0 padding."""
    m, t = config["model"], config["titles"]
    g = inputs.rng(seed, 5)
    n, L, V = m["articles"], m["title_len"], m["vocab"]
    low = t["min_words"]
    lengths = low + g.binomial(L - low, (t["mean_words"] - low) / (L - low), n)
    cdf = np.cumsum(1.0 / np.arange(1, V) ** t["zipf_exponent"])
    words = 1 + np.minimum(np.searchsorted(cdf, g.random((n, L)) * cdf[-1], side="right"), V - 2)
    words[np.arange(L)[None, :] >= lengths[:, None]] = 0
    words[0] = 0
    return words.astype(np.int32)


def training_rows(w: inputs.World, config: dict, rows: int, seed: int) -> dict:
    """``rows`` rows: ``hist`` (rows, history_len), ``item_id`` and ``label``
    (rows, 1 + npratio), the clicked candidate first; ``user_id``."""
    g, law, m = inputs.rng(seed, 1), w.law, config["model"]
    K = m["npratio"]
    users, wins, cands = [], [], []
    got = 0
    while got < rows:
        n_imp = max(64, int(1.5 * (rows - got) / (0.1 * (2 + law["max_candidates"]) / 2)))
        n_cand = g.integers(2, law["max_candidates"] + 1, n_imp)
        who = g.integers(0, int(w.n_users * law["train_user_share"]), n_imp)
        win = w.windows(g, who)
        items = w.popular(g, int(n_cand.sum()))
        imp = np.repeat(np.arange(n_imp), n_cand)
        clicked = g.random(len(items)) < w.click_prob(who[imp], items)
        starts = np.concatenate([[0], np.cumsum(n_cand)])
        for i in range(n_imp):
            seg, hit = items[starts[i]:starts[i + 1]], clicked[starts[i]:starts[i + 1]]
            pos, neg = seg[hit], seg[~hit]
            if not len(pos):
                continue
            if len(neg) >= K:
                pick = np.argsort(g.random((len(pos), len(neg))), axis=1)[:, :K]
                negs = neg[pick]
            else:
                extra = w.popular(g, len(pos) * (K - len(neg))).reshape(len(pos), -1)
                negs = np.concatenate([np.broadcast_to(neg, (len(pos), len(neg))), extra], 1)
            cands.append(np.concatenate([pos[:, None], negs], axis=1))
            users.append(np.full(len(pos), who[i]))
            wins.append(np.full(len(pos), win[i]))
            got += len(pos)
    users = np.concatenate(users)[:rows]
    wins = np.concatenate(wins)[:rows]
    out = w.user_features(users, wins, ["hist", "user_id"], {"hist": m["history_len"]})
    out["item_id"] = (np.concatenate(cands)[:rows] + 1).astype(np.int32)
    label = np.zeros((rows, 1 + K), np.float32)
    label[:, 0] = 1.0
    out["label"] = label
    return out


def check_config(cfg, config: dict) -> None:
    """The program's config must state what the configuration file states."""
    n, m, tr = cfg.extra("nrms_cfg") or {}, config["model"], config["train"]
    hp = cfg.train_hparams
    port = {k: n.get(k) for k in ("vocab", "word_dim", "num_heads", "head_dim", "query_dim",
                                  "title_len", "history_len", "npratio", "articles")}
    want = {k: m[k] for k in port}
    recipe = {"batch_size": cfg.dataset.batch_size, "lr": hp.lr, "loss": cfg.extra("loss"),
              "adam": {"b1": hp.b1, "b2": hp.b2, "eps": 1e-8, "weight_decay": hp.weight_decay},
              "dropout": n.get("dropout"), "optimizer": hp.embedding_optimizer,
              "constant_lr": hp.min_lr == hp.lr}
    expect = {"batch_size": tr["batch_size"], "lr": tr["lr"], "loss": tr["loss"],
              "adam": tr["adam"], "dropout": config["dropout"], "optimizer": "adamw",
              "constant_lr": True}
    if port != want or recipe != expect:
        raise ValueError(f"{cfg.name}: the port states {port} {recipe}, the configuration "
                         f"file {want} {expect}")


def load(model, params: dict) -> None:
    """Copy the benchmark's parameters into the program's, by name, all."""
    own = dict(model.named_parameters())
    if set(own) != set(params):
        raise KeyError(f"parameters differ: {sorted(set(own) ^ set(params))}")
    with torch.no_grad():
        for n, p in own.items():
            p.copy_(params[n])


def _check_steps(ctx, trainer, state, ds) -> dict:
    """The first ``check_steps`` steps, through the window's own call."""
    n = ctx.params["check_steps"]
    b1 = trainer.cfg.train_hparams.b1
    losses, batches = [], []
    step = trainer.train_step

    def recording(st, batch, carry):
        batches.append({k: v.detach().cpu().numpy().copy() for k, v in batch.items()})
        loss, logits = step(st, batch, carry)
        losses.append(loss)
        return loss, logits

    recording.__dict__.update(step.__dict__)
    trainer.train_step = recording
    model = trainer.model
    try:
        p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
        aucs = [_steps(trainer, state, ds, 1, 0)["train_auc"]]
        grads = {k: float(torch.linalg.vector_norm(state.opt.state[p]["exp_avg"].double()
                                                   / (1 - b1)))
                 for k, p in model.named_parameters()}
        aucs.append(_steps(trainer, state, ds, n, 0, skip=1)["train_auc"])
        change = {k: float(torch.linalg.vector_norm((p.detach() - p0[k]).double()))
                  for k, p in model.named_parameters()}
    finally:
        trainer.train_step = step
    return {"losses": [float(x) for x in losses], "grad_norms": grads, "change_norms": change,
            "aucs": aucs, "calls": [[0], list(range(1, n))], "batches": batches}


def run(ctx, window: bool = True) -> dict:
    """The cell's run; without ``window`` (the limits' readings) set-up and
    the judgement alone. Returns the readings and what the reference took."""
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.trainer import AUC_BINS, PackedDataset, Trainer

    dev, conf, par = ctx.device, ctx.config, ctx.params
    with ctx.part("config"):
        cfg = program.port_config(conf["program"]["ranker"])
        check_config(cfg, conf)
        if conf["train"]["auc_bins"] != AUC_BINS:
            raise ValueError(f"the port bins the train AUC in {AUC_BINS}")
        cfg = replace(cfg, dataset=replace(cfg.dataset, shuffle_seed=ctx.seed % 2 ** 63))
    if dev.type == "cuda":
        with ctx.part("cuda"):
            w = torch.nn.Parameter(torch.ones(8, 8, device=dev))
            opt = torch.optim.AdamW([w])
            w.grad, = torch.autograd.grad((w @ w).sum(), w)
            opt.step()
            _sync(dev)
    bs, steps = conf["train"]["batch_size"], par["steps_per_epoch"]
    with ctx.part("data"):
        wld = world(conf, ctx.seed, par["law"])
        arrays = training_rows(wld, conf, steps * bs, ctx.seed)
        del wld
        table = titles(conf, ctx.seed)
        ds = PackedDataset(arrays)
    with ctx.part("weights"):
        params = weights.draw(ref.param_specs(conf), ctx.seed, dev)
    workdir = tempfile.mkdtemp(prefix="bench_train_")
    try:
        with ctx.part("trainer"):
            model = build_ranker(cfg, seed=0, device=dev)
            load(model, params)
            model.set_titles(torch.from_numpy(table))
            trainer = Trainer(cfg, model, workdir=workdir, device=dev)
            state = trainer.init_state()
            _sync(dev)
        with ctx.part("check_steps"):
            prog = _check_steps(ctx, trainer, state, ds)
        with ctx.part("warmup"):
            _steps(trainer, state, ds, par["warmup_steps"], 0, skip=par["check_steps"])
            if ctx.trace:
                ctx.spans.wrap(trainer, "train_step", "train_step")
            _sync(dev)
        ctx.setup_done()
        if window:
            _window(ctx, trainer, state, ds, steps * bs)
        ctx.read_memory_peak()
        ctx.spans.unwrap()
        del trainer, state, model
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    recorded = prog.pop("batches")
    prog["feed_rows"] = judge.feed_rows(recorded, arrays, ["hist", "item_id", "user_id"])
    batches = [{n: torch.from_numpy(b[n]).to(dev) for n in ("hist", "item_id", "label")}
               for b in recorded]
    return judged(ctx, prog, params, torch.from_numpy(table).to(dev), batches)


def judged(ctx, prog: dict, params: dict, table: torch.Tensor, batches) -> dict:
    """The reference's first steps on the program's batches, and the numbers
    of ``correct``."""
    ref_out = ref.first_steps(params, ctx.config, table, batches)
    labels = [b["label"].reshape(-1) for b in batches]
    # no rowwise table, so nothing is left out by the accumulator's rule
    train = {"auc_bins": ctx.config["train"]["auc_bins"], "adagrad_init": 0.0}
    out = judge.training(prog, ref_out, labels, train)
    ctx.numbers.update(out["numbers"])
    print(f"judge: worst leaves {out['worst']}; train AUC {out['aucs']}", flush=True)
    return {"prog": prog, "ref": ref_out, "params": params, "batches": batches, "titles": table}


def _window(ctx, trainer, state, ds, rows: int) -> None:
    dev = ctx.device
    half = ctx.seconds / 2 if ctx.trace else ctx.seconds
    epoch, t0 = 1, time.perf_counter()
    while True:
        trainer.train_epoch(state, ds, epoch)
        epoch += 1
        if time.perf_counter() - t0 >= half:
            break
    wall = time.perf_counter() - t0
    rate = (epoch - 1) * rows / wall
    ctx.attempted = (epoch - 1) * ctx.params["steps_per_epoch"]
    ctx.e2e["train_examples_per_s"] = rate
    ctx.untraced.update(examples_per_s=rate, t0=t0, t1=t0 + wall)
    print(f"window: {epoch - 1} epochs of {rows} rows in {wall:.3f} s", flush=True)
    if ctx.trace:
        from harness import trace

        trace.warm_profiler(dev)
        ctx.spans.labelled = True
        upto = trainer.global_step + ctx.params["trace_steps"]
        _, ctx.profile = launches.profiled(lambda: _steps(trainer, state, ds, upto, epoch), dev,
                                           [NEWS_SPAN])
