"""Training traffic: whole epochs of ``Trainer.train_epoch`` on one trainer.

Set-up builds the trainer from the seed's rows and parameters and drives
its first ``check_steps`` steps through ``train_epoch`` (two calls of epoch
0 capped by ``max_step``: the first step, then the rest), recording what
the reference is held to: each step's loss, the rows it trained on (a
wrapper around ``train_step`` copies each batch to the host), the first
gradient as the optimizer took it, each leaf's change, and each call's
train AUC; then warm-up steps up to ``warmup_steps``. The window
runs whole epochs, one ``train_epoch`` call each and at least one, until
``--seconds`` have passed; ``train_examples_per_s`` is their examples over
their wall time, the last call's final sync included.

With ``--trace 1`` the first epochs, until half of ``--seconds`` has passed,
run untraced with a span around each ``train_step`` call; then, after one
short profiler session, ``trace_steps`` steps of one more ``train_epoch``
call run under ``torch.profiler``.

After the window the trainer is freed and the reference trains the same
first steps on the same rows from the same parameters.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

from harness import inputs, judge, program, trace, weights
from reference.model import param_specs
from reference.train_step import first_steps


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _first_grads(trainer, state, cfg, init: float) -> dict:
    """The first gradient's norm of each leaf, from the optimizer's state
    after one step: AdamW's first moment over (1 - b1); a rowwise AdaGrad
    table's accumulator, whose rows add mean(g^2) to ``init``."""
    opt, b1 = state.dense_opt, cfg.train_hparams.b1
    init = float(torch.tensor(init, dtype=torch.float32))     # as the state holds it

    def of(name, p):
        if p in opt.state:
            return opt.state[p]["exp_avg"].double() / (1 - b1)
        acc = state.emb_acc.get(name.removeprefix("embedder.tables."))
        return None if acc is None else ((acc.double() - init) * p.shape[1]).clamp_min(0).sqrt()

    return {n: float(torch.linalg.vector_norm(t))
            for n, t in program.leaves(trainer.model, cfg, of=of).items()}


def run(ctx, window: bool = True) -> dict:
    """The cell's run; without ``window`` (the limits' readings) set-up and
    the judgement alone. Returns the readings and what the reference took."""
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.trainer import PackedDataset, Trainer

    dev, cfg_file, par = ctx.device, ctx.config, ctx.params
    model_spec, train = cfg_file["ranker"], cfg_file["train"]
    if dev.type == "cuda":
        ctx.setup.update(program.start(dev))
    with ctx.part("config"):
        cfg = program.port_config(cfg_file["program"]["ranker"])
        program.check_config(cfg, model_spec, train)
        cfg = replace(cfg, dataset=replace(cfg.dataset, shuffle_seed=ctx.seed % 2 ** 63))
    bs, steps = train["batch_size"], par["steps_per_epoch"]
    with ctx.part("data"):
        world = inputs.World(cfg_file, ctx.seed, par["law"])
        arrays = inputs.training_rows(world, model_spec, steps * bs, ctx.seed)
        del world
        ds = PackedDataset(arrays)
    with ctx.part("weights"):
        params = weights.draw(param_specs(model_spec), ctx.seed, dev)
    workdir = tempfile.mkdtemp(prefix="bench_train_")
    try:
        with ctx.part("trainer"):
            model = build_ranker(cfg, seed=0, device=dev)
            program.load(model, cfg, params)
            trainer = Trainer(cfg, model, workdir=workdir, device=dev)
            state = trainer.init_state()
            _sync(dev)
        with ctx.part("check_steps"):
            prog = _check_steps(ctx, trainer, state, ds, cfg, train["adagrad_init"])
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
    names = [f[0] for f in model_spec["fields"]]
    prog["feed_rows"] = judge.feed_rows(prog.pop("batches"), arrays, names)
    batches = [{n: torch.from_numpy(b[n]).to(dev) for n in names}
               | {"label": torch.from_numpy(b["label"]).to(dev)} for b in prog["ref_batches"]]
    ref = first_steps(params, cfg_file, batches)
    out = judge.training(prog, ref, [b["label"] for b in batches], train)
    ctx.numbers.update(out["numbers"])
    print(f"judge: worst leaves {out['worst']}; train AUC {out['aucs']}; left out "
          f"{out['left_out']}", flush=True)
    return {"prog": prog, "ref": ref, "params": params, "batches": batches}


def _steps(trainer, state, ds, upto: int, epoch: int, skip: int = 0) -> dict:
    """``train_epoch`` of ``epoch`` from batch ``skip`` up to global step
    ``upto``; returns its metrics."""
    cfg = trainer.cfg
    trainer.cfg = replace(cfg, train_hparams=replace(cfg.train_hparams, max_step=upto))
    try:
        return trainer.train_epoch(state, ds, epoch, skip_steps=skip)[1]
    finally:
        trainer.cfg = cfg


def _check_steps(ctx, trainer, state, ds, cfg, init: float) -> dict:
    """The first ``check_steps`` steps, through the window's own call."""
    n = ctx.params["check_steps"]
    losses, batches = [], []
    step = trainer.train_step

    def recording(st, batch, carry):
        batches.append({k: v.detach().cpu().numpy().copy() for k, v in batch.items()})
        loss, logits = step(st, batch, carry)
        losses.append(loss)
        return loss, logits

    recording.__dict__.update(step.__dict__)
    trainer.train_step = recording
    try:
        p0 = {k: v.clone() for k, v in program.leaves(trainer.model, cfg).items()}
        aucs = [_steps(trainer, state, ds, 1, 0)["train_auc"]]
        grads = _first_grads(trainer, state, cfg, init)
        aucs.append(_steps(trainer, state, ds, n, 0, skip=1)["train_auc"])
        p_n = program.leaves(trainer.model, cfg)
        change = {k: float(torch.linalg.vector_norm((p_n[k] - p0[k]).double())) for k in p0}
    finally:
        trainer.train_step = step
    ref_batches = [{k: v for k, v in b.items() if k != "_valid"} for b in batches]
    for b in ref_batches:
        b["label"] = b["label"][:, 0].astype(np.float32)
    return {"losses": [float(x) for x in losses], "grad_norms": grads, "change_norms": change,
            "aucs": aucs, "calls": [[0], list(range(1, n))], "batches": batches,
            "ref_batches": ref_batches}


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
        trace.warm_profiler(dev)
        ctx.spans.labelled = True
        upto = trainer.global_step + ctx.params["trace_steps"]
        _, ctx.profile = trace.profiled(lambda: _steps(trainer, state, ds, upto, epoch), dev)
