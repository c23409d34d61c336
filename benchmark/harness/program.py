"""The program under test, ``news_recsys_tpu_torch``, built through its
public entries: its config constructors (``zoo``), ``build_ranker``,
``build_dssm``, ``training.trainer.Trainer`` and ``serving``.

The benchmark's parameters go into the port's modules by name: a table
packed in an arena (``config.arena_layout``) takes each member's rows at its
offset, every other parameter its own tensor whole. :func:`leaves` reads the
program's tables back by logical table, to judge them.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Dict

import torch


def start(device) -> Dict[str, float]:
    """Load (the first run in a checkout: build) the kernel library on a
    thread while CUDA and PyTorch's first optimizer and autograd calls start
    on this one; returns the seconds of each part."""
    t0 = time.perf_counter()
    from news_recsys_tpu_torch.ops import _build

    built = []
    thread = threading.Thread(target=lambda: built.append(_build.build()))
    thread.start()
    w = torch.nn.Parameter(torch.ones(8, 8, device=device))
    opt = torch.optim.AdamW([w])
    w.grad, = torch.autograd.grad((w @ w).sum(), w)
    opt.step()
    torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    thread.join()
    if not built:
        raise RuntimeError("the kernel library did not build (nvcc's report is above)")
    _build.library()
    return {"import_and_cuda_s": t1 - t0, "kernel_library_s": time.perf_counter() - t1}


def port_config(ctor):
    from news_recsys_tpu_torch import zoo

    fn, *args = ctor
    return getattr(zoo, fn)(*args)


def check_config(cfg, model: dict, train: dict = None) -> None:
    """The port's config must state what the configuration file states: every
    logical table's size and width, and the training recipe."""
    emb = cfg.embeddings
    for table, (vocab, dim) in model["tables"].items():
        got = (int(emb.embedding_table_size[table]), int(emb.embedding_size[table]))
        if got != (vocab, dim):
            raise ValueError(f"{cfg.name}: table {table} is {got} in the port, "
                             f"{(vocab, dim)} in the configuration file")
    if train is None:
        return
    from news_recsys_tpu_torch.training.sparse_step import ADAGRAD_INIT_ACC
    from news_recsys_tpu_torch.training.trainer import AUC_BINS

    hp = cfg.train_hparams
    port = {"batch_size": cfg.dataset.batch_size, "lr": hp.lr, "auc_bins": AUC_BINS,
            "adagrad_init": ADAGRAD_INIT_ACC,
            "lr_hold_steps": hp.lr_milestones[0],
            "adamw": {"b1": hp.b1, "b2": hp.b2, "eps": 1e-8, "weight_decay": hp.weight_decay}}
    if hp.embedding_optimizer != "rowwise_adagrad" or any(
            train[k] != v for k, v in port.items()):
        raise ValueError(f"{cfg.name}: the port trains {hp.embedding_optimizer} with {port}, "
                         f"the configuration file {train}")


def _table_slices(module, cfg, prefix: str) -> Dict[str, tuple]:
    """{benchmark parameter name: (port parameter, row slice, rows of the
    benchmark's tensor)} of every table."""
    from news_recsys_tpu_torch.config import arena_layout

    arena = arena_layout(cfg)
    params = dict(module.named_parameters())
    out = {}
    for table, vocab in cfg.embeddings.embedding_table_size.items():
        vocab = int(vocab)
        if table in arena:
            name, off, _ = arena[table]
            out[f"{prefix}tables.{table}"] = (params[f"embedder.tables.{name}"],
                                              slice(off + 1, off + vocab), slice(1, vocab))
        elif f"embedder.tables.{table}" in params:
            out[f"{prefix}tables.{table}"] = (params[f"embedder.tables.{table}"],
                                              slice(0, vocab), slice(0, vocab))
    return out


def load(module, cfg, params: Dict[str, torch.Tensor], prefix: str = "") -> None:
    """Copy the benchmark's ``params`` (each name ``prefix`` + the port's)
    into the port's ``module``; every parameter of either side must be
    matched."""
    tables = _table_slices(module, cfg, prefix)
    matched, done = set(tables), set()
    with torch.no_grad():
        for name, (p, rows, src) in tables.items():
            if rows.start == 1:
                p[0] = 0.0
            p[rows] = params[name][src]
            done.add(id(p))
        for name, p in module.named_parameters():
            if id(p) in done:
                continue
            key = prefix + name
            if key not in params or params[key].shape != p.shape:
                raise KeyError(f"no benchmark parameter {key} {tuple(p.shape)}")
            p.copy_(params[key])
            matched.add(key)
    extra = set(params) - matched
    if extra:
        raise KeyError(f"benchmark parameters the port lacks: {sorted(extra)}")


def leaves(module, cfg, prefix: str = "", of=None) -> Dict[str, torch.Tensor]:
    """The port's parameters by benchmark name, tables cut to their logical
    rows (each arena member apart); with ``of(port name, parameter)``, the
    tensor it returns in each parameter's place (a (V,) accumulator or a
    moment of the parameter's shape), leaves where it returns None left
    out."""
    of = of or (lambda name, p: p.detach())
    members = defaultdict(list)
    for name, (p, rows, _) in _table_slices(module, cfg, prefix).items():
        members[id(p)].append((name, rows))
    out = {}
    for n, p in module.named_parameters():
        t = of(n, p)
        if t is not None:
            for name, rows in members.get(id(p), [(prefix + n, slice(None))]):
                out[name] = t[rows]
    return out
