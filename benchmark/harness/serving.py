"""What a serving driver needs: the cascade built from the seed, its HTTP
server, the load generator's process and the judgement of the answers.

The cascade is the port's ``serving.CascadeRecommender`` over its
``Recommender`` (DSSM recall, corpus encoded at set-up), both built by
``build_dssm`` / ``build_ranker`` and given the benchmark's parameters,
served by ``serving.serve_http`` on a thread of this process. The load
generator (:mod:`harness.http_client`) runs in a child process.

With ``--trace 1`` the window's first part runs untraced with spans around
``Recommender.recommend`` and ``CascadeRecommender.recommend``; its last
``trace_seconds`` (at most half of it), after one short profiler session,
run under ``torch.profiler``.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from . import inputs, judge, program, trace, weights
from .spec import BENCH_DIR

GRACE_S = 60.0


def build(ctx):
    """(the port's cascade, the benchmark's parameters, item arrays)."""
    from news_recsys_tpu_torch.models.dssm import build_dssm
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.serving import CascadeRecommender, PackedDataset, Recommender
    from reference.model import param_specs

    dev, c = ctx.device, ctx.config
    with ctx.part("config"):
        rcfg = program.port_config(c["program"]["ranker"])
        dcfg = program.port_config(c["program"]["recall"])
        program.check_config(rcfg, c["ranker"])
        program.check_config(dcfg, c["recall"])
    with ctx.part("data"):
        items = inputs.items(inputs.World(c, ctx.seed, ctx.params["law"]), c)
        table = {n: v[1:] for n, v in items.items()}
        table["label"] = np.zeros((len(table["item_id"]), 1), np.float32)
    with ctx.part("weights"):
        params = weights.draw(param_specs(c["ranker"]) + param_specs(c["recall"], "recall."),
                              ctx.seed, dev)
    with ctx.part("cascade"):
        dssm = build_dssm(dcfg, seed=0, device=dev)
        program.load(dssm, dcfg, {n[7:]: v for n, v in params.items()
                                  if n.startswith("recall.")})
        ranker = build_ranker(rcfg, seed=0, device=dev)
        program.load(ranker, rcfg, {n: v for n, v in params.items()
                                    if not n.startswith("recall.")})
        recall = Recommender(dcfg, dssm, PackedDataset(table), device=dev)
        casc = CascadeRecommender(recall, rcfg, ranker, PackedDataset(table),
                                  fetch=c["serve"]["fetch"])
    return casc, params, items


class Load:
    """The server on a thread and the load generator's process."""

    def __init__(self, ctx, casc, save: list):
        from news_recsys_tpu_torch.serving import serve_http

        self.server = serve_http(casc, host="127.0.0.1", port=0)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        par = ctx.params
        self.dir = tempfile.mkdtemp(prefix="bench_serve_")
        spec = {"host": "127.0.0.1", "port": self.server.server_address[1],
                "config": ctx.config, "law": par["law"], "seed": ctx.seed, "users": par["users"],
                "k": ctx.config["serve"]["k"], "seconds": ctx.seconds,
                "warmup": par["warmup_requests"], "requests": par["closed_requests"],
                "grace": GRACE_S, "save": save, "out": os.path.join(self.dir, "records.json")}
        path = os.path.join(self.dir, "spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        self.out = spec["out"]
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(BENCH_DIR, "harness", "http_client.py"), path],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def expect(self, word: str, timeout: float) -> None:
        box = []
        reader = threading.Thread(target=lambda: box.append(self.proc.stdout.readline()))
        reader.start()
        reader.join(timeout)
        if not box or box[0].split()[:1] != [word]:
            raise RuntimeError(f"the load generator said {box} where {word} was due "
                               f"(exit code {self.proc.poll()})")

    def go(self) -> float:
        t0 = time.perf_counter() + 0.05
        self.proc.stdin.write(f"GO {t0!r}\n")
        self.proc.stdin.flush()
        return t0

    def results(self) -> dict:
        with open(self.out) as f:
            return json.load(f)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=60)
        for name in os.listdir(self.dir):
            os.remove(os.path.join(self.dir, name))
        os.rmdir(self.dir)


def run(ctx) -> dict:
    """Set-up, the window and the judgement of one serving cell; returns the
    window's records."""
    dev, par = ctx.device, ctx.params
    if dev.type == "cuda":
        ctx.setup.update(program.start(dev))
    casc, params, items = build(ctx)
    sample = _sample(ctx)
    load = None
    try:
        with ctx.part("server_and_warmup"):
            if ctx.trace:
                ctx.spans.wrap(casc.recall, "recommend", "recall")
                ctx.spans.wrap(casc, "recommend", "cascade")
            load = Load(ctx, casc, sample)
            load.expect("WARM", 900)
        ctx.setup_done()
        t0 = load.go()
        split = t0 + (max(ctx.seconds / 2, ctx.seconds - par["trace_seconds"]) if ctx.trace
                      else ctx.seconds)
        if ctx.trace:
            time.sleep(max(0.0, split - time.perf_counter()))
            trace.warm_profiler(dev)
            ctx.spans.labelled = True
            _, ctx.profile = trace.profiled(
                lambda: time.sleep(max(0.0, t0 + ctx.seconds - time.perf_counter())), dev,
                ctx.spans)
        load.expect("DONE", ctx.seconds + GRACE_S + 120)
        ctx.read_memory_peak()
        records = load.results()
    finally:
        ctx.spans.unwrap()
        if load is not None:
            load.close()
    ctx.untraced.update(t0=t0, t1=split)
    del casc, load                                  # the server's handler holds the cascade
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    _judge(ctx, records, sample, params, items)
    return records


def _sample(ctx) -> list:
    """The requests whose answers are judged: ``sample_requests`` of the
    first ``closed_sample_from``, drawn from the seed."""
    par = ctx.params
    pool = par["closed_sample_from"]
    g = inputs.rng(ctx.seed, 5)
    return sorted(int(i) for i in g.choice(pool, min(pool, par["sample_requests"]),
                                           replace=False))


def generator_health(records: dict) -> None:
    ok = sum(r[3] == 200 for r in records["records"])
    print(f"generator: sent {len(records['records'])}, succeeded {ok}, failed "
          f"{len(records['records']) - ok}", file=sys.stderr, flush=True)


def sampled_users(ctx, sample: list) -> tuple:
    """The users of the sampled requests, as the generator sent them:
    ({feature: (R * users, ...) tensor on the device}, (R * users, L) clicked ids)."""
    c, par = ctx.config, ctx.params
    n = par["closed_requests"]
    reqs = inputs.requests(inputs.World(c, ctx.seed, par["law"]), c, ctx.seed,
                           n + par["warmup_requests"], par["users"])
    rows = [i % n for i in sample]
    feats = {f: torch.from_numpy(v[rows].reshape(len(rows) * par["users"], *v.shape[2:]))
             .to(ctx.device) for f, v in reqs.items()}
    return feats, reqs["hist"][rows].reshape(len(rows) * par["users"], -1)


def reference(ctx, params: dict, items: dict, feats: dict, served: np.ndarray) -> dict:
    """The reference cascade's answer for ``feats``, with the logits of the
    ``served`` (N, k) ids (id 0 where a list was short)."""
    from reference.cascade import corpus, serve

    item_t = {f: torch.from_numpy(v).to(ctx.device) for f, v in items.items()}
    with torch.no_grad():
        emb = corpus(params, ctx.config["recall"], item_t)
        return serve(params, ctx.config, feats, item_t, emb,
                     extra=torch.from_numpy(np.clip(served, 0, None)).to(ctx.device))


def _judge(ctx, records: dict, sample: list, params: dict, items: dict) -> None:
    users, k = ctx.params["users"], ctx.config["serve"]["k"]
    ids = np.full((len(sample), users, k), -1, np.int64)
    scores = np.zeros((len(sample), users, k))
    missing = 0
    for j, i in enumerate(sample):
        reply = records["saved"].get(str(i))
        if reply is None:
            missing += 1
            continue
        ans = json.loads(reply)
        for u, (row, sc) in enumerate(zip(ans["ids"], ans["scores"])):
            ids[j, u, :len(row[:k])] = row[:k]
            scores[j, u, :len(sc[:k])] = sc[:k]
    feats, hist = sampled_users(ctx, sample)
    flat = ids.reshape(-1, k)
    ref = reference(ctx, params, items, feats, flat)
    nums = judge.serving(flat, scores.reshape(-1, k), hist, ref, len(items["item_id"]) - 1)
    failed = sum(r[3] != 200 for r in records["records"])
    ctx.numbers.update(nums, missing=failed + missing)
