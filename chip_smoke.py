"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Drives the port's serving path once at the full width of the repo's MIND
models, from seeded random weights, and fails (non-zero exit, no result
line) if any phase fails:

1. needs CUDA; prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``news_recsys_tpu_torch/csrc`` (nvcc, sm_90a);
3. holds each kernel against its plain PyTorch version on the card at the
   serving path's shapes, and times both (device time from CUDA graph
   replays, and wall time per call with host overhead);
4. builds the recall -> rank cascade (DSSM of configs/dssm.yaml, DCN of
   zoo.mind_config("dcn"), 65,238 items, fetch 100) on the card, saves it
   as a bundle, loads it back and serves it over HTTP on a thread; sends
   requests of 64 users with histories (k=10) and checks every answer;
5. loads the same bundle on the CPU (plain PyTorch ops) and checks that it
   agrees with the card's answers;
6. checks that the requests launched both kernels.

Its last three lines are the card, a JSON line of the kernels and their
times, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

SEED = 0
USERS_PER_REQUEST = 64
REQUESTS = 8                  # timed, after one warm-up request
K = 10
FETCH = 100
# kernel vs plain on the card: float32 with another summation order; the
# cross stack's values grow over three layers, hence its looser atol
DCN_TOL = dict(rtol=1e-5, atol=1e-4)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
# card vs CPU answers: sigmoid scores and user embeddings
ANSWER_TOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def call_ms(fn, rounds: int = 21, inner: int = 20) -> float:
    """Wall time per call, host overhead included: median over ``rounds``
    of ``inner`` back-to-back calls timed with CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def device_ms(fn, rounds: int = 21, inner: int = 20) -> float:
    """Device time per call: ``inner`` calls captured in one CUDA graph and
    replayed, so no host work sits between the launches; median over
    ``rounds`` replays. Inputs stay in L2 from one call to the next."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def check_kernels(dev) -> list:
    from news_recsys_tpu_torch.ops.dcn_kernel import cross_plain, dcn_cross_stack
    from news_recsys_tpu_torch.ops.fused_lookup_pool import (fused_lookup_pool,
                                                             reference_lookup_pool)
    rng = np.random.default_rng(SEED)
    B, D, NL = USERS_PER_REQUEST * FETCH, 112, 3
    bound = np.sqrt(6 / (D + 1))
    x0 = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
    ws = torch.from_numpy(rng.uniform(-bound, bound, (NL, D)).astype(np.float32)).to(dev)
    bs = torch.from_numpy(0.1 * rng.standard_normal((NL, D), np.float32)).to(dev)

    V, Dp, Bp, L = 65280, 16, 1024, 30
    table = rng.standard_normal((V, Dp), np.float32)
    table[0] = 0
    ids = rng.integers(1, 65239, (Bp, L)).astype(np.int32)
    lengths = rng.integers(0, L + 1, Bp)
    lengths[:4] = (0, 1, L, L)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    ids[mask == 0] = 0
    ids[3, ::3] = 0                      # padding inside an unmasked row
    table, ids, mask = (torch.from_numpy(a).to(dev) for a in (table, ids, mask))

    cases = [
        ("dcn_cross_stack", "news_recsys_tpu_torch/csrc/dcn_cross.cu",
         "news_recsys_tpu/ops/dcn_kernel.py:51", dcn_cross_stack, cross_plain,
         (x0, ws, bs), DCN_TOL, f"B={B} D={D} NL={NL}"),
        ("fused_lookup_pool", "news_recsys_tpu_torch/csrc/lookup_pool.cu",
         "news_recsys_tpu/ops/fused_lookup_pool.py:71", fused_lookup_pool,
         reference_lookup_pool, (table, ids, mask), POOL_TOL,
         f"V={V} D={Dp} B={Bp} L={L}"),
    ]
    out = []
    with torch.inference_mode():
        for name, source, replaces, kernel, plain, args, tol, shape in cases:
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            torch.testing.assert_close(got, want, **tol)
            # plain, kernel, kernel, plain: the two orders average out drift
            t = [device_ms(lambda: f(*args)) for f in (plain, kernel, kernel, plain)]
            ms, plain_ms = (t[1] + t[2]) / 2, (t[0] + t[3]) / 2
            calls = [call_ms(lambda: f(*args)) for f in (kernel, plain)]
            log(f"kernel {name} [{shape}]: max_abs_err {err:.3e} (tol {tol}); device time "
                f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; per call with "
                f"host overhead kernel {calls[0] * 1e3:.2f} us, plain {calls[1] * 1e3:.2f} us")
            out.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": 0, "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms,
                        "call_ms": calls[0], "plain_call_ms": calls[1]})
    return out


def make_requests(n_requests: int) -> list:
    from news_recsys_tpu_torch.zoo import DSSM_HIST_LEN, MIND_TABLE_SIZE
    rng = np.random.default_rng(SEED + 1)
    reqs = []
    for _ in range(n_requests):
        n, L = USERS_PER_REQUEST, DSSM_HIST_LEN
        hist = rng.integers(1, MIND_TABLE_SIZE["item_id"], (n, L))
        lengths = rng.integers(0, L + 1, n)
        hist[np.arange(L)[None, :] >= lengths[:, None]] = 0
        users = {"user_id": rng.integers(1, MIND_TABLE_SIZE["user_id"], n).tolist(),
                 "user_click_category":
                     rng.integers(1, MIND_TABLE_SIZE["user_click_category"], n).tolist(),
                 "hist": hist.tolist()}
        histories = [[int(i) for i in row if i] for row in hist]
        reqs.append({"users": users, "k": K, "histories": histories})
    return reqs


def post(url: str, body: dict) -> dict:
    req = urllib.request.Request(url + "/recommend", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def check_answer(answer: dict, req: dict, n_items: int) -> None:
    ids, scores = answer["ids"], answer["scores"]
    assert len(ids) == len(scores) == USERS_PER_REQUEST, len(ids)
    for row_ids, row_scores, hist in zip(ids, scores, req["histories"]):
        assert len(row_ids) == K == len(set(row_ids)), row_ids
        assert not set(row_ids) & set(hist), "served an item from the history"
        assert all(1 <= i <= n_items for i in row_ids), row_ids
        assert np.isfinite(row_scores).all() and all(0 < s < 1 for s in row_scores)
        assert all(a >= b for a, b in zip(row_scores, row_scores[1:])), row_scores


def ranker_scores(casc, batch, ids: list) -> np.ndarray:
    """Sigmoid ranker scores of (user row r, ids[r][j]) pairs on ``casc``'s device."""
    rows = torch.as_tensor(casc._pos[np.asarray(ids).reshape(-1)], device=casc.device)
    k = len(ids[0])
    feats = {n: torch.as_tensor(batch[n], device=casc.device).repeat_interleave(k, dim=0)
             for n in casc.user_feature_names}
    feats.update({n: v[rows] for n, v in casc._items.items()})
    with torch.inference_mode():
        return torch.sigmoid(casc.ranker_model(feats)).reshape(len(ids), k).cpu().numpy()


def recall_cut_tie(gpu, cpu, batch, r: int, hist: list) -> bool:
    """True when the two devices' recall candidates for user ``r`` differ
    only by items scored within ANSWER_TOL of the fetch cut."""
    one = {k: v[r:r + 1] for k, v in batch.items()}
    (g_ids,), (g_sc,) = gpu.recall.recommend(one, k=FETCH, histories=[hist])
    (c_ids,), (c_sc,) = cpu.recall.recommend(one, k=FETCH, histories=[hist])
    diff = set(g_ids) ^ set(c_ids)
    score = {**dict(zip(g_ids, g_sc)), **dict(zip(c_ids, c_sc))}
    return bool(diff) and all(abs(score[i] - c_sc[-1]) <= ANSWER_TOL for i in diff)


def compare_with_cpu(gpu, cpu, reqs: list, answers: list) -> None:
    """Card answers vs the CPU's plain-op answers; a user's list may differ
    only through ties (neighbouring scores within ANSWER_TOL, or recall
    candidates at the fetch cut)."""
    from news_recsys_tpu_torch.serving import PackedDataset, _user_batch_from_json
    ties = 0
    emb_err = score_err = 0.0
    for req, ans in zip(reqs, answers):
        batch = _user_batch_from_json(cpu, req["users"])
        with torch.inference_mode():
            emb = [rec.recall._encode(PackedDataset(dict(batch)),
                                      rec.recall.model.user_embedding).cpu().numpy()
                   for rec in (gpu, cpu)]
        emb_err = max(emb_err, float(np.abs(emb[0] - emb[1]).max()))
        cpu_scores = ranker_scores(cpu, batch, ans["ids"])
        score_err = max(score_err, float(np.abs(cpu_scores - np.asarray(ans["scores"])).max()))
        want_ids, want_scores = cpu.recommend(batch, k=K, histories=req["histories"])
        for r, (got, want, w) in enumerate(zip(ans["ids"], want_ids, want_scores)):
            gaps = np.abs(np.diff(w))
            tied = [(j > 0 and gaps[j - 1] <= ANSWER_TOL)
                    or (j < len(gaps) and gaps[j] <= ANSWER_TOL) for j in range(K)]
            if all(t or g == c for g, c, t in zip(got, want, tied)):
                continue
            if not recall_cut_tie(gpu, cpu, batch, r, req["histories"][r]):
                raise AssertionError(f"user {r}: card served {got}, CPU {want}")
            ties += 1
    log(f"card vs CPU: user embeddings max_abs_err {emb_err:.3e}, served sigmoid scores "
        f"max_abs_err {score_err:.3e} (tol {ANSWER_TOL}); users differing by a recall-cut "
        f"tie: {ties}")
    assert emb_err <= ANSWER_TOL and score_err <= ANSWER_TOL


def build_kernels() -> None:
    from news_recsys_tpu_torch.ops import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    report = (lib.parent / "build.log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", report))
    log(f"build: {time.perf_counter() - t0:.2f} s -> {lib}; ptxas: {len(regs)} kernels, "
        f"{min(regs)}-{max(regs)} registers, {spills} bytes spilled")


def build_cascade(dev: torch.device):
    """The full-width MIND cascade on ``dev`` from seeded weights: DSSM recall
    of configs/dssm.yaml over 65,238 items, DCN ranker of
    zoo.mind_config("dcn"), fetch 100."""
    from news_recsys_tpu_torch.models.dssm import build_dssm
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.serving import CascadeRecommender, PackedDataset, Recommender
    from news_recsys_tpu_torch.zoo import MIND_TABLE_SIZE, mind_config, mind_dssm_config

    rng = np.random.default_rng(SEED + 2)
    n_items = MIND_TABLE_SIZE["item_id"] - 1
    items = PackedDataset({
        "item_id": np.arange(1, n_items + 1, dtype=np.int32),
        "category": rng.integers(1, MIND_TABLE_SIZE["category"], n_items).astype(np.int32),
        "subcategory": rng.integers(1, MIND_TABLE_SIZE["subcategory"], n_items).astype(np.int32),
        "label": np.zeros((n_items, 1), np.float32),
    })
    dcfg, rcfg = mind_dssm_config(), mind_config("dcn")
    recall = Recommender(dcfg, build_dssm(dcfg, seed=SEED + 3, device=dev), items, device=dev)
    return CascadeRecommender(recall, rcfg, build_ranker(rcfg, seed=SEED + 4, device=dev),
                              items, fetch=FETCH)


def run(dev: torch.device) -> None:
    from news_recsys_tpu_torch.ops.dcn_kernel import dcn_cross_stack
    from news_recsys_tpu_torch.ops.fused_lookup_pool import fused_lookup_pool
    from news_recsys_tpu_torch.serving import CascadeRecommender, serve_http

    name = torch.cuda.get_device_name(0)
    smi = card()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels()
    kernels = check_kernels(dev)

    t0 = time.perf_counter()
    casc = build_cascade(dev)
    n_items = len(casc.recall.item_ids)
    shapes = [{n: tuple(t.shape) for n, t in model.embedder.tables.items()}
              for model in (casc.recall.model, casc.ranker_model)]
    log(f"cascade built on {name} in {time.perf_counter() - t0:.2f} s: {n_items} items; "
        f"recall tables {shapes[0]}; ranker tables {shapes[1]}")

    reqs = make_requests(1 + REQUESTS)
    with tempfile.TemporaryDirectory() as tmp:
        bundle = casc.save(os.path.join(tmp, "cascade"))
        del casc
        gpu = CascadeRecommender.load(bundle, device=dev)
        server = serve_http(gpu, host="127.0.0.1", port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            assert health["items"] == n_items and health["cascade"], health
            dcn_cross_stack.launches = 0
            fused_lookup_pool.launches = 0
            answers, latency_ms = [], []
            for req in reqs:
                t = time.perf_counter()
                answers.append(post(url, req))
                latency_ms.append((time.perf_counter() - t) * 1e3)
            launches = {"dcn_cross_stack": dcn_cross_stack.launches,
                        "fused_lookup_pool": fused_lookup_pool.launches}
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        for req, ans in zip(reqs, answers):
            check_answer(ans, req, n_items)
        log(f"served {len(reqs)} requests x {USERS_PER_REQUEST} users (k={K}, fetch={FETCH}); "
            f"answers checked; launches in those requests: {launches}")
        log(f"request latency on {name} ({smi}): first {latency_ms[0]:.1f} ms, then median "
            f"{np.median(latency_ms[1:]):.1f} ms, max {max(latency_ms[1:]):.1f} ms over "
            f"{REQUESTS} requests")

        cpu = CascadeRecommender.load(bundle, device="cpu")
        compare_with_cpu(gpu, cpu, reqs, answers)

    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: the served requests never launched it")

    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU is visible (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    run(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
