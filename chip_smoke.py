"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Drives the port's paths once at the full width of the repo's MIND
models, from seeded random weights: serving (the recall -> rank cascade,
with a DCN and with a DeepFM ranker), training (the DCN and DeepFM rankers'
sparse step under ``Trainer.fit``, DeepFM's with validation) and a few
steps of each other ranker of the zoo. Fails (non-zero exit, no result
line) if any phase fails:

1. needs CUDA; prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``news_recsys_tpu_torch/csrc`` (nvcc, sm_90a,
   one nvcc per source in parallel);
3. holds each kernel against its plain PyTorch version on the card at its
   path's shapes, and times both (device time from CUDA graph replays, or
   from a profiler trace where the plain version synchronises, and wall
   time per call with host overhead);
4. serving: builds the cascade (DSSM of configs/dssm.yaml, 65,238 items,
   fetch 100; the DCN of zoo.mind_config("dcn"), then the DeepFM of
   zoo.mind_ranker_config("deepfm")) on the card, saves it as a bundle,
   loads it back and serves it over HTTP on a thread; sends requests of 64
   users with histories (k=10) and checks every answer; loads the same
   bundle on the CPU (plain PyTorch ops) and checks that it agrees with the
   card's answers;
5. training: the DCN of zoo.mind_config("dcn",
   embedding_optimizer="rowwise_adagrad") (arena 159,360 x 32, batch 512)
   on a synthetic dataset of 64 batches shaped like bench.py's; 4 steps on
   the card and on the CPU from the same state and batches must agree;
   then ``Trainer.fit`` for one epoch on the card (loss finite), and a
   second, warm epoch timed for steps/s and examples/s; the same for the
   DeepFM of zoo.mind_ranker_config("deepfm") (arena 159,360 x 16), whose
   ``Trainer.fit`` also validates on a dev set of 256 users x 32 rows (half
   of them warm): the block must be finite and equal the CPU's
   ``validate`` on the same state;
6. the rest of the zoo (LR, Deep, Wide&Deep, FM, DCN-v2 of
   zoo.mind_ranker_config): 2 steps each at full width, card against CPU;
7. checks that each path launched the kernels it runs: the counts are set
   to 0 just before a path is driven and read just after.

Its last three lines are the card, a JSON line of the kernels and their
times, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import math
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
# training: batch 512, one epoch of 64 steps over a synthetic dataset
TRAIN_BATCH = 512
TRAIN_STEPS = 64
CHECK_STEPS = 4
# card vs CPU training state after CHECK_STEPS steps: cuBLAS and the CPU sum
# the matmuls in other orders, and Adam divides each step by |g| + 1e-8,
# which amplifies those differences in weights whose gradient cancels there
TRAIN_TOL = dict(rtol=1e-5, atol=5e-5)
# the cross stack's backward sums 512 terms per weight in per-block
# partials: rtol 1e-5 and an atol of 1e-5 of the largest gradient
BWD_RTOL = 1e-5
# the FM second order sums F products per column and D columns in another
# order than PyTorch: rtol 1e-5 and an atol of 1e-5 of the largest value
FM_F, FM_D = 5, 15              # DeepFM: 5 fields of 16, latent columns 1..15
# DeepFM's dev set: users x rows each, half the users warm
DEV_USERS, DEV_ROWS = 256, 32
# card vs CPU validation metrics on the same state
VAL_TOL = 1e-4
ZOO_CHECK_STEPS = 2


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


def device_events(prof) -> list:
    """A ``torch.profiler`` trace's device kernels and copies, by name; user
    annotations (``Optimizer.step#...`` ranges), which span other kernels,
    are left out so that nothing is counted twice."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def traced_ms(fn, calls: int = 50) -> float:
    """Device time per call from a ``torch.profiler`` trace of ``calls``
    eager calls: the kernels' own time, without the gaps between them. For
    a function that synchronises (a CUDA graph cannot capture it)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in device_events(prof)) / 1e3 / calls


def report_kernel(name, source, replaces, err, tol, times, calls, timing, shape,
                  **extra) -> dict:
    """Log a kernel's check and times, and return its entry of the
    ``kernels`` line. ``times``: device ms of plain, kernel, kernel, plain
    (the two orders average out drift); ``calls``: ms per call with host
    overhead of kernel and plain."""
    ms, plain_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
    log(f"kernel {name} [{shape}]: max_abs_err {err:.3e} ({tol}); device time ({timing}) "
        f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us; per call with host "
        f"overhead kernel {calls[0] * 1e3:.2f} us, plain {calls[1] * 1e3:.2f} us")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "timing": timing, "call_ms": calls[0], "plain_call_ms": calls[1], **extra}


def scaled_tol(want: torch.Tensor) -> dict:
    """rtol 1e-5 and an atol of 1e-5 of the largest value."""
    return dict(rtol=1e-5, atol=1e-5 * max(1.0, float(want.abs().max())))


def check_kernels(dev) -> list:
    from news_recsys_tpu_torch.ops.dcn_kernel import cross_plain, dcn_cross_stack
    from news_recsys_tpu_torch.ops.fm_kernel import fm_plain, fm_second_order
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
    v = torch.from_numpy(rng.standard_normal((B, FM_F, FM_D), np.float32)).to(dev)

    cases = [
        ("dcn_cross_stack", "news_recsys_tpu_torch/csrc/dcn_cross.cu",
         "news_recsys_tpu/ops/dcn_kernel.py:51", dcn_cross_stack, cross_plain,
         (x0, ws, bs), DCN_TOL, f"B={B} D={D} NL={NL}"),
        ("fused_lookup_pool", "news_recsys_tpu_torch/csrc/lookup_pool.cu",
         "news_recsys_tpu/ops/fused_lookup_pool.py:71", fused_lookup_pool,
         reference_lookup_pool, (table, ids, mask), POOL_TOL,
         f"V={V} D={Dp} B={Bp} L={L}"),
        ("fm_second_order", "news_recsys_tpu_torch/csrc/fm_second_order.cu",
         "news_recsys_tpu/ops/fm_kernel.py:33", fm_second_order, fm_plain, (v,), scaled_tol,
         f"B={B} F={FM_F} D={FM_D}"),
    ]
    out = []
    with torch.inference_mode():
        for name, source, replaces, kernel, plain, args, tol, shape in cases:
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            tol = tol(want) if callable(tol) else tol
            torch.testing.assert_close(got, want, **tol)
            t = [device_ms(lambda: f(*args)) for f in (plain, kernel, kernel, plain)]
            calls = [call_ms(lambda: f(*args)) for f in (kernel, plain)]
            out.append(report_kernel(name, source, replaces, err, f"tol {tol}", t, calls,
                                     "cuda_graph", shape))
    return out


def check_fm_training_kernels(dev) -> tuple:
    """The FM second order at the training shape (batch 512, 5 fields, 15
    latent columns): the forward against ``fm_plain``, the backward against
    ``fm_bwd_plain`` with two runs bit-identical. Returns (the forward's
    error and times at this shape, the backward's entry)."""
    from news_recsys_tpu_torch.ops.fm_kernel import (fm_bwd_plain, fm_plain, fm_second_order,
                                                     fm_second_order_bwd)

    rng = np.random.default_rng(SEED + 12)
    B, shape = TRAIN_BATCH, f"B={TRAIN_BATCH} F={FM_F} D={FM_D}"
    v = torch.from_numpy(rng.standard_normal((B, FM_F, FM_D), np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal(B, np.float32)).to(dev)
    with torch.no_grad():
        out, out_want = fm_second_order(v), fm_plain(v)
        dv, dv_want, again = fm_second_order_bwd(v, g), fm_bwd_plain(v, g), \
            fm_second_order_bwd(v, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, out_want, **scaled_tol(out_want))
    torch.testing.assert_close(dv, dv_want, **scaled_tol(dv_want))
    if not torch.equal(dv, again):
        raise AssertionError("fm_second_order_bwd: two runs gave different bits")
    fwd_err, bwd_err = float((out - out_want).abs().max()), float((dv - dv_want).abs().max())
    with torch.no_grad():
        t = [device_ms(lambda: f(v)) for f in (fm_plain, fm_second_order, fm_second_order,
                                               fm_plain)]
        fwd = {"shape": shape, "max_abs_err": fwd_err, "ms": (t[1] + t[2]) / 2,
               "plain_ms": (t[0] + t[3]) / 2}
        log(f"kernel fm_second_order [{shape}]: max_abs_err {fwd_err:.3e}; device time "
            f"(cuda_graph) kernel {fwd['ms'] * 1e3:.2f} us, plain {fwd['plain_ms'] * 1e3:.2f} us")
        t = [device_ms(lambda: f(v, g)) for f in (fm_bwd_plain, fm_second_order_bwd,
                                                  fm_second_order_bwd, fm_bwd_plain)]
        calls = [call_ms(lambda: f(v, g)) for f in (fm_second_order_bwd, fm_bwd_plain)]
    return fwd, report_kernel(
        "fm_second_order_bwd", "news_recsys_tpu_torch/csrc/fm_second_order.cu",
        "news_recsys_tpu/ops/fm_kernel.py:69", bwd_err,
        "rtol 1e-5, atol 1e-5 of the largest value; two runs bit-identical", t, calls,
        "cuda_graph", shape)


def check_training_kernels(dev) -> list:
    """The training path's kernels at its shapes: the cross stack's forward
    in the mode that writes the backward's residuals and its backward fed
    those residuals (batch 512, D 112, 3 layers), and the row scatter
    (arena 159,360 x 32, 1,024 sorted slots with duplicates, as the dedup
    gives them)."""
    from news_recsys_tpu_torch.ops.dcn_kernel import (_cross_fwd_kernel, cross_bwd_plain,
                                                      cross_fwd_plain, dcn_cross_bwd)
    from news_recsys_tpu_torch.ops.scatter_rows import scatter_rows_plain, scatter_rows_set

    rng = np.random.default_rng(SEED + 7)
    B, D, NL = TRAIN_BATCH, 112, 3
    bound = np.sqrt(6 / (D + 1))
    x0 = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
    ws = torch.from_numpy(rng.uniform(-bound, bound, (NL, D)).astype(np.float32)).to(dev)
    bs = torch.from_numpy(0.1 * rng.standard_normal((NL, D), np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
    with torch.no_grad():
        fwd = _cross_fwd_kernel(x0, ws, bs, residuals=True)
        fwd_want = cross_fwd_plain(x0, ws, bs)
    torch.cuda.synchronize()
    fwd_err = max(float((a - b).abs().max()) for a, b in zip(fwd, fwd_want))
    for part, a, b in zip(("out", "xs", "ss"), fwd, fwd_want):
        torch.testing.assert_close(a, b, msg=lambda m: f"cross forward {part}: {m}", **DCN_TOL)
    log(f"kernel dcn_cross_stack with residuals [B={B} D={D} NL={NL}]: out, xs, ss "
        f"max_abs_err {fwd_err:.3e} (tol {DCN_TOL})")
    bwd_args = (x0, ws, fwd[1], fwd[2], g)          # the forward kernel's own xs, ss
    with torch.no_grad():
        got, want = dcn_cross_bwd(*bwd_args), cross_bwd_plain(*bwd_args)
        again = dcn_cross_bwd(*bwd_args)
    torch.cuda.synchronize()
    bwd_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    bwd_scale = max(float(b.abs().max()) for b in want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=BWD_RTOL, atol=1e-5 * float(b.abs().max()))
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("dcn_cross_bwd: two runs gave different bits")

    V, Ds, S = 159360, 32, 2 * TRAIN_BATCH
    table = torch.from_numpy(rng.standard_normal((V, Ds), np.float32)).to(dev)
    rows = np.sort(rng.integers(1, V, S)).astype(np.int32)
    rows[1::7] = rows[0::7][: len(rows[1::7])]          # duplicates, still sorted
    rows.sort()
    vals = rng.standard_normal((S, Ds)).astype(np.float32)[np.searchsorted(rows, rows)]
    rows, vals = torch.from_numpy(rows).to(dev), torch.from_numpy(vals).to(dev)
    with torch.no_grad():
        t_kernel, t_plain = table.clone(), table.clone()
        scatter_rows_set(t_kernel, rows, vals)
        scatter_rows_plain(t_plain, rows, vals)
    torch.cuda.synchronize()
    scatter_err = float((t_kernel - t_plain).abs().max())
    if not torch.equal(t_kernel, t_plain):
        raise AssertionError("scatter_rows_set: the table differs from the plain version's")

    with torch.no_grad():
        t = [device_ms(lambda: f(*bwd_args))
             for f in (cross_bwd_plain, dcn_cross_bwd, dcn_cross_bwd, cross_bwd_plain)]
        calls = [call_ms(lambda: f(*bwd_args)) for f in (dcn_cross_bwd, cross_bwd_plain)]
        bwd = report_kernel(
            "dcn_cross_bwd", "news_recsys_tpu_torch/csrc/dcn_cross_bwd.cu",
            "news_recsys_tpu/ops/dcn_kernel.py:102", bwd_err,
            f"rtol {BWD_RTOL}, atol 1e-5 of the largest gradient, {bwd_scale:.4g}; two runs "
            f"bit-identical", t, calls, "cuda_graph", f"B={B} D={D} NL={NL}",
            fwd_residuals_max_abs_err=fwd_err)
        scatter = (lambda: scatter_rows_set(t_kernel, rows, vals),
                   lambda: scatter_rows_plain(t_plain, rows, vals))
        t = [traced_ms(scatter[i]) for i in (1, 0, 0, 1)]
        calls = [call_ms(f) for f in scatter]
        return [bwd, report_kernel(
            "scatter_rows_set", "news_recsys_tpu_torch/csrc/scatter_rows.cu",
            "news_recsys_tpu/ops/scatter_rows.py:68", scatter_err, "bit-identical", t, calls,
            "profiler", f"V={V} D={Ds} S={S}")]


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


def ranker_config(ranker: str):
    """The ranker's full-width MIND config: DCN as zoo.mind_config("dcn")
    (the PR 1 cascade), the others as the scoreboard trains them."""
    from news_recsys_tpu_torch.zoo import mind_config, mind_ranker_config

    return mind_config("dcn") if ranker == "dcn" else mind_ranker_config(ranker)


def train_config(ranker: str):
    """The ranker's full-width MIND training config at batch TRAIN_BATCH: DCN
    as bench.py trains it (``mind_config("dcn")`` with rowwise AdaGrad), the
    others as the scoreboard trains them."""
    from news_recsys_tpu_torch.zoo import mind_config, mind_ranker_config

    if ranker == "dcn":
        return mind_config("dcn", batch_size=TRAIN_BATCH, embedding_optimizer="rowwise_adagrad")
    return mind_ranker_config(ranker)


def build_cascade(dev: torch.device, ranker: str = "dcn"):
    """The full-width MIND cascade on ``dev`` from seeded weights: DSSM recall
    of configs/dssm.yaml over 65,238 items, the ranker of
    :func:`ranker_config`, fetch 100."""
    from news_recsys_tpu_torch.models.dssm import build_dssm
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.serving import CascadeRecommender, PackedDataset, Recommender
    from news_recsys_tpu_torch.zoo import MIND_TABLE_SIZE, mind_dssm_config

    rng = np.random.default_rng(SEED + 2)
    n_items = MIND_TABLE_SIZE["item_id"] - 1
    items = PackedDataset({
        "item_id": np.arange(1, n_items + 1, dtype=np.int32),
        "category": rng.integers(1, MIND_TABLE_SIZE["category"], n_items).astype(np.int32),
        "subcategory": rng.integers(1, MIND_TABLE_SIZE["subcategory"], n_items).astype(np.int32),
        "label": np.zeros((n_items, 1), np.float32),
    })
    dcfg, rcfg = mind_dssm_config(), ranker_config(ranker)
    recall = Recommender(dcfg, build_dssm(dcfg, seed=SEED + 3, device=dev), items, device=dev)
    return CascadeRecommender(recall, rcfg, build_ranker(rcfg, seed=SEED + 4, device=dev),
                              items, fetch=FETCH)


def ranking_arrays(rows: int, seed: int) -> dict:
    """Synthetic ranking rows shaped like ``bench.py:_ranking_arrays``: the
    five MIND features drawn uniformly over their tables, 10% positives."""
    from news_recsys_tpu_torch.zoo import MIND_FEATURES, MIND_TABLE_SIZE
    rng = np.random.default_rng(seed)
    arrays = {n: rng.integers(1, MIND_TABLE_SIZE[n], rows).astype(np.int32)
              for n in MIND_FEATURES}
    arrays["label"] = (rng.random(rows) < 0.1).astype(np.float32).reshape(-1, 1)
    return arrays


def serve_phase(dev: torch.device, name: str, smi: str, ranker: str = "dcn") -> dict:
    """Serve the cascade over HTTP and check it; returns the kernel launches
    of the served requests."""
    from news_recsys_tpu_torch.serving import CascadeRecommender, serve_http

    t0 = time.perf_counter()
    casc = build_cascade(dev, ranker)
    n_items = len(casc.recall.item_ids)
    shapes = [{n: tuple(t.shape) for n, t in model.embedder.tables.items()}
              for model in (casc.recall.model, casc.ranker_model)]
    log(f"cascade ({ranker} ranker) built on {name} in {time.perf_counter() - t0:.2f} s: "
        f"{n_items} items; recall tables {shapes[0]}; ranker tables {shapes[1]}")

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
            reset_launches()
            answers, latency_ms = [], []
            for req in reqs:
                t = time.perf_counter()
                answers.append(post(url, req))
                latency_ms.append((time.perf_counter() - t) * 1e3)
            launches = read_launches()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        for req, ans in zip(reqs, answers):
            check_answer(ans, req, n_items)
        log(f"served {len(reqs)} requests x {USERS_PER_REQUEST} users (k={K}, fetch={FETCH}); "
            f"answers checked; launches in those requests: {launches}")
        log(f"request latency ({ranker} ranker) on {name} ({smi}): first {latency_ms[0]:.1f} "
            f"ms, then median {np.median(latency_ms[1:]):.1f} ms, max "
            f"{max(latency_ms[1:]):.1f} ms over {REQUESTS} requests")

        cpu = CascadeRecommender.load(bundle, device="cpu")
        compare_with_cpu(gpu, cpu, reqs, answers)
    return launches


def compare_training_with_cpu(dev: torch.device, cfg, ds, n_steps: int = CHECK_STEPS) -> None:
    """``n_steps`` sparse steps on the card and on the CPU from the same
    seeded state and the same batches: every parameter (both take the sorted
    route, so every table row) and accumulator within TRAIN_TOL."""
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.sparse_step import (init_sparse_state,
                                                            make_sparse_train_step)
    from news_recsys_tpu_torch.training.trainer import AucHist, BatchPacker, unpack_batch

    cpu_model = build_ranker(cfg, seed=SEED + 5)
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to(dev)}
    states = {d: init_sparse_state(m, cfg) for d, m in models.items()}
    steps = {d: make_sparse_train_step(m, cfg) for d, m in models.items()}
    packer = BatchPacker(ds)
    idx = np.random.default_rng(SEED + 8).permutation(packer.n)[: n_steps * TRAIN_BATCH]
    losses = {"cpu": [], "cuda": []}
    for rows in idx.reshape(n_steps, TRAIN_BATCH):
        for d, device in (("cpu", torch.device("cpu")), ("cuda", dev)):
            batch = unpack_batch(torch.from_numpy(packer.int_mat[rows]).to(device),
                                 torch.from_numpy(packer.float_mat[rows]).to(device),
                                 torch.ones(TRAIN_BATCH, device=device), packer.layout_key())
            loss, _ = steps[d](states[d], batch, AucHist.zeros(device))
            losses[d].append(float(loss))
    want = dict(models["cpu"].named_parameters())
    err = {"params": 0.0, "accumulators": 0.0}
    for n, p in models["cuda"].named_parameters():
        err["params"] = max(err["params"], float((p.detach().cpu() - want[n].detach()).abs().max()))
        torch.testing.assert_close(p.detach().cpu(), want[n].detach(), msg=n, **TRAIN_TOL)
    for n, acc in states["cuda"].emb_acc.items():
        err["accumulators"] = max(err["accumulators"],
                                  float((acc.cpu() - states["cpu"].emb_acc[n]).abs().max()))
        torch.testing.assert_close(acc.cpu(), states["cpu"].emb_acc[n], msg=n, **TRAIN_TOL)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], **TRAIN_TOL)
    log(f"training {cfg.name} ({cfg.extra('dcn_cfg', {}) or ''}), card vs CPU after {n_steps} "
        f"steps at batch {TRAIN_BATCH}: tables {sorted(cpu_model.tables.items())}; max_abs_err "
        f"tables + dense parameters {err['params']:.3e}, AdaGrad accumulators "
        f"{err['accumulators']:.3e}, losses {losses['cuda']} vs {losses['cpu']} "
        f"(tol {TRAIN_TOL}; TF32 off: allow_tf32={torch.backends.cuda.matmul.allow_tf32})")


def dev_arrays(train_users: np.ndarray, seed: int) -> dict:
    """A dev set of DEV_USERS users with DEV_ROWS rows each, shaped like
    :func:`ranking_arrays`; half of the users have training rows (warm),
    half have none (cold)."""
    from news_recsys_tpu_torch.zoo import MIND_TABLE_SIZE
    rng = np.random.default_rng(seed)
    seen = np.unique(train_users)
    unseen = np.setdiff1d(np.arange(1, MIND_TABLE_SIZE["user_id"]), seen)
    users = np.concatenate([rng.choice(seen, DEV_USERS // 2, replace=False),
                            rng.choice(unseen, DEV_USERS // 2, replace=False)])
    arrays = ranking_arrays(DEV_USERS * DEV_ROWS, seed)
    arrays["user_id"] = np.repeat(users, DEV_ROWS).astype(np.int32)
    return arrays


def check_validation(trainer, state, dev_ds, warm: set, tmp: str) -> None:
    """The block ``Trainer.fit`` wrote must be finite, and the card's metrics
    on ``state`` must equal the CPU's ``validate`` on a copy of it."""
    from news_recsys_tpu_torch.training.trainer import Trainer

    block = open(trainer.val_log_path).read()
    with open(trainer.metrics_path) as f:
        logged = [json.loads(line) for line in f if "val_auc" in line]
    if (block.count("Validation Results") != 1 or len(logged) != 1
            or re.search(r"nan|inf", block, re.IGNORECASE)
            or not all(math.isfinite(v) for v in logged[0].values())):
        raise AssertionError(f"Trainer.fit's validation: {logged}\n{block}")
    t0 = time.perf_counter()
    card = trainer.validate(state, dev_ds, 0, warm)
    val_s = time.perf_counter() - t0
    cpu = Trainer(trainer.cfg, copy.deepcopy(trainer.model).to("cpu"),
                  workdir=os.path.join(tmp, "cpu"))
    want = cpu.validate(cpu.init_state(), dev_ds, 0, warm)
    err = max(abs(card[c][k] - want[c][k]) for c in want for k in want[c])
    if err > VAL_TOL or abs(card["Overall"]["AUC"] - logged[0]["val_auc"]) > VAL_TOL:
        raise AssertionError(f"validation, card vs CPU: max_abs_err {err}: {card} vs {want}")
    log(f"validation ({DEV_USERS} users x {DEV_ROWS} rows, {card['Warm_Start']['User_Count']} "
        f"warm) on the card in {val_s * 1e3:.1f} ms: card vs CPU max_abs_err over every metric "
        f"and cohort {err:.3e} (tol {VAL_TOL}); Overall AUC {card['Overall']['AUC']:.4f}, GAUC "
        f"{card['Overall']['GAUC']:.4f}")


def train_phase(dev: torch.device, name: str, smi: str, ranker: str = "dcn") -> dict:
    """Train the full-width ranker with ``Trainer.fit`` on the card; returns
    the kernel launches of that epoch. DCN's epoch trains alone; DeepFM's
    also validates on a dev set, checked against the CPU."""
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.trainer import PackedDataset, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False        # the card is held to the CPU
    cfg = train_config(ranker)
    data_seed, seed = (SEED + 9, SEED + 6) if ranker == "dcn" else (SEED + 10, SEED + 11)
    arrays = ranking_arrays(TRAIN_BATCH * TRAIN_STEPS, data_seed)
    ds = PackedDataset(arrays)
    validate = ranker != "dcn"
    dev_ds = PackedDataset(dev_arrays(arrays["user_id"], SEED + 12)) if validate else None
    warm = {int(u) for u in np.unique(arrays["user_id"])} if validate else None
    compare_training_with_cpu(dev, cfg, ds)

    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, build_ranker(cfg, seed=seed, device=dev), workdir=tmp,
                          device=dev)
        tables = {n: tuple(t.shape) for n, t in trainer.model.embedder.tables.items()}
        reset_launches()
        t0 = time.perf_counter()
        state = trainer.fit(ds, dev_ds, warm, max_epochs=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = read_launches()
        with open(trainer.metrics_path) as f:
            first = next(json.loads(line) for line in f if "train_loss" in line)
        if first["steps"] != TRAIN_STEPS or not math.isfinite(first["train_loss"]):
            raise AssertionError(f"Trainer.fit: {first}")
        bad = [n for n, p in trainer.model.named_parameters() if not torch.isfinite(p).all()]
        if bad:
            raise AssertionError(f"Trainer.fit left non-finite parameters: {bad}")
        log(f"Trainer.fit ({ranker}) on {name}: tables {tables}; {TRAIN_STEPS} steps of batch "
            f"{TRAIN_BATCH}{' and a validation' if validate else ''} in {fit_s:.2f} s (first "
            f"epoch, warm-up included); train_loss {first['train_loss']:.6f}, train_auc "
            f"{first['train_auc']:.4f}; launches in that epoch: {launches}")
        if validate:
            check_validation(trainer, state, dev_ds, warm, tmp)
        _, warm_epoch = trainer.train_epoch(state, ds, epoch=1)
        if not math.isfinite(warm_epoch["train_loss"]):
            raise AssertionError(f"train_epoch: {warm_epoch}")
    rate = warm_epoch["examples_per_sec"]
    log(f"training throughput ({ranker}) on {name} ({smi}): batch {TRAIN_BATCH}, a warm epoch "
        f"of {warm_epoch['steps']} steps: {rate / TRAIN_BATCH:.1f} steps/s, {rate:.0f} "
        f"examples/s")
    return launches


def zoo_phase(dev: torch.device) -> dict:
    """ZOO_CHECK_STEPS steps of each other ranker of the zoo at its full
    width, card against CPU; returns the kernel launches of those steps."""
    from news_recsys_tpu_torch.training.trainer import PackedDataset
    from news_recsys_tpu_torch.zoo import mind_ranker_config

    ds = PackedDataset(ranking_arrays(TRAIN_BATCH * ZOO_CHECK_STEPS, SEED + 13))
    reset_launches()
    for recipe in ("lr", "deep", "widedeep", "fm", "dcn@v2"):
        compare_training_with_cpu(dev, mind_ranker_config(recipe), ds, n_steps=ZOO_CHECK_STEPS)
    return read_launches()


def counted_kernels() -> dict:
    from news_recsys_tpu_torch.ops.dcn_kernel import dcn_cross_bwd, dcn_cross_stack
    from news_recsys_tpu_torch.ops.fm_kernel import fm_second_order, fm_second_order_bwd
    from news_recsys_tpu_torch.ops.fused_lookup_pool import fused_lookup_pool
    from news_recsys_tpu_torch.ops.scatter_rows import scatter_rows_set
    return {f.__name__: f for f in (dcn_cross_stack, fused_lookup_pool, dcn_cross_bwd,
                                    scatter_rows_set, fm_second_order, fm_second_order_bwd)}


def reset_launches() -> None:
    for f in counted_kernels().values():
        f.launches = 0


def read_launches() -> dict:
    return {n: f.launches for n, f in counted_kernels().items()}


# the kernels each path must launch
PATH_KERNELS = {"serve": ("dcn_cross_stack", "fused_lookup_pool"),
                "train": ("dcn_cross_stack", "dcn_cross_bwd", "scatter_rows_set"),
                "serve_deepfm": ("fm_second_order", "fused_lookup_pool"),
                "train_deepfm": ("fm_second_order", "fm_second_order_bwd", "scatter_rows_set"),
                "train_zoo": ("fm_second_order", "fm_second_order_bwd", "scatter_rows_set")}


def run(dev: torch.device) -> None:
    name = torch.cuda.get_device_name(0)
    smi = card()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    build_kernels()
    kernels = check_kernels(dev) + check_training_kernels(dev)
    fm_train_fwd, fm_bwd = check_fm_training_kernels(dev)
    next(k for k in kernels if k["name"] == "fm_second_order")["at_train_shape"] = fm_train_fwd
    kernels.append(fm_bwd)
    paths = {"serve": serve_phase(dev, name, smi),
             "train": train_phase(dev, name, smi),
             "serve_deepfm": serve_phase(dev, name, smi, "deepfm"),
             "train_deepfm": train_phase(dev, name, smi, "deepfm"),
             "train_zoo": zoo_phase(dev)}
    for path, names in PATH_KERNELS.items():
        for k in names:
            if paths[path][k] <= 0:
                raise AssertionError(f"{k}: the {path} path never launched it")
    for k in kernels:
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())

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
