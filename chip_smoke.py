"""Smoke run of the PyTorch port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Drives the port's paths once at the full width of the repo's MIND
models, from seeded random weights: serving (the recall -> rank cascade,
with a DCN, a DeepFM and an attention ranker), training (the DCN, DeepFM and
attention rankers' sparse step under ``Trainer.fit``, DeepFM's with
validation; the attention ranker's all-dense AdamW step; the DSSM's
retrieval training under ``DSSMTrainer.fit``), a few steps of each other
ranker of the zoo, and the command line from synthetic raw files to
predictions, retrieval and the ItemCF baseline, checkpoint conversion,
the cascade served from checkpoints and the tooling commands, and the
training runtime (slab-streamed data, the device metric engine,
profiling). Fails (non-zero exit, no result line) if any phase fails:

1. needs CUDA; prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``news_recsys_tpu_torch/csrc`` (nvcc, sm_90a,
   one nvcc per source in parallel; PyTorch's own start-up on the card is
   paid meanwhile);
3. holds each of the eleven kernels against its plain PyTorch version on the
   card at its path's shapes, and times both (device time from CUDA graph
   replays, and wall time per call with host overhead); beside them the bound (the
   least time the card could take: bytes moved over 3.35 TB/s or float32
   operations over the peak of the units the kernel uses, 67 TFLOP/s outside
   the tensor cores and 495 TFLOP/s in TF32 on them, whichever is larger,
   from this run's inputs, by each kernel's ``*_cost`` function in
   ``news_recsys_tpu_torch/ops``) and, where one PyTorch call computes the same
   function, that call's time; the fused block runs both its routes (tiled
   and general) against the plain version and times them in the same run;
   the row scatter runs at the DCN arena's shape, at each of its two shards
   of 79,680 rows (the same slots translated into the shard, as a rank of a
   model axis of 2 writes them), and at the sparse attention
   step's two (each table handed all 16,384 slots of one seeded batch's
   joint dedup), the FM forward at a request's B 6,400 and a step's B 512,
   the cross stack's training forward (with ``ss``) and backward at B 512
   and at the large batch's 8,192, the block's forward at B 6,400, 512 and
   2,048 and its backward at 512 and 2,048, NRMS's masked attention forward
   and backward at the news encoder's 3,520 titles of 30 and the user
   encoder's 64 histories of 50 (``F.scaled_dot_product_attention`` the
   library call);
   the FM and cross stack backwards also against their own second run bit
   for bit, the cross backward against a CUDA-graph replay of itself too;
   and one empty kernel, the floor of a launch (``launch_floor_ms``);
4. serving: builds the cascade (DSSM of configs/dssm.yaml, 65,238 items,
   fetch 100; the DCN of zoo.mind_config("dcn"), then the DeepFM of
   zoo.mind_ranker_config("deepfm")) on the card, saves it as a bundle,
   loads it back and serves it over HTTP on a thread; sends requests of 64
   users with histories (k=10) and checks every answer; loads the same
   bundle on the CPU (plain PyTorch ops) and checks that it agrees with the
   card's answers;
5. training: the DCN of zoo.mind_config("dcn",
   embedding_optimizer="rowwise_adagrad") (arena 159,360 x 32, batch 512)
   on a synthetic dataset of 32 batches shaped like bench.py's; 4 steps on
   the card and on the CPU from the same state and batches must agree;
   then ``Trainer.fit`` for one epoch on the card (loss finite), and a
   second, warm epoch timed for steps/s and examples/s; the same for the
   DeepFM of zoo.mind_ranker_config("deepfm") (arena 159,360 x 16), whose
   ``Trainer.fit`` also validates on a dev set of 256 users x 32 rows (half
   of them warm): the block must be finite and equal the CPU's
   ``validate`` on the same state;
6. the attention ranker of zoo.attention_config() (user 94,080 x 32, item
   65,280 x 32 shared with the unpooled history of 30, one Transformer
   block D 32, 2 heads, FF 64): served in the cascade, card against CPU;
   trained on the sparse step (4 steps card against CPU, ``Trainer.fit`` for
   an epoch of 64 steps, a timed warm epoch: 15,872 item-table slots a
   step); and the scoreboard recipe zoo.mind_ranker_config("attention@adamw")
   on the all-dense AdamW step (4 steps card against CPU, then
   ``Trainer.fit`` for an epoch and a timed warm one);
7. the rest of the zoo (LR, Deep, Wide&Deep, FM, DCN-v2 and the scoreboard
   attention recipe of zoo.mind_ranker_config): 2 steps each at full width,
   card against CPU; NRMS of zoo.mind_nrms_config() (``train_nrms``): 8
   all-dense steps at batch 64, the attention's forward and backward once
   for each encoder a step; the DSSM of configs/dssm.yaml (user 94,058 x 16, item
   65,239 x 16, ``hist`` of 30 pooled over the item table, rate 8, logQ) on
   32 batches of 512 clicked rows with histories of 0-30: 4 steps of its
   all-dense AdamW step and 4 of its rowwise AdaGrad variant, card against
   CPU from the same state before each step (gradients, and the weights
   but those whose gradient was under ~1e-7 so far, where Adam amplifies
   rounding); ``DSSMTrainer.fit`` for an epoch with a retrieval validation
   of 1,024 queries over 65,238 items, whose encodings and HR@10 (on
   targets drawn from the CPU's own candidate lists) must equal the CPU's
   but for ties at the cut; and a timed warm epoch;
8. the command line (``cli``), through ``news_recsys_tpu_torch.cli.main`` in
   a temporary directory: ``synth`` (20,000 news, 20,000 users, 40,000 +
   8,000 impressions, seed 3), ``preprocess`` and ``fe`` with a copy of
   configs/dcn.yaml (paths into the directory, ``max_epoch`` 2,
   ``ckpt_every_steps`` 100, every other field as shipped: user 94,058 x 32
   and item 65,239 x 32 in the arena, the all-dense AdamW step, batch 512);
   ``train`` for 2 epochs on the card, each validated (finite AUC, GAUC,
   NDCG@10); the same cut at ``max_step`` 150 into a second dir and
   ``train --resume`` there with the shipped ``max_step``, whose
   ``epoch_001.pt`` must equal the straight run's within the training
   tolerance; ``predict`` of the dev split on the card and on the CPU from
   the same checkpoint (scores within 1e-5), and once more as ``python3 -m
   news_recsys_tpu_torch`` in a subprocess; then ``fe`` and ``train`` for an
   epoch with a copy of configs/attention.yaml (``hist`` and ``entities``);
   then with a copy of configs/dssm.yaml ``fe``, ``train`` for an epoch
   (click positives plus leave-one-out history pairs, logQ; its
   ``retrieval_eval.json`` checked and its bundle loaded and asked),
   ``predict -m dssm`` on the card and on the CPU (embeddings and cosines
   within 1e-5) and ``itemcf`` on the host; then ``convert-ckpt`` of the
   DCN run's last epoch checkpoint to per-table tables and back (bit for
   bit on the arena's addressable rows and every other tensor) and
   ``predict`` of the per-table one under ``arena_tables: false`` (the
   arena run's scores within 1e-6); ``serve --ranker-ckpt <the DCN run>
   --ranker-config <its yaml>`` on the DSSM run's bundle over HTTP, with
   ``--backend device`` and ``host`` (every answer equal to an in-process
   ``build_cascade``'s id for id, the two backends' recall equal but for
   near ties); ``fe --text`` and ``open_split`` from the text splits (the
   ``.npz`` arrays); ``log`` of the DCN run; ``visualize-history`` of the
   raw train files;
9. the optimizer variants (``train_variants``), each at full width with
   its own timed warm epoch: the DCN of zoo.mind_config("dcn") on
   ``sparse_adamw`` (the table and both (V, D) moments written by the row
   scatter kernel), on ``rowwise_adagrad`` with K-step write-back (K 4, an
   epoch of 30 steps, a step checkpoint every 6 that cuts a group, and a run
   cut at step 18 and resumed that must equal the straight one bit for bit),
   with bfloat16 tables and towers at batch 512 and 8,192 (bench.py's bf16
   lines; the unique-row layout, stochastic rounding, no scatter), and the
   DSSM of configs/dssm.yaml on ``sparse_adamw``; each held to the CPU from
   the same state before every step and with the same rounding bits;
10. the training runtime (``runtime``): the DCN at MIND-small widths on the
   slab-streamed path (``device_resident_bytes`` of 3 batches of rows) and
   on the resident path, 32 steps, ``predict`` and ``validate`` (the
   device metric engine) bit for bit, a slab's host gather and upload timed
   beside the step; 8.4 M rows of the attention ranker's data (2.15 GB
   packed) that the default 2 GiB budget sends down the slab path, 64 steps
   bit for bit against the resident path; a DSSM epoch of 16 steps on slabs
   against the resident path, bit for bit; the device metric engine at
   20,000, 200,000 and 2.6 M rows (users of ~37 rows, tied scores) against
   the host engine and its own second run, both engines timed; ``Trainer(profile_steps=1)``, whose trace
   must name the cross backward's kernel, and ``device_memory_stats()``;
11. multi-device training (``parallel``): two ranks spawned on ``cuda:0``
   after the build, joined over gloo (NCCL refuses two ranks on one card;
   CUDA tensors' all-to-alls and all-gathers go through the host), against
   this process on the card from the same seeded state and batches: the
   DCN of zoo.mind_config("dcn", embedding_optimizer="rowwise_adagrad")
   (batch 512) at (data 1, model 2), the arena in two shards of 79,680 rows,
   8 steps bit for bit; at (data 2, model 1) 8 steps within the training
   tolerance, the AUC histograms equal; on ``sparse_adamw`` at (1, 2) 4
   steps bit for bit but the spare row, which the shards leave (and the
   padding row) as it was; the DSSM of configs/dssm.yaml at (2, 1), 4 steps,
   negatives over the global batch; ``Trainer.fit`` for an epoch of 32 steps
   at (1, 2), whose epoch checkpoint, loaded by this process, predicts the
   ranks' scores bit for bit; each rank's launches; the warm step time of
   each layout (runs of 8 steps) with the collectives' share, beside this
   process's;
12. the roofline of each training path (``roofline``): the DCN, DeepFM,
   the attention ranker's sparse and dense steps and the all-dense DSSM at
   batch 512, and NRMS at its batch of 64, each from its seeded state: one
   warm step counted by ``utils/roofline.py``'s ``step_cost`` (the matmuls'
   FLOPs and each kernel's own count, by the units they run on; bytes op by
   op) on a copy of the state on the card and on the CPU, the CPU's
   optimizers in the card's foreach form, which must be equal; ``mfu_pct``
   (each units' FLOPs at its own peak) and ``hbm_bw_util_pct`` against the
   H100's published peaks at the wall time of a step of a warm epoch and at
   its device time from a ``torch.profiler`` trace, none over 100%; each of
   the eleven kernels counted on some path;
13. traces one CUDA-graph replay of the cross backward with
   ``torch.profiler`` (after the timed phases of this process, before the
   ranks of ``parallel`` are spawned), which must run its two device kernels
   once each (``device_kernels``); checks that each path launched the
   kernels it runs, the new paths as many times as they should: the counts
   are set to 0 just before a path is driven and read just after;
14. the full-scale quality campaign's scripts (``fullscale``) end to end on
   the card at the shipped widths and a tiny depth:
   ``scripts/fullscale_rankers_torch.py --prepare`` (synth of 3,000 news
   and 3,000 users, seed 3; preprocess, base config, fe, the tightening),
   then ``dcn``, ``dssm@aug+logq+ns8`` and the variant paths
   ``dcn@b8192+bf16``, ``fm@adamw``, ``dcn@rneg4``, ``attention@rneg4`` and
   ``dssm@aug+logq+adamw`` for an epoch each, all seven training processes
   at once; then ``scripts/cascade_eval_torch.py`` on their checkpoints over
   256 dev positives, in this process, ranked by ``dcn`` (``fullscale``: the
   DSSM's user tower pools twice, the DCN ranks once) and by
   ``attention_rneg4`` (``fullscale_attention``: the block once over the
   25,600 candidates, the pool once more for ``entities``). Every artifact
   must be written, every AUC and HR@10 in them finite, and the card they
   name an NVIDIA one;
15. the MIND parity harness (``mind_parity``) at the same depth:
   ``scripts/mind_parity_torch.py --synth`` (deep, dcn and the attention
   ranker for an epoch each, the three training processes at once), whose
   reload of each best epoch and ``Trainer.predict`` of the dev split run in
   this process (the cross stack, the block and the pool once a batch of
   512): each row's AUC, nDCG@10 and MRR must equal its val log's best
   Overall block within 1e-4, the card's scores the CPU's on the same
   checkpoint within 1e-5; the ``--data`` route on a copy of the raw files
   must give the same checksum manifest and ``base.yaml``; and
   ``scripts/popularity_baseline_torch.py`` on the run's processed files,
   on the card and on the CPU, must give the same HR@10 and HR@50.

Its last three lines are the card, a JSON line of the kernels and their
times (and the launch floor and each training path's roofline), and
``{"ok": true, "device": {...}}``.
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

from news_recsys_tpu_torch.utils.roofline import _PEAKS, H100

H100_PEAKS = _PEAKS[H100]

T_START = time.perf_counter()
SEED = 0
USERS_PER_REQUEST = 64
REQUESTS = 6                  # timed, after one warm-up request
K = 10
FETCH = 100
# kernel vs plain on the card: float32 with another summation order; the
# cross stack's values grow over three layers, hence its looser atol
DCN_TOL = dict(rtol=1e-5, atol=1e-4)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)
# card vs CPU answers: sigmoid scores and user embeddings
ANSWER_TOL = 1e-5
# training: batch 512, one epoch over a synthetic dataset: 64 steps for the
# attention ranker, 32 for the DCN and the DeepFM (cut from 64 to keep the
# run short as paths are added)
TRAIN_BATCH = 512
TRAIN_STEPS = 64
EARLIER_TRAIN_STEPS = 32
CHECK_STEPS = 4
# card vs CPU training state after CHECK_STEPS steps: cuBLAS and the CPU sum
# the matmuls in other orders, and Adam divides each step by |g| + 1e-8,
# which amplifies those differences in weights whose gradient cancels there
TRAIN_TOL = dict(rtol=1e-5, atol=5e-5)
# an AdamW second moment under this (b2 0.999): the weight's gradient was
# under ~1e-7 in every step so far, a sum that cancelled to within ~100x
# the card's and the CPU's rounding differences (compare_dssm_training_with_cpu)
ROUNDING_NU = 1e-17
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
DENSE_STEPS = 16                # steps in an epoch of the all-dense path
DSSM_STEPS = 32                 # a DSSM epoch: 32 batches of 512
DSSM_QUERIES = 1024             # the DSSM validation's query rows
# the train_variants phase: the DCN and the DSSM on the sparse step's other
# optimizer settings. K-step write-back (K 4) trains an epoch of 30 steps
# (not a multiple of 4) with a step checkpoint every 6 steps, which cuts
# every second group: the trainer flushes there, two steps into it, so each
# 6-step chunk applies twice; a run cut at step 18 and resumed must equal the
# straight run bit for bit
LAZY_K, LAZY_STEPS, LAZY_CKPT_EVERY, LAZY_CUT = 4, 30, 6, 18
LAZY_APPLIES = LAZY_STEPS // LAZY_CKPT_EVERY * -(-LAZY_CKPT_EVERY // LAZY_K)
B8192, B8192_STEPS, B8192_CHECK_STEPS = 8192, 16, 2
VARIANTS = ("dcn@sparse_adamw", "dcn@K4", "dcn@bf16", "dcn_b8192@bf16", "dssm@sparse_adamw")
# bfloat16 towers, card vs CPU: their matmuls round to 8 bits of mantissa
# on both, in other orders; after a step from the same state a weight may
# move by up to ~3 lr (Adam's largest move) the other way where its
# gradient is within that rounding of 0
BF16_TOWER_TOL = dict(rtol=2e-2, atol=1e-2)
# the fused block, kernel vs plain on the card: the JAX package's tolerances
# for its kernel (float32, other summation orders; gradients are sums over
# B*L rows, held to an atol of 2e-5 of the largest value)
BLOCK_L, BLOCK_D, BLOCK_H, BLOCK_F = 30, 32, 2, 64
BLOCK_FWD_TOL = dict(rtol=2e-5, atol=2e-5)
BLOCK_GRAD_RTOL = 2e-4
# this slice's kernels and their plain versions take 50 us to 3 ms a call:
# fewer replays and calls than the microsecond kernels get
DEEP = dict(rounds=7, inner=10)
# the card's published peaks (NVIDIA's H100 SXM data sheet, in
# news_recsys_tpu_torch/utils/roofline.py): device memory here; a kernel's
# rate is that of the units its cost names (float32 outside the tensor
# cores, every kernel but the block's tiled route; dense TF32 on them, the
# tiled route's mma.sync products, its float32 operations counted once, not
# the three products of the 3xTF32 split)
HBM_BYTES_PER_S = H100_PEAKS["hbm"]
# the cli phase: synthetic raw MIND files at the size of a full training
# run (200,326 train rows: 391 steps of 512 an epoch), the shipped configs
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
CLI_SYNTH = ["--news", "20000", "--users", "20000", "--train-impressions", "40000",
             "--dev-impressions", "8000", "--seed", "3"]
CLI_EPOCHS = 2
CLI_CKPT_EVERY = 100
CLI_CUT_STEP = 150


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def call_ms(fn, rounds: int = 11, inner: int = 20) -> float:
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


def device_ms(fn, rounds: int = 11, inner: int = 20, stream=None) -> float:
    """Device time per call: ``inner`` calls captured in one CUDA graph and
    replayed, so no host work sits between the launches; median over
    ``rounds`` replays. Inputs stay in L2 from one call to the next.
    ``stream``: the stream to warm up and capture on (a backward's kernels
    run on their forward's stream), else a new one."""
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
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


def least_time(cost) -> dict:
    """The least time the card could take for a kernel's ``cost`` (its
    ``*_cost`` function's ``KernelCost``: bytes moved, each input read once
    and each output written once, and float32 operations at the peak of the
    units it names)."""
    nbytes, flops, peak_flops = cost.bytes, cost.flops, H100_PEAKS[cost.units]
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak_flops * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": float(nbytes), "flops": float(flops), "peak_flops": peak_flops}


def report_kernel(name, source, replaces, err, tol, times, calls, timing, shape, work,
                  library_ms=None, **extra) -> dict:
    """Log a kernel's check and times, and return its entry of the
    ``kernels`` line. ``times``: device ms of plain, kernel, kernel, plain
    (the two orders average out drift; the kernel's two ride along as
    ``turns_ms``); ``calls``: ms per call with host
    overhead of kernel and plain; ``work``: :func:`least_time` of this run's
    inputs; ``library_ms``: device ms of the one PyTorch call that computes
    the same function, where there is one."""
    ms, plain_ms = (times[1] + times[2]) / 2, (times[0] + times[3]) / 2
    if ms < work["bound_ms"]:
        raise AssertionError(f"{name} [{shape}]: {ms * 1e3:.2f} us is under its bound of "
                             f"{work['bound_ms'] * 1e3:.2f} us: the bound is wrong")
    lib = "none" if library_ms is None else f"{library_ms * 1e3:.2f} us"
    log(f"kernel {name} [{shape}]: max_abs_err {err:.3e} ({tol}); device time ({timing}) "
        f"kernel {ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, bound "
        f"{work['bound_ms'] * 1e3:.2f} us by {work['bound_by']}, library call {lib}; per call "
        f"with host overhead kernel {calls[0] * 1e3:.2f} us, plain {calls[1] * 1e3:.2f} us")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "turns_ms": [times[1], times[2]], **work,
            "library_ms": library_ms, "timing": timing, "shape": shape, "call_ms": calls[0],
            "plain_call_ms": calls[1], **extra}


def scaled_tol(want: torch.Tensor) -> dict:
    """rtol 1e-5 and an atol of 1e-5 of the largest value."""
    return dict(rtol=1e-5, atol=1e-5 * max(1.0, float(want.abs().max())))


def check_kernels(dev) -> list:
    from news_recsys_tpu_torch.ops.dcn_kernel import cross_cost, cross_plain, dcn_cross_stack
    from news_recsys_tpu_torch.ops.fm_kernel import (fm_cost, fm_plain, fm_second_order,
                                                     plan_fm_fwd)
    rng = np.random.default_rng(SEED)
    B, D, NL = USERS_PER_REQUEST * FETCH, 112, 3
    bound = np.sqrt(6 / (D + 1))
    x0 = torch.from_numpy(rng.standard_normal((B, D), np.float32)).to(dev)
    ws = torch.from_numpy(rng.uniform(-bound, bound, (NL, D)).astype(np.float32)).to(dev)
    bs = torch.from_numpy(0.1 * rng.standard_normal((NL, D), np.float32)).to(dev)

    v = torch.from_numpy(rng.standard_normal((B, FM_F, FM_D), np.float32)).to(dev)

    cases = [
        ("dcn_cross_stack", "news_recsys_tpu_torch/csrc/dcn_cross.cu",
         "news_recsys_tpu/ops/dcn_kernel.py:51", dcn_cross_stack, cross_plain,
         (x0, ws, bs), DCN_TOL, f"B={B} D={D} NL={NL}",
         least_time(cross_cost(B, D, NL)), None),
        ("fm_second_order", "news_recsys_tpu_torch/csrc/fm_second_order.cu",
         "news_recsys_tpu/ops/fm_kernel.py:33", fm_second_order, fm_plain, (v,), scaled_tol,
         f"B={B} F={FM_F} D={FM_D}",
         least_time(fm_cost(B, FM_F, FM_D)), None),
    ]
    log(f"  fm_second_order [B={B}]: plan {plan_fm_fwd(*v.shape)._asdict()}")
    out = []
    with torch.inference_mode():
        for name, source, replaces, kernel, plain, args, tol, shape, work, library in cases:
            got, want = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            tol = tol(want) if callable(tol) else tol
            torch.testing.assert_close(got, want, **tol)
            if not torch.equal(kernel(*args), got):
                raise AssertionError(f"{name}: two runs gave different bits")
            t = [device_ms(lambda: f(*args)) for f in (plain, kernel, kernel, plain)]
            calls = [call_ms(lambda: f(*args)) for f in (kernel, plain)]
            out.append(report_kernel(name, source, replaces, err, f"tol {tol}", t, calls,
                                     "cuda_graph", shape, work,
                                     device_ms(library) if library else None))
    return out


def check_fm_training_kernels(dev) -> tuple:
    """The FM second order at the training shape (batch 512, 5 fields, 15
    latent columns): the forward against ``fm_plain``, the backward against
    ``fm_bwd_plain``, each with two runs bit-identical. Returns (the
    forward's error and times at this shape, the backward's entry)."""
    from news_recsys_tpu_torch.ops.fm_kernel import (fm_bwd_cost, fm_bwd_plain, fm_cost,
                                                     fm_plain, fm_second_order,
                                                     fm_second_order_bwd, plan_fm_bwd,
                                                     plan_fm_fwd)

    rng = np.random.default_rng(SEED + 12)
    B, shape = TRAIN_BATCH, f"B={TRAIN_BATCH} F={FM_F} D={FM_D}"
    v = torch.from_numpy(rng.standard_normal((B, FM_F, FM_D), np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal(B, np.float32)).to(dev)
    with torch.no_grad():
        out, out_want, out_again = fm_second_order(v), fm_plain(v), fm_second_order(v)
        dv, dv_want, again = fm_second_order_bwd(v, g), fm_bwd_plain(v, g), \
            fm_second_order_bwd(v, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, out_want, **scaled_tol(out_want))
    torch.testing.assert_close(dv, dv_want, **scaled_tol(dv_want))
    if not (torch.equal(dv, again) and torch.equal(out, out_again)):
        raise AssertionError("fm_second_order: two runs gave different bits")
    fwd_err, bwd_err = float((out - out_want).abs().max()), float((dv - dv_want).abs().max())
    with torch.no_grad():
        t = [device_ms(lambda: f(v)) for f in (fm_plain, fm_second_order, fm_second_order,
                                               fm_plain)]
        fwd = {"shape": shape, "max_abs_err": fwd_err, "ms": (t[1] + t[2]) / 2,
               "plain_ms": (t[0] + t[3]) / 2, "turns_ms": t[1:3],
               "call_ms": call_ms(lambda: fm_second_order(v)),
               **least_time(fm_cost(B, FM_F, FM_D))}
        log(f"kernel fm_second_order [{shape}]: max_abs_err {fwd_err:.3e}; device time "
            f"(cuda_graph) kernel {fwd['ms'] * 1e3:.2f} us, plain {fwd['plain_ms'] * 1e3:.2f} us, "
            f"bound {fwd['bound_ms'] * 1e3:.2f} us by {fwd['bound_by']}; plan "
            f"{plan_fm_fwd(*v.shape)._asdict()}")
        t = [device_ms(lambda: f(v, g)) for f in (fm_bwd_plain, fm_second_order_bwd,
                                                  fm_second_order_bwd, fm_bwd_plain)]
        calls = [call_ms(lambda: f(v, g)) for f in (fm_second_order_bwd, fm_bwd_plain)]
    log(f"  fm_second_order_bwd [{shape}]: plan {plan_fm_bwd(*v.shape)._asdict()}")
    return fwd, report_kernel(
        "fm_second_order_bwd", "news_recsys_tpu_torch/csrc/fm_second_order.cu",
        "news_recsys_tpu/ops/fm_kernel.py:69", bwd_err,
        "rtol 1e-5, atol 1e-5 of the largest value; two runs bit-identical", t, calls,
        "cuda_graph", shape, least_time(fm_bwd_cost(B, FM_F, FM_D)))


def cross_case(B: int, seed: int, dev) -> tuple:
    """(x0, ws, bs, g) of the DCN's cross stack at batch ``B`` (D 112, 3
    layers): unit-normal rows and gradients, Glorot-uniform weights, small
    biases."""
    rng = np.random.default_rng(seed)
    D, NL = 112, 3
    bound = np.sqrt(6 / (D + 1))
    arrays = (rng.standard_normal((B, D), np.float32),
              rng.uniform(-bound, bound, (NL, D)).astype(np.float32),
              0.1 * rng.standard_normal((NL, D), np.float32),
              rng.standard_normal((B, D), np.float32))
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


CROSS_LARGE_BATCH = 8192          # the cross stack of ``dcn@b8192``
SHAPE_KEYS = ("shape", "max_abs_err", "ms", "plain_ms", "turns_ms", "bound_ms", "bound_by",
              "library_ms", "call_ms", "plain_call_ms")


def check_training_kernels(dev) -> list:
    """The DCN training path's cross stack kernels at its shapes: the
    forward in the mode that writes the backward's residuals (``ss``) and
    its backward fed those residuals, at batch 512 and, as ``at_b8192``,
    at the large batch's 8,192 (D 112, 3 layers)."""
    fwd, bwd = cross_training_kernels(TRAIN_BATCH, SEED + 7, dev)
    big_fwd, big_bwd = cross_training_kernels(CROSS_LARGE_BATCH, SEED + 8, dev)
    fwd["at_b8192"] = {k: big_fwd[k] for k in SHAPE_KEYS}
    bwd["at_b8192"] = {k: big_bwd[k] for k in SHAPE_KEYS}
    return [fwd, bwd]


def cross_training_kernels(B: int, seed: int, dev) -> tuple:
    """(forward entry, backward entry) of the cross stack's training kernels
    at batch ``B``: each held to its plain version, the backward's two runs
    and a graph replay bit-identical."""
    from news_recsys_tpu_torch.ops.dcn_kernel import (_aligned, _cross_fwd_kernel, _plan,
                                                      cross_bwd_cost, cross_bwd_rebuild_plain,
                                                      cross_cost, cross_fwd_plain, dcn_cross_bwd)

    D, NL = 112, 3
    shape = f"B={B} D={D} NL={NL}"
    x0, ws, bs, g = cross_case(B, seed, dev)
    fwd_kernel = lambda: _cross_fwd_kernel(x0, ws, bs, residuals=True)           # noqa: E731
    fwd_plain = lambda: cross_fwd_plain(x0, ws, bs)                              # noqa: E731
    with torch.no_grad():
        (out, ss), (want_out, _, want_ss) = fwd_kernel(), fwd_plain()
    torch.cuda.synchronize()
    fwd_err = max(float((a - b).abs().max()) for a, b in ((out, want_out), (ss, want_ss)))
    for part, a, b in (("out", out, want_out), ("ss", ss, want_ss)):
        torch.testing.assert_close(a, b, msg=lambda m: f"cross forward {part} [{shape}]: {m}",
                                   **DCN_TOL)
    with torch.no_grad():
        t = [device_ms(f) for f in (fwd_plain, fwd_kernel, fwd_kernel, fwd_plain)]
        calls = [call_ms(f) for f in (fwd_kernel, fwd_plain)]
    # out and ss written
    work = least_time(cross_cost(B, D, NL, residuals=True))
    fwd = report_kernel(
        "dcn_cross_stack", "news_recsys_tpu_torch/csrc/dcn_cross.cu",
        "news_recsys_tpu/ops/dcn_kernel.py:51", fwd_err, f"out and ss, tol {DCN_TOL}", t, calls,
        "cuda_graph", f"{shape} residuals", work, mode="residuals for the backward (ss)")

    bwd_args = (x0, ws, bs, ss, g)                  # the forward kernel's own ss
    with torch.no_grad():
        got, want = dcn_cross_bwd(*bwd_args), cross_bwd_rebuild_plain(*bwd_args)
        again = dcn_cross_bwd(*bwd_args)
    torch.cuda.synchronize()
    bwd_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    bwd_scale = max(float(b.abs().max()) for b in want)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=BWD_RTOL, atol=1e-5 * float(b.abs().max()))
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"dcn_cross_bwd [{shape}]: two runs gave different bits")
    if not all(torch.equal(a, b) for a, b in zip(got, graph_replay(dcn_cross_bwd, *bwd_args))):
        raise AssertionError(f"dcn_cross_bwd [{shape}]: a CUDA-graph replay differs from an "
                             "eager call")
    plan = _plan(x0, NL, _aligned(x0, ws, bs, g), True)
    log(f"  dcn_cross_bwd [{shape}]: plan {plan._asdict()}")
    with torch.no_grad():
        kernel = lambda: dcn_cross_bwd(*bwd_args)                                # noqa: E731
        plain = lambda: cross_bwd_rebuild_plain(*bwd_args)                       # noqa: E731
        t = [device_ms(f) for f in (plain, kernel, kernel, plain)]
        calls = [call_ms(f) for f in (kernel, plain)]
        # x0, g, ss, ws and bs read, dx0, dws and dbs written
        bwd = report_kernel(
            "dcn_cross_bwd", "news_recsys_tpu_torch/csrc/dcn_cross_bwd.cu",
            "news_recsys_tpu/ops/dcn_kernel.py:102", bwd_err,
            f"rtol {BWD_RTOL}, atol 1e-5 of the largest gradient, {bwd_scale:.4g}; two runs "
            f"bit-identical, a graph replay too", t, calls, "cuda_graph", shape,
            least_time(cross_bwd_cost(B, D, NL)))
    return fwd, bwd


def capture(fn, *args):
    """``fn(*args)`` captured in a CUDA graph after a warm-up call on a side
    stream: (the graph, its outputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.no_grad(), torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph):
        out = fn(*args)
    return graph, out


def graph_replay(fn, *args):
    """``fn(*args)`` captured in a CUDA graph and replayed once; returns the
    graph's outputs."""
    graph, out = capture(fn, *args)
    graph.replay()
    torch.cuda.synchronize()
    return out


# the device kernels one call of the cross backward runs at batch 512: the
# per-row kernel and the sum of its block partials (by dependent launch)
CROSS_BWD_KERNELS = ("dcn_cross_bwd_rows_kernel", "dcn_cross_bwd_sum_kernel")


def trace_cross_bwd(dev) -> int:
    """The device kernels of one CUDA-graph replay of the DCN training path's
    cross backward (batch 512, D 112, 3 layers), from a ``torch.profiler``
    trace: fails unless it ran each of CROSS_BWD_KERNELS once and nothing
    else; returns how many kernels ran. Run after every timed phase, so no
    timing runs with the profiler set up."""
    from news_recsys_tpu_torch.ops.dcn_kernel import _cross_fwd_kernel, dcn_cross_bwd

    x0, ws, bs, g = cross_case(TRAIN_BATCH, SEED + 7, dev)
    with torch.no_grad():
        ss = _cross_fwd_kernel(x0, ws, bs, residuals=True)[1]
    graph, _ = capture(dcn_cross_bwd, x0, ws, bs, ss, g)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    ran = {e.key: e.count for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA}
    log(f"  dcn_cross_bwd [B={TRAIN_BATCH}], one graph replay traced: {ran}")
    if (sorted(ran.values()) != [1, 1]
            or not all(any(k in key for key in ran) for k in CROSS_BWD_KERNELS)):
        raise AssertionError(f"dcn_cross_bwd: a graph replay ran {ran}, not "
                             f"{' and '.join(CROSS_BWD_KERNELS)} once each")
    return sum(ran.values())


def scatter_cases() -> dict:
    """The row scatter's shapes on the main paths, by label: a DCN step's
    arena (1,024 slots), its two shards of 79,680 rows at (data 1, model 2)
    (the same slots translated into each; the parallel phase), the sparse attention step's item and user tables
    (16,384 joint slots of one seeded ``zoo.attention_arrays`` batch of 512)
    and the rowwise DSSM step's (D 16, 16,384 joint slots of a
    :func:`dssm_arrays` batch of 512)."""
    from news_recsys_tpu_torch.training.scatter_layouts import (arena_scatter_case,
                                                                arena_shard_scatter_case,
                                                                attention_scatter_layouts,
                                                                dssm_scatter_layouts)
    from news_recsys_tpu_torch.zoo import attention_arrays, attention_config
    cases = {"arena": arena_scatter_case(SEED + 18, 2 * TRAIN_BATCH)}
    for shard in range(2):
        cases[f"arena shard {shard} of 2"] = arena_shard_scatter_case(SEED + 18, shard,
                                                                      slots=2 * TRAIN_BATCH)
    layouts = attention_scatter_layouts(attention_config(batch_size=TRAIN_BATCH),
                                        attention_arrays(TRAIN_BATCH, seed=SEED + 19), SEED + 19)
    for t, case in layouts.items():
        cases[f"attention {t}"] = case
    layouts = dssm_scatter_layouts(dssm_config("rowwise_adagrad"),
                                   dssm_arrays(TRAIN_BATCH, SEED + 27), SEED + 27)
    for t, case in layouts.items():
        cases[f"dssm {t}"] = case
    return cases


def check_scatter(dev) -> list:
    """The row scatter at every shape of :func:`scatter_cases`: the kernel
    against the plain version bit for bit (two runs of it too), each table
    written from the same start; times of plain, kernel and ``index_copy_``."""
    from news_recsys_tpu_torch.ops.scatter_rows import (scatter_cost, scatter_rows_plain,
                                                        scatter_rows_set)
    from news_recsys_tpu_torch.training.scatter_layouts import scatter_layout_stats

    out = []
    for label, (table_np, rows_np, vals_np) in scatter_cases().items():
        table, rows, vals = (torch.from_numpy(a).to(dev) for a in (table_np, rows_np, vals_np))
        (V, D), S = table.shape, rows.shape[0]
        stats = scatter_layout_stats(rows_np, V)
        with torch.no_grad():
            t_plain = scatter_rows_plain(table.clone(), rows, vals)
            t_kernel = scatter_rows_set(table.clone(), rows, vals)
            t_again = scatter_rows_set(table.clone(), rows, vals)
        torch.cuda.synchronize()
        for what, got in (("the kernel", t_kernel), ("a second run", t_again)):
            if not torch.equal(got, t_plain):
                raise AssertionError(f"scatter_rows_set [{label}]: {what}'s table differs "
                                     f"from the plain version's")
        err = float((t_kernel - t_plain).abs().max())
        kernel = lambda: scatter_rows_set(t_kernel, rows, vals)                 # noqa: E731
        plain = lambda: scatter_rows_plain(t_plain, rows, vals)                 # noqa: E731
        inside = torch.from_numpy((rows_np >= 0) & (rows_np < V)).to(dev)
        rows64, vals_in = rows.long()[inside], vals[inside]
        with torch.no_grad():
            t = [device_ms(f) for f in (plain, kernel, kernel, plain)]
            calls = [call_ms(f) for f in (kernel, plain)]
            # the one call that writes table[rows] = vals, on the slots inside
            # the table (a shard's; the others are dropped)
            library = device_ms(lambda: t_plain.index_copy_(0, rows64, vals_in))
        log(f"  scatter [{label}]: {stats}")
        out.append(report_kernel(
            "scatter_rows_set", "news_recsys_tpu_torch/csrc/scatter_rows.cu",
            "news_recsys_tpu/ops/scatter_rows.py:68", err, "bit-identical; two runs too", t,
            calls, "cuda_graph", f"{label}: V={V} D={D} S={S}",
            # rows read once; of vals the row of one slot a distinct row (the
            # contract makes the others copies of it); a row written a distinct row
            least_time(scatter_cost(S, D, stats["distinct_rows"])), library,
            case=label, **stats))
    return out


def block_case(B: int, seed: int, dev) -> tuple:
    """(params, x, mask, dy) of the attention ranker's block at batch ``B``:
    ~25% invalid keys, a few examples with no valid key, torch-default
    weights and LayerNorm scales around 1."""
    rng = np.random.default_rng(seed)
    L, D, F = BLOCK_L, BLOCK_D, BLOCK_F
    x = rng.standard_normal((B, L, D)).astype(np.float32)
    mask = (rng.random((B, L)) > 0.25).astype(np.float32)
    mask[1::97] = 0.0
    shapes = ((D, 3 * D), (3 * D,), (D, D), (D,), (D,), (D,), (D, F), (F,), (F, D), (D,), (D,),
              (D,))
    fan_in = (D, D, D, D, 0, 0, D, D, F, F, 0, 0)
    params = [(rng.uniform(-1, 1, sh) / np.sqrt(f) if f else 0.1 * rng.standard_normal(sh))
              .astype(np.float32) for sh, f in zip(shapes, fan_in)]
    params[4] += 1.0
    params[10] += 1.0
    dy = rng.standard_normal((B, L, D)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (*params, x, mask, dy))


def block_work(B: int, backward: bool, route: str) -> dict:
    """The bound of the block at batch ``B`` (``block_cost`` and
    ``block_bwd_cost`` of ``ops/fused_attention.py``). The tiled route's
    products run on the tensor cores: its bound uses the TF32 peak."""
    from news_recsys_tpu_torch.ops.fused_attention import (block_bwd_cost, block_cost,
                                                           route_units)
    cost = (block_bwd_cost if backward else block_cost)(B, BLOCK_L, BLOCK_D, BLOCK_F,
                                                        route_units(route))
    return least_time(cost)


BLOCK_SOURCES = {"general": "news_recsys_tpu_torch/csrc/fused_attention.cu",
                 "tiled": "news_recsys_tpu_torch/csrc/fused_attention_tiled_{}.cu"}


def block_routes(B: int, backward: bool, dev) -> dict:
    """What the block's entry says of its routes at batch ``B``: the route
    the wrapper takes with no keyword (the timed launch) and its source."""
    from news_recsys_tpu_torch.ops.fused_attention import plan_shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = plan_shape(B, BLOCK_L, BLOCK_D, BLOCK_F, BLOCK_H, sms, backward)
    if plan.route != "tiled":
        raise AssertionError(f"the ranker's block must take the tiled route, got {plan}")
    log(f"  fused block {'backward' if backward else 'forward'} [B={B}]: plan {plan}")
    return {"kernel_route": plan.route,
            "source": BLOCK_SOURCES[plan.route].format("bwd" if backward else "fwd"),
            "general_source": BLOCK_SOURCES["general"]}


def encoder_layer(params, device):
    """``torch.nn.TransformerEncoderLayer`` with the block's weights:
    post-norm, ReLU, ``layer_norm_eps`` 1e-6, dropout 0."""
    D, F = BLOCK_D, BLOCK_F
    wqkv, bqkv, wo, bo, g1, b1, w1, c1, w2, c2, g2, b2 = params
    layer = torch.nn.TransformerEncoderLayer(D, BLOCK_H, F, dropout=0.0, activation="relu",
                                             layer_norm_eps=1e-6, batch_first=True,
                                             norm_first=False, device=device)
    with torch.no_grad():
        for dst, src in ((layer.self_attn.in_proj_weight, wqkv.t()),
                         (layer.self_attn.in_proj_bias, bqkv),
                         (layer.self_attn.out_proj.weight, wo.t()),
                         (layer.self_attn.out_proj.bias, bo), (layer.norm1.weight, g1),
                         (layer.norm1.bias, b1), (layer.linear1.weight, w1.t()),
                         (layer.linear1.bias, c1), (layer.linear2.weight, w2.t()),
                         (layer.linear2.bias, c2), (layer.norm2.weight, g2),
                         (layer.norm2.bias, b2)):
            dst.copy_(src)
    return layer


def encoder_layer_ms(params, x, mask) -> float:
    """Device time (CUDA graph replays, as every other ``library_ms``) of
    :func:`encoder_layer` on the same inputs in eval mode, with
    ``src_key_padding_mask``. A yardstick only: it gives NaN or zeros where
    an example has no valid key, and nothing in the port calls it."""
    layer = encoder_layer(params, x.device).eval()
    padding = mask == 0
    with torch.inference_mode():
        return device_ms(lambda: layer(x, src_key_padding_mask=padding), **DEEP)


def encoder_layer_bwd_ms(params, x, mask, dy) -> float:
    """Device time of the backward of :func:`encoder_layer` in train mode on
    the same inputs: ``torch.autograd.grad`` of its output (``dy`` upstream)
    with respect to x and its 12 parameters, the forward run once outside the
    timing. Graph replays like every ``library_ms``, the forward and the
    capture on one stream (autograd runs a backward kernel on its forward's
    stream). A yardstick only, NaN where an example has no valid key: nothing
    in the port calls it."""
    layer = encoder_layer(params, x.device).train()
    xg = x.detach().clone().requires_grad_()
    inputs = (xg, *layer.parameters())
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        out = layer(xg, src_key_padding_mask=mask == 0)
    return device_ms(lambda: torch.autograd.grad(out, inputs, dy, retain_graph=True),
                     stream=stream, **DEEP)


def pool_bwd_case(V: int, L: int, B: int, skewed: bool, seed: int) -> tuple:
    """(ids (B, L) int32, mask, the longest run of one id) for the pool's
    backward: ragged lengths, one example masked out, and ids either uniform
    over the table or from a Zipf law (exponent 1.05, folded into the
    table), whose most frequent id takes about one valid slot in 20, as
    popular items and entities do. The first design's kernel walked a run of
    equal ids with D threads, so its time followed the longest run; the
    current one's should not."""
    rng = np.random.default_rng(seed)
    if skewed:
        ids = (1 + (rng.zipf(1.05, (B, L)) - 1) % (V - 65)).astype(np.int32)
    else:
        ids = rng.integers(1, V - 64, (B, L)).astype(np.int32)
    lengths = rng.integers(0, L + 1, B)
    lengths[:3] = (0, 1, L)
    ids[np.arange(L)[None, :] >= lengths[:, None]] = 0
    mask = (ids != 0).astype(np.float32)
    mask[5] = 0.0
    longest = int(np.bincount(ids[ids > 0]).max())
    return ids, mask, longest


def embedding_bag_bwd_ms(ids, mask, g, V: int, want) -> tuple:
    """(device ms, how it was timed) of the one PyTorch call that computes the
    pool backward's table gradient: the backward of ``F.embedding_bag(mode=
    "sum", per_sample_weights=)`` alone (``aten::_embedding_bag_dense_backward``,
    the node autograd runs), its forward run once outside the timing. Graph
    replays like every ``library_ms``; if that call cannot be captured in a
    graph, CUDA events around eager calls (host overhead included then). A
    yardstick only: nothing in the port calls it."""
    from news_recsys_tpu_torch.ops.fused_lookup_pool import EPS
    B, L = ids.shape
    aten = torch.ops.aten
    table = torch.zeros((V, g.shape[1]), device=g.device, requires_grad=True)
    valid = mask * (ids != 0)
    weights = (valid / (valid.sum(dim=1, keepdim=True) + EPS)).reshape(-1)     # the mean's share
    flat, offsets = ids.long().reshape(-1), torch.arange(0, B * L, L, device=g.device)
    try:
        with torch.no_grad():
            _, offset2bag, bag_size, max_indices = aten._embedding_bag(
                table, flat, offsets, False, 0, False, weights, False, -1)
            backward = lambda: aten._embedding_bag_dense_backward(               # noqa: E731
                g, flat, offset2bag, bag_size, max_indices, V, False, 0, weights, -1)
            torch.testing.assert_close(backward(), want, **scaled_tol(want))
            return device_ms(backward, **DEEP), "cuda_graph"
    except (RuntimeError, TypeError) as e:
        torch.cuda.synchronize()
        log(f"  embedding_bag's backward op alone failed or is not capturable "
            f"({str(e).splitlines()[0][:80]}): autograd's call timed with CUDA events")
    pooled = torch.nn.functional.embedding_bag(flat, table, offsets, mode="sum",
                                               per_sample_weights=weights)
    backward = lambda: torch.autograd.grad(pooled, table, g, retain_graph=True)[0]  # noqa: E731
    torch.testing.assert_close(backward(), want, **scaled_tol(want))
    return call_ms(backward, **DEEP), "events"


# The pool's shapes (V, L, B), D 16: the recall's user tower pools the DSSM
# ``hist`` over the item table for every request (1,024 and 64 users), the
# all-dense attention step pools ``entities`` at batch 512; the backward runs
# at the two training shapes (``entities``; ``hist``, where item 6's DSSM
# training will take it).
POOL_D = 16
POOL_FWD_SHAPES = {"at_entities_shape": (30080, 5, TRAIN_BATCH),
                   "at_64_users": (65280, 30, USERS_PER_REQUEST)}
POOL_BWD_SHAPES = ((30080, 5), (65280, 30))


def pool_fwd_case(V: int, L: int, B: int, skewed: bool, seed: int, dev) -> tuple:
    """(table, ids, mask, longest run) on ``dev``: the ids and mask of
    :func:`pool_bwd_case` and a seeded (V, POOL_D) table, row 0 zero."""
    ids, mask, longest = pool_bwd_case(V, L, B, skewed, seed)
    table = np.random.default_rng(seed + 1).standard_normal((V, POOL_D)).astype(np.float32)
    table[0] = 0
    return (*(torch.from_numpy(a).to(dev) for a in (table, ids, mask)), longest)


POOL_KEYS = ("shape", "ids", "longest_run", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms", "call_ms", "path")


def check_pool_forward(dev) -> dict:
    """The pool's forward against ``reference_lookup_pool``, and its time
    beside the plain version's and ``embedding_bag``'s: the
    entry is a 1,024-user request's ``hist`` (65,280 x 16, L 30, the ids of
    earlier runs' entry); Zipf ids, and the ``entities`` and 64-user shapes on
    uniform and Zipf ids, ride along."""
    from news_recsys_tpu_torch.ops.fused_lookup_pool import (fused_lookup_pool, pool_cost,
                                                             reference_lookup_pool)

    rng = np.random.default_rng(SEED)
    V, L, B = 65280, 30, 1024
    table = rng.standard_normal((V, POOL_D), np.float32)
    table[0] = 0
    ids = rng.integers(1, 65239, (B, L)).astype(np.int32)
    lengths = rng.integers(0, L + 1, B)
    lengths[:4] = (0, 1, L, L)
    mask = (np.arange(L)[None, :] < lengths[:, None]).astype(np.float32)
    ids[mask == 0] = 0
    ids[3, ::3] = 0                      # padding inside an unmasked row
    longest = int(np.bincount(ids[(mask > 0) & (ids > 0)]).max())
    main = (*(torch.from_numpy(a).to(dev) for a in (table, ids, mask)), longest)
    cases = {("entry", False): main}
    cases[("entry", True)] = pool_fwd_case(V, L, B, True, SEED + 50, dev)
    for key, (Vc, Lc, Bc) in POOL_FWD_SHAPES.items():
        for skewed in (False, True):
            cases[(key, skewed)] = pool_fwd_case(Vc, Lc, Bc, skewed, SEED + 51 + Lc + Bc, dev)
    entries = {}
    for (key, skewed), (table, ids, mask, longest) in cases.items():
        (Vc, D), (Bc, Lc) = table.shape, ids.shape
        args = (table, ids, mask)
        weights = mask * (ids != 0)
        ids64 = ids.long()
        with torch.inference_mode():
            got, want = fused_lookup_pool(*args), reference_lookup_pool(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **POOL_TOL)
            t = [device_ms(lambda: f(*args)) for f in (reference_lookup_pool, fused_lookup_pool,
                                                      fused_lookup_pool, reference_lookup_pool)]
            calls = [call_ms(lambda: f(*args)) for f in (fused_lookup_pool,
                                                         reference_lookup_pool)]
            # the gather and the weighted sum in one call; the division is left out
            library = device_ms(lambda: torch.nn.functional.embedding_bag(
                ids64, table, mode="sum", per_sample_weights=weights))
        # the pool reads every distinct row its slots point at once, and the ids and mask
        rows = int(torch.unique(ids[weights > 0]).numel())
        kind = "zipf" if skewed else "uniform"
        entries[key, skewed] = report_kernel(
            "fused_lookup_pool", "news_recsys_tpu_torch/csrc/lookup_pool.cu",
            "news_recsys_tpu/ops/fused_lookup_pool.py:71", float((got - want).abs().max()),
            f"tol {POOL_TOL}", t, calls, "cuda_graph",
            f"V={Vc} D={D} B={Bc} L={Lc} ids={kind} longest_run={longest}",
            least_time(pool_cost(Bc, Lc, D, rows)), library,
            ids=kind, longest_run=longest,
            # rows of at most 8 slots keep the first design's loop (csrc/lookup_pool.cu)
            path="short-row loop" if Lc <= 8 else "every load in flight")
    entry = entries["entry", False]
    entry["zipf_ids"] = {k: entries["entry", True][k] for k in POOL_KEYS}
    for key in POOL_FWD_SHAPES:
        entry[key] = {k: entries[key, False][k] for k in POOL_KEYS}
        entry[key]["zipf_ids"] = {k: entries[key, True][k] for k in POOL_KEYS}
    return entry


def check_pool_backward(dev) -> dict:
    """The pool's backward against ``pool_bwd_plain`` (two runs bit-identical)
    and its time beside the plain version's and ``embedding_bag``'s
    backward, at ``entities`` (30,080 x 16, L 5; the entry) and the DSSM
    ``hist`` (65,280 x 16, L 30) at batch 512, each on skewed (Zipf) and on
    uniform ids."""
    from news_recsys_tpu_torch.ops.fused_lookup_pool import (fused_lookup_pool_bwd,
                                                             pool_bwd_cost, pool_bwd_plain)

    B, entries = TRAIN_BATCH, {}
    for V, L in POOL_BWD_SHAPES:
        for skewed in (True, False):
            ids, mask, longest = pool_bwd_case(V, L, B, skewed, SEED + 30 + L)
            g = torch.from_numpy(np.random.default_rng(SEED + 40 + L)
                                 .standard_normal((B, POOL_D)).astype(np.float32)).to(dev)
            ids, mask = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
            kernel = lambda: fused_lookup_pool_bwd(ids, mask, g, V)             # noqa: E731
            plain = lambda: pool_bwd_plain(ids, mask, g, V)                     # noqa: E731
            got, want, second = kernel(), plain(), kernel()
            torch.cuda.synchronize()
            tol = scaled_tol(want)
            torch.testing.assert_close(got, want, **tol)
            if not torch.equal(got, second):
                raise AssertionError("fused_lookup_pool_bwd: two runs gave different bits")
            t = [device_ms(f, **DEEP) for f in (plain, kernel, kernel, plain)]
            calls = [call_ms(f, **DEEP) for f in (kernel, plain)]
            library_ms, library_timing = embedding_bag_bwd_ms(ids, mask, g, V, want)
            kind = "zipf" if skewed else "uniform"
            entries[L, skewed] = report_kernel(
                "fused_lookup_pool_bwd", "news_recsys_tpu_torch/csrc/lookup_pool_bwd.cu",
                "news_recsys_tpu/ops/fused_lookup_pool.py:127", float((got - want).abs().max()),
                f"tol {tol}; two runs bit-identical", t, calls,
                "cuda_graph", f"V={V} D={POOL_D} B={B} L={L} ids={kind} longest_run={longest}",
                least_time(pool_bwd_cost(B, L, POOL_D, V)),
                library_ms, library_timing=library_timing, ids=kind, longest_run=longest)
    # the entry is the skewed case at the shape the all-dense path gives the
    # kernel (``entities``); the uniform case and the DSSM ``hist`` shape ride along
    keys = (*POOL_KEYS[:-1], "library_timing")
    main = entries[5, True]
    main["uniform_ids"] = {k: entries[5, False][k] for k in keys}
    main["at_hist_shape"] = {k: entries[30, True][k] for k in keys}
    main["at_hist_shape"]["uniform_ids"] = {k: entries[30, False][k] for k in keys}
    return main


# NRMS's attention at the training cell's shapes: the news encoder's 64 x 55
# titles of 30 words, the user encoder's 64 histories of 50; 16 heads of 16
MHSA_SHAPES = {"news": (64 * 55, 30), "user": (64, 50)}
MHSA_HEADS, MHSA_HEAD_DIM = 16, 16
MHSA_TOL = 1e-5                    # rtol, and atol of the largest value


def mhsa_case(N: int, L: int, seed: int, dev) -> tuple:
    """qkv N(0, 1) (scores of order 1), dO, and the mask of the training
    cell's slots: news rows half padding slots (no kept key), the rest
    titles of 1 + Binomial(29, 10/29) words; histories of 0 to L clicks."""
    rng = np.random.default_rng(seed)
    H, hd = MHSA_HEADS, MHSA_HEAD_DIM
    qkv = torch.from_numpy(rng.standard_normal((N, L, 3 * H * hd), np.float32)).to(dev)
    g = torch.from_numpy(rng.standard_normal((N, L, H * hd), np.float32)).to(dev)
    if L == MHSA_SHAPES["news"][1]:
        n = np.where(rng.random(N) < 0.5, 0, 1 + rng.binomial(L - 1, 10 / 29, N))
    else:
        n = rng.integers(0, L + 1, N)
    mask = torch.from_numpy(np.arange(L)[None, :] < n[:, None]).to(dev)
    return qkv, mask, g


def sdpa_views(qkv, H: int):
    N, L, width = qkv.shape
    return qkv.view(N, L, 3, H, width // (3 * H)).permute(2, 0, 3, 1, 4)


def sdpa_ms(qkv, mask, g=None) -> float:
    """Device time of ``F.scaled_dot_product_attention`` on the same q, k, v
    views with the mask as ``attn_mask``: the forward, or (``g``) its backward
    by ``torch.autograd.grad`` after one forward outside the timing, on the
    forward's stream. A yardstick only: nothing in the port calls it."""
    import torch.nn.functional as F

    attn_mask = mask[:, None, None, :]
    if g is None:
        q, k, v = sdpa_views(qkv, MHSA_HEADS)
        with torch.inference_mode():
            return device_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask),
                             **DEEP)
    x = qkv.detach().clone().requires_grad_()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        q, k, v = sdpa_views(x, MHSA_HEADS)
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
        dy = g.view(*g.shape[:2], MHSA_HEADS, -1).transpose(1, 2)
    return device_ms(lambda: torch.autograd.grad(out, x, dy, retain_graph=True), stream=stream,
                     **DEEP)


def check_mhsa_kernels(dev) -> list:
    """``masked_mhsa`` and its backward at the news and the user encoder's
    shapes against the plain chain, two runs bit-identical; device times of
    kernel, plain and ``F.scaled_dot_product_attention``. Returns the two
    entries (the news shape's, the user shape's under ``at_user_shape``)."""
    from news_recsys_tpu_torch.ops.mhsa import (masked_mhsa, masked_mhsa_bwd,
                                                masked_mhsa_bwd_plain, masked_mhsa_plain,
                                                mhsa_bwd_cost, mhsa_cost, plan_mhsa)
    H, hd = MHSA_HEADS, MHSA_HEAD_DIM
    source = "news_recsys_tpu_torch/csrc/nrms_attention.cu"
    entries = {}
    for part, (N, L) in MHSA_SHAPES.items():
        qkv, mask, g = mhsa_case(N, L, SEED + 40 + L, dev)
        log(f"  masked_mhsa [{part}: N={N} L={L}]: plan {plan_mhsa(N, L, H, hd)._asdict()}; "
            f"rows with no kept key {int((~mask.any(dim=1)).sum())} of {N}")
        cases = (("masked_mhsa", lambda: masked_mhsa(qkv, mask, H),
                  lambda: masked_mhsa_plain(qkv, mask, H), mhsa_cost, None),
                 ("masked_mhsa_bwd", lambda: masked_mhsa_bwd(qkv, mask, g, H),
                  lambda: masked_mhsa_bwd_plain(qkv, mask, g, H), mhsa_bwd_cost, g))
        for name, kernel, plain, cost, upstream in cases:
            with torch.inference_mode(upstream is None):
                got, again, want = kernel(), kernel(), plain()
                torch.cuda.synchronize()
                tol = dict(rtol=MHSA_TOL, atol=MHSA_TOL * max(1.0, float(want.abs().max())))
                torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{name} [{part}]: {m}")
                if not torch.equal(got, again):
                    raise AssertionError(f"{name} [{part}]: two runs gave different bits")
                t = [device_ms(f, **DEEP) for f in (plain, kernel, kernel, plain)]
                calls = [call_ms(f, **DEEP) for f in (kernel, plain)]
            entry = report_kernel(
                name, source, "none: NRMS has no JAX counterpart", float((got - want).abs().max()),
                f"rtol {MHSA_TOL}, atol {MHSA_TOL} of the largest value; two runs bit-identical",
                t, calls, "cuda_graph", f"N={N} L={L} H={H} hd={hd}",
                least_time(cost(N, L, H, hd)), sdpa_ms(qkv, mask, upstream))
            if part == "news":
                entries[name] = entry
            else:
                entries[name]["at_user_shape"] = {k: entry[k] for k in SHAPE_KEYS}
    return list(entries.values())


BLOCK_LARGE_BATCH = 2048          # the block of ``attention@b2048``
BLOCK_SHAPE_KEYS = SHAPE_KEYS + ("peak_flops", "kernel_route", "general_ms",
                                 "general_max_abs_err")


def check_attention_kernels(dev) -> list:
    """The fused block's kernels at their paths' shapes: the forward at batch
    6,400 (a served request), 512 (a training step) and 2,048 (a step of the
    large batch), the backward at 512 and 2,048 (dx and all 12 parameter
    gradients, two runs bit-identical)."""
    from news_recsys_tpu_torch.ops.fused_attention import block_plain, fused_transformer_block

    shape = f"L={BLOCK_L} D={BLOCK_D} H={BLOCK_H} F={BLOCK_F}"
    out, nested = [], {}
    for B in (USERS_PER_REQUEST * FETCH, TRAIN_BATCH, BLOCK_LARGE_BATCH):
        *params, x, mask, dy = block_case(B, SEED + 20 + B, dev)
        routes = block_routes(B, False, dev)
        kernel = lambda: fused_transformer_block(params, x, mask, BLOCK_H)      # noqa: E731
        general = lambda: fused_transformer_block(params, x, mask, BLOCK_H,     # noqa: E731
                                                  route="general")
        plain = lambda: block_plain(x, mask, *params, num_heads=BLOCK_H)        # noqa: E731
        with torch.inference_mode():
            got, got_general, want = kernel(), general(), plain()
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **BLOCK_FWD_TOL)
            torch.testing.assert_close(got_general, want, **BLOCK_FWD_TOL)
            err, general_err = (float((g - want).abs().max()) for g in (got, got_general))
            t = [device_ms(f, **DEEP) for f in (plain, general, kernel, kernel, general, plain)]
            calls = [call_ms(f, **DEEP) for f in (kernel, plain)]
        source = routes.pop("source")
        entry = report_kernel("fused_transformer_block", source,
                              "news_recsys_tpu/ops/fused_attention.py:307", err,
                              f"tol {BLOCK_FWD_TOL}", [t[0], t[2], t[3], t[5]], calls,
                              "cuda_graph", f"B={B} {shape}",
                              block_work(B, False, routes["kernel_route"]),
                              encoder_layer_ms(params, x, mask), **routes,
                              general_ms=(t[1] + t[4]) / 2, general_max_abs_err=general_err)
        log(f"  route {routes['kernel_route']} {entry['ms'] * 1e3:.2f} us; the general route at "
            f"the same shape {entry['general_ms'] * 1e3:.2f} us, max_abs_err {general_err:.3e}")
        if out:
            nested[B] = {k: entry[k] for k in BLOCK_SHAPE_KEYS}
        else:
            out.append(entry)
    out[0]["at_train_shape"] = nested[TRAIN_BATCH]
    out[0]["at_b2048"] = nested[BLOCK_LARGE_BATCH]
    out.append(block_bwd_entry(TRAIN_BATCH, dev))
    # at 2,048 examples some pre-activation of the feed-forward lies within
    # rounding of the ReLU's kink (|z| 2.0e-7 in example 10 of this seeded
    # case), where rounding picks the gate and with it the example's whole
    # gradient: those examples' upstream gradients are zeroed, as
    # tests/test_torch_cuda.py::mute_relu_kinks does
    big = block_bwd_entry(BLOCK_LARGE_BATCH, dev, mute_kinks=True)
    out[-1]["at_b2048"] = {k: v for k, v in big.items()
                           if k in BLOCK_SHAPE_KEYS + ("kink_examples_muted",)}
    return out


KINK_MARGIN = 1e-5


def kink_examples(params, x, mask) -> torch.Tensor:
    """(B,) the examples in which a pre-activation of the block's
    feed-forward, as the plain version computes it, lies within
    ``KINK_MARGIN`` of the ReLU's kink."""
    from news_recsys_tpu_torch.ops.fused_attention import layer_norm_plain, mhsa_plain
    wqkv, bqkv, wo, bo, g1, b1, w1, c1 = params[:8]
    y1 = layer_norm_plain(x + mhsa_plain(x, mask, wqkv, bqkv, wo, bo, BLOCK_H), g1, b1)
    return ((y1 @ w1 + c1).abs() < KINK_MARGIN).flatten(1).any(dim=1)


def block_bwd_entry(B: int, dev, mute_kinks: bool = False) -> dict:
    """The block's backward at batch ``B`` (the forward's inputs at that
    batch, an upstream gradient): both routes held to ``block_bwd_plain``,
    two runs bit-identical; the entry of the timed (default) route. With
    ``mute_kinks`` the upstream gradient is zeroed in the examples of
    :func:`kink_examples` (at most one in 20)."""
    from news_recsys_tpu_torch.ops.fused_attention import (PARAM_NAMES, block_bwd_plain,
                                                           fused_transformer_block_bwd)

    shape = f"L={BLOCK_L} D={BLOCK_D} H={BLOCK_H} F={BLOCK_F}"
    *params, x, mask, dy = block_case(B, SEED + 20 + B, dev)
    muted = {}
    if mute_kinks:
        with torch.no_grad():
            near = kink_examples(params, x, mask)
        if int(near.sum()) > B // 20:
            raise AssertionError(f"block [B={B}]: {int(near.sum())} examples near a kink")
        dy = torch.where(near[:, None, None], torch.zeros_like(dy), dy)
        muted = {"kink_examples_muted": int(near.sum())}
        log(f"  fused block backward [B={B}]: upstream gradient zeroed in {int(near.sum())} "
            f"examples near the ReLU's kink (|z| < {KINK_MARGIN})")
    routes = block_routes(B, True, dev)
    kernel = lambda: fused_transformer_block_bwd(params, x, mask, dy, BLOCK_H)  # noqa: E731
    general = lambda: fused_transformer_block_bwd(params, x, mask, dy, BLOCK_H,  # noqa: E731
                                                  route="general")
    plain = lambda: block_bwd_plain(params, x, mask, dy, BLOCK_H)               # noqa: E731
    (want_dx, want_dparams), errs = plain(), []
    for fn in (kernel, general):
        (dx, dparams), (again_dx, again) = fn(), fn()
        torch.cuda.synchronize()
        errs.append(0.0)
        for name, a, b in zip(("dx", *PARAM_NAMES), (dx, *dparams), (want_dx, *want_dparams)):
            torch.testing.assert_close(a, b, rtol=BLOCK_GRAD_RTOL,
                                       msg=lambda m: f"{name} [B={B}]: {m}",
                                       atol=2e-5 * max(1.0, float(b.abs().max())))
            errs[-1] = max(errs[-1], float((a - b).abs().max()))
        if not (torch.equal(dx, again_dx)
                and all(torch.equal(a, b) for a, b in zip(dparams, again))):
            raise AssertionError(f"fused_transformer_block_bwd [B={B}]: two runs gave "
                                 "different bits")
    t = [device_ms(f, **DEEP) for f in (plain, general, kernel, kernel, general, plain)]
    calls = [call_ms(f, **DEEP) for f in (kernel, plain)]
    library_ms = encoder_layer_bwd_ms(params, x, mask, dy)
    source = routes.pop("source")
    entry = report_kernel(
        "fused_transformer_block_bwd", source, "news_recsys_tpu/ops/fused_attention.py:333",
        errs[0], f"rtol {BLOCK_GRAD_RTOL}, atol 2e-5 of each gradient's largest value; two runs "
        f"bit-identical", [t[0], t[2], t[3], t[5]], calls, "cuda_graph", f"B={B} {shape}",
        block_work(B, True, routes["kernel_route"]), library_ms, **routes,
        general_ms=(t[1] + t[4]) / 2, general_max_abs_err=errs[1], **muted)
    log(f"  route {routes['kernel_route']} {entry['ms'] * 1e3:.2f} us; the general route at the "
        f"same shape {entry['general_ms'] * 1e3:.2f} us, max_abs_err {errs[1]:.3e}")
    return entry


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


def recall_cut_tie(gpu, cpu, batch, r: int, histories: list) -> bool:
    """True when the two devices' recall candidates for user ``r`` differ
    only by items scored within ANSWER_TOL of the fetch cut. Both recall the
    whole request, as it was served: the card rounds a batch of one
    otherwise than a batch of 64 (cuBLAS picks another product)."""
    (g_ids, g_sc), (c_ids, c_sc) = (rec.recall.recommend(batch, k=FETCH, histories=histories)
                                    for rec in (gpu, cpu))
    g_ids, g_sc, c_ids, c_sc = g_ids[r], g_sc[r], c_ids[r], c_sc[r]
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
            if not recall_cut_tie(gpu, cpu, batch, r, req["histories"]):
                raise AssertionError(f"user {r}: card served {got}, CPU {want}")
            ties += 1
    log(f"card vs CPU: user embeddings max_abs_err {emb_err:.3e}, served sigmoid scores "
        f"max_abs_err {score_err:.3e} (tol {ANSWER_TOL}); users differing by a recall-cut "
        f"tie: {ties}")
    assert emb_err <= ANSWER_TOL and score_err <= ANSWER_TOL


def start_pytorch(dev: torch.device) -> float:
    """PyTorch's one-off costs on the card: the CUDA context, cuBLAS, and the
    modules that the first ``torch.autograd.grad`` and the first optimizer
    import (seconds, on a machine that keeps no bytecode cache). No kernel of
    the port is needed for them, so they are paid while ``nvcc`` runs."""
    t0 = time.perf_counter()
    w = torch.nn.Parameter(torch.ones(8, 8, device=dev))
    opt = torch.optim.AdamW([w])
    w.grad, = torch.autograd.grad((w @ w).sum(), w)
    opt.step()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def ptxas_report(report: str, part: str) -> dict:
    """{kernel: [registers, spilled bytes]} of the entry functions whose
    mangled name holds ``part``, from nvcc's ``-Xptxas=-v`` report."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            name = m.group(1)
            continue
        if name is None or part not in name:
            continue
        info = out.setdefault(name, [0, 0])
        m = re.search(r"Used (\d+) registers", line)
        if m:
            info[0] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            info[1] = int(m.group(1))
    return out


def build_kernels(dev: torch.device) -> None:
    """Build and load the kernels: ``nvcc`` on a thread (which waits for its
    subprocesses, one per source), PyTorch's start-up on this one meanwhile."""
    from news_recsys_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = []
    thread = threading.Thread(target=lambda: built.append(_build.build()))
    thread.start()
    start_s = start_pytorch(dev)
    thread.join()
    if not built:
        raise RuntimeError("the kernels did not build (nvcc's report is above)")
    lib = built[0]
    _build.library()
    report = (lib.parent / "build.log").read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", report)]
    spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill", report))
    log(f"build: {time.perf_counter() - t0:.2f} s (PyTorch's start-up on the card meanwhile: "
        f"{start_s:.2f} s) -> {lib}; ptxas: {len(regs)} kernels, "
        f"{min(regs)}-{max(regs)} registers, {spills} bytes spilled")
    for part in ("fm_bwd", "dcn_cross_bwd", "mhsa"):
        kernels = ptxas_report(report, part)
        log(f"  {part} kernels (registers, spilled bytes): " + "; ".join(
            f"{n[:70]} {r} {s}" for n, (r, s) in kernels.items()))


def ranker_config(ranker: str):
    """The ranker's full-width MIND config: DCN as zoo.mind_config("dcn")
    (the PR 1 cascade), the others as the scoreboard trains them."""
    from news_recsys_tpu_torch.zoo import mind_config, mind_ranker_config

    from news_recsys_tpu_torch.zoo import attention_config

    if ranker == "attention":
        return attention_config()
    return mind_config("dcn") if ranker == "dcn" else mind_ranker_config(ranker)


def train_config(ranker: str):
    """The ranker's full-width MIND training config at batch TRAIN_BATCH: DCN
    and ``attention`` as bench.py trains them (``mind_config("dcn")`` and
    ``attention_config()`` with rowwise AdaGrad), the others, ``attention@adamw``
    among them, as the scoreboard trains them."""
    from news_recsys_tpu_torch.zoo import mind_config, mind_ranker_config

    from news_recsys_tpu_torch.zoo import attention_config

    if ranker == "dcn":
        return mind_config("dcn", batch_size=TRAIN_BATCH, embedding_optimizer="rowwise_adagrad")
    if ranker == "attention":
        return attention_config(batch_size=TRAIN_BATCH)
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


def training_arrays(cfg, rows: int, seed: int) -> dict:
    """Synthetic rows for ``cfg``: :func:`ranking_arrays`, or for an attention
    config ``zoo.attention_arrays`` with every 50th history emptied, plus,
    for the scoreboard recipe, the two other sparse features and ragged
    ``entities`` of 5 over its 30,000-row table."""
    from news_recsys_tpu_torch.zoo import MIND_TABLE_SIZE, attention_arrays
    if cfg.name != "attention":
        return ranking_arrays(rows, seed)
    arrays = attention_arrays(rows, seed=seed)
    arrays["hist"][::50] = 0
    arrays["hist_mask"] = (arrays["hist"] != 0).astype(np.float32)
    if "entities" in cfg.features.array_feature_names:
        rng = np.random.default_rng(seed + 1000)
        for f in ("subcategory", "user_click_category"):
            arrays[f] = rng.integers(1, MIND_TABLE_SIZE[f], rows).astype(np.int32)
        n_ent = cfg.embeddings.embedding_table_size["entities"]
        L = cfg.features.array_max_length["entities"]
        entities = rng.integers(1, n_ent, (rows, L)).astype(np.int32)
        entities[np.arange(L)[None, :] >= rng.integers(0, L + 1, rows)[:, None]] = 0
        arrays["entities"] = entities
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

        cpu = timed(f"serve ({ranker}): the bundle loaded on the CPU", CascadeRecommender.load,
                    bundle, "cpu")
        timed(f"serve ({ranker}): card vs CPU", compare_with_cpu, gpu, cpu, reqs, answers)
    return launches


def compare_training_with_cpu(dev: torch.device, cfg, ds, n_steps: int = CHECK_STEPS) -> None:
    """``n_steps`` training steps (sparse, or all-dense for ``adamw``) on the
    card and on the CPU from the same seeded state and the same batches:
    every parameter (both take the same update route, so every table row) and
    accumulator within TRAIN_TOL."""
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.dense_step import init_dense_state, make_train_step
    from news_recsys_tpu_torch.training.sparse_step import (init_sparse_state,
                                                            make_sparse_train_step)
    from news_recsys_tpu_torch.training.trainer import AucHist, BatchPacker, unpack_batch

    dense = cfg.train_hparams.embedding_optimizer == "adamw"
    init, make_step = ((init_dense_state, make_train_step) if dense
                       else (init_sparse_state, make_sparse_train_step))
    cpu_model = build_ranker(cfg, seed=SEED + 5, device="cpu")
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to(dev)}
    states = {d: init(m, cfg) for d, m in models.items()}
    steps = {d: make_step(m, cfg) for d, m in models.items()}
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
    for n, acc in ({} if dense else states["cuda"].emb_acc).items():
        err["accumulators"] = max(err["accumulators"],
                                  float((acc.cpu() - states["cpu"].emb_acc[n]).abs().max()))
        torch.testing.assert_close(acc.cpu(), states["cpu"].emb_acc[n], msg=n, **TRAIN_TOL)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], **TRAIN_TOL)
    log(f"training {cfg.name} ({cfg.extra('dcn_cfg', {}) or ''}; "
        f"{cfg.train_hparams.embedding_optimizer}), card vs CPU after {n_steps} "
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
                  workdir=os.path.join(tmp, "cpu"), device="cpu")
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
    the kernel launches of that epoch. DCN's and the attention ranker's
    epochs train alone (``attention@adamw`` on the all-dense step, AdamW
    over the full tables); DeepFM's also validates on a dev set, checked
    against the CPU."""
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.trainer import PackedDataset, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False        # the card is held to the CPU
    cfg = train_config(ranker)
    dense = cfg.train_hparams.embedding_optimizer == "adamw"
    n_steps = (DENSE_STEPS if dense else
               TRAIN_STEPS if ranker == "attention" else EARLIER_TRAIN_STEPS)
    data_seed, seed = {"dcn": (SEED + 9, SEED + 6), "deepfm": (SEED + 10, SEED + 11),
                       "attention": (SEED + 14, SEED + 15)}.get(ranker, (SEED + 16, SEED + 17))
    arrays = training_arrays(cfg, TRAIN_BATCH * n_steps, data_seed)
    ds = PackedDataset(arrays)
    validate = ranker == "deepfm"
    dev_ds = PackedDataset(dev_arrays(arrays["user_id"], SEED + 12)) if validate else None
    warm = {int(u) for u in np.unique(arrays["user_id"])} if validate else None
    timed(f"train ({ranker}): {CHECK_STEPS} steps card vs CPU", compare_training_with_cpu, dev,
          cfg, ds)

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
        if first["steps"] != n_steps or not math.isfinite(first["train_loss"]):
            raise AssertionError(f"Trainer.fit: {first}")
        bad = [n for n, p in trainer.model.named_parameters() if not torch.isfinite(p).all()]
        if bad:
            raise AssertionError(f"Trainer.fit left non-finite parameters: {bad}")
        log(f"Trainer.fit ({ranker}) on {name}: tables {tables}; {n_steps} steps of batch "
            f"{TRAIN_BATCH}{' and a validation' if validate else ''} in {fit_s:.2f} s (first "
            f"epoch, warm-up included); train_loss {first['train_loss']:.6f}, train_auc "
            f"{first['train_auc']:.4f}; launches in that epoch: {launches}")
        if validate:
            check_validation(trainer, state, dev_ds, warm, tmp)
        _, warm_epoch = trainer.train_epoch(state, ds, epoch=1)
        if not math.isfinite(warm_epoch["train_loss"]):
            raise AssertionError(f"train_epoch: {warm_epoch}")
    rate = warm_epoch["examples_per_sec"]
    log(f"training throughput ({ranker}, {cfg.train_hparams.embedding_optimizer}) on {name} "
        f"({smi}): batch {TRAIN_BATCH}, a warm epoch of {warm_epoch['steps']} steps: "
        f"{rate / TRAIN_BATCH:.1f} steps/s ({TRAIN_BATCH / rate * 1e3:.3f} ms a step), "
        f"{rate:.0f} examples/s")
    return launches


NRMS_STEPS = 8


def nrms_arrays(cfg, rows: int, seed: int) -> tuple:
    """NRMS's title table (1 + Binomial(29, 10/29) words a title) and
    ``rows`` training rows (histories of 0 to 50 clicks, 1 + 4 candidates,
    the positive first)."""
    rng = np.random.default_rng(seed)
    c = cfg.extra("nrms_cfg")
    A, L, H = c["articles"], c["title_len"], c["history_len"]
    titles = rng.integers(1, c["vocab"], (A, L)).astype(np.int32)
    titles[np.arange(L)[None, :] > rng.binomial(L - 1, 10 / 29, A)[:, None]] = 0
    titles[0] = 0
    hist = rng.integers(1, A, (rows, H)).astype(np.int32)
    hist[np.arange(H)[None, :] >= rng.integers(0, H + 1, rows)[:, None]] = 0
    label = np.zeros((rows, 1 + c["npratio"]), np.float32)
    label[:, 0] = 1
    return titles, {"hist": hist, "label": label,
                    "item_id": rng.integers(1, A, (rows, 1 + c["npratio"])).astype(np.int32),
                    "user_id": np.arange(1, rows + 1, dtype=np.int32)}


def train_nrms_phase(dev: torch.device, name: str) -> dict:
    """NRMS_STEPS all-dense steps of NRMS at its published widths and the
    training cell's batch (64 rows of 1 + 4 candidates); returns their
    kernel launches: the attention's forward and backward once for each
    encoder a step."""
    from news_recsys_tpu_torch import zoo
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training import dense_step
    from news_recsys_tpu_torch.training.trainer import AucHist

    cfg = zoo.mind_nrms_config()
    B = cfg.dataset.batch_size
    titles, arrays = nrms_arrays(cfg, B * NRMS_STEPS, SEED + 50)
    batches = [{k: torch.from_numpy(arrays[k][i * B:(i + 1) * B]).to(dev)
                for k in ("hist", "item_id", "label")} for i in range(NRMS_STEPS)]
    model = build_ranker(cfg, seed=SEED + 51, device=dev)
    model.set_titles(torch.from_numpy(titles))
    state = dense_step.init_dense_state(model, cfg)
    step = dense_step.make_train_step(model, cfg)
    hist = AucHist.zeros(dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    losses = [step(state, b, hist)[0] for b in batches]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / NRMS_STEPS * 1e3
    launches = read_launches()
    losses = [float(x) for x in losses]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"NRMS steps: losses {losses}")
    log(f"NRMS on {name}: {NRMS_STEPS} steps of batch {cfg.dataset.batch_size}, {ms:.2f} ms a "
        f"step (the first included); losses {losses[0]:.6f} .. {losses[-1]:.6f}; launches "
        f"{launches}")
    return launches


def zoo_phase(dev: torch.device) -> dict:
    """ZOO_CHECK_STEPS steps of each other ranker of the zoo at its full
    width, card against CPU; returns the kernel launches of those steps."""
    from news_recsys_tpu_torch.training.trainer import PackedDataset
    from news_recsys_tpu_torch.zoo import mind_ranker_config

    reset_launches()
    for recipe in ("lr", "deep", "widedeep", "fm", "dcn@v2", "attention"):
        cfg = mind_ranker_config(recipe)
        ds = PackedDataset(training_arrays(cfg, TRAIN_BATCH * ZOO_CHECK_STEPS, SEED + 13))
        compare_training_with_cpu(dev, cfg, ds, n_steps=ZOO_CHECK_STEPS)
    return read_launches()


def dssm_config(optimizer: str = "adamw"):
    """configs/dssm.yaml (``zoo.mind_dssm_config()``: user 94,058 x 16, item
    65,239 x 16, ``hist`` of 30 over the item table, towers 48 ->
    128-128-64-16, rate 8, temperature 0.1, logQ) at batch TRAIN_BATCH, on
    ``optimizer``: the all-dense ``adamw`` as shipped, or ``rowwise_adagrad``
    on the user and item tables."""
    from news_recsys_tpu_torch.config import config_from_dict, config_to_dict
    from news_recsys_tpu_torch.zoo import mind_dssm_config

    raw = config_to_dict(mind_dssm_config())
    raw["train_hparams"]["embedding_optimizer"] = optimizer
    return config_from_dict(raw)


def dssm_arrays(rows: int, seed: int) -> dict:
    """Synthetic DSSM training rows: :func:`ranking_arrays`, every row a click
    (the shipped recipe trains on click positives only), and a click history
    ``hist`` of 0-30 items over the item table."""
    from news_recsys_tpu_torch.zoo import DSSM_HIST_LEN, MIND_TABLE_SIZE
    arrays = ranking_arrays(rows, seed)
    rng = np.random.default_rng(seed + 1000)
    hist = rng.integers(1, MIND_TABLE_SIZE["item_id"], (rows, DSSM_HIST_LEN)).astype(np.int32)
    hist[np.arange(DSSM_HIST_LEN)[None, :] >= rng.integers(0, DSSM_HIST_LEN + 1, rows)[:, None]] = 0
    arrays["hist"], arrays["hist_mask"] = hist, (hist != 0).astype(np.float32)
    arrays["label"][:] = 1.0
    return arrays


def compare_dssm_training_with_cpu(dev: torch.device, cfg, ds) -> None:
    """CHECK_STEPS DSSM steps on the card and on the CPU, the same batches and
    negative permutations, each step from the same state (the CPU's, copied
    to the card before it): the loss, every gradient (rtol 1e-5, atol 1e-5
    of the largest) and, after the step, every parameter and accumulator
    within TRAIN_TOL, but for the parameters whose AdamW second moment is
    positive and under ROUNDING_NU (AdamW's, or ``sparse_adamw``'s per
    table element). Those are the weights whose gradient
    was near rounding noise (|g| < ~1e-7 in every step so far): Adam's
    update, lr * g / (|g| + 1e-8), turns a 1e-9 difference between the
    card's and the CPU's sums into up to 1e-4 there (on the H100 an
    ``item_fc`` weight whose gradient was 1.9e-9 ended 1.6e-4 apart after
    the first step); their gradients are held with every other. A straight
    run would carry such a move into every later step."""
    from news_recsys_tpu_torch.models.dssm import build_dssm, item_log_q
    from news_recsys_tpu_torch.training import retrieval
    from news_recsys_tpu_torch.training.dense_step import init_dense_state
    from news_recsys_tpu_torch.training.sparse_step import init_sparse_state
    from news_recsys_tpu_torch.training.trainer import BatchPacker, unpack_batch

    d_cfg = cfg.extra("dssm_cfg", {})
    rate = d_cfg["negative_sample_rate"]
    logq = item_log_q(ds, cfg.embeddings.embedding_table_size["item_id"])
    cpu_model = build_dssm(cfg, seed=SEED + 21, device="cpu")
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to(dev)}
    devices = {"cpu": torch.device("cpu"), "cuda": dev}
    dense = cfg.train_hparams.embedding_optimizer == "adamw"
    init, make = ((init_dense_state, retrieval.make_dssm_train_step) if dense else
                  (init_sparse_state, retrieval.make_dssm_sparse_train_step))
    runs = {d: (init(m, cfg), make(m, cfg, d_cfg["temperature"],
                                   logq_table=torch.from_numpy(logq).to(devices[d])))
            for d, m in models.items()}
    negatives = {d: retrieval.draw_negatives(SEED + 22, 0, CHECK_STEPS, TRAIN_BATCH, rate,
                                             devices[d])
                 for d in models}
    packer = BatchPacker(ds)
    idx = np.random.default_rng(SEED + 23).permutation(packer.n)[: CHECK_STEPS * TRAIN_BATCH]
    (cpu, _), (card, _) = runs["cpu"], runs["cuda"]
    opts = [(getattr(st, "opt", None) or st.dense_opt) for st in (cpu, card)]
    losses = {"cpu": [], "cuda": []}
    err = {"params": 0.0, "grads": 0.0, "accumulators": 0.0}
    exempt = 0
    for rows in idx.reshape(CHECK_STEPS, TRAIN_BATCH):
        models["cuda"].load_state_dict(models["cpu"].state_dict())
        opts[1].load_state_dict(copy.deepcopy(opts[0].state_dict()))
        copy_rowwise_state(cpu, card)
        for d, device in devices.items():
            batch = unpack_batch(torch.from_numpy(packer.int_mat[rows]).to(device),
                                 torch.from_numpy(packer.float_mat[rows]).to(device),
                                 torch.ones(TRAIN_BATCH, device=device), packer.layout_key())
            state, step = runs[d]
            losses[d].append(float(step(state, batch, negatives[d])[0]))
        want = dict(models["cpu"].named_parameters())
        for n, p in models["cuda"].named_parameters():
            w = want[n].detach()
            if want[n].grad is not None:
                g, wg = p.grad.cpu(), want[n].grad
                err["grads"] = max(err["grads"], float((g - wg).abs().max()))
                torch.testing.assert_close(g, wg, msg=f"{n}.grad", **scaled_tol(wg))
            held = held_weights(w, adam_nu(cpu, opts[0], n, want[n]))
            exempt += int((~held).sum())
            got = p.detach().cpu()
            err["params"] = max(err["params"], float((got - w)[held].abs().max()))
            torch.testing.assert_close(got[held], w[held], msg=n, **TRAIN_TOL)
        err["accumulators"] = max(err["accumulators"], check_rowwise_state(card, cpu))
        if card.step != cpu.step:
            raise AssertionError(f"steps: card {card.step}, CPU {cpu.step}")
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], **TRAIN_TOL)
    log(f"training dssm ({cfg.train_hparams.embedding_optimizer}, rate {rate}, logQ), card vs "
        f"CPU, {CHECK_STEPS} steps at batch {TRAIN_BATCH}, each from the CPU's state: tables "
        f"{sorted(cpu_model.tables.items())}; max_abs_err gradients {err['grads']:.3e}, "
        f"tables + towers {err['params']:.3e}, rowwise optimizer state "
        f"{err['accumulators']:.3e} (tol {TRAIN_TOL}; weights left out, second moment in "
        f"(0, {ROUNDING_NU}): {exempt}); losses {losses['cuda']} vs {losses['cpu']}")


def dssm_eval_sets(seed: int) -> tuple:
    """(item corpus, query rows, histories): the 65,238 items of
    :func:`build_cascade`'s corpus and DSSM_QUERIES clicked rows of
    :func:`dssm_arrays`, each history the row's ``hist`` ids."""
    from news_recsys_tpu_torch.training.trainer import PackedDataset
    from news_recsys_tpu_torch.zoo import MIND_TABLE_SIZE

    rng = np.random.default_rng(seed)
    n_items = MIND_TABLE_SIZE["item_id"] - 1
    items = {"item_id": np.arange(1, n_items + 1, dtype=np.int32),
             "category": rng.integers(1, MIND_TABLE_SIZE["category"], n_items).astype(np.int32),
             "subcategory": rng.integers(1, MIND_TABLE_SIZE["subcategory"],
                                         n_items).astype(np.int32),
             "label": np.zeros((n_items, 1), np.float32)}
    query = dssm_arrays(DSSM_QUERIES, seed + 1)
    histories = [[int(x) for x in h[h > 0]] for h in query["hist"]]
    return PackedDataset(items), PackedDataset(query), histories


def kept_candidates(device, corpus, users, item_ids, histories, n: int) -> tuple:
    """(ids, scores), each (Q, n): every query row's first ``n`` candidates
    once its history is taken out, searched on ``device`` as
    ``evaluate_retrieval`` searches."""
    from news_recsys_tpu_torch.ops.topk import TopKSearcher

    searcher = TopKSearcher(device=device)
    searcher.update_embedding(corpus)
    idx, scores = searcher.search(users, n + max(len(h) for h in histories))
    ids, kept_scores = [], []
    for r, h in enumerate(histories):
        keep = ~np.isin(item_ids[idx[r]], h)
        ids.append(item_ids[idx[r]][keep][:n])
        kept_scores.append(scores[r][keep][:n])
    return np.stack(ids), np.stack(kept_scores)


def check_dssm_validation(trainer, items, query, histories) -> None:
    """The card's encodings of ``trainer``'s model against a CPU copy's
    (ANSWER_TOL), and the retrieval evaluation of both on targets drawn
    from the CPU's own candidate lists (a kept rank in [0, 2K) a query, so
    that half of them hit): each device's HR@K must be its rows' hits, and
    a row's hit may differ between the two only where its target's score
    ties the K-th kept candidate's (within ANSWER_TOL)."""
    from news_recsys_tpu_torch.training.retrieval import DSSMTrainer, evaluate_retrieval

    item_ids = items.arrays["item_id"].astype(np.int64)
    with tempfile.TemporaryDirectory() as tmp:
        cpu = DSSMTrainer(trainer.cfg, copy.deepcopy(trainer.model).to("cpu"), workdir=tmp,
                          device="cpu")
        trainers = {"cuda": trainer, "cpu": cpu}
        enc = {d: (t.encode_item_corpus(items), t.encode_users(query))
               for d, t in trainers.items()}
        kept = {d: kept_candidates(t.device, *enc[d], item_ids, histories, 2 * K)
                for d, t in trainers.items()}
        rng = np.random.default_rng(SEED + 26)
        targets = kept["cpu"][0][np.arange(len(histories)), rng.integers(0, 2 * K,
                                                                         len(histories))]
        t0 = time.perf_counter()
        hr = {"cuda": evaluate_retrieval(trainer, items, query, targets, histories, K)}
        val_s = time.perf_counter() - t0
        hr["cpu"] = evaluate_retrieval(cpu, items, query, targets, histories, K)
    err = max(float(np.abs(a - b).max()) for a, b in zip(enc["cuda"], enc["cpu"]))
    hits = {d: (kept[d][0][:, :K] == targets[:, None]).any(axis=1) for d in kept}
    position = {int(i): j for j, i in enumerate(item_ids)}
    corpus, users = enc["cpu"]
    gaps = [abs(float(users[r] @ corpus[position[int(targets[r])]]) - kept["cpu"][1][r, K - 1])
            for r in np.flatnonzero(hits["cuda"] != hits["cpu"])]
    if (err > ANSWER_TOL or any(g > ANSWER_TOL for g in gaps)
            or any(hr[d][f"HR@{K}"] != float(hits[d].mean()) for d in hr)):
        raise AssertionError(f"DSSM validation, card vs CPU: encodings max_abs_err {err}, "
                             f"{hr}, hits {[h.mean() for h in hits.values()]}, gaps {gaps}")
    log(f"DSSM validation ({len(histories)} queries, {len(item_ids)} items, targets at kept "
        f"ranks 0-{2 * K - 1} of the CPU's lists) on the card in {val_s * 1e3:.1f} ms: "
        f"HR@{K} {hr['cuda'][f'HR@{K}']:.4f} (CPU {hr['cpu'][f'HR@{K}']:.4f}; rows differing "
        f"by a tie at the cut: {len(gaps)}); encodings card vs CPU max_abs_err {err:.3e} "
        f"(tol {ANSWER_TOL})")


def train_dssm_phase(dev: torch.device, name: str, smi: str) -> dict:
    """The DSSM of configs/dssm.yaml trained on the card: CHECK_STEPS steps
    of its all-dense step and of the rowwise AdaGrad variant against the
    CPU, then ``DSSMTrainer.fit`` for an epoch of DSSM_STEPS with a retrieval
    validation, checked against the CPU, and a timed warm epoch. Returns the
    kernel launches of the rowwise steps (``train_dssm_rowwise``) and of the
    fit (``train_dssm``)."""
    from news_recsys_tpu_torch.models.dssm import build_dssm
    from news_recsys_tpu_torch.training.retrieval import DSSMTrainer
    from news_recsys_tpu_torch.training.trainer import PackedDataset

    torch.backends.cuda.matmul.allow_tf32 = False        # the card is held to the CPU
    cfg = dssm_config()
    ds = PackedDataset(dssm_arrays(TRAIN_BATCH * DSSM_STEPS, SEED + 20))
    timed(f"train_dssm: {CHECK_STEPS} all-dense steps card vs CPU",
          compare_dssm_training_with_cpu, dev, cfg, ds)
    reset_launches()
    timed(f"train_dssm: {CHECK_STEPS} rowwise steps card vs CPU",
          compare_dssm_training_with_cpu, dev, dssm_config("rowwise_adagrad"), ds)
    paths = {"train_dssm_rowwise": read_launches()}
    items, query, histories = dssm_eval_sets(SEED + 24)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = DSSMTrainer(cfg, build_dssm(cfg, seed=SEED + 25, device=dev), workdir=tmp,
                              device=dev)
        trainer.set_eval_data(items, histories=histories, k=K)
        reset_launches()
        t0 = time.perf_counter()
        state = trainer.fit(ds, query, max_epochs=1)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        paths["train_dssm"] = read_launches()
        with open(trainer.metrics_path) as f:
            lines = [json.loads(line) for line in f]
        first = next(m for m in lines if "train_loss" in m)
        val = [m for m in lines if "val_hr_at_10" in m]
        block = open(trainer.val_log_path).read()
        if (first["steps"] != DSSM_STEPS or not math.isfinite(first["train_loss"])
                or "train_auc" in first or len(val) != 1 or block.count("Retrieval:") != 1
                or not math.isfinite(val[0]["val_hr_at_10"])):
            raise AssertionError(f"DSSMTrainer.fit: {lines}\n{block}")
        log(f"DSSMTrainer.fit (dssm, adamw) on {name}: {DSSM_STEPS} steps of batch "
            f"{TRAIN_BATCH} and a validation in {fit_s:.2f} s (first epoch, warm-up included); "
            f"train_loss {first['train_loss']:.6f}, val HR@{K} {val[0]['val_hr_at_10']:.4f}; "
            f"launches in that epoch: {paths['train_dssm']}")
        check_dssm_validation(trainer, items, query, histories)
        _, warm_epoch = trainer.train_epoch(state, ds, epoch=1)
        if not math.isfinite(warm_epoch["train_loss"]):
            raise AssertionError(f"train_epoch: {warm_epoch}")
    rate = warm_epoch["examples_per_sec"]
    log(f"training throughput (dssm, adamw) on {name} ({smi}): batch {TRAIN_BATCH}, a warm "
        f"epoch of {warm_epoch['steps']} steps: {rate / TRAIN_BATCH:.1f} steps/s "
        f"({TRAIN_BATCH / rate * 1e3:.3f} ms a step), {rate:.0f} examples/s")
    return paths


ROWWISE_KEYS = ("emb_acc", "emb_mu", "emb_nu")


def copy_rowwise_state(src, dst) -> None:
    """The CPU state ``src``'s rowwise optimizer state, apply counter and
    pending rows into the card's ``dst`` (a sparse state; nothing for a
    dense one)."""
    from news_recsys_tpu_torch.training.sparse_step import PendingRows

    for key in ROWWISE_KEYS:
        for name, t in getattr(dst, key, {}).items():
            t.copy_(getattr(src, key)[name])
    if getattr(src, "pending", None) is not None:
        p, dev = src.pending, next(dst.model.parameters()).device
        dst.pending = PendingRows({t: v.to(dev, copy=True) for t, v in p.ids.items()},
                                  {t: v.to(dev, copy=True) for t, v in p.grads.items()},
                                  p.valid.to(dev, copy=True), p.count)
    if hasattr(dst, "applies"):
        dst.applies = src.applies


def check_rowwise_state(card, cpu) -> float:
    """The rowwise optimizer state, card against CPU, within TRAIN_TOL on
    the tables' addressable rows; returns the largest difference."""
    err = 0.0
    vocab = {t: v for t, (v, _) in cpu.model.tables.items()}
    for key in ROWWISE_KEYS:
        for name, t in getattr(card, key, {}).items():
            got, want = t.cpu()[: vocab[name]], getattr(cpu, key)[name][: vocab[name]]
            err = max(err, float((got - want).abs().max()))
            torch.testing.assert_close(got, want, msg=f"{key} {name}", **TRAIN_TOL)
    return err


def adam_nu(state, opt, name: str, param):
    """The Adam second moment of a parameter after the step: AdamW's, or for
    a large table on ``sparse_adamw`` its per-element ``emb_nu``; None."""
    nu = opt.state.get(param, {}).get("exp_avg_sq") if opt is not None else None
    table = name[len("embedder.tables."):]
    if nu is None and table in getattr(state, "emb_nu", {}):
        nu = state.emb_nu[table]
    return nu


def held_weights(w: torch.Tensor, nu) -> torch.Tensor:
    """The weights held to TRAIN_TOL: all but those whose Adam second moment
    is positive and under ROUNDING_NU (a gradient within rounding of 0 in
    every step so far, which Adam's first steps amplify)."""
    if nu is None:
        return torch.ones_like(w, dtype=torch.bool)
    return ((nu == 0) | (nu >= ROUNDING_NU)).reshape(w.shape)


def same_noise(seed: int):
    """One rounding-noise function for both devices: drawn on the CPU and
    copied, so the card and the CPU round bfloat16 rows with the same bits."""
    from news_recsys_tpu_torch.training.sparse_step import rounding_noise

    cpu = rounding_noise(seed)
    return lambda step, index, shape, device: cpu(step, index, shape, "cpu").to(device)


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise distance in bfloat16 ulps of two bfloat16 tensors."""
    def ordered(t):
        u = t.cpu().view(torch.int16).to(torch.int32) & 0xFFFF
        return torch.where(u >= 0x8000, -(u & 0x7FFF), u)
    return (ordered(a) - ordered(b)).abs()


def variant_config(name: str):
    """The train_variants phase's configs: ``dssm@sparse_adamw`` is
    :func:`dssm_config` on ``sparse_adamw``; the others
    ``zoo.mind_config("dcn")`` (arena 159,360 x 32) at batch TRAIN_BATCH on
    ``sparse_adamw``, with K-step write-back (``K4``: K LAZY_K, a step
    checkpoint every LAZY_CKPT_EVERY steps), or with bfloat16 tables and
    towers on ``rowwise_adagrad`` (``bf16``; ``dcn_b8192@bf16`` at batch
    8,192): bench.py's two bf16 lines."""
    from news_recsys_tpu_torch.config import config_from_dict, config_to_dict
    from news_recsys_tpu_torch.zoo import mind_config

    if name == "dssm@sparse_adamw":
        return dssm_config("sparse_adamw")
    bf16 = {"param_dtype": "bfloat16", "compute_dtype": "bfloat16"} if "bf16" in name else {}
    raw = config_to_dict(mind_config(
        "dcn", batch_size=B8192 if "b8192" in name else TRAIN_BATCH,
        embedding_optimizer="sparse_adamw" if "sparse_adamw" in name else "rowwise_adagrad",
        embedding_update_period=LAZY_K if "K4" in name else 1, **bf16))
    if "K4" in name:
        raw["train_hparams"]["ckpt_every_steps"] = LAZY_CKPT_EVERY
    return config_from_dict(raw)


def compare_variant_with_cpu(dev: torch.device, cfg, ds, n_steps: int) -> None:
    """``n_steps`` sparse steps of a DCN variant on the card and on the CPU,
    the same batches and rounding noise, each step from the CPU's state
    copied to the card before it (with K > 1 its pending rows too; a
    combined update after every K steps and after the last): the losses,
    every parameter and the rowwise optimizer state. Tolerances: float32
    within TRAIN_TOL but for weights whose Adam second moment is in (0,
    ROUNDING_NU) (AdamW's, or ``sparse_adamw``'s per table element); a
    bfloat16 table within one ulp on its addressable rows; with bfloat16
    towers every float32 parameter (the towers, the cross stack and the
    small tables, all stepped on the towers' gradients) and the losses
    within BF16_TOWER_TOL."""
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.sparse_step import (init_sparse_state,
                                                            make_sparse_train_step)
    from news_recsys_tpu_torch.training.trainer import AucHist, BatchPacker, unpack_batch

    cpu_model = build_ranker(cfg, seed=SEED + 31, device="cpu")
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to(dev)}
    devices = {"cpu": torch.device("cpu"), "cuda": dev}
    noise = same_noise(SEED + 32)
    states = {d: init_sparse_state(m, cfg) for d, m in models.items()}
    steps = {d: make_sparse_train_step(m, cfg, noise=noise) for d, m in models.items()}
    cpu, card = states["cpu"], states["cuda"]
    K, bs = cfg.train_hparams.embedding_update_period, cfg.dataset.batch_size
    tower_tol = BF16_TOWER_TOL if cfg.mesh.compute_dtype == "bfloat16" else TRAIN_TOL
    vocab = {f"embedder.tables.{t}": v for t, (v, _) in cpu_model.tables.items()}
    packer = BatchPacker(ds)
    idx = np.random.default_rng(SEED + 33).permutation(packer.n)[: n_steps * bs]
    losses = {"cpu": [], "cuda": []}
    err = {"params": 0.0, "state": 0.0, "ulps": 0, "bf16 values": 0, "bf16 exact": 0}
    exempt = 0
    for i, rows in enumerate(idx.reshape(n_steps, bs)):
        models["cuda"].load_state_dict(models["cpu"].state_dict())
        card.dense_opt.load_state_dict(copy.deepcopy(cpu.dense_opt.state_dict()))
        copy_rowwise_state(cpu, card)
        card.step = cpu.step
        for d, device in devices.items():
            batch = unpack_batch(torch.from_numpy(packer.int_mat[rows]).to(device),
                                 torch.from_numpy(packer.float_mat[rows]).to(device),
                                 torch.ones(bs, device=device), packer.layout_key())
            losses[d].append(float(steps[d](states[d], batch, AucHist.zeros(device))[0]))
            if K > 1 and (states[d].step % K == 0 or i == n_steps - 1):
                steps[d].flush(states[d])
        want = dict(models["cpu"].named_parameters())
        for n, p in models["cuda"].named_parameters():
            w, got = want[n].detach(), p.detach().cpu()
            if p.dtype == torch.bfloat16:
                ulps = bf16_ulps(got[: vocab[n]], w[: vocab[n]])
                err["ulps"] = max(err["ulps"], int(ulps.max()))
                err["bf16 values"] += ulps.numel()
                err["bf16 exact"] += int((ulps == 0).sum())
                if int(ulps.max()) > 1:
                    raise AssertionError(f"{n}: {int(ulps.max())} bfloat16 ulps apart")
                continue
            held = held_weights(w, adam_nu(cpu, cpu.dense_opt, n, want[n]))
            exempt += int((~held).sum())
            err["params"] = max(err["params"], float((got - w)[held].abs().max()))
            torch.testing.assert_close(got[held], w[held], msg=n, **tower_tol)
        err["state"] = max(err["state"], check_rowwise_state(card, cpu))
        if (card.step, card.applies) != (cpu.step, cpu.applies):
            raise AssertionError(f"steps, applies: card {card.step, card.applies}, "
                                 f"CPU {cpu.step, cpu.applies}")
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], **tower_tol)
    log(f"training {cfg.name} ({cfg.train_hparams.embedding_optimizer}, K "
        f"{K}, tables {cfg.mesh.param_dtype}, towers {cfg.mesh.compute_dtype}), card vs CPU, "
        f"{n_steps} steps at batch {bs}, each from the CPU's state, the same rounding bits: "
        f"max_abs_err float32 parameters {err['params']:.3e} (tol {TRAIN_TOL}, towers "
        f"{tower_tol}; weights left out, Adam second moment in (0, {ROUNDING_NU}): {exempt}), "
        f"rowwise optimizer state {err['state']:.3e}; bfloat16 tables: at most {err['ulps']} "
        f"ulp apart, {err['bf16 exact']} of {err['bf16 values']} values bit-identical; "
        f"applies {card.applies}; losses {losses['cuda']} vs {losses['cpu']}")


def check_lazy_resume(dev: torch.device, cfg, ds, tmp: str) -> None:
    """K-step write-back cut at step LAZY_CUT (a step checkpoint, two steps
    into a group) and resumed, against the straight run: the tables, every
    other parameter, the accumulators and the apply counter bit for bit."""
    from news_recsys_tpu_torch.config import config_from_dict, config_to_dict
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.checkpoint import state_dict
    from news_recsys_tpu_torch.training.trainer import Trainer

    raw = config_to_dict(cfg)
    raw["train_hparams"]["max_step"] = LAZY_CUT
    runs = {}
    for label, run_cfg in (("straight", cfg), ("cut", config_from_dict(raw))):
        trainer = Trainer(run_cfg, build_ranker(cfg, seed=SEED + 34, device=dev),
                          workdir=os.path.join(tmp, label), device=dev)
        runs[label] = trainer.fit(ds, max_epochs=1)
    trainer = Trainer(cfg, build_ranker(cfg, seed=SEED + 35, device=dev),
                      workdir=os.path.join(tmp, "cut"), device=dev)
    resumed = trainer.fit(ds, max_epochs=1, resume=True)
    a, b = state_dict(runs["straight"]), state_dict(resumed)
    diff = [f"{key} {n}" for key in ("model", *ROWWISE_KEYS) for n, t in a[key].items()
            if not torch.equal(b[key][n], t)]
    if diff or (a["step"], a["applies"]) != (b["step"], b["applies"]) or \
            runs["cut"].step != LAZY_CUT:
        raise AssertionError(f"K-step write-back resumed at step {LAZY_CUT} differs from the "
                             f"straight run: {diff}, steps/applies {a['step'], a['applies']} vs "
                             f"{b['step'], b['applies']}")
    log(f"K-step write-back (K {LAZY_K}), cut at step {LAZY_CUT} of {LAZY_STEPS} (checkpoints "
        f"every {LAZY_CKPT_EVERY}) and resumed on the card: every tensor bit-identical to the "
        f"straight run's ({len(a['model'])} parameters, accumulators); steps {b['step']}, "
        f"applies {b['applies']}")


def train_variant(dev: torch.device, name: str, smi: str, tmp: str) -> dict:
    """One variant of :func:`variant_config` on the card: card against CPU
    from the same state before each step, ``Trainer.fit`` (the DSSM:
    ``DSSMTrainer.fit``) for an epoch, counted, then a timed warm epoch;
    for ``dcn@K4`` also the resumed run. Returns the epoch's launches."""
    from news_recsys_tpu_torch.models.dssm import build_dssm
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.retrieval import DSSMTrainer
    from news_recsys_tpu_torch.training.trainer import PackedDataset, Trainer

    cfg = variant_config(name)
    bs = cfg.dataset.batch_size
    dssm = name.startswith("dssm")
    n_steps = (DSSM_STEPS if dssm else LAZY_STEPS if "K4" in name
               else B8192_STEPS if "b8192" in name else EARLIER_TRAIN_STEPS)
    seed = SEED + 36 + VARIANTS.index(name)
    ds = PackedDataset(dssm_arrays(bs * n_steps, seed) if dssm else
                       ranking_arrays(bs * n_steps, seed))
    if dssm:
        timed(f"train_variants ({name}): {CHECK_STEPS} steps card vs CPU",
              compare_dssm_training_with_cpu, dev, cfg, ds)
    else:
        check = (B8192_CHECK_STEPS if "b8192" in name else
                 LAZY_CKPT_EVERY if "K4" in name else CHECK_STEPS)
        timed(f"train_variants ({name}): {check} steps card vs CPU", compare_variant_with_cpu,
              dev, cfg, ds, check)
    work = os.path.join(tmp, name.replace("@", "_"))
    if dssm:
        trainer = DSSMTrainer(cfg, build_dssm(cfg, seed=seed, device=dev), workdir=work,
                              device=dev)
    else:
        trainer = Trainer(cfg, build_ranker(cfg, seed=seed, device=dev), workdir=work,
                          device=dev)
    reset_launches()
    t0 = time.perf_counter()
    state = trainer.fit(ds, max_epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    with open(trainer.metrics_path) as f:
        first = next(json.loads(line) for line in f if "train_loss" in line)
    bad = [n for n, p in trainer.model.named_parameters() if not torch.isfinite(p).all()]
    if first["steps"] != n_steps or not math.isfinite(first["train_loss"]) or bad:
        raise AssertionError(f"{name}: Trainer.fit: {first}; non-finite parameters {bad}")
    tables = {n: (tuple(t.shape), str(t.dtype)[6:]) for n, t in
              trainer.model.embedder.tables.items()}
    log(f"Trainer.fit ({name}) on the card: tables {tables}; {n_steps} steps of batch {bs} in "
        f"{fit_s:.2f} s (first epoch, warm-up included); train_loss "
        f"{first['train_loss']:.6f}; applies {getattr(state, 'applies', 0)}; launches in that "
        f"epoch: {launches}")
    _, warm = trainer.train_epoch(state, ds, epoch=1)
    if not math.isfinite(warm["train_loss"]):
        raise AssertionError(f"{name}: train_epoch: {warm}")
    rate = warm["examples_per_sec"]
    log(f"training throughput ({name}) on {smi}: batch {bs}, a warm epoch of {warm['steps']} "
        f"steps: {rate / bs:.1f} steps/s ({bs / rate * 1e3:.3f} ms a step), {rate:.0f} "
        f"examples/s")
    if "K4" in name:
        timed("train_variants (dcn@K4): the resumed run", check_lazy_resume, dev, cfg, ds,
              os.path.join(tmp, "resume"))
    return launches


def train_variants_phase(dev: torch.device, smi: str) -> dict:
    """Every variant of VARIANTS trained on the card (:func:`train_variant`);
    returns each one's launches as a path ``train_<variant>``."""
    torch.backends.cuda.matmul.allow_tf32 = False        # the card is held to the CPU
    with tempfile.TemporaryDirectory() as tmp:
        return {f"train_{name.replace('@', '_')}": train_variant(dev, name, smi, tmp)
                for name in VARIANTS}


def cli_config(tmp: str, name: str, **train) -> str:
    """A copy of ``configs/<name>.yaml`` whose paths point into ``tmp``, with
    ``max_epoch`` CLI_EPOCHS, ``ckpt_every_steps`` CLI_CKPT_EVERY and
    ``train``'s fields; every other field as shipped. Returns its path."""
    import yaml
    with open(os.path.join(REPO_DIR, "configs", f"{name}.yaml")) as f:
        doc = yaml.safe_load(f)
    doc["paths"] = {"data_path": os.path.join(tmp, "Data", "MIND"),
                    "out_basedir": os.path.join(tmp, "out")}
    doc["train_hparams"].update(max_epoch=CLI_EPOCHS, ckpt_every_steps=CLI_CKPT_EVERY, **train)
    path = os.path.join(tmp, f"{name}{''.join(f'_{k}{v}' for k, v in train.items())}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    return path


def cli_run(label: str, *argv) -> float:
    """``news_recsys_tpu_torch.cli.main(argv)``, its wall time logged and
    returned."""
    from news_recsys_tpu_torch.cli import main
    t0 = time.perf_counter()
    main(list(argv))
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    log(f"cli {label}: {' '.join(argv)}: {s:.2f} s")
    return s


def check_cli_training(workdir: str, epochs: int, steps: int) -> list:
    """The ``metrics.jsonl`` of a ``train`` run: ``epochs`` epochs of ``steps``
    steps, each validated with a finite AUC, GAUC and NDCG@10; returns its
    training lines."""
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    trained = [m for m in lines if "train_loss" in m]
    validated = [m for m in lines if "val_auc" in m]
    if ([m["steps"] for m in trained] != [steps] * epochs or len(validated) != epochs
            or not all(math.isfinite(m[k]) for m in validated
                       for k in ("val_auc", "val_gauc", "val_ndcg10"))
            or not all(math.isfinite(m["train_loss"]) for m in trained)):
        raise AssertionError(f"train in {workdir}: {lines}")
    return trained


def compare_checkpoints(a: str, b: str) -> tuple:
    """(largest difference, bit-identical?) of two checkpoint files, every
    tensor held to TRAIN_TOL: the card need not give the same bits twice
    (atomics in a sum), so a resumed run is held to a straight one as the
    card is held to the CPU."""
    from news_recsys_tpu_torch.training.checkpoint import load_state

    def leaves(x, path=""):
        if isinstance(x, torch.Tensor):
            yield path, x
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                yield from leaves(x[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                yield from leaves(v, f"{path}/{i}")

    got, want = load_state(a), load_state(b)
    if got["step"] != want["step"] or got["kind"] != want["kind"]:
        raise AssertionError(f"{a}: step {got['step']} ({got['kind']}), {b}: {want['step']} "
                             f"({want['kind']})")
    (got, want) = (dict(leaves(x)) for x in (got, want))
    if sorted(got) != sorted(want):
        raise AssertionError(f"{a} and {b} hold other tensors")
    err, same = 0.0, True
    for path, w in want.items():
        g = got[path]
        same = same and torch.equal(g, w)
        if g.is_floating_point():
            err = max(err, float((g - w).abs().max()) if g.numel() else 0.0)
            torch.testing.assert_close(g, w, msg=lambda m: f"{path}: {m}", **TRAIN_TOL)
        elif not torch.equal(g, w):
            raise AssertionError(f"{path} differs")
    return err, same


def read_scores(path: str) -> np.ndarray:
    with open(path) as f:
        return np.array([json.loads(line)["score"] for line in f], np.float64)


def cli_phase(dev: torch.device, name: str, smi: str) -> dict:
    """The port's command line from raw files to predictions on the card
    (module docstring, item 8); returns the kernel launches of the commands
    run in this process."""
    card = str(dev)
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        times = {"synth": cli_run("synth", "synth", "--out", os.path.join(tmp, "Data", "MIND"),
                                  *CLI_SYNTH)}
        dcn = cli_config(tmp, "dcn")
        times["preprocess"] = cli_run("preprocess", "preprocess", "-c", dcn)
        times["fe (dcn)"] = cli_run("fe (dcn)", "fe", "-c", dcn)
        from news_recsys_tpu_torch.data.packed_dataset import PackedDataset
        from news_recsys_tpu_torch.config import load_config
        cfg = load_config(dcn)
        n_train = len(PackedDataset.open_split(cfg, "train"))
        n_dev = len(PackedDataset.open_split(cfg, "dev"))
        steps = n_train // cfg.dataset.batch_size
        log(f"cli data: {n_train} train rows ({steps} steps of {cfg.dataset.batch_size} an "
            f"epoch), {n_dev} dev rows")

        straight = os.path.join(tmp, "dcn_straight")
        times["train (dcn)"] = cli_run("train (dcn)", "train", "-c", dcn, "--workdir", straight,
                                       "--epochs", str(CLI_EPOCHS), "--device", card)
        trained = check_cli_training(straight, CLI_EPOCHS, steps)
        log(f"cli train (dcn) on {name} ({smi}): {CLI_EPOCHS} epochs of {steps} steps, each "
            f"validated on {n_dev} rows, checkpoints every {CLI_CKPT_EVERY} steps; examples/s by "
            f"epoch {[round(m['examples_per_sec'], 1) for m in trained]}; train_loss "
            f"{[round(m['train_loss'], 6) for m in trained]}")

        resumed = os.path.join(tmp, "dcn_resumed")
        times["train (dcn, cut)"] = cli_run(
            "train (dcn, cut)", "train", "-c", cli_config(tmp, "dcn", max_step=CLI_CUT_STEP),
            "--workdir", resumed, "--epochs", str(CLI_EPOCHS), "--device", card)
        times["train --resume (dcn)"] = cli_run(
            "train --resume (dcn)", "train", "-c", dcn, "--workdir", resumed, "--epochs",
            str(CLI_EPOCHS), "--device", card, "--resume")
        with open(os.path.join(resumed, "metrics.jsonl")) as f:
            after = [json.loads(line) for line in f if "train_loss" in line][1:]
        first = CLI_CUT_STEP // CLI_CKPT_EVERY * CLI_CKPT_EVERY
        if [m["steps"] for m in after] != [steps - first, steps]:
            raise AssertionError(f"train --resume did not resume at step {first}: {after}")
        err, same = compare_checkpoints(os.path.join(resumed, "ckpts", "epoch_001.pt"),
                                        os.path.join(straight, "ckpts", "epoch_001.pt"))
        log(f"cli resume: cut at step {CLI_CUT_STEP}, resumed at step {first} (epoch 0, offset "
            f"{first} batches); epoch_001.pt vs the straight run's: max_abs_err {err:.3e} (tol "
            f"{TRAIN_TOL}), bit-identical: {same}")

        out = {d: os.path.join(tmp, f"predict_{d}.jsonl") for d in ("cuda", "cpu", "process")}
        for d, device in (("cuda", card), ("cpu", "cpu")):
            times[f"predict ({d})"] = cli_run(f"predict ({d})", "predict", "-c", dcn,
                                              "--checkpoint", straight, "--output", out[d],
                                              "--device", device)
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "news_recsys_tpu_torch", "predict", "-c", dcn,
                        "--checkpoint", straight, "--output", out["process"], "--device", card],
                       cwd=REPO_DIR, check=True, timeout=600)
        times["predict (python3 -m)"] = time.perf_counter() - t0
        scores = {d: read_scores(p) for d, p in out.items()}
        if not all(len(v) == n_dev and np.isfinite(v).all() for v in scores.values()):
            raise AssertionError(f"predict: {[len(v) for v in scores.values()]} rows")
        card_cpu = float(np.abs(scores["cuda"] - scores["cpu"]).max())
        card_process = float(np.abs(scores["cuda"] - scores["process"]).max())
        log(f"cli predict: {n_dev} dev rows; card vs CPU max_abs_err {card_cpu:.3e}, in-process "
            f"vs python3 -m on the card {card_process:.3e} (tol {ANSWER_TOL}); python3 -m "
            f"predict {times['predict (python3 -m)']:.2f} s")
        if card_cpu > ANSWER_TOL or card_process > ANSWER_TOL:
            raise AssertionError("predict: the card's scores differ")

        attention = cli_config(tmp, "attention")
        times["fe (attention)"] = cli_run("fe (attention)", "fe", "-c", attention)
        workdir = os.path.join(tmp, "attention")
        times["train (attention)"] = cli_run("train (attention)", "train", "-c", attention,
                                             "--workdir", workdir, "--epochs", "1",
                                             "--device", card)
        trained = check_cli_training(workdir, 1, steps)
        log(f"cli train (attention) on {name} ({smi}): 1 epoch of {steps} steps: examples/s "
            f"{trained[0]['examples_per_sec']:.1f}, train_loss {trained[0]['train_loss']:.6f}")
        dssm_steps_run = cli_dssm(tmp, card, name, smi, times)
        launches = read_launches()
        # a backward a step: the DCN's straight, cut and resumed runs, the
        # attention ranker's epoch (whose forward pools ``entities``), the
        # DSSM's epoch (whose user tower pools ``hist``)
        want = {"dcn_cross_bwd": 2 * steps + CLI_CUT_STEP + 2 * steps - first,
                "fused_transformer_block_bwd": steps,
                "fused_lookup_pool_bwd": steps + dssm_steps_run}
        if any(launches[k] != n for k, n in want.items()):
            raise AssertionError(f"cli: launches {launches}, expected {want}")
        serve_launches = cli_tooling(tmp, card, name, smi, times, dcn, straight, scores["cuda"])
    log(f"cli wall times (s): {json.dumps({k: round(v, 3) for k, v in times.items()})}")
    return {"cli": launches, "serve_ranker_ckpt": serve_launches}


SERVE_REQUESTS = 3                  # requests to each `serve --ranker-ckpt` server


def serve_command(argv: list) -> tuple:
    """``news_recsys_tpu_torch.cli.main(["serve", *argv, "--port", "0"])`` on
    a thread, as ``python -m news_recsys_tpu_torch serve`` runs it; returns
    (url, the server, the thread) once it serves. Stop it with
    ``server.shutdown()``."""
    import news_recsys_tpu_torch.serving as serving
    from news_recsys_tpu_torch.cli import main

    made, real = [], serving.serve_http
    serving.serve_http = lambda *a, **kw: made.append(real(*a, **kw)) or made[-1]
    try:
        thread = threading.Thread(target=main, args=(["serve", *argv, "--port", "0"],),
                                  daemon=True)
        thread.start()
        deadline = time.perf_counter() + 600
        while not made and thread.is_alive() and time.perf_counter() < deadline:
            time.sleep(0.05)
    finally:
        serving.serve_http = real
    if not made:
        raise AssertionError(f"serve {' '.join(argv)} did not start serving")
    return f"http://127.0.0.1:{made[0].server_address[1]}", made[0], thread


def served_answers(argv: list, backend: str, reqs: list) -> tuple:
    """The answers of ``serve *argv --backend backend`` to ``reqs`` over HTTP
    and its ``/healthz``; the server is stopped after."""
    url, server, thread = serve_command([*argv, "--backend", backend])
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        answers = [post(url, req) for req in reqs]
    finally:
        server.shutdown()
        thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError("the serve command did not stop")
    return health, answers


def recall_differs_by_ties(host, device, batch, histories) -> int:
    """Users whose recall candidates differ between the host and device
    searchers; fails unless every difference is a near tie (neighbouring
    scores within ANSWER_TOL, or items scored within it of the fetch cut)."""
    (h_ids, h_sc), (d_ids, d_sc) = (rec.recommend(batch, k=FETCH, histories=histories)
                                    for rec in (host, device))
    differ = 0
    for r in range(len(d_ids)):
        if h_ids[r] == d_ids[r]:
            continue
        differ += 1
        gaps = np.abs(np.diff(d_sc[r]))
        score = {**dict(zip(h_ids[r], h_sc[r])), **dict(zip(d_ids[r], d_sc[r]))}
        for j, (a, b) in enumerate(zip(h_ids[r], d_ids[r])):
            tied = ((j > 0 and gaps[j - 1] <= ANSWER_TOL) or (j < len(gaps)
                    and gaps[j] <= ANSWER_TOL))
            if a != b and not tied and not all(abs(score[i] - d_sc[r][-1]) <= ANSWER_TOL
                                               for i in set(h_ids[r]) ^ set(d_ids[r])):
                raise AssertionError(f"user {r}: host recall {h_ids[r]}, device {d_ids[r]}")
    return differ


def addressable(x: torch.Tensor, arena_rows: int, arena_vocab: int) -> torch.Tensor:
    return x[:arena_vocab] if x.dim() and x.shape[0] == arena_rows else x


def cli_tooling(tmp: str, card: str, name: str, smi: str, times: dict, dcn: str,
                straight: str, card_scores: np.ndarray) -> dict:
    """The tooling commands in the ``cli`` phase's directory: ``convert-ckpt``
    of the DCN run's epoch checkpoint to per-table tables and back (the
    arena's addressable rows and every other tensor bit for bit), ``predict``
    of the per-table checkpoint under ``arena_tables: false`` (the arena
    run's scores within 1e-6); ``serve --ranker-ckpt --ranker-config`` on
    the DSSM run's bundle over HTTP, on the device and the host backends
    (answers equal to an in-process ``build_cascade``'s, id for id; the
    recall's ids equal but for ties); ``fe --text`` and ``open_split`` from
    the text splits (the ``.npz`` arrays); ``log`` of the run;
    ``visualize-history`` of the raw train files. Returns the launches of
    the device server's requests."""
    import contextlib
    import io
    import yaml
    from news_recsys_tpu_torch.config import arena_layout, load_config, table_specs
    from news_recsys_tpu_torch.models.embedding import padded_vocab
    from news_recsys_tpu_torch.serving import Recommender, _user_batch_from_json, build_cascade
    from news_recsys_tpu_torch.training.checkpoint import load_state
    from news_recsys_tpu_torch.training.trainer import PackedDataset

    cfg = load_config(dcn)
    src = os.path.join(straight, "ckpts", f"epoch_{CLI_EPOCHS - 1:03d}.pt")
    per_table, back = (os.path.join(tmp, f"dcn_{k}.pt") for k in ("per_table", "arena_back"))
    times["convert-ckpt (per-table)"] = cli_run("convert-ckpt (per-table)", "convert-ckpt", "-c",
                                                dcn, "--input", src, "--output", per_table,
                                                "--to", "per-table")
    times["convert-ckpt (arena)"] = cli_run("convert-ckpt (arena)", "convert-ckpt", "-c", dcn,
                                            "--input", per_table, "--output", back, "--to", "arena")
    (arena_name, arena_vocab), = {(a, total) for a, _, total in arena_layout(cfg).values()}
    rows = padded_vocab(table_specs(cfg)[arena_name][0])
    got, want = (dict(tree_leaves(load_state(p))) for p in (back, src))
    if sorted(got) != sorted(want) or "/model/embedder.tables.user_id" not in dict(
            tree_leaves(load_state(per_table))):
        raise AssertionError(f"convert-ckpt: {sorted(set(got) ^ set(want))}")
    for path, w in want.items():
        g = got[path]
        same = (torch.equal(addressable(g, rows, arena_vocab), addressable(w, rows, arena_vocab))
                if isinstance(w, torch.Tensor) else g == w)
        if not same:
            raise AssertionError(f"convert-ckpt round trip: {path} differs")
    doc = yaml.safe_load(open(dcn))
    doc["embeddings"]["arena_tables"] = False
    per_table_cfg = os.path.join(tmp, "dcn_per_table.yaml")
    with open(per_table_cfg, "w") as f:
        yaml.safe_dump(doc, f)
    out = os.path.join(tmp, "predict_per_table.jsonl")
    times["predict (per-table)"] = cli_run("predict (per-table)", "predict", "-c", per_table_cfg,
                                           "--checkpoint", per_table, "--output", out,
                                           "--device", card)
    err = float(np.abs(read_scores(out) - card_scores).max())
    if err > 1e-6:
        raise AssertionError(f"the per-table checkpoint predicts {err} off the arena's")
    log(f"cli convert-ckpt: {src} -> per-table -> arena: {len(want)} leaves bit-identical (the "
        f"arena on its {arena_vocab} addressable rows of {rows}); predict of the per-table "
        f"checkpoint under arena_tables false on the card vs the arena run's: max_abs_err "
        f"{err:.3e} (tol 1e-6)")

    bundle = os.path.join(tmp, "dssm", "bundle")
    argv = ["--bundle", bundle, "--ranker-ckpt", straight, "--ranker-config", dcn,
            "--device", card]
    reqs = make_requests(SERVE_REQUESTS)
    reset_launches()
    t0 = time.perf_counter()
    health, answers = served_answers(argv, "device", reqs)
    times["serve --ranker-ckpt (device)"] = time.perf_counter() - t0
    launches = read_launches()
    t0 = time.perf_counter()
    host_health, host_answers = served_answers(argv, "host", reqs)
    times["serve --ranker-ckpt (host)"] = time.perf_counter() - t0
    for h, backend in ((health, "device"), (host_health, "host")):
        if h.get("backend") != backend or not h.get("cascade") or h.get("ranker") != "dcn" \
                or h.get("fetch") != FETCH:
            raise AssertionError(f"/healthz: {h}")
    cascades = {b: build_cascade(bundle, straight, dcn, fetch=FETCH, backend=b, device=card)
                for b in ("device", "host")}
    ties = 0
    for req, ans, host_ans in zip(reqs, answers, host_answers):
        batch = _user_batch_from_json(cascades["device"], req["users"])
        for b, got in (("device", ans), ("host", host_ans)):
            want_ids, want_scores = cascades[b].recommend(batch, k=K, histories=req["histories"])
            if got["ids"] != want_ids or np.abs(np.subtract(got["scores"], want_scores)).max() > 0:
                raise AssertionError(f"serve --backend {b}: {got['ids']} against the "
                                     f"in-process cascade's {want_ids}")
        ties += recall_differs_by_ties(cascades["host"].recall, cascades["device"].recall, batch,
                                       req["histories"])
    log(f"cli serve --ranker-ckpt {straight} --ranker-config dcn.yaml on the DSSM bundle: "
        f"{SERVE_REQUESTS} requests of {USERS_PER_REQUEST} users over HTTP on --backend device "
        f"and host, every answer equal to an in-process build_cascade's id for id; host vs "
        f"device recall (fetch {FETCH}): {ties} users differing by near ties; /healthz "
        f"{health}; launches of the device server's requests: {launches}")

    times["fe --text (dcn)"] = cli_run("fe --text (dcn)", "fe", "-c", dcn, "--text")
    base = os.path.join(cfg.paths.out_basedir, "extractored_feature")
    compared = {}
    for split in ("train", "dev", "item"):
        npz = os.path.join(base, f"{split}_features.npz")
        want = PackedDataset.load(npz).arrays
        os.replace(npz, npz + ".away")
        try:
            t0 = time.perf_counter()
            got = PackedDataset.open_split(cfg, split).arrays
            load_s = time.perf_counter() - t0
        finally:
            os.replace(npz + ".away", npz)
        if not set(want) <= set(got) or (split != "item" and set(want) != set(got)) or any(
                not np.array_equal(got[k], want[k]) for k in want):
            raise AssertionError(f"open_split({split}) from the text split differs")
        compared[split] = (len(got["label"]), round(load_s, 3))
    log(f"cli fe --text; open_split from the .txt splits equals the .npz arrays: {compared} "
        "(rows, load s)")

    report = io.StringIO()
    with contextlib.redirect_stdout(report):
        times["log"] = cli_run("log", "log", straight)
    if "Best Epoch" not in report.getvalue() or "Warm Start AUC" not in report.getvalue():
        raise AssertionError(f"log: {report.getvalue()}")
    html_path = os.path.join(tmp, "history.html")
    raw = os.path.join(tmp, "Data", "MIND", "MINDsmall_train")
    times["visualize-history"] = cli_run("visualize-history", "visualize-history", "--news",
                                         os.path.join(raw, "news.tsv"), "--behaviors",
                                         os.path.join(raw, "behaviors.tsv"), "--output",
                                         html_path)
    page = open(html_path, encoding="utf-8").read()
    if "<h3>Users (200)</h3>" not in page:
        raise AssertionError("visualize-history: no list of 200 users")
    title = next(line for line in report.getvalue().splitlines() if line.startswith("## "))
    log(f"cli log: {title!r}; visualize-history: "
        f"{os.path.getsize(html_path)} bytes, 200 users")
    return launches


def cli_dssm(tmp: str, card: str, name: str, smi: str, times: dict) -> int:
    """The DSSM's commands in the ``cli`` phase's directory: ``fe`` and
    ``train --epochs 1`` of a copy of configs/dssm.yaml (its
    ``retrieval_eval.json`` and bundle checked, the bundle loaded and asked),
    ``predict -m dssm`` on the card and on the CPU (embeddings and cosines
    within ANSWER_TOL) and ``itemcf``; returns the DSSM epoch's steps."""
    from news_recsys_tpu_torch.serving import Recommender
    from news_recsys_tpu_torch.training.trainer import PackedDataset
    from news_recsys_tpu_torch.config import load_config

    dssm = cli_config(tmp, "dssm")
    times["fe (dssm)"] = cli_run("fe (dssm)", "fe", "-c", dssm)
    workdir = os.path.join(tmp, "dssm")
    times["train (dssm)"] = cli_run("train (dssm)", "train", "-c", dssm, "--workdir", workdir,
                                    "--epochs", "1", "--device", card)
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    (trained,), val = [m for m in lines if "train_loss" in m], \
        [m for m in lines if "val_hr_at_10" in m]
    with open(os.path.join(workdir, "retrieval_eval.json")) as f:
        res = json.load(f)
    if (set(res) != {"HR@10", "num_queries"} or res["num_queries"] <= 0
            or len(val) != 1 or val[0]["val_hr_at_10"] != res["HR@10"]
            or not math.isfinite(trained["train_loss"])
            or not os.path.exists(os.path.join(workdir, "ckpts", "epoch_000.pt"))):
        raise AssertionError(f"train (dssm): {res}, {lines}")
    cfg = load_config(dssm)
    dev_ds = PackedDataset.open_split(cfg, "dev")
    rec = Recommender.load(os.path.join(workdir, "bundle"), device=card)
    users = {k: v[:USERS_PER_REQUEST] for k, v in dev_ds.arrays.items()}
    ids, _ = rec.recommend(users, k=K, histories=[list(h[h > 0]) for h in users["hist"]])
    if [len(r) for r in ids] != [K] * USERS_PER_REQUEST:
        raise AssertionError(f"the DSSM bundle answered {ids}")
    log(f"cli train (dssm) on {name} ({smi}): 1 epoch of {trained['steps']} steps "
        f"(click positives + history pairs, logQ): examples/s "
        f"{trained['examples_per_sec']:.1f}, train_loss {trained['train_loss']:.6f}; "
        f"retrieval_eval.json {res}; the bundle served {USERS_PER_REQUEST} dev users")

    out = {d: os.path.join(tmp, f"predict_dssm_{d}.jsonl") for d in ("cuda", "cpu")}
    for d, device in (("cuda", card), ("cpu", "cpu")):
        times[f"predict -m dssm ({d})"] = cli_run(
            f"predict -m dssm ({d})", "predict", "-c", dssm, "-m", "dssm", "--checkpoint",
            workdir, "--output", out[d], "--device", device)
    rows = {}
    for d, path in out.items():
        with open(path) as f:
            recs = [json.loads(line) for line in f]
        rows[d] = {k: np.array([r[k] for r in recs], np.float64)
                   for k in ("user_embedding", "item_embedding", "score")}
    err = {k: float(np.abs(rows["cuda"][k] - rows["cpu"][k]).max()) for k in rows["cpu"]}
    if (len(rows["cuda"]["score"]) != len(dev_ds) or max(err.values()) > ANSWER_TOL
            or not np.isfinite(rows["cuda"]["score"]).all()):
        raise AssertionError(f"predict -m dssm, card vs CPU: {err}")
    log(f"cli predict -m dssm: {len(dev_ds)} dev rows; card vs CPU max_abs_err {err} "
        f"(tol {ANSWER_TOL})")

    times["itemcf"] = cli_run("itemcf", "itemcf", "-c", dssm)
    with open(os.path.join(cfg.paths.out_basedir, "itemcf", "metrics.json")) as f:
        itemcf = json.load(f)
    if not (itemcf["queries"] > 0 and 0.0 <= itemcf["HR@10"] <= itemcf["HR@50"] <= 1.0):
        raise AssertionError(f"itemcf: {itemcf}")
    log(f"cli itemcf (host): {itemcf}")
    return int(trained["steps"])


SLAB_STEPS = EARLIER_TRAIN_STEPS    # the DCN's slab epoch at batch 512
SLAB_BATCHES = 3                    # its device_resident_bytes: about 3 batches of rows
BIG_ROWS, BIG_STEPS = 8_400_000, 64  # attention rows above the default 2 GiB budget
DSSM_SLAB_STEPS = 16
# device_metrics_min_rows, a tenth of it and MIND-small dev's size: where the
# device engine starts to pay is measured, not carried over
METRIC_ROWS = (20_000, 200_000, 2_600_000)
METRIC_USER_ROWS = 37                # rows (candidates) a user
PROFILE_STEPS = 8


def with_train(cfg, **train):
    import dataclasses
    return dataclasses.replace(cfg, train_hparams=dataclasses.replace(cfg.train_hparams,
                                                                      **train))


def tree_leaves(x, path: str = ""):
    if isinstance(x, dict):
        for k in sorted(x, key=str):
            yield from tree_leaves(x[k], f"{path}/{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from tree_leaves(v, f"{path}/{i}")
    else:
        yield path, x


def assert_same_bits(a, b, what: str) -> int:
    """Two states (:func:`training.checkpoint.state_dict`'s dicts, or any
    tree of tensors) equal bit for bit; returns the number of leaves."""
    got, want = dict(tree_leaves(a)), dict(tree_leaves(b))
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: other leaves {sorted(set(got) ^ set(want))}")
    for path, w in want.items():
        g = got[path]
        if not (torch.equal(g, w) if isinstance(w, torch.Tensor) else g == w):
            raise AssertionError(f"{what}: {path} differs")
    return len(want)


def slab_budget(ds, steps: int) -> int:
    """A ``device_resident_bytes`` that sends ``ds`` down the slab path in
    slabs of ``steps`` batches."""
    from news_recsys_tpu_torch.training.trainer import BatchPacker
    packer = BatchPacker(ds)
    row = (packer.int_mat.nbytes + packer.float_mat.nbytes) / packer.n
    return int(row * TRAIN_BATCH * steps) + 1


def slab_times(trainer, ds, steps: int, rounds: int = 5) -> tuple:
    """(host gather ms, gather + upload ms) of one slab of ``steps`` batches
    of ``ds`` through ``trainer.upload_slab``: medians of ``rounds``."""
    packer = trainer._packer(ds)[0]
    rows = np.random.default_rng(SEED).permutation(packer.n)[: steps * TRAIN_BATCH]
    gather, total = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        packer.int_mat[rows], packer.float_mat[rows]
        t1 = time.perf_counter()
        trainer.upload_slab(packer, rows)
        torch.cuda.synchronize()
        gather.append(t1 - t0)
        total.append(time.perf_counter() - t1)
    return float(np.median(gather)) * 1e3, float(np.median(total)) * 1e3


def fit_epoch(trainer, ds, **fit) -> tuple:
    """``trainer.fit`` for one epoch: (state, its kernel launches, wall s)."""
    reset_launches()
    t0 = time.perf_counter()
    state = trainer.fit(ds, max_epochs=1, **fit)
    torch.cuda.synchronize()
    return state, read_launches(), time.perf_counter() - t0


def slab_dcn(dev: torch.device, name: str, smi: str) -> dict:
    """The DCN at MIND-small widths (``train_config("dcn")``, batch 512) on
    the slab path (``device_resident_bytes`` of SLAB_BATCHES batches of
    rows) and on the resident path from the same seed: an epoch of
    SLAB_STEPS steps, ``predict`` and ``validate`` (the device metric
    engine) of a dev set, which streams too; states, scores and blocks bit
    for bit. Then a warm epoch of each, timed; returns the slab epoch's
    kernel launches."""
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.checkpoint import state_dict
    from news_recsys_tpu_torch.training.trainer import PackedDataset, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = with_train(train_config("dcn"), device_metrics_min_rows=0)
    arrays = ranking_arrays(TRAIN_BATCH * SLAB_STEPS, SEED + 30)
    ds = PackedDataset(arrays)
    dev_ds = PackedDataset(dev_arrays(arrays["user_id"], SEED + 31))
    warm = {int(u) for u in np.unique(arrays["user_id"])}
    slab_cfg = with_train(cfg, device_resident_bytes=slab_budget(ds, SLAB_BATCHES))
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, c in (("slab", slab_cfg), ("resident", cfg)):
            trainer = Trainer(c, build_ranker(c, seed=SEED + 32, device=dev),
                              workdir=os.path.join(tmp, label), device=dev)
            state, launches, fit_s = fit_epoch(trainer, ds)
            runs[label] = (trainer, state, launches, fit_s, trainer.predict(dev_ds),
                           trainer.validate(state, dev_ds, 0, warm))
        (st, ss, launches, slab_s, sp, sv), (rt, rs, _, res_s, rp, rv) = \
            runs["slab"], runs["resident"]
        if (st._packer(ds)[1] is not None or st._packer(dev_ds)[1] is not None
                or rt._packer(ds)[1] is None):
            raise AssertionError("the budget did not send the DCN's data down the slab path")
        leaves = assert_same_bits(state_dict(ss), state_dict(rs), "DCN, slab vs resident")
        if not np.array_equal(sp, rp) or json.dumps(sv, sort_keys=True) != json.dumps(
                rv, sort_keys=True):
            raise AssertionError(f"DCN slab vs resident: scores or blocks differ: {sv} {rv}")
        cap = st._slab_chunk_cap(st._packer(ds)[0], TRAIN_BATCH)
        gather_ms, upload_ms = slab_times(st, ds, cap)
        warm_epochs = {label: runs[label][0].train_epoch(runs[label][1], ds, epoch=1)[1]
                       for label in ("slab", "resident")}
    step_ms = {k: TRAIN_BATCH / m["examples_per_sec"] * 1e3 for k, m in warm_epochs.items()}
    log(f"runtime slab (dcn) on {name} ({smi}): {SLAB_STEPS} steps of {TRAIN_BATCH}, slabs of "
        f"{cap} batches ({cap * TRAIN_BATCH} rows), predict and validate of {len(dev_ds)} dev "
        f"rows (device engine): bit-identical to the resident path ({leaves} state leaves, "
        f"every score, the block); first epochs {slab_s:.2f} / {res_s:.2f} s (slab / "
        f"resident); a slab: host gather {gather_ms:.3f} ms, gather + upload "
        f"{upload_ms:.3f} ms; warm epochs {step_ms['slab']:.3f} / {step_ms['resident']:.3f} "
        f"ms a step (slab / resident); launches in the slab epoch: {launches}")
    return launches


def slab_default_budget(dev: torch.device, name: str, smi: str) -> dict:
    """BIG_ROWS rows of ``zoo.attention_arrays`` (256 bytes a packed row, over
    the default ``device_resident_bytes`` of 2 GiB) for the attention ranker's
    sparse step (``train_config("attention")``, ``max_step`` BIG_STEPS): the
    default budget sends them down the slab path; the same steps on the
    resident path (a budget of 4 GiB) give the same state bit for bit.
    Returns the slab epoch's kernel launches."""
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.checkpoint import state_dict
    from news_recsys_tpu_torch.training.trainer import PackedDataset, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = with_train(train_config("attention"), max_step=BIG_STEPS)
    t0 = time.perf_counter()
    ds = PackedDataset(training_arrays(cfg, BIG_ROWS, SEED + 33))
    make_s = time.perf_counter() - t0
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, c in (("slab", cfg), ("resident", with_train(cfg, device_resident_bytes=4 << 30))):
            trainer = Trainer(c, build_ranker(c, seed=SEED + 34, device=dev),
                              workdir=os.path.join(tmp, label), device=dev)
            t0 = time.perf_counter()
            packer, mats = trainer._packer(ds)
            torch.cuda.synchronize()
            pack_s = time.perf_counter() - t0
            state, launches, fit_s = fit_epoch(trainer, ds)
            runs[label] = (trainer, state_dict(state), launches, fit_s, pack_s, mats is None)
            del trainer, state, mats
        (st, sblob, launches, slab_s, spack_s, slabbed), (_, rblob, _, res_s, rpack_s, rslab) = \
            runs["slab"], runs["resident"]
        nbytes = packer.int_mat.nbytes + packer.float_mat.nbytes
        if not slabbed or rslab or nbytes <= cfg.train_hparams.device_resident_bytes:
            raise AssertionError(f"{nbytes} packed bytes against the default budget "
                                 f"{cfg.train_hparams.device_resident_bytes}: slab {slabbed}")
        leaves = assert_same_bits(sblob, rblob, "attention, slab vs resident")
        cap = min(cfg.train_hparams.chunk_steps, st._slab_chunk_cap(packer, TRAIN_BATCH),
                  BIG_STEPS)
        gather_ms, upload_ms = slab_times(st, ds, cap)
    log(f"runtime slab (attention, the default budget) on {name} ({smi}): {BIG_ROWS} rows, "
        f"{nbytes} packed bytes ({nbytes / BIG_ROWS:.0f} a row) over the default "
        f"{cfg.train_hparams.device_resident_bytes}; made in {make_s:.2f} s, packed in "
        f"{spack_s:.2f} s (slab) / {rpack_s:.2f} s (resident, its upload included); "
        f"{BIG_STEPS} steps in {slab_s:.2f} / {res_s:.2f} s (slab / resident, first "
        f"epochs), bit-identical ({leaves} state leaves); a slab of {cap} batches: host "
        f"gather {gather_ms:.3f} ms, gather + upload {upload_ms:.3f} ms; launches in the slab "
        f"epoch: {launches}")
    return launches


def slab_dssm(dev: torch.device, name: str, smi: str) -> dict:
    """configs/dssm.yaml's DSSM (all-dense AdamW, logQ) for an epoch of
    DSSM_SLAB_STEPS on the slab path (slabs of SLAB_BATCHES batches) and on
    the resident path: the same state and encodings of the 65,238-item
    corpus and the queries, bit for bit (the epoch's negatives are keyed by
    the global step). Returns the slab epoch's kernel launches."""
    from news_recsys_tpu_torch.models.dssm import build_dssm
    from news_recsys_tpu_torch.training.checkpoint import state_dict
    from news_recsys_tpu_torch.training.retrieval import DSSMTrainer
    from news_recsys_tpu_torch.training.trainer import PackedDataset

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dssm_config()
    ds = PackedDataset(dssm_arrays(TRAIN_BATCH * DSSM_SLAB_STEPS, SEED + 35))
    items, query, _ = dssm_eval_sets(SEED + 36)
    slab_cfg = with_train(cfg, device_resident_bytes=slab_budget(ds, SLAB_BATCHES))
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, c in (("slab", slab_cfg), ("resident", cfg)):
            trainer = DSSMTrainer(c, build_dssm(c, seed=SEED + 37, device=dev),
                                  workdir=os.path.join(tmp, label), device=dev)
            state, launches, fit_s = fit_epoch(trainer, ds)
            runs[label] = (trainer, state_dict(state), launches, fit_s,
                           trainer.encode_item_corpus(items), trainer.encode_users(query))
    (st, sblob, launches, slab_s, s_items, s_users), (rt, rblob, _, res_s, r_items, r_users) = \
        runs["slab"], runs["resident"]
    if st._packer(ds)[1] is not None or st._packer(items)[1] is not None \
            or rt._packer(ds)[1] is None:
        raise AssertionError("the budget did not send the DSSM's data down the slab path")
    leaves = assert_same_bits(sblob, rblob, "DSSM, slab vs resident")
    if not (np.array_equal(s_items, r_items) and np.array_equal(s_users, r_users)):
        raise AssertionError("DSSM slab vs resident: the encodings differ")
    log(f"runtime slab (dssm) on {name} ({smi}): {DSSM_SLAB_STEPS} steps of {TRAIN_BATCH}, "
        f"slabs of {SLAB_BATCHES} batches: bit-identical to the resident path ({leaves} state "
        f"leaves, {len(s_items)} item and {len(s_users)} query encodings); first epochs "
        f"{slab_s:.2f} / {res_s:.2f} s (slab / resident); launches in the slab epoch: "
        f"{launches}")
    return launches


def metric_rows(n: int, seed: int) -> tuple:
    """``n`` validation rows, users of about METRIC_USER_ROWS rows, float32
    scores on a grid of 1/5,000 (ties), 8% clicks, half the users warm."""
    rng = np.random.default_rng(seed)
    users = max(1, n // METRIC_USER_ROWS)
    uids = rng.integers(1, users + 1, n)
    scores = (np.round(rng.random(n) * 5000) / 5000).astype(np.float32)
    labels = (rng.random(n) < 0.08).astype(np.float32)
    return uids, scores, labels, set(range(1, users // 2 + 1))


def metric_engine(dev: torch.device, name: str, smi: str) -> None:
    """The device metric engine at METRIC_ROWS rows against the host engine
    (abs 2e-5, ``User_Count`` exact, tests/test_metrics_device.py's
    tolerance), and against its own second run on the card bit for bit;
    both engines' wall times logged."""
    from news_recsys_tpu_torch.training.metrics import compute_user_metrics
    from news_recsys_tpu_torch.training.metrics_device import compute_user_metrics_device

    for n in METRIC_ROWS:
        rows = metric_rows(n, SEED + 38)
        t0 = time.perf_counter()
        host = compute_user_metrics(*rows)
        host_s = time.perf_counter() - t0
        card_s, runs = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            runs.append(compute_user_metrics_device(*rows, device=dev))
            card_s.append(time.perf_counter() - t0)
        if json.dumps(runs[0], sort_keys=True) != json.dumps(runs[1], sort_keys=True):
            raise AssertionError(f"the device engine gave other bits on a second run: {runs}")
        err = 0.0
        for cohort, vals in host.items():
            for key, val in vals.items():
                got = runs[0][cohort][key]
                if key == "User_Count" and got != val:
                    raise AssertionError(f"{cohort} User_Count {got}, the host's {val}")
                err = max(err, abs(got - val))
        if err > 2e-5:
            raise AssertionError(f"device engine vs host at {n} rows: {err}: {runs[0]} {host}")
        log(f"runtime metric engine on {name} ({smi}): {n} rows, "
            f"{host['Warm_Start']['User_Count'] + host['Cold_Start']['User_Count']} users, "
            f"ties: device vs host max_abs_err {err:.3e} (tol 2e-5, User_Count exact), two "
            f"runs bit-identical; wall s: device {card_s[0]:.3f} / {card_s[1]:.3f} (first / "
            f"second run), host {host_s:.3f}")


def profile_check(dev: torch.device, name: str, smi: str) -> None:
    """``Trainer(profile_steps=1)`` on the DCN's sparse step for an epoch of
    PROFILE_STEPS: a trace under ``<log_dir>/profile`` that names the cross
    backward's kernel; ``device_memory_stats()`` logged."""
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.trainer import PackedDataset, Trainer
    from news_recsys_tpu_torch.utils.profiling import device_memory_stats

    cfg = train_config("dcn")
    ds = PackedDataset(ranking_arrays(TRAIN_BATCH * PROFILE_STEPS, SEED + 39))
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, build_ranker(cfg, seed=SEED + 40, device=dev), workdir=tmp,
                          device=dev, profile_steps=1)
        _, _, fit_s = fit_epoch(trainer, ds)
        traces = [os.path.join(tmp, "profile", f) for f in os.listdir(os.path.join(tmp, "profile"))
                  if ".pt.trace.json" in f]
        if len(traces) != 1:
            raise AssertionError(f"profile: {traces}")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        ours = sorted({k for k in kernels if "dcn_cross_bwd_rows_kernel" in k})
        if not ours:
            raise AssertionError(f"profile: no dcn_cross_bwd_rows_kernel among {len(kernels)} "
                                 "kernels of the trace")
        size = os.path.getsize(traces[0])
    log(f"runtime profile on {name} ({smi}): Trainer(profile_steps=1), {PROFILE_STEPS} steps in "
        f"{fit_s:.2f} s traced; {size} bytes of trace, {len(kernels)} kernels, "
        f"{sum(any(c in k for c in CROSS_BWD_KERNELS) for k in kernels)} of the cross "
        f"backward's ({ours[0]}); device_memory_stats() {device_memory_stats()}")


def runtime_phase(dev: torch.device, name: str, smi: str) -> dict:
    """The training runtime: the slab-streamed path (the DCN, the
    default budget's attention run, the DSSM), the device metric engine,
    profiling; returns the slab epochs' kernel launches by path."""
    paths = {"train_slab": timed("runtime: the DCN on slabs", slab_dcn, dev, name, smi),
             "train_slab_budget": timed("runtime: the default budget's slabs",
                                        slab_default_budget, dev, name, smi),
             "train_slab_dssm": timed("runtime: the DSSM on slabs", slab_dssm, dev, name, smi)}
    timed("runtime: the device metric engine", metric_engine, dev, name, smi)
    timed("runtime: profiling", profile_check, dev, name, smi)
    return paths


# -- the parallel phase: two gloo ranks on one card ---------------------------------

PARALLEL_STEPS = 8          # DCN steps of each layout held to one process
PARALLEL_ADAM_STEPS = 4     # sparse_adamw steps at (1, 2)
PARALLEL_DSSM_STEPS = 4     # DSSM steps at (2, 1)
PARALLEL_EPOCH = 32         # Trainer.fit's epoch at (1, 2), then a timed warm one
PARALLEL_TIMED, PARALLEL_RUNS = 8, 3     # the step timing: steps a run, runs a layout
PARALLEL_LAYOUTS = ((1, 2), (2, 1))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def parallel_config(optimizer: str = "rowwise_adagrad"):
    from news_recsys_tpu_torch.zoo import mind_config
    return mind_config("dcn", batch_size=TRAIN_BATCH, embedding_optimizer=optimizer)


def parallel_arrays(steps: int, seed: int, padding: bool = False) -> dict:
    """:func:`ranking_arrays` of ``steps`` batches; with ``padding`` every
    37th ``user_id`` and every 41st ``item_id`` is 0 (unknown), so the step
    has invalid slots, which one process parks on the arena's spare row."""
    arrays = ranking_arrays(TRAIN_BATCH * steps, seed)
    if padding:
        arrays["user_id"][::37] = 0
        arrays["item_id"][::41] = 0
    return arrays


def stepper(kind: str, cfg, weights: dict, dev: torch.device, mesh):
    """(state, step(state, batch, carry), carry) of a model of ``cfg`` from
    ``weights`` on ``dev``, its tables cut to ``mesh``'s shards: the DCN's
    sparse step (carry: the AUC histogram) or the DSSM's all-dense step
    (carry: the negatives of PARALLEL_DSSM_STEPS steps of the global batch)."""
    from news_recsys_tpu_torch.parallel.sharded_embedding import shard_parameters
    from news_recsys_tpu_torch.training.trainer import AucHist

    if kind == "dssm":
        from news_recsys_tpu_torch.models.dssm import build_dssm
        from news_recsys_tpu_torch.training import retrieval
        from news_recsys_tpu_torch.training.dense_step import init_dense_state

        model = build_dssm(cfg, device=dev)
        model.load_state_dict(weights)
        shard_parameters(model, mesh)
        d_cfg = cfg.extra("dssm_cfg", {})
        step = retrieval.make_dssm_train_step(model, cfg, d_cfg["temperature"], mesh=mesh)
        carry = retrieval.draw_negatives(SEED + 42, 0, PARALLEL_DSSM_STEPS, TRAIN_BATCH,
                                         d_cfg["negative_sample_rate"], dev)
        return init_dense_state(model, cfg), step, carry
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.sparse_step import (init_sparse_state,
                                                            make_sparse_train_step)

    model = build_ranker(cfg, device=dev)
    model.load_state_dict(weights)
    shard_parameters(model, mesh)
    return (init_sparse_state(model, cfg), make_sparse_train_step(model, cfg, mesh=mesh),
            AucHist.zeros(dev))


def run_steps(run: dict, dev: torch.device, mesh) -> dict:
    """``run["steps"]`` steps of ``run`` (kind, config, weights, arrays) on
    ``mesh`` (None: one process), each rank on its slice of every batch of
    TRAIN_BATCH in row order: the losses, the launches, the AUC histogram
    summed over the data axis, and the gathered state (process 0), on the
    host."""
    from news_recsys_tpu_torch.training.checkpoint import state_dict
    from news_recsys_tpu_torch.training.trainer import BatchPacker, PackedDataset, unpack_batch

    state, step, carry = stepper(run["kind"], run["cfg"], run["weights"], dev, mesh)
    packer = BatchPacker(PackedDataset(run["arrays"]))
    int_mat, float_mat = (torch.from_numpy(m).to(dev) for m in (packer.int_mat, packer.float_mat))
    sl = mesh.batch_slice(TRAIN_BATCH) if mesh is not None else slice(None)
    rows = torch.arange(TRAIN_BATCH * run["steps"], device=dev).view(run["steps"], -1)[:, sl]
    ones = torch.ones(rows.shape[1], device=dev)
    reset_launches()
    outs = [step(state, unpack_batch(int_mat[r], float_mat[r], ones, packer.layout_key()),
                 carry) for r in rows]
    sync(dev)
    out = {"launches": read_launches(), "losses": [float(x[0]) for x in outs]}
    if run["kind"] != "dssm":
        hist = [h.clone() for h in (carry.pos, carry.neg)]
        if mesh is not None:
            hist = [mesh.all_reduce_(h, "data") for h in hist]
        out["hist"] = [h.cpu() for h in hist]
        out["probs"] = torch.sigmoid(torch.stack([x[1] for x in outs])).cpu()
    blob = state_dict(state, mesh)
    out["state"] = flat_state(blob) if mesh is None or mesh.rank == 0 else None
    return out


def flat_state(blob: dict) -> dict:
    """A checkpoint dict's tensors by a flat name, on the host."""
    out = {f"model/{k}": v for k, v in blob["model"].items()}
    for key in ROWWISE_KEYS:
        out.update({f"{key}/{t}": v for t, v in blob.get(key, {}).items()})
    for key in ("opt", "dense_opt"):
        for i, st in ((blob.get(key) or {}).get("state") or {}).items():
            out.update({f"{key}/{i}/{k}": v for k, v in st.items() if k != "step"})
    return {k: v.detach().cpu() for k, v in out.items()}


def time_steps(run: dict, dev: torch.device, mesh) -> dict:
    """Warm step wall times: PARALLEL_RUNS runs of PARALLEL_TIMED steps
    (each ending in a synchronize), after two untimed steps; then one more
    run with the collectives timed (each waits for the device before and
    after it), whose collective seconds over its wall time are the
    collectives' share."""
    from news_recsys_tpu_torch.training.trainer import BatchPacker, PackedDataset, unpack_batch

    state, step, carry = stepper(run["kind"], run["cfg"], run["weights"], dev, mesh)
    packer = BatchPacker(PackedDataset(run["arrays"]))
    int_mat, float_mat = (torch.from_numpy(m).to(dev) for m in (packer.int_mat, packer.float_mat))
    sl = mesh.batch_slice(TRAIN_BATCH) if mesh is not None else slice(None)
    n = PARALLEL_TIMED
    rows = torch.arange(TRAIN_BATCH * n, device=dev).view(n, -1)[:, sl]
    ones = torch.ones(rows.shape[1], device=dev)
    batches = [unpack_batch(int_mat[r], float_mat[r], ones, packer.layout_key()) for r in rows]

    def one_run():
        sync(dev)
        t0 = time.perf_counter()
        for b in batches:
            step(state, b, carry)
        sync(dev)
        return (time.perf_counter() - t0) / n * 1e3

    for b in batches[:2]:
        step(state, b, carry)
    runs = [one_run() for _ in range(PARALLEL_RUNS)]
    out = {"step_ms": float(np.median(runs)), "runs_ms": runs}
    if mesh is not None:
        mesh.stats.reset()
        mesh.stats.timed = True
        timed_ms = one_run()
        mesh.stats.timed = False
        out.update(timed_step_ms=timed_ms,
                   collectives_ms=mesh.stats.seconds / n * 1e3,
                   collective_calls=mesh.stats.calls / n,
                   host_copies=mesh.stats.host_copies / n,
                   host_mb=mesh.stats.host_bytes / n / 1e6)
        out["collectives_share"] = out["collectives_ms"] / timed_ms
    return out


def parallel_fit(run: dict, dev: torch.device, mesh, workdir: str) -> dict:
    """``Trainer.fit`` for an epoch of PARALLEL_EPOCH steps on ``mesh``: its
    launches, the gathered ``predict`` of the data after it, and a timed
    warm epoch."""
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.trainer import PackedDataset, Trainer

    model = build_ranker(run["cfg"], device=dev)
    model.load_state_dict(run["weights"])
    trainer = Trainer(run["cfg"], model, workdir=workdir, device=dev, mesh=mesh)
    ds = PackedDataset(run["arrays"])
    reset_launches()
    state = trainer.fit(ds, max_epochs=1)
    sync(dev)
    launches = read_launches()
    predict = trainer.predict(ds)
    _, warm = trainer.train_epoch(state, ds, epoch=1)
    return {"launches": launches, "warm": warm, "predict": predict,
            "ckpt": os.path.join(trainer.ckpt_dir, "epoch_000.pt")}


def parallel_worker(rank: int, spec: dict) -> dict:
    """One rank of the parallel phase: every layout's runs, the fit at
    (1, 2), the step timings."""
    from news_recsys_tpu_torch.parallel.mesh import Mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(spec["device"])
    meshes = {lay: Mesh(*lay) for lay in PARALLEL_LAYOUTS}
    out = {name: run_steps(run, dev, meshes[run["layout"]])
           for name, run in spec["runs"].items()}
    out["fit"] = parallel_fit(spec["runs"]["dcn_1x2"], dev, meshes[(1, 2)], spec["workdir"])
    out["timing"] = {lay: time_steps(spec["runs"]["dcn_1x2"], dev, meshes[lay])
                     for lay in PARALLEL_LAYOUTS}
    return out


def parallel_runs() -> dict:
    """The runs of the phase, by name: the DCN of ``mind_config("dcn",
    embedding_optimizer="rowwise_adagrad")`` at (1, 2) and (2, 1), on
    ``sparse_adamw`` at (1, 2) with unknown ids, and the DSSM of
    configs/dssm.yaml at (2, 1); weights seeded, on the host."""
    from news_recsys_tpu_torch.models.dssm import build_dssm
    from news_recsys_tpu_torch.models.rankers import build_ranker

    def weights(net):
        return {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}

    ada, adam, dssm = parallel_config(), parallel_config("sparse_adamw"), dssm_config()
    dcn = dict(kind="dcn", cfg=ada, weights=weights(build_ranker(ada, seed=SEED + 40,
                                                                 device="cpu")),
               arrays=parallel_arrays(PARALLEL_EPOCH, SEED + 41), steps=PARALLEL_STEPS)
    return {"dcn_1x2": dict(dcn, layout=(1, 2)), "dcn_2x1": dict(dcn, layout=(2, 1)),
            "adamw_1x2": dict(kind="dcn", cfg=adam, layout=(1, 2), weights=dcn["weights"],
                              arrays=parallel_arrays(PARALLEL_ADAM_STEPS, SEED + 43, True),
                              steps=PARALLEL_ADAM_STEPS),
            "dssm_2x1": dict(kind="dssm", cfg=dssm, layout=(2, 1), steps=PARALLEL_DSSM_STEPS,
                             weights=weights(build_dssm(dssm, seed=SEED + 44, device="cpu")),
                             arrays=dssm_arrays(TRAIN_BATCH * PARALLEL_DSSM_STEPS, SEED + 45))}


def assert_states(got: dict, want: dict, what: str, tol=None, skip_rows=None,
                  held=None) -> float:
    """Every tensor of ``got`` against ``want``: equal bits (``tol`` None) or
    within ``tol``; ``skip_rows`` maps a flat name to the rows left out,
    ``held`` to the mask of elements held. Returns the largest difference."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: {sorted(set(got) ^ set(want))}")
    err = 0.0
    for key, w in want.items():
        g = got[key]
        if key in (skip_rows or {}):
            keep = torch.ones(w.shape[0], dtype=torch.bool)
            keep[skip_rows[key]] = False
            g, w = g[keep], w[keep]
        if key in (held or {}):
            g, w = g[held[key]], w[held[key]]
        if g.numel():
            err = max(err, float((g.float() - w.float()).abs().max()))
        if tol is None:
            if not torch.equal(g, w):
                raise AssertionError(f"{what}: {key} differs from one process's "
                                     f"(max {float((g.float() - w.float()).abs().max()):.3e})")
        else:
            torch.testing.assert_close(g, w, msg=f"{what}: {key}", **tol)
    return err


PARALLEL_FIT_LAUNCHES = {"dcn_cross_stack": PARALLEL_EPOCH, "dcn_cross_bwd": PARALLEL_EPOCH,
                         "scatter_rows_set": PARALLEL_EPOCH}
PARALLEL_LAUNCHES = {
    # per rank: the cross stack's forward and backward once a step, the
    # arena's shard-local scatter once a step (three on sparse_adamw), the
    # DSSM's pool and its backward once a step
    "dcn_1x2": {"dcn_cross_stack": PARALLEL_STEPS, "dcn_cross_bwd": PARALLEL_STEPS,
                "scatter_rows_set": PARALLEL_STEPS},
    "dcn_2x1": {"dcn_cross_stack": PARALLEL_STEPS, "dcn_cross_bwd": PARALLEL_STEPS,
                "scatter_rows_set": PARALLEL_STEPS},
    "adamw_1x2": {"dcn_cross_stack": PARALLEL_ADAM_STEPS, "dcn_cross_bwd": PARALLEL_ADAM_STEPS,
                  "scatter_rows_set": 3 * PARALLEL_ADAM_STEPS},
    "dssm_2x1": {"fused_lookup_pool": PARALLEL_DSSM_STEPS,
                 "fused_lookup_pool_bwd": PARALLEL_DSSM_STEPS, "scatter_rows_set": 0},
}


def parallel_phase(dev: torch.device, name: str, smi: str) -> dict:
    """Two ranks on ``cuda:0`` over gloo (CUDA tensors' all-to-all and
    all-gather staged through the host), spawned after the kernels are
    built, against this process on the card: the DCN at (data 1, model 2)
    bit for bit (8 steps; the arena's two shards of 79,680 rows), at
    (data 2, model 1) within TRAIN_TOL with equal AUC histograms, on
    ``sparse_adamw`` at (1, 2) bit for bit but the spare row, which stays as
    it was (and the padding row); the DSSM at (2, 1), its losses and weights
    within TRAIN_TOL (but those under ROUNDING_NU, as in the card-vs-CPU
    check); ``Trainer.fit`` for an epoch at (1, 2) whose checkpoint, loaded
    by this process, predicts the ranks' scores bit for bit; the launch
    counts of every rank; the warm step time of each layout beside this
    process's. Returns the launches of every run (rank 0)."""
    from news_recsys_tpu_torch.config import table_specs
    from news_recsys_tpu_torch.models.embedding import padded_vocab
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.parallel.distributed import spawn_ranks
    from news_recsys_tpu_torch.training.trainer import PackedDataset, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    runs = parallel_runs()
    t0 = time.perf_counter()
    refs = {n: run_steps(run, dev, None) for n, run in runs.items() if n != "dcn_2x1"}
    refs["dcn_2x1"] = refs["dcn_1x2"]
    one_timing = time_steps(runs["dcn_1x2"], dev, None)
    log(f"parallel: one process's runs on the card {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = spawn_ranks(parallel_worker, 2,
                            ({"runs": runs, "workdir": tmp, "device": str(dev)},),
                            init_method=f"file://{tmp}/store", backend="gloo",
                            device=dev, timeout=600, group_timeout=120,
                            threads=torch.get_num_threads())
        log(f"parallel: two ranks on one card (gloo), spawn to exit "
            f"{time.perf_counter() - t0:.2f} s")
        fit = ranks[0]["fit"]
        cfg = runs["dcn_1x2"]["cfg"]
        trainer = Trainer(cfg, build_ranker(cfg, device=dev), workdir=os.path.join(tmp, "one"),
                          device=dev)
        trainer.load_checkpoint(trainer.init_state(), fit["ckpt"])
        pred = trainer.predict(PackedDataset(runs["dcn_1x2"]["arrays"]))
    for r in ranks:
        if not np.array_equal(r["fit"]["predict"], pred):
            raise AssertionError("the two-rank epoch checkpoint, loaded by one process, "
                                 "predicts other scores")
        for n, want in PARALLEL_LAUNCHES.items():
            got = {k: r[n]["launches"][k] for k in want}
            if got != want:
                raise AssertionError(f"parallel {n}: launches {got}, expected {want}")
    want_fit = PARALLEL_FIT_LAUNCHES
    got_fit = {k: ranks[1]["fit"]["launches"][k] for k in want_fit}
    if got_fit != want_fit or {k: fit["launches"][k] for k in want_fit} != want_fit:
        raise AssertionError(f"parallel fit: launches {fit['launches']}, expected {want_fit}")
    got = {n: ranks[0][n] for n in runs}
    err_1x2 = assert_states(got["dcn_1x2"]["state"], refs["dcn_1x2"]["state"], "dcn (1, 2)")
    if got["dcn_1x2"]["losses"] != refs["dcn_1x2"]["losses"]:
        raise AssertionError("dcn (1, 2): losses differ from one process's")
    err_2x1 = assert_states(got["dcn_2x1"]["state"], refs["dcn_1x2"]["state"], "dcn (2, 1)",
                            tol=TRAIN_TOL)
    np.testing.assert_allclose(got["dcn_2x1"]["losses"], refs["dcn_1x2"]["losses"], **TRAIN_TOL)
    for h, w in zip(got["dcn_1x2"]["hist"], refs["dcn_1x2"]["hist"]):
        if not torch.equal(h, w):
            raise AssertionError("dcn (1, 2): the AUC histogram differs from one process's")
    flips, dp = check_hist_2x1(torch.cat([r["dcn_2x1"]["probs"] for r in ranks], dim=1),
                               refs["dcn_1x2"]["probs"], got["dcn_2x1"]["hist"],
                               refs["dcn_1x2"]["hist"])
    # sparse_adamw: the arena's spare row (one process's invalid slots' row)
    arena = "model/embedder.tables.arena_d32"
    spare = padded_vocab(dict(table_specs(runs["adamw_1x2"]["cfg"]))["arena_d32"][0]) - 1
    skip = {k: [spare] for k in (arena, "emb_mu/arena_d32", "emb_nu/arena_d32")}
    err_adam = assert_states(got["adamw_1x2"]["state"], refs["adamw_1x2"]["state"],
                             "sparse_adamw (1, 2)", skip_rows=skip)
    init = runs["adamw_1x2"]["weights"]["embedder.tables.arena_d32"]
    sharded_arena, one_arena = got["adamw_1x2"]["state"][arena], refs["adamw_1x2"]["state"][arena]
    if not (torch.equal(sharded_arena[[0, spare]], init[[0, spare]])
            and bool((got["adamw_1x2"]["state"]["emb_mu/arena_d32"][spare] == 0).all())):
        raise AssertionError("sparse_adamw (1, 2): the padding or spare row moved")
    spare_moved = float((one_arena[spare] - init[spare]).abs().max())
    # the DSSM: Adam's amplified rounding left out, as card vs CPU
    want = refs["dssm_2x1"]["state"]
    held = {}
    names = [n for n, _ in build_dssm_names(runs["dssm_2x1"]["cfg"])]
    for i, n in enumerate(names):
        nu = want.get(f"opt/{i}/exp_avg_sq")
        if nu is not None:
            held[f"model/{n}"] = held_weights(want[f"model/{n}"], nu)
    err_dssm = assert_states(got["dssm_2x1"]["state"], want, "dssm (2, 1)", tol=TRAIN_TOL,
                             held=held)
    np.testing.assert_allclose(got["dssm_2x1"]["losses"], refs["dssm_2x1"]["losses"],
                               **TRAIN_TOL)
    log(f"parallel on {name} ({smi}): two gloo ranks on one card against one process on it: "
        f"dcn (1, 2) {PARALLEL_STEPS} steps bit for bit (max_abs_err {err_1x2:.3e}), the "
        f"arena {tuple(got['dcn_1x2']['state'][arena].shape)} in "
        f"two shards, AUC histograms equal; dcn (2, 1) max_abs_err {err_2x1:.3e} (tol "
        f"{TRAIN_TOL}), probabilities within {dp:.3e}, AUC histograms equal in their sums, "
        f"{flips} of {PARALLEL_STEPS * TRAIN_BATCH} examples in the next bin (each within "
        f"that of a bin edge); sparse_adamw (1, 2) {PARALLEL_ADAM_STEPS} steps bit for bit but the spare "
        f"row {spare} (one process moved it by {spare_moved:.3e}; the shards left it and the "
        f"padding row as they were), max_abs_err {err_adam:.3e}; dssm (2, 1) "
        f"{PARALLEL_DSSM_STEPS} steps max_abs_err {err_dssm:.3e}, losses "
        f"{got['dssm_2x1']['losses']} vs {refs['dssm_2x1']['losses']}; Trainer.fit (1, 2) "
        f"{PARALLEL_EPOCH} steps, its checkpoint predicts the ranks' scores bit for bit in one "
        f"process; launches a rank: {ranks[0]['fit']['launches']}")
    for lay, t in ranks[0]["timing"].items():
        log(f"parallel step time on {name} ({smi}): dcn rowwise_adagrad batch {TRAIN_BATCH} at "
            f"(data {lay[0]}, model {lay[1]}), two ranks on one card over gloo: "
            f"{t['step_ms']:.3f} ms a step (runs of {PARALLEL_TIMED} steps: "
            f"{', '.join(f'{x:.3f}' for x in t['runs_ms'])}); collectives "
            f"{t['collectives_ms']:.3f} ms of a {t['timed_step_ms']:.3f} ms step with them timed "
            f"({t['collectives_share']:.1%}), {t['collective_calls']:.0f} calls, "
            f"{t['host_copies']:.0f} host copies ({t['host_mb']:.3f} MB) a step; one process: "
            f"{one_timing['step_ms']:.3f} ms a step (runs "
            f"{', '.join(f'{x:.3f}' for x in one_timing['runs_ms'])}); warm epoch at (1, 2): "
            f"{TRAIN_BATCH / ranks[0]['fit']['warm']['examples_per_sec'] * 1e3:.3f} ms a step")
    return {"parallel": fit["launches"],
            **{f"parallel_{n}": ranks[0][n]["launches"] for n in runs}}


def check_hist_2x1(probs, want_probs, hist, want_hist) -> tuple:
    """(examples binned apart, largest probability difference) of the AUC
    histogram at (data 2, model 1) against one process's: the ranks'
    logits come from half batches, which cuBLAS rounds otherwise, so a
    probability within that rounding of one of the 4,096 bin edges may
    land in the next bin. The sums must be equal, every example binned
    apart must lie that close to an edge, and the histograms may differ
    only by those examples."""
    from news_recsys_tpu_torch.training.trainer import AUC_BINS

    for h, w in zip(hist, want_hist):
        if float(h.sum()) != float(w.sum()):
            raise AssertionError("dcn (2, 1): the AUC histogram's sums differ")
    dp = float((probs - want_probs).abs().max())
    if dp > TRAIN_TOL["atol"]:
        raise AssertionError(f"dcn (2, 1): probabilities {dp:.3e} apart")
    bins = [(p * AUC_BINS).to(torch.int32).clamp(0, AUC_BINS - 1) for p in (probs, want_probs)]
    apart = bins[0] != bins[1]
    edge = (want_probs * AUC_BINS - (want_probs * AUC_BINS).round()).abs()
    if bool((edge[apart] > AUC_BINS * dp + 1e-6).any()):
        raise AssertionError("dcn (2, 1): an example away from a bin edge changed bins")
    moved = sum(float((h - w).abs().sum()) for h, w in zip(hist, want_hist))
    if moved > 2 * int(apart.sum()):
        raise AssertionError(f"dcn (2, 1): the AUC histograms differ by {moved}, more than "
                             f"the {int(apart.sum())} examples binned apart move")
    return int(apart.sum()), dp


def build_dssm_names(cfg):
    """(name, parameter) of a DSSM of ``cfg`` in ``named_parameters`` order:
    the order of AdamW's state in its checkpoint."""
    from news_recsys_tpu_torch.models.dssm import build_dssm
    return list(build_dssm(cfg, device="cpu").named_parameters())


def counted_kernels() -> dict:
    from news_recsys_tpu_torch.ops.dcn_kernel import dcn_cross_bwd, dcn_cross_stack
    from news_recsys_tpu_torch.ops.fm_kernel import fm_second_order, fm_second_order_bwd
    from news_recsys_tpu_torch.ops.fused_attention import (fused_transformer_block,
                                                           fused_transformer_block_bwd)
    from news_recsys_tpu_torch.ops.fused_lookup_pool import (fused_lookup_pool,
                                                             fused_lookup_pool_bwd)
    from news_recsys_tpu_torch.ops.mhsa import masked_mhsa, masked_mhsa_bwd
    from news_recsys_tpu_torch.ops.scatter_rows import scatter_rows_set
    return {f.__name__: f for f in (dcn_cross_stack, fused_lookup_pool, dcn_cross_bwd,
                                    scatter_rows_set, fm_second_order, fm_second_order_bwd,
                                    fused_transformer_block, fused_transformer_block_bwd,
                                    fused_lookup_pool_bwd, masked_mhsa, masked_mhsa_bwd)}


def launch_empty() -> None:
    """One empty kernel (``nrt_empty``, one block of 32 threads) on the current stream."""
    from news_recsys_tpu_torch.ops import _build
    _build.launch("nrt_empty", torch.cuda.current_stream().cuda_stream)


def launch_floor_ms() -> float:
    """Device time of :func:`launch_empty` as :func:`device_ms` takes it: the
    floor under every kernel's time in this run."""
    ms = device_ms(launch_empty)
    log(f"launch floor: an empty kernel {ms * 1e3:.2f} us (CUDA graph replays)")
    return ms


ROOFLINE_PATHS = {"train": "dcn", "train_deepfm": "deepfm", "train_attention": "attention",
                  "train_attention_dense": "attention@adamw", "train_dssm": "dssm",
                  "train_nrms": "nrms"}
ROOFLINE_EPOCH_STEPS = {"dcn": EARLIER_TRAIN_STEPS, "deepfm": EARLIER_TRAIN_STEPS,
                        "attention": TRAIN_STEPS, "attention@adamw": DENSE_STEPS,
                        "dssm": DSSM_STEPS, "nrms": DENSE_STEPS}
ROOFLINE_TRACED_STEPS = 4


def roofline_trainer(recipe: str, dev: torch.device, workdir: str, ds):
    """The trainer of a training path of this script on ``dev``, its model
    from the path's seed (drawn on the host, so the card and the CPU start
    from the same weights), prepared for ``ds`` as ``fit`` prepares it (the
    DSSM's logQ table)."""
    from news_recsys_tpu_torch import zoo
    from news_recsys_tpu_torch.models.dssm import build_dssm
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.retrieval import DSSMTrainer
    from news_recsys_tpu_torch.training.trainer import Trainer

    if recipe == "dssm":
        cfg = dssm_config()
        trainer = DSSMTrainer(cfg, build_dssm(cfg, seed=SEED + 25, device=dev),
                              workdir=workdir, device=dev)
    elif recipe == "nrms":
        cfg = zoo.mind_nrms_config()
        model = build_ranker(cfg, seed=SEED + 6, device=dev)
        model.set_titles(torch.from_numpy(nrms_arrays(cfg, 1, SEED + 52)[0]))
        trainer = Trainer(cfg, model, workdir=workdir, device=dev)
    else:
        cfg = train_config(recipe)
        trainer = Trainer(cfg, build_ranker(cfg, seed=SEED + 6, device=dev), workdir=workdir,
                          device=dev)
    trainer.prepare(ds)
    return trainer


def roofline_dataset(recipe: str):
    from news_recsys_tpu_torch import zoo
    from news_recsys_tpu_torch.training.trainer import PackedDataset
    steps = ROOFLINE_EPOCH_STEPS[recipe]
    if recipe == "dssm":
        return PackedDataset(dssm_arrays(TRAIN_BATCH * steps, SEED + 20))
    if recipe == "nrms":
        cfg = zoo.mind_nrms_config()
        return PackedDataset(nrms_arrays(cfg, cfg.dataset.batch_size * steps, SEED + 52)[1])
    return PackedDataset(training_arrays(train_config(recipe), TRAIN_BATCH * steps, SEED + 9))


def roofline_batches(trainer, ds, n: int) -> list:
    """The first ``n`` batches of ``ds`` on the trainer's device, in order."""
    from news_recsys_tpu_torch.training.trainer import BatchPacker, unpack_batch
    packer, bs = BatchPacker(ds), trainer.cfg.dataset.batch_size
    ones = torch.ones(bs, device=trainer.device)
    return [unpack_batch(*(torch.from_numpy(m[i * bs:(i + 1) * bs]).to(trainer.device)
                           for m in (packer.int_mat, packer.float_mat)),
                         ones, packer.layout_key()) for i in range(n)]


def compare_step_costs(card: dict, cpu: dict, path: str) -> None:
    """Fails unless the card's count equals the CPU's exactly: FLOPs (the
    total, by units and each kernel's), bytes, and each op's tally."""
    if card != cpu:
        diff = {k: (card[k], cpu[k]) for k in card if card[k] != cpu[k]}
        raise AssertionError(f"roofline {path}: the card's count differs from the CPU's "
                             f"(card, CPU): {diff}")


def foreach_optimizers(state) -> None:
    """Set the optimizers of a CPU training state to the foreach form that
    torch.optim takes for CUDA tensors, so the CPU runs the card's ops."""
    for opt in vars(state).values():
        if isinstance(opt, torch.optim.Optimizer):
            for group in opt.param_groups:
                group["foreach"] = True


def traced_step_ms(trainer, state, batches) -> float:
    """Device time of a step: the sum of the device kernels' and copies'
    durations over ``batches`` under ``torch.profiler`` (user annotations,
    which span other kernels, left out, as ``chip_profile.device_events``
    reads a trace), over the number of steps."""
    carry = trainer._epoch_carry(2, state.step, len(batches))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            trainer.train_step(state, batch, carry)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not events:
        raise AssertionError("torch.profiler saw no device kernel in the traced steps")
    return sum(e.self_device_time_total for e in events) / 1e3 / len(batches)


def roofline_path(dev: torch.device, name: str, smi: str, path: str) -> tuple:
    """One training path's roofline: a warm step counted by ``step_cost`` on a
    copy of the state on the card and on the CPU, from the same state and
    batch, the CPU's optimizers in the card's foreach form (the counts must
    be equal); the card's wall time a step of a warm
    epoch (``BATCH / examples_per_sec``, as the reference's bench reads it)
    and its device time a step from a ``torch.profiler`` trace; the shares
    at both, none over 100%. Returns (the path's entry of the kernels line,
    the card's kernel launches in the counted step)."""
    from news_recsys_tpu_torch.utils.roofline import step_cost, step_utilisation

    recipe = ROOFLINE_PATHS[path]
    ds = roofline_dataset(recipe)
    costs, trainers, states = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for side, d in (("cpu", torch.device("cpu")), ("card", dev)):
            trainer = roofline_trainer(recipe, d, os.path.join(tmp, side), ds)
            state = trainer.init_state()
            if side == "cpu":
                foreach_optimizers(state)
            warm, counted, *_ = roofline_batches(trainer, ds, 2)
            carry = trainer._epoch_carry(0, state.step, 2)
            trainer.train_step(state, warm, carry)
            reset_launches()
            costs[side] = step_cost(trainer.train_step, copy.deepcopy(state), counted,
                                    copy.deepcopy(carry))
            trainers[side], states[side] = trainer, state
        launches = read_launches()
        compare_step_costs(costs["card"], costs["cpu"], path)
        calls = {k: v["calls"] for k, v in costs["card"]["kernels"].items()}
        if {k: n for k, n in launches.items() if n} != calls:
            raise AssertionError(f"roofline {path}: the counted step launched {launches}, its "
                                 f"count names {calls}")
        trainer, state = trainers["card"], states["card"]
        trainer.train_epoch(state, ds, epoch=0)
        _, epoch = trainer.train_epoch(state, ds, epoch=1)
        batch = trainer.cfg.dataset.batch_size
        wall_s = batch / epoch["examples_per_sec"]
        device_s = traced_step_ms(trainer, state,
                                  roofline_batches(trainer, ds, ROOFLINE_TRACED_STEPS)) / 1e3
    cost = costs["card"]
    shares = {at: step_utilisation(cost["flops"], cost["bytes"], t, device=dev,
                                   flops_by_units=cost["flops_by_units"])
              for at, t in (("wall", wall_s), ("device", device_s))}
    for at, util in shares.items():
        if "mfu_pct" not in util:
            raise AssertionError(f"roofline {path}: the card {name!r} has no published peaks")
        if util["mfu_pct"] > 100 or util["hbm_bw_util_pct"] > 100:
            raise AssertionError(f"roofline {path}: a share over 100% at the {at} time: {util} "
                                 f"(the count or the time is wrong)")
    log(f"roofline {path} ({recipe}, batch {batch}) on {name} ({smi}): flops_per_step "
        f"{cost['flops']} (by units {cost['flops_by_units']}), hbm_bytes_per_step "
        f"{cost['bytes']} (the CPU's count equal); peak {shares['wall']['peak_flops']:.4g} "
        f"FLOP/s ({shares['wall']['peak_units']}); wall {wall_s * 1e3:.4f} ms a step (warm "
        f"epoch of {epoch['steps']}): mfu_pct {shares['wall']['mfu_pct']} (by units "
        f"{shares['wall']['mfu_pct_by_units']}), hbm_bw_util_pct "
        f"{shares['wall']['hbm_bw_util_pct']}; device {device_s * 1e3:.4f} ms a step (traced, "
        f"{ROOFLINE_TRACED_STEPS} steps): mfu_pct {shares['device']['mfu_pct']} (by units "
        f"{shares['device']['mfu_pct_by_units']}), hbm_bw_util_pct "
        f"{shares['device']['hbm_bw_util_pct']}; kernels {cost['kernels']}")
    entry = {"recipe": recipe, "card": smi, "flops_per_step": cost["flops"],
             "flops_by_units": cost["flops_by_units"], "hbm_bytes_per_step": cost["bytes"],
             "peak_flops": shares["wall"]["peak_flops"],
             "peak_units": shares["wall"]["peak_units"], "kernels": cost["kernels"],
             "wall_step_ms": wall_s * 1e3, "device_step_ms": device_s * 1e3,
             **{f"{k}_at_{at}": shares[at][k] for at in shares
                for k in ("mfu_pct", "mfu_pct_by_units", "hbm_bw_util_pct")}}
    return entry, launches


def roofline_phase(dev: torch.device, name: str, smi: str) -> tuple:
    """Each training path's roofline (:func:`roofline_path`); fails unless
    each kernel of :func:`counted_kernels` was counted on a path. Returns
    ({path: entry}, {roofline_<path>: the counted step's launches})."""
    torch.backends.cuda.matmul.allow_tf32 = False        # the card is held to the CPU
    entries, paths = {}, {}
    for path in ROOFLINE_PATHS:
        entries[path], paths[f"roofline_{path}"] = timed(f"roofline {path}", roofline_path, dev,
                                                         name, smi, path)
    counted = {k for e in entries.values() for k in e["kernels"]}
    if counted != set(counted_kernels()):
        raise AssertionError(f"roofline: no path counted {set(counted_kernels()) - counted}")
    return entries, paths


FULLSCALE_SYNTH = ("--news 3000 --users 3000 --train-impressions 3000 --dev-impressions 600 "
                   "--seed 3")
# the base rows, then the variant paths: bf16 tables and towers at the
# large batch, the dense step with the FM kernels, random corpus negatives
# (both rankers) and the all-dense DSSM
FULLSCALE_MODELS = ("dcn", "dssm@aug+logq+ns8", "dcn@b8192+bf16", "fm@adamw", "dcn@rneg4",
                    "attention@rneg4", "dssm@aug+logq+adamw")
FULLSCALE_QUERIES = 256
# the cascades of the phase: (path, ranker row); each path's launches counted alone
FULLSCALE_CASCADES = (("fullscale", "dcn"), ("fullscale_attention", "attention_rneg4"))


def load_script(name: str):
    """``scripts/<name>.py`` of this checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(REPO_DIR, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def fullscale_phase(dev: torch.device, name: str, smi: str) -> dict:
    """The full-scale campaign's two scripts on the card at a tiny depth
    (module docstring, item 14): every row of ``FULLSCALE_MODELS`` for an
    epoch, then a cascade over the DSSM's checkpoint for each ranker of
    ``FULLSCALE_CASCADES``; returns each cascade evaluation's launches. The
    training runs' own processes are not counted here: they run the
    ``train`` command whose launches the ``cli`` phase counts."""
    launches, results, walls = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        work = os.path.join(tmp, "work")
        rankers = os.path.join(tmp, "rankers.json")
        t0 = time.perf_counter()
        art = load_script("fullscale_rankers_torch").main(
            ["--prepare", "--workdir", work, "--synth-args", FULLSCALE_SYNTH,
             "--models", ",".join(FULLSCALE_MODELS), "--epochs", "1",
             "--jobs", str(len(FULLSCALE_MODELS)), "--device", str(dev), "--out", rankers,
             "--val-logs", os.path.join(tmp, "logs")])
        t_runs = time.perf_counter() - t0
        docs = [(rankers, art)]
        for path, ranker in FULLSCALE_CASCADES:
            out = os.path.join(tmp, f"{path}.json")
            reset_launches()
            t0 = time.perf_counter()
            results[path] = load_script("cascade_eval_torch").main(
                ["--recall-cfg", os.path.join(work, "dssm_aug+logq+ns8.yaml"),
                 "--recall-ckpt", os.path.join(work, "exp_dssm_aug+logq+ns8", "ckpts",
                                               "epoch_000.pt"),
                 "--ranker-cfg", os.path.join(work, f"{ranker}.yaml"),
                 "--ranker-ckpt", os.path.join(work, f"exp_{ranker}"),
                 "--max-queries", str(FULLSCALE_QUERIES), "--device", str(dev), "--out", out])
            torch.cuda.synchronize()
            launches[path] = read_launches()
            walls[path] = round(time.perf_counter() - t0, 2)
            docs.append((out, results[path]))
        for path, doc in docs:
            with open(path) as f:
                if json.load(f) != doc:
                    raise AssertionError(f"{path} is not what the script returned")
        with open(os.path.join(work, "prepare.json")) as f:
            prep = json.load(f)["wall_seconds"]
    values = {f"{r['model']} {cohort} {k}": v for r in art["results"]
              for cohort, vals in r["best"].items() for k, v in vals.items()
              if k in ("AUC", "HR@10")}
    for path, res in results.items():
        values.update({f"{path} {k}": res[k] for k in ("HR@10_recall_only", "HR@10_cascade")})
    if ([r["model"] for r in art["results"]] != [m.replace("@", "_") for m in FULLSCALE_MODELS]
            or not all(math.isfinite(v) for v in values.values())
            or any(res["queries"] != FULLSCALE_QUERIES for res in results.values())):
        raise AssertionError(f"fullscale: {values}, {[r['queries'] for r in results.values()]} "
                             "queries")
    for doc in (art, *results.values()):
        if not doc["device"]["name"].startswith("NVIDIA"):
            raise AssertionError(f"fullscale: the artifact names {doc['device']}")
    log(f"fullscale on {name} ({smi}): prepare {prep} s; runs (--jobs {len(FULLSCALE_MODELS)}) "
        f"{t_runs:.2f} s, walls {[(r['model'], r['wall_seconds']) for r in art['results']]}; "
        f"cascades of {FULLSCALE_QUERIES} queries {walls} s; device {art['device']}")
    log(f"fullscale values: {json.dumps(values)}")
    return launches


MIND_PARITY_MODELS = ("deep", "dcn", "attention")
MIND_PARITY_TOL = 1e-4              # the val log prints four decimals
# the kernels of the harness's scoring: the dev split's batches of 512 through
# the DCN's cross stack, and the attention ranker's block and ``entities`` pool
MIND_PARITY_KERNELS = ("dcn_cross_stack", "fused_transformer_block", "fused_lookup_pool")


def config_paths(raw: dict, *dirs: str) -> dict:
    """``raw`` (a config's dict) with each of ``dirs`` in its paths named by
    its place: configs of two work directories compare equal."""
    text = json.dumps(raw)
    for i, d in enumerate(dirs):
        text = text.replace(d, f"<dir{i}>")
    return json.loads(text)


def mind_parity_phase(dev: torch.device, name: str, smi: str) -> dict:
    """The MIND parity harness and the popularity baseline on the card at
    the ``fullscale`` phase's depth (module docstring, item 15); returns the
    launches of the harness's scoring. Its training processes run the
    ``train`` command whose launches the ``cli`` phase counts."""
    import shutil

    import yaml

    from news_recsys_tpu_torch.data.packed_dataset import PackedDataset
    from news_recsys_tpu_torch.config import load_config
    from news_recsys_tpu_torch.utils.log_analysis import best_epoch, parse_log

    parity = load_script("mind_parity_torch")
    popularity = load_script("popularity_baseline_torch")
    errs = {}
    with tempfile.TemporaryDirectory() as tmp:
        work, logs = os.path.join(tmp, "work"), os.path.join(tmp, "logs")
        reset_launches()
        t0 = time.perf_counter()
        art = parity.main(["--synth", "--workdir", work, "--synth-args", FULLSCALE_SYNTH,
                           "--models", ",".join(MIND_PARITY_MODELS), "--epochs", "1",
                           "--jobs", str(len(MIND_PARITY_MODELS)), "--device", str(dev),
                           "--out", os.path.join(tmp, "parity.json"), "--val-logs", logs])
        torch.cuda.synchronize()
        launches = read_launches()
        t_run = time.perf_counter() - t0
        with open(os.path.join(tmp, "parity.json")) as f:
            if json.load(f) != art:
                raise AssertionError("mind_parity: the artifact is not what the script returned")
        if [r["model"] for r in art["results"]] != list(MIND_PARITY_MODELS) or \
                not art["device"]["name"].startswith("NVIDIA"):
            raise AssertionError(f"mind_parity: rows {[r['model'] for r in art['results']]}, "
                                 f"device {art['device']}")
        batches = -(-len(PackedDataset.open_split(
            load_config(os.path.join(work, "dcn.yaml")), "dev")) // TRAIN_BATCH)
        want = {k: batches for k in MIND_PARITY_KERNELS}
        if {k: launches[k] for k in want} != want:
            raise AssertionError(f"mind_parity: launches {launches}, expected {want}")

        for row in art["results"]:
            model = row["model"]
            best = best_epoch(parse_log(os.path.join(logs, f"{model}_val_log.log")))
            overall = best["data"]["Overall"]
            if best["epoch"] != row["best_epoch"] or row["val_log_overall"] != overall:
                raise AssertionError(f"mind_parity {model}: best epoch {row['best_epoch']}, "
                                     f"the log's {best['epoch']}")
            for ours, theirs in (("AUC", "AUC"), ("nDCG@10", "NDCG@10"), ("MRR", "MRR@10")):
                if not abs(row[ours] - overall[theirs]) <= MIND_PARITY_TOL:
                    raise AssertionError(f"mind_parity {model}: {ours} {row[ours]} against the "
                                         f"val log's {theirs} {overall[theirs]}")
            cfg = os.path.join(work, f"{model}.yaml")
            ckpt = os.path.join(work, f"exp_{model}", "ckpts",
                                f"epoch_{row['best_epoch']:03d}.pt")
            uids, card_scores, labels = parity.score_dev(cfg, ckpt, model, str(dev))
            cpu_scores = parity.score_dev(cfg, ckpt, model, "cpu")[1]
            errs[model] = float(np.abs(card_scores - cpu_scores).max())
            if not errs[model] <= ANSWER_TOL:
                raise AssertionError(f"mind_parity {model}: card against CPU {errs[model]}")
            table = parity.per_user_ranking_metrics(uids, card_scores, labels)
            if any(abs(row[k] - v) > 1e-5 for k, v in table.items()):
                raise AssertionError(f"mind_parity {model}: the row {row} is not the table "
                                     f"{table} of the card's scores")

        copy_dir = os.path.join(tmp, "copy")
        shutil.copytree(os.path.join(work, "Data", "MIND"), copy_dir)
        work2 = os.path.join(tmp, "work_data")
        t0 = time.perf_counter()
        again = parity.main(["--data", copy_dir, "--workdir", work2, "--models", "",
                             "--device", str(dev), "--out", os.path.join(tmp, "data.json")])
        t_data = time.perf_counter() - t0
        bases = []
        for w, d in ((work, os.path.join(work, "Data", "MIND")), (work2, copy_dir)):
            with open(os.path.join(w, "base.yaml")) as f:
                bases.append(config_paths(yaml.safe_load(f), d, w))
        if again["checksums"] != art["checksums"] or bases[0] != bases[1]:
            raise AssertionError("mind_parity: the --data route's manifest or base.yaml differs")

        pre = os.path.join(work, "tmp", "preprocess")
        hrs = []
        for i, where in enumerate((str(dev), "cpu")):
            pop = popularity.main(["--pre", pre, "--device", where,
                                   "--out", os.path.join(tmp, f"pop_{i}.json")])
            hrs.append({k: v for k, v in pop.items() if k.startswith("HR@") or k == "queries"})
        if hrs[0] != hrs[1] or not hrs[0]["queries"] > 0:
            raise AssertionError(f"mind_parity: popularity on the card {hrs[0]}, CPU {hrs[1]}")
    log(f"mind_parity on {name} ({smi}): harness (--jobs {len(MIND_PARITY_MODELS)}) "
        f"{t_run:.2f} s, data step {art['wall_seconds']['data_step']} s, walls "
        f"{[(r['model'], r['wall_seconds']) for r in art['results']]}; --data route "
        f"{t_data:.2f} s; predict card vs CPU {errs}; launches {want}")
    log("mind_parity table:\n" + art["table_markdown"])
    log(f"mind_parity popularity: {hrs[0]}")
    return {"mind_parity": launches}


def reset_launches() -> None:
    for f in counted_kernels().values():
        f.launches = 0


def read_launches() -> dict:
    return {n: f.launches for n, f in counted_kernels().items()}


# The kernels each path must launch: at least once (None), or exactly as
# many times as given. Serving: one user-tower pool and one ranker forward a
# request. Training: one forward and one backward a step, and one scatter
# for each large table that updates (the attention ranker's item and user
# tables); the all-dense step pools ``entities`` and scatters nothing.
N_REQUESTS = 1 + REQUESTS
PATH_KERNELS = {
    "serve": {"dcn_cross_stack": None, "fused_lookup_pool": None},
    "train": {"dcn_cross_stack": EARLIER_TRAIN_STEPS, "dcn_cross_bwd": EARLIER_TRAIN_STEPS,
              "scatter_rows_set": None},
    "serve_deepfm": {"fm_second_order": None, "fused_lookup_pool": None},
    "train_deepfm": {"fm_second_order": None, "fm_second_order_bwd": None,
                     "scatter_rows_set": None},
    # NRMS: the attention's forward and backward once for each encoder a step
    "train_nrms": {"masked_mhsa": 2 * NRMS_STEPS, "masked_mhsa_bwd": 2 * NRMS_STEPS,
                   "fused_transformer_block": 0, "fused_lookup_pool": 0},
    "train_zoo": {"fm_second_order": None, "fm_second_order_bwd": None,
                  "scatter_rows_set": None, "fused_transformer_block": ZOO_CHECK_STEPS,
                  "fused_transformer_block_bwd": ZOO_CHECK_STEPS},
    "serve_attention": {"fused_transformer_block": N_REQUESTS, "fused_lookup_pool": N_REQUESTS,
                        "fused_transformer_block_bwd": 0, "scatter_rows_set": 0},
    "train_attention": {"fused_transformer_block": TRAIN_STEPS,
                        "fused_transformer_block_bwd": TRAIN_STEPS,
                        "scatter_rows_set": TRAIN_STEPS, "fused_lookup_pool": 0},
    "train_attention_dense": {"fused_transformer_block": DENSE_STEPS,
                              "fused_transformer_block_bwd": DENSE_STEPS,
                              "fused_lookup_pool": DENSE_STEPS,
                              "fused_lookup_pool_bwd": DENSE_STEPS, "scatter_rows_set": 0},
    # the DSSM's all-dense step pools ``hist`` (65,280 x 16, L 30) once a
    # step and runs the pool's backward once a step; its validation pools
    # each batch of 512 queries once; the rowwise variant pools in plain ops
    # on the gathered rows and scatters the user table a step (the item
    # table's 15,872 slots of 65,280 rows take the dense AdaGrad route, as the
    # sparse attention step's item table does: one scatter a step there)
    "train_dssm": {"fused_lookup_pool": DSSM_STEPS + -(-DSSM_QUERIES // TRAIN_BATCH),
                   "fused_lookup_pool_bwd": DSSM_STEPS, "scatter_rows_set": 0},
    "train_dssm_rowwise": {"scatter_rows_set": CHECK_STEPS, "fused_lookup_pool": 0,
                           "fused_lookup_pool_bwd": 0},
    # the optimizer variants' epochs: sparse_adamw writes the table and both
    # moments through the scatter, three launches a table a step (the DSSM
    # has two tables); K-step write-back one launch an apply; a bfloat16
    # table takes the unique-row layout and a plain write, no scatter
    "train_dcn_sparse_adamw": {"dcn_cross_stack": EARLIER_TRAIN_STEPS,
                               "dcn_cross_bwd": EARLIER_TRAIN_STEPS,
                               "scatter_rows_set": 3 * EARLIER_TRAIN_STEPS},
    "train_dcn_K4": {"dcn_cross_stack": LAZY_STEPS, "dcn_cross_bwd": LAZY_STEPS,
                     "scatter_rows_set": LAZY_APPLIES},
    "train_dcn_bf16": {"dcn_cross_stack": EARLIER_TRAIN_STEPS,
                       "dcn_cross_bwd": EARLIER_TRAIN_STEPS, "scatter_rows_set": 0},
    "train_dcn_b8192_bf16": {"dcn_cross_stack": B8192_STEPS, "dcn_cross_bwd": B8192_STEPS,
                             "scatter_rows_set": 0},
    "train_dssm_sparse_adamw": {"scatter_rows_set": 3 * 2 * DSSM_STEPS, "fused_lookup_pool": 0,
                                "fused_lookup_pool_bwd": 0},
    # the command line: the DCN's, the attention ranker's and the DSSM's
    # all-dense steps, validations and predictions (the pool pools
    # ``entities`` and ``hist``)
    "cli": {"dcn_cross_stack": None, "dcn_cross_bwd": None, "fused_transformer_block": None,
            "fused_transformer_block_bwd": None, "fused_lookup_pool": None,
            "fused_lookup_pool_bwd": None, "scatter_rows_set": 0},
    # the cascade that `serve --ranker-ckpt` composes pools the user
    # tower and runs the DCN's cross stack once a request; the slab epochs
    # launch what their steps launch on the resident path
    "serve_ranker_ckpt": {"fused_lookup_pool": SERVE_REQUESTS, "dcn_cross_stack": SERVE_REQUESTS,
                          "dcn_cross_bwd": 0, "scatter_rows_set": 0},
    "train_slab": {"dcn_cross_stack": SLAB_STEPS, "dcn_cross_bwd": SLAB_STEPS,
                   "scatter_rows_set": SLAB_STEPS},
    "train_slab_budget": {"fused_transformer_block": BIG_STEPS,
                          "fused_transformer_block_bwd": BIG_STEPS,
                          "scatter_rows_set": BIG_STEPS, "fused_lookup_pool": 0},
    "train_slab_dssm": {"fused_lookup_pool": DSSM_SLAB_STEPS,
                        "fused_lookup_pool_bwd": DSSM_SLAB_STEPS, "scatter_rows_set": 0},
    # two ranks on one card (rank 0's counts; every rank's are checked in the
    # phase): Trainer.fit's epoch at (1, 2), one cross stack forward and
    # backward and one shard-local scatter a step; and each held run
    "parallel": PARALLEL_FIT_LAUNCHES,
    **{f"parallel_{n}": want for n, want in PARALLEL_LAUNCHES.items()},
    # the roofline phase's counted step of each training path: a forward and
    # a backward, and a scatter for each large table on the sorted route
    "roofline_train": {"dcn_cross_stack": 1, "dcn_cross_bwd": 1, "scatter_rows_set": 1},
    "roofline_train_deepfm": {"fm_second_order": 1, "fm_second_order_bwd": 1,
                              "scatter_rows_set": None},
    "roofline_train_attention": {"fused_transformer_block": 1, "fused_transformer_block_bwd": 1,
                                 "scatter_rows_set": 1, "fused_lookup_pool": 0},
    "roofline_train_attention_dense": {"fused_transformer_block": 1,
                                       "fused_transformer_block_bwd": 1, "fused_lookup_pool": 1,
                                       "fused_lookup_pool_bwd": 1, "scatter_rows_set": 0},
    "roofline_train_dssm": {"fused_lookup_pool": 1, "fused_lookup_pool_bwd": 1,
                            "scatter_rows_set": 0},
    "roofline_train_nrms": {"masked_mhsa": 2, "masked_mhsa_bwd": 2, "scatter_rows_set": 0},
    # the full-scale scripts' cascade evaluation of 256 queries in one chunk:
    # the DSSM's user tower pools ``hist`` for recall alone and again for the
    # cascade, the DCN scores the 256 x 100 candidates in one forward; the
    # attention ranker scores them through one block and pools ``entities``
    # once more
    "fullscale": {"fused_lookup_pool": 2, "dcn_cross_stack": 1, "dcn_cross_bwd": 0,
                  "scatter_rows_set": 0},
    "fullscale_attention": {"fused_lookup_pool": 3, "fused_transformer_block": 1,
                            "fused_transformer_block_bwd": 0, "dcn_cross_stack": 0,
                            "scatter_rows_set": 0},
    # the MIND parity harness's scoring of the dev split (its exact count, a
    # launch a batch, is checked in the phase): forwards only
    "mind_parity": {**{k: None for k in MIND_PARITY_KERNELS}, "dcn_cross_bwd": 0,
                    "fused_transformer_block_bwd": 0, "fused_lookup_pool_bwd": 0,
                    "scatter_rows_set": 0, "fm_second_order": 0},
}


def check_launches(paths: dict) -> None:
    for path, wanted in PATH_KERNELS.items():
        for k, n in wanted.items():
            got = paths[path][k]
            if (got <= 0) if n is None else (got != n):
                raise AssertionError(f"{k}: the {path} path launched it {got} times, expected "
                                     f"{'at least once' if n is None else n}: {paths[path]}")


def timed(label: str, fn, *args):
    """``fn(*args)``, with the phase's wall time logged."""
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    log(f"phase {label}: {time.perf_counter() - t0:.2f} s")
    return out


def run(dev: torch.device) -> None:
    name = torch.cuda.get_device_name(0)
    smi = card()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    timed("build", build_kernels, dev)
    kernels = timed("kernels of serving", check_kernels, dev)
    kernels += timed("kernels of DCN training", check_training_kernels, dev)
    kernels += timed("the row scatter", check_scatter, dev)
    fm_train_fwd, fm_bwd = timed("kernels of FM training", check_fm_training_kernels, dev)
    next(k for k in kernels if k["name"] == "fm_second_order")["at_train_shape"] = fm_train_fwd
    kernels.append(fm_bwd)
    kernels += timed("kernels of the attention ranker", check_attention_kernels, dev)
    kernels.insert(1, timed("the pool's forward", check_pool_forward, dev))
    kernels.append(timed("the pool's backward", check_pool_backward, dev))
    kernels += timed("NRMS's attention", check_mhsa_kernels, dev)
    floor = timed("launch floor", launch_floor_ms)
    paths = {"serve": timed("serve", serve_phase, dev, name, smi),
             "train": timed("train", train_phase, dev, name, smi),
             "serve_deepfm": timed("serve_deepfm", serve_phase, dev, name, smi, "deepfm"),
             "train_deepfm": timed("train_deepfm", train_phase, dev, name, smi, "deepfm"),
             "train_zoo": timed("train_zoo", zoo_phase, dev),
             "train_nrms": timed("train_nrms", train_nrms_phase, dev, name),
             "serve_attention": timed("serve_attention", serve_phase, dev, name, smi,
                                      "attention"),
             "train_attention": timed("train_attention", train_phase, dev, name, smi,
                                      "attention"),
             "train_attention_dense": timed("train_attention_dense", train_phase, dev, name,
                                            smi, "attention@adamw"),
             **timed("train_dssm", train_dssm_phase, dev, name, smi),
             **timed("cli", cli_phase, dev, name, smi),
             **timed("train_variants", train_variants_phase, dev, smi),
             **timed("runtime", runtime_phase, dev, name, smi)}
    roofline, roofline_paths = timed("roofline", roofline_phase, dev, name, smi)
    paths.update(roofline_paths)
    # traced before ranks are spawned on the card: after a spawn, this
    # process's torch.profiler trace misses the replay's first kernel
    next(k for k in kernels if k["name"] == "dcn_cross_bwd")["device_kernels"] = \
        timed("trace of the cross backward", trace_cross_bwd, dev)
    paths.update(timed("parallel", parallel_phase, dev, name, smi))
    paths.update(timed("fullscale", fullscale_phase, dev, name, smi))
    paths.update(timed("mind_parity", mind_parity_phase, dev, name, smi))
    check_launches(paths)
    for k in kernels:
        k["launches_by_path"] = {path: counts[k["name"]] for path, counts in paths.items()}
        k["launches"] = sum(k["launches_by_path"].values())
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no path launched it")

    log(f"phases done {time.perf_counter() - T_START:.2f} s after the script started")
    log(smi)
    log(json.dumps({"kernels": kernels, "launch_floor_ms": floor, "roofline": roofline}))
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
