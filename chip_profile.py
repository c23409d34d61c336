"""Where a cascade request's and a training step's time go in the PyTorch
port, on one CUDA GPU.

    python3 chip_profile.py [--users 64,256,1024] [--requests 10]
    python3 chip_profile.py --block-split
    python3 chip_profile.py --pool-split
    python3 chip_profile.py --cross-split
    python3 chip_profile.py --scatter-split
    python3 chip_profile.py --fm-split
    python3 chip_profile.py --routes

Builds the full-width MIND cascades of ``chip_smoke.py`` (seeded weights,
65,238 items, fetch 100; a DCN and an attention ranker over the same
recall) on the card and, for each request size, calls
``CascadeRecommender.recommend`` directly (no HTTP), in three separate runs
over the same requests after two warm-up requests:

1. plain: wall time per request of parsing the request JSON, ``recommend``
   and encoding the answer, with nothing added to the code;
2. layers: wall time of the user tower, the top-k search, the recall stage
   and the ranker's forward, from wrappers that synchronise the card around each
   (removed again before the next run);
3. traced: a ``torch.profiler`` trace of 5 requests, for the device kernel
   time per request and the top kernels.

The device-busy share is the traced device time per request over the
plain run's ``recommend`` time, so neither the tracer's nor the wrappers'
overhead enters it.

Training: the full-width DCN, DeepFM and attention rankers of
``chip_smoke.py``'s training phases (``mind_config("dcn",
embedding_optimizer="rowwise_adagrad")``, ``mind_ranker_config("deepfm")``,
``attention_config()``, and ``mind_ranker_config("attention@adamw")`` on the
all-dense step, whose spans are forward, backward, AdamW over every
parameter and the AUC; batch 512) under ``Trainer.train_epoch``, and the
DSSM of configs/dssm.yaml (``chip_smoke.dssm_config()``, the all-dense
step: towers, loss, backward, AdamW; and its rowwise AdaGrad variant,
``dssm@rowwise``) under ``DSSMTrainer.train_epoch``, and the optimizer
variants of ``chip_smoke.py``'s ``train_variants`` phase (the DCN on
``sparse_adamw``, with K-step write-back without its step checkpoints, with
bfloat16 tables and towers at batch 512 and 8,192; the DSSM on
``sparse_adamw``), after a warm-up epoch, in the same three runs over epochs of TRAIN_STEPS
(24) steps: plain (ms per step, nothing added), layers (gather, fields,
forward, backward, dense AdamW, dedup, rowwise update + scatter, AUC, each
wrapped with card syncs), traced (device time per step, top kernels). The
device-busy share of a step is the traced device time per step over the
plain run's. For the training paths of ``chip_smoke.py``'s ``roofline``
phase, one step counted by ``utils/roofline.py``'s ``step_cost`` gives
``mfu_pct`` and ``hbm_bw_util_pct`` at the plain step and at the device time.

``--block-split`` instead takes the fused Transformer block's kernels apart at
the attention ranker's widths: each launch of the backward by name (both
routes, batch 512, from a ``torch.profiler`` trace), and the general route's
forward at batch 6,400 and 512 whole, with its products alone and with its
attention alone (two copies of ``csrc/fused_attention.cu`` with one line
changed each, built beside the library; their outputs are not the block's);
and the tiled route with its TF32 split made by ``cvt.rna.tf32.f32`` instead
of integer rounding (``-DNRT_SPLIT_WITH_CVT``), forward and backward.

``--pool-split`` takes the fused lookup + pool's kernels apart at
``chip_smoke.py``'s shapes: the backward at batch 512 on ``entities`` (30,080
x 16, L 5) and ``hist`` (65,280 x 16, L 30), Zipf and uniform ids, whole
(graph replays) and each launch by name from a ``torch.profiler`` trace
(memset, scan, accumulate, write); the forward whole at a 1,024-user request
(B 1,024, L 30), ``entities`` (B 512, L 5) and a 64-user request (B 64, L 30),
uniform and Zipf ids.

``--cross-split`` takes the DCN cross stack's kernels apart at
``chip_smoke.py``'s three shapes (the forward at a request's B 6,400 and at a
step's B 512 with the backward's residuals, the backward at B 512 and 6,400;
D 112, 3 layers): whole (graph replays), each launch by name from a
``torch.profiler`` trace; the backward (its sum kernel by programmatic
dependent launch) against a copy that launches the sum kernel plainly after
the rows kernel, bit for bit (eager and in a CUDA graph) and in four turns
each; and the DCN training step's device time with them, traced.

``--scatter-split`` times the row scatter at ``chip_smoke.py``'s three
shapes (a DCN step's arena, the sparse attention step's item and user
tables): the kernel, copies of it built beside the library (64 and 128
threads a block, a relaxed load of the values, the values loaded only after
the row ids where the warp or where the slot itself writes), ``index_copy_``
and the plain version, in turns.

``--fm-split`` times the FM kernels (5 fields of 15) in four turns each: the
forward at a request's B 6,400 and a step's B 512, the kernel (F and D fixed
at compile time) against a copy that takes them at run time; the backward
at B 512 and 6,400, the kernel against copies of its staged path with the
other of 8, 16 and 32 rows a block and a copy that takes the general path (a
warp a row) at 5 x 15; each against the plain version, bit for bit among the
staged copies.

``--routes`` times rowwise AdaGrad's two update routes for one table at the
path shapes (the DCN's arena at batch 512 and 8,192: 1,024 and 16,384
slots; the sparse attention step's item table: 15,872 slots): the sorted
route (sort, segment sum, update, row scatter kernel) against the dense
full-table route, in turns, eager (CUDA events) and as graph replays, with
the host waits of each; then the sparse attention step and the rowwise DSSM
step whole with their item table on either route, in turns;
``training/sparse_step.py``'s ``DENSE_UPDATE_MIN_SHARE`` comes from it.
"""

from __future__ import annotations

import argparse
import collections
import copy
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
from news_recsys_tpu_torch.ops import fm_kernel  # noqa: E402
from news_recsys_tpu_torch.serving import _user_batch_from_json  # noqa: E402

TRAIN_STEPS = 24            # steps in each profiled training epoch


def plain_times(casc, reqs) -> dict:
    """Mean wall ms per request of each step of an unmodified request."""
    totals = collections.defaultdict(float)
    for req in reqs:
        body = json.dumps(req)
        t0 = time.perf_counter()
        parsed = json.loads(body)
        batch = _user_batch_from_json(casc, parsed["users"])
        t1 = time.perf_counter()
        ids, scores = casc.recommend(batch, k=chip_smoke.K, histories=parsed["histories"])
        t2 = time.perf_counter()
        json.dumps({"ids": ids, "scores": scores})
        t3 = time.perf_counter()
        totals["parse request JSON"] += t1 - t0
        totals["cascade.recommend"] += t2 - t1
        totals["encode answer JSON"] += t3 - t2
        totals["whole request, no HTTP"] += t3 - t0
    return {k: v / len(reqs) * 1e3 for k, v in totals.items()}


def sync_timer(fn, label, totals):
    """``fn`` with the card synchronised around it and its wall time added
    to ``totals[label]``."""
    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        totals[label] += time.perf_counter() - t
        return out
    return timed


def layer_times(casc, reqs) -> dict:
    """Mean wall ms per request of each layer, the card synchronised around each."""
    totals = collections.defaultdict(float)
    spans = [(casc.recall, "_encode", "recall: user tower"),
             (casc.recall.searcher, "search", "recall: matmul + topk + copy"),
             (casc.recall, "recommend", "recall: total (incl. history dedup)"),
             (casc.ranker_model, "forward", f"rank: {casc.ranker_cfg.name} forward")]
    for obj, name, label in spans:
        setattr(obj, name, sync_timer(getattr(obj, name), label, totals))
    try:
        for req in reqs:
            casc.recommend(_user_batch_from_json(casc, req["users"]), k=chip_smoke.K,
                           histories=req["histories"])
    finally:
        for obj, name, _ in spans:
            delattr(obj, name)          # back to the class's own method
    return {k: v / len(reqs) * 1e3 for k, v in totals.items()}


def device_events(prof) -> list:
    """A ``torch.profiler`` trace's device kernels and copies, by name; user
    annotations (``Optimizer.step#...`` ranges), which span other kernels,
    are left out so that nothing is counted twice."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def traced_kernels(casc, reqs) -> list:
    """Device kernels of ``reqs`` under ``torch.profiler``."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for req in reqs:
            casc.recommend(_user_batch_from_json(casc, req["users"]), k=chip_smoke.K,
                           histories=req["histories"])
        torch.cuda.synchronize()
    return device_events(prof)


# the kernel of each profiled model's forward (and backward)
FORWARD_KERNELS = {"dcn": "cross", "deepfm": "FM", "attention": "fused block",
                   "attention@adamw": "fused block", "dssm": "pool",
                   "dssm@rowwise": "no", "dcn@sparse_adamw": "cross", "dcn@K4": "cross",
                   "dcn@bf16": "cross", "dcn_b8192@bf16": "cross", "dssm@sparse_adamw": "no"}


def rowwise_spans(cfg) -> list:
    """The rowwise update's two spans for ``cfg``: its dedup (the sorted or
    the unique-row layout) and its optimizer (AdaGrad or Adam, with the
    row scatter kernel or a plain write). K-step write-back runs both inside
    its flush, every K steps."""
    from news_recsys_tpu_torch.training import sparse_step

    adam = cfg.train_hparams.embedding_optimizer == "sparse_adamw"
    bf16 = cfg.mesh.param_dtype == "bfloat16"
    write = "plain write" if bf16 else "scatter kernel"
    return [(sparse_step, "_unique_rows" if bf16 else "_joint_dedup",
             f"dedup ({'unique rows' if bf16 else 'sort'} + segment sum)"),
            (sparse_step, "rowwise_adam_update" if adam else "rowwise_adagrad_update",
             f"rowwise {'Adam' if adam else 'AdaGrad'} + {write}")]


def train_spans(trainer, state, ranker: str) -> list:
    """(object, attribute, label) of each layer of the ranker's step."""
    from news_recsys_tpu_torch.models import dssm
    from news_recsys_tpu_torch.training import dense_step, retrieval, sparse_step

    kernel = FORWARD_KERNELS[ranker]
    if ranker == "dssm":
        return [(trainer.model, "forward", "towers (embed, pool kernel, MLPs)"),
                (dssm, "dssm_loss_from_embeddings", "loss (normalise, negatives, InfoNCE)"),
                (torch.Tensor, "backward", "backward (incl. the pool bwd kernel)"),
                (state.opt, "step", "AdamW over every parameter")]
    if ranker.startswith("dssm@"):
        return [(retrieval, "gather_large_rows", "gather (large-table rows)"),
                (retrieval, "fields_from_rows", "fields (small-table gathers, pooling)"),
                (trainer.model, "towers_from_fields", "towers (MLPs)"),
                (retrieval, "dssm_loss_from_embeddings", "loss (normalise, negatives, InfoNCE)"),
                (torch.Tensor, "backward", "backward"),
                (state.dense_opt, "step", "dense AdamW"),
                *rowwise_spans(trainer.cfg)]
    if not trainer.sparse_embeddings:
        return [(trainer.model, "forward", f"forward (embed, pool, {kernel} kernel, MLP)"),
                (torch.Tensor, "backward", f"backward (incl. {kernel} and pool bwd kernels)"),
                (state.opt, "step", "AdamW over every parameter"),
                (dense_step, "binned_auc_update", "AUC histogram")]
    return [(sparse_step, "gather_large_rows", "gather (large-table rows)"),
            (sparse_step, "fields_from_rows", "fields (small-table gathers, masks)"),
            (trainer.model, "forward_from_fields", f"forward ({kernel} kernel + MLP)"),
            (torch.Tensor, "backward", f"backward (incl. {kernel} bwd kernel)"),
            (state.dense_opt, "step", "dense AdamW"),
            *rowwise_spans(trainer.cfg),
            (sparse_step, "binned_auc_update", "AUC histogram")]


def train_layer_times(trainer, state, ds, epoch, ranker: str) -> dict:
    """Mean wall ms per step of each layer of the step, the card
    synchronised around each."""
    totals = collections.defaultdict(float)
    spans = train_spans(trainer, state, ranker)
    saved = [(obj, name, obj.__dict__.get(name)) for obj, name, _ in spans]
    for obj, name, label in spans:
        setattr(obj, name, sync_timer(getattr(obj, name), label, totals))
    try:
        _, metrics = trainer.train_epoch(state, ds, epoch)
    finally:
        for obj, name, old in saved:
            if old is None:
                delattr(obj, name)          # back to the class's own method
            else:
                setattr(obj, name, old)
    return {k: v / metrics["steps"] * 1e3 for k, v in totals.items()}


def profile_training(smi: str, ranker: str = "dcn") -> None:
    from news_recsys_tpu_torch.config import config_from_dict, config_to_dict
    from news_recsys_tpu_torch.models.dssm import build_dssm
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.retrieval import DSSMTrainer
    from news_recsys_tpu_torch.training.trainer import PackedDataset, Trainer

    steps = TRAIN_STEPS
    dev = torch.device("cuda")
    if ranker in chip_smoke.VARIANTS:
        raw = config_to_dict(chip_smoke.variant_config(ranker))
        raw["train_hparams"]["ckpt_every_steps"] = 0          # no checkpoint writes timed
        cfg = config_from_dict(raw)
    elif ranker.startswith("dssm"):
        cfg = chip_smoke.dssm_config("rowwise_adagrad" if ranker == "dssm@rowwise" else "adamw")
    else:
        cfg = chip_smoke.train_config(ranker)
    bs = cfg.dataset.batch_size
    if ranker.startswith("dssm"):
        ds = PackedDataset(chip_smoke.dssm_arrays(bs * steps, chip_smoke.SEED + 20))
    else:
        ds = PackedDataset(chip_smoke.training_arrays(cfg, bs * steps, chip_smoke.SEED + 9))
    with tempfile.TemporaryDirectory() as tmp:
        if ranker.startswith("dssm"):
            trainer = DSSMTrainer(cfg, build_dssm(cfg, seed=chip_smoke.SEED + 25, device=dev),
                                  workdir=tmp, device=dev)
        else:
            trainer = Trainer(cfg, build_ranker(cfg, seed=chip_smoke.SEED + 6, device=dev),
                              workdir=tmp, device=dev)
        trainer.prepare(ds)                                              # as fit does
        state = trainer.init_state()
        state, _ = trainer.train_epoch(state, ds, 0)                     # warm-up
        _, plain = trainer.train_epoch(state, ds, 1)
        step_ms = bs / plain["examples_per_sec"] * 1e3
        layers = train_layer_times(trainer, state, ds, 2, ranker)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.train_epoch(state, ds, 3)
            torch.cuda.synchronize()
    kernels = device_events(prof)
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    print(f"\n== training {ranker}, batch {bs}, epochs of {steps} steps ({smi})")
    print(f"  {'plain: step (train_epoch wall / steps)':44s} {step_ms:9.3f} ms")
    for k, v in layers.items():
        print(f"  {'layers: ' + k:44s} {v:9.3f} ms")
    print(f"  {'layers: sum of the spans above':44s} {sum(layers.values()):9.3f} ms")
    print(f"  {'steps/s, examples/s (plain)':44s} {1e3 / step_ms:9.1f} "
          f"{plain['examples_per_sec']:.0f}")
    print(f"  device kernels (profiler, {steps} steps) {dev_ms:.3f} ms/step, {launches:.0f} "
          f"kernels and copies/step -> device busy {dev_ms / step_ms * 100:.2f}% of the "
          f"plain run's step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.key[:72]:72s} {e.self_device_time_total / steps:8.1f} us/step "
              f"({e.count // steps} calls)")
    if ranker in chip_smoke.ROOFLINE_PATHS.values():
        print_roofline(trainer, state, ds, step_ms, dev_ms)


def print_roofline(trainer, state, ds, step_ms: float, dev_ms: float) -> None:
    """``mfu_pct`` and ``hbm_bw_util_pct`` of one step (``step_cost`` on a copy
    of the state) at the plain run's step time and at the traced device time."""
    from news_recsys_tpu_torch.utils.roofline import step_cost, step_utilisation

    batch = chip_smoke.roofline_batches(trainer, ds, 1)[0]
    cost = step_cost(trainer.train_step, copy.deepcopy(state), batch,
                     trainer._epoch_carry(4, state.step, 1))
    for label, ms in (("plain step", step_ms), ("device time", dev_ms)):
        u = step_utilisation(cost["flops"], cost["bytes"], ms / 1e3, device=trainer.device,
                             flops_by_units=cost["flops_by_units"])
        print(f"  {'roofline at the ' + label:44s} mfu_pct {u['mfu_pct']}, hbm_bw_util_pct "
              f"{u['hbm_bw_util_pct']} ({cost['flops']} FLOPs, {cost['bytes']} bytes a step; "
              f"peak {u['peak_units']})")


# (what a variant of the general forward leaves out, the line changed, its replacement)
FORWARD_VARIANTS = {
    "products alone (no attention loop)": (
        "  for (int h = 0; h < H; ++h) {\n    attention_probs(sS, sQKV, ldq, sM, L, D, hd, h, scale);"
        "\n    const float* v = sQKV",
        "  for (int h = 0; h < 0; ++h) {\n    attention_probs(sS, sQKV, ldq, sM, L, D, hd, h, scale);"
        "\n    const float* v = sQKV"),
    "attention alone (no products)": (
        "  const int groups = (R + RB - 1) / RB;\n  for (int item = threadIdx.x; item < groups * N;",
        "  const int groups = 0;\n  for (int item = threadIdx.x; item < groups * N;"),
}


def build_variant(src, tag: str, entry: str, flags=()):
    """``src`` built as a library of its own under the build directory;
    returns its C entry point ``entry``."""
    import ctypes
    import subprocess

    from news_recsys_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / f"{tag}.so"
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", f"-I{_build.CSRC_DIR}", *flags, "-o", str(lib),
                    str(src)], check=True)
    fn = getattr(ctypes.CDLL(str(lib)), entry)
    fn.argtypes, fn.restype = _build.SIGNATURES[entry], ctypes.c_int
    return fn


def source_variant(source: str, changes, tag: str, entry: str):
    """``csrc/<source>`` with each ``(old, new)`` of ``changes`` applied (each
    ``old`` must occur once), built under ``build/variants``; returns its
    entry ``entry``."""
    from news_recsys_tpu_torch.ops import _build

    text = (_build.CSRC_DIR / source).read_text()
    for old, new in changes:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {tag!r}: {old!r} occurs {text.count(old)} times")
        text = text.replace(old, new)
    src = _build.BUILD_DIR / "variants" / f"{tag}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(text)
    return build_variant(src, tag, entry)


def block_split(smi: str) -> None:
    import ctypes

    from news_recsys_tpu_torch.ops import _build
    from news_recsys_tpu_torch.ops import fused_attention as fa

    dev = torch.device("cuda")
    L, D, H, F = chip_smoke.BLOCK_L, chip_smoke.BLOCK_D, chip_smoke.BLOCK_H, chip_smoke.BLOCK_F
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"\n== the fused block's kernels taken apart, L={L} D={D} H={H} F={F} ({smi})")
    *params, x, mask, dy = chip_smoke.block_case(chip_smoke.TRAIN_BATCH, chip_smoke.SEED, dev)
    reps = 20
    for route in fa.ROUTES:
        fa.fused_transformer_block_bwd(params, x, mask, dy, H, route=route)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fa.fused_transformer_block_bwd(params, x, mask, dy, H, route=route)
            torch.cuda.synchronize()
        print(f"  backward, B={chip_smoke.TRAIN_BATCH}, route {route}: "
              f"{fa.plan_shape(x.shape[0], L, D, F, H, sms, True, route)}")
        for e in sorted(device_events(prof), key=lambda e: -e.self_device_time_total):
            print(f"    {e.key[:72]:72s} {e.self_device_time_total / reps:8.2f} us/call "
                  f"({e.count // reps} launches)")
    variants = {tag: source_variant("fused_attention.cu", [change], f"variant{i}",
                                    "nrt_fused_block_fwd")
                for i, (tag, change) in enumerate(FORWARD_VARIANTS.items())}
    cvt = {d: build_variant(_build.CSRC_DIR / f"fused_attention_tiled_{d}.cu", f"cvt_{d}",
                            f"nrt_fused_block_tiled_{d}", ("-DNRT_SPLIT_WITH_CVT",))
           for d in ("fwd", "bwd")}
    for B in (chip_smoke.USERS_PER_REQUEST * chip_smoke.FETCH, chip_smoke.TRAIN_BATCH):
        *params, x, mask, dy = chip_smoke.block_case(B, chip_smoke.SEED, dev)
        plan = fa.plan_shape(B, L, D, F, H, sms, False, "general")
        out, ptrs = torch.empty_like(x), fa._param_pointers(params)
        args = (x.data_ptr(), mask.data_ptr(), ctypes.addressof(ptrs), out.data_ptr(), None,
                B, L, D, F, H, plan.blocks)
        with torch.inference_mode():
            whole = {r: chip_smoke.device_ms(
                lambda: fa.fused_transformer_block(params, x, mask, H, route=r),
                **chip_smoke.DEEP) for r in fa.ROUTES}
            parts = {tag: chip_smoke.device_ms(lambda: fn(*args, fa.stream_ptr(x)),
                                               **chip_smoke.DEEP) for tag, fn in variants.items()}
        print(f"  forward, B={B}: " + ", ".join(f"{r} route {t * 1e3:.2f} us"
                                                for r, t in whole.items()))
        for tag, t in parts.items():
            print(f"    general route, {tag:36s} {t * 1e3:8.2f} us")
        plan = fa.plan_shape(B, L, D, F, H, sms, False)
        args = (x.data_ptr(), mask.data_ptr(), ctypes.addressof(ptrs), out.data_ptr(), B, L,
                plan.blocks)
        t = chip_smoke.device_ms(lambda: cvt["fwd"](*args, fa.stream_ptr(x)), **chip_smoke.DEEP)
        print(f"    tiled route, the split by cvt.rna.tf32.f32           {t * 1e3:8.2f} us")
    plan = fa.plan_shape(B, L, D, F, H, sms, True)
    dx, dflat = torch.empty_like(x), x.new_empty((fa.param_floats(D, F),))
    partial = x.new_empty((plan.blocks * dflat.numel(),))
    args = (x.data_ptr(), mask.data_ptr(), dy.data_ptr(), ctypes.addressof(ptrs), dx.data_ptr(),
            dflat.data_ptr(), partial.data_ptr(), B, L, plan.blocks)
    whole = {r: chip_smoke.device_ms(
        lambda: fa.fused_transformer_block_bwd(params, x, mask, dy, H, route=r),
        **chip_smoke.DEEP) for r in fa.ROUTES}
    t = chip_smoke.device_ms(lambda: cvt["bwd"](*args, fa.stream_ptr(x)), **chip_smoke.DEEP)
    print(f"  backward, B={B}: " + ", ".join(f"{r} route {v * 1e3:.2f} us"
                                             for r, v in whole.items()))
    print(f"    tiled route, the split by cvt.rna.tf32.f32           {t * 1e3:8.2f} us")


def pool_split(smi: str) -> None:
    from news_recsys_tpu_torch.ops.fused_lookup_pool import (fused_lookup_pool,
                                                             fused_lookup_pool_bwd)

    dev, B, D, reps = torch.device("cuda"), chip_smoke.TRAIN_BATCH, chip_smoke.POOL_D, 20
    print(f"\n== the pool's backward taken apart, D={D} B={B} ({smi})")
    for V, L in chip_smoke.POOL_BWD_SHAPES:
        for skewed in (True, False):
            ids, mask, longest = chip_smoke.pool_bwd_case(V, L, B, skewed,
                                                          chip_smoke.SEED + 30 + L)
            g = torch.from_numpy(np.random.default_rng(chip_smoke.SEED + 40 + L)
                                 .standard_normal((B, D)).astype(np.float32)).to(dev)
            ids, mask = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
            designs = {"memset, scan, accumulate, write":
                       lambda: fused_lookup_pool_bwd(ids, mask, g, V)}
            print(f"  V={V} L={L} ids={'zipf' if skewed else 'uniform'} longest_run={longest}")
            for label, fn in designs.items():
                whole = chip_smoke.device_ms(fn, **chip_smoke.DEEP)
                fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
                events = device_events(prof)
                parts = sum(e.self_device_time_total for e in events) / reps
                print(f"    {label}: {whole * 1e3:.2f} us a call (graph replays); its launches "
                      f"alone (eager, traced) {parts:.2f} us:")
                for e in sorted(events, key=lambda e: -e.self_device_time_total):
                    print(f"      {e.key[:70]:70s} {e.self_device_time_total / reps:8.2f} us "
                          f"({e.count // reps} a call)")
    print(f"\n== the pool's forward, D={D} ({smi})")
    shapes = {"request, 1,024 users": (65280, 30, 1024), **chip_smoke.POOL_FWD_SHAPES}
    for label, (V, L, Bf) in shapes.items():
        for skewed in (False, True):
            table, ids, mask, longest = chip_smoke.pool_fwd_case(V, L, Bf, skewed,
                                                                 chip_smoke.SEED + 60, dev)
            with torch.inference_mode():
                t = chip_smoke.device_ms(lambda: fused_lookup_pool(table, ids, mask))
            print(f"  {label} (V={V} L={L} B={Bf}), ids={'zipf' if skewed else 'uniform'} "
                  f"longest_run={longest}: {t * 1e3:.2f} us")


# a copy of the cross backward that launches its sum kernel plainly, not by
# programmatic dependent launch (source text replaced: what, by what)
CROSS_PLAIN_LAUNCH = ("  config.numAttrs = 1;", "  config.numAttrs = 0;")


def cross_bwd_variant(entry, *args):
    """:func:`dcn_cross_bwd` on ``args`` through ``entry``, the C entry of a
    copy of its source (``_launch_cross_bwd``: the wrapper's plan and
    buffers)."""
    from news_recsys_tpu_torch.ops.dcn_kernel import _launch_cross_bwd

    def checked(*a):
        rc = entry(*a)
        if rc:
            raise RuntimeError(f"a copy of the cross backward: cudaError_t {rc}")
    return _launch_cross_bwd(checked, *args)


def cross_split(smi: str) -> None:
    from news_recsys_tpu_torch.ops import dcn_kernel as dk

    dev, reps, TB = torch.device("cuda"), 20, chip_smoke.TRAIN_BATCH
    serve_B = chip_smoke.USERS_PER_REQUEST * chip_smoke.FETCH
    x0, ws, bs, _ = chip_smoke.cross_case(serve_B, chip_smoke.SEED, dev)
    tx0, tws, tbs, tg = chip_smoke.cross_case(TB, chip_smoke.SEED + 7, dev)
    with torch.no_grad():
        _, ss = dk._cross_fwd_kernel(tx0, tws, tbs, residuals=True)
    kernels = {f"forward, B={serve_B}": lambda: dk._cross_fwd_kernel(x0, ws, bs, False),
               f"forward with residuals, B={TB}": lambda: dk._cross_fwd_kernel(tx0, tws, tbs,
                                                                                True),
               f"backward, B={TB}": lambda: dk.dcn_cross_bwd(tx0, tws, tbs, ss, tg)}
    floor = chip_smoke.device_ms(chip_smoke.launch_empty)
    print(f"\n== the cross stack's kernels, D=112 NL=3 ({smi}); an empty kernel "
          f"{floor * 1e3:.2f} us")
    with torch.no_grad():
        for label, fn in kernels.items():
            print(f"  {label}: {chip_smoke.device_ms(fn) * 1e3:.2f} us (graph replays)")
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            for e in sorted(device_events(prof), key=lambda e: -e.self_device_time_total):
                print(f"    {e.key[:64]:64s} {e.self_device_time_total / reps:7.2f} us "
                      f"({e.count // reps} a call, eager)")

    plain_launch = source_variant("dcn_cross_bwd.cu", [CROSS_PLAIN_LAUNCH], "cross_plain_launch",
                                  "nrt_dcn_cross_bwd")
    for B, seed in ((TB, chip_smoke.SEED + 7), (serve_B, chip_smoke.SEED)):
        bx0, bws, bbs, bg = chip_smoke.cross_case(B, seed, dev)
        with torch.no_grad():
            args = (bx0, bws, bbs, dk._cross_fwd_kernel(bx0, bws, bbs, residuals=True)[1], bg)
            want = dk.dcn_cross_bwd(*args)
            for how, got in (
                    ("eager", cross_bwd_variant(plain_launch, *args)),
                    ("graph replay", chip_smoke.graph_replay(cross_bwd_variant, plain_launch,
                                                             *args)),
                    ("the kernel's graph replay", chip_smoke.graph_replay(dk.dcn_cross_bwd,
                                                                          *args))):
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"B={B}: {how} differs from an eager call")
            fns = {"sum by dependent launch (shipped)": lambda: dk.dcn_cross_bwd(*args),
                   "sum by a plain launch": lambda: cross_bwd_variant(plain_launch, *args)}
            times = collections.defaultdict(list)
            for name in [*fns, *reversed(fns), *fns, *reversed(fns)]:
                times[name].append(chip_smoke.device_ms(fns[name]))
        print(f"  backward, B={B}: plan {dk._plan(bx0, 3, True, True)._asdict()}; bit for bit "
              f"equal, eager and graph replay")
        print_turns(times)

    cross_step_split(smi)


def cross_step_split(smi: str) -> None:
    """The DCN training step's device time, and its cross kernels' part: two
    traced epochs of TRAIN_STEPS steps after a warm-up epoch."""
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training.trainer import PackedDataset, Trainer

    bs, steps = chip_smoke.TRAIN_BATCH, TRAIN_STEPS
    cfg = chip_smoke.train_config("dcn")
    ds = PackedDataset(chip_smoke.training_arrays(cfg, bs * steps, chip_smoke.SEED + 9))
    dev, runs = torch.device("cuda"), []
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(cfg, build_ranker(cfg, seed=chip_smoke.SEED + 6, device=dev),
                          workdir=tmp, device=dev)
        state, _ = trainer.train_epoch(trainer.init_state(), ds, 0)          # warm-up
        for epoch in (1, 2):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                trainer.train_epoch(state, ds, epoch)
                torch.cuda.synchronize()
            events = device_events(prof)
            cross = [e for e in events if "dcn_cross" in e.key]
            runs.append((sum(e.self_device_time_total for e in events) / steps,
                         sum(e.self_device_time_total for e in cross) / steps,
                         sum(e.count for e in cross) / steps))
    print(f"\n== the DCN training step, batch {bs}, traced epochs of {steps} steps ({smi})")
    print("  device time a step " + ", ".join(f"{r[0]:.1f}" for r in runs)
          + " us; of it the cross kernels " + ", ".join(f"{r[1]:.2f}" for r in runs)
          + f" us ({runs[0][2]:.0f} launches a step)")


# copies of the scatter kernel (source text replaced: what, by what): 64 and
# 128 threads a block; a relaxed load of the values in place of the volatile
# one; and two that load a slot's values only after its row ids (a second
# trip to memory), where its warp or where the slot itself has a row to
# write (the latter is what the compiler makes of a plain load before the
# branch)
SCATTER_LOADS = """  const T val = load_now(vals + i);
  if ((unsigned)row >= (unsigned)V || (has_next && next == row)) return;
  table[(size_t)row * chunks + c] = val;"""
SCATTER_THREADS = "constexpr int kThreads = 256;"
SCATTER_VARIANTS = {
    "64 threads a block": (SCATTER_THREADS, "constexpr int kThreads = 64;"),
    "128 threads a block": (SCATTER_THREADS, "constexpr int kThreads = 128;"),
    "relaxed.gpu load of the values": ("ld.volatile.global.v4", "ld.relaxed.gpu.global.v4"),
    "values only where the warp writes": (SCATTER_LOADS, """\
  const bool write = (unsigned)row < (unsigned)V && !(has_next && next == row);
  if (!__any_sync(__activemask(), write)) return;
  const T val = __ldg(vals + i);
  if (write) table[(size_t)row * chunks + c] = val;"""),
    "values only where the slot writes": (SCATTER_LOADS, """\
  if ((unsigned)row >= (unsigned)V || (has_next && next == row)) return;
  table[(size_t)row * chunks + c] = __ldg(vals + i);""")}


def print_turns(times: dict) -> None:
    for name, t in times.items():
        print(f"    {name:36s} {np.mean(t) * 1e3:7.2f} us (graph replays; turns "
              + ", ".join(f"{x * 1e3:.2f}" for x in t) + ")")


def scatter_split(smi: str) -> None:
    from news_recsys_tpu_torch.ops import stream_ptr
    from news_recsys_tpu_torch.ops.scatter_rows import scatter_rows_plain, scatter_rows_set
    from news_recsys_tpu_torch.training.scatter_layouts import scatter_layout_stats

    variants = {label: source_variant("scatter_rows.cu", [change], f"scatter{i}",
                                      "nrt_scatter_rows_set")
                for i, (label, change) in enumerate(SCATTER_VARIANTS.items())}
    dev = torch.device("cuda")
    floor = chip_smoke.device_ms(chip_smoke.launch_empty)
    print(f"\n== the row scatter ({smi}); an empty kernel {floor * 1e3:.2f} us")
    for label, arrays in chip_smoke.scatter_cases().items():
        table, rows, vals = (torch.from_numpy(a).to(dev) for a in arrays)
        (V, D), S = table.shape, rows.shape[0]
        want = scatter_rows_plain(table.clone(), rows, vals)
        rows64 = rows.long()
        fns = {"kernel (256 threads a block)": lambda: scatter_rows_set(table, rows, vals)}
        for name, fn in variants.items():
            def launch(fn=fn, t=table):
                rc = fn(t.data_ptr(), rows.data_ptr(), vals.data_ptr(), S, D, V, stream_ptr(t))
                if rc:
                    raise RuntimeError(f"a scatter variant: cudaError_t {rc}")
            copy = table.clone()
            launch(t=copy)
            torch.cuda.synchronize()
            if not torch.equal(copy, want):
                raise AssertionError(f"{label}, {name}: the table differs from the plain one's")
            fns[name] = launch
        fns["index_copy_"] = lambda: table.index_copy_(0, rows64, vals)
        fns["plain"] = lambda: scatter_rows_plain(table, rows, vals)
        times = collections.defaultdict(list)
        with torch.no_grad():
            for name in [*fns, *reversed(fns)]:
                times[name].append(chip_smoke.device_ms(fns[name]))
        print(f"  {label}: V={V} D={D} S={S} {scatter_layout_stats(arrays[1], V)}")
        print_turns(times)


# a copy of the FM forward whose staged kernel takes F and D at run time
# (source text replaced: what, by what; its loops then do not unroll)
FM_RUN_TIME = (
    ("template <int F, int D>\n__global__", "__global__"),
    ("float* __restrict__ out, int B) {", "float* __restrict__ out, int B, int F, int D) {"),
    ("fm_fwd_staged_kernel<5, 15><<<blocks, kRows * kLanes, smem, stream>>>(v, out, B);",
     "fm_fwd_staged_kernel<<<blocks, kRows * kLanes, smem, stream>>>(v, out, B, F, D);"))


# copies of the FM backward (source text replaced: what, by what): the
# staged block's other row counts, and the general path at 5 x 15
FM_BWD_ROWS = f"constexpr int kBwdRows = {fm_kernel.FM_BWD_ROWS};"
FM_BWD_VARIANTS = {
    f"{rows} rows a block": [(FM_BWD_ROWS, f"constexpr int kBwdRows = {rows};")]
    for rows in (8, 16, 32) if rows != fm_kernel.FM_BWD_ROWS}
FM_BWD_VARIANTS["general path (a warp a row)"] = [
    ("  if (F == 5 && D == 15) {  // DeepFM's fields and columns\n"
     "    const unsigned blocks = (unsigned)((B + kBwdRows - 1) / kBwdRows);",
     "  if (false) {\n    const unsigned blocks = (unsigned)((B + kBwdRows - 1) / kBwdRows);")]


def fm_split(smi: str) -> None:
    from news_recsys_tpu_torch.ops import stream_ptr
    from news_recsys_tpu_torch.ops.fm_kernel import (fm_bwd_plain, fm_plain, fm_second_order,
                                                     fm_second_order_bwd, plan_fm_bwd,
                                                     plan_fm_fwd)

    dev = torch.device("cuda")
    F, D = chip_smoke.FM_F, chip_smoke.FM_D
    run_time = source_variant("fm_second_order.cu", FM_RUN_TIME, "fm_run_time", "nrt_fm_fwd")
    bwd_variants = {label: source_variant("fm_second_order.cu", changes, f"fm_bwd{i}",
                                          "nrt_fm_bwd")
                    for i, (label, changes) in enumerate(FM_BWD_VARIANTS.items())}
    floor = chip_smoke.device_ms(chip_smoke.launch_empty)
    print(f"\n== the FM kernels, F={F} D={D} ({smi}); an empty kernel {floor * 1e3:.2f} us")
    for B in (chip_smoke.USERS_PER_REQUEST * chip_smoke.FETCH, chip_smoke.TRAIN_BATCH):
        v = torch.from_numpy(np.random.default_rng(chip_smoke.SEED).standard_normal(
            (B, F, D)).astype(np.float32)).to(dev)
        out, want = torch.empty(B, device=dev), fm_second_order(v)

        def launch_run_time():
            rc = run_time(v.data_ptr(), out.data_ptr(), B, F, D, stream_ptr(v))
            if rc:
                raise RuntimeError(f"the run-time FM forward: cudaError_t {rc}")

        launch_run_time()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"B={B}: the run-time copy's bits differ from the kernel's")
        fns = {"kernel (F 5, D 15 at compile time)": lambda: fm_second_order(v),
               "F, D at run time": launch_run_time,
               "plain": lambda: fm_plain(v)}
        times = collections.defaultdict(list)
        with torch.no_grad():
            for name in [*fns, *reversed(fns), *fns, *reversed(fns)]:
                times[name].append(chip_smoke.device_ms(fns[name]))
        print(f"  forward, B={B}: plan {plan_fm_fwd(B, F, D)._asdict()}")
        print_turns(times)
    for B in (chip_smoke.TRAIN_BATCH, chip_smoke.USERS_PER_REQUEST * chip_smoke.FETCH):
        rng = np.random.default_rng(chip_smoke.SEED + 12)
        v = torch.from_numpy(rng.standard_normal((B, F, D)).astype(np.float32)).to(dev)
        g = torch.from_numpy(rng.standard_normal(B).astype(np.float32)).to(dev)
        dv, want = torch.empty_like(v), fm_second_order_bwd(v, g)
        torch.testing.assert_close(want, fm_bwd_plain(v, g), **chip_smoke.scaled_tol(want))
        fns = {f"kernel ({fm_kernel.FM_BWD_ROWS} rows a block)": lambda: fm_second_order_bwd(v, g)}
        for label, fn in bwd_variants.items():
            def launch(fn=fn, label=label):
                rc = fn(v.data_ptr(), g.data_ptr(), dv.data_ptr(), B, F, D, stream_ptr(v))
                if rc:
                    raise RuntimeError(f"the FM backward, {label}: cudaError_t {rc}")
            launch()
            torch.cuda.synchronize()
            if label.startswith("general"):
                torch.testing.assert_close(dv, want, **chip_smoke.scaled_tol(want))
            elif not torch.equal(dv, want):
                raise AssertionError(f"B={B}, {label}: the copy's bits differ from the kernel's")
            fns[label] = launch
        fns["plain"] = lambda: fm_bwd_plain(v, g)
        times = collections.defaultdict(list)
        with torch.no_grad():
            for name in [*fns, *reversed(fns), *fns, *reversed(fns)]:
                times[name].append(chip_smoke.device_ms(fns[name]))
        print(f"  backward, B={B}: plan {plan_fm_bwd(B, F, D)._asdict()}")
        print_turns(times)


# the rowwise AdaGrad update's path shapes: (model, batch, table); the DCN's
# arena at bench.py's two batches, the sparse attention step's item table
# (item_id and the unpooled history of 30: 15,872 slots of a batch of 512)
ROUTE_SHAPES = {"DCN arena, batch 512": ("dcn", 512, "arena_d32"),
                "DCN arena, batch 8,192": ("dcn", 8192, "arena_d32"),
                "attention item table, batch 512": ("attention", 512, "item_id")}


def event_ms(fn, rounds: int = 7, inner: int = 20) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``inner`` eager calls,
    a call: the update as the eager step runs it, launch overhead and any
    wait for the host included."""
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


SYNC_CALLS = 5


def syncs(fn) -> list:
    """Where SYNC_CALLS calls of ``fn`` made the host wait for the card: the
    file and line of the Python call of each operation that synchronised."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(SYNC_CALLS):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{'/'.join(w.filename.split('/')[-3:])}:{w.lineno}" for w in caught
            if "synchroniz" in str(w.message)]


def route_split(smi: str) -> None:
    """Rowwise AdaGrad's two routes for one table at ROUTE_SHAPES: the sorted
    route (the joint dedup's sort and segment sum, then the update and the
    row scatter kernel) and the dense full-table route (a (V, D) segment
    sum, then a pass over every row), in turns, each from its own copy of
    the table; after one call both hold the same table (within 1e-5). Times:
    CUDA events over eager calls (what the eager step pays) and, where the
    route captures, CUDA-graph replays (the device alone); and how often a
    call makes the host wait for the card."""
    from news_recsys_tpu_torch.config import table_specs
    from news_recsys_tpu_torch.models.embedding import padded_vocab
    from news_recsys_tpu_torch.training.scatter_layouts import update_route_case
    from news_recsys_tpu_torch.training.sparse_step import (_joint_dedup,
                                                            dense_rowwise_adagrad_update,
                                                            rowwise_adagrad_update)
    from news_recsys_tpu_torch.zoo import attention_arrays, attention_config, mind_config

    dev = torch.device("cuda")
    print(f"\n== rowwise AdaGrad update routes ({smi})")
    for label, (model, bs, name) in ROUTE_SHAPES.items():
        if model == "dcn":
            cfg = mind_config("dcn", batch_size=bs, embedding_optimizer="rowwise_adagrad")
            arrays = chip_smoke.ranking_arrays(bs, chip_smoke.SEED + 40)
        else:
            cfg = attention_config(batch_size=bs)
            arrays = attention_arrays(bs, seed=chip_smoke.SEED + 40)
        table_np, ids_np, g_np = update_route_case(cfg, arrays, chip_smoke.SEED + 41, name)
        (V, D), S = table_np.shape, ids_np.shape[0]
        vocab = table_specs(cfg)[name][0]
        ids, g = (torch.from_numpy(a).to(dev) for a in (ids_np, g_np))
        spec, spare = {name: (vocab, D)}, {name: padded_vocab(vocab) - 1}
        copies = {r: (torch.from_numpy(table_np).to(dev), torch.full((V,), 0.1, device=dev))
                  for r in ("sorted", "dense")}

        def sorted_route(t=copies["sorted"]):
            rows, grads = _joint_dedup({name: [(ids, g)]}, spec, spare)[name]
            rowwise_adagrad_update(t[0], t[1], rows, grads, 1e-3)

        def dense_route(t=copies["dense"]):
            dense_rowwise_adagrad_update(t[0], t[1], ids, g, 1e-3, max_id=vocab - 1)

        routes = {"sorted": sorted_route, "dense": dense_route}
        for route in routes.values():
            route()
        torch.testing.assert_close(copies["sorted"][0][:vocab], copies["dense"][0][:vocab],
                                   rtol=1e-5, atol=1e-5)
        turns = {r: [] for r in routes}
        for r in ("sorted", "dense", "dense", "sorted"):
            turns[r].append(event_ms(routes[r]))
        graph = {}
        for r, fn in routes.items():
            try:
                graph[r] = chip_smoke.device_ms(fn, rounds=7, inner=10)
            except RuntimeError as e:                      # a route that cannot be captured
                graph[r] = f"not capturable ({str(e).splitlines()[0][:60]})"
        rows, grads = _joint_dedup({name: [(ids, g)]}, spec, spare)[name]
        waits = {**{r: syncs(fn) for r, fn in routes.items()},
                 "sorted route's dedup": syncs(lambda: _joint_dedup({name: [(ids, g)]}, spec,
                                                                    spare)),
                 "sorted route's update": syncs(lambda: rowwise_adagrad_update(
                     *copies["sorted"], rows, grads, 1e-3))}
        distinct = int(np.unique(ids_np[(ids_np > 0) & (ids_np < vocab)]).size)
        print(f"  {label}: V {V} D {D}, {S} slots, {distinct} distinct rows")
        for r in routes:
            print(f"    {r:6s} route: eager {min(turns[r]):8.3f} ms a call (turns "
                  f"{', '.join(f'{t:.3f}' for t in turns[r])}); graph replay "
                  f"{graph[r] if isinstance(graph[r], str) else f'{graph[r]:.3f} ms'}; host "
                  f"waits in {SYNC_CALLS} calls {len(waits[r])} {waits[r]}")
        for part in ("sorted route's dedup", "sorted route's update"):
            print(f"    host waits in {SYNC_CALLS} calls of the {part}: {len(waits[part])} "
                  f"{waits[part]}")
    for ranker in ("attention", "dssm@rowwise"):
        step_routes(smi, ranker)

def step_routes(smi: str, ranker: str) -> None:
    """The ranker's whole training step (batch 512, epochs of TRAIN_STEPS)
    with its item table on the dense route (the port's choice) and on the
    sorted route (``DENSE_UPDATE_MIN_SHARE`` set past 1 for the epoch), in
    turns: wall ms a step of an untraced epoch and device ms a step of a
    traced one."""
    from news_recsys_tpu_torch.models.dssm import build_dssm
    from news_recsys_tpu_torch.models.rankers import build_ranker
    from news_recsys_tpu_torch.training import sparse_step
    from news_recsys_tpu_torch.training.retrieval import DSSMTrainer
    from news_recsys_tpu_torch.training.trainer import PackedDataset, Trainer

    dev, bs, steps = torch.device("cuda"), chip_smoke.TRAIN_BATCH, TRAIN_STEPS
    share = {"dense": sparse_step.DENSE_UPDATE_MIN_SHARE, "sorted": 2.0}
    times = {r: [] for r in share}
    with tempfile.TemporaryDirectory() as tmp:
        if ranker == "dssm@rowwise":
            cfg = chip_smoke.dssm_config("rowwise_adagrad")
            ds = PackedDataset(chip_smoke.dssm_arrays(bs * steps, chip_smoke.SEED + 20))
            trainer = DSSMTrainer(cfg, build_dssm(cfg, seed=chip_smoke.SEED + 25, device=dev),
                                  workdir=tmp, device=dev)
        else:
            cfg = chip_smoke.train_config(ranker)
            ds = PackedDataset(chip_smoke.training_arrays(cfg, bs * steps, chip_smoke.SEED + 9))
            trainer = Trainer(cfg, build_ranker(cfg, seed=chip_smoke.SEED + 6, device=dev),
                              workdir=tmp, device=dev)
        trainer.prepare(ds)                                              # as fit does
        state = trainer.init_state()
        state, _ = trainer.train_epoch(state, ds, 0)                     # warm-up
        try:
            for epoch, route in enumerate(("dense", "sorted", "sorted", "dense"), 1):
                sparse_step.DENSE_UPDATE_MIN_SHARE = share[route]
                _, plain = trainer.train_epoch(state, ds, epoch)
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    trainer.train_epoch(state, ds, epoch)
                    torch.cuda.synchronize()
                dev_ms = sum(e.self_device_time_total for e in device_events(prof)) / 1e3 / steps
                times[route].append((bs / plain["examples_per_sec"] * 1e3, dev_ms))
        finally:
            sparse_step.DENSE_UPDATE_MIN_SHARE = share["dense"]
    print(f"  {ranker} step, batch {bs}, the item table's update route ({smi}):")
    for route, runs in times.items():
        print(f"    {route:6s}: wall {', '.join(f'{w:.3f}' for w, _ in runs)} ms a step; device "
              f"{', '.join(f'{d:.3f}' for _, d in runs)} ms a step")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--users", default="64,256,1024")
    p.add_argument("--requests", type=int, default=10)
    p.add_argument("--block-split", action="store_true",
                   help="take the fused block's kernels apart instead")
    p.add_argument("--pool-split", action="store_true",
                   help="take the lookup + pool's kernels apart instead")
    p.add_argument("--cross-split", action="store_true",
                   help="take the cross stack's kernels apart instead")
    p.add_argument("--scatter-split", action="store_true",
                   help="time the row scatter's designs at its shapes instead")
    p.add_argument("--fm-split", action="store_true",
                   help="time the FM kernels against copies of other designs instead")
    p.add_argument("--routes", action="store_true",
                   help="time rowwise AdaGrad's sorted and dense routes at the path shapes")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = chip_smoke.card()
    print(smi, flush=True)
    if args.block_split:
        block_split(smi)
        return
    if args.pool_split:
        pool_split(smi)
        return
    if args.cross_split:
        cross_split(smi)
        return
    if args.scatter_split:
        scatter_split(smi)
        return
    if args.fm_split:
        fm_split(smi)
        return
    if args.routes:
        route_split(smi)
        return
    for ranker in ("dcn", "attention"):
        profile_serving(smi, ranker, args)
    for ranker in FORWARD_KERNELS:
        profile_training(smi, ranker)
    print(smi)


def profile_serving(smi: str, ranker: str, args) -> None:
    casc = chip_smoke.build_cascade(torch.device("cuda"), ranker)
    for users in map(int, args.users.split(",")):
        chip_smoke.USERS_PER_REQUEST = users
        reqs = chip_smoke.make_requests(2 + args.requests)
        for req in reqs[:2]:                                  # warm-up
            casc.recommend(_user_batch_from_json(casc, req["users"]), k=chip_smoke.K,
                           histories=req["histories"])
        plain = plain_times(casc, reqs[2:])
        layers = layer_times(casc, reqs[2:])
        traced = reqs[2:7]
        kernels = traced_kernels(casc, traced)
        dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / len(traced)
        print(f"\n== {ranker} cascade, {users} users/request, {args.requests} requests, "
              f"no HTTP ({smi})")
        for k, v in {**plain, **layers}.items():
            print(f"  {k:36s} {v:9.3f} ms")
        print(f"  {'users served per second':36s} "
              f"{users / plain['whole request, no HTTP'] * 1e3:9.0f}")
        print(f"  device kernels (profiler, {len(traced)} requests) {dev_ms:.3f} ms/request "
              f"-> device busy {dev_ms / plain['cascade.recommend'] * 100:.2f}% "
              f"of the plain run's recommend")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"    {e.key[:72]:72s} "
                  f"{e.self_device_time_total / len(traced):8.1f} us/request")


if __name__ == "__main__":
    main()
