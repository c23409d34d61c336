"""``block_roofline.train`` and ``block_roofline.batch``: the fused
Transformer block's kernels (``ops/fused_attention.py``: the forward, and
in training the backward and its reduction of the parameter gradients)
against their least time, summed over the traced calls: least time over
device time. A call's least time is the larger of its FLOPs at the TF32
peak (the block runs on the tensor cores in 3xTF32, counted once) and its
bytes at the HBM bandwidth, with P = 4 D^2 + 2 D F + 9 D + F parameters:

- forward: B L (2 (4 D^2 + 2 D F) + 4 L D) FLOPs; 4 (2 B L D + B L + P)
  bytes (x read, y written, the mask and the parameters read);
- backward: three times the forward's FLOPs (it recomputes the forward);
  4 (3 B L D + B L + 2 P) bytes.

B is the training batch, or ``users x fetch`` rows of a served request."""

from __future__ import annotations

from metrics import shapes


def read(ctx, name: str):
    prof = ctx.profile
    if not prof:
        return None
    model = ctx.config["ranker"]
    att = model["attention"]
    hist = next(f for f in model["fields"] if f[0] == att["hist_feature"])
    L, D, F = hist[3], model["tables"][hist[1]][1], att["ff_dim"]
    B = (ctx.config["train"]["batch_size"] if name.endswith(".train")
         else ctx.params["users"] * ctx.config["serve"]["fetch"])
    P = 4 * D * D + 2 * D * F + 9 * D + F
    fwd_calls = bwd_calls = 0
    seconds = 0.0
    for kernel, (count, t) in prof["kernels"].items():
        if "block_fwd" in kernel:
            fwd_calls += count
        elif "block_bwd" in kernel:
            bwd_calls += count
        elif "reduce_partials" not in kernel:
            continue
        seconds += t
    if not fwd_calls:
        return None
    flops = shapes.block_flops(B, L, D, F)
    fwd = shapes.least_time(ctx.config, {"tf32": flops}, 4 * (2 * B * L * D + B * L + P))
    bwd = shapes.least_time(ctx.config, {"tf32": 3 * flops}, 4 * (3 * B * L * D + B * L + 2 * P))
    return 100.0 * (fwd_calls * fwd + bwd_calls * bwd) / seconds
