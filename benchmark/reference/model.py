"""The benchmark's models in plain PyTorch, from the equations alone.

Nothing here imports the program under test: the sizes come from the
configuration files under ``benchmark/configs/``, the parameters from the
harness (drawn from the run's seed), and every op is a plain ``torch`` op in
float32, with no kernel, cache or batching of the program's.

- Fields: an id gathers its table's row, id 0 reads zeros; a ``pooled``
  array is the mean of its non-zero ids' rows (denominator + 1e-8); a
  ``sequence`` array stays (B, L, D) with its mask ``ids != 0``. Fields
  concatenate in the configuration's order.
- DCN v1 (Wang et al. 2017): ``x_{l+1} = x0 * (x_l . w_l) + b_l + x_l``,
  then an MLP over ``[x0, x_L]``.
- Attention ranker: post-norm Transformer blocks over the history (fused
  qkv, scores / sqrt(head dim), -1e9 on padding keys, LayerNorm eps 1e-6
  with the variance E[z^2] - E[z]^2), target-aware pooling with the item's
  row (an empty history pools to zeros), then the MLP over the other fields
  and the pooled vector.
- DSSM towers: Linear layers with LeakyReLU(0.2) between, L2-normalised
  outputs (norm held at 1e-12 or more).

Linear weights are (out, in) as ``nn.Linear``'s; the attention block's are
(in, out).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

NEG = -1e9
LN_EPS = 1e-6
POOL_EPS = 1e-8

Params = Dict[str, torch.Tensor]


def param_specs(model: dict, prefix: str = "") -> List[Tuple[str, tuple, str, float]]:
    """(name, shape, law, scale) of every parameter of a ranker or recall
    section of a configuration: ``law`` is ``normal`` (std ``scale``, row 0
    zero), ``uniform`` (+-``scale``), ``ones`` or ``zeros``."""
    out = [(f"{prefix}tables.{t}", (v, d), "normal", float(model["init_scale"]))
           for t, (v, d) in sorted(model["tables"].items())]

    def linear(name, n_in, n_out):
        bound = 1.0 / math.sqrt(n_in)
        out.extend([(f"{name}.weight", (n_out, n_in), "uniform", bound),
                    (f"{name}.bias", (n_out,), "uniform", bound)])

    if "tower" in model:                                  # a DSSM's two towers
        for side in ("user", "item"):
            n_in = sum(model["tables"][t][1] for _, t, _, _ in model[f"{side}_fields"])
            for i, (a, b) in enumerate(zip([n_in, *model["tower"]], model["tower"])):
                linear(f"{prefix}{side}_fc.layers.{i}", a, b)
        return out
    dims = {name: model["tables"][t][1] for name, t, _, _ in model["fields"]}
    width = sum(dims.values())
    if model["kind"] == "dcn":
        bound = math.sqrt(6.0 / (width + 1))
        out += [(f"{prefix}cross.ws", (model["cross_layers"], width), "uniform", bound),
                (f"{prefix}cross.bs", (model["cross_layers"], width), "zeros", 0.0)]
        tower_in = 2 * width
    else:
        att = model["attention"]
        D, F = dims[att["hist_feature"]], att["ff_dim"]
        for i in range(att["num_layers"]):
            b = f"{prefix}blocks.{i}."
            out += [(b + "attn.wqkv", (D, 3 * D), "uniform", 1 / math.sqrt(D)),
                    (b + "attn.bqkv", (3 * D,), "uniform", 1 / math.sqrt(D)),
                    (b + "attn.wo", (D, D), "uniform", 1 / math.sqrt(D)),
                    (b + "attn.bo", (D,), "uniform", 1 / math.sqrt(D)),
                    (b + "g1", (D,), "ones", 0.0), (b + "b1", (D,), "zeros", 0.0),
                    (b + "w1", (D, F), "uniform", 1 / math.sqrt(D)),
                    (b + "c1", (F,), "uniform", 1 / math.sqrt(D)),
                    (b + "w2", (F, D), "uniform", 1 / math.sqrt(F)),
                    (b + "c2", (D,), "uniform", 1 / math.sqrt(F)),
                    (b + "g2", (D,), "ones", 0.0), (b + "b2", (D,), "zeros", 0.0)]
        tower_in = width
    for i, (a, b) in enumerate(zip([tower_in, *model["hidden"]], model["hidden"])):
        linear(f"{prefix}tower.layers.{i}", a, b)
    return out


def gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``, id 0 reading zeros."""
    rows = torch.nn.functional.embedding(ids.long(), table)
    return rows * (ids != 0).to(rows.dtype)[..., None]


def fields(p: Params, specs, batch: Dict[str, torch.Tensor], prefix: str = "") -> tuple:
    """(the fields in ``specs`` order, {sequence name: its (B, L) mask})."""
    out, masks = [], {}
    for name, table, kind, _ in specs:
        ids = batch[name]
        rows = gather(p[f"{prefix}tables.{table}"], ids)
        if kind == "pooled":
            w = (ids != 0).to(rows.dtype)
            rows = (rows * w[..., None]).sum(dim=1) / (w.sum(dim=1, keepdim=True) + POOL_EPS)
        elif kind == "sequence":
            masks[name] = (ids != 0).to(rows.dtype)
        out.append(rows)
    return out, masks


def mlp(p: Params, name: str, x: torch.Tensor, n: int, slope: float = 0.0) -> torch.Tensor:
    """``n`` Linear layers, ReLU (LeakyReLU with ``slope``) between them."""
    for i in range(n):
        x = x @ p[f"{name}.layers.{i}.weight"].T + p[f"{name}.layers.{i}.bias"]
        if i < n - 1:
            x = torch.nn.functional.leaky_relu(x, slope) if slope else torch.relu(x)
    return x


def layer_norm(z: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    mean = z.mean(dim=-1, keepdim=True)
    var = (z * z).mean(dim=-1, keepdim=True) - mean * mean
    return (z - mean) * torch.rsqrt(var + LN_EPS) * g + b


def block(p: Params, name: str, x: torch.Tensor, mask: torch.Tensor, heads: int) -> torch.Tensor:
    """One post-norm Transformer block, (B, L, D) -> (B, L, D)."""
    B, L, D = x.shape
    hd = D // heads
    qkv = (x @ p[name + "attn.wqkv"] + p[name + "attn.bqkv"]).reshape(B, L, 3, heads, hd)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
    scores = torch.where(mask[:, None, None, :] > 0, scores, NEG)
    att = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(B, L, D)
    y1 = layer_norm(x + att @ p[name + "attn.wo"] + p[name + "attn.bo"], p[name + "g1"],
                    p[name + "b1"])
    ffn = torch.relu(y1 @ p[name + "w1"] + p[name + "c1"]) @ p[name + "w2"] + p[name + "c2"]
    return layer_norm(y1 + ffn, p[name + "g2"], p[name + "b2"])


def ranker_logits(p: Params, model: dict, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(B,) logits of the configuration's ranker on ``batch`` (ids by feature name)."""
    fs, masks = fields(p, model["fields"], batch)
    n = len(model["hidden"])
    if model["kind"] == "dcn":
        x0 = torch.cat(fs, dim=1)
        x = x0
        for l in range(model["cross_layers"]):
            x = x0 * (x @ p["cross.ws"][l])[:, None] + p["cross.bs"][l] + x
        return mlp(p, "tower", torch.cat([x0, x], dim=1), n)[:, 0]
    att = model["attention"]
    names = [f[0] for f in model["fields"]]
    hi, ti = names.index(att["hist_feature"]), names.index(att["target_feature"])
    h, mask = fs[hi], masks[att["hist_feature"]]
    for i in range(att["num_layers"]):
        h = block(p, f"blocks.{i}.", h, mask, att["num_heads"])
    scores = torch.einsum("bld,bd->bl", h, fs[ti]) / math.sqrt(h.shape[-1])
    alpha = torch.softmax(torch.where(mask > 0, scores, NEG), dim=-1)
    alpha = alpha * (mask.sum(dim=1, keepdim=True) > 0)
    pooled = torch.einsum("bl,bld->bd", alpha, h)
    rest = [f for i, f in enumerate(fs) if i != hi]
    return mlp(p, "tower", torch.cat(rest + [pooled], dim=1), n)[:, 0]


def l2(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def tower(p: Params, recall: dict, side: str, batch: Dict[str, torch.Tensor],
          prefix: str = "recall.") -> torch.Tensor:
    """L2-normalised DSSM ``side`` ("user" or "item") embeddings of ``batch``."""
    fs, _ = fields(p, recall[f"{side}_fields"], batch, prefix)
    return l2(mlp(p, f"{prefix}{side}_fc", torch.cat(fs, dim=1), len(recall["tower"]),
                  recall["negative_slope"]))
