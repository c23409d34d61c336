"""Work counted from a configuration's shapes alone, so that it counts the
same work whatever implements it: FLOPs by the units they are held to
(``tf32`` for the attention block, which runs on the tensor cores in
3xTF32 and is counted once; ``float32`` for the rest), and each kernel's
least time on the card's published peaks.

A matrix product counts 2 M N K; the DCN cross layer 5 D a row (its dot
product's two, then ``x0 * s + b + x``); the attention block
``L (2 (4 D^2 + 2 D F) + 4 L D)`` a row; a masked mean pool 2 L D; the
target-aware pooling 4 L D. A training example counts its forward three
times (the forward, and the backward's two products for each of the
forward's).
"""

from __future__ import annotations

from typing import Dict


def _dims(model: dict) -> Dict[str, int]:
    return {name: model["tables"][table][1] for name, table, _, _ in model["fields"]}


def mlp_flops(sizes) -> int:
    return sum(2 * a * b for a, b in zip(sizes, sizes[1:]))


def block_flops(rows: int, L: int, D: int, F: int) -> int:
    return rows * L * (2 * (4 * D * D + 2 * D * F) + 4 * L * D)


def ranker_flops(model: dict) -> Dict[str, int]:
    """A ranker's forward FLOPs a row, by units."""
    dims = _dims(model)
    pools = sum(2 * length * dims[n] for n, _, kind, length in model["fields"]
                if kind == "pooled")
    if model["kind"] == "dcn":
        width = sum(dims.values())
        return {"float32": pools + 5 * model["cross_layers"] * width
                + mlp_flops([2 * width, *model["hidden"]])}
    att = model["attention"]
    hist = next(f for f in model["fields"] if f[0] == att["hist_feature"])
    L, D = hist[3], dims[hist[0]]
    block = att["num_layers"] * block_flops(1, L, D, att["ff_dim"])
    return {"float32": pools + 4 * L * D + mlp_flops([sum(dims.values()), *model["hidden"]]),
            "tf32": block}


def train_flops(config: dict) -> Dict[str, int]:
    """A training example's FLOPs, by units."""
    return {u: 3 * f for u, f in ranker_flops(config["ranker"]).items()}


def request_flops(config: dict, users: int) -> Dict[str, int]:
    """A cascade request's FLOPs, by units: the user tower, every item's
    score, and the ranker over ``users x fetch`` pairs."""
    rec = config["recall"]
    tower_in = sum(rec["tables"][t][1] for _, t, _, _ in rec["user_fields"])
    hist = next(f for f in rec["user_fields"] if f[0] == "hist")
    user = mlp_flops([tower_in, *rec["tower"]]) + 2 * hist[3] * rec["tables"][hist[1]][1]
    score = 2 * rec["tower"][-1] * (rec["tables"]["item_id"][0] - 1)
    out = {u: f * users * config["serve"]["fetch"]
           for u, f in ranker_flops(config["ranker"]).items()}
    out["float32"] += users * (user + score)
    return out


def least_time(config: dict, flops: Dict[str, float], nbytes: float = 0.0) -> float:
    """The least seconds the card takes for ``flops`` (by units) and
    ``nbytes``: the larger of the FLOP bound and the byte bound."""
    peaks = config["peaks"]
    compute = sum(f / peaks[f"{u}_flops"] for u, f in flops.items())
    return max(compute, nbytes / peaks["hbm_bytes"])
