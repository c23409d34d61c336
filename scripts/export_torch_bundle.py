"""Rewrite a serving bundle of the JAX package into the PyTorch port's format.

Runs where both packages import (it reads flax msgpack). The output is a
directory that ``news_recsys_tpu_torch.serving`` loads and
``python -m news_recsys_tpu_torch serve --bundle <out>`` serves:

    # a recall bundle, or a cascade bundle
    python scripts/export_torch_bundle.py --bundle <jax bundle> --out <dir>
    # compose a cascade from a recall bundle and a trained ranker first
    python scripts/export_torch_bundle.py --bundle <jax recall bundle> \
        --ranker-ckpt <epoch_*.msgpack | experiment dir> --ranker-config <yaml> --out <dir>

Parameters pass through ``news_recsys_tpu_torch.convert``, configs through
their plain dicts, and the port's own ``save`` writes the bundle. The rewrite
is a change of format and computes nothing, so it holds the port's models on
the CPU (``device="cpu"``) and needs no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from news_recsys_tpu import serving as jserving  # noqa: E402
from news_recsys_tpu.config import config_to_dict  # noqa: E402
from news_recsys_tpu_torch import serving as tserving  # noqa: E402
from news_recsys_tpu_torch.config import config_from_dict  # noqa: E402
from news_recsys_tpu_torch.convert import params_from_flax  # noqa: E402
from news_recsys_tpu_torch.models.dssm import build_dssm  # noqa: E402
from news_recsys_tpu_torch.models.rankers import build_ranker  # noqa: E402


def port_config(cfg):
    """A JAX-package config as the port's, through its plain dict."""
    return config_from_dict(config_to_dict(cfg))


def port_recommender(rec: jserving.Recommender) -> tserving.Recommender:
    cfg = port_config(rec.cfg)
    return tserving.Recommender(cfg, params_from_flax(rec.params, build_dssm(cfg, device="cpu")),
                                device="cpu", _corpus=rec.corpus, _item_ids=rec.item_ids)


def port_cascade(casc: jserving.CascadeRecommender) -> tserving.CascadeRecommender:
    rcfg = port_config(casc.ranker_cfg)
    ranker = params_from_flax(casc.ranker_params, build_ranker(rcfg, rcfg.name, device="cpu"))
    return tserving.CascadeRecommender(port_recommender(casc.recall), rcfg, ranker,
                                       tserving.PackedDataset(casc.item_arrays), fetch=casc.fetch)


def export(bundle: str, out: str, ranker_ckpt: str = "", ranker_config: str = "",
           fetch: int = 100) -> str:
    with open(os.path.join(bundle, "meta.json")) as f:
        is_cascade = json.load(f).get("kind") == "cascade"
    if ranker_ckpt:
        if not ranker_config:
            raise SystemExit("--ranker-ckpt requires --ranker-config")
        rec = port_cascade(jserving.build_cascade(bundle, ranker_ckpt, ranker_config,
                                                  fetch=fetch, backend="device"))
    elif is_cascade:
        rec = port_cascade(jserving.CascadeRecommender.load(bundle, backend="device"))
    else:
        rec = port_recommender(jserving.Recommender.load(bundle, backend="device"))
    rec.save(out)
    # carry the source bundle's vocab maps over
    src = os.path.join(bundle, "recall") if is_cascade else bundle
    dst = os.path.join(out, "recall") if isinstance(rec, tserving.CascadeRecommender) else out
    if os.path.isdir(os.path.join(src, "vocab")) and not os.path.isdir(os.path.join(dst, "vocab")):
        shutil.copytree(os.path.join(src, "vocab"), os.path.join(dst, "vocab"))
        with open(os.path.join(dst, "meta.json")) as f:
            meta = json.load(f)
        meta["vocab_files"] = sorted(os.listdir(os.path.join(dst, "vocab")))
        with open(os.path.join(dst, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--bundle", required=True, help="JAX recall or cascade bundle")
    p.add_argument("--out", required=True, help="output directory (port bundle)")
    p.add_argument("--ranker-ckpt", default="")
    p.add_argument("--ranker-config", default="")
    p.add_argument("--fetch", type=int, default=100)
    args = p.parse_args(argv)
    print(export(args.bundle, args.out, args.ranker_ckpt, args.ranker_config, args.fetch))


if __name__ == "__main__":
    main()
