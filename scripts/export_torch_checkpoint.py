"""Rewrite a training checkpoint of the JAX package into the PyTorch port's.

Runs where both packages import (it reads flax msgpack). The output is an
``epoch_*.pt`` that ``python -m news_recsys_tpu_torch predict --checkpoint``
and the port's ``Trainer.load_checkpoint`` read:

    python scripts/export_torch_checkpoint.py -c <config.yaml> \
        --checkpoint <epoch_*.msgpack | experiment dir> --out <dir>/ckpts/epoch_000.pt

A ranker's JAX state (all-dense AdamW, or the sparse state with rowwise
AdaGrad) is restored by the JAX package's own ``Trainer.load_checkpoint``,
converted by ``news_recsys_tpu_torch.convert`` (``dense_state_from_jax`` /
``sparse_state_from_jax``: parameters, AdamW's moments and count, the
accumulators, the step) and written by the port's
``training/checkpoint.py``. A DSSM's ``epoch_*.msgpack`` holds its weights
alone (``DSSMTrainer.save_checkpoint``), and becomes the port's weights-only
``epoch_*.pt`` (``predict -m dssm`` reads it). The rewrite is a change of
format and computes nothing, so the port's model stays on the CPU
(``device="cpu"``) and no GPU is needed.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from news_recsys_tpu.cli import _resolve_ckpt  # noqa: E402
from news_recsys_tpu.config import config_to_dict, load_config  # noqa: E402
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker  # noqa: E402
from news_recsys_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from news_recsys_tpu_torch.config import config_from_dict  # noqa: E402
from news_recsys_tpu_torch.convert import (dense_state_from_jax,  # noqa: E402
                                           params_from_flax, sparse_state_from_jax)
from news_recsys_tpu_torch.models.dssm import build_dssm  # noqa: E402
from news_recsys_tpu_torch.models.rankers import build_ranker  # noqa: E402
from news_recsys_tpu_torch.training.checkpoint import save_state, save_weights  # noqa: E402


def sample_batch(cfg) -> dict:
    """A batch of ``cfg``'s shapes (the JAX trainer builds its state from
    one; the values do not matter, the checkpoint replaces them)."""
    bs, feats = cfg.dataset.batch_size, cfg.features
    batch = {n: np.ones(bs, np.int32) for n in feats.sparse_feature_names}
    batch.update({n: np.zeros(bs, np.float32) for n in feats.dense_feature_names})
    for n in feats.array_feature_names:
        shape = (bs, feats.array_max_length[n])
        batch[n], batch[f"{n}_mask"] = np.ones(shape, np.int32), np.ones(shape, np.float32)
    batch["label"] = np.zeros((bs, 1), np.float32)
    batch["_valid"] = np.ones(bs, np.float32)
    return batch


def export(config: str, checkpoint: str, out: str, model: str = "") -> str:
    jcfg = load_config(config)
    name = model or jcfg.name
    path = _resolve_ckpt(checkpoint)
    cfg = config_from_dict(config_to_dict(jcfg))
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    if name == "dssm":
        from flax import serialization
        with open(path, "rb") as f:
            params = serialization.msgpack_restore(f.read())
        return save_weights(out, params_from_flax(params, build_dssm(cfg, device="cpu")))
    with tempfile.TemporaryDirectory() as tmp:
        jt = JTrainer(jcfg, jbuild_ranker(jcfg, name), workdir=tmp, use_mesh=False)
        jstate = jax.device_get(jt.load_checkpoint(jt.init_state(sample_batch(jcfg)), path))
    convert = sparse_state_from_jax if jt.sparse_embeddings else dense_state_from_jax
    state = convert(jstate, build_ranker(cfg, name, device="cpu"), cfg)
    return save_state(out, state)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-c", "--config", required=True, help="the model's YAML config")
    p.add_argument("-m", "--model", default="", help="override config model name")
    p.add_argument("--checkpoint", required=True,
                   help="JAX epoch_*.msgpack, or an experiment dir (its newest epoch)")
    p.add_argument("--out", required=True, help="the port's checkpoint to write (.pt)")
    args = p.parse_args(argv)
    print(export(args.config, args.checkpoint, args.out, args.model))


if __name__ == "__main__":
    main()
