"""The port's count of one full-width DCN training step against XLA's count of
the JAX package's step, on the CPU.

``bench.py``'s primary path: ``mind_config("dcn",
embedding_optimizer="rowwise_adagrad")`` at batch 512 (arena 159,360 x 32).
XLA's count is ``compiled_cost`` of the JAX trainer's chunk function at a
chunk of one step, called as ``bench.py`` calls it; the port's is
``step_cost`` of its sparse step from the same parameters and batch. The
port counts the matmuls and its kernels' arithmetic, and no elementwise op,
which XLA's count holds: the port's FLOPs lie between 0.7x and 1.0x of XLA's.
"""

import copy
import tempfile

import jax
import numpy as np
import torch

from news_recsys_tpu.data.packed_dataset import PackedDataset
from news_recsys_tpu.models.rankers import build_ranker as jbuild_ranker
from news_recsys_tpu.training.trainer import AucHist as JaxAucHist
from news_recsys_tpu.training.trainer import Trainer as JaxTrainer
from news_recsys_tpu.utils.roofline import compiled_cost
from news_recsys_tpu.zoo import mind_config as jax_mind_config
from news_recsys_tpu_torch.convert import params_from_flax
from news_recsys_tpu_torch.models.rankers import build_ranker
from news_recsys_tpu_torch.ops.dcn_kernel import cross_bwd_cost, cross_cost
from news_recsys_tpu_torch.training import sparse_step as tss
from news_recsys_tpu_torch.training.trainer import AucHist, BatchPacker, unpack_batch
from news_recsys_tpu_torch.utils.roofline import step_cost
from news_recsys_tpu_torch.zoo import MIND_FEATURES, MIND_TABLE_SIZE, mind_config

torch.set_num_threads(2)
BATCH = 512


def ranking_arrays(rows: int, seed: int = 0) -> dict:
    """``bench.py``'s synthetic rows: the five MIND features uniform over
    their tables, 10% positives."""
    rng = np.random.default_rng(seed)
    arrays = {n: rng.integers(1, MIND_TABLE_SIZE[n], rows).astype(np.int32)
              for n in MIND_FEATURES}
    arrays["label"] = (rng.random(rows) < 0.1).astype(np.float32).reshape(-1, 1)
    return arrays


def test_full_width_dcn_step_counts_within_xla(tmp_path):
    arrays = ranking_arrays(2 * BATCH)
    jcfg = jax_mind_config("dcn", batch_size=BATCH, embedding_optimizer="rowwise_adagrad")
    jds = PackedDataset(arrays)
    with tempfile.TemporaryDirectory(dir=tmp_path) as tmp:
        trainer = JaxTrainer(jcfg, jbuild_ranker(jcfg, "dcn"), workdir=tmp, use_mesh=False)
        state = trainer.init_state(jds.take(np.arange(BATCH)))
        packer = trainer._packer(jds)
        run = trainer._chunked_step(packer.layout_key(), BATCH)
        idx = np.arange(BATCH, dtype=np.int32)[None, :]          # a chunk of one step
        xla = compiled_cost(run, state, JaxAucHist.zeros(), packer.int_mat, packer.float_mat,
                            idx)
        params = jax.device_get(state.params)

    cfg = mind_config("dcn", batch_size=BATCH, embedding_optimizer="rowwise_adagrad")
    model = params_from_flax(params, build_ranker(cfg, device="cpu"))
    tstate = tss.init_sparse_state(model, cfg)
    step = tss.make_sparse_train_step(model, cfg)
    tpacker = BatchPacker(jds)
    rows = idx[0]
    batch = unpack_batch(torch.from_numpy(tpacker.int_mat[rows]),
                         torch.from_numpy(tpacker.float_mat[rows]), torch.ones(BATCH),
                         tpacker.layout_key())
    cost = step_cost(step, copy.deepcopy(tstate), batch, AucHist.zeros("cpu"))

    D, NL = model.schema.total_dim, 3
    assert cost["kernels"]["dcn_cross_stack"]["flops"] == cross_cost(BATCH, D, NL).flops
    assert cost["kernels"]["dcn_cross_bwd"]["flops"] == cross_bwd_cost(BATCH, D, NL).flops
    assert 0.7 * xla["flops"] <= cost["flops"] <= xla["flops"], (cost["flops"], xla)
    # XLA's count holds the full-table passes of its compiled (V, D) updates;
    # the port's, the rows it moves
    assert 0 < cost["bytes"] < xla["bytes"], (cost["bytes"], xla)
