"""The plain reference against the program on the CPU at the configurations'
own widths; the FLOPs the metrics count from shapes against the program's
own count of a step (``utils.roofline.step_cost``)."""

import copy
import os

import pytest
import torch

from bench_cells import run_small
from harness import inputs, program, spec, weights
from metrics import shapes
from reference import model as ref

CPU = torch.device("cpu")


def _world(conf: dict, seed: int):
    return inputs.World(conf, seed, spec.workload("attention.train-b512")["params"]["law"])


def _ranker(name: str, seed: int = 5):
    from news_recsys_tpu_torch.models.rankers import build_ranker

    conf = spec.config(name)
    cfg = program.port_config(conf["program"]["ranker"])
    params = weights.draw(ref.param_specs(conf["ranker"]), seed, CPU)
    model = build_ranker(cfg, seed=0, device=CPU)
    program.load(model, cfg, params)
    return conf, cfg, params, model


@pytest.mark.parametrize("name", ["mind-dcn", "mind-attention"])
def test_ranker_logits_match_the_program(name):
    conf, cfg, params, model = _ranker(name)
    rows = inputs.training_rows(_world(conf, 11), conf["ranker"], 256, 11)
    batch = {k: torch.from_numpy(v) for k, v in rows.items() if k != "label"}
    with torch.no_grad():
        want = ref.ranker_logits(params, conf["ranker"], batch)
        got = model(batch)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_port_leaves_round_trip():
    conf, cfg, params, model = _ranker("mind-dcn")
    leaves = program.leaves(model, cfg)
    assert set(leaves) == set(params)
    for n, v in leaves.items():
        lo = 1 if v.shape[0] != params[n].shape[0] else 0       # an arena member's rows
        torch.testing.assert_close(v, params[n][lo:], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["mind-dcn", "mind-attention"])
def test_dssm_towers_match_the_program(name):
    from news_recsys_tpu_torch.models.dssm import build_dssm

    conf = spec.config(name)
    cfg = program.port_config(conf["program"]["recall"])
    params = weights.draw(ref.param_specs(conf["recall"], "recall."), 3, CPU)
    dssm = build_dssm(cfg, seed=0, device=CPU)
    program.load(dssm, cfg, {n[7:]: v for n, v in params.items()})
    world = _world(conf, 4)
    reqs = inputs.requests(world, conf, 4, 2, 32)
    users = {f: torch.from_numpy(v.reshape(64, *v.shape[2:])) for f, v in reqs.items()}
    items = {f: torch.from_numpy(v[1:200]) for f, v in inputs.items(world, conf).items()}
    with torch.no_grad():
        torch.testing.assert_close(ref.l2(dssm.user_embedding(users)),
                                   ref.tower(params, conf["recall"], "user", users),
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(ref.l2(dssm.item_embedding(items)),
                                   ref.tower(params, conf["recall"], "item", items),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cell", sorted(f[:-5] for f in os.listdir(
    os.path.join(spec.BENCH_DIR, "workloads"))))
def test_cells_are_correct_on_the_cpu(monkeypatch, cell):
    res = run_small(monkeypatch, cell, seconds=2.0)
    assert res["correct"] is True, res["checks"]


@pytest.mark.parametrize("name", ["mind-dcn", "mind-attention"])
def test_shape_flops_against_the_programs_count(tmp_path, name):
    """A step's FLOPs from the configuration's shapes (3 forwards a row, by
    units) against ``step_cost`` of one step of the program. The float32
    counts agree within 1%: the program counts the cross stack's backward as
    8 NL D a row where the shapes count 2 x 5 NL D. The program's TF32 count
    is 4/3 of the shapes': the block's backward kernel recomputes the forward,
    which a count of the model's work leaves out (PERF.md)."""
    from news_recsys_tpu_torch.data.packed_dataset import BatchPacker, unpack_batch
    from news_recsys_tpu_torch.training.trainer import AucHist, PackedDataset, Trainer
    from news_recsys_tpu_torch.utils.roofline import step_cost

    conf, cfg, params, model = _ranker(name)
    bs = conf["train"]["batch_size"]
    rows = inputs.training_rows(_world(conf, 9), conf["ranker"], bs, 9)
    packer = BatchPacker(PackedDataset(rows))
    batch = unpack_batch(torch.from_numpy(packer.int_mat), torch.from_numpy(packer.float_mat),
                         torch.ones(bs), packer.layout_key())
    trainer = Trainer(cfg, model, workdir=str(tmp_path), device=CPU)
    state = trainer.init_state()
    trainer.train_step(state, batch, AucHist.zeros(CPU))
    counted = step_cost(trainer.train_step, copy.deepcopy(state), batch,
                        AucHist.zeros(CPU))["flops_by_units"]
    ours = {u: bs * f for u, f in shapes.train_flops(conf).items()}
    assert abs(counted["float32"] - ours["float32"]) <= 0.01 * ours["float32"], (counted, ours)
    assert counted.get("tf32", 0) * 3 == ours.get("tf32", 0) * 4, (counted, ours)
