"""The control of ``correct``: the reference put in the program's place and
computed in TF32, the precision below the configurations' float32 (TF32
off), comes out not correct, and so does a training step on half of each
batch; the program itself comes out correct. On the card (TF32 exists only
there) at the cells' widths, with fewer steps and requests than a run:

    python3 -m pytest -m cuda benchmark/tests/test_bench_control.py
"""

import pytest

from bench_cells import small_cell
from harness import cli, judge, program, spec

SEEDS = (2500000001, 2500000002, 2500000003)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["attention.train-b512"])
def test_training_control_and_half_batch_fail(card, monkeypatch, name, seed):
    from tools import calibrate

    cell = small_cell(name, steps_per_epoch=16, warmup_steps=8)
    monkeypatch.setattr(spec, "workload", lambda n: cell)
    program.start(card)
    readings = dict(calibrate.training(cli.Context(name, seed, 1.0, False, card), True))
    limits = cell["limits"]
    assert judge.verdict(readings["program"], limits)[0], readings["program"]
    assert not judge.verdict(readings["control"], limits)[0], readings["control"]
    assert not judge.verdict(readings["fault_half_batch"], limits)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["attention.serve-1024u"])
def test_serving_control_fails(card, monkeypatch, name, seed):
    from tools import calibrate

    cell = spec.workload(name)
    cell["params"]["sample_requests"] = 2
    monkeypatch.setattr(spec, "workload", lambda n: cell)
    program.start(card)
    numbers = calibrate.serving_control(cli.Context(name, seed, 4.0, False, card))
    assert not judge.verdict({**numbers, "missing": 0}, cell["limits"])[0], numbers
