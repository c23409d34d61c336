"""``train`` over two processes through the port's command line, on the CPU:
the counterpart of ``tests/test_multihost.py``.

The data comes from the port's ``synth``, ``preprocess`` and ``fe`` (the
size of ``tests/test_torch_cli.py``). One process trains the Deep ranker for
two epochs; then two processes train the same config with
``--coordinator 127.0.0.1:<port> --num-processes 2 --process-id i --device
cpu``, on the data axis (``mesh.model`` 1) and on the model axis
(``mesh.model`` 2), and once more under ``torchrun`` with none of those
flags. Each epoch's ``train_loss`` is within 1e-5 of the one-process run's
and ``val_log.log`` is the same file; process 0 alone writes the logs and
the checkpoints, in one process's format.
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import yaml

from news_recsys_tpu_torch.cli import main as cli
from news_recsys_tpu_torch.training.checkpoint import load_state

from tests.test_torch_cli import write_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def losses(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return [(m["step"], m["train_loss"]) for m in map(json.loads, f) if "train_loss" in m]


def run(procs_argv, env=None):
    procs = [subprocess.Popen(argv, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for argv in procs_argv]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """(tmp dir, {layout: config path}, the one-process experiment dir)."""
    tmp = tmp_path_factory.mktemp("pcli")
    cfgs = {}
    for name, mesh in (("data", {"model": 1}), ("model", {"model": 2})):
        path = write_config(tmp / f"{name}.yaml", tmp)
        raw = yaml.safe_load(open(path))
        raw["mesh"] = {"data": -1, **mesh}
        (tmp / f"{name}.yaml").write_text(yaml.safe_dump(raw))
        cfgs[name] = path
    cli(["synth", "--out", str(tmp / "Data"), "--news", "150", "--users", "60",
         "--train-impressions", "300", "--dev-impressions", "80"])
    cli(["preprocess", "-c", cfgs["data"]])
    cli(["fe", "-c", cfgs["data"]])
    single = str(tmp / "exp_1proc")
    run([[sys.executable, "-m", "news_recsys_tpu_torch", "train", "-c", cfgs["data"],
          "--device", "cpu", "--workdir", single]])
    return tmp, cfgs, single


def assert_same_run(workdir, single):
    l1, l2 = losses(single), losses(workdir)
    assert len(l1) == len(l2) == 2
    for (s1, v1), (s2, v2) in zip(l1, l2):
        assert s1 == s2 and abs(v1 - v2) < LOSS_TOL, (l1, l2)
    v1, v2 = (open(os.path.join(d, "val_log.log")).read() for d in (single, workdir))
    assert "Validation Results" in v2 and "AUC" in v2
    assert v1 == v2
    with open(os.path.join(workdir, "train.log")) as f:
        assert f.read().count("Training Metrics:") == 2          # written once, by process 0
    a, b = (load_state(os.path.join(d, "ckpts", "epoch_001.pt")) for d in (single, workdir))
    assert a["kind"] == b["kind"] and a["step"] == b["step"]
    assert {k: v.shape for k, v in a["model"].items()} == {k: v.shape for k, v in b["model"].items()}


@pytest.mark.parametrize("layout", ["data", "model"])
def test_train_on_two_processes_matches_one(workspace, layout):
    tmp, cfgs, single = workspace
    workdir = str(tmp / f"exp_2proc_{layout}")
    port = free_port()
    outs = run([[sys.executable, "-m", "news_recsys_tpu_torch", "train", "-c", cfgs[layout],
                 "--device", "cpu", "--workdir", workdir, "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", "2", "--process-id", str(i)] for i in range(2)])
    assert "Mesh(data=" in outs[0]
    assert_same_run(workdir, single)


def test_train_under_torchrun(workspace):
    """``torchrun --nproc-per-node 2``: the process group comes from its
    environment, with no flag."""
    tmp, cfgs, single = workspace
    workdir = str(tmp / "exp_torchrun")
    run([[sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
          "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
          "-m", "news_recsys_tpu_torch", "train", "-c", cfgs["model"], "--device", "cpu",
          "--workdir", workdir]], env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert_same_run(workdir, single)


def test_coordinator_flags_must_come_together(workspace):
    """``--coordinator`` without the process count and id is refused before
    anything trains."""
    _, cfgs, _ = workspace
    with pytest.raises(ValueError, match="--num-processes and --process-id"):
        cli(["train", "-c", cfgs["data"], "--device", "cpu", "--coordinator", "127.0.0.1:1"])
