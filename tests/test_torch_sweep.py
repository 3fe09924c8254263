"""sim/sweep.py's --net on the CPU: the JAX package's orbax checkpoint
directory (the argument examples/multi_run.py:55 takes) loads the same
net as its exported .onnx, and a one-segment 'neo' sweep runs on it."""

import os

import torch

from neoplanner_tpu_torch.sim import sweep
from tests.test_torch_imports import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
NET = os.path.join(ROOT, "artifacts", "planner_net_smallconv")


def test_net_from_checkpoint_directory_equals_onnx():
    net, cfg = sweep.load_net(NET, "cpu")
    net_o, cfg_o = sweep.load_net(NET + ".onnx", "cpu")
    assert cfg == cfg_o and cfg.backbone == "smallconv"
    sd, sd_o = net.state_dict(), net_o.state_dict()
    assert sorted(sd) == sorted(sd_o)
    for k in sd:
        assert torch.equal(sd[k], sd_o[k]), k
    # a trailing separator names the same directory
    net_s, _ = sweep.load_net(NET + os.sep, "cpu")
    assert all(torch.equal(v, net_s.state_dict()[k]) for k, v in sd.items())


def test_sweep_runs_on_checkpoint_directory():
    out = sweep.main(["--planners", "neo", "--net", NET, "--device", "cpu",
                      "--repeats", "2", "--segments", "1", "--max-iters",
                      "2", "--worlds", "0"])
    (cell,) = out["cells"]
    assert cell["planner"] == "neo" and cell["envs"] == 2
    assert cell["plans"] >= 2 and len(out["records"]) == 2
