"""The frozen counts against hand counts."""

import numpy as np
import pytest
import torch

from counts import kernels, peaks, resnet


def test_resnet18_matches_published_macs():
    # torchvision's ResNet-18 at 224 x 224 x 3 with the 1000-class head:
    # 1.814 G multiply-adds (the published ~1.8 GMACs)
    macs = resnet.resnet18_flops(224, 224, 3, 1000) / 2
    assert macs == pytest.approx(1.814e9, rel=2e-3)
    # one input channel removes two thirds of the stem's 118.0 M MACs
    one = resnet.resnet18_flops(224, 224, 1, 1000) / 2
    stem3 = 3 * 49 * 64 * 112 * 112
    assert macs - one == stem3 * 2 // 3


def test_resnet18_at_640x480():
    # the stem alone: 2 x 49 x 64 x 240 x 320 operations
    f = resnet.resnet18_flops(480, 640, 1, 24)
    assert f > 2 * 49 * 64 * 240 * 320
    assert f == pytest.approx(21.2435e9, rel=1e-4)


def test_planner_net_adds_the_mlps():
    net = dict(img_height=48, img_width=64, img_feature_size=24,
               motion_input_size=24, motion_feature_size=24, output_size=9)
    mlps = 2 * (24 * 48 + 48 * 24 + 24 * 24 + 24 * 24) \
        + 2 * (48 * 48 + 48 * 96 + 96 * 96 + 96 * 9)
    assert resnet.planner_net_flops(net) == \
        resnet.resnet18_flops(48, 64, 1, 24) + mlps
    with pytest.raises(ValueError):
        resnet.planner_net_flops(dict(net, backbone="smallconv"))


def test_givens_flops_by_hand():
    # n = 2, lbw = 1, fill = 1, d = 1: column 0 has one rotation of
    # 7 + 6 * (2 + 1) and a back substitution of 1 * (2 * 1 + 1); column 1
    # a back substitution of 1 * (2 * 0 + 1)
    assert kernels.givens_flops(1, n=2, d=1, fill=1) == 25 + 3 + 1


def test_solve_flops_linear_in_iterations():
    k = lambda it: kernels.solve_flops(24, 25, np.array(it))
    one = kernels.objective_flops(24, 25, True)
    fwd = kernels.objective_flops(24, 25, False)
    assert k([0]) == one
    assert k([3]) == 4 * one + 3 * fwd
    assert k([1, 2]) == k([1]) + k([2])


def test_render_work_by_hand():
    # a 2 x 2 grid of 8 x 32 tiles over a 10 x 40 frame (partial tiles of
    # 2 rows and 8 columns), one pose, K = 3
    kept = torch.zeros((1, 2, 2, 3), dtype=torch.bool)
    kept[0, 0, 0, :2] = True      # 256 pixels x 2 survivors
    kept[0, 1, 1, :] = True       # 2 x 8 pixels x 3 survivors
    flops, nbytes = kernels.render_work(kept, 10, 40, 3, (8, 32))
    want = 256 * (60 + 70) + 8 * 8 * 60 + 2 * 32 * 60 + 16 * (60 + 105)
    assert flops == want
    assert nbytes == (3 + 4 + 400 + 3 * 8) * 4


def test_bound_takes_the_larger():
    assert peaks.bound_s(67e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(67e12, 2 * 3.35e12) == pytest.approx(2.0)
