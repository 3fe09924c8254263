"""Operations of the PlannerNet's forward pass from its layer shapes: two
per multiply-add of each convolution and dense layer (BatchNorm, the
activations, pooling and the residual adds are not counted)."""

from __future__ import annotations


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def resnet18_flops(height: int, width: int, in_channels: int = 1,
                   num_features: int = 24) -> int:
    """The ResNet-18 depth encoder (a 7x7/2 stem, a 3x3/2 max-pool, four
    stages of two basic blocks at 64, 128, 256, 512 features, the first
    block of stages 2-4 at stride 2 with a 1x1/2 downsample, global
    pooling and a dense head) on one (in_channels, height, width) image."""
    f = 0
    h, w = _out(height, 7, 2, 3), _out(width, 7, 2, 3)
    f += 2 * in_channels * 49 * 64 * h * w
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)
    cin = 64
    for stage in range(4):
        cout = 64 * 2 ** stage
        for block in range(2):
            s = 2 if stage > 0 and block == 0 else 1
            ho, wo = _out(h, 3, s, 1), _out(w, 3, s, 1)
            f += 2 * cin * 9 * cout * ho * wo          # conv_0
            f += 2 * cout * 9 * cout * ho * wo         # conv_1
            if s != 1 or cin != cout:
                f += 2 * cin * cout * ho * wo          # 1x1 downsample
            h, w, cin = ho, wo, cout
    return f + 2 * cin * num_features


def mlp_flops(dims) -> int:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def planner_net_flops(net: dict) -> int:
    """One sample of the PlannerNet of the configuration's ``net`` entry
    (NetParams' fields; the 'resnet18' backbone and the 'mlp' fusion)."""
    if net.get("backbone", "resnet18") != "resnet18" \
            or net.get("fusion_arch", "mlp") != "mlp":
        raise ValueError("counted for the resnet18 backbone and the mlp "
                         "fusion only")
    f = resnet18_flops(net["img_height"], net["img_width"], 1,
                       net["img_feature_size"])
    f += mlp_flops((net["motion_input_size"], 48, 24, 24,
                    net["motion_feature_size"]))
    f += mlp_flops((net["img_feature_size"] + net["motion_feature_size"], 48,
                    96, 96, net["output_size"]))
    return f
