"""PlannerNet training: Adam and mean-squared error against the expert's
labels, and checkpoints.

The port of neoplanner_tpu/learn/train.py (the reference's trainer,
nn_trainer.py:158-312): the same loss (MSE, mean), optimizer (Adam, lr
1e-3, b1 0.9, b2 0.999, eps 1e-8 outside the square root: optax's and
torch's defaults agree), 80/20 split, epoch order and batching. The dataset
lives on the device and is sliced per step. ``freeze_backbone`` trains
nothing of the image trunk but the convolutions that flax names Conv_0 and
its dense head (nn_trainer.py:115-117, _freeze_mask train.py:45). The
ResNet-18's BatchNorm trains as flax's does (mutable batch_stats): each
step normalizes by the batch's statistics and moves the running stats,
also in a frozen trunk; evaluation runs the net in eval() mode, on the
running stats. Checkpoints are the JAX package's orbax directories, read
and written without JAX (io/orbax.py, weights.from_flax / to_flax), with
the net's ``.netcfg.json`` beside them; a ``torch.save`` file that the
port wrote before it wrote orbax still loads.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import NetParams
from neoplanner_tpu_torch.io import orbax
from neoplanner_tpu_torch.learn import weights
from neoplanner_tpu_torch.models.planner_net import PlannerNet, ieee_f32

# flax's lecun_normal: a standard normal truncated to [-2, 2], scaled so
# that the truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 1e-3     # nn_trainer.py:31
    batch_size: int = 64            # the reference uses 2 (:27)
    epochs: int = 5                 # nn_trainer.py:28
    train_split: float = 0.8        # nn_trainer.py:30
    seed: int = 42                  # nn_trainer.py:32
    freeze_backbone: bool = False   # nn_trainer.py:115-117


def init_params(generator: torch.Generator,
                np_cfg: NetParams) -> Dict[str, torch.Tensor]:
    """A PlannerNet state_dict drawn as flax initializes the JAX net
    (init_params, train.py:36): every conv and dense kernel from lecun_normal
    (a truncated normal with variance 1 / fan_in), every bias zero, each
    BatchNorm's scale and running variance 1 and its shift and running
    mean 0, on the generator's device."""
    sd = {}
    for name, p in PlannerNet(np_cfg).state_dict().items():
        t = torch.zeros(p.shape, device=generator.device)
        if ".bn_" in name:              # a ResNet BatchNorm
            if name.endswith(("weight", "running_var")):
                t.fill_(1.0)
        elif name.endswith("weight"):
            std = math.sqrt(1.0 / (p[0].numel())) / _TRUNC_STD
            torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                        generator=generator)
        sd[name] = t
    return sd


def freeze_mask(state_dict) -> Dict[str, bool]:
    """True where freeze_backbone trains a parameter (_freeze_mask,
    train.py:44-53): everything outside the image trunk, its dense head,
    and the trunk's convolutions that flax names Conv_0 (the smallconv
    net's first; the ResNet's stem and the first of every block, since
    JAX's mask matches the name at any depth); not the other convolutions
    nor any BatchNorm's scale and shift."""
    def trains(name):
        if not name.startswith("img_backbone.") \
                or name.startswith("img_backbone.head."):
            return True
        return name.startswith("img_backbone.convs.0.") \
            or ".conv_0." in name
    return {name: trains(name) for name in state_dict}


def make_optimizer(net: PlannerNet, cfg: TrainConfig) -> torch.optim.Adam:
    """Adam over the trainable parameters; with freeze_backbone the others
    take no gradient and stay as they are."""
    mask = freeze_mask(dict(net.named_parameters()))
    if not cfg.freeze_backbone:
        mask = dict.fromkeys(mask, True)
    params = []
    for name, p in net.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    return torch.optim.Adam(params, lr=cfg.learning_rate)


def train_step(net: PlannerNet, opt: torch.optim.Optimizer,
               img: torch.Tensor, motion: torch.Tensor,
               label: torch.Tensor) -> torch.Tensor:
    """One Adam step on a batch (img (b, h, w, 1)); returns its loss. The
    caller sets the net's mode: in train() a ResNet's BatchNorm normalizes
    by the batch's statistics and moves its running stats. The backward
    pass runs in IEEE f32 as the forward does (:func:`ieee_f32`)."""
    opt.zero_grad(set_to_none=True)
    loss = ((net(img, motion) - label) ** 2).mean()
    with ieee_f32():
        loss.backward()
    opt.step()
    return loss.detach()


def train(depths, motions, labels, np_cfg: NetParams,
          cfg: TrainConfig = TrainConfig(),
          init: Optional[Dict[str, torch.Tensor]] = None,
          perm: Optional[np.ndarray] = None, log_every: int = 0,
          device="cuda") -> Tuple[PlannerNet, Dict[str, list]]:
    """Train on (N, h, w) depth images and (N, 24) motions against (N, 9)
    labels (numpy arrays), on ``device``. init is the initial state_dict
    (default: init_params of a CPU generator seeded cfg.seed); perm the
    permutation of the N samples whose first train_split share trains and
    the rest tests (default: torch.randperm of a CPU generator seeded
    cfg.seed + 1). Each epoch takes the training samples in the order
    np.random.default_rng(cfg.seed) permutes them, in whole batches (or one
    step on all of them when there are fewer than a batch), and ends with
    one evaluation on the whole test split, as train.py:114-140.

    Returns (net in eval mode on the device, history {'train_loss': [...],
    'test_loss': [...], 'epoch_s': [...]}), epoch_s the wall seconds of
    each epoch's training steps, to their end on the device)."""
    dev = _cuda.resolve_device(device)
    n = len(depths)
    if init is None:
        init = init_params(torch.Generator().manual_seed(cfg.seed), np_cfg)
    if perm is None:
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(
            cfg.seed + 1)).numpy()
    net = PlannerNet(np_cfg)
    net.load_state_dict(init)
    net.to(dev).train()
    opt = make_optimizer(net, cfg)
    n_train = int(cfg.train_split * n)
    tr, te = np.array(perm[:n_train]), np.array(perm[n_train:])

    def on_dev(a, extra=()):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=dev).reshape(a.shape + extra)

    depths, motions, labels = on_dev(depths, (1,)), on_dev(motions), \
        on_dev(labels)
    history = {"train_loss": [], "test_loss": [], "epoch_s": []}
    bs = cfg.batch_size
    rng = np.random.default_rng(cfg.seed)
    for epoch in range(cfg.epochs):
        t0 = time.perf_counter()
        order = rng.permutation(len(tr))
        losses = []
        for i in range(0, len(tr) - bs + 1, bs) or [0]:
            idx = tr[order[i:i + bs]]
            if len(idx) == 0:
                idx = tr[:min(bs, len(tr))]
            idx = torch.as_tensor(idx, device=dev)
            losses.append(train_step(net, opt, depths[idx], motions[idx],
                                     labels[idx]))
        # reading the loss waits for the epoch's steps
        history["train_loss"].append(float(torch.stack(losses).mean()))
        history["epoch_s"].append(time.perf_counter() - t0)
        if len(te):
            idx = torch.as_tensor(te, device=dev)
            net.eval()
            with torch.no_grad():
                out = net(depths[idx], motions[idx])
            net.train()
            history["test_loss"].append(float(((out - labels[idx]) ** 2)
                                              .mean()))
        if log_every and (epoch + 1) % log_every == 0:
            print(f"epoch {epoch + 1}: train {history['train_loss'][-1]:.4f}"
                  + (f" test {history['test_loss'][-1]:.4f}" if len(te)
                     else ""))
    for p in net.parameters():
        p.requires_grad_(True)
    return net.eval(), history


def save_checkpoint(path: str, state_dict, np_cfg: NetParams) -> None:
    """What the JAX package's save_checkpoint writes for the same net: the
    weights (weights.to_flax) as an orbax checkpoint directory at path,
    replacing one that is there (io/orbax.save), and the net's
    configuration as JSON at path + '.netcfg.json', JAX's text."""
    path = os.path.abspath(path)
    orbax.save(path, weights.to_flax(state_dict, np_cfg))
    with open(path + ".netcfg.json", "w") as f:
        json.dump(dataclasses.asdict(np_cfg), f)


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], NetParams]:
    """(state_dict on the CPU, NetParams) of a checkpoint: a directory is
    an orbax checkpoint, written by save_checkpoint or by the JAX
    package's (read by io/orbax.py without JAX and converted by
    weights.from_flax); a file is a torch.save of the state_dict, as the
    port wrote checkpoints before it wrote orbax. The NetParams come from
    path + '.netcfg.json' in both cases."""
    path = os.path.normpath(path)
    if os.path.isdir(path):
        state_dict = weights.from_flax(orbax.restore(path))
    else:
        state_dict = torch.load(path, map_location="cpu", weights_only=True)
    with open(path + ".netcfg.json") as f:
        np_cfg = NetParams(**json.load(f))
    return state_dict, np_cfg
