"""Expert-data collection, PlannerNet training and export, end to end.

The port's counterpart of examples/train.py (the reference's data-collection
session, README.md:151-166, and nn_trainer.py's main): batched record
rollouts of the expert planner on the scene path, chunked into pulls of a
few segments whose frames are kept as uint8 on the host; then Adam
training of the PlannerNet (learn/train.py, a 90/10 split as
examples/train.py takes): the smallconv net on 160 x 120 frames, or with
--resnet640 the reference's contract, the ResNet-18 net (NetParams()) on
640 x 480 frames (examples/train.py:13, 64-66); then the checkpoint as
examples/train.py:149 writes it (the orbax directory OUT and
OUT.netcfg.json, which the JAX package's train.load_checkpoint reads), a
``torch.export`` program (OUT.pt2) and an ONNX file (OUT.onnx), and the
program's latency at batch 1.

    python -m neoplanner_tpu_torch.learn.pipeline \\
        --out artifacts/planner_net_torch
    python -m neoplanner_tpu_torch.learn.pipeline --resnet640 --envs 256 \\
        --out artifacts/planner_net_resnet640_torch
    python -m neoplanner_tpu_torch.learn.pipeline --device cpu --envs 4 \\
        --pulls 1 --segments-per-pull 2 --epochs 1 --max-iters 2 \\
        --out /tmp/net
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, NetParams,
                                         PlannerParams, SimParams,
                                         WorldParams)
from neoplanner_tpu_torch.learn import (data, datagen, export, onnx_interop,
                                        train)
from neoplanner_tpu_torch.sim import env
from neoplanner_tpu_torch.world import scenegen


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=512)
    ap.add_argument("--pulls", type=int, default=6,
                    help="datagen pulls of --segments-per-pull segments")
    ap.add_argument("--segments-per-pull", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--max-iters", type=int, default=48,
                    help="the expert's L-BFGS iterations")
    ap.add_argument("--out", default="artifacts/planner_net_torch")
    ap.add_argument("--resnet640", action="store_true",
                    help="the 640 x 480 ResNet-18 contract (NetParams())")
    ap.add_argument("--export-csv", default=None,
                    help="also write the dataset in the reference's layout")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the pipeline; returns what it measured and made: samples,
    record_s (datagen seconds, frames to the host included), pull_s (each
    pull's seconds; the first holds the warm-up), segments,
    launches (the kernels' launches during datagen), dataset (the uint8
    frames, motions and labels), train_s (train() whole: the data's copy
    to the device, the first epoch's warm-up and the evaluations
    included), steps_per_epoch, step_ms (ms a step in the last epoch),
    history, net, paths, latency_ms ((mean, p50) of the program at batch
    1)."""
    args = parse_args(argv)
    dev = _cuda.resolve_device(args.device)
    pp = PlannerParams(max_iters=args.max_iters)
    mp, sp = MissionParams(), SimParams()
    mapp = MapParams(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
    if args.resnet640:
        cam = CameraParams(width=640, height=480)
        netp = NetParams()
    else:
        cam = CameraParams(width=160, height=120)
        netp = NetParams(img_width=160, img_height=120, backbone="smallconv")

    # ---- chunked datagen
    gen = _cuda.make_generator(0, dev)
    worlds = scenegen.generate_batch(gen, args.envs,
                                     WorldParams(num_boxes=12))
    state = env.reset(worlds, pp, mp, mapp, gen)
    before = dict(_cuda.launches)
    D, M, L, pull_s = [], [], [], []
    _cuda.synchronize(dev)
    t0 = time.perf_counter()
    for p in range(args.pulls):
        t_pull = time.perf_counter()
        state, *out = datagen.record_rollout(state, args.segments_per_pull,
                                             pp, mp, sp, cam, mp.des_pos_z)
        d, m, l = datagen.flatten_valid(*out)
        D.append(d.astype(np.uint8))
        M.append(m)
        L.append(l)
        pull_s.append(time.perf_counter() - t_pull)
        print(f"pull {p}: {sum(len(x) for x in D)} samples "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    record_s = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in _cuda.launches.items()}
    D, M, L = np.concatenate(D), np.concatenate(M), np.concatenate(L)
    if args.export_csv:
        datagen.export_csv(args.export_csv, D, M, L)
        print(f"exported the reference-format dataset to {args.export_csv}")

    # ---- train
    cfg = train.TrainConfig(epochs=args.epochs, batch_size=args.batch_size,
                            train_split=0.9, seed=0)
    n_tr = int(cfg.train_split * len(D))
    steps_per_epoch = max(n_tr // cfg.batch_size, 1)
    _cuda.synchronize(dev)
    t0 = time.perf_counter()
    net, history = train.train(D, M, L, netp, cfg, log_every=1, device=dev)
    _cuda.synchronize(dev)
    train_s = time.perf_counter() - t0

    # ---- checkpoint and export
    paths = dict(checkpoint=args.out, program=args.out + ".pt2",
                 onnx=args.out + ".onnx")
    train.save_checkpoint(paths["checkpoint"], net.state_dict(), netp)
    export.save(paths["program"], net)
    onnx_interop.export_planner_net(net.state_dict(), netp, paths["onnx"])
    engine = export.load(paths["program"], dev)
    flat = data.flat_input(torch.as_tensor(D[:1], dtype=torch.float32),
                           torch.as_tensor(M[:1])).to(dev)
    latency = export.latency_test(engine, flat)
    step_ms = history["epoch_s"][-1] * 1e3 / steps_per_epoch
    print(f"{len(D)} samples in {record_s:.1f} s; "
          f"{cfg.epochs * steps_per_epoch} steps in {train_s:.1f} s, "
          f"{step_ms:.2f} ms a step in the last epoch; latency p50 "
          f"{latency[1]:.3f} ms; wrote " + ", ".join(paths.values()),
          flush=True)
    return dict(samples=len(D), record_s=record_s, pull_s=pull_s,
                segments=args.pulls * args.segments_per_pull,
                launches=launches, dataset=(D, M, L), train_s=train_s,
                steps_per_epoch=steps_per_epoch, step_ms=step_ms,
                history=history, net=net, paths=paths, latency_ms=latency)


if __name__ == "__main__":
    main()
