"""Batched expert-demonstration collection and the reference's CSV layout.

The port of neoplanner_tpu/learn/datagen.py (the reference's record
pipeline: RecordPlanner appending CSV rows and PNG depth images while random
missions fly, record_planner.py:136-185). B envs step together with the
expert planner; every segment gives each env one sample (the depth frame at
the drone's pose before the step, the 24-dim motion input and the 9-dim
label of the expert's solution), valid where the replan was accepted.
``export_csv`` writes the reference's 34-column train.csv and
depth_img/<id>.png, byte for byte as the JAX package writes them.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, PlannerParams,
                                         SimParams, WorldParams)
from neoplanner_tpu_torch.learn import data
from neoplanner_tpu_torch.sense import raycast
from neoplanner_tpu_torch.sim import env
from neoplanner_tpu_torch.world import scenegen

CSV_HEADER = (
    "id,drone_vel_x,drone_vel_y,drone_vel_z,"
    "R11,R12,R13,R21,R22,R23,R31,R32,R33,"
    "init_pos_x,init_pos_y,init_pos_z,init_vel_x,init_vel_y,init_vel_z,"
    "target_pos_x,target_pos_y,target_pos_z,target_vel_x,target_vel_y,"
    "target_vel_z,wpts1_x,wpts1_y,wpts1_z,wpts2_x,wpts2_y,wpts2_z,ts1,ts2,ts3"
)  # record_planner.py:95-129


def record_rollout(state: env.EnvState, num_segments: int,
                   pp: PlannerParams, mp: MissionParams, sp: SimParams,
                   cam: CameraParams, des_pos_z: float,
                   draws: Optional[Sequence[env.Draws]] = None):
    """num_segments segments of random missions with the expert planner on
    the state's path, a sample per env and segment (record_rollout,
    datagen.py:40): the frame rendered at the drone's pose before the step
    (kernel B4 on the card), normalized; the motion input and the label
    formed from the segment's SegmentInfo. draws, one per segment, replace
    the state generator's.

    Returns (final state, depths (B, S, h, w), motions (B, S, 24), labels
    (B, S, 9), valid (B, S)), env-major as the JAX package's vmap of a scan.
    """
    depths, motions, labels, valid = [], [], [], []
    for s in range(num_segments):
        depth = raycast.render_depth_auto(state.world, state.drone.pos,
                                          state.drone.quat, cam)
        state, info = env.step_segment(
            state, pp, mp, sp, cam, planner="expert", mission_mode="random",
            draws=None if draws is None else draws[s])
        depths.append(data.normalize_depth(depth))
        motions.append(data.motion_vector(info.drone, des_pos_z,
                                          info.plan_init, info.target))
        labels.append(data.make_label(info.drone, des_pos_z, info.int_wpts,
                                      info.ts))
        valid.append(info.ok)
    return (state, torch.stack(depths, 1), torch.stack(motions, 1),
            torch.stack(labels, 1), torch.stack(valid, 1))


def flatten_valid(depths, motions, labels, valid):
    """The valid samples of record_rollout's (B, S, ...) outputs as numpy
    arrays, env-major (datagen.py:75-81)."""
    v = valid.reshape(-1).cpu().numpy()

    def flat(x):
        return x.reshape((-1,) + x.shape[2:]).cpu().numpy()[v]
    return flat(depths), flat(motions), flat(labels)


def collect(generator: torch.Generator, num_envs: int, num_segments: int,
            pp: PlannerParams, mp: MissionParams, sp: SimParams,
            mapp: MapParams, cam: CameraParams, wp: WorldParams,
            device="cuda"):
    """Random worlds, batched record rollouts, flat arrays (collect,
    datagen.py:63): num_envs worlds and their random goals from the
    generator (on ``device``), reset on the scene path (the JAX package
    resets on the grid but plans on the scene, and only the scene is
    queried), num_segments segments each.

    Returns (depths (N, h, w), motions (N, 24), labels (N, 9)), numpy, the
    valid samples only, env-major."""
    dev = _cuda.resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"collection on {dev}")
    worlds = scenegen.generate_batch(generator, num_envs, wp)
    state = env.reset(worlds, pp, mp, mapp, generator)
    _, *out = record_rollout(state, num_segments, pp, mp, sp, cam,
                             mp.des_pos_z)
    return flatten_valid(*out)


def export_csv(out_dir: str, depths: np.ndarray, motions: np.ndarray,
               labels: np.ndarray, start_id: int = 0) -> str:
    """Append to the reference's training_data layout: train.csv (header
    when new, one row per sample with id t<id>) and depth_img/<id>.png
    (the frame truncated to uint8) (record_planner.py:152-185)."""
    from PIL import Image

    img_dir = os.path.join(out_dir, "depth_img")
    os.makedirs(img_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, "train.csv")
    fresh = not os.path.isfile(csv_path)
    with open(csv_path, "a") as f:
        if fresh:
            f.write(CSV_HEADER + "\n")
        for i in range(len(depths)):
            sample_id = start_id + i
            row = np.concatenate([motions[i], labels[i]])
            f.write(f"t{sample_id}," + ",".join(f"{x:.6f}" for x in row)
                    + "\n")
            Image.fromarray(depths[i].astype(np.uint8), mode="L").save(
                os.path.join(img_dir, f"{sample_id}.png"))
    return csv_path


def load_csv(out_dir: str):
    """A training_data directory back into (depths, motions, labels)
    float32 arrays; rows without their image are skipped."""
    from PIL import Image

    depths, motions, labels = [], [], []
    with open(os.path.join(out_dir, "train.csv")) as f:
        if f.readline().strip() != CSV_HEADER:
            raise ValueError(f"{out_dir}/train.csv: not the reference's "
                             f"header")
        for line in f:
            parts = line.strip().split(",")
            img_path = os.path.join(out_dir, "depth_img",
                                    f"{parts[0][1:]}.png")
            if not os.path.isfile(img_path):
                continue
            depths.append(np.asarray(Image.open(img_path), dtype=np.float32))
            vals = np.array([float(x) for x in parts[1:]], dtype=np.float32)
            motions.append(vals[:24])
            labels.append(vals[24:])
    return np.stack(depths), np.stack(motions), np.stack(labels)
