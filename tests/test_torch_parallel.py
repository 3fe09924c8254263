"""The port's env-axis data parallelism (parallel/mesh.py) on four gloo
processes on the CPU.

tests/test_parallel.py's configuration (B = 8, the 'expert' planner,
random missions, the scene path): one torch.multiprocessing spawn of four
ranks over a FileStore in a temporary directory (no TCP port to collide
with other test processes). Each rank builds the same state and draws
from the same seeds, takes its shard, steps one segment through
sharded_vmap_step, and reports; the parent steps the whole batch.

Tolerances: the sharded segment against the unsharded one within
tests/test_parallel.py's 5e-2 on the positions, with equal plan flags;
mean_over_envs within 1e-6 of the unsharded mean; replicate and the
shards exactly. This module imports no JAX, so that the spawned ranks
start fast.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from neoplanner_tpu_torch import _cuda
from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                         MissionParams, PlannerParams,
                                         SimParams, WorldParams)
from neoplanner_tpu_torch.parallel import mesh as pmesh
from neoplanner_tpu_torch.sim import env
from neoplanner_tpu_torch.world import scenegen
from tests.test_torch_imports import one_torch_thread  # noqa: F401

PP = PlannerParams(max_iters=16, samples_per_piece=8, retry_num=1,
                   extra_lateral_scales=())
MP = MissionParams()
SP = SimParams()
CAM = CameraParams()
MAPP = MapParams(width=64, height=64, origin_x=-2.0, origin_y=-3.2)
WP = WorldParams(num_boxes=4, max_boxes=8, rejection_rounds=2)
B = 8
RANKS = 4


def _problem():
    """The batch and its draws, the same in every process. The metrics
    start from seeded values, distinct per env, so that the means that
    mean_over_envs takes are not those of the zeros a first segment
    leaves (its drones hover on the reset buffer)."""
    worlds = scenegen.generate_batch(_cuda.make_generator(0, "cpu"), B, WP)
    state = env.reset(worlds, PP, MP, MAPP, _cuda.make_generator(1, "cpu"))
    state = state.replace(metrics=torch.rand(
        (B, 3), generator=_cuda.make_generator(3, "cpu")))
    draws = env.draw(_cuda.make_generator(2, "cpu"), B, PP)
    return state, draws


def _segment(state, draws):
    return env.step_segment(state, PP, MP, SP, CAM, draws=draws,
                            planner="expert")


def _raises(fn, exc) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def _rank(rank, store, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, RANKS),
                            rank=rank, world_size=RANKS)
    try:
        state, draws = _problem()
        res = {}
        mesh = pmesh.make_mesh(device_type="cpu")
        res["mesh_shape"] = tuple(mesh.shape)
        res["bad_n_devices"] = _raises(
            lambda: pmesh.make_mesh(3, device_type="cpu"), ValueError)
        res["no_cuda_mesh"] = _raises(lambda: pmesh.make_mesh(), RuntimeError)
        shard = pmesh.shard_batch(state, mesh)
        step = pmesh.sharded_vmap_step(_segment, mesh)
        out, info = step(shard, pmesh.shard_batch(draws, mesh))
        res.update(pos=out.drone.pos, vel=out.drone.vel, planned=info.planned,
                   ok=info.ok, centers=shard.world.centers,
                   wm=pmesh.mean_over_envs(env.weighted_metric(out), mesh),
                   pos_mean=pmesh.mean_over_envs(out.drone.pos, mesh))
        res["replicated"] = pmesh.replicate(
            {"x": torch.arange(6.0) * (rank + 1), "n": None}, mesh)["x"]
        res["indivisible"] = _raises(lambda: pmesh.shard_batch(
            torch.zeros(6, 2), mesh), ValueError)
        res["not_batch"] = _raises(lambda: pmesh.shard_batch(
            (torch.zeros(8, 2), torch.zeros(4)), mesh), ValueError)
        res["bad_factor"] = _raises(lambda: pmesh.make_multislice_mesh(
            dcn=3, device_type="cpu"), ValueError)
        m3 = pmesh.make_multislice_mesh(dcn=2, mdl=2, device_type="cpu")
        res["m3_shape"] = tuple(m3.shape)
        res["m3_names"] = tuple(m3.mesh_dim_names)
        res["m3_coord"] = tuple(m3.get_coordinate())
        shard3 = pmesh.shard_batch_multislice(state, m3)
        out3, info3 = _segment(shard3, pmesh.shard_batch_multislice(draws,
                                                                    m3))
        wm_local = env.weighted_metric(out3)
        res.update(centers3=shard3.world.centers, pos3=out3.drone.pos,
                   ok3=info3.ok, wm3_local=wm_local.double().mean(),
                   wm3=pmesh.mean_over_envs(wm_local, m3, ("dcn", "dp")),
                   wm3_mdl=pmesh.mean_over_envs(wm_local, m3, "mdl"))
        res["no_env_dim"] = _raises(lambda: pmesh.mean_over_envs(
            wm_local, m3), ValueError)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("parallel")
    tmp.spawn(_rank, args=(str(base / "store"), str(base)), nprocs=RANKS,
              join=True)
    ranks = [torch.load(base / f"rank{r}.pt", weights_only=False)
             for r in range(RANKS)]
    state, draws = _problem()
    ref, info = _segment(state, draws)
    return ranks, state, ref, info


def test_sharded_segment_step(runs):
    ranks, state, ref, info = runs
    assert all(r["mesh_shape"] == (RANKS,) for r in ranks)
    for r, res in enumerate(ranks):
        assert res["pos"].shape == (B // RANKS, 3)
        np.testing.assert_array_equal(
            res["centers"].numpy(),
            state.world.centers[2 * r:2 * r + 2].numpy())
    pos = torch.cat([r["pos"] for r in ranks])
    assert torch.isfinite(pos).all()
    np.testing.assert_allclose(pos.numpy(), ref.drone.pos.numpy(),
                               atol=5e-2)
    assert torch.equal(torch.cat([r["ok"] for r in ranks]), info.ok)
    assert torch.equal(torch.cat([r["planned"] for r in ranks]),
                       info.planned)
    assert int(info.planned.sum()) > 0


def test_mean_over_envs(runs):
    ranks, _, ref, _ = runs
    want = float(env.weighted_metric(ref).double().mean())
    for res in ranks:
        assert res["wm"] == ranks[0]["wm"]
        assert abs(float(res["wm"]) - want) <= 1e-6 * max(abs(want), 1.0)
        np.testing.assert_allclose(res["pos_mean"].numpy(),
                                   ref.drone.pos.mean(0).numpy(), atol=5e-2)


def test_replicate(runs):
    ranks = runs[0]
    for res in ranks:
        np.testing.assert_array_equal(res["replicated"].numpy(),
                                      np.arange(6.0))


def test_mesh_and_shard_errors(runs):
    for res in runs[0]:
        assert res["bad_n_devices"] and res["no_cuda_mesh"]
        assert res["indivisible"] and res["not_batch"]
        assert res["bad_factor"]


def test_multislice_shard(runs):
    """The (dcn=2, dp=1, mdl=2) mesh: the env batch in two blocks of four
    over (dcn, dp), each held by both ranks along mdl; the segment on the
    blocks matches the unsharded one; mean_over_envs over (dcn, dp) is the
    global mean, over mdl the block's own, and raises for a dim the mesh
    lacks."""
    ranks, state, ref, info = runs
    for r, res in enumerate(ranks):
        assert res["m3_shape"] == (2, 1, 2)
        assert res["m3_names"] == ("dcn", "dp", "mdl")
        dcn, dp, mdl = res["m3_coord"]
        assert (dcn, dp, mdl) == (r // 2, 0, r % 2)
        block = slice(4 * dcn, 4 * dcn + 4)
        np.testing.assert_array_equal(res["centers3"].numpy(),
                                      state.world.centers[block].numpy())
        np.testing.assert_allclose(res["pos3"].numpy(),
                                   ref.drone.pos[block].numpy(), atol=5e-2)
        assert torch.equal(res["ok3"], info.ok[block])
        want = float(env.weighted_metric(ref).double().mean())
        assert abs(float(res["wm3"]) - want) <= 1e-6 * max(abs(want), 1.0)
        # over mdl alone: the two replicas of one block, its own mean
        local = float(res["wm3_local"])
        assert abs(float(res["wm3_mdl"]) - local) <= 1e-6 * max(abs(local),
                                                                1.0)
        assert res["no_env_dim"]
