#!/usr/bin/env python3
"""Drive the PyTorch port of NEO-Planner on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--against CHECKOUT]

Phases, one short line each:
1. the card (name and power limit from nvidia-smi) and the kernels' build
   (neoplanner_tpu_torch/csrc/*.cu: the main library and one library of
   B5, B1, B6, B2s and B7 per piece count M = 2, 3, 5, 12, 16, one nvcc
   process each, side by side; loaded with ctypes);
2. each hand-written kernel of the scene path against its plain PyTorch
   version on the card, at that path's shapes (B = 1024 envs), inputs from a
   numpy seed, TF32 off: max abs/rel error beside the stated tolerance,
   kernel and plain times (CUDA events, medians), the bound from bytes and
   operations; B5 also on the adjoint's transposed band, its warp's
   dependent chain, and minco.solve_coeffs whole (the system's build, the
   concatenation and B5) with its device operations under torch.profiler;
3. B1 timed at its second launch of a segment, the lazy bank's retry
   lanes (B x retry_num problems, those of the envs whose first lane was
   accepted skipped), beside its first-lane launch; the lazy bank
   (expert.warm_start_plan: B1 on the first lanes, then on the retries with
   a skip mask) at B = 1024 on the card against its plain version on the
   CPU;
4. a small scene loop (B = 32, 2 segments) on the card against the same
   loop on the CPU, where every kernel wrapper takes its plain version;
5. the scene path: the NEO closed loop of bench.py's flagship configuration
   at B = 1024 (scene SDF, ground-truth sensing, the smallconv PlannerNet
   from artifacts/planner_net_smallconv.onnx, random missions): one warm-up
   segment and 3 timed segments of env.step_segment, with every kernel's
   launch count, which must be above 0 for the path's kernels;
6. each kernel of the vision path against its plain version on the card at
   B = 512 (examples/profile_vision.py's map, one fused frame per segment):
   B8 v2 on rendered frames (with the share of tile-frames that the
   cameras reach, by fusion.tile_reach), B9 on the fused grids, B6 on
   windows of the rebuilt maps (one iteration, 24 iterations against the
   cost basin with a plain GPU-vs-CPU control, the retry launch timed as
   B1's, and the lazy bank with rejected first lanes on the card against
   the CPU), B10 on the sensed maps;
7. a small vision loop (B = 16, 2 segments) on the card against the CPU;
8. the vision path: the same NEO loop with depth sensing, fusion, the
   truncated ESDF, grid planning and grid tracking at B = 512, goals at
   x = 20 so that every timed segment replans: one warm-up and 2 timed
   segments, per-stage times, launch counts above 0 for the path's kernels;
9. the sensor-rate path's kernels against their plain versions on the card
   at B = 512 (examples/profile_vision.py's defaults: six fused frames per
   segment, fusion frames at row stride 4): B8 v3 on five frames per env
   rendered from poses along tracked segments onto grids fused for three
   segments (differing cells printed, 0 expected; the share of tile-frames
   reached printed), B4 at row stride 4 over those 5 x 512 poses in one
   launch, B3 and B10 from substep 30;
10. a small sensor-rate loop (B = 16, 2 segments) on the card against the
   CPU, and its one-iteration twin elementwise;
11. the sensor-rate path: profile_vision's configuration at B = 512
   (fuse_frames=6, fusion_row_stride=4, esdf_interp="mxu"), goals at x = 20:
   one warm-up and 3 timed segments, per-stage times, launches per segment
   (render_depth 2, fuse_depth_dense 1, fuse_depth_multi 1, edt_trunc_lite
   1, track_segment_grid 6);
12. the reference's default map (MapParams(): 448 x 256 cells, the '2d'
   fusion, the exact ESDF), B = 512: B9 exact against its plain version on
   the ground-truth grids of 512 worlds and on grids fused by the '2d'
   fusion (differing cells printed, 0 expected);
13. B9 banded on the same grids at edt_truncation = 2.0 (0 expected);
14. B8 v1 on the default map with a 4 m camera (114-cell windows, every
   8th drone by the map's corner) and on a 120 x 96 map with the 6 m
   camera, three frames each (differing cells and their quanta printed),
   the share of window tiles and strips the cameras reach
   (fusion.window_reach), and insert_depth_2d_dense whole on the first
   shape beside its grid copy and the kernel;
15. small loops on the default map (B = 16, 2 segments) on the card
   against the CPU: gt+grid (sensing='gt', plan_map='grid', the exact map
   built at the reset) and depth+grid with the '2d_dense' fusion and the
   4 m camera (B8 v1 and B9 exact every segment);
16. the gt+grid path at B = 512 (examples/demo.py's MapParams() and
   CameraParams(160, 120), the planner of the vision paths, goals at
   x = 20): the reset, one warm-up and 2 timed segments, per-stage times,
   live replans, launches (edt_exact 1 at the reset, 0 per segment);
17. the default depth path: the same on MapParams() with depth sensing
   (the '2d' fusion, the exact lite ESDF rebuilt every segment: edt_exact
   1 at the reset and 1 per segment);
18. the per-evaluation objective kernels against their plain versions at
   the lazy banks' shapes: B2s (after phase 3) on 3072 scene problems and
   their 12,288 line-search candidates, B7 (after phase 6) on 1536
   problems and 6144 candidates on the vision path's windows and (after
   phase 12) on windows of the gt+grid maps, with samples past the window
   and past the map; values within 5e-4, gradients within 2e-3 of each
   problem's largest component; each launch's grid (blocks x warps, one
   warp per problem) beside its time; and solve.solve_per_eval against B1
   and B6 on their problems (one iteration, 24 in the cost basin, one
   solve of each timed and one per-eval solve under torch.profiler);
19. small loops (B = 16, 2 segments) of the 'expert' and 'warmstart'
   planners with the per-evaluation solve on the scene and gt+grid paths,
   on the card against the CPU;
20. the 'expert' planner at full width, goals at x = 20, 1 warm-up and 2
   timed segments: the gt+grid path at B = 512 with the fused solver and
   with the per-evaluation solve, the scene path at B = 1024 with the
   per-evaluation solve (no frame rendered: render_depth 0);
21. the piece count M = 5 (the reference's init_wpts_num 4): the expert
   planner with the fused solver on the scene path at B = 1024 (B1, B5,
   B3) and on the gt+grid path at B = 512 (B6, B5, B10), 1 warm-up and 2
   timed segments, steps/s, missions and launches above 0;
22. B5 at M = 2, 5, 12 and 16 (n = 6M), both bands, on B = 1024 MINCO
   systems against its plain version on the card (1e-4 of each system's
   largest solution component), times (events and graph_ms), bound
   (givens_bytes: the band's 32 B sectors, the right-hand sides and the
   solution);
23. B2s and B7 at M = 5 and 12 at the lazy banks' shapes (3072 scene
   problems and 12,288 candidates, 1536 problems and 6144 candidates on
   the M = 5 gt+grid loop's windows), held as in phase 18, with times;
24. B1 and B6 at M = 5 and 12 (B = 1024 and 512 problems): at histories
   2 and 3, six iterations (the L-BFGS ring wrapped) on 256 problems, f
   and x of each within 1e-3 of the plain solver on the card, missing on
   no more problems than the plain solver on the CPU does
   (plan/parity.few_iterations); at histories 5, 10 and 20 one iteration
   against the plain solver on the card (1e-3 relative on f,
   plan/parity.one_iteration), 24 iterations in its acceptance and cost
   basin (basin(), its median tolerance from the GPU-vs-CPU control on
   256 problems), times and bounds;
25. plan_adaptive on tests/test_expert.py's golden 24 m problem (M = 12):
   ok and the end-point error (tol 0.05 m);
26. the expert-data and training path: a record rollout (B = 16, 2
   segments, one solver iteration) on the card against the CPU (valid
   flags equal, motions and labels within 1e-4, B4's pixel rule on the
   frames); then learn/pipeline.main at examples/train.py's widths (512
   envs, 12 boxes, a 160 x 120 camera, max_iters 48, the smallconv net at
   batch 64), cut to 2 pulls of 4 segments and 2 epochs: samples/s, ms a
   record segment and the record's launches (B4 1, B1 2, B5 2, B3 1 a
   segment, exactly), train ms a step and steps/s, the torch.export
   program's p50 latency at batch 1; the first training step's loss on the
   card against the CPU from the same weights and batch (1e-5 relative);
   the program and the ONNX file (read back by weights.from_onnx) against
   the trained net (1e-5); a record segment (B = 512) and a training step
   under torch.profiler (utils/profiling.device_trace: device busy time,
   idle share, the kernels with the most device time); two scene 'neo'
   segments at B = 512 with the trained net (replans ok printed: a check
   that it runs);
27. (n) B4 at 640 x 480 over 256 poses (the plain version on 8 of them,
   B4's pixel rule), its time and bound; the paper's PlannerNet
   (NetParams(): ResNet-18 at 640 x 480) with weights from init_params
   seeded NET640_SEED and running stats from four train-mode passes over
   the frames: its forward time at batch 256, card vs CPU at batch 2 with
   TF32 off (1e-4 of the largest output);
28. (o) the paper's NEO loop: the scene path at B = 256 with that net and
   CameraParams(640, 480), random missions, 1 warm-up and 2 timed
   segments, stages, launches held per segment (B4 1, B1 2, B5 2, B3 1);
   a B = 4 card-vs-CPU loop at one solver iteration by phase 4's rules;
29. (p) the 'geo' loop: gt+grid on the flagship map at B = 512, goals at
   x = 20, 1 warm-up and 2 timed segments, the front end ('geo') apart
   from the refine, launches held (B9 exact 1 at the reset; B6 2, B5 2,
   B10 1 a segment); the front end's wavefront timed apart; at B = 8 the
   front end card vs CPU exactly equal and one refine iteration of B6
   against the plain solver (plan/parity.one_iteration);
30. (q) the tracker: track_rollout on the scene path at B = 512, 3
   segments of circular_target_path, every env replanning every segment;
31. (r) the ResNet-18 trainer: 3 steps at batch 64 at 640 x 480 (ms a
   step), the first step card vs CPU at batch 4 with TF32 off (the loss
   and the stem BatchNorm's running stats within 1e-4 relative);
32. (s) the world sweep: two random worlds (WorldParams(): 15 boxes,
   capacity 24) written with worldio.write_world and parsed back (1e-4,
   test_world_roundtrip's tolerance), a forest world of 150
   model://pine_tree meshes written by this script (300 primitives
   parsed; worldio.forest_world_xml), B1 (one iteration by
   plan/parity.one_iteration, 24 in basin()), B3 and B4 on the forest at
   the sweep's shapes (1024 envs at its 304 slots) against their plain
   versions by the flagship's rules, 10-env card-vs-CPU loops on the
   forest at one solver iteration ('neo' and 'expert', phase 4's rules),
   then sim/sweep.main over those 3 worlds x the 'expert' and
   'neo' planners (the smallconv net) at B = 1024 and 3 segments (one
   untimed rollout first): ms a segment, steps/s, missions ok and the
   launches of each cell (B1, B5 and B3 above 0, and B4 under 'neo');
33. (t) the .bt map plan (BASELINE config 1) on the first parsed world:
   occupancy_3d at MapParams() with 100 z cells and fill_unknown_3d on the
   card (voxels, the fill's steps and ms) against the CPU (0 differing
   voxels), write_bt / bt_to_grid (equal) and write_pcd / read_pcd in both
   modes, the z in [1.8, 10] slice projected as
   tests/test_octomap_io.py:46-62 does (its cells that differ from
   occupancy_2d printed), esdf.build on it (B9 exact; 0 cells differing
   from the plain version) and expert.plan for 512 start/goal pairs on
   that map (B6 and B5: ok and launches);
34. (u) the env-axis mesh: a world-size-1 NCCL group over a FileStore,
   make_mesh() and make_multislice_mesh(1, dcn=1, mdl=1), shard_batch of
   the flagship scene state (B = 1024, two segments in), one segment
   through sharded_vmap_step against the unsharded segment on the same
   state and draws (0 differing elements), mean_over_envs of the weighted
   metric against the unsharded mean (1e-6) and replicate; more than one
   card is not measured on a one-card machine;
35. (v) the JAX package's orbax checkpoints read without JAX
   (io/zstd.py's decoder built by g++, io/ocdbt.py, io/orbax.py under
   train.load_checkpoint): the smallconv checkpoint bit for bit against
   weights.from_onnx of its .onnx; the trained ResNet-18 checkpoint
   (artifacts/planner_net_resnet640): restore time, bytes decoded and the
   SHA-256 of its state_dict (weights.digest) against RESNET640_SHA256,
   the digest of JAX's restore; its forward pass at batch 256 on phase
   (n)'s frames, card vs CPU (1e-4 of the largest output); the paper's
   NEO loop with the trained net (phase (o)'s loop: B = 256, 640 x 480,
   B4 1, B1 2, B5 2, B3 1 a segment), ms a segment, replans ok, L-BFGS
   iterations a plan and acceptance (over the warm-up and the timed
   segments: with periodic replans every env plans in the warm-up only)
   beside the seeded net's from phase (o), then both nets' loops with
   replan_mode="online" (every env replans every segment until its goal);
   the trained net's B = 4 card-vs-CPU twin at one solver iteration by phase 4's
   rules, and at 24 iterations the plan flags' agreement and the median
   relative objective gap of the plans both accepted (printed, not held).

The vision paths' counts include their reset, which builds the truncated
lite map of an unknown grid through B9 banded. The last lines are every
kernel's launches over the paths, the kernels' JSON record, the card's name
and power limit, and
{"ok": true, "device": {...}}. Any failure exits non-zero before them.
The script needs one GPU and exits non-zero without a result when there is
none or when the package is missing.

--against CHECKOUT (another commit's tree, e.g. unpacked by git archive)
also builds that tree's neoplanner_tpu_torch/csrc in this process and, at
each objective check of phase 18, launches its B2s / B7 on the same inputs,
at phases 6, 12 and 13 its B9 fused (the vision grids), B9 exact and B9
banded (the default map's ground-truth and fused grids), at phase 2 its B4
(the scene frames, B = 1024, 160 x 120, and the same frames with every
third primitive a cylinder) and B3 (spr = 60, B = 1024), at
phase 6 its B10 (spr = 60 and a 10-substep chunk from i0 = 30, B = 512)
and B8 v2 (the replan frame, B = 512), at phase 9 its B4 at row stride 4
(512 x 5 poses) and B8 v3 (the five strided frames, B = 512), at phase 2
also its B5 (B = 1024 at both bands, B = 512) and at phase 14 its B8 v1
(the 4 m camera's 114-cell windows, B = 512, both from copies of one
grid): it prints the elements (f and g, field cells, pixels, grid cells,
or the state, trace and tick elements) whose bits differ from this
tree's and both kernels' medians in turns (other, this, this, other),
both through their C entries, back to back from the host and as a CUDA
graph of the launches (the device time), and for B3, B4, B5, B8 and B10
the shape's bound (B4's from the survivors of its tiles' cull); at phase
25 also its B1 (B = 1024) and B6 (B = 512) at M = 3 and history 10. The
other checkout's kernels are built and bound by that checkout's own
neoplanner_tpu_torch/_cuda.py. Nothing is held against a tolerance there.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

B = 1024                      # envs on the scene path
BV = 512                      # envs on the vision path
SEGMENTS = 3                  # timed segments after one warm-up
PEAK_F32 = 67e12              # H100 SXM f32 (non-tensor) FLOP/s, data sheet
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 bytes/s, data sheet
# The least operations per cell of a truncated EDT of a binarized grid: the
# threshold, a two-sweep pass 1 (a compare, a select and an add per sweep),
# a linear-time lower-envelope pass 2 (~10), then sqrt, scale, clamp and
# the bf16 store. O(1) per cell: the banded kernel's loop trips over +-R
# are its own choice and are not counted.
EDT_CELL_OPS = 20
REPO = os.path.dirname(os.path.abspath(__file__))

KERNELS = {
    "lbfgs_scene_solve": dict(
        source="neoplanner_tpu_torch/csrc/lbfgs_scene.cu",
        replaces="neoplanner_tpu/plan/solve_pallas.py:223"),
    "minco_banded_solve": dict(
        source="neoplanner_tpu_torch/csrc/minco_solve.cu",
        replaces="neoplanner_tpu/ops/minco_pallas.py:37"),
    "track_segment": dict(
        source="neoplanner_tpu_torch/csrc/track.cu",
        replaces="neoplanner_tpu/sim/track_pallas.py:94"),
    "render_depth": dict(
        source="neoplanner_tpu_torch/csrc/raycast.cu",
        replaces="neoplanner_tpu/sense/raycast_pallas.py:72"),
    "lbfgs_grid_solve": dict(
        source="neoplanner_tpu_torch/csrc/lbfgs_grid.cu",
        replaces="neoplanner_tpu/plan/solve_pallas_grid.py:46"),
    "fuse_depth_dense": dict(
        source="neoplanner_tpu_torch/csrc/fusion.cu",
        replaces="neoplanner_tpu/mapping/occupancy_pallas.py:176"),
    "edt_trunc_lite": dict(
        source="neoplanner_tpu_torch/csrc/edt_trunc.cu",
        replaces="neoplanner_tpu/ops/edt_pallas.py:153"),
    "track_segment_grid": dict(
        source="neoplanner_tpu_torch/csrc/track.cu",
        replaces="neoplanner_tpu/sim/track_pallas.py:94"),
    "fuse_depth_multi": dict(
        source="neoplanner_tpu_torch/csrc/fusion_multi.cu",
        replaces="neoplanner_tpu/mapping/occupancy_pallas.py:299"),
    "edt_exact": dict(
        source="neoplanner_tpu_torch/csrc/edt_exact.cu",
        replaces="neoplanner_tpu/ops/edt_pallas.py:32"),
    "edt_banded": dict(
        source="neoplanner_tpu_torch/csrc/edt_trunc.cu",
        replaces="neoplanner_tpu/ops/edt_pallas.py:56"),
    "fuse_depth_window": dict(
        source="neoplanner_tpu_torch/csrc/fusion_window.cu",
        replaces="neoplanner_tpu/mapping/occupancy_pallas.py:51"),
    "objective_scene_fwd": dict(
        source="neoplanner_tpu_torch/csrc/objective_eval.cu",
        replaces="neoplanner_tpu/plan/costs_pallas.py:514"),
    "objective_scene_valgrad": dict(
        source="neoplanner_tpu_torch/csrc/objective_eval.cu",
        replaces="neoplanner_tpu/plan/costs_pallas.py:514"),
    "objective_grid_fwd": dict(
        source="neoplanner_tpu_torch/csrc/objective_eval.cu",
        replaces="neoplanner_tpu/plan/costs_pallas_grid.py:79"),
    "objective_grid_valgrad": dict(
        source="neoplanner_tpu_torch/csrc/objective_eval.cu",
        replaces="neoplanner_tpu/plan/costs_pallas_grid.py:94"),
}
SCENE_PATH = ("lbfgs_scene_solve", "minco_banded_solve", "track_segment",
              "render_depth")
# the vision paths' reset builds the truncated lite map of an unknown grid
# through B9 banded (esdf.build, as the reference's reset)
VISION_PATH = ("render_depth", "fuse_depth_dense", "edt_trunc_lite",
               "lbfgs_grid_solve", "minco_banded_solve", "track_segment_grid",
               "edt_banded")
SENSOR_PATH = VISION_PATH + ("fuse_depth_multi",)
# the gt+grid and the default depth path (whose '2d' fusion has no kernel)
DEFAULT_MAP_PATH = ("render_depth", "edt_exact", "lbfgs_grid_solve",
                    "minco_banded_solve", "track_segment_grid")
# the expert planner's loops (no net, no frame on the ground-truth paths)
EXPERT_GRID_PATH = ("edt_exact", "lbfgs_grid_solve", "minco_banded_solve",
                    "track_segment_grid")
PER_EVAL_GRID_PATH = ("edt_exact", "objective_grid_fwd",
                      "objective_grid_valgrad", "minco_banded_solve",
                      "track_segment_grid")
PER_EVAL_SCENE_PATH = ("objective_scene_fwd", "objective_scene_valgrad",
                       "minco_banded_solve", "track_segment")
# the expert planner on the scene (no frame rendered)
EXPERT_SCENE_PATH = ("lbfgs_scene_solve", "minco_banded_solve",
                     "track_segment")
# the piece counts whose kernel libraries the run builds (side by side)
PIECE_BUILDS = (2, 3, 5, 12, 16)
FUSE_FRAMES = 6               # examples/profile_vision.py:36 (VIS_FUSE)
# launches per segment of the sensor-rate loop: the replan-time frame and
# the five mid-segment frames in one launch, one fusion each, one rebuild,
# six tracking chunks
SENSOR_PER_SEGMENT = dict(render_depth=2, fuse_depth_dense=1,
                          fuse_depth_multi=1, edt_trunc_lite=1,
                          track_segment_grid=FUSE_FRAMES)


# appended to every line that say() prints (phase (v): the card's name and
# power limit, also on the lines of the loops it runs)
_SAY_TAG = [""]


def say(msg: str) -> None:
    print(msg + _SAY_TAG[0], flush=True)


def load_other(checkout: str):
    """Another checkout's kernel libraries, built and bound by that
    checkout's own _cuda module (its C entries may take other arguments):
    (the main library, the library of B5, B1, B6, B2s and B7 at M = 3,
    nvcc seconds). A checkout with one library returns it twice."""
    import importlib.util
    from pathlib import Path
    path = Path(checkout).resolve() / "neoplanner_tpu_torch" / "_cuda.py"
    spec = importlib.util.spec_from_file_location("other_cuda", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if hasattr(mod, "load_pieces"):
        main_lib, lib3 = mod.load(), mod.load_pieces(3)
        return main_lib, lib3, sum(mod.build_seconds.values())
    lib, seconds = mod.load_from(mod._SRC)
    return lib, lib, seconds or 0.0


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def median_ms(torch, fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def bound(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def render_work(kept, rows: int, width: int, n_prims: int,
                tile: tuple[int, int]):
    """B4's operations and bytes on this run's inputs. kept is
    raycast.tile_cull's (E, [F,] TY, TX, K) survivors of the tiles (TILE_H,
    TILE_W); a pixel costs 60 operations (its ray, the ground plane, the
    depth) and 35 for each primitive it tests, the survivors of its tile.
    The bytes read each pose and each env's table of n_prims once and write
    each pixel."""
    th, tw = tile
    h = np.minimum(th, rows - np.arange(0, rows, th))
    w = np.minimum(tw, width - np.arange(0, width, tw))
    per_tile = kept.sum(-1).double().cpu().numpy()
    flops = float((h[:, None] * w[None, :] * (60 + 35 * per_tile)).sum())
    n_pose = int(np.prod(kept.shape[:-3]))
    nbytes = (n_pose * (3 + 4 + rows * width)
              + kept.shape[0] * n_prims * 8) * 4
    return flops, nbytes


def givens_flops(lbw: int, n: int = 18, d: int = 2, fill: int = 6) -> int:
    """Floating-point operations of one band-restricted Givens solve of
    n = 6M rows (18 at M = 3)."""
    f = 0
    for c in range(n):
        for _ in range(c + 1, min(c + lbw + 1, n)):
            f += 7 + 6 * ((min(c + fill + 1, n) - c) + d)
        f += d * (2 * (min(c + fill + 1, n) - c - 1) + 1)
    return f


def givens_bytes(n: int, lbw: int, count: int, d: int = 2,
                 fill: int = 6) -> int:
    """Bytes that count band solves of n = 6M rows must move: of each row r
    of a problem's dense aug (n, n + d) only its band, columns r - lbw ..
    r + fill - lbw, and its d right-hand sides, counted as the 32 B
    sectors they touch (the problems back to back), and the n x d solution
    written once."""
    r, j = np.arange(n)[:, None], np.arange(n + d)[None, :]
    need = (j >= n) | ((j >= r - lbw) & (j <= r + fill - lbw))
    at = np.arange(count)[:, None] * (n * (n + d)) \
        + np.nonzero(need.ravel())[0][None, :]
    return int(np.unique(at * 4 // 32).size) * 32 + count * n * d * 4


def objective_flops(K: int, dist_flops, grad: bool, M: int = 3):
    """Operations of one objective evaluation per problem (M pieces, K
    samples each): the system build and solve, the energy quadrature (3M
    nodes), and per sample the polynomial, the hinges and dist_flops for
    the distance query (~20 per live primitive of the scene SDF, ~25 for
    four window taps); with the gradient also the per-sample adjoint, the
    transposed solve and the duration chain."""
    per_sample = 50 + dist_flops + (60 if grad else 0)
    fixed = 40 * M + givens_flops(4, 6 * M) + 3 * M * 30
    if grad:
        fixed += givens_flops(2, 6 * M) + 3 * M * 30 + 50 * M
    return fixed + M * K * per_sample


def solve_flops(K: int, dist_flops, iters: np.ndarray, M: int = 3) -> float:
    """A solve spending iters iterations: one value-and-gradient per
    iteration plus the first, and at least one line-search value each."""
    return float(np.sum(objective_flops(K, dist_flops, True, M) * (1 + iters)
                        + objective_flops(K, dist_flops, False, M) * iters))


def err_line(got, want):
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    d = np.abs(g - w)
    return float(d.max()), float((d / np.maximum(np.abs(w), 1e-6)).max())


def rel(a, b):
    return ((a - b).abs() / b.abs().clamp(min=1.0)).cpu().numpy()


def record_check(dev, pp, mp, sp, mapp, cam, card):
    """learn/datagen.record_rollout at B = 16, 2 segments, one solver
    iteration, on the card and on the CPU from the same worlds, goals and
    draws: the valid flags equal, motions and labels within 1e-4 on the
    valid samples, at most 1e-3 of the frames' pixels off by more than
    1e-3 m (B4's rule; the normalized frames scaled back by max_range)."""
    import torch
    from neoplanner_tpu_torch import _cuda
    from neoplanner_tpu_torch.config import WorldParams
    from neoplanner_tpu_torch.learn import datagen
    from neoplanner_tpu_torch.sim import env
    from neoplanner_tpu_torch.world import scenegen
    n, segs = 16, 2
    pp1 = dataclasses.replace(pp, max_iters=1)
    gen_c = _cuda.make_generator(40, "cpu")
    w_c = scenegen.generate_batch(gen_c, n, WorldParams(num_boxes=12))
    s_c = env.reset(w_c, pp1, mp, mapp, gen_c)
    w_g = w_c.replace(**{f: getattr(w_c, f).to(dev) for f in
                         ("centers", "half_sizes", "active", "shape")})
    s_g = env.reset(w_g, pp1, mp, mapp, _cuda.make_generator(40, dev),
                    goal=s_c.goal.to(dev))
    d_c = [env.draw(gen_c, n, pp1) for _ in range(segs)]
    d_g = [d.replace(**{k: getattr(d, k).to(dev) for k in
                        ("target_noise", "bank_noise", "goal_u")})
           for d in d_c]
    _, *out_g = datagen.record_rollout(s_g, segs, pp1, mp, sp, cam,
                                       mp.des_pos_z, draws=d_g)
    _, *out_c = datagen.record_rollout(s_c, segs, pp1, mp, sp, cam,
                                       mp.des_pos_z, draws=d_c)
    (dg, mg, lg, vg), (dc, mc, lc, vc) = ([t.cpu() for t in o]
                                          for o in (out_g, out_c))
    err_m = float((mg - mc)[vc].abs().max()) if vc.any() else 0.0
    err_l = float((lg - lc)[vc].abs().max()) if vc.any() else 0.0
    off = float(((dg - dc).abs() * cam.max_range / 255.0 > 1e-3)
                .float().mean())
    same = bool(torch.equal(vg, vc))
    say(f"record B={n} {segs} segments (1 iteration) card vs CPU: valid "
        f"flags equal {same} ({int(vc.sum())} of {vc.numel()} valid), "
        f"motions max diff {err_m:.3g}, labels {err_l:.3g} (tol 1e-4), "
        f"frames {off:.2e} of pixels off by > 1e-3 m (tol 1e-3) [{card}]")
    if not same or not bool(vc.any()) or err_m > 1e-4 or err_l > 1e-4 \
            or off > 1e-3:
        raise AssertionError("the record rollout on the card disagrees "
                             "with the CPU")


RECORD_PER_SEGMENT = dict(render_depth=1, lbfgs_scene_solve=2,
                          minco_banded_solve=2, track_segment=1)


def pipeline_phase(dev, mp, sp, mapp, cam, card, launch_totals, tmp):
    """learn/pipeline.main at examples/train.py's widths, cut to 2 pulls of
    4 segments and 2 epochs, with its record launches held per segment;
    then the first training step card vs CPU, the exported program and
    ONNX file against the net, and two scene 'neo' segments with it."""
    import torch
    from neoplanner_tpu_torch import _cuda
    from neoplanner_tpu_torch.config import PlannerParams, WorldParams
    from torch.autograd import DeviceType
    from neoplanner_tpu_torch.learn import (data, datagen, export, pipeline,
                                            train, weights)
    from neoplanner_tpu_torch.models import planner_net
    from neoplanner_tpu_torch.sim import env
    from neoplanner_tpu_torch.utils import profiling
    from neoplanner_tpu_torch.world import scenegen
    pulls, seg_per_pull, epochs = 2, 4, 2
    _cuda.reset_launches()
    res = pipeline.main([
        "--envs", "512", "--pulls", str(pulls),
        "--segments-per-pull", str(seg_per_pull), "--epochs", str(epochs),
        "--batch-size", "64", "--max-iters", "48",
        "--out", os.path.join(tmp, "planner_net")])
    counts = dict(_cuda.launches)
    segs = res["segments"]
    say(f"pipeline record (512 envs, 12 boxes, 160 x 120, max_iters 48; "
        f"cut: {pulls} pulls of {seg_per_pull} segments, not 6): "
        f"{res['samples']} samples, {res['samples'] / res['record_s']:.1f} "
        f"samples/s, {res['record_s'] * 1e3 / segs:.1f} ms a record segment "
        f"(the last pull's {res['pull_s'][-1] * 1e3 / seg_per_pull:.1f}; the "
        f"first holds the warm-up) [{card}]")
    say(f"pipeline record launches ({segs} segments): " + ", ".join(
        f"{k} {counts[k]} ({counts[k] / segs:g}/segment)"
        for k in RECORD_PER_SEGMENT) + f" [{card}]")
    for k, per in RECORD_PER_SEGMENT.items():
        if counts[k] != per * segs or res["launches"][k] != counts[k]:
            raise AssertionError(f"the record phase launched {k} "
                                 f"{counts[k]} times, expected {per} a "
                                 f"segment")
        launch_totals[k] += counts[k]
    first_ms = res["history"]["epoch_s"][0] * 1e3 / res["steps_per_epoch"]
    say(f"pipeline train (smallconv, batch 64; cut: {epochs} epochs, not "
        f"12): {res['steps_per_epoch']} steps an epoch, "
        f"{res['step_ms']:.3f} ms a step, {1e3 / res['step_ms']:.1f} steps/s"
        f" in the last epoch (the first, with the warm-up: {first_ms:.3f} "
        f"ms a step; train() whole {res['train_s']:.2f} s), loss "
        f"{res['history']['train_loss']} test {res['history']['test_loss']}"
        f" [{card}]")
    say(f"pipeline export: torch.export program p50 "
        f"{res['latency_ms'][1]:.4f} ms, mean {res['latency_ms'][0]:.4f} ms "
        f"at batch 1 [{card}]")
    net = res["net"]
    np_cfg = net.np_cfg
    D, M, L = res["dataset"]

    # the first training step on the card and on the CPU, one init, one batch
    init = train.init_params(torch.Generator().manual_seed(0), np_cfg)
    batch = (torch.as_tensor(D[:64], dtype=torch.float32)[..., None],
             torch.as_tensor(M[:64]), torch.as_tensor(L[:64]))
    losses = []
    for on in (dev, torch.device("cpu")):
        n_ = planner_net.PlannerNet(np_cfg)
        n_.load_state_dict(init)
        n_.to(on).train()
        opt = train.make_optimizer(n_, train.TrainConfig())
        losses.append(float(train.train_step(
            n_, opt, *(t.to(on) for t in batch))))
    rel_loss = abs(losses[0] - losses[1]) / abs(losses[1])
    say(f"first training step loss card {losses[0]:.7g} CPU {losses[1]:.7g}:"
        f" rel diff {rel_loss:.3g} (tol 1e-5)")
    if rel_loss > 1e-5:
        raise AssertionError("the training step on the card disagrees with "
                             "the CPU")

    # the program and the ONNX file against the net
    engine = export.load(res["paths"]["program"], dev)
    onnx_net = planner_net.PlannerNet(np_cfg)
    onnx_net.load_state_dict(weights.from_onnx(res["paths"]["onnx"]))
    onnx_net.to(dev).eval()
    flat = data.flat_input(torch.as_tensor(D[:8], dtype=torch.float32),
                           torch.as_tensor(M[:8])).to(dev)
    with torch.no_grad():
        want = torch.cat([net.forward_flat(flat[i:i + 1]) for i in range(8)])
        got_e = torch.cat([engine(flat[i:i + 1]) for i in range(8)])
        got_o = torch.cat([onnx_net.forward_flat(flat[i:i + 1])
                           for i in range(8)])
    err_e = float((got_e - want).abs().max())
    err_o = float((got_o - want).abs().max())
    say(f"export, 8 samples at batch 1: program vs net max diff "
        f"{err_e:.3g}, ONNX "
        f"(weights.from_onnx) vs net {err_o:.3g} (tol 1e-5)")
    if err_e > 1e-5 or err_o > 1e-5:
        raise AssertionError("the exported net disagrees with the trained "
                             "one")

    # where a record segment's and a training step's time goes: their
    # device events under torch.profiler (utils/profiling.device_trace)
    pp48 = PlannerParams(max_iters=48)
    gen = _cuda.make_generator(30, dev)
    worlds = scenegen.generate_batch(gen, 512, WorldParams(num_boxes=12))
    state = env.reset(worlds, pp48, mp, mapp, gen)
    tnet = planner_net.PlannerNet(np_cfg)
    tnet.load_state_dict(net.state_dict())
    tnet.to(dev).train()
    opt = train.make_optimizer(tnet, train.TrainConfig())
    batch = tuple(t.to(dev) for t in batch)
    for name, fn in (
            ("record segment B=512", lambda: datagen.record_rollout(
                state, 1, pp48, mp, sp, cam, mp.des_pos_z)),
            ("training step", lambda: train.train_step(tnet, opt, *batch))):
        fn()
        torch.cuda.synchronize()
        with profiling.device_trace(os.path.join(tmp, "trace")) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # the device's kernels and copies (not the ranges that user
        # annotations such as the optimizer's step span on the device)
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        say(f"{name} under torch.profiler: {wall:.2f} ms wall, "
            f"{len(kern)} device events busy {busy:.3f} ms (idle share "
            f"{1.0 - busy / wall:.3f}); most device time: " + "; ".join(
                f"{k[:40]} {v:.3f} ms" for k, v in top) + f" [{card}]")

    # two scene 'neo' segments at B = 512 with the trained net
    ok, planned = 0, 0
    for _ in range(2):
        state, info = env.step_segment(state, pp48, mp, sp, cam, net)
        ok += int(info.ok.sum())
        planned += int(info.planned.sum())
    finite = all(bool(torch.isfinite(t).all()) for t in (
        state.drone.pos, state.buffer, state.metrics))
    say(f"trained net, 2 scene 'neo' segments B=512: replans ok "
        f"{ok}/{planned}, finite {finite}")
    if not finite or planned == 0:
        raise AssertionError("the trained net's loop did not run")


NET640_SEED = 640             # the seeded weights of the 640 x 480 net
# the trained 640 x 480 net's checkpoint, and weights.digest of the
# state_dict that JAX's train.load_checkpoint + weights.from_flax give
# (held there by tests/test_torch_orbax.py)
RESNET640 = os.path.join("artifacts", "planner_net_resnet640")
RESNET640_SHA256 = ("375694e11667bb36187f89b6fe7c26b1"
                    "3f246abf112353349d8151ed00723d3b")
NEO640_PER_SEGMENT = dict(render_depth=1, lbfgs_scene_solve=2,
                          minco_banded_solve=2, track_segment=1)
GEO_PATH = ("edt_exact", "lbfgs_grid_solve", "minco_banded_solve",
            "track_segment_grid")
GEO_PER_SEGMENT = dict(lbfgs_grid_solve=2, minco_banded_solve=2,
                       track_segment_grid=1, edt_exact=0)
TRACKER_PATH = ("lbfgs_scene_solve", "minco_banded_solve", "track_segment")


def seeded_net640(dev, frames_u8):
    """The PlannerNet of NetParams() (ResNet-18, 640 x 480) with weights
    from the port's init_params seeded NET640_SEED, its running stats set
    by four train-mode passes over frames_u8 (normalized depth frames on
    the card) so that eval() reads nonzero, realistic stats; in eval()
    mode on dev."""
    import torch
    from neoplanner_tpu_torch.config import NetParams
    from neoplanner_tpu_torch.learn import train
    from neoplanner_tpu_torch.models.planner_net import PlannerNet
    net = PlannerNet(NetParams())
    net.load_state_dict(train.init_params(
        torch.Generator().manual_seed(NET640_SEED), NetParams()))
    net.to(dev).train()
    motion = torch.zeros((frames_u8.shape[0], 24), device=dev)
    with torch.no_grad():
        for _ in range(4):
            net(frames_u8[..., None], motion)
    return net.eval()


def paper_phases(dev, card, pp, mp, sp, mapp, worlds, worlds_v, goals_v,
                 launch_totals, run_path, small_loop, render_work, wp):
    """(n) B4 at 640 x 480 and the ResNet-18 PlannerNet's forward pass;
    (o) the paper's NEO loop at 640 x 480 (scene path, B = 256) and its
    B = 4 card-vs-CPU twin; (p) the 'geo' loop on the gt+grid path at
    B = 512 and the geo front end card vs CPU; (q) the tracker at B = 512;
    (r) the ResNet-18 trainer. Each phase prints its own wall time.
    Returns what phase (v) reuses: (n)'s frames and motion inputs, the
    256 worlds and the seeded net's loop figures from (o)."""
    import torch
    from neoplanner_tpu_torch import _cuda
    from neoplanner_tpu_torch.config import CameraParams, NetParams
    from neoplanner_tpu_torch.core import frames
    from neoplanner_tpu_torch.learn import data, train
    from neoplanner_tpu_torch.models.planner_net import PlannerNet
    from neoplanner_tpu_torch.ops import minco
    from neoplanner_tpu_torch.plan import costs, expert, geo, parity, solve
    from neoplanner_tpu_torch.sense import raycast
    from neoplanner_tpu_torch.sim import env, tracker
    from neoplanner_tpu_torch.world import scenegen

    rng = np.random.default_rng(13)          # these phases' own draws
    cam640 = CameraParams(width=640, height=480)
    n_pose = 256

    # ---- (n) B4 at 640 x 480: 256 poses, the plain version on 8
    t_n = time.perf_counter()
    sub = type(worlds)(*(getattr(worlds, f)[:n_pose] for f in
                         ("centers", "half_sizes", "active", "shape")))
    pos = torch.from_numpy(np.stack([
        rng.uniform(-1.0, 4.0, n_pose), rng.uniform(-2.0, 2.0, n_pose),
        rng.uniform(1.5, 2.5, n_pose)], -1)).float().to(dev)
    quat = frames.quat_from_accel_yaw(
        torch.from_numpy(rng.normal(scale=2.0, size=(n_pose, 3))).float()
        .to(dev), torch.from_numpy(rng.uniform(-0.6, 0.6, n_pose)).float()
        .to(dev)).contiguous()
    prims = raycast.pack_prims(sub)
    depth = torch.empty((n_pose, 480, 640), device=dev)
    raycast.launch_render(pos, quat, prims, depth, cam640)
    sub8 = type(worlds)(*(getattr(sub, f)[:8] for f in
                          ("centers", "half_sizes", "active", "shape")))
    want = raycast.render_depth(sub8, pos[:8], quat[:8], cam640)
    diff = (depth[:8] - want).abs()
    frac_off = float((diff > 1e-3).float().mean())
    ms = median_ms(torch, lambda: raycast.launch_render(
        pos, quat, prims, depth, cam640), 10)
    kept = raycast.tile_cull(sub, pos, quat, cam640)
    b_ms, b_by = bound(*render_work(kept, 480, 640, prims.shape[1],
                                    (raycast.TILE_H, raycast.TILE_W)))
    say(f"(n) render_depth 640 x 480, {n_pose} poses: {frac_off:.2e} of the "
        f"first 8 frames' pixels off the plain version by > 1e-3 m (tol "
        f"1e-3), max abs {float(diff.max()):.3g}; {ms:.3f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}) [{card}]")
    if frac_off > 1e-3:
        raise AssertionError("render_depth at 640 x 480 disagrees with its "
                             "plain version")
    img = data.normalize_depth(depth)
    net = seeded_net640(dev, img)
    bn0 = net.img_backbone.bn_0
    say(f"(n) PlannerNet NetParams() (resnet18/mlp), seeded weights "
        f"(init_params seed {NET640_SEED}; running stats from 4 train-mode "
        f"passes over the frames: stem mean |{float(bn0.running_mean.abs().mean()):.3g}|, "
        f"var {float(bn0.running_var.mean()):.3g}); cuDNN TF32 "
        f"{torch.backends.cudnn.allow_tf32}, matmul TF32 "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    motion = torch.from_numpy(rng.normal(size=(n_pose, 24))).float().to(dev)
    with torch.no_grad():
        fwd_ms = median_ms(torch, lambda: net(img[..., None], motion), 5)
        out_g = net(img[:2, ..., None], motion[:2]).cpu()
    net_cpu = PlannerNet(NetParams())
    net_cpu.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
    net_cpu.eval()
    with torch.no_grad():
        out_c = net_cpu(img[:2, ..., None].cpu(), motion[:2].cpu())
    err = float((out_g - out_c).abs().max() / out_c.abs().max())
    macs = 11.1e9 * n_pose      # ~11 G multiply-adds an image at 640 x 480
    say(f"(n) PlannerNet forward batch {n_pose}: {fwd_ms:.2f} ms "
        f"({fwd_ms / n_pose:.3f} ms an image; {2 * macs / fwd_ms / 1e9:.1f} "
        f"TFLOP/s of f32 against the card's 67); card vs CPU at batch 2: "
        f"max diff {err:.3g} of the largest output (tol 1e-4); phase "
        f"{time.perf_counter() - t_n:.1f} s [{card}]")
    if err > 1e-4:
        raise AssertionError("the ResNet-18 net on the card disagrees with "
                             "the CPU")

    # ---- (o) the paper's NEO loop: scene path, B = 256, 640 x 480
    t_o = time.perf_counter()
    worlds256 = sub
    seeded = {}
    run_path("paper NEO 640x480", SCENE_PATH, n_pose, lambda: env.reset(
        worlds256, pp, mp, mapp, _cuda.make_generator(21)), n_seg=2,
        per_segment=NEO640_PER_SEGMENT, net_=net, cam_=cam640, stats=seeded)
    # card vs CPU at one solver iteration: the seeded net's inits leave
    # 24-iteration solves chaotic (a 1e-6 relative change of its weights
    # moves a plan by 0.07 m on the CPU alone)
    small_loop("paper NEO 640x480 (1 iteration)", 4, 22,
               lambda g, n: scenegen.generate_batch(g, n, wp), mapp, {},
               pp_=dataclasses.replace(pp, max_iters=1), cam_=cam640,
               nets=(net, net_cpu))
    say(f"(o) phase {time.perf_counter() - t_o:.1f} s")

    # ---- (p) the 'geo' loop: gt+grid on the flagship map, B = 512
    t_p = time.perf_counter()
    gt_grid = dict(sensing="gt", plan_map="grid")
    state_g, planned = run_path(
        "gt+grid geo", GEO_PATH, BV, lambda: env.reset(
            worlds_v, pp, mp, mapp, _cuda.make_generator(23), goal=goals_v,
            **gt_grid), n_seg=2, per_segment=GEO_PER_SEGMENT,
        at_reset=dict(edt_exact=1), absent=("render_depth",
                                            "lbfgs_scene_solve"),
        planner="geo")
    if planned <= 0:
        raise AssertionError("the geo loop's timed segments replanned no env")
    # the front end's parts at B = 512: the wavefront alone and whole
    head_b = torch.zeros((BV, 3, 2), device=dev)
    tail_b = torch.zeros((BV, 3, 2), device=dev)
    head_b[:, 0] = state_g.drone.pos[:, :2]
    tail_b[:, 0] = head_b[:, 0] + torch.tensor([5.0, 0.0], device=dev)
    wave_ms = median_ms(torch, lambda: geo.wavefront_field(
        state_g.emap, tail_b[:, 0], pp.safe_dis, 256), 3)
    fe_ms = median_ms(torch, lambda: geo.front_end(
        state_g.emap, head_b, tail_b, pp.safe_dis), 3)
    cells = BV * mapp.height * mapp.width
    say(f"(p) geo front end B={BV}: {fe_ms:.1f} ms whole, the wavefront's "
        f"256 sweeps {wave_ms:.1f} ms ({wave_ms / 256 * 1e3:.0f} us a sweep "
        f"over {cells * 4 / 1e6:.0f} MB), descent and pruning "
        f"{fe_ms - wave_ms:.1f} ms [{card}]")
    # the front end and one refine iteration, B = 8, card vs CPU
    n8 = 8
    emap8 = state_g.emap.index(torch.arange(n8, device=dev))
    emap8_c = emap8.replace(**{f: getattr(emap8, f).cpu() for f in (
        "esdf", "origin", "occupancy", "grad_x", "grad_y")})
    head = torch.zeros((n8, 3, 2), device=dev)
    tail = torch.zeros((n8, 3, 2), device=dev)
    head[:, 0] = state_g.drone.pos[:n8, :2]
    tail[:, 0] = head[:, 0] + torch.tensor([5.0, 0.0], device=dev)
    fe_g = geo.front_end(emap8, head, tail, pp.safe_dis)
    fe_c = geo.front_end(emap8_c, head.cpu(), tail.cpu(), pp.safe_dis)
    same = [bool(torch.equal(a.cpu(), b)) for a, b in zip(fe_g, fe_c)]
    say(f"(p) geo front end B={n8} card vs CPU: field, descent points, "
        f"ends, key indices equal {same} (exact expected)")
    if not all(same):
        raise AssertionError("the geo front end on the card differs from "
                             "the CPU")
    _, pts, _, i1, i2 = fe_g
    envs = torch.arange(n8, device=dev)
    q0 = torch.stack([pts[envs, i1], pts[envs, i2]], -1)
    pp1 = dataclasses.replace(pp, max_iters=1)
    x0 = costs.pack(q0, minco.T_to_tau(expert.init_ts(pp, dev).expand(
        n8, -1), pp.t_min, pp.t_max), pp).contiguous()
    window = expert.make_plan_window(emap8, head, tail, pp)
    got = solve.solve_grid(x0, head, tail, window, envs, pp1)
    want = solve._solve_plain(x0, head, tail, window, envs, pp1)
    worst, n_off = parity.one_iteration(x0, head, tail, window, envs, pp1,
                                        got, want)
    say(f"(p) geo refine B={n8}, one iteration: B6 against the plain solver "
        f"max rel f {worst:.3g} (tol 1e-3), {n_off} off; phase "
        f"{time.perf_counter() - t_p:.1f} s")

    # ---- (q) the tracker: 3 segments of a circle, scene path, B = 512
    t_q = time.perf_counter()
    sub5 = type(worlds)(*(getattr(worlds, f)[:BV] for f in
                          ("centers", "half_sizes", "active", "shape")))
    start = torch.tensor([[1.5, 0.0]], device=dev).expand(BV, 2)
    targets = tracker.circular_target_path(3, [0.5, 0.0], 1.0, 0.5,
                                           mp.replan_period, device=dev)
    _cuda.reset_launches()
    state_t = env.reset(sub5, pp, mp, mapp, _cuda.make_generator(24),
                        goal=start.clone(), start_pos=start)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_t, path = tracker.track_rollout(state_t, targets, pp, mp, sp)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(_cuda.launches)
    err_t = (path[-1, :, :2] - targets[-1]).norm(dim=-1)
    say(f"(q) tracker B={BV}, 3 segments of a circle: plan_count "
        f"{sorted(set(state_t.plan_count.tolist()))} (3 expected), "
        f"{secs * 1e3 / 3:.1f} ms/segment, target error at the end median "
        f"{float(err_t.median()):.3g} m; launches " + ", ".join(
            f"{k} {counts[k]}" for k in TRACKER_PATH)
        + f"; phase {time.perf_counter() - t_q:.1f} s [{card}]")
    if not bool((state_t.plan_count == 3).all()) or not bool(
            torch.isfinite(path).all()):
        raise AssertionError("the tracker did not replan every segment")
    for k in TRACKER_PATH:
        if counts[k] <= 0:
            raise AssertionError(f"the tracker never launched {k}")
        launch_totals[k] += counts[k]

    # ---- (r) the ResNet-18 trainer at 640 x 480
    t_r = time.perf_counter()
    labels = torch.from_numpy(rng.normal(size=(n_pose, 9))).float().to(dev)
    tnet = PlannerNet(NetParams())
    tnet.load_state_dict(net.state_dict())
    tnet.to(dev).train()
    opt = train.make_optimizer(tnet, train.TrainConfig())
    times = []
    for k in range(4):          # one warm-up, 3 timed
        idx = slice(64 * k, 64 * (k + 1))
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        train.train_step(tnet, opt, img[idx, ..., None], motion[idx],
                         labels[idx])
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    losses, stems = [], []
    for on in (dev, torch.device("cpu")):
        n_ = PlannerNet(NetParams())
        n_.load_state_dict(net.state_dict())
        n_.to(on).train()
        o_ = train.make_optimizer(n_, train.TrainConfig())
        losses.append(float(train.train_step(
            n_, o_, img[:4, ..., None].to(on), motion[:4].to(on),
            labels[:4].to(on))))
        stems.append(torch.cat([n_.img_backbone.bn_0.running_mean,
                                n_.img_backbone.bn_0.running_var]).cpu())
    rel_loss = abs(losses[0] - losses[1]) / abs(losses[1])
    rel_bn = float((stems[0] - stems[1]).abs().max() / stems[1].abs().max())
    say(f"(r) ResNet-18 trainer batch 64 at 640 x 480: "
        f"{np.mean(times[1:]):.2f} ms a step (3 steps after a warm-up "
        f"{times[0]:.1f} ms); first step card vs CPU at batch 4: loss "
        f"{losses[0]:.7g} vs {losses[1]:.7g} rel {rel_loss:.3g} (tol 1e-4),"
        f" stem BN running stats rel {rel_bn:.3g} (tol 1e-4); phase "
        f"{time.perf_counter() - t_r:.1f} s [{card}]")
    if rel_loss > 1e-4 or rel_bn > 1e-4:
        raise AssertionError("the ResNet-18 training step on the card "
                             "disagrees with the CPU")
    return dict(img=img, motion=motion, worlds=worlds256, seeded=seeded,
                seeded_net=net)



# the world sweep's paths: launches above 0 in every cell (B4 under 'neo')
SWEEP_PATH = ("lbfgs_scene_solve", "minco_banded_solve", "track_segment")
SWEEP_PLANNERS = ("expert", "neo")
SWEEP_ENVS = 1024
FOREST_SEED = 44              # worldio.forest_world_xml: 300 primitives
FOREST_TWIN_ENVS = 10         # the forest's card-vs-CPU loops


def world_phases(dev, card, pp, mp, sp, mapp, cam, nets, worlds, onnx,
                 launch_totals, tmp, small_loop, boundary_problems, accepted,
                 basin):
    """(s) the world sweep at full width: two random worlds written and
    parsed back, a forest world of 300 primitives; B1, B3 and B4 on the
    forest at the sweep's shapes (1024 envs at its capacity of 304 slots)
    against their plain versions, and card-vs-CPU loops on it at one
    solver iteration ('neo' and 'expert'); then sim/sweep.main over
    those 3 worlds x the 'expert' and 'neo' planners at B = 1024 and 3
    segments; (t) the .bt map plan (BASELINE config 1): occupancy_3d and
    fill_unknown_3d of a parsed world at MapParams() with 100 z cells, on
    the card against the CPU, the .bt and .pcd files, the z in [1.8, 10]
    slice, its exact ESDF (B9 exact) against the plain version, and
    expert.plan for 512 start/goal pairs on it; (u) the env-axis mesh on a
    world-size-1 NCCL group: one sharded segment of the flagship scene
    state at B = 1024 against the unsharded one, bit for bit, and
    mean_over_envs. Each phase prints its own wall time."""
    import torch
    import torch.distributed as dist
    from neoplanner_tpu_torch import _cuda
    from neoplanner_tpu_torch.config import (MapParams, PlannerParams,
                                             WorldParams)
    from neoplanner_tpu_torch.core import frames
    from neoplanner_tpu_torch.io import octomap
    from neoplanner_tpu_torch.mapping import esdf, scene
    from neoplanner_tpu_torch.ops import minco
    from neoplanner_tpu_torch.parallel import mesh as pmesh
    from neoplanner_tpu_torch.plan import costs, expert, parity, solve
    from neoplanner_tpu_torch.sense import raycast
    from neoplanner_tpu_torch.sim import env, sweep, track
    from neoplanner_tpu_torch.world import scenegen, voxelize, worldio

    fields = ("centers", "half_sizes", "active", "shape")
    net = nets[0]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def forest_kernels(fw):
        """B1, B3 and B4 on the forest at the shapes sim/sweep.main gives
        them (SWEEP_ENVS envs of the world at the sweep's common capacity,
        its PlannerParams and MapParams()) against their plain versions
        on the card, by the flagship checks' rules; then the card-vs-CPU
        loops on the forest at one solver iteration, as phase (o) holds the
        NEO loop. B5's inputs do not depend on the world: the flagship
        holds it at the same N."""
        t_f = time.perf_counter()
        cap = sweep.common_capacity(parsed + [fw])
        fw = sweep.with_capacity(fw, cap)
        fb = sweep.batch_of(fw, SWEEP_ENVS)
        fw_c = type(fw)(*(getattr(fw, f).cpu() for f in fields))
        mapp_s = MapParams()
        pp_s = PlannerParams(max_iters=24)   # the sweep's, 24 iterations
        sc_f = scene.build(fb, mapp_s)
        prims_f = scene.pack_prims(sc_f)
        n, g = SWEEP_ENVS, np.random.default_rng(48)

        # B1: 1024 problems along the corridor and into the tree rows
        start = torch.from_numpy(np.stack([g.uniform(0.0, 30.0, n),
                                           g.uniform(-1.0, 1.0, n)], -1)
                                 ).float()
        head, tail, q0, ts0 = boundary_problems(n, start, gen=g)
        x0 = costs.pack(q0, minco.T_to_tau(ts0, pp_s.t_min, pp_s.t_max),
                        pp_s).contiguous()
        env_of = torch.arange(n, device=dev, dtype=torch.int32)
        skip = torch.zeros(n, dtype=torch.int32, device=dev)
        sol = (torch.empty_like(x0), torch.empty(n, device=dev),
               torch.empty(n, dtype=torch.int32, device=dev))
        pp1 = dataclasses.replace(pp_s, max_iters=1)
        solve.launch_solver(x0, head, tail, prims_f, env_of, skip, sol, pp1)
        got1 = tuple(t.clone() for t in sol)
        want1 = solve._solve_plain(x0, head, tail, sc_f, env_of.long(), pp1)
        worst1, n_off = parity.one_iteration(x0, head, tail, sc_f,
                                             env_of.long(), pp1, got1, want1)
        _, b1_ms = timed(lambda: solve.launch_solver(
            x0, head, tail, prims_f, env_of, skip, sol, pp_s))
        (px, pf, _), b1_plain_ms = timed(lambda: solve._solve_plain(
            x0, head, tail, sc_f, env_of.long(), pp_s))
        n_c = 32                 # the control's problems, on the host
        sc_c = scene.SceneMap(*(getattr(sc_f, f).cpu() for f in
                                ("centers", "half", "is_cyl", "active")))

        def plain_cpu(p):
            return solve._solve_plain(x0[:n_c].cpu(), head[:n_c].cpu(),
                                      tail[:n_c].cpu(), sc_c,
                                      torch.arange(n_c), p)[1]
        say(f"(s) lbfgs_scene_solve on the forest, {n} problems at {cap} "
            f"slots ({int(sc_f.active[0].sum())} live in the slice): one "
            f"iteration max rel f {worst1:.3g} (tol 1e-3), {n_off} off (by "
            f"parity.one_iteration's rule); 24 iterations {b1_ms:.3f} ms, "
            f"plain {b1_plain_ms:.1f} ms [{card}]")
        basin("lbfgs_scene_solve forest", accepted(sol[0], head, tail, sc_f,
                                                   pp_s),
              accepted(px, head, tail, sc_f, pp_s), sol[1], pf, sol[2],
              rel(want1[1][:n_c].cpu(), plain_cpu(pp1)),
              rel(pf[:n_c].cpu(), plain_cpu(pp_s)), n_c)

        # B3: one segment of commands along the corridor, swaying into the
        # tree rows (the collision metric live)
        t = torch.arange(60, device=dev) / 60.0

        def col(lo, hi):
            return torch.from_numpy(g.uniform(lo, hi, n)).float().to(dev)[
                :, None]
        px0, py0, v = col(2.0, 28.0), col(-1.0, 1.0), col(0.5, 1.5)
        amp, w = col(0.2, 2.5), col(1.5, 3.0)
        cmds = torch.stack([
            torch.stack([px0 + v * t, py0 + amp * torch.sin(w * t)], -1),
            torch.stack([v.expand(n, 60), amp * w * torch.cos(w * t)], -1),
            torch.stack([torch.zeros(n, 60, device=dev),
                         -amp * w * w * torch.sin(w * t)], -1)],
            dim=2).contiguous()
        goal = sweep.clear_goal(fw, mapp_s, pp_s.safe_dis + 0.3)
        st = env.reset(fb, pp_s, mp, mapp_s, _cuda.make_generator(49, dev),
                       goal=goal.expand(n, 2).clone(),
                       start_pos=cmds[:, 0, 0].contiguous())
        st_packed = track.pack_state(st)
        tout = torch.empty((n, 18), device=dev)
        trace = torch.empty((n, 60, 5, 3), device=dev)
        _, b3_ms = timed(lambda: track.launch_tracker(
            cmds, st_packed, prims_f, tout, trace, pp_s, mp, sp))
        plain3, b3_plain_ms = timed(
            lambda: track._track_plain(st, cmds, pp_s, mp, sp))

        def track_line(out):
            """The plain tracker's outputs as the kernel's (n, 18) line,
            and the name of each column."""
            wd, wreach, wsteps, wmet, wmpos, _ = out
            pieces = [("pos", wd.pos), ("vel", wd.vel),
                      ("yaw", wd.yaw[:, None]), ("quat", wd.quat),
                      ("metric_pos", wmpos), ("metrics", wmet),
                      ("reached", wreach[:, None].float()),
                      ("steps", wsteps[:, None].float())]
            return (torch.cat([v for _, v in pieces], 1),
                    [k for k, v in pieces for _ in range(v.shape[1])])

        def worst(got, want_, names):
            """(max abs, rel) over the line and the trace, and where."""
            d = (got[0] - want_[0].to(got[0].device)).abs().amax(0)
            e = max(err_line(got[0], want_[0]), err_line(got[1], want_[1]))
            where = names[int(d.argmax())] if float(d.max()) >= e[0] \
                else "trace"
            return e, where
        want, names = track_line(plain3)
        err3, at3 = worst((tout, trace), (want, plain3[5]), names)
        hit = int((plain3[3][:, 2] > 0).sum())
        # the control: the plain tracker on the CPU, the first n_t envs
        n_t = 128
        st_c = env.reset(sweep.batch_of(fw_c, n_t), pp_s, mp, mapp_s,
                         _cuda.make_generator(49, "cpu"),
                         goal=goal.cpu().expand(n_t, 2).clone(),
                         start_pos=cmds[:n_t, 0, 0].cpu().contiguous())
        same_in = torch.equal(track.pack_state(st_c), st_packed[:n_t].cpu())
        plain_c = track._track_plain(st_c, cmds[:n_t].cpu(), pp_s, mp, sp)
        ctrl, at_c = worst((want[:n_t], plain3[5][:n_t]),
                           (track_line(plain_c)[0], plain_c[5]), names)
        say(f"(s) track_segment on the forest, {n} envs at {cap} slots: max "
            f"abs {err3[0]:.3g} in {at3} (tol 1e-3), rel {err3[1]:.3g}; "
            f"{hit} envs with a collision metric; {b3_ms:.3f} ms, plain "
            f"{b3_plain_ms:.1f} ms; the plain version on the card against "
            f"the CPU on {n_t} envs (packed inputs equal {same_in}): max "
            f"abs {ctrl[0]:.3g} in {at_c} [{card}]")
        if err3[0] > 1e-3 or hit == 0:
            raise AssertionError("track_segment on the forest disagrees "
                                 "with its plain version")

        # B4: a frame from each env, looking into the trees
        pos = torch.cat([col(2.0, 28.0), col(-1.0, 1.0), col(1.5, 2.5)], 1)
        quat = frames.quat_from_accel_yaw(
            torch.from_numpy(g.normal(scale=2.0, size=(n, 3))).float()
            .to(dev), col(-1.2, 1.2)[:, 0]).contiguous()
        prims_r = raycast.pack_prims(fb)
        depth = torch.empty((n, cam.height, cam.width), device=dev)
        raycast.launch_render(pos, quat, prims_r, depth, cam)
        want_d, b4_plain_ms = timed(lambda: raycast.render_depth(
            fb, pos, quat, cam))
        diff = (depth - want_d).abs()
        frac_off = float((diff > 1e-3).float().mean())
        near = float((want_d < cam.max_range).float().mean())
        b4_ms = median_ms(torch, lambda: raycast.launch_render(
            pos, quat, prims_r, depth, cam), 10)
        kept = raycast.tile_cull(fb, pos, quat, cam)
        b_ms, b_by = bound(*render_work(kept, cam.height, cam.width,
                                        prims_r.shape[1],
                                        (raycast.TILE_H, raycast.TILE_W)))
        say(f"(s) render_depth on the forest, {n} frames at {cap} slots "
            f"({near:.3f} of the pixels hit within range; "
            f"{float(kept.sum(-1).float().mean()):.2f} primitives a tile "
            f"survive the cull): {frac_off:.2e} of the pixels off by > 1e-3 "
            f"m (tol 1e-3), max abs {float(diff.max()):.3g}; {b4_ms:.3f} ms, "
            f"plain {b4_plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}) "
            f"[{card}]")
        if frac_off > 1e-3:
            raise AssertionError("render_depth on the forest disagrees with "
                                 "its plain version")

        # the loops: card vs CPU from the same forest, goals and draws
        for planner in SWEEP_PLANNERS:
            small_loop(f"forest {planner} (1 iteration)", FOREST_TWIN_ENVS,
                       50, lambda g_, k: sweep.batch_of(fw_c, k), mapp_s,
                       {}, pp_=pp1, nets=nets, planner=planner)
        say(f"(s) forest kernel checks {time.perf_counter() - t_f:.1f} s")

    # ---- (s) the world sweep: 2 random worlds and a forest, 'expert' and
    # 'neo' at B = 1024, 3 segments
    t_s = time.perf_counter()
    wp = WorldParams()
    paths, parsed = [], []
    for i in range(2):
        world = scenegen.generate(_cuda.make_generator(40 + i, dev), wp)
        path = os.path.join(tmp, f"rand_{i}.world")
        worldio.write_world(world, path)
        back = worldio.parse_world(path, max_boxes=wp.max_boxes,
                                    device=dev)
        a = world.active
        n = int(a.sum())
        err = max(float((back.centers[:n] - world.centers[a]).abs().max()),
                  float((back.half_sizes[:n] - world.half_sizes[a]).abs()
                        .max()))
        same = bool(torch.equal(back.shape[:n], world.shape[a])) and bool(
            back.active[:n].all()) and not bool(back.active[n:].any())
        say(f"(s) {os.path.basename(path)}: {n} primitives written, parsed "
            f"back max diff {err:.3g} (tol 1e-4), shapes and flags equal "
            f"{same}")
        if err > 1e-4 or not same:
            raise AssertionError("a written world parsed back differently")
        paths.append(path)
        parsed.append(back)
    forest = os.path.join(tmp, "forest.world")
    with open(forest, "w") as f:
        f.write(worldio.forest_world_xml(FOREST_SEED))
    fw = worldio.parse_world(forest, max_boxes=None, device=dev)
    say(f"(s) forest.world: 150 pine-tree meshes parsed into "
        f"{int(fw.active.sum())} primitives (capacity "
        f"{fw.active.shape[0]}; 300 expected)")
    if int(fw.active.sum()) != 300:
        raise AssertionError("the forest world parsed into another count")
    paths.append(forest)
    forest_kernels(fw)
    _cuda.reset_launches()
    res = sweep.main(["--worlds", *paths, "--planners", *SWEEP_PLANNERS,
                      "--repeats", str(SWEEP_ENVS), "--segments", "3",
                      "--net", onnx])
    for c in res["cells"]:
        la = c["launches"]
        want = SWEEP_PATH + (("render_depth",) if c["planner"] == "neo"
                             else ())
        say(f"(s) sweep {c['world']} ({c['prims']} primitives) "
            f"{c['planner']} B={c['envs']}: {c['ms_segment']:.1f} "
            f"ms/segment, {c['steps_per_s']:.0f} steps/s, missions ok "
            f"{c['reached']}/{c['envs']}, plans {c['plans']}; launches "
            + ", ".join(f"{k} {la[k]}" for k in want)
            + f" [{card}]")
        for k in want:
            if la[k] <= 0:
                raise AssertionError(f"the sweep's {c['world']} "
                                     f"{c['planner']} cell never launched "
                                     f"{k}")
            launch_totals[k] += la[k]
    say(f"(s) phase {time.perf_counter() - t_s:.1f} s")

    # ---- (t) the .bt map plan (BASELINE config 1) on the first parsed
    # world: MapParams(), 100 z cells from z = 0
    t_t = time.perf_counter()
    mp3 = MapParams()
    nz = 100
    world = parsed[0]
    world_c = type(world)(*(getattr(world, f).cpu() for f in fields))
    vol, occ_ms = timed(lambda: voxelize.occupancy_3d(world, mp3, nz))
    filled, fill_ms = timed(lambda: voxelize.fill_unknown_3d(vol))
    _, steps = voxelize.flood_free(vol)      # the fill's step count
    vol_c = voxelize.occupancy_3d(world_c, mp3, nz)
    _, steps_c = voxelize.flood_free(vol_c)
    filled_c = voxelize.fill_unknown_3d(vol_c)
    d_occ = int((vol.cpu() != vol_c).sum())
    d_fill = int((filled.cpu() != filled_c).sum())
    say(f"(t) occupancy_3d {nz} x {mp3.height} x {mp3.width} = "
        f"{vol.numel()} voxels, {int(vol.sum())} occupied: {occ_ms:.2f} ms; "
        f"fill_unknown_3d {steps} steps (CPU {steps_c}), {fill_ms:.2f} ms, "
        f"{int(filled.sum())} occupied; differing from the CPU: occupancy "
        f"{d_occ}, fill {d_fill} (0 expected) [{card}]")
    if d_occ or d_fill or steps != steps_c:
        raise AssertionError("the 3-D voxelization on the card differs "
                             "from the CPU")
    origin3 = (mp3.origin_x, mp3.origin_y, 0.0)
    bt = os.path.join(tmp, "world.bt")
    grid = filled_c.numpy()
    octomap.write_bt(bt, grid, mp3.resolution, origin3)
    back, res_bt = octomap.bt_to_grid(bt, origin3, grid.shape)
    vox, _ = octomap.bt_to_voxels(bt)
    pcd_ok = []
    for ascii_mode in (True, False):
        pcd = os.path.join(tmp, f"world_{ascii_mode}.pcd")
        octomap.write_pcd(pcd, vox, ascii_mode=ascii_mode)
        pts = octomap.read_pcd(pcd)
        pcd_ok.append(pts.shape == vox.shape and float(
            np.abs(pts - vox).max()) <= (1e-5 if ascii_mode else 0.0))
    say(f"(t) world.bt {os.path.getsize(bt)} bytes: bt_to_grid equal "
        f"{bool(np.array_equal(back, grid))}, {len(vox)} voxels; .pcd "
        f"ascii / binary roundtrips {pcd_ok} (1e-5 / exact)")
    if not np.array_equal(back, grid) or not all(pcd_ok) \
            or len(vox) != int(grid.sum()):
        raise AssertionError("the .bt or .pcd files do not roundtrip")
    sel = (vox[:, 2] >= mp3.z_min) & (vox[:, 2] <= mp3.z_max)
    xy = vox[sel][:, :2]
    occ = np.zeros((mp3.height, mp3.width), np.float32)
    cols = ((xy[:, 0] - mp3.origin_x) / res_bt).astype(int)
    rows = ((xy[:, 1] - mp3.origin_y) / res_bt).astype(int)
    ok = (rows >= 0) & (rows < mp3.height) & (cols >= 0) & (cols < mp3.width)
    occ[rows[ok], cols[ok]] = 1.0
    occ2 = voxelize.occupancy_2d(type(world_c)(*(
        getattr(world_c, f)[None] for f in fields)), mp3)[0].numpy()
    say(f"(t) the z in [{mp3.z_min}, {mp3.z_max}] slice: {int(occ.sum())} "
        f"cells, {int((occ != occ2).sum())} differ from occupancy_2d's "
        f"{int(occ2.sum())} (voxel centres against the slice's overlap)")
    occ_d = torch.from_numpy(occ).to(dev)[None]
    org2 = (mp3.origin_x, mp3.origin_y)
    _cuda.reset_launches()
    emap, esdf_ms = timed(lambda: esdf.build(occ_d, org2, res_bt))
    emap_c = esdf.build(occ_d.cpu(), org2, res_bt)
    n_esdf = sum(int((getattr(emap, f).cpu() != getattr(emap_c, f)).sum())
                 for f in ("esdf", "grad_x", "grad_y"))
    say(f"(t) esdf.build of the slice (B9 exact, launches "
        f"{_cuda.launches['edt_exact']}): {esdf_ms:.2f} ms, {n_esdf} cells "
        f"differ from the plain version (0 expected); max "
        f"{float(emap.esdf.max()):.3g} m")
    if n_esdf or _cuda.launches["edt_exact"] != 1:
        raise AssertionError("the .bt map's ESDF differs from the plain "
                             "version")
    launch_totals["edt_exact"] += 1
    n_plan = 512
    rng = np.random.default_rng(45)
    field = emap_c.esdf[0].numpy()

    def clear(p):
        c = np.clip(((p[:, 0] - mp3.origin_x) / res_bt).astype(int), 0,
                    mp3.width - 1)
        r = np.clip(((p[:, 1] - mp3.origin_y) / res_bt).astype(int), 0,
                    mp3.height - 1)
        return field[r, c] > pp.safe_dis + 0.3
    start = rng.uniform([0.0, -5.0], [24.0, 5.0], (8 * n_plan, 2))
    goal = start + [5.0, 0.0] + rng.normal(size=start.shape)
    keep = np.nonzero(clear(start) & clear(goal))[0][:n_plan]
    head = torch.zeros((n_plan, 3, 2), device=dev)
    tail = torch.zeros((n_plan, 3, 2), device=dev)
    head[:, 0] = torch.from_numpy(start[keep]).float().to(dev)
    tail[:, 0] = torch.from_numpy(goal[keep]).float().to(dev)
    emap_b = emap.index(torch.zeros(n_plan, dtype=torch.long, device=dev))
    noise = torch.from_numpy(rng.normal(size=(
        n_plan, pp.retry_num, pp.dims, pp.num_wpts))).float().to(dev)
    _cuda.reset_launches()
    traj, plan_ms = timed(lambda: expert.plan(emap_b, head, tail, noise, pp))
    la = dict(_cuda.launches)
    say(f"(t) expert.plan on the .bt map, {n_plan} start/goal pairs: ok "
        f"{int(traj.ok.sum())}/{n_plan}, iters mean "
        f"{float(traj.iters.float().mean()):.1f}, {plan_ms:.1f} ms; "
        f"launches lbfgs_grid_solve {la['lbfgs_grid_solve']}, "
        f"minco_banded_solve {la['minco_banded_solve']}; phase "
        f"{time.perf_counter() - t_t:.1f} s [{card}]")
    if min(la["lbfgs_grid_solve"], la["minco_banded_solve"]) <= 0 \
            or int(traj.ok.sum()) == 0 or not bool(
                torch.isfinite(traj.coeffs).all()):
        raise AssertionError("the .bt map plan failed")
    for k in ("lbfgs_grid_solve", "minco_banded_solve"):
        launch_totals[k] += la[k]

    # ---- (u) the env-axis mesh on a world-size-1 NCCL group
    t_u = time.perf_counter()
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        mesh = pmesh.make_mesh()
        m3 = pmesh.make_multislice_mesh(1, dcn=1, mdl=1)
        # two segments first, so that the metrics that mean_over_envs
        # reduces are live
        state = env.reset(worlds, pp, mp, mapp, _cuda.make_generator(46, dev))
        for _ in range(2):
            state, _ = env.step_segment(state, pp, mp, sp, cam, net)
        draws = env.draw(_cuda.make_generator(47, dev),
                         worlds.active.shape[0], pp)
        shard = pmesh.shard_batch(state, mesh)
        shard3 = pmesh.shard_batch_multislice(state, m3)
        same3 = all(torch.equal(getattr(shard3.drone, f),
                                getattr(shard.drone, f))
                    for f in ("pos", "vel", "quat", "yaw"))

        def segment(s, d):
            return env.step_segment(s, pp, mp, sp, cam, net, draws=d)
        _cuda.reset_launches()
        step = pmesh.sharded_vmap_step(segment, mesh)
        (out_s, info_s), seg_ms = timed(lambda: step(
            shard, pmesh.shard_batch(draws, mesh)))
        la = dict(_cuda.launches)
        out_u, info_u = segment(state, draws)
        pairs = [(getattr(out_s.drone, f), getattr(out_u.drone, f))
                 for f in ("pos", "vel", "quat", "yaw")] + [
            (out_s.buffer, out_u.buffer), (out_s.metrics, out_u.metrics),
            (out_s.goal, out_u.goal), (info_s.ok, info_u.ok),
            (info_s.planned, info_u.planned), (info_s.ts, info_u.ts),
            (info_s.int_wpts, info_u.int_wpts)]
        n_diff = sum(int((a != b).sum()) for a, b in pairs)
        wm = pmesh.mean_over_envs(env.weighted_metric(out_s), mesh)
        wm_u = env.weighted_metric(out_u).double().mean()
        wm_rel = abs(float(wm) - float(wm_u)) / max(abs(float(wm_u)), 1.0)
        rep = pmesh.replicate(draws, mesh)
        rep_ok = torch.equal(rep.goal_u, draws.goal_u)
        say(f"(u) mesh {tuple(mesh.shape)} {mesh.mesh_dim_names} and "
            f"multislice {tuple(m3.shape)} {m3.mesh_dim_names} over "
            f"{dist.get_backend()} (world size 1): shards equal {same3}; "
            f"one sharded segment "
            f"B={worlds.active.shape[0]} ({seg_ms:.1f} ms; launches "
            + ", ".join(f"{k} {la[k]}" for k in SCENE_PATH)
            + f"): {n_diff} elements differ from the unsharded segment (0 "
            f"expected, bit for bit); mean_over_envs(weighted_metric) "
            f"{float(wm):.7g} vs {float(wm_u):.7g} rel {wm_rel:.3g} (tol "
            f"1e-6); replicate equal {rep_ok} [{card}]")
        if n_diff or not same3 or wm_rel > 1e-6 or not rep_ok:
            raise AssertionError("the sharded segment differs from the "
                                 "unsharded one")
        for k in SCENE_PATH:
            if la[k] <= 0:
                raise AssertionError(f"the sharded segment never launched "
                                     f"{k}")
            launch_totals[k] += la[k]
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()
    say(f"(u) phase {time.perf_counter() - t_u:.1f} s")


RESNET640_CPU_FRAMES = 256   # the frames the CPU forward pass checks
RESNET640_CPU_CHUNK = 16     # frames per CPU forward call


def checkpoint_phases(dev, card, pp, mp, mapp, wp, paper, run_path,
                      small_loop, twin_loops):
    """(v) the JAX package's orbax checkpoints restored without JAX, and
    the paper's NEO loop at 640 x 480 with the trained ResNet-18. Every
    line it prints ends with the card's name and power limit."""
    t_v = time.perf_counter()
    _SAY_TAG[0] = f" [{card}]"
    try:
        _checkpoint_phases(dev, pp, mp, mapp, wp, paper, run_path,
                           small_loop, twin_loops)
        say(f"(v) phase {time.perf_counter() - t_v:.1f} s")
    finally:
        _SAY_TAG[0] = ""


def _checkpoint_phases(dev, pp, mp, mapp, wp, paper, run_path, small_loop,
                       twin_loops):
    import torch
    from neoplanner_tpu_torch import _cuda
    from neoplanner_tpu_torch.config import CameraParams, NetParams
    from neoplanner_tpu_torch.io import orbax, zstd
    from neoplanner_tpu_torch.learn import train, weights
    from neoplanner_tpu_torch.mapping import scene
    from neoplanner_tpu_torch.models.planner_net import PlannerNet
    from neoplanner_tpu_torch.plan import costs, expert
    from neoplanner_tpu_torch.sim import env
    from neoplanner_tpu_torch.world import scenegen

    cam640 = CameraParams(width=640, height=480)
    # ---- (a) the smallconv checkpoint against its ONNX export
    t0 = time.perf_counter()
    zstd.build()
    build_s = time.perf_counter() - t0
    small = os.path.join(REPO, "artifacts", "planner_net_smallconv")
    t0 = time.perf_counter()
    sd, _ = train.load_checkpoint(small)
    small_s = time.perf_counter() - t0
    ref = weights.from_onnx(small + ".onnx")
    n_eq = sum(k in sd and sd[k].dtype == ref[k].dtype
               and torch.equal(sd[k], ref[k]) for k in ref)
    say(f"(v) smallconv orbax checkpoint, restored without JAX in "
        f"{small_s * 1e3:.1f} ms: {n_eq} of {len(ref)} tensors bit-equal to "
        f"weights.from_onnx of its .onnx ({len(sd)} restored; all equal "
        f"expected); zstd decoder built by g++ in {build_s:.2f} s")
    if n_eq != len(ref) or len(sd) != len(ref):
        raise AssertionError("the smallconv checkpoint differs from its "
                             "ONNX export")

    # ---- (b) the trained ResNet-18's checkpoint
    path = os.path.join(REPO, RESNET640)
    t0 = time.perf_counter()
    sd, np_cfg = train.load_checkpoint(path)
    restore_s = time.perf_counter() - t0
    stats = {}
    t0 = time.perf_counter()
    orbax.restore(path, stats)
    again_s = time.perf_counter() - t0
    digest = weights.digest(sd)
    n_values = sum(t.numel() for t in sd.values())
    say(f"(v) resnet640 orbax checkpoint: train.load_checkpoint "
        f"{restore_s * 1e3:.1f} ms (the run's first read of its files; "
        f"io/orbax.restore again {again_s * 1e3:.1f} ms, warm), "
        f"{stats['arrays']} arrays, "
        f"{len(sd)} tensors, {n_values:,} values, {stats['bytes_read']:,} "
        f"bytes of zstd frames decoded to {stats['bytes_decoded']:,} "
        f"({stats['bytes_decoded'] / again_s / 1e6:.0f} MB/s whole); "
        f"NetParams() {np_cfg == NetParams()}; state_dict SHA-256 {digest} "
        f"(JAX's restore: {RESNET640_SHA256})")
    if digest != RESNET640_SHA256 or np_cfg != NetParams():
        raise AssertionError("the trained ResNet-18 checkpoint restores "
                             "to other weights than JAX's")

    # ---- (c) its forward pass at batch 256 on phase (n)'s frames
    img, motion = paper["img"], paper["motion"]
    net = PlannerNet(np_cfg)
    net.load_state_dict(sd)
    net.to(dev).eval()
    net_cpu = PlannerNet(np_cfg)
    net_cpu.load_state_dict(sd)
    net_cpu.eval()
    with torch.no_grad():
        fwd_ms = median_ms(torch, lambda: net(img[..., None], motion), 5)
        out_g = net(img[..., None], motion).cpu()
        t0 = time.perf_counter()
        n_c = RESNET640_CPU_FRAMES
        out_c = torch.cat([net_cpu(img[i:i + RESNET640_CPU_CHUNK, ..., None]
                                   .cpu(), motion[i:i + RESNET640_CPU_CHUNK]
                                   .cpu())
                           for i in range(0, n_c, RESNET640_CPU_CHUNK)])
        cpu_s = time.perf_counter() - t0
    err = float((out_g[:n_c] - out_c).abs().max() / out_c.abs().max())
    say(f"(v) trained PlannerNet forward batch {img.shape[0]}: {fwd_ms:.2f} "
        f"ms; card vs CPU on {n_c} frames (CPU {cpu_s:.1f} s in chunks of "
        f"{RESNET640_CPU_CHUNK}): max diff {err:.3g} of the largest output "
        f"(tol 1e-4), outputs |max| {float(out_c.abs().max()):.3g}")
    if err > 1e-4:
        raise AssertionError("the trained ResNet-18 on the card disagrees "
                             "with the CPU")

    # ---- (d) the paper's NEO loop with the trained net: phase (o)'s
    # periodic loop, then both nets with replan_mode="online" (every env
    # replans every segment until its goal: plans in the timed segments)
    worlds256 = paper["worlds"]

    def loop(name, net_, **kw):
        st = {}
        run_path(name, SCENE_PATH, img.shape[0], lambda: env.reset(
            worlds256, pp, mp, mapp, _cuda.make_generator(21)), n_seg=2,
            per_segment=NEO640_PER_SEGMENT, net_=net_, cam_=cam640,
            stats=st, **kw)
        return st

    def line(mode, a, b):
        say(f"(v) paper NEO 640x480 B={img.shape[0]} {mode}, trained vs "
            f"seeded (same worlds, reset seed and draws' seed): "
            f"{a['ms_segment']:.1f} vs {b['ms_segment']:.1f} ms/segment; "
            f"replans ok {a['ok']}/{a['planned']} vs {b['ok']}/"
            f"{b['planned']} (warm-up and 2 timed segments; timed "
            f"{a['timed_planned']} vs {b['timed_planned']}); L-BFGS "
            f"iterations a plan {a['iters']:.2f} vs {b['iters']:.2f}; "
            f"acceptance {a['ok'] / max(a['planned'], 1):.3f} vs "
            f"{b['ok'] / max(b['planned'], 1):.3f}; accepted plans' "
            f"duration {a['duration']:.3f} vs {b['duration']:.3f} s")
    trained = loop("paper NEO 640x480 trained", net)
    if trained["planned"] <= 0:
        raise AssertionError("the trained NEO loop planned no replan")
    line("periodic (phase (o)'s loop)", trained, paper["seeded"])
    online = [loop(f"paper NEO 640x480 {k} online", n_, replan_mode="online")
              for k, n_ in (("trained", net), ("seeded", paper["seeded_net"]))]
    line("online", *online)

    # ---- (e) its B = 4 card-vs-CPU twin: one iteration held, 24 printed
    small_loop("paper NEO 640x480 trained (1 iteration)", 4, 22,
               lambda g, n: scenegen.generate_batch(g, n, wp), mapp, {},
               pp_=dataclasses.replace(pp, max_iters=1), cam_=cam640,
               nets=(net, net_cpu))
    first = {}
    twin_loops(4, 22, lambda g, n: scenegen.generate_batch(g, n, wp), mapp,
               {}, pp, {}, cam640, (net, net_cpu), first)
    i_c, i_g = first["cpu"], first["card"]
    pmap = scene.build(first["worlds"], mapp)

    def plan_f(info):
        head = expert.pad_boundary_state(info.plan_init.cpu(), pp)
        tail = expert.pad_boundary_state(info.target.cpu(), pp)
        c, _ = costs.traj_costs(head, tail, info.int_wpts.cpu(),
                                info.ts.cpu(), pmap, pp)
        return c @ costs.weights(pp)
    both = i_c.ok & i_g.ok.cpu()
    f_c, f_g = plan_f(i_c), plan_f(i_g)
    gap = ((f_g - f_c).abs() / f_c.abs().clamp_min(1e-12))[both]
    flags = float((i_g.ok.cpu() == i_c.ok).float().mean())
    say(f"(v) trained NEO 640x480 B=4 twin at 24 iterations (information, "
        f"not held): plan flags agree {flags:.3f}, accepted both "
        f"{int(both.sum())}, median relative objective gap "
        f"{float(gap.median()) if len(gap) else float('nan'):.3g}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", default=None, help="another checkout whose "
                    "B3, B4, B5, B8, B10, B9, objective and solver kernels "
                    "phases 2, 6, 9, 12, 13, 14, 18 and 25 compare with "
                    "this one's")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from neoplanner_tpu_torch import _cuda
    except ImportError as exc:
        print(f"chip_smoke: the port is missing ({exc})", file=sys.stderr)
        return 2
    from neoplanner_tpu_torch.config import (CameraParams, MapParams,
                                             MissionParams, NetParams,
                                             PlannerParams, SimParams,
                                             WorldParams)
    from neoplanner_tpu_torch.core import frames
    from neoplanner_tpu_torch.mapping import esdf, fusion, occupancy, scene
    from neoplanner_tpu_torch.models import planner_net
    from neoplanner_tpu_torch.ops import edt, minco
    from neoplanner_tpu_torch.plan import (costs, expert, objective, parity,
                                           solve)
    from neoplanner_tpu_torch.sense import raycast
    from neoplanner_tpu_torch.sim import env, track
    from neoplanner_tpu_torch.utils.profiling import StageTimer
    from neoplanner_tpu_torch.world import scenegen, voxelize

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    say(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda})")
    t_start = time.perf_counter()
    wall = _cuda.prebuild(PIECE_BUILDS)
    _cuda.load()
    say(f"build: {len(_cuda.build_seconds)} libraries built side by side, "
        f"one nvcc each, in {wall:.1f} s wall ("
        + ", ".join(f"{k.split('_')[1]} {v:.1f} s" for k, v in
                    sorted(_cuda.build_seconds.items()))
        + "; none: already built), load "
        f"{time.perf_counter() - t_start:.1f} s")
    other = other3 = None
    if args.against:
        other, other3, other_s = load_other(args.against)
        say(f"against {args.against}: nvcc {other_s:.1f} s")

    # the flagship configuration (bench.py:101-142)
    pp = PlannerParams(max_iters=24, samples_per_piece=24, retry_num=2,
                       extra_lateral_scales=(), max_ls=4)
    mp, sp = MissionParams(), SimParams()
    mapp = MapParams(width=256, height=192, origin_x=-4.0, origin_y=-9.6)
    # the vision configuration (examples/profile_vision.py:33-71)
    mapp_v = dataclasses.replace(mapp, edt_truncation=2.0, fusion="2d_dense")
    vision = dict(sensing="depth", plan_map="grid")
    wp = WorldParams(num_boxes=10)
    npc = NetParams(img_width=160, img_height=120, motion_input_size=24,
                    output_size=9, img_feature_size=24,
                    motion_feature_size=24, backbone="smallconv",
                    fusion_arch="mlp")
    cam = CameraParams(width=npc.img_width, height=npc.img_height)
    onnx = os.path.join(REPO, "artifacts", "planner_net_smallconv.onnx")
    rng = np.random.default_rng(0)
    # the per-evaluation checks draw from their own generator, so that every
    # other check reads the inputs it read before they were added
    rng_eval = np.random.default_rng(9)
    rng_retry = np.random.default_rng(10)   # the retry launches' seeds
    rng_b5 = np.random.default_rng(11)      # B5's transposed right sides
    worlds = scenegen.generate_batch(_cuda.make_generator(0), B, wp)
    sc = scene.build(worlds, mapp)
    n_active = sc.active.sum(1).cpu().numpy()
    record = {}
    launch_totals = {k: 0 for k in KERNELS}   # over the paths' runs

    def report(name, err, tol, ms, plain_ms, flops, nbytes, library_ms=None,
               on="abs"):
        """Record a kernel; err = (max abs, a relative measure), held to
        tol on the first (on="abs") or the second (on="rel", or "ratio":
        the largest error over its bound)."""
        b_ms, b_by = bound(flops, nbytes)
        record[name] = dict(name=name, route="cuda", **KERNELS[name],
                            launches=0, max_abs_err=err[0], ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=library_ms)
        ok = err[0 if on == "abs" else 1] <= tol
        measure = "ratio to the bounds" if on == "ratio" else "rel"
        say(f"{name}: max abs {err[0]:.3g}, {measure} {err[1]:.3g}; tol "
            f"{tol:g} ({on}) {'ok' if ok else 'MISS'}; {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}; operations "
            f"{flops / PEAK_F32 * 1e3:.4f}, bytes "
            f"{nbytes / PEAK_BYTES * 1e3:.4f})")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")

    def boundary_problems(n, start=None, gen=None):
        """n planning problems from start (n, 2), by default standard normal
        around the origin, to ~5 m ahead: (head, tail, q0, ts0) on the
        card, drawn from gen (by default rng)."""
        g = rng if gen is None else gen
        head = torch.zeros((n, 3, 2))
        tail = torch.zeros((n, 3, 2))
        head[:, 0] = (torch.from_numpy(g.normal(size=(n, 2))).float()
                      if start is None else start.cpu())
        head[:, 1] = torch.from_numpy(g.normal(scale=0.5,
                                               size=(n, 2))).float()
        tail[:, 0] = head[:, 0] + torch.tensor([5.0, 0.0]) + \
            torch.from_numpy(g.normal(size=(n, 2))).float()
        tail[:, 1] = torch.from_numpy(g.normal(scale=0.5,
                                               size=(n, 2))).float()
        head, tail = head.to(dev), tail.to(dev)
        q0 = expert.straight_line_wpts(head[:, 0], tail[:, 0], pp) \
            + torch.from_numpy(g.normal(scale=0.4, size=(n, 2, 2))).float(
            ).to(dev)
        ts0 = torch.from_numpy(g.uniform(1.0, 4.0, (n, 3))).float().to(dev)
        return head, tail, q0, ts0

    def accepted(x, head, tail, pmap, cost_pp):
        q, tau = costs.unpack(x, cost_pp)
        cv, _ = costs.traj_costs(head, tail, q, minco.tau_to_T(
            tau, pp.t_min, pp.t_max), pmap, cost_pp)
        return cv[:, 3] * pp.w_collision <= pp.collision_cost_tol

    def window_cells_read(window, xs, head, tail, pp_=None):
        """Distinct window cells that the bilinear taps of one solve per
        problem read at the iterates xs (each (P, nv); problem p on window
        p), summed over problems: the least a solve that passes through
        those iterates must load. Samples outside the map read FAR, not the
        window."""
        pp_ = pp_ or pp
        P, Hw, Ww = window.win.shape
        taps = []
        for x in xs:
            q, tau = costs.unpack(x, pp_)
            ts = minco.tau_to_T(tau, pp.t_min, pp.t_max)
            c = minco.solve_coeffs(head, tail, q, ts).reshape(
                P, ts.shape[1], 6, -1)
            t, _ = costs.piece_samples(ts, pp)
            pos = torch.einsum("nmkj,nmjd->nmkd", minco.beta(t, 0),
                               c)[..., :2].reshape(P, -1, 2)
            o = window.worg[:, None]
            u = torch.floor(torch.clamp((pos[..., 1] - o[..., 1]) / o[..., 2]
                                        - 0.5, 0.0, Hw - 1.001)).long()
            v = torch.floor(torch.clamp((pos[..., 0] - o[..., 0]) / o[..., 2]
                                        - 0.5, 0.0, Ww - 1.001)).long()
            in_map = ((pos[..., 0] >= o[..., 3]) & (pos[..., 1] >= o[..., 4])
                      & (pos[..., 0] < o[..., 5]) & (pos[..., 1] < o[..., 6]))
            for du in (0, 1):
                for dv in (0, 1):
                    taps.append(torch.where(in_map, (u + du) * Ww + v + dv,
                                            -1))
        cells = torch.sort(torch.cat(taps, 1), 1).values
        new = torch.ones_like(cells, dtype=torch.bool)
        new[:, 1:] = cells[:, 1:] != cells[:, :-1]
        return int((new & (cells >= 0)).sum())

    def basin(name, ok_k, ok_p, f_k, f_p, iters, f1_ctrl, f_ctrl, n_c,
              med_tol=1e-4, mean_tol=1e-2):
        """Hold a 24-iteration solve to its plain version's cost basin:
        acceptance flags agree on >= 95% of problems, the median relative f
        difference is <= med_tol and the mean f agrees to mean_tol (None:
        printed, not held), the median f to 1%, and among the problems
        whose f differs by more than 1e-4 the kernel's is below the plain
        version's on at least 40% (when there are 20 such: a solver that
        is worse shows in the sign); print the plain GPU-vs-CPU control
        beside it (f1_ctrl and f_ctrl, the relative f differences of its
        first n_c problems at 1 and 24 iterations). At M = 3 the
        tolerances are 1e-4 and 1e-2. Past M = 3 two f32 solvers part
        within 24 iterations on many problems, the plain solver on the
        card and on the CPU too: the median is held to twice the
        control's (control_tol), and the mean f, which the few problems
        where one solver escapes a collision that the other stays in
        carry, is not held (the control on every problem moved it by up to
        1.7e-2 at M = 5 and 12, PERF.md)."""
        n = ok_k.shape[0]
        agree = float((ok_k == ok_p).float().mean())
        rel_f = rel(f_k, f_p)
        mean_gap = abs(float(f_k.mean()) / float(f_p.mean()) - 1.0)
        med_gap = abs(float(f_k.median()) / float(f_p.median()) - 1.0)
        parted = rel_f > 1e-4
        lower = float((f_k < f_p).cpu().numpy()[parted].mean()) \
            if parted.any() else 1.0
        say(f"{name} 24 iters: accepted {int(ok_k.sum())}/{n} kernel, "
            f"{int(ok_p.sum())}/{n} plain, flags agree {agree:.3f} (tol "
            f"0.95); f rel diff median {np.median(rel_f):.2e} (tol "
            f"{med_tol:.2e}) p99 {np.percentile(rel_f, 99):.2e} max "
            f"{rel_f.max():.2e}, mean f gap {mean_gap:.2e} ("
            f"{'not held' if mean_tol is None else f'tol {mean_tol:.2e}'}"
            f"), median f gap {med_gap:.2e} (tol 1e-2), "
            f"kernel lower on {lower:.3f} of the {int(parted.sum())} "
            f"problems apart by > 1e-4 (tol 0.4); iters mean "
            f"{float(iters.float().mean()):.1f}")
        gap = (f_k - f_p).abs()
        top = torch.topk(gap, min(5, n)).indices
        say(f"{name} largest f differences (kernel vs plain, iters): "
            + ", ".join(f"{float(f_k[i]):.6g} vs {float(f_p[i]):.6g} "
                        f"({int(iters[i])})" for i in top)
            + f"; their share of the summed difference "
            f"{float(gap[top].sum() / gap.sum().clamp(min=1e-30)):.3f}")
        say(f"{name} plain GPU vs CPU ({n_c} problems): f rel diff max "
            f"{f1_ctrl.max():.2e} at 1 iter; at 24 iters median "
            f"{np.median(f_ctrl):.2e} p99 {np.percentile(f_ctrl, 99):.2e}"
            f" max {f_ctrl.max():.2e}")
        if agree < 0.95 or np.median(rel_f) > med_tol \
                or (mean_tol is not None and mean_gap > mean_tol) \
                or med_gap > 1e-2 \
                or (int(parted.sum()) >= 20 and lower < 0.4):
            raise AssertionError(f"{name} leaves the plain version's cost "
                                 f"basin")

    def control_tol(name, f_gpu, f_cpu):
        """basin()'s median tolerance past M = 3 from the control, the
        plain solver's f on the card and on the CPU from the same
        problems: max(1e-4, twice the control's median relative f
        difference); prints it and the control's mean f gap."""
        med_c = float(np.median(rel(f_gpu.cpu(), f_cpu)))
        mean_c = abs(float(f_cpu.mean()) / float(f_gpu.cpu().mean()) - 1.0)
        say(f"{name} control: the plain solver on the CPU against the card "
            f"on {f_cpu.shape[0]} problems, median f rel diff {med_c:.2e}, "
            f"mean f gap {mean_c:.2e}")
        return max(1e-4, 2.0 * med_c)

    def retry_launch(name, x0_, head_, tail_, ok_first, first_ms, launch):
        """Time a solver kernel at its second launch of a segment: the lazy
        bank's retry lanes (expert.warm_start_plan), retry_num problems per
        env from the first lane's start perturbed, those of the envs whose
        first lane was accepted skipped; print it beside the first-lane
        launch. launch(x0, head, tail, env_of, skip, out) launches it."""
        n, r = x0_.shape[0], pp.retry_num
        xr = (x0_.repeat_interleave(r, 0) + torch.from_numpy(
            rng_retry.normal(scale=0.3, size=(n * r, 7))).float().to(dev)
        ).contiguous()
        env_r = torch.arange(n, device=dev,
                             dtype=torch.int32).repeat_interleave(r)
        skip_r = ok_first.to(torch.int32)[env_r.long()].contiguous()
        out = (torch.empty_like(xr), torch.empty(n * r, device=dev),
               torch.empty(n * r, dtype=torch.int32, device=dev))
        args = (xr, head_.repeat_interleave(r, 0).contiguous(),
                tail_.repeat_interleave(r, 0).contiguous(), env_r, skip_r,
                out)
        ms = median_ms(torch, lambda: launch(*args), 10)
        live = int((skip_r == 0).sum())
        skipped_ok = bool((out[2][skip_r == 1] == 0).all()) and bool(
            (out[1][skip_r == 1] == 0).all()) and torch.equal(
            out[0][skip_r == 1], xr[skip_r == 1])
        say(f"{name} retry launch: {n * r} problems, {live} live (envs "
            f"{int((~ok_first).sum())}), iters mean "
            f"{float(out[2][skip_r == 0].float().mean()) if live else 0:.1f}"
            f": {ms:.3f} ms; first-lane launch ({n} problems) "
            f"{first_ms:.3f} ms; skipped problems return (x0, 0, 0): "
            f"{skipped_ok}")
        if not skipped_ok:
            raise AssertionError(f"{name} changed a skipped problem")

    def lazy_bank(name, pmap, pmap_cpu, head, tail, q0, ts0, it_first,
                  first_ok):
        """warm_start_plan on the card (the first lanes, then the retries
        with the accepted envs skipped, B5 for acceptance and coefficients)
        against its plain version on the CPU, from the solver check's
        inputs. Skip mask: the kernel is deterministic and the first launch
        repeats the solver check's 24-iteration run, so an env whose first
        lane was accepted spends exactly that run's iterations (its retries
        skipped) and a rejected env spends more (its retries live). The
        selection is held to the solver's cost basin: ok flags agree on >=
        95% of envs, the median relative cost difference of the selected
        trajectories is <= 1e-4, and the median env's waypoints and
        durations agree to 1e-2 m and 1e-2 s."""
        n = head.shape[0]
        noise = torch.from_numpy(rng.normal(size=(n, pp.retry_num, pp.dims,
                                                  pp.num_wpts))).float()
        tg = expert.warm_start_plan(pmap, head, tail, q0, ts0, noise.to(dev),
                                    pp)
        t0 = time.perf_counter()
        tc = expert.warm_start_plan(pmap_cpu, head.cpu(), tail.cpu(),
                                    q0.cpu(), ts0.cpu(), noise, pp)
        cpu_s = time.perf_counter() - t0
        extra = (tg.iters - it_first).cpu()
        first_ok = first_ok.cpu()
        skip_ok = bool((extra[first_ok] == 0).all())
        live_ok = bool((extra[~first_ok] > 0).all())
        agree_b = float((tg.ok.cpu() == tc.ok).float().mean())
        wts = costs.weights(pp, "cpu")
        rel_b = rel((tg.costs.cpu() @ wts), tc.costs @ wts)
        d_w = (tg.int_wpts.cpu() - tc.int_wpts).abs().flatten(1).amax(1)
        d_t = (tg.ts.cpu() - tc.ts).abs().amax(1)
        say(f"{name} lazy bank B={n}: {int((~first_ok).sum())} envs retried "
            f"(iters > first lane: {live_ok}), {int(first_ok.sum())} skipped "
            f"(iters = first lane: {skip_ok}); ok {int(tg.ok.sum())} card, "
            f"{int(tc.ok.sum())} CPU, agree {agree_b:.3f} (tol 0.95); cost "
            f"rel diff median {np.median(rel_b):.2e} (tol 1e-4) max "
            f"{rel_b.max():.2e}; wpts diff median {float(d_w.median()):.2e} "
            f"m max {float(d_w.max()):.3g}, ts diff median "
            f"{float(d_t.median()):.2e} s max {float(d_t.max()):.3g} (tol "
            f"1e-2 on medians); CPU {cpu_s:.1f} s")
        if int((~first_ok).sum()) == 0 or not (skip_ok and live_ok) \
                or agree_b < 0.95 or np.median(rel_b) > 1e-4 \
                or float(d_w.median()) > 1e-2 or float(d_t.median()) > 1e-2:
            raise AssertionError(f"the {name} lazy bank on the card "
                                 f"disagrees with its plain version")

    def objective_check(kind, label, pmap, x, head, tail, env_of,
                        dist_flops, map_bytes, record_it=True, pp_=None):
        """B2s (kind 'scene') or B7 ('grid') against its plain version at a
        lazy bank's shapes: the value and gradient at the P problems x, and
        the value at max_ls line-search candidates of each (t * d, t =
        0.5^k, d a random direction), in one launch each: values within
        5e-4 of max(|f|, 1) of the plain version, gradients within 2e-3 of
        max(|g|_inf, 1) per problem (the golden tests' 5e-4 and 2e-3,
        tests/test_costs_pallas*.py, which scale each component by itself:
        a component that cancels to a small value carries the roundoff of
        the large terms it sums, and at this batch the plain version sits
        ~1e-2 off its f64 self there, so the elementwise measures are
        printed) of the reference named below.
        dist_flops (P,): operations of one distance query per problem;
        map_bytes: the map bytes the launch must read. With dist_flops,
        each launch's time (events and the device timer, graph_ms) beside
        the plain version's and the bound, and with record_it the kernel's
        record.
        pp_: the planner parameters (by default the flagship's, M = 3)."""
        pp_ = pp_ or pp
        P, L, nv, M = x.shape[0], pp_.max_ls, pp_.num_vars, pp_.num_pieces
        d = torch.from_numpy(rng_eval.normal(scale=0.3, size=(P, nv))
                             ).float().to(dev)
        steps = 0.5 ** torch.arange(L, device=dev, dtype=torch.float32)
        xc = (x[:, None] + steps[:, None] * d[:, None]).reshape(-1, nv
                                                                ).contiguous()
        hc = head.repeat_interleave(L, 0).contiguous()
        tc = tail.repeat_interleave(L, 0).contiguous()
        e1 = env_of.to(torch.int32).contiguous()
        ec = e1.repeat_interleave(L).contiguous()
        if kind == "scene":
            map_args = (scene.pack_prims(pmap),)
            launch = objective.launch_scene
        else:
            map_args = (pmap.win.contiguous(), pmap.worg.contiguous())
            launch = objective.launch_grid
        f_c = torch.empty(P * L, device=dev)
        f_v = torch.empty(P, device=dev)
        g_v = torch.empty((P, nv), device=dev)
        launch(xc, hc, tc, *map_args, ec, f_c, None, pp_)
        launch(x, head, tail, *map_args, e1, f_v, g_v, pp_)
        want_c = objective.plain_fwd(xc, hc, tc, pmap, ec.long(), pp_)
        want_f, want_g = objective.plain_valgrad(x, head, tail, pmap,
                                                 env_of.long(), pp_)

        def f64(t):
            return t.detach().cpu().double()

        def rel_g(g, ref):
            """max |g - ref| scaled by each problem's largest component of
            ref (or 1), and scaled elementwise by max(|ref|, 1)"""
            d = (f64(g) - f64(ref)).abs()
            row = f64(ref).abs().amax(1, keepdim=True).clamp(min=1.0)
            return (float((d / row).max()),
                    float((d / f64(ref).abs().clamp(min=1.0)).max()))
        s_c = float(rel(f_c, want_c).max())
        s_f = float(rel(f_v, want_f).max())
        s_g, s_g_el = rel_g(g_v, want_g)
        # beside it, both against the plain version in f64 on the CPU (on
        # the card its banded solve is kernel B5, in f32)
        pmap64 = type(pmap)(*(
            f64(t) if t.is_floating_point() else t.cpu()
            for t in (getattr(pmap, f.name)
                      for f in dataclasses.fields(pmap))))
        g64 = objective.plain_valgrad(f64(x), f64(head), f64(tail), pmap64,
                                      env_of.long().cpu(), pp_)[1]
        k64, p64 = rel_g(g_v, g64), rel_g(want_g, g64)
        # the gradient's reference: on the scene the f64 value, exact to
        # roundoff (kernel and f32 plain version each carry up to ~2e-3 of
        # f32 sums, so their distance can reach twice that); on windows the
        # f32 plain version, which takes the kernel's bilinear cells (at a
        # cell edge f64 takes the next cell, and the gradient jumps there)
        g_gate = k64[0] if kind == "scene" else s_g
        n_coll = int((want_f > 100.0).sum())
        tail_line = ""
        if M != 3:
            # past M = 3 the f32 plain version itself leaves 2e-3 of the
            # f64 one on a few problems of a bank (3.15e-3 at M = 5 over
            # 3072 problems on the CPU, where warp_objective run on the
            # host read 2.29e-3): hold at most 0.1% of the problems past
            # 2e-3, and every problem within 1e-2
            ref = g64 if kind == "scene" else want_g
            row = f64(ref).abs().amax(1, keepdim=True).clamp(min=1.0)
            per_k = ((f64(g_v) - f64(ref)).abs() / row).amax(1)
            per_p = ((f64(want_g) - g64).abs() / f64(g64).abs().amax(
                1, keepdim=True).clamp(min=1.0)).amax(1)
            share_k = float((per_k > 2e-3).double().mean())
            share_p = float((per_p > 2e-3).double().mean())
            tail_line = (f"; problems past 2e-3: kernel {share_k:.2e} (tol "
                         f"1e-3), f32 plain against f64 {share_p:.2e}")
            g_gate = 2e-3 if share_k <= 1e-3 and \
                float(per_k.max()) <= 1e-2 else float(per_k.max())
        say(f"objective_{kind} {label} M={M}: {P} problems, {P * L} "
            f"candidates; "
            f"values scaled err {s_c:.3g} (candidates), {s_f:.3g} (problems)"
            f" (tol 5e-4); gradients scaled err against the f32 plain "
            f"version {s_g:.3g} (elementwise {s_g_el:.3g}), against f64: "
            f"kernel {k64[0]:.3g} (elementwise {k64[1]:.3g}), plain "
            f"{p64[0]:.3g} (elementwise {p64[1]:.3g}); held: "
            f"{'f64' if kind == 'scene' else 'f32 plain'} {g_gate:.3g} (tol "
            f"2e-3){tail_line}; {n_coll} problems with a live collision "
            f"term")
        if max(s_c, s_f) > 5e-4 or g_gate > 2e-3 or n_coll == 0:
            raise AssertionError(f"objective_{kind} {label} disagrees with "
                                 f"its plain version")
        if other is not None and M == 3:
            against(kind, label, map_args, (
                (f"objective_{kind}_fwd", xc, hc, tc, ec, f_c, None),
                (f"objective_{kind}_valgrad", x, head, tail, e1, f_v, g_v)))
        if dist_flops is None:       # a check alone: no times
            return
        io_c = P * L * (nv + 12 + 1 + 1) * 4
        io_v = P * (nv + 12 + 1 + nv + 1) * 4
        dfl = np.asarray(dist_flops, dtype=np.float64)
        K = pp_.samples_per_piece
        work = {"fwd": (float(np.sum(objective_flops(
                    K, np.repeat(dfl, L), False, M))), io_c + map_bytes),
                "valgrad": (float(np.sum(objective_flops(K, dfl, True, M))),
                            io_v + map_bytes)}
        calls = {"fwd": (lambda: launch(xc, hc, tc, *map_args, ec, f_c,
                                        None, pp_),
                         lambda: objective.plain_fwd(xc, hc, tc, pmap,
                                                     ec.long(), pp_)),
                 "valgrad": (lambda: launch(x, head, tail, *map_args, e1,
                                            f_v, g_v, pp_),
                             lambda: objective.plain_valgrad(
                                 x, head, tail, pmap, env_of.long(), pp_))}
        ms = {k: (median_ms(torch, c[0], 20), graph_ms(c[0]),
                  median_ms(torch, c[1], 3)) for k, c in calls.items()}
        for k, (ev, gr, pl) in ms.items():
            b_ms, b_by = bound(*work[k])
            say(f"objective_{kind}_{k} {label} M={M}: {ev:.3f} ms (events), "
                f"device (graph) {gr:.4f} ms, plain {pl:.3f} ms, bound "
                f"{b_ms:.4f} ms ({b_by})")
        if not record_it:
            return
        report(f"objective_{kind}_fwd",
               (float((f_c - want_c).abs().max()), s_c), 5e-4,
               ms["fwd"][0], ms["fwd"][2], *work["fwd"], on="rel")
        report(f"objective_{kind}_valgrad",
               (max(float((f_v - want_f).abs().max()),
                    float((g_v - want_g).abs().max())),
                max(s_f / 5e-4, g_gate / 2e-3)), 1.0,
               ms["valgrad"][0], ms["valgrad"][2], *work["valgrad"],
               on="ratio")
        W = objective.WARPS
        say(f"objective_{kind} grids: fwd {-(-P * L // W)} blocks x {W} "
            f"warps ({record[f'objective_{kind}_fwd']['ms']:.3f} ms), "
            f"valgrad {-(-P // W)} x {W} "
            f"({record[f'objective_{kind}_valgrad']['ms']:.3f} ms)")

    def graph_ms(fn, n=20, reps=5):
        """fn's device time in ms: n calls captured in one CUDA graph and
        replayed between two events, the median of reps replays, over n.
        No host work lies between the launches, so a kernel shorter than
        its launch's host path is timed as the card runs it (the
        back-to-back timer then reads the host's ~10-20 us a call)."""
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="relaxed"):
            for _ in range(n):
                fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            graph.replay()
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e) / n)
        return float(np.median(times))

    def in_turns(call, pieces=False):
        """call(lib)'s time in ms for the other checkout's library and this
        tree's, in turns (other, this, this, other): 20 launches back to
        back between two events (so that the host's enqueueing hides behind
        the card's work), the median of 5 such runs; then the same turns
        timed as a CUDA graph of 20 launches (``graph_ms``). With pieces,
        the libraries of B5, B1, B6, B2s and B7 at M = 3. Returns the
        eight times and their text."""
        this, that = ((_cuda.load_pieces(3), other3) if pieces
                      else (_cuda.load(), other))
        libs = (that, this, this, that)
        ms = [median_ms(torch, lambda: [call(lib) for _ in range(20)], 5)
              / 20 for lib in libs]
        ms += [graph_ms(lambda: call(lib)) for lib in libs]
        return ms, (f"ms other {ms[0]:.4f} / this {ms[1]:.4f} / this "
                    f"{ms[2]:.4f} / other {ms[3]:.4f}; device (graph) ms "
                    f"other {ms[4]:.4f} / this {ms[5]:.4f} / this "
                    f"{ms[6]:.4f} / other {ms[7]:.4f}")

    def against(kind, label, map_args, calls):
        """--against: the other checkout's B2s / B7 and this tree's on each
        of calls [(name, x, head, tail, env_of, f, g)], whose f and g hold
        this tree's results from its wrapper: the elements whose bits
        differ, then each kernel's time, both through their C entries (the
        same host path), in turns (``in_turns``), on all rows and on their
        first two thirds. On a bank of three lanes an env
        these are the sizes of the expert loop's two launches: its lazy
        bank solves batch_num = 3 lanes of every env, then retry_num = 2."""
        K = pp.samples_per_piece
        for name, x_, h_, t_, e_, f_, g_ in calls:
            outs = {}
            for lib in (other3, _cuda.load_pieces(3)):
                outs[lib] = (torch.empty_like(f_),
                             None if g_ is None else torch.empty_like(g_))
            if kind == "scene":
                sizes = (map_args[0].shape[1],)
            else:
                sizes = tuple(map_args[0].shape[1:])

            def call(lib, n):
                entry = (lib.neo_objective_scene if kind == "scene"
                         else lib.neo_objective_grid)
                f_o, g_o = outs[lib]
                _cuda.check(entry(
                    _cuda.ptr(x_), _cuda.ptr(h_), _cuda.ptr(t_),
                    *map(_cuda.ptr, map_args), _cuda.ptr(e_),
                    _cuda.ptr(f_o), None if g_o is None else _cuda.ptr(g_o),
                    n, *sizes, K, objective._params(pp),
                    _cuda.stream_ptr(dev)), name)

            def n_diff(a, b):
                return int((a.view(torch.int32) != b.view(torch.int32)).sum())
            P_ = x_.shape[0]
            for lib in outs:
                call(lib, P_)
            torch.cuda.synchronize()
            (f_o, g_o), (f_m, g_m) = outs.values()
            line = (f"f differs on {n_diff(f_o, f_)} of {f_.numel()}")
            if g_ is not None:
                line += f", g on {n_diff(g_o, g_)} of {g_.numel()}"
            if n_diff(f_m, f_) or (g_ is not None and n_diff(g_m, g_)):
                raise AssertionError(f"{name}: its C entry and its wrapper "
                                     f"disagree")
            line += " (bits)"
            for n in (P_, 2 * P_ // 3):
                turns = in_turns(lambda lib: call(lib, n), pieces=True)[1]
                line += f"; {n} rows {turns}"
            say(f"{name} {label} against {args.against}: {line}")

    def edt_against(name, label, grid, dtype, extra, params):
        """--against: the other checkout's B9 kernel and this tree's, both
        through their C entries (neo_<name>, with the launch's extra int
        arguments and host params), on grid: the cells whose bits differ,
        then each kernel's time in turns (``in_turns``)."""
        B_, H_, W_ = grid.shape
        outs = {lib: torch.empty(grid.shape, dtype=dtype, device=dev)
                for lib in (other, _cuda.load())}

        def call(lib):
            _cuda.check(getattr(lib, f"neo_{name}")(
                _cuda.ptr(grid), _cuda.ptr(outs[lib]), B_, H_, W_, *extra,
                _cuda.host_floats(params), _cuda.stream_ptr(dev)), name)
        for lib in outs:
            call(lib)
        torch.cuda.synchronize()
        word = torch.int16 if dtype == torch.bfloat16 else torch.int32
        o, m = (t.view(word) for t in outs.values())
        n = int((o != m).sum())
        say(f"{name} {label} against {args.against}: {n} of {o.numel()} "
            f"cells differ (bits); {in_turns(call)[1]}")

    def entry_against(name, label, entry, fill, want, work, init=None,
                      pieces=False):
        """--against: the other checkout's kernel and this tree's, both
        through their C entries, lib.<entry>(*fill(buffers)) writing into
        float32 buffers shaped as want (copies of init for a kernel that
        works in place), this tree's wrapper's outputs on the same inputs
        (which its C entry must give bit for bit): the elements whose bits
        differ, then each kernel's time in turns (``in_turns``; an in-place
        kernel goes on from its own output) and the bound of work =
        (operations, bytes)."""
        libs = ((other3, _cuda.load_pieces(3)) if pieces
                else (other, _cuda.load()))
        bufs = {lib: [torch.empty_like(t) if init is None else init[i].clone()
                      for i, t in enumerate(want)]
                for lib in libs}
        # the arguments built once, so that the timer sees the launches; the
        # last, the stream, read at each call (a graph captures on its own)
        argv = {lib: fill(bufs[lib])[:-1] for lib in bufs}

        def call(lib):
            _cuda.check(getattr(lib, entry)(*argv[lib], _cuda.stream_ptr(dev)),
                        name)
        for lib in bufs:
            call(lib)
        torch.cuda.synchronize()
        (o, m), n = bufs.values(), 0
        for a, b, w in zip(o, m, want):
            if not torch.equal(b.view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f"{name}: its C entry and its wrapper "
                                     f"disagree")
            n += int((a.view(torch.int32) != b.view(torch.int32)).sum())
        b_ms, b_by = bound(*work)
        say(f"{name} {label} against {args.against}: {n} of "
            f"{sum(a.numel() for a in o)} elements differ (bits); "
            f"{in_turns(call, pieces)[1]}; bound {b_ms:.4f} ms ({b_by})")

    def per_eval_check(name, pmap, x0_, head_, tail_, env_, fused,
                       accept_map, cost_pp):
        """solve.solve_per_eval (the PyTorch loop over B2s / B7) against the
        fused solver kernel (B1 / B6) on the same problems: one iteration x
        within 1e-4 with the same iteration counts; 24 iterations in the
        cost basin as basin() holds a solver kernel to its plain version
        (roundoff steers a few percent of the solves onto other iterate
        paths, as it does between the plain version on the card and on the
        CPU): acceptance flags agreeing on >= 95% (the count of differing
        flags printed), the median relative f difference <= 1e-4 and the
        mean f within 1%, with the share of problems whose f agrees within
        5e-3 printed; then one timed 24-iteration solve of each (after a
        synchronize)."""
        n = x0_.shape[0]
        pp1 = dataclasses.replace(pp, max_iters=1)
        xf1, _, itf1 = fused(x0_, head_, tail_, pmap, env_, pp1)
        xp1, _, itp1 = solve.solve_per_eval(x0_, head_, tail_, pmap, env_,
                                            pp1)
        d1 = float((xp1 - xf1).abs().max())
        same_it = int((itp1 == itf1).sum())
        times = {}
        for which, fn in (("fused", fused), ("per_eval",
                                             solve.solve_per_eval)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(x0_, head_, tail_, pmap, env_, pp)
            torch.cuda.synchronize()
            times[which] = ((time.perf_counter() - t0) * 1e3, out)
        (_, (xf, ff, itf)), (_, (xp, fp, itp)) = times["fused"], \
            times["per_eval"]
        ok_f = accepted(xf, head_, tail_, accept_map, cost_pp)
        ok_p = accepted(xp, head_, tail_, accept_map, cost_pp)
        rel_f = rel(fp, ff)
        within = float((rel_f <= 5e-3).mean())
        mean_gap = abs(float(fp.mean()) / float(ff.mean()) - 1.0)
        n_flags = int((ok_f != ok_p).sum())
        say(f"solve_per_eval vs {name} B={n}: 1 iteration x diff max "
            f"{d1:.3g} (tol 1e-4), iteration counts equal {same_it}/{n}; 24 "
            f"iterations: f rel diff median {np.median(rel_f):.2e} (tol "
            f"1e-4) max {rel_f.max():.2e}, within 5e-3 on {within:.3f}, mean "
            f"f gap {mean_gap:.2e} (tol 1e-2); "
            f"acceptance flags differ on {n_flags}/{n} (accepted "
            f"{int(ok_p.sum())} per_eval, {int(ok_f.sum())} fused); iters "
            f"mean {float(itp.float().mean()):.1f} / "
            f"{float(itf.float().mean()):.1f}; one solve "
            f"{times['per_eval'][0]:.1f} ms per_eval, "
            f"{times['fused'][0]:.1f} ms fused")
        if d1 > 1e-4 or same_it != n or np.median(rel_f) > 1e-4 \
                or mean_gap > 1e-2 or n_flags > 0.05 * n:
            raise AssertionError(f"solve_per_eval leaves {name}'s results")
        # where a per-evaluation solve's time goes: its device events under
        # torch.profiler (one stream, so they do not overlap)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve.solve_per_eval(x0_, head_, tail_, pmap, env_, pp)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        obj = [e for e in kern if "objective_" in e.name]
        # the value-and-gradient kernels, by demangled or mangled name
        obj_g = sum(e.time_range.elapsed_us() for e in obj
                    if "<true>" in e.name or "ILb1E" in e.name) / 1e3
        obj_ms = sum(e.time_range.elapsed_us() for e in obj) / 1e3
        if kern:
            say(f"solve_per_eval {name} under torch.profiler: {wall:.1f} ms "
                f"wall, {len(kern)} device events busy {busy:.2f} ms (idle "
                f"share {1.0 - busy / wall:.3f}), of which the objective "
                f"kernels {obj_ms:.2f} ms ({len(obj)} launches; value and "
                f"gradient {obj_g:.2f} ms, value {obj_ms - obj_g:.2f} ms)")
        else:
            say(f"solve_per_eval {name} device time under torch.profiler: "
                f"not measured (no device events recorded)")

    # ---- B5: banded MINCO solve, N = B systems (acceptance of lane 0)
    head, tail, q0, ts0 = boundary_problems(B)
    A, b = minco.build_system(head, tail, q0, ts0)
    aug = torch.cat([A, b], dim=2).contiguous()
    out = torch.empty((B, 18, 2), device=dev)
    minco.launch_banded_solve(aug, out, 4)
    want = minco._givens_solve(A, b, 4, 2)
    nbytes = givens_bytes(18, 4, B)
    report("minco_banded_solve", err_line(out, want), 1e-3,
           median_ms(torch, lambda: minco.launch_banded_solve(aug, out, 4),
                     20),
           median_ms(torch, lambda: minco._givens_solve(A, b, 4, 2), 10),
           B * givens_flops(4), nbytes,
           library_ms=median_ms(torch, lambda: torch.linalg.solve(A, b), 10))
    # the adjoint's transposed band (A^T lam = x_bar, lower bandwidth 2)
    x_bar = torch.from_numpy(rng_b5.normal(size=(B, 18, 2))).float().to(dev)
    aug_t = torch.cat([A.transpose(1, 2), x_bar], dim=2).contiguous()
    out_t = torch.empty((B, 18, 2), device=dev)
    minco.launch_banded_solve(aug_t, out_t, 2)
    err_t = err_line(out_t, minco._givens_solve(A.transpose(1, 2), x_bar, 2,
                                                4))
    say(f"minco_banded_solve A^T (lower bandwidth 2) B={B}: max abs "
        f"{err_t[0]:.3g}, rel {err_t[1]:.3g}; tol 1e-3 "
        f"{'ok' if err_t[0] <= 1e-3 else 'MISS'}")
    if err_t[0] > 1e-3:
        raise AssertionError("minco_banded_solve (A^T) disagrees with its "
                             "plain version")
    out_512 = torch.empty((BV, 18, 2), device=dev)
    minco.launch_banded_solve(aug[:BV], out_512, 4)
    # the warp's dependent chain, which the card cannot beat: each band's
    # launch timed on the device (graph_ms), and what each rotation that
    # lower bandwidth 4 adds to 2's costs, in ns and in cycles at the card's
    # largest SM clock
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()[0])
    t_b5 = {4: graph_ms(lambda: minco.launch_banded_solve(aug, out, 4)),
            2: graph_ms(lambda: minco.launch_banded_solve(aug_t, out_t, 2))}
    t_512 = graph_ms(lambda: minco.launch_banded_solve(aug[:BV], out_512, 4))
    n_rot = {lbw: sum(min(c + lbw + 1, 18) - c - 1 for c in range(18))
             for lbw in (4, 2)}
    per_rot = (t_b5[4] - t_b5[2]) / (n_rot[4] - n_rot[2]) * 1e6
    b5_bound = {lbw: bound(B * givens_flops(lbw), givens_bytes(18, lbw, B))
                for lbw in (4, 2)}
    say(f"minco_banded_solve device (graph) ms: B={B} lower bandwidth 4 "
        f"{t_b5[4]:.4f}, 2 {t_b5[2]:.4f}, B={BV} {t_512:.4f}; {n_rot[4]} and "
        f"{n_rot[2]} rotations a warp, 18 column syncs and 18 divides; each "
        f"of the {n_rot[4] - n_rot[2]} more at 4 costs {per_rot:.1f} ns "
        f"({per_rot * clock / 1e3:.0f} cycles at {clock:.0f} MHz), so the "
        f"chain of {n_rot[4]} takes {n_rot[4] * per_rot / 1e3:.2f} us; "
        f"bound (the band's sectors, the right-hand sides and the "
        f"solution) B={B} lower bandwidth 4 {b5_bound[4][0]:.4f} ms "
        f"({b5_bound[4][1]}), 2 {b5_bound[2][0]:.4f} ms ({b5_bound[2][1]})")
    if other is not None:
        for label, aug_, out_, n_, lbw in (
                (f"B={B}", aug, out, B, 4),
                (f"A^T (lower bandwidth 2) B={B}", aug_t, out_t, B, 2),
                (f"B={BV}", aug[:BV], out_512, BV, 4)):
            entry_against("minco_banded_solve", label,
                          "neo_minco_banded_solve",
                          lambda o, a_=aug_, n_=n_, l_=lbw: (
                              _cuda.ptr(a_), _cuda.ptr(o[0]), n_, l_,
                              _cuda.stream_ptr(dev)), [out_],
                          (n_ * givens_flops(lbw),
                           givens_bytes(18, lbw, n_)), pieces=True)
    # the wrapper whole: minco.solve_coeffs builds A and b (~100 small
    # PyTorch ops), concatenates them and launches B5
    ms_coeffs = median_ms(torch, lambda: minco.solve_coeffs(head, tail, q0,
                                                            ts0), 20)
    ms_cat = median_ms(torch, lambda: torch.cat([A, b], dim=2).contiguous(),
                       20)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    minco.solve_coeffs(head, tail, q0, ts0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        minco.solve_coeffs(head, tail, q0, ts0)
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3
    n_b5 = sum(1 for e in ops if "minco_banded_solve" in e.name)
    say(f"minco.solve_coeffs B={B}: {ms_coeffs:.3f} ms a call (CUDA events, "
        f"median of 20; the build, the concatenation and B5); the "
        f"concatenation alone {ms_cat:.3f} ms, B5 alone "
        f"{record['minco_banded_solve']['ms']:.3f} ms; under torch.profiler "
        f"{len(ops)} device operations a call ({n_b5} of them B5), busy "
        f"{busy:.3f} ms")

    # ---- B4: depth frames of B drones, 160x120
    def poses(n):
        pos = torch.from_numpy(np.stack([
            rng.uniform(-1.0, 4.0, n), rng.uniform(-2.0, 2.0, n),
            rng.uniform(1.5, 2.5, n)], -1)).float().to(dev)
        acc = torch.from_numpy(rng.normal(scale=2.0, size=(n, 3))).float(
            ).to(dev)
        yaw = torch.from_numpy(rng.uniform(-0.6, 0.6, n)).float().to(dev)
        return pos, frames.quat_from_accel_yaw(acc, yaw).contiguous()

    pos, quat = poses(B)
    prims8 = raycast.pack_prims(worlds)
    depth = torch.empty((B, cam.height, cam.width), device=dev)
    raycast.launch_render(pos, quat, prims8, depth, cam)
    want = raycast.render_depth(worlds, pos, quat, cam)
    diff = (depth - want).abs()
    frac_off = float((diff > 1e-3).float().mean())
    say(f"render_depth: {frac_off:.2e} of pixels off by > 1e-3 m "
        f"(tol 1e-3: edge grazes)")
    if frac_off > 1e-3:
        raise AssertionError("render_depth disagrees with its plain version")
    tile = (raycast.TILE_H, raycast.TILE_W)
    kept = raycast.tile_cull(worlds, pos, quat, cam)
    work = render_work(kept, cam.height, cam.width, prims8.shape[1], tile)
    # the dense work, every pixel against every live primitive, as the TPU
    # kernel does it: printed beside the bound, not as it
    dense = (B * cam.height * cam.width
             * (60 + 35 * float(worlds.active.sum()) / B))
    say(f"render_depth: {float(kept.sum(-1).float().mean()):.3f} primitives "
        f"a tile survive the cull, of {float(worlds.active.sum()) / B:.3f} "
        f"live ({tuple(kept.shape[1:3])} tiles a frame); bound "
        f"{bound(*work)[0]:.4f} ms on the survivors, "
        f"{bound(dense, work[1])[0]:.4f} ms on the dense work")
    # held above to the share of pixels off (an edge graze flips a ray from
    # hit to miss); the largest difference is recorded as it is
    report("render_depth", (float(diff.max()), frac_off), 1e-3,
           median_ms(torch, lambda: raycast.launch_render(
               pos, quat, prims8, depth, cam), 20),
           median_ms(torch, lambda: raycast.render_depth(
               worlds, pos, quat, cam), 5),
           *work, on="rel")
    cam_params = _cuda.host_floats([cam.fx, cam.fy, cam.min_range,
                                    cam.max_range, cam.height])
    if other is not None:
        def render_fill(prims_):
            return lambda o: (
                _cuda.ptr(pos), _cuda.ptr(quat), _cuda.ptr(prims_),
                _cuda.ptr(o[0]), B, 1, prims_.shape[1], cam.width,
                cam.height, 1, cam_params, _cuda.stream_ptr(dev))
        entry_against("render_depth", "scene frames B=1024",
                      "neo_render_depth", render_fill(prims8), [depth], work)
        # the same frames with every third primitive a cylinder
        prims_c = prims8.clone()
        prims_c[:, 1::3, 6] = 1.0
        worlds_c = worlds.replace(shape=prims_c[..., 6].to(worlds.shape.dtype))
        depth_c = raycast.render_depth_auto(worlds_c, pos, quat, cam)
        entry_against("render_depth", "scene frames with cylinders B=1024",
                      "neo_render_depth", render_fill(prims_c), [depth_c],
                      render_work(raycast.tile_cull(worlds_c, pos, quat, cam),
                                  cam.height, cam.width, prims_c.shape[1],
                                  tile))

    # ---- B3: one tracking segment of B envs
    def track_inputs(n, state):
        goals = torch.from_numpy(np.stack([rng.uniform(0.3, 1.0, n),
                                           rng.uniform(-0.3, 0.3, n)], -1))
        state = state.replace(goal=goals.float().to(dev))
        t = torch.arange(60, device=dev) / 60.0
        v = torch.from_numpy(rng.uniform(0.5, 1.0, n)).float().to(dev)[:, None]
        w = torch.from_numpy(rng.uniform(1.5, 3.0, n)).float().to(dev)[:, None]
        cmds = torch.stack([
            torch.stack([v * t, 0.4 * torch.sin(w * t)], -1),
            torch.stack([v.expand(n, 60), 0.4 * w * torch.cos(w * t)], -1),
            torch.stack([torch.zeros(n, 60, device=dev),
                         -0.4 * w * w * torch.sin(w * t)], -1)], dim=2)
        return state, cmds.contiguous()

    st, cmds = track_inputs(B, env.reset(worlds, pp, mp, mapp,
                                         _cuda.make_generator(1)))
    st_packed = track.pack_state(st)
    prims6 = scene.pack_prims(sc)
    tout = torch.empty((B, 18), device=dev)
    trace = torch.empty((B, 60, 5, 3), device=dev)
    track.launch_tracker(cmds, st_packed, prims6, tout, trace, pp, mp, sp)
    wd, wreach, wsteps, wmet, wmpos, wtrace = track._track_plain(
        st, cmds, pp, mp, sp)
    want = torch.cat([wd.pos, wd.vel, wd.yaw[:, None], wd.quat, wmpos, wmet,
                      wreach[:, None].float(), wsteps[:, None].float()], 1)
    err = max(err_line(tout, want), err_line(trace, wtrace))
    work = (B * 60 * 200 + B * 10 * 20 * float(n_active.mean()),
            B * (60 * 6 + 22 + 24 * 6 + 18 + 60 * 15) * 4)
    report("track_segment", err, 1e-3,
           median_ms(torch, lambda: track.launch_tracker(
               cmds, st_packed, prims6, tout, trace, pp, mp, sp), 20),
           median_ms(torch, lambda: track._track_plain(
               st, cmds, pp, mp, sp), 5), *work)
    if other is not None:
        entry_against("track_segment", "spr=60 B=1024", "neo_track_segment",
                      lambda o: (
                          _cuda.ptr(cmds), _cuda.ptr(st_packed),
                          _cuda.ptr(prims6), _cuda.ptr(o[0]),
                          _cuda.ptr(o[1]), B, prims6.shape[1], 60, 0,
                          track._params(pp, mp, sp), _cuda.stream_ptr(dev)),
                      [tout, trace], work)

    # ---- B1 (+B2): the first-lane L-BFGS solve of B problems. One
    # iteration must agree to roundoff (1e-3 relative on f). Over 24
    # iterations roundoff steers individual solves onto other iterate paths
    # — the plain version on the GPU and on the CPU spread the same way — so
    # the full solve is held to the same cost basin (see basin()).
    x0 = costs.pack(q0, minco.T_to_tau(ts0, pp.t_min, pp.t_max), pp)
    x0 = x0.contiguous()
    env_of = torch.arange(B, device=dev, dtype=torch.int32)
    skip = torch.zeros(B, dtype=torch.int32, device=dev)
    sol = (torch.empty_like(x0), torch.empty(B, device=dev),
           torch.empty(B, dtype=torch.int32, device=dev))

    def plain(p):
        return solve._solve_plain(x0, head, tail, sc, env_of.long(), p)

    pp1 = dataclasses.replace(pp, max_iters=1)
    solve.launch_solver(x0, head, tail, prims6, env_of, skip, sol, pp1)
    f1 = sol[1].clone()
    _, pf1, _ = plain(pp1)
    err1 = err_line(f1, pf1)
    solve.launch_solver(x0, head, tail, prims6, env_of, skip, sol, pp)
    it24 = sol[2].clone()
    px, pf, _ = plain(pp)
    ok_k = accepted(sol[0], head, tail, sc, pp)
    ok_p = accepted(px, head, tail, sc, pp)
    # the control: the same plain solver on the CPU, first 256 problems
    n_c = min(256, B)
    sc_cpu = scene.SceneMap(*(getattr(sc, f).cpu() for f in
                              ("centers", "half", "is_cyl", "active")))

    def plain_cpu(p):
        return solve._solve_plain(x0[:n_c].cpu(), head[:n_c].cpu(),
                                  tail[:n_c].cpu(), sc_cpu,
                                  torch.arange(n_c), p)[1]

    basin("lbfgs_scene_solve", ok_k, ok_p, sol[1], pf, sol[2],
          rel(pf1[:n_c].cpu(), plain_cpu(pp1)),
          rel(pf[:n_c].cpu(), plain_cpu(pp)), n_c)
    iters = sol[2].cpu().numpy().astype(np.float64)
    first_ms = median_ms(torch, lambda: solve.launch_solver(
        x0, head, tail, prims6, env_of, skip, sol, pp), 10)
    retry_launch("lbfgs_scene_solve", x0, head, tail, ok_k, first_ms,
                 lambda *a: solve.launch_solver(*a[:3], prims6, *a[3:],
                                                pp=pp))
    report("lbfgs_scene_solve", err1, 1e-3, first_ms,
           median_ms(torch, lambda: plain(pp), 3),
           solve_flops(pp.samples_per_piece, 20 * n_active, iters),
           B * (7 * 4 + 12 * 4 + 2 * 4 + 7 * 4 + 8) + B * 24 * 6 * 4,
           on="rel")

    lazy_bank("scene", sc, sc_cpu, head, tail, q0, ts0, it24, ok_k)

    # ---- B2s: the scene path's lazy bank at B = 1024 (3 lanes per env:
    # 3072 problems, 12,288 line-search candidates)
    lanes = 1 + pp.retry_num
    x_bank = (x0.repeat_interleave(lanes, 0) + torch.from_numpy(
        rng_eval.normal(scale=0.3, size=(B * lanes, 7))).float().to(dev)
    ).contiguous()
    env_bank = torch.arange(B, device=dev).repeat_interleave(lanes)
    objective_check("scene", "bank B=1024", sc, x_bank,
                    head.repeat_interleave(lanes, 0).contiguous(),
                    tail.repeat_interleave(lanes, 0).contiguous(), env_bank,
                    20 * n_active[env_bank.cpu().numpy()],
                    B * 24 * 6 * 4)
    per_eval_check("lbfgs_scene_solve", sc, x0, head, tail, env_of.long(),
                   solve.solve_scene, sc, pp)

    net = planner_net.load(onnx, npc, dev)
    net_cpu = planner_net.load(onnx, npc, "cpu")

    def twin_loops(n, seed, gen_world, map_params, path, pp_, seg_kw, cam_,
                   nets=None, first=None):
        """n envs, 2 segments, on the card and on the CPU from the same
        worlds, goals and draws; returns (CPU state, card state, segment 1
        planned count, segment 1 plan-flag agreement, per env whether the
        plan flags agreed in both segments). first, when given, receives
        segment 1's CPU and card SegmentInfo and the CPU worlds."""
        gen_c = _cuda.make_generator(seed, "cpu")
        w_c = gen_world(gen_c, n)
        w_g = type(w_c)(*(getattr(w_c, f).to(dev) for f in
                          ("centers", "half_sizes", "active", "shape")))
        s_c = env.reset(w_c, pp_, mp, map_params, gen_c, **path)
        s_g = env.reset(w_g, pp_, mp, map_params, _cuda.make_generator(seed),
                        goal=s_c.goal.to(dev), **path)
        s_g = s_g.replace(flap=s_c.flap.to(dev))
        for seg in range(2):
            d_c = env.draw(gen_c, n, pp_)
            d_g = env.Draws(*(x.to(dev) for x in (d_c.target_noise,
                                                  d_c.bank_noise,
                                                  d_c.goal_u)))
            s_c, i_c = env.step_segment(s_c, pp_, mp, sp, cam_,
                                        (nets or (net, net_cpu))[1],
                                        draws=d_c, **seg_kw)
            s_g, i_g = env.step_segment(s_g, pp_, mp, sp, cam_,
                                        (nets or (net, net_cpu))[0],
                                        draws=d_g, **seg_kw)
            agree = (i_g.ok.cpu() == i_c.ok) & (agree if seg else True)
            if seg == 0 and first is not None:
                first.update(cpu=i_c, card=i_g, worlds=w_c)
            if seg == 0:
                n_plan = int(i_c.planned.sum())
                flags = float((i_g.ok.cpu() == i_c.ok).float().mean())
        return s_c, s_g, n_plan, flags, agree

    def small_loop(name, n, seed, gen_world, map_params, path, pp_=pp,
                   twin=False, cam_=cam, path_kernels=(), nets=None,
                   **seg_kw):
        """Segment 1 plans every env while the drones hover on the reset
        buffer; segment 2 flies those plans. Gate: the plan flags of
        segment 1 agree on >= 90% of envs (and all plan), and every drone's
        position after segment 2 is within 1e-3 m of the CPU loop's. With
        twin, the same loop at one solver iteration is also held
        elementwise: drone states, setpoint buffers and metrics within 1e-3
        on the envs whose plan flags agree, and the log-odds grids within
        one update quantum on at most 1e-4 of the updated cells."""
        _cuda.reset_launches()
        s_c, s_g, n_plan, flags, _ = twin_loops(n, seed, gen_world,
                                                map_params, path, pp_, seg_kw,
                                                cam_, nets)
        counts = dict(_cuda.launches)
        diff = (s_g.drone.pos.cpu() - s_c.drone.pos).abs().amax(1)
        say(f"small {name} loop B={n}: segment 1 planned {n_plan}, plan flags "
            f"agree {flags:.3f} (tol 0.9); after segment 2 drone pos diff "
            f"max {float(diff.max()):.3g} m (tol 1e-3), moved "
            f"{float(s_c.drone.pos[:, :2].norm(dim=1).median()):.3g} m "
            f"(median)")
        if n_plan != n or flags < 0.9 or float(diff.max()) > 1e-3:
            raise AssertionError(f"the {name} loop on the card disagrees "
                                 f"with the plain path")
        if path_kernels:
            say(f"small {name} loop kernels on the card (reset and 2 "
                f"segments): " + ", ".join(f"{k} {counts[k]}"
                                           for k in path_kernels))
        for k in path_kernels:
            if counts[k] <= 0:
                raise AssertionError(f"the small {name} loop never launched "
                                     f"{k}")
            launch_totals[k] += counts[k]
        if not twin:
            return
        s_c, s_g, _, flags1, same = twin_loops(
            n, seed, gen_world, map_params, path,
            dataclasses.replace(pp_, max_iters=1), seg_kw, cam_, nets)
        if int(same.sum()) < 0.9 * n:
            raise AssertionError(f"the {name} one-iteration twin's plan "
                                 f"flags agree on {int(same.sum())} of {n}")
        worst = max(float((getattr(s_g, k).cpu() - getattr(s_c, k)).abs()
                          .flatten(1).amax(1)[same].max())
                    for k in ("buffer", "metrics"))
        worst = max(worst, *(float((getattr(s_g.drone, k).cpu()
                                    - getattr(s_c.drone, k)).abs().amax(1)
                                   [same].max())
                             for k in ("pos", "vel", "quat")))
        d_lo = (s_g.logodds.cpu() - s_c.logodds).abs()
        off = d_lo > 0
        quantum = float((d_lo[off][:, None] - l_quanta.abs()[None]).abs()
                        .amin(1).max()) if off.any() else 0.0
        n_upd = int((s_c.logodds != 0).sum())
        say(f"small {name} twin (1 iteration): plan flags agree {flags1:.3f}"
            f" (tol 0.9); state, buffer, metrics max diff {worst:.3g} (tol "
            f"1e-3); log-odds {int(off.sum())} of {n_upd} updated cells "
            f"differ (tol 1e-4 of them, each by one quantum)")
        if flags1 < 0.9 or worst > 1e-3 or quantum > 1e-5 \
                or int(off.sum()) > 1e-4 * n_upd:
            raise AssertionError(f"the {name} one-iteration twin on the card "
                                 f"disagrees with the plain path")

    def run_path(name, path_kernels, n, make_state, n_seg=SEGMENTS, pp_=pp,
                 per_segment=None, at_reset=None, absent=(), net_=None,
                 cam_=None, stats=None, **seg_kw):
        """The loop of the path that reset chose: counts set to 0, the
        state made by make_state() (the reset), one warm-up and n_seg timed
        segments stepped with seg_kw, counts read. For the kernels in
        per_segment and at_reset the counts are held to exactly that many
        launches per segment plus that many at the reset, the kernels in
        absent to none; returns (state, planned replans in the timed
        segments). stats, when given, receives the timed segments' ms a
        segment and, over the warm-up and the timed segments, replans ok
        and planned, L-BFGS iterations a plan and the accepted plans' mean
        duration (s)."""
        net_, cam_ = net_ or net, cam_ or cam
        _cuda.reset_launches()
        state = make_state()
        state, info = env.step_segment(state, pp_, mp, sp, cam_, net_,
                                       **seg_kw)
        warm = (int(info.planned.sum()), int(info.ok.sum()))
        iters = (info.iters * info.planned).sum()
        dur = (info.ts.sum(1) * info.ok).sum()
        planned, accepted_plans = 0, 0
        torch.cuda.synchronize()
        timer = StageTimer()
        t0 = time.perf_counter()
        for _ in range(n_seg):
            state, info = env.step_segment(state, pp_, mp, sp, cam_, net_,
                                           timer=timer, **seg_kw)
            planned = planned + info.planned.sum()
            accepted_plans = accepted_plans + info.ok.sum()
            iters = iters + (info.iters * info.planned).sum()
            dur = dur + (info.ts.sum(1) * info.ok).sum()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if stats is not None:
            n_plans = warm[0] + int(planned)
            stats.update(ms_segment=secs * 1e3 / n_seg,
                         ok=warm[1] + int(accepted_plans), planned=n_plans,
                         iters=int(iters) / max(n_plans, 1),
                         duration=float(dur) / max(warm[1]
                                                   + int(accepted_plans), 1),
                         timed_planned=int(planned))
        counts = dict(_cuda.launches)
        stages = timer.ms()
        per_segment, at_reset = per_segment or {}, at_reset or {}
        say(f"{name} loop B={n}: "
            f"{n * mp.steps_per_replan * n_seg / secs:.0f} steps/s "
            f"({secs * 1e3 / n_seg:.1f} ms/segment), missions done "
            f"{int(state.missions_done.sum())} ok "
            f"{int(state.missions_ok.sum())}, live replans ok "
            f"{int(accepted_plans)}/{int(planned)} in the timed segments, "
            f"{warm[1]}/{warm[0]} in the warm-up")
        say(f"{name} stages ms/segment: " + ", ".join(
            f"{k} {v / n_seg:.2f}" for k, v in stages.items()))
        say(f"{name} kernels (reset and {n_seg + 1} segments): " + ", ".join(
            f"{k} {counts[k]} ({at_reset.get(k, 0)} at reset, "
            f"{(counts[k] - at_reset.get(k, 0)) / (n_seg + 1):g}/segment)"
            for k in path_kernels))
        for k in path_kernels:
            if counts[k] <= 0:
                raise AssertionError(f"the {name} path never launched {k}")
            if k in per_segment or k in at_reset:
                want = per_segment.get(k, 0) * (n_seg + 1) + at_reset.get(k, 0)
                if counts[k] != want:
                    raise AssertionError(
                        f"the {name} path launched {k} {counts[k]} times, "
                        f"expected {per_segment.get(k, 0)} per segment and "
                        f"{at_reset.get(k, 0)} at the reset")
            launch_totals[k] += counts[k]
        for k in absent:
            if counts[k] != 0:
                raise AssertionError(f"the {name} path launched {k}")
        finite = all(bool(torch.isfinite(t).all()) for t in (
            state.drone.pos, state.drone.vel, state.drone.quat, state.buffer,
            state.metrics))
        if not finite or state.buffer.shape != (n, env.n_buffer(pp_, mp), 3,
                                                2):
            raise AssertionError(f"the {name} loop produced non-finite state")
        return state, int(planned)

    small_loop("scene", 32, 5, lambda g, n: scenegen.generate_batch(g, n, wp),
               mapp, {})
    run_path("scene", SCENE_PATH, B,
             lambda: env.reset(worlds, pp, mp, mapp, _cuda.make_generator(2)))

    # ================= the vision path: its kernels at B = BV =============
    worlds_v = scenegen.generate_batch(_cuda.make_generator(10), BV, wp)
    thr = occupancy.occ_threshold(mapp_v)
    l_quanta = torch.tensor([occupancy._l(mapp_v.prob_miss),
                             occupancy._l(mapp_v.prob_hit)])

    # ---- B8 v2: two frames per env fused into an unknown grid
    prims8_v = raycast.pack_prims(worlds_v)
    lo = occupancy.logodds_init(mapp_v, BV, dev)
    frames_v = []
    for _ in range(2):
        pos_v, quat_v = poses(BV)
        depth_v = raycast.render_depth_auto(worlds_v, pos_v, quat_v, cam)
        frames_v.append((depth_v, pos_v, quat_v))
    worst, n_off, n_upd, n_carve_off = 0.0, 0, 0, 0
    for depth_v, pos_v, quat_v in frames_v:
        tabs, sc8, hit = fusion._inputs(depth_v, pos_v, quat_v, cam, mapp_v)
        out_k = torch.empty_like(lo)
        # the carve alone (no hit cells), then carve and hits
        no_hit = torch.full_like(hit, -1)
        fusion.launch_fuse(lo, tabs, sc8, no_hit, out_k, cam, mapp_v)
        n_carve_off += int((out_k != fusion._fuse_plain(
            lo, tabs, sc8, no_hit, cam, mapp_v)).sum())
        fusion.launch_fuse(lo, tabs, sc8, hit, out_k, cam, mapp_v)
        want = fusion._fuse_plain(lo, tabs, sc8, hit, cam, mapp_v)
        d = (out_k - want).abs()
        off = d > 0
        if off.any():
            q = (d[off].cpu()[:, None] - l_quanta.abs()[None]).abs().amin(1)
            if float(q.max()) > 1e-5:
                idx = torch.nonzero(off.flatten())[:8, 0]
                is_hit = torch.isin(idx, hit.flatten())
                say("fuse_depth_dense: cells (flat index, before, kernel, "
                    "plain, hit cell): " + "; ".join(
                        f"{int(i)} {float(lo.flatten()[i]):.6g} "
                        f"{float(out_k.flatten()[i]):.6g} "
                        f"{float(want.flatten()[i]):.6g} {bool(h)}"
                        for i, h in zip(idx, is_hit)))
                raise AssertionError("fuse_depth_dense: a cell differs by "
                                     "more than one update quantum")
        worst = max(worst, float(d.max()))
        n_off += int(off.sum())
        n_upd += int((want != lo).sum())
        lo = out_k
    say(f"fuse_depth_dense: {n_off} of {n_upd} updated cells differ, each "
        f"by one l_miss/l_hit quantum (tol 1e-4 of the updated cells); the "
        f"carve alone: {n_carve_off} cells differ")
    tabs, sc8, hit = fusion._inputs(*frames_v[1], cam, mapp_v)
    lo_in = lo.clone()
    H, W = mapp_v.height, mapp_v.width
    work_v2 = (BV * H * W * 25 + BV * cam.width * 3,
               BV * (2 * H * W * 4 + cam.width * (4 + 8) + 8 * 4))
    report("fuse_depth_dense", (worst, n_off / max(n_upd, 1)), 1e-4,
           median_ms(torch, lambda: fusion.launch_fuse(
               lo_in, tabs, sc8, hit, out_k, cam, mapp_v), 20),
           median_ms(torch, lambda: fusion._fuse_plain(
               lo_in, tabs, sc8, hit, cam, mapp_v), 5),
           *work_v2, on="rel")

    def kept_share(name, label, tabs_, sc_, mp_):
        """The share of tile-frames and of the warps' strip-frames that
        the frames' cameras reach (fusion.tile_reach)."""
        line = []
        for th, tw in ((fusion.TILE_H, fusion.TILE_W),
                       (fusion.WARP_H, fusion.WARP_W)):
            keep = fusion.tile_reach(tabs_, sc_, cam, mp_, (th, tw))
            line.append(f"{int(keep.sum())} of {keep.numel()} {th} x {tw} "
                        f"({float(keep.float().mean()):.4f})")
        say(f"{name} {label}: the cameras reach " + ", ".join(line)
            + " tile-frames (fusion.tile_reach)")
    kept_share("fuse_depth_dense", f"replan frame B={BV}", tabs, sc8, mapp_v)
    if other is not None:
        entry_against("fuse_depth_dense", f"replan frame B={BV}",
                      "neo_fuse_depth_dense", lambda o: (
                          _cuda.ptr(lo_in), _cuda.ptr(tabs), _cuda.ptr(sc8),
                          _cuda.ptr(hit), _cuda.ptr(o[0]), BV, H, W,
                          cam.width,
                          _cuda.host_floats(fusion._params(cam, mapp_v)),
                          _cuda.stream_ptr(dev)),
                      [out_k], work_v2)

    # ---- B9: the truncated ESDF of the fused grids, and of random ones
    lo_rand = torch.from_numpy(rng.uniform(-2.0, 2.0, (64, H, W))).float(
        ).to(dev)
    n_diff = 0
    for grid in (lo, lo_rand):
        field = torch.empty(grid.shape, dtype=torch.bfloat16, device=dev)
        edt.launch_edt(grid, field, thr, mapp_v.resolution,
                       mapp_v.edt_truncation)
        want = edt.edt_truncated(grid > thr, mapp_v.resolution,
                                 mapp_v.edt_truncation).to(torch.bfloat16)
        n_diff += int((field != want).sum())
    field = torch.empty(lo.shape, dtype=torch.bfloat16, device=dev)
    report("edt_trunc_lite", (float(n_diff), float(n_diff)), 0.0,
           median_ms(torch, lambda: edt.launch_edt(
               lo, field, thr, mapp_v.resolution, mapp_v.edt_truncation), 20),
           median_ms(torch, lambda: edt.edt_truncated(
               lo > thr, mapp_v.resolution, mapp_v.edt_truncation).to(
               torch.bfloat16), 5),
           lo.numel() * EDT_CELL_OPS, lo.numel() * (4 + 2))
    say(f"edt_trunc_lite: {n_diff} cells differ over {BV + 64} grids "
        f"(tol 0: bit-exact)")
    if other is not None:
        edt_against("edt_trunc_lite", "vision grids B=512", lo,
                    torch.bfloat16, (edt.radius_cells(
                        mapp_v.edt_truncation, mapp_v.resolution),),
                    [thr, mapp_v.resolution, mapp_v.edt_truncation])

    # ---- B6 (+B2): first-lane solves on windows of the rebuilt maps
    emap = esdf.ESDFMap(esdf=field, origin=torch.tensor(
        [mapp_v.origin_x, mapp_v.origin_y], device=dev),
        resolution=mapp_v.resolution)
    emap_cpu = emap.replace(esdf=emap.esdf.cpu(), origin=emap.origin.cpu())
    # problems start at the fused frames' first poses and run 5 m ahead,
    # across what those frames sensed
    head_v, tail_v, q0_v, ts0_v = boundary_problems(BV,
                                                    frames_v[0][1][:, :2])
    window = expert.make_plan_window(emap, head_v, tail_v, pp)
    x0_v = costs.pack(q0_v, minco.T_to_tau(ts0_v, pp.t_min, pp.t_max),
                      pp).contiguous()
    envs_v = torch.arange(BV, device=dev, dtype=torch.int32)
    skip_v = torch.zeros(BV, dtype=torch.int32, device=dev)
    sol_v = (torch.empty_like(x0_v), torch.empty(BV, device=dev),
             torch.empty(BV, dtype=torch.int32, device=dev))
    grid_args = (x0_v, head_v, tail_v, window.win, window.worg, envs_v,
                 skip_v, sol_v)

    def plain_grid(p, n=BV, on=dev):
        w = esdf.GridWindow(window.win[:n].to(on), window.worg[:n].to(on))
        return solve._solve_plain(x0_v[:n].to(on), head_v[:n].to(on),
                                  tail_v[:n].to(on), w,
                                  torch.arange(n, device=on), p)

    solve.launch_grid_solver(*grid_args, pp=pp1)
    f1_v = sol_v[1].clone()
    _, pf1_v, _ = plain_grid(pp1)
    err1_v = err_line(f1_v, pf1_v)
    solve.launch_grid_solver(*grid_args, pp=pp)
    it24_v = sol_v[2].clone()
    px_v, pf_v, _ = plain_grid(pp)
    near_pp = dataclasses.replace(pp, esdf_interp="nearest")
    ok_kv = accepted(sol_v[0], head_v, tail_v, emap, near_pp)
    ok_pv = accepted(px_v, head_v, tail_v, emap, near_pp)
    n_cv = min(256, BV)
    basin("lbfgs_grid_solve", ok_kv, ok_pv, sol_v[1], pf_v, sol_v[2],
          rel(pf1_v[:n_cv].cpu(), plain_grid(pp1, n_cv, "cpu")[1]),
          rel(pf_v[:n_cv].cpu(), plain_grid(pp, n_cv, "cpu")[1]), n_cv)
    iters_v = sol_v[2].cpu().numpy().astype(np.float64)
    first_ms_v = median_ms(torch, lambda: solve.launch_grid_solver(
        *grid_args, pp=pp), 10)
    retry_launch("lbfgs_grid_solve", x0_v, head_v, tail_v, ok_kv,
                 first_ms_v,
                 lambda *a: solve.launch_grid_solver(
                     *a[:3], window.win, window.worg, *a[3:], pp=pp))
    report("lbfgs_grid_solve", err1_v, 1e-3, first_ms_v,
           median_ms(torch, lambda: plain_grid(pp), 3),
           solve_flops(pp.samples_per_piece, 25, iters_v),
           BV * (7 * 4 + 12 * 4 + 2 * 4 + 7 * 4 + 8)
           + window.worg.numel() * 4
           + 4 * window_cells_read(window, (x0_v, sol_v[0]), head_v,
                                 tail_v),
           on="rel")
    lazy_bank("grid", emap, emap_cpu, head_v, tail_v, q0_v, ts0_v, it24_v,
              ok_kv)

    # ---- B7: the vision path's lazy bank on the same windows (3 lanes per
    # env: 1536 problems, 6144 candidates); the third lane of every 8th env
    # ends 12 m ahead (beyond its window), of every 8th + 4 beyond the map
    x_bank = x0_v.repeat_interleave(lanes, 0).clone()
    head_b = head_v.repeat_interleave(lanes, 0).clone()
    tail_b = tail_v.repeat_interleave(lanes, 0).clone()
    far = torch.arange(BV * lanes, device=dev)
    far_win = far[(far % lanes == 2) & ((far // lanes) % 8 == 0)]
    far_map = far[(far % lanes == 2) & ((far // lanes) % 8 == 4)]
    tail_b[far_win, 0] = head_b[far_win, 0] + torch.tensor([12.0, 0.0],
                                                           device=dev)
    tail_b[far_map, 0] = torch.tensor([24.0, 0.0], device=dev)
    x_bank[:, :4] = expert.straight_line_wpts(
        head_b[:, 0], tail_b[:, 0], pp).reshape(-1, 4)
    x_bank = (x_bank + torch.from_numpy(rng_eval.normal(
        scale=0.2, size=(BV * lanes, 7))).float().to(dev)).contiguous()
    env_bank_v = torch.arange(BV, device=dev).repeat_interleave(lanes)
    objective_check("grid", "vision windows B=512", window, x_bank, head_b,
                    tail_b, env_bank_v, np.full(BV * lanes, 25.0),
                    4 * window_cells_read(
                        esdf.GridWindow(window.win[env_bank_v],
                                        window.worg[env_bank_v]),
                        (x_bank,), head_b, tail_b)
                    + window.worg.numel() * 4)
    per_eval_check("lbfgs_grid_solve", window, x0_v, head_v, tail_v,
                   envs_v.long(), solve.solve_grid, emap, near_pp)

    # ---- B10: one grid tracking segment of BV envs on the sensed maps
    st_v = env.reset(worlds_v, pp, mp, mapp_v, _cuda.make_generator(11),
                     **vision)
    st_v, cmds_v = track_inputs(BV, st_v.replace(emap=emap))
    stv_packed = track.pack_state(st_v)
    gout = torch.empty((BV, 18), device=dev)
    gtrace = torch.empty((BV, 60, 5, 3), device=dev)
    gticks = torch.empty((BV, 60), device=dev)
    track.launch_tracker_grid(cmds_v, stv_packed, gout, gtrace, gticks, pp,
                              mp, sp)
    wd, wreach, wsteps, wmet, wmpos, wtrace, wticks = \
        track._track_grid_plain(st_v, cmds_v, pp, mp, sp)
    want = torch.cat([wd.pos, wd.vel, wd.yaw[:, None], wd.quat, wmpos, wmet,
                      wreach[:, None].float(), wsteps[:, None].float()], 1)
    err = max(err_line(gout, want), err_line(gtrace, wtrace),
              err_line(gticks, wticks))
    def grid_work(spr_):
        return (BV * spr_ * 200,
                BV * (spr_ * 6 + 22 + 18 + spr_ * 15 + spr_) * 4)
    report("track_segment_grid", err, 1e-3,
           median_ms(torch, lambda: track.launch_tracker_grid(
               cmds_v, stv_packed, gout, gtrace, gticks, pp, mp, sp), 20),
           median_ms(torch, lambda: track._track_grid_plain(
               st_v, cmds_v, pp, mp, sp), 5), *grid_work(60))
    if other is not None:
        def grid_fill(c_, spr_, i0_):
            return lambda o: (
                _cuda.ptr(c_), _cuda.ptr(stv_packed), _cuda.ptr(o[0]),
                _cuda.ptr(o[1]), _cuda.ptr(o[2]), BV, spr_, i0_,
                track._params(pp, mp, sp), _cuda.stream_ptr(dev))
        entry_against("track_segment_grid", "spr=60 B=512",
                      "neo_track_segment_grid", grid_fill(cmds_v, 60, 0),
                      [gout, gtrace, gticks], grid_work(60))
        cmds_c = cmds_v[:, 30:40].contiguous()
        c_outs = (torch.empty_like(gout), torch.empty((BV, 10, 5, 3),
                                                      device=dev),
                  torch.empty((BV, 10), device=dev))
        track.launch_tracker_grid(cmds_c, stv_packed, *c_outs, pp, mp, sp,
                                  i0=30)
        entry_against("track_segment_grid", "10-substep chunk i0=30 B=512",
                      "neo_track_segment_grid", grid_fill(cmds_c, 10, 30),
                      c_outs, grid_work(10))

    # ---- the vision loops (one fused frame per segment)
    small_loop("vision", 16, 6, lambda g, n: scenegen.generate_batch(g, n, wp),
               mapp_v, vision)
    goals_v = torch.stack([torch.full((BV,), 20.0), torch.from_numpy(
        rng.uniform(-1.5, 1.5, BV)).float()], 1).to(dev)
    state_v, planned_v = run_path(
        "vision", VISION_PATH, BV, lambda: env.reset(
            worlds_v, pp, mp, mapp_v, _cuda.make_generator(12),
            goal=goals_v, **vision), n_seg=2, at_reset=dict(edt_banded=1))
    if planned_v <= 0:
        raise AssertionError("the vision path's timed segments replanned "
                             "no env")

    # ================= the sensor-rate path (profile_vision's defaults) ====
    pp_s = dataclasses.replace(pp, esdf_interp="mxu")
    mapp_s = dataclasses.replace(mapp_v, fusion_row_stride=4)
    sensor = dict(fuse_frames=FUSE_FRAMES)
    F5, RS = FUSE_FRAMES - 1, mapp_s.fusion_row_stride

    # grids fused for three sensor-rate segments, then five poses per env
    # along the next segment's tracked chunks
    st_s = env.reset(worlds_v, pp_s, mp, mapp_s, _cuda.make_generator(13),
                     goal=goals_v, **vision)
    for _ in range(3):
        st_s, _ = env.step_segment(st_s, pp_s, mp, sp, cam, net, **sensor)
    chunk = mp.steps_per_replan // FUSE_FRAMES
    s_c, pos5, quat5 = st_s, [], []
    for c in range(F5):
        drone, reached, steps, metrics, metric_pos, _ = \
            track.track_segment_grid(s_c, st_s.buffer[:, c * chunk:(c + 1)
                                                      * chunk], pp_s, mp, sp,
                                     i0=c * chunk)
        s_c = s_c.replace(drone=drone, reached=reached, steps=steps,
                          metrics=metrics, metric_pos=metric_pos)
        pos5.append(drone.pos)
        quat5.append(drone.quat)
    pos5 = torch.stack(pos5, 1).contiguous()
    quat5 = torch.stack(quat5, 1).contiguous()

    # ---- B4 at row stride 4: the 5 x BV poses in one launch
    depth5 = raycast.render_depth_auto(worlds_v, pos5, quat5, cam,
                                       row_stride=RS)
    want = raycast.render_depth(worlds_v, pos5, quat5, cam, row_stride=RS)
    frac_off = float(((depth5 - want).abs() > 1e-3).float().mean())
    ms_s = median_ms(torch, lambda: raycast.render_depth_auto(
        worlds_v, pos5, quat5, cam, row_stride=RS), 20)
    kept = raycast.tile_cull(worlds_v, pos5, quat5, cam, RS)
    work_s = render_work(kept, depth5.shape[2], cam.width,
                         worlds_v.active.shape[1],
                         (raycast.TILE_H, raycast.TILE_W))
    say(f"render_depth row stride {RS}: "
        f"{float(kept.sum(-1).float().mean()):.3f} primitives a tile "
        f"survive the cull ({tuple(kept.shape[2:4])} tiles a frame); bound "
        f"{bound(*work_s)[0]:.4f} ms ({bound(*work_s)[1]})")
    say(f"render_depth row stride {RS}, {BV} x {F5} poses: shape "
        f"{tuple(depth5.shape)}, {frac_off:.2e} of pixels off by > 1e-3 m "
        f"(tol 1e-3), max abs {float((depth5 - want).abs().max()):.3g}; "
        f"{ms_s:.3f} ms")
    if frac_off > 1e-3:
        raise AssertionError("render_depth at row stride 4 disagrees with "
                             "its plain version")
    if other is not None:
        prims_v8 = raycast.pack_prims(worlds_v)
        entry_against("render_depth", f"row stride {RS}, {BV} x {F5} poses",
                      "neo_render_depth", lambda o: (
                          _cuda.ptr(pos5), _cuda.ptr(quat5),
                          _cuda.ptr(prims_v8), _cuda.ptr(o[0]), BV * F5, F5,
                          prims_v8.shape[1], cam.width, depth5.shape[2], RS,
                          cam_params, _cuda.stream_ptr(dev)),
                      [depth5], work_s)

    # ---- B8 v3: the five frames onto the fused grids, one clip per frame
    lo_s = st_s.logodds.contiguous()
    tabs5, sc5, hit5 = fusion._multi_inputs(depth5, pos5, quat5, cam, mapp_s,
                                            RS)
    out5 = torch.empty_like(lo_s)
    fusion.launch_fuse_multi(lo_s, tabs5, sc5, hit5, out5, cam, mapp_s)
    want = fusion._fuse_multi_plain(lo_s, tabs5, sc5, hit5, cam, mapp_s)
    d = (out5 - want).abs()
    off = d > 0
    n_upd = int((want != lo_s).sum())
    l_min = torch.tensor(occupancy._l(mapp_s.clamp_min))
    n_at_min = int((want == l_min.to(dev)).sum())
    say(f"fuse_depth_multi: {int(off.sum())} of {n_upd} updated cells differ "
        f"(0 expected; tol 1e-4 of them, each by one quantum); {n_at_min} "
        f"cells at the lower clamp bound")
    if off.any():
        q = (d[off].cpu()[:, None] - l_quanta.abs()[None]).abs().amin(1)
        if float(q.max()) > 1e-5 or int(off.sum()) > 1e-4 * n_upd:
            idx = torch.nonzero(off.flatten())[:8, 0]
            say("fuse_depth_multi: cells (flat index, before, kernel, plain): "
                + "; ".join(f"{int(i)} {float(lo_s.flatten()[i]):.6g} "
                            f"{float(out5.flatten()[i]):.6g} "
                            f"{float(want.flatten()[i]):.6g}" for i in idx))
            raise AssertionError("fuse_depth_multi disagrees with its plain "
                                 "version")
    if n_at_min == 0:
        raise AssertionError("the B8 v3 check never reached a clamp bound")
    w = cam.width
    work_v3 = (BV * F5 * H * W * 25,
               BV * (2 * H * W * 4 + F5 * (w * (4 + 4) + 8 * 4)))
    report("fuse_depth_multi", (float(d.max()), int(off.sum()) / max(n_upd,
                                                                     1)),
           1e-4,
           median_ms(torch, lambda: fusion.launch_fuse_multi(
               lo_s, tabs5, sc5, hit5, out5, cam, mapp_s), 20),
           median_ms(torch, lambda: fusion._fuse_multi_plain(
               lo_s, tabs5, sc5, hit5, cam, mapp_s), 5),
           *work_v3, on="rel")
    kept_share("fuse_depth_multi", f"{F5} frames at row stride {RS} B={BV}",
               tabs5, sc5, mapp_s)
    if other is not None:
        entry_against("fuse_depth_multi",
                      f"{F5} frames at row stride {RS} B={BV}",
                      "neo_fuse_depth_multi", lambda o: (
                          _cuda.ptr(lo_s), _cuda.ptr(tabs5), _cuda.ptr(sc5),
                          _cuda.ptr(hit5), _cuda.ptr(o[0]), BV, F5, H, W, w,
                          _cuda.host_floats(fusion._params(cam, mapp_s)),
                          _cuda.stream_ptr(dev)), [out5], work_v3)
    # the yardstick inside the port: the same frames as F5 B8 v2 launches
    envs = torch.arange(BV, device=dev)[:, None] * (H * W)
    v2_in = [(tabs5[:, f].contiguous(), sc5[:, f].contiguous(),
              torch.where(hit5[:, f] >= 0, hit5[:, f].long() + envs, -1))
             for f in range(F5)]

    def chained_v2():
        for t, c, h in v2_in:
            fusion.launch_fuse(lo_s, t, c, h, out_k, cam, mapp_s)

    say(f"fuse_depth_multi: {F5} frames in one launch; the same frames as "
        f"{F5} B8 v2 launches: {median_ms(torch, chained_v2, 10):.3f} ms")

    # ---- B3 and B10 from substep 30
    cmds30 = cmds[:, 30:].contiguous()
    tout30 = torch.empty((B, 18), device=dev)
    trace30 = torch.empty((B, 30, 5, 3), device=dev)
    track.launch_tracker(cmds30, st_packed, prims6, tout30, trace30, pp, mp,
                         sp, i0=30)
    wd, wreach, wsteps, wmet, wmpos, wtrace = track._track_plain(
        st, cmds30, pp, mp, sp, i0=30)
    want = torch.cat([wd.pos, wd.vel, wd.yaw[:, None], wd.quat, wmpos, wmet,
                      wreach[:, None].float(), wsteps[:, None].float()], 1)
    err3 = max(err_line(tout30, want), err_line(trace30, wtrace))
    cmds_v30 = cmds_v[:, 30:].contiguous()
    gout30 = torch.empty((BV, 18), device=dev)
    gtrace30 = torch.empty((BV, 30, 5, 3), device=dev)
    gticks30 = torch.empty((BV, 30), device=dev)
    track.launch_tracker_grid(cmds_v30, stv_packed, gout30, gtrace30,
                              gticks30, pp, mp, sp, i0=30)
    wd, wreach, wsteps, wmet, wmpos, wtrace, wticks = \
        track._track_grid_plain(st_v, cmds_v30, pp, mp, sp, i0=30)
    want = torch.cat([wd.pos, wd.vel, wd.yaw[:, None], wd.quat, wmpos, wmet,
                      wreach[:, None].float(), wsteps[:, None].float()], 1)
    err10 = max(err_line(gout30, want), err_line(gtrace30, wtrace),
                err_line(gticks30, wticks))
    say(f"track_segment i0=30: max abs {err3[0]:.3g}; track_segment_grid "
        f"i0=30: max abs {err10[0]:.3g}, ticks {int(wticks.sum())} (tol "
        f"1e-3)")
    if err3[0] > 1e-3 or err10[0] > 1e-3 or int(wticks.sum()) == 0:
        raise AssertionError("a tracker from substep 30 disagrees with its "
                             "plain version")

    # ---- the sensor-rate loops
    small_loop("sensor-rate", 16, 7,
               lambda g, n: scenegen.generate_batch(g, n, wp), mapp_s,
               vision, pp_=pp_s, twin=True, **sensor)
    state_s, planned_s = run_path(
        "sensor-rate", SENSOR_PATH, BV, lambda: env.reset(
            worlds_v, pp_s, mp, mapp_s, _cuda.make_generator(14),
            goal=goals_v, **vision), pp_=pp_s,
        per_segment=SENSOR_PER_SEGMENT, at_reset=dict(edt_banded=1),
        **sensor)
    if planned_s <= 0:
        raise AssertionError("the sensor-rate path's timed segments "
                             "replanned no env")
    say(f"sensor-rate map: {int((state_s.logodds > thr).sum()) / BV:.0f} "
        f"occupied and {int((state_s.logodds < 0).sum()) / BV:.0f} free "
        f"cells per env (mean); vision path's {int((state_v.logodds < 0).sum()) / BV:.0f} "
        f"free; total {time.perf_counter() - t_start:.1f} s")

    # ================= the reference's default maps (MapParams()) =========
    # examples/demo.py: MapParams() (448 x 256 cells, fusion '2d', the exact
    # ESDF) and CameraParams(160, 120); the gt+grid path is the JAX
    # package's reset default (sensing='gt', plan_map='grid')
    mapp_d = MapParams()
    H_d, W_d = mapp_d.height, mapp_d.width
    gt_grid = dict(sensing="gt", plan_map="grid")
    cam4 = dataclasses.replace(cam, max_range=4.0)   # v1's window fits

    # ---- (a) B9 exact at B = BV: ground-truth grids of BV worlds, and grids
    # fused by the '2d' fusion from two frames per env
    occ_gt = voxelize.occupancy_2d(worlds_v, mapp_d)
    lo_d = occupancy.logodds_init(mapp_d, BV, dev)
    for _ in range(2):
        pos_d, quat_d = poses(BV)
        depth_d = raycast.render_depth_auto(worlds_v, pos_d, quat_d, cam)
        lo_d = occupancy.insert_depth_2d(lo_d, depth_d, pos_d, quat_d, cam,
                                         mapp_d)
    occ_fused = occupancy.to_occupancy(lo_d, mapp_d)
    say(f"default map grids: {float(occ_gt.sum()) / BV:.0f} ground-truth and "
        f"{float(occ_fused.sum()) / BV:.0f} fused occupied cells per env "
        f"(mean), {int((lo_d < 0).sum()) / BV:.0f} fused free")
    field_x = torch.empty(occ_gt.shape, device=dev)
    n_diff = 0
    for grid in (occ_gt, occ_fused):
        edt.launch_edt_exact(grid, field_x, 0.5, mapp_d.resolution)
        n_diff += int((field_x != edt._edt_plain(
            grid, mapp_d.resolution)).sum())
    say(f"edt_exact: {n_diff} cells differ over 2 x {BV} grids (0 expected; "
        f"tol 0: bit-exact)")
    report("edt_exact", (float(n_diff), float(n_diff)), 0.0,
           median_ms(torch, lambda: edt.launch_edt_exact(
               occ_gt, field_x, 0.5, mapp_d.resolution), 20),
           median_ms(torch, lambda: edt._edt_plain(
               occ_gt, mapp_d.resolution), 3),
           occ_gt.numel() * EDT_CELL_OPS, occ_gt.numel() * (4 + 4))
    ms_fused = median_ms(torch, lambda: edt.launch_edt_exact(
        occ_fused, field_x, 0.5, mapp_d.resolution), 20)
    say(f"edt_exact on the fused grids: {ms_fused:.3f} ms")
    if other is not None:
        for label, grid in (("ground-truth grids", occ_gt),
                            ("fused grids", occ_fused)):
            edt_against("edt_exact", f"{label} B=512", grid, torch.float32,
                        (), [0.5, mapp_d.resolution, edt.FAR])

    # ---- B7 on windows of the gt+grid path's full-profile maps: BV
    # problems from the origin, every 8th ending 12 m ahead (beyond its
    # window), every 8th + 4 beyond the map's edge at y = 12.8
    emap_gt = esdf.build(occ_gt, (mapp_d.origin_x, mapp_d.origin_y),
                         mapp_d.resolution)
    head_g, tail_g, q0_g, ts0_g = boundary_problems(BV, gen=rng_eval)
    idx = torch.arange(BV, device=dev)
    tail_g[idx % 8 == 0, 0] = head_g[idx % 8 == 0, 0] + torch.tensor(
        [12.0, 0.0], device=dev)
    tail_g[idx % 8 == 4, 0] = head_g[idx % 8 == 4, 0] + torch.tensor(
        [2.0, 14.0], device=dev)
    window_g = expert.make_plan_window(emap_gt, head_g, tail_g, pp)
    q0_g = expert.straight_line_wpts(head_g[:, 0], tail_g[:, 0], pp) + \
        torch.from_numpy(rng_eval.normal(scale=0.4, size=(BV, 2, 2))).float(
            ).to(
            dev)
    x0_g = costs.pack(q0_g, minco.T_to_tau(ts0_g, pp.t_min, pp.t_max),
                      pp).contiguous()
    objective_check("grid", "gt+grid windows B=512", window_g, x0_g, head_g,
                    tail_g, idx, None, 0, record_it=False)

    # ---- (b) B9 banded on the same grids at edt_truncation = 2.0 (R = 20)
    field_b = torch.empty(occ_gt.shape, device=dev)
    n_diff = 0
    for grid in (occ_gt, occ_fused):
        edt.launch_edt_banded(grid, field_b, 0.5, mapp_d.resolution, 2.0)
        n_diff += int((field_b != edt._truncated_plain(
            grid > 0.5, mapp_d.resolution, 2.0)).sum())
    say(f"edt_banded: {n_diff} cells differ over 2 x {BV} grids (0 expected; "
        f"tol 0: bit-exact)")
    report("edt_banded", (float(n_diff), float(n_diff)), 0.0,
           median_ms(torch, lambda: edt.launch_edt_banded(
               occ_gt, field_b, 0.5, mapp_d.resolution, 2.0), 20),
           median_ms(torch, lambda: edt._truncated_plain(
               occ_gt > 0.5, mapp_d.resolution, 2.0), 3),
           occ_gt.numel() * EDT_CELL_OPS, occ_gt.numel() * (4 + 4))
    if other is not None:
        for label, grid in (("ground-truth grids", occ_gt),
                            ("fused grids", occ_fused)):
            edt_against("edt_banded", f"{label} B=512", grid, torch.float32,
                        (edt.radius_cells(2.0, mapp_d.resolution),),
                        [0.5, mapp_d.resolution, 2.0])

    # ---- (c) B8 v1 at B = BV: the default map with the 4 m camera (114-cell
    # windows that follow the drones; every 8th drone by the map's corner,
    # where its window clamps), and a 120 x 96 map with the 6 m camera
    mapp_w = dataclasses.replace(mapp_d, fusion="2d_dense")
    mapp_s96 = MapParams(width=120, height=96, origin_x=-2.0, origin_y=-4.8,
                         fusion="2d_dense")
    win_rows = []
    for label, mpw, camw, shift in (("default map, 4 m camera", mapp_w, cam4,
                                     0.0),
                                    ("120 x 96 map, 6 m camera", mapp_s96,
                                     cam, 3.0)):
        wv = worlds_v.replace(centers=worlds_v.centers - torch.tensor(
            [shift, 0.0, 0.0], device=dev))
        lo_w = occupancy.logodds_init(mpw, BV, dev)
        n_off, n_upd, worst = 0, 0, 0.0
        for f in range(3):
            pos_w, quat_w = poses(BV)
            if mpw.width > 200:
                pos_w[::8, :2] = torch.tensor([-7.0, -11.5], device=dev)
            depth_w = raycast.render_depth_auto(wv, pos_w, quat_w, camw)
            tabs, sc8, hit = fusion._inputs(depth_w, pos_w, quat_w, camw, mpw)
            sc_w, org = fusion._window_inputs(sc8, pos_w, camw, mpw)
            out_w = lo_w.clone()
            fusion.launch_fuse_window(out_w, tabs, sc_w, org, hit, camw, mpw)
            want = fusion._fuse_window_plain(lo_w, tabs, sc_w, org, hit, camw,
                                             mpw)
            d = (out_w - want).abs()
            off = d > 0
            if off.any():
                q = (d[off].cpu()[:, None] - l_quanta.abs()[None]).abs(
                    ).amin(1)
                say(f"fuse_depth_window {label} frame {f}: "
                    f"{int(off.sum())} cells differ, by "
                    f"{sorted(set(np.round(d[off].cpu().numpy(), 5)))[:6]} "
                    f"(quantum misfit {float(q.max()):.2e})")
                if float(q.max()) > 1e-5:
                    raise AssertionError("fuse_depth_window: a cell differs "
                                         "by more than one update quantum")
            worst = max(worst, float(d.max()))
            n_off += int(off.sum())
            n_upd += int((want != lo_w).sum())
            lo_w = want
        ch, cw = fusion._window_cells(camw, mpw)
        say(f"fuse_depth_window {label}: {ch} x {cw} windows, {n_off} of "
            f"{n_upd} updated cells differ (0 expected; tol 1e-4 of them, "
            f"each by one quantum); corner windows at {org[0].tolist()}")
        if n_off > 1e-4 * max(n_upd, 1):
            raise AssertionError("fuse_depth_window disagrees with its plain "
                                 "version")
        win_rows.append((label, mpw, camw, lo_w, tabs, sc_w, org, hit,
                         worst, n_off / max(n_upd, 1),
                         (depth_w, pos_w, quat_w)))
    (label, mpw, camw, lo_w, tabs, sc_w, org, hit, worst, frac,
     frame_w) = win_rows[0]
    out_w = lo_w.clone()
    ch, cw = fusion._window_cells(camw, mpw)
    work_v1 = (BV * ch * cw * 25 + BV * camw.width * 3,
               BV * (2 * ch * cw * 4 + camw.width * (4 + 8) + 8 * 4 + 2 * 4))
    report("fuse_depth_window", (worst, frac), 1e-4,
           median_ms(torch, lambda: fusion.launch_fuse_window(
               out_w, tabs, sc_w, org, hit, camw, mpw), 20),
           median_ms(torch, lambda: fusion._fuse_window_plain(
               lo_w, tabs, sc_w, org, hit, camw, mpw), 5),
           *work_v1, on="rel")
    # where the kernel's time goes, on the device (graph_ms): the launch as
    # timed, with nothing to carve and no hit (tables all res, hits -1), and
    # on the first envs only, one block an SM
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    tabs_0, hit_0 = torch.full_like(tabs, mpw.resolution), torch.full_like(
        hit, -1)
    out_1 = out_w[:n_sm].clone()
    t_full = graph_ms(lambda: fusion.launch_fuse_window(
        out_w, tabs, sc_w, org, hit, camw, mpw))
    t_bare = graph_ms(lambda: fusion.launch_fuse_window(
        out_w, tabs_0, sc_w, org, hit_0, camw, mpw))
    t_one = graph_ms(lambda: fusion.launch_fuse_window(
        out_1, tabs[:n_sm], sc_w[:n_sm], org[:n_sm], hit[:n_sm], camw, mpw))
    say(f"fuse_depth_window {label} device (graph) ms: B={BV} {t_full:.4f}; "
        f"nothing to carve and no hit {t_bare:.4f}; the first {n_sm} envs, "
        f"a block an SM, {t_one:.4f}; bound {bound(*work_v1)[0]:.4f}")
    line = []
    for th, tw in ((fusion.TILE_H, fusion.TILE_W),
                   (fusion.WARP_H, fusion.WARP_W)):
        keep = fusion.window_reach(tabs, sc_w, camw, mpw, (th, tw))
        line.append(f"{int(keep.sum())} of {keep.numel()} {th} x {tw} "
                    f"({float(keep.float().mean()):.4f})")
    say(f"fuse_depth_window {label} B={BV}: the cameras reach "
        + ", ".join(line) + " window tiles and strips (fusion.window_reach)")
    # the wrapper whole on this shape: the frame's columns, the windows,
    # the copy of the grid that the kernel then updates in place
    ms_whole = median_ms(torch, lambda: fusion.insert_depth_2d_dense(
        lo_w, *frame_w, camw, mpw), 20)
    ms_clone = median_ms(torch, lambda: lo_w.to(torch.float32).contiguous()
                         .clone(), 20)
    say(f"fuse_depth_window {label} B={BV}: insert_depth_2d_dense "
        f"{ms_whole:.3f} ms a call (CUDA events, median of 20), of which the "
        f"grid's copy alone {ms_clone:.3f} ms ({lo_w.numel() * 4 / 1e6:.1f} "
        f"MB read and written) and the kernel "
        f"{record['fuse_depth_window']['ms']:.3f} ms")
    if other is not None:
        # in place: both libraries start from copies of lo_w
        want_w = lo_w.clone()
        fusion.launch_fuse_window(want_w, tabs, sc_w, org, hit, camw, mpw)
        entry_against("fuse_depth_window", f"{label} B={BV}",
                      "neo_fuse_depth_window", lambda o: (
                          _cuda.ptr(o[0]), _cuda.ptr(tabs), _cuda.ptr(sc_w),
                          _cuda.ptr(org), _cuda.ptr(hit), BV,
                          mpw.height, mpw.width, ch, cw, camw.width,
                          _cuda.host_floats(fusion._params(camw, mpw)),
                          _cuda.stream_ptr(dev)), [want_w], work_v1,
                      init=[lo_w])
    label, mpw, camw, lo_w, tabs, sc_w, org, hit, _, _, _ = win_rows[1]
    out_w2 = lo_w.clone()
    ms_96 = median_ms(torch, lambda: fusion.launch_fuse_window(
        out_w2, tabs, sc_w, org, hit, camw, mpw), 20)
    say(f"fuse_depth_window {label}: {ms_96:.3f} ms")

    # ---- (d) small loops on the default map, on the card against the CPU
    small_loop("gt+grid", 16, 8,
               lambda g, n: scenegen.generate_batch(g, n, wp),
               dataclasses.replace(mapp_d, edt_truncation=2.0), gt_grid,
               path_kernels=("edt_exact", "lbfgs_grid_solve",
                             "track_segment_grid"))
    small_loop("depth+grid 2d_dense", 16, 9,
               lambda g, n: scenegen.generate_batch(g, n, wp), mapp_w, vision,
               cam_=cam4, path_kernels=("fuse_depth_window", "edt_exact",
                                        "lbfgs_grid_solve",
                                        "track_segment_grid"))

    # ---- (d') the expert planners with the per-evaluation solve, small
    # loops on the card against the CPU: the scene and the gt+grid path
    for planner in ("expert", "warmstart"):
        small_loop(f"scene {planner} per_eval", 16, 20,
                   lambda g, n: scenegen.generate_batch(g, n, wp), mapp, {},
                   path_kernels=PER_EVAL_SCENE_PATH, planner=planner,
                   solver="per_eval")
        small_loop(f"gt+grid {planner} per_eval", 16, 21,
                   lambda g, n: scenegen.generate_batch(g, n, wp),
                   dataclasses.replace(mapp_d, edt_truncation=2.0), gt_grid,
                   path_kernels=PER_EVAL_GRID_PATH, planner=planner,
                   solver="per_eval")

    # ---- (e) the gt+grid path at B = BV: the exact map built once at reset
    _, planned_g = run_path(
        "gt+grid", DEFAULT_MAP_PATH, BV, lambda: env.reset(
            worlds_v, pp, mp, mapp_d, _cuda.make_generator(15),
            goal=goals_v, **gt_grid), n_seg=2,
        per_segment=dict(edt_exact=0), at_reset=dict(edt_exact=1))
    # ---- (f) the default depth path: '2d' fusion, exact lite ESDF
    state_f, planned_f = run_path(
        "default depth+grid", DEFAULT_MAP_PATH, BV, lambda: env.reset(
            worlds_v, pp, mp, mapp_d, _cuda.make_generator(16),
            goal=goals_v, **vision), n_seg=2,
        per_segment=dict(edt_exact=1), at_reset=dict(edt_exact=1))
    if planned_g <= 0 or planned_f <= 0:
        raise AssertionError("a default-map path's timed segments replanned "
                             "no env")

    field_f = state_f.emap.esdf.float()
    say(f"default depth map: {int((state_f.logodds < 0).sum()) / BV:.0f} "
        f"free cells per env (mean), ESDF max {float(field_f.max()):g} "
        f"(bf16 FAR 9984 on maps that sensed nothing), min "
        f"{float(field_f.min()):g}")

    # ---- (g) the expert planner at full width: the gt+grid path at B = BV
    # with the fused solver (B6) and with the per-evaluation solve (B7), the
    # scene path at B = 1024 with the per-evaluation solve (B2s); no net and
    # no frame (render_depth 0), goals at x = 20
    planned_x = []
    for solver, kernels in (("fused", EXPERT_GRID_PATH),
                            ("per_eval", PER_EVAL_GRID_PATH)):
        planned_x.append(run_path(
            f"gt+grid expert {solver}", kernels, BV, lambda: env.reset(
                worlds_v, pp, mp, mapp_d, _cuda.make_generator(17),
                goal=goals_v, **gt_grid), n_seg=2,
            per_segment=dict(edt_exact=0), at_reset=dict(edt_exact=1),
            absent=("render_depth",) + tuple(
                k for k in ("lbfgs_grid_solve", "objective_grid_fwd",
                            "objective_grid_valgrad") if k not in kernels),
            planner="expert", solver=solver)[1])
    goals_b = torch.stack([torch.full((B,), 20.0), torch.from_numpy(
        rng_eval.uniform(-1.5, 1.5, B)).float()], 1).to(dev)
    planned_x.append(run_path(
        "scene expert per_eval", PER_EVAL_SCENE_PATH, B, lambda: env.reset(
            worlds, pp, mp, mapp, _cuda.make_generator(18), goal=goals_b),
        n_seg=2, absent=("render_depth", "lbfgs_scene_solve"),
        planner="expert", solver="per_eval")[1])
    if min(planned_x) <= 0:
        raise AssertionError("an expert loop's timed segments replanned no "
                             "env")
    # ================= the piece count M and the L-BFGS history H ==========
    # ---- (h) the expert 'fused' loops at M = 5 (the reference's
    # init_wpts_num 4): the scene path at B = 1024 and the gt+grid path at
    # B = BV, goals at x = 20, 1 warm-up and 2 timed segments
    pp5 = dataclasses.replace(pp, num_pieces=5)
    _, planned_s5 = run_path(
        "scene expert fused M=5", EXPERT_SCENE_PATH, B, lambda: env.reset(
            worlds, pp5, mp, mapp, _cuda.make_generator(19), goal=goals_b),
        n_seg=2, pp_=pp5, absent=("render_depth", "objective_scene_fwd",
                                  "objective_scene_valgrad"),
        planner="expert", solver="fused")
    state_g5, planned_g5 = run_path(
        "gt+grid expert fused M=5", EXPERT_GRID_PATH, BV, lambda: env.reset(
            worlds_v, pp5, mp, mapp_d, _cuda.make_generator(20),
            goal=goals_v, **gt_grid), n_seg=2, pp_=pp5,
        per_segment=dict(edt_exact=0), at_reset=dict(edt_exact=1),
        absent=("render_depth", "objective_grid_fwd",
                "objective_grid_valgrad"), planner="expert", solver="fused")
    if min(planned_s5, planned_g5) <= 0:
        raise AssertionError("an M = 5 loop's timed segments replanned no "
                             "env")

    rng_m = np.random.default_rng(12)       # the M checks' own draws

    def m_problems(M, n, start=None):
        """n problems of M pieces from start (n, 2) (by default standard
        normal around the origin) to ~2M m ahead, the distance whose
        adaptive piece count is M: (x0, head, tail) on the card."""
        pp_m = dataclasses.replace(pp, num_pieces=M)
        head_m, tail_m, _, _ = boundary_problems(n, start=start, gen=rng_m)
        tail_m[:, 0] = head_m[:, 0] + torch.tensor([2.0 * M, 0.0],
                                                   device=dev) \
            + torch.from_numpy(rng_m.normal(size=(n, 2))).float().to(dev)
        q0_m = expert.straight_line_wpts(head_m[:, 0], tail_m[:, 0], pp_m) \
            + torch.from_numpy(rng_m.normal(scale=0.4, size=(
                n, 2, M - 1))).float().to(dev)
        ts0_m = expert.init_ts(pp_m, dev) * torch.from_numpy(
            rng_m.uniform(0.7, 1.3, (n, M))).float().to(dev)
        x0_m = costs.pack(q0_m, minco.T_to_tau(ts0_m, pp.t_min, pp.t_max),
                          pp_m)
        return x0_m.contiguous(), head_m.contiguous(), tail_m.contiguous()

    def gt_windows(M, start):
        """BV problems of M pieces from start, each on its env's window of
        the M = 5 gt+grid loop's maps (expert.make_plan_window)."""
        pp_m = dataclasses.replace(pp, num_pieces=M)
        x0_m, head_m, tail_m = m_problems(M, BV, start)
        return x0_m, head_m, tail_m, expert.make_plan_window(
            state_g5.emap, head_m, tail_m, pp_m)

    # ---- (i) B5 at M = 2, 5, 12 and 16, both bands, N = B MINCO systems
    for M in (2, 5, 12, 16):
        pp_m = dataclasses.replace(pp, num_pieces=M)
        x0_m, head_m, tail_m = m_problems(M, B)
        q_m, tau_m = costs.unpack(x0_m, pp_m)
        A_m, b_m = minco.build_system(head_m, tail_m, q_m, minco.tau_to_T(
            tau_m, pp.t_min, pp.t_max))
        n = 6 * M
        for lbw, A_ in ((4, A_m), (2, A_m.transpose(1, 2))):
            aug_m = torch.cat([A_, b_m], 2).contiguous()
            out_m = torch.empty((B, n, 2), device=dev)
            minco.launch_banded_solve(aug_m, out_m, lbw)
            want_m = minco._givens_solve(A_, b_m, lbw, 6 - lbw)
            scale = want_m.abs().amax((1, 2), keepdim=True).clamp(min=1.0)
            err_m = float(((out_m - want_m).abs() / scale).max())
            ms_k = median_ms(torch, lambda: minco.launch_banded_solve(
                aug_m, out_m, lbw), 20)
            ms_g = graph_ms(lambda: minco.launch_banded_solve(aug_m, out_m,
                                                              lbw))
            ms_p = median_ms(torch, lambda: minco._givens_solve(
                A_, b_m, lbw, 6 - lbw), 3)
            b_ms, b_by = bound(B * givens_flops(lbw, n),
                               givens_bytes(n, lbw, B))
            say(f"minco_banded_solve M={M} (n={n}) lower bandwidth {lbw} "
                f"B={B}: max err {err_m:.3g} of each system's largest "
                f"component (tol 1e-4) {'ok' if err_m <= 1e-4 else 'MISS'}; "
                f"{ms_k:.4f} ms (events), device (graph) {ms_g:.4f} ms, "
                f"plain {ms_p:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
            if err_m > 1e-4:
                raise AssertionError(f"minco_banded_solve at M={M} disagrees "
                                     f"with its plain version")

    # ---- (j) B2s and B7 at M = 5 and 12 at the lazy banks' shapes: 3072
    # scene problems and their 12,288 candidates, 1536 window problems
    # (the M = 5 gt+grid loop's maps) and their 6144 candidates
    lanes = 1 + pp.retry_num
    n_slots = scene.pack_prims(sc).shape[1]
    start_g = state_g5.drone.pos[:, :2]
    for M in (5, 12):
        pp_m = dataclasses.replace(pp, num_pieces=M)
        nv = pp_m.num_vars
        x0_m, head_m, tail_m = m_problems(M, B)
        xb = (x0_m.repeat_interleave(lanes, 0) + torch.from_numpy(
            rng_m.normal(scale=0.3, size=(B * lanes, nv))).float().to(dev)
        ).contiguous()
        eb = torch.arange(B, device=dev).repeat_interleave(lanes)
        objective_check("scene", f"bank B={B}", sc, xb,
                        head_m.repeat_interleave(lanes, 0).contiguous(),
                        tail_m.repeat_interleave(lanes, 0).contiguous(), eb,
                        20 * n_active[eb.cpu().numpy()],
                        B * n_slots * 6 * 4, record_it=False, pp_=pp_m)
        x0_g, head_g5, tail_g5, win_m = gt_windows(M, start_g)
        xg = (x0_g.repeat_interleave(lanes, 0) + torch.from_numpy(
            rng_m.normal(scale=0.3, size=(BV * lanes, nv))).float().to(dev)
        ).contiguous()
        eg = torch.arange(BV, device=dev).repeat_interleave(lanes)
        hg = head_g5.repeat_interleave(lanes, 0).contiguous()
        tg = tail_g5.repeat_interleave(lanes, 0).contiguous()
        objective_check("grid", f"gt+grid windows B={BV}", win_m, xg, hg, tg,
                        eg, np.full(BV * lanes, 25.0),
                        4 * window_cells_read(
                            esdf.GridWindow(win_m.win[eg], win_m.worg[eg]),
                            (xg,), hg, tg, pp_m)
                        + win_m.worg.numel() * 4, record_it=False, pp_=pp_m)

    # ---- (k) B1 and B6 at M = 5 and 12: at histories 5, 10 and 20 one
    # iteration against the plain solver on the card (parity.one_iteration)
    # and 24 iterations held to its acceptance and cost basin (basin(), its
    # median tolerance from the plain solver's GPU-vs-CPU control on the
    # first N_CTRL problems); at histories 2 and 3, 6 iterations, so that
    # the ring wraps, on N_CTRL problems, f and x of each within 1e-3 of
    # the plain solver on the card (parity.few_iterations, the plain
    # solver on the CPU the control)
    N_CTRL = 256
    sc_cpu = scene.SceneMap(*(getattr(sc, f).cpu() for f in
                              ("centers", "half", "is_cyl", "active")))
    for M in (5, 12):
        pp_m = dataclasses.replace(pp, num_pieces=M)
        x0_g, head_g5, tail_g5, win_m = gt_windows(M, start_g)
        win_cpu = esdf.GridWindow(win_m.win.cpu(), win_m.worg.cpu())
        cases = (("lbfgs_scene_solve", solve.solve_scene, sc, sc_cpu,
                  *m_problems(M, B), 20 * n_active, B * n_slots * 6 * 4),
                 ("lbfgs_grid_solve", solve.solve_grid, win_m, win_cpu,
                  x0_g, head_g5, tail_g5, np.full(BV, 25.0),
                  win_m.win.numel() * 4))
        for (name, fused, pmap, pmap_cpu, x0_m, head_m, tail_m, dfl,
             map_bytes) in cases:
            P = x0_m.shape[0]
            env_m = torch.arange(P, device=dev)

            def cpu(p, n, pmap_cpu=pmap_cpu, x0_m=x0_m, head_m=head_m,
                    tail_m=tail_m):
                return solve._solve_plain(
                    x0_m[:n].cpu(), head_m[:n].cpu(), tail_m[:n].cpu(),
                    pmap_cpu, torch.arange(n), p)
            n_w = min(N_CTRL, P)
            for H in (2, 3):
                p6 = dataclasses.replace(pp_m, history=H, max_iters=6)
                sub = (x0_m[:n_w], head_m[:n_w], tail_m[:n_w], pmap,
                       env_m[:n_w], p6)
                w6 = solve._solve_plain(*sub)
                n_k, n_cc, worst = parity.few_iterations(fused(*sub), w6,
                                                         cpu(p6, n_w))
                say(f"{name} M={M} H={H} 6 iters on {n_w} problems (ring "
                    f"wrapped on {int((w6[2] > H).sum())}): f or x off the "
                    f"plain solver by > 1e-3 on {n_k} (tol 2 x {n_cc} + "
                    f"{n_w // 64}; the plain solver on the CPU on {n_cc}), "
                    f"largest relative difference elsewhere {worst:.3g}")
            for H in (5, 10, 20):
                p24 = dataclasses.replace(pp_m, history=H)
                p1 = dataclasses.replace(p24, max_iters=1)
                k1 = fused(x0_m, head_m, tail_m, pmap, env_m, p1)
                w1 = solve._solve_plain(x0_m, head_m, tail_m, pmap, env_m, p1)
                e1, n_flip = parity.one_iteration(x0_m, head_m, tail_m, pmap,
                                                  env_m, p1, k1, w1)
                ex = float((k1[0] - w1[0]).abs().max())
                k24 = fused(x0_m, head_m, tail_m, pmap, env_m, p24)
                w24 = solve._solve_plain(x0_m, head_m, tail_m, pmap, env_m,
                                         p24)
                ms_k = median_ms(torch, lambda: fused(
                    x0_m, head_m, tail_m, pmap, env_m, p24), 3)
                ms_p = median_ms(torch, lambda: solve._solve_plain(
                    x0_m, head_m, tail_m, pmap, env_m, p24), 1)
                t_c = time.perf_counter()
                c24 = cpu(p24, n_w)[1]
                t_c = time.perf_counter() - t_c
                c1 = rel(w1[1][:n_w].cpu(), cpu(p1, n_w)[1])
                label = f"{name} M={M} H={H} P={P}"
                say(f"{label} 1 iter: f rel err max {e1:.3g} (tol 1e-3) "
                    f"outside {n_flip} problems held to the f64 plain "
                    f"solver or to another backtracking step (tol 1 in 16), "
                    f"x max abs err {ex:.3g}; control on the CPU "
                    f"{t_c:.1f} s")
                med_tol = control_tol(label, w24[1][:n_w], c24)
                basin(label, accepted(k24[0], head_m, tail_m, pmap, p24),
                      accepted(w24[0], head_m, tail_m, pmap, p24), k24[1],
                      w24[1], k24[2], c1, rel(w24[1][:n_w].cpu(), c24), n_w,
                      med_tol, None)
                iters = k24[2].cpu().numpy().astype(np.float64)
                b_ms, b_by = bound(solve_flops(pp.samples_per_piece, dfl,
                                               iters, M),
                                   P * (2 * pp_m.num_vars + 12 + 2) * 4
                                   + map_bytes)
                say(f"{label} 24 iters: {ms_k:.3f} ms (events), plain "
                    f"{ms_p:.1f} ms, bound {b_ms:.4f} ms ({b_by})")

    # ---- (l) plan_adaptive on tests/test_expert.py's golden 24 m problem:
    # M = 12 pieces, max_iters 96, two retries, a 160-cell window (the
    # whole 120 x 160 map)
    occ_a = torch.zeros((1, 120, 160), device=dev)
    occ_a[0, 60, 80] = 1.0
    emap_a = esdf.build(occ_a, (-2.0, -6.0), 0.1)
    head_a = torch.zeros((1, 3, 2), device=dev)
    head_a[0, 1, 0] = 0.5
    tail_a = torch.zeros((1, 3, 2), device=dev)
    tail_a[0, 0, 0] = 24.0
    M_a = expert.adaptive_num_pieces(head_a[0, 0], tail_a[0, 0])
    pp_a = PlannerParams(max_iters=96, retry_num=2, extra_lateral_scales=(),
                         kernel_window_cells=160)
    noise_a = torch.randn((1, pp_a.retry_num, 2, M_a - 1), device=dev,
                          generator=_cuda.make_generator(21))
    _cuda.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj_a = expert.plan_adaptive(emap_a, head_a, tail_a, noise_a, pp_a)
    torch.cuda.synchronize()
    ms_a = (time.perf_counter() - t0) * 1e3
    end_a = minco.eval_at(traj_a.coeffs, traj_a.ts,
                          traj_a.ts.sum(1, keepdim=True), 0)[0, 0]
    err_a = float(torch.linalg.vector_norm(
        end_a - torch.tensor([24.0, 0.0], device=dev)))
    ok_a = bool(traj_a.ok[0])
    say(f"plan_adaptive golden 24 m: M={M_a}, ok {ok_a}, end-point error "
        f"{err_a:.4f} m (tol 0.05), weighted cost "
        f"{float(traj_a.costs[0] @ costs.weights(pp_a, dev)):.6g}, iters "
        f"{int(traj_a.iters[0])}, {ms_a:.1f} ms; launches lbfgs_grid_solve "
        f"{_cuda.launches['lbfgs_grid_solve']}, minco_banded_solve "
        f"{_cuda.launches['minco_banded_solve']}")
    if M_a != 12 or not ok_a or err_a > 0.05 or \
            _cuda.launches["lbfgs_grid_solve"] <= 0:
        raise AssertionError("plan_adaptive missed the golden's goal")

    # ---- (m) --against: B1 and B6 at M = 3 and history 10, through their C
    # entries, this tree's and the other's (whose entries may take no
    # history): the elements whose bits differ and both times in turns
    if other is not None:
        this3 = _cuda.load_pieces(3)
        x0_3, head_3, tail_3 = m_problems(3, B)
        x0_g3, head_g3, tail_g3, win_3 = gt_windows(3, start_g)
        for name, entry, x_, h_, t_, maps, sizes in (
                ("lbfgs_scene_solve", "neo_lbfgs_scene_solve", x0_3, head_3,
                 tail_3, (scene.pack_prims(sc),), (n_slots,)),
                ("lbfgs_grid_solve", "neo_lbfgs_grid_solve", x0_g3, head_g3,
                 tail_g3, (win_3.win.contiguous(), win_3.worg.contiguous()),
                 tuple(win_3.win.shape[1:]))):
            P = x_.shape[0]
            env_ = torch.arange(P, device=dev, dtype=torch.int32)
            skip_ = torch.zeros(P, device=dev, dtype=torch.int32)
            outs = {lib: (torch.empty_like(x_), torch.empty(P, device=dev),
                          torch.empty(P, dtype=torch.int32, device=dev))
                    for lib in (other3, this3)}
            n_args = len(getattr(this3, entry).argtypes)

            def call(lib, entry=entry, x_=x_, h_=h_, t_=t_, maps=maps,
                     sizes=sizes, P=P, env_=env_, skip_=skip_, outs=outs,
                     n_args=n_args, name=name):
                fn = getattr(lib, entry)
                hist = (pp.history,) if len(fn.argtypes) == n_args else ()
                o = outs[lib]
                _cuda.check(fn(
                    _cuda.ptr(x_), _cuda.ptr(h_), _cuda.ptr(t_),
                    *map(_cuda.ptr, maps), _cuda.ptr(env_), _cuda.ptr(skip_),
                    *map(_cuda.ptr, o), P, *sizes, pp.samples_per_piece,
                    pp.max_iters, pp.max_ls, *hist, solve._params(pp),
                    _cuda.stream_ptr(dev)), name)
            for lib in outs:
                call(lib)
            torch.cuda.synchronize()
            (o_o, o_m) = outs.values()
            n_diff = sum(int((a.view(torch.int32) != b.view(torch.int32)
                              ).sum()) for a, b in zip(o_o, o_m))
            n_all = sum(a.numel() for a in o_o)
            say(f"{name} M=3 H={pp.history} B={P} against {args.against}: "
                f"{n_diff} of {n_all} elements (x, f, iters) differ (bits); "
                f"{in_turns(call, pieces=True)[1]}")

    # ================= the expert-data and training path ==================
    record_check(dev, pp, mp, sp, mapp, cam, card)
    with tempfile.TemporaryDirectory() as tmp:
        pipeline_phase(dev, mp, sp, mapp, cam, card, launch_totals, tmp)

    # ================= the paper's ResNet-18 net, 'geo', the tracker ======
    paper = paper_phases(dev, card, pp, mp, sp, mapp, worlds, worlds_v,
                         goals_v, launch_totals, run_path, small_loop,
                         render_work, wp)

    # ================= world files, the .bt map, the env-axis mesh =======
    with tempfile.TemporaryDirectory() as tmp:
        world_phases(dev, card, pp, mp, sp, mapp, cam, (net, net_cpu),
                     worlds, onnx, launch_totals, tmp, small_loop,
                     boundary_problems, accepted, basin)

    # ================= the JAX package's checkpoints, the trained net ====
    checkpoint_phases(dev, card, pp, mp, mapp, wp, paper, run_path,
                      small_loop, twin_loops)

    say(f"total {time.perf_counter() - t_start:.1f} s")

    for k in KERNELS:
        record[k]["launches"] = launch_totals[k]
    say("kernels: " + ", ".join(f"{k} {record[k]['launches']}"
                                for k in KERNELS))
    print(json.dumps({"kernels": [record[k] for k in KERNELS]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
