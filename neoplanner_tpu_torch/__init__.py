"""neoplanner_tpu_torch: NEO-Planner's batched closed loop in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of ``neoplanner_tpu`` (JAX on a TPU), which stays beside it as the
reference. Every function takes tensors with a leading env (or problem) axis
in place of the JAX package's ``vmap``. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; a kernel wrapper launches its CUDA kernel
for CUDA tensors and takes its plain PyTorch version only for CPU tensors.

Beside the loop (``sim``, ``plan``, ``mapping``, ``sense``, ``ops``,
``models``, ``learn``, ``utils``):

- ``world``: procedural worlds (``scenegen``), Gazebo ``.world`` files
  (``worldio``), occupancy grids, voxel volumes and the analytic SDF
  (``voxelize``);
- ``io``: the octomap ``.bt`` / PCL ``.pcd`` codec (``octomap``, a C++
  library built with g++ at first use) and the ONNX protobuf codec;
- ``parallel``: env-axis data parallelism over ``torch.distributed``, one
  process per device (``mesh``);
- ``sim.sweep``: the planners x worlds benchmark sweep.
"""

from neoplanner_tpu_torch.config import (CameraParams, MapParams,  # noqa: F401
                                         MissionParams, NetParams,
                                         PlannerParams, SimParams,
                                         WorldParams)
