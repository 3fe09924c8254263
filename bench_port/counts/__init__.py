"""The yardstick's counts: the operations and bytes of the port's kernels
on a run's inputs (frozen copies of chip_smoke.py's ``bound``,
``render_work``, ``givens_flops``, ``givens_bytes``, ``objective_flops``
and ``solve_flops``), the ResNet-18's operations from its layer shapes,
and the H100's published peaks."""
