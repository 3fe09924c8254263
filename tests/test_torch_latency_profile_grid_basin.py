"""The B = 1 replan latency's full profile against the JAX package: the
32-iteration plan on the exact ESDF of the ground-truth grid, by the rules of
test_torch_latency_profile.py.
"""

from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_latency_profile import check_basin, full_profile


def test_full_profile_plan_matches_jax():
    check_basin(full_profile("grid"))
