"""The B = 1 replan latency's full profile against the JAX package: one
L-BFGS iteration on the exact ESDF of the ground-truth grid, by the rules of
test_torch_latency_profile.py.
"""

from tests.test_torch_imports import one_torch_thread  # noqa: F401
from tests.test_torch_latency_profile import check_one_iteration, full_profile


def test_full_profile_one_iteration_matches_jax():
    check_one_iteration(full_profile("grid"))
