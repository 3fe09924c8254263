"""Subpackage of the PyTorch port (mirrors neoplanner_tpu.parallel)."""

from neoplanner_tpu_torch.parallel import mesh

__all__ = ["mesh"]
