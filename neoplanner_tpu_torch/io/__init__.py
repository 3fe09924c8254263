"""Subpackage of the PyTorch port (mirrors neoplanner_tpu.io)."""
