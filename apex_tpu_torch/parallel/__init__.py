"""Data-parallel pieces of the port: single-process SyncBatchNorm so far."""
from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm  # noqa: F401

__all__ = ["SyncBatchNorm"]
