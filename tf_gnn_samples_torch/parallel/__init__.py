"""Data parallelism over torch.distributed: one process (rank) per model
replica (counterpart of tf_gnn_samples_tpu/parallel/, its data-parallel
and multi-host parts)."""

from .data_parallel import dp_eval_step, dp_train_step, world
from .multihost import initialize, shutdown

__all__ = ["dp_eval_step", "dp_train_step", "initialize", "shutdown",
           "world"]
