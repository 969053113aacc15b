"""Data and graph parallelism over torch.distributed: one process (rank)
per model replica, or per partition of every batch's graph (counterpart
of tf_gnn_samples_tpu/parallel/, its data-parallel, all-gather
graph-parallel and multi-host parts)."""

from .data_parallel import dp_eval_step, dp_train_step, world
from .graph_parallel import (GP_LAYERS, gp_propagation_apply,
                             make_gp_task_steps, partition_task_batch)
from .multihost import initialize, shutdown

__all__ = ["GP_LAYERS", "dp_eval_step", "dp_train_step",
           "gp_propagation_apply", "initialize", "make_gp_task_steps",
           "partition_task_batch", "shutdown", "world"]
