"""Profiling hooks (counterpart of tf_gnn_samples_tpu/utils/profiling.py).

The reference has no profiler (TensorBoard scalar summaries only). Here:
`torch.profiler` traces, written by `tensorboard_trace_handler` as a
`*.pt.trace.json` Chrome trace (viewable in TensorBoard's profiler plugin,
Perfetto or chrome://tracing), plus the per-epoch graphs/nodes/edges-per-
sec counters already emitted by the training loop (runtime/model.py log
format).

Usage:
    python -m tf_gnn_samples_torch.train RGCN QM9 --profile-dir /tmp/trace ...
or programmatically:

    with trace_if(profile_dir):
        model.train(...)
"""

import contextlib

import torch


@contextlib.contextmanager
def trace_if(profile_dir=None):
    """torch.profiler trace (host, and the card's kernels where there is
    one) written to `profile_dir` when a directory is given; no-op else."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                profile_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler timeline (record_function)."""
    with torch.profiler.record_function(name):
        yield
