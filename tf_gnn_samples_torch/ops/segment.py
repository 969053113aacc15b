"""Segment (scatter) aggregation (counterpart of the part of
tf_gnn_samples_tpu/ops/segment.py the ported layers use).

Empty-segment semantics, as tf.unsorted_segment_*: sum 0, max the dtype's
finite minimum; mean and sqrt_n divide by max(count, 1) (ops/edge_ops.py).
"""

import torch


def segment_sum(data, segment_ids, num_segments):
    """out[s] = sum of data rows with segment_ids == s (0 for empty)."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add(0, segment_ids, data)


def segment_max(data, segment_ids, num_segments):
    """out[s] = elementwise max of data rows with segment_ids == s, floored
    at finfo.min (so empty segments get finfo.min, as tf.unsorted_segment_max
    does). Ties share the gradient equally, as jax.ops.segment_max's does."""
    floor = torch.finfo(data.dtype).min
    out = torch.full((num_segments,) + tuple(data.shape[1:]), floor,
                     dtype=data.dtype, device=data.device)
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    out = out.scatter_reduce(0, idx.expand_as(data), data, "amax",
                             include_self=False)
    return torch.clamp(out, min=floor)
