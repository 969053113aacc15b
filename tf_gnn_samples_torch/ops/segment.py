"""Segment (scatter) aggregation (counterpart of the part of
tf_gnn_samples_tpu/ops/segment.py this slice uses)."""

import torch


def segment_sum(data, segment_ids, num_segments):
    """out[s] = sum of data rows with segment_ids == s (0 for empty)."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add(0, segment_ids, data)
