"""Edge-level gathers and aggregation over the flat edge stream
(counterpart of the part of tf_gnn_samples_tpu/ops/edge_ops.py this slice
uses).

Gathers clamp their indices as `jnp.take(..., mode="clip")` does: padded
edges carry src_flat / tgt_flat = L * n_pad, one row past the type-stacked
table, and torch's index_select does not clamp. Their (finite, garbage)
rows reach only the dump receiver or the dump rank, so their cotangents
are zero.
"""

import torch

from .segment import segment_sum


def _take_clip(table, idx):
    return table.index_select(0, idx.clamp(0, table.shape[0] - 1))


def gather_flat_src(table_flat, flat):
    """table_flat[[L*N, ...]][src_flat]: per-edge source-side rows."""
    return _take_clip(table_flat, flat.src_flat)


def gather_flat_tgt(table_flat, flat):
    """table_flat[[L*N, ...]][tgt_flat]: per-edge target-side rows."""
    return _take_clip(table_flat, flat.tgt_flat)


def aggregate_flat(messages, flat, n_pad: int, aggregation: str):
    """Sum per-edge messages into receiver rows over the whole stream; the
    dump row n_pad (padded edges) is sliced off."""
    if aggregation in ("sum", "unsorted_segment_sum"):
        return segment_sum(messages, flat.receivers, n_pad + 1)[:n_pad]
    raise ValueError("Aggregation '%s' is not yet ported." % aggregation)


class _InjectiveTake(torch.autograd.Function):
    """table[fwd_idx] whose backward is the INVERSE take through inv_idx
    (-1 = no row): fwd_idx hits every real table slot at most once, and
    the ranks it maps non-injectively (slack rows, the dump group) carry
    exactly-zero cotangents."""

    @staticmethod
    def forward(ctx, table, fwd_idx, inv_idx):
        ctx.save_for_backward(inv_idx)
        return _take_clip(table, fwd_idx)

    @staticmethod
    def backward(ctx, g):
        (inv_idx,) = ctx.saved_tensors
        d = g.index_select(0, inv_idx.clamp(min=0))
        return torch.where((inv_idx >= 0)[:, None], d, 0.0), None, None


def take_by_fine_rank(table_flat, graph):
    """table_flat rows at each FINE (receiver, type) rank: [RPAD, ...]."""
    flat = graph.flat
    return _InjectiveTake.apply(table_flat, flat.fine_to_flat,
                                flat.fine_from_flat)


class _FineCombine(torch.autograd.Function):
    """Sum the <= L fine-rank rows of each receiver: out[v] = sum_l
    table[from_flat_2d[l, v]] over slots >= 0. Each real fine rank belongs
    to exactly one receiver, so the transpose is one row take by to_rcv
    (slack and dump rows point at n_pad and get zero)."""

    @staticmethod
    def forward(ctx, table, from_flat_2d, to_rcv, n_pad):
        ctx.save_for_backward(to_rcv)
        ctx.n_pad = n_pad
        num_types = from_flat_2d.shape[0]
        rows = table.index_select(0, from_flat_2d.clamp(min=0).reshape(-1))
        rows = rows.reshape((num_types, n_pad) + tuple(table.shape[1:]))
        return torch.where((from_flat_2d >= 0)[..., None], rows, 0.0).sum(0)

    @staticmethod
    def backward(ctx, g):
        (to_rcv,) = ctx.saved_tensors
        d = g.index_select(0, to_rcv.clamp(max=ctx.n_pad - 1))
        return torch.where((to_rcv < ctx.n_pad)[:, None], d, 0.0), None, None, None


def fine_table_to_nodes(table, graph):
    """Combine a FINE (receiver, type) rank table [RPAD, D] into node rows
    [n_pad, D]."""
    flat = graph.flat
    n_pad, num_types = graph.n_pad, graph.num_edge_types
    ffl = flat.fine_from_flat.reshape(num_types, n_pad)
    return _FineCombine.apply(table, ffl, flat.fine_to_rcv, n_pad)
