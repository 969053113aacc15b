"""Static-shape batched graph representation (counterpart of
tf_gnn_samples_tpu/ops/graph.py).

The host-side construction is numpy, as in the JAX package, and every
emitted field equals the JAX package's array for the same input. The
batch carries only the fields the ported layers read; the TPU window
tokens, the diluted `sd_*` src stream and the type-major `tm_*` view wait
for the slices whose consumers need them (the CUDA kernels reduce over
sorted ranks and need no window).

Padding contract: nodes are padded to `n_pad` and edges of each type to
`e_pads[l]`. Padded edges point their receiver at the dump row `n_pad`,
their flat source/target at `L * n_pad` (one past the type-stacked node
table, clamped by every gather), and share the final dump rank; dump and
slack rank-table rows are never mapped back to real nodes. Rank tables
keep the JAX package's heights (`fine_rank_table_rows`,
`src_rank_table_rows`, slack rows included), so every index map means the
same thing in both packages.
"""

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import SMALL_NUMBER
from .ranked_segment import fine_rank_table_rows, src_rank_table_rows


class EdgeBlock(NamedTuple):
    """All edges of one edge type, padded and sorted by receiver (stable;
    padding, with receiver == n_pad, sorts to the end)."""

    senders: np.ndarray  # [E_l] int32; padding -> n_pad
    receivers: np.ndarray  # [E_l] int32 SORTED ascending; padding -> n_pad
    mask: np.ndarray  # [E_l] float32; 1.0 = real edge
    norm_scale: np.ndarray  # [E_l] f32; mask / (c_{rcv, l} + SMALL_NUMBER)


class FlatEdges(NamedTuple):
    """ALL edges of the batch as one stream, globally sorted by receiver.
    Types are offsets into type-stacked [L * n_pad, D] node tables:
    `src_flat = type * n_pad + sender` (and `tgt_flat` analogously)."""

    src_flat: torch.Tensor  # [E_tot] int32; padding -> L * n_pad (clamp)
    tgt_flat: torch.Tensor  # [E_tot] int32; padding -> L * n_pad
    receivers: torch.Tensor  # [E_tot] int32 SORTED; padding -> n_pad
    edge_type: torch.Tensor  # [E_tot] int32
    mask: torch.Tensor  # [E_tot] float32
    norm_scale: torch.Tensor  # [E_tot] float32
    perm_by_src: torch.Tensor  # [E_tot] int32; src_flat[perm] is sorted
    # Gap-free nondecreasing group ranks of the stream: coarse (receiver)
    # and fine (receiver, type); padded edges share the final dump rank.
    rcv_rank: torch.Tensor  # [E_tot] int32
    tgt_rank: torch.Tensor  # [E_tot] int32
    # Ranks of the src-sorted stream and the node-table <-> rank maps
    # (-1 = the slot sends no edge; 0 for slack rows of src_from_rank).
    src_sorted_rank: torch.Tensor  # [E_tot] int32 (by perm_by_src)
    src_to_rank: torch.Tensor  # [L * n_pad] int32
    src_from_rank: torch.Tensor  # [R_src] int32
    # Fine rank of each edge of the src-sorted stream (tgt_rank[perm]).
    fine_rank_by_src: torch.Tensor  # [E_tot] int32
    # Fine-rank maps: flat node-table row / receiver of each fine rank
    # (slack rows -> 0 / dump row n_pad), and the inverse map.
    fine_to_flat: torch.Tensor  # [RPAD] int32
    fine_to_rcv: torch.Tensor  # [RPAD] int32
    fine_from_flat: torch.Tensor  # [L * n_pad] int32


class GraphBatch(NamedTuple):
    """A batch of disconnected graphs packed into one padded mega-graph."""

    node_features: torch.Tensor  # [N, F] float32; padding rows -> 0
    node_mask: torch.Tensor  # [N] float32; 1.0 = real node
    node_graph_ids: torch.Tensor  # [N] int32 in [0, G]; padding -> G (dump)
    flat: FlatEdges
    node_to_rank: torch.Tensor  # [N] int32: coarse rank of node
    node_has_incoming: torch.Tensor  # [N] float32: 1.0 if any real in-edge
    typed_incoming_counts: torch.Tensor  # [L, N] float32 (c_{v,l})
    graph_mask: torch.Tensor  # [G] float32; 1.0 = real graph
    num_graphs: int  # real graph count
    # [L, N, N] f32 per-type adjacency, built once per step by the runtime
    # for the dense strategy (ops/edge_ops.py dense_adjacency), else None.
    dense_adj: Optional[torch.Tensor] = None

    @property
    def n_pad(self) -> int:
        return self.node_features.shape[0]

    @property
    def g_pad(self) -> int:
        return self.graph_mask.shape[0]

    @property
    def num_edge_types(self) -> int:
        return self.typed_incoming_counts.shape[0]


def bucket_size(n: int, min_size: int = 128, buckets_per_octave: int = 4) -> int:
    """Round `n` up to a bucket boundary (`buckets_per_octave` sizes per
    power of two, so padding waste is bounded)."""
    if n <= min_size:
        return min_size
    po2 = 1 << (int(n - 1).bit_length() - 1)
    step = max(min_size, po2 // buckets_per_octave)
    return -(-n // step) * step


def _group_ranks(sorted_vals: np.ndarray):
    """(is_new, ranks): gap-free group ranks of a sorted stream."""
    is_new = np.empty(sorted_vals.shape[0], dtype=bool)
    if sorted_vals.shape[0]:
        is_new[0] = True
        is_new[1:] = sorted_vals[1:] != sorted_vals[:-1]
    return is_new, np.cumsum(is_new, dtype=np.int32) - 1


def pad_graph_batch(
    node_features: np.ndarray,
    adjacency_lists: Sequence[np.ndarray],
    node_graph_ids: np.ndarray,
    num_graphs: int,
    *,
    n_pad: Optional[int] = None,
    e_pads: Optional[Sequence[int]] = None,
    g_pad: Optional[int] = None,
    typed_incoming_counts: Optional[np.ndarray] = None,
) -> GraphBatch:
    """Build a padded GraphBatch (CPU tensors) from host numpy arrays.

    Args:
        node_features: [n, F] real node features.
        adjacency_lists: L arrays of shape [e_l, 2] int (sender, receiver).
        node_graph_ids: [n] int graph index per node.
        num_graphs: real number of graphs in the batch.
        n_pad / e_pads / g_pad: static target sizes; default = bucketed.
        typed_incoming_counts: optional precomputed [L, n] counts.
    """
    n = int(node_features.shape[0])
    L = len(adjacency_lists)
    if n_pad is None:
        n_pad = bucket_size(n)
    assert n_pad >= n, (n_pad, n)
    if e_pads is None:
        e_pads = [bucket_size(int(a.shape[0])) for a in adjacency_lists]
    if g_pad is None:
        g_pad = bucket_size(max(int(num_graphs), 1), min_size=16)

    feats = np.zeros((n_pad, node_features.shape[1]), dtype=np.float32)
    feats[:n] = node_features
    node_mask = np.zeros((n_pad,), dtype=np.float32)
    node_mask[:n] = 1.0
    gids = np.full((n_pad,), g_pad, dtype=np.int32)
    gids[:n] = node_graph_ids

    if typed_incoming_counts is None:
        typed_incoming_counts = np.zeros((L, n), dtype=np.float32)
        for l, adj in enumerate(adjacency_lists):
            if adj.shape[0]:
                np.add.at(typed_incoming_counts[l],
                          adj[:, 1].astype(np.int64), 1.0)
    counts = np.zeros((L, n_pad), dtype=np.float32)
    counts[:, :n] = typed_incoming_counts

    edges = []
    for l, adj in enumerate(adjacency_lists):
        e = int(adj.shape[0])
        e_pad = int(e_pads[l])
        assert e_pad >= e, (l, e_pad, e)
        snd = np.full((e_pad,), n_pad, dtype=np.int32)
        rcv = np.full((e_pad,), n_pad, dtype=np.int32)
        msk = np.zeros((e_pad,), dtype=np.float32)
        if e:
            order = np.argsort(adj[:, 1], kind="stable")
            snd[:e] = adj[order, 0]
            rcv[:e] = adj[order, 1]
            msk[:e] = 1.0
        c = counts[l][np.minimum(rcv, n_pad - 1)]
        norm = (msk / (c + SMALL_NUMBER)).astype(np.float32)
        edges.append(EdgeBlock(senders=snd, receivers=rcv, mask=msk,
                               norm_scale=norm))

    graph_mask = np.zeros((g_pad,), dtype=np.float32)
    graph_mask[:num_graphs] = 1.0

    all_snd = np.concatenate([e.senders for e in edges])
    all_rcv = np.concatenate([e.receivers for e in edges])
    all_msk = np.concatenate([e.mask for e in edges])
    all_norm = np.concatenate([e.norm_scale for e in edges])
    all_type = np.concatenate([
        np.full(e.senders.shape[0], l, dtype=np.int32)
        for l, e in enumerate(edges)
    ])
    order = np.argsort(all_rcv, kind="stable")
    src_flat = all_type * np.int32(n_pad) + np.minimum(all_snd, n_pad - 1)
    src_flat = np.where(all_msk > 0, src_flat, L * n_pad).astype(np.int32)
    tgt_flat = all_type * np.int32(n_pad) + np.minimum(all_rcv, n_pad - 1)
    tgt_flat = np.where(all_msk > 0, tgt_flat, L * n_pad).astype(np.int32)

    rcv_sorted = all_rcv[order]
    is_new, rcv_rank = _group_ranks(rcv_sorted)
    tgt_sorted = tgt_flat[order]
    is_new_f, tgt_rank = _group_ranks(tgt_sorted)
    node_to_rank = np.zeros((n_pad,), dtype=np.int32)
    node_has_incoming = np.zeros((n_pad,), dtype=np.float32)
    real = (rcv_sorted < n_pad) & is_new
    node_to_rank[rcv_sorted[real]] = rcv_rank[real]
    node_has_incoming[np.unique(rcv_sorted[rcv_sorted < n_pad])] = 1.0

    src_in_stream = src_flat[order]
    perm_by_src = np.argsort(src_in_stream, kind="stable").astype(np.int32)
    svals = src_in_stream[perm_by_src]
    snew, src_sorted_rank = _group_ranks(svals)
    src_to_rank = np.full((L * n_pad,), -1, dtype=np.int32)
    keep = svals[snew] < L * n_pad
    src_to_rank[svals[snew][keep]] = src_sorted_rank[snew][keep]

    e_tot = int(src_sorted_rank.shape[0])
    src_from_rank = np.zeros(
        (src_rank_table_rows(L * n_pad, e_tot, 256),), dtype=np.int32)
    if e_tot:
        src_from_rank[src_sorted_rank[snew]] = np.minimum(
            svals[snew], L * n_pad - 1)

    rpad = fine_rank_table_rows(n_pad, L, int(tgt_rank.shape[0]), 256)
    fine_to_flat = np.zeros((rpad,), dtype=np.int32)
    fine_to_rcv = np.full((rpad,), n_pad, dtype=np.int32)
    fine_from_flat = np.full((L * n_pad,), -1, dtype=np.int32)
    if tgt_rank.shape[0]:
        fine_to_flat[tgt_rank[is_new_f]] = np.minimum(
            tgt_sorted[is_new_f], L * n_pad - 1)
        fine_to_rcv[tgt_rank[is_new_f]] = rcv_sorted[is_new_f]
        real_f = is_new_f & (tgt_sorted < L * n_pad)
        fine_from_flat[tgt_sorted[real_f]] = tgt_rank[real_f]

    t = torch.from_numpy
    flat = FlatEdges(
        src_flat=t(src_in_stream),
        tgt_flat=t(tgt_sorted),
        receivers=t(rcv_sorted),
        edge_type=t(all_type[order]),
        mask=t(all_msk[order]),
        norm_scale=t(all_norm[order]),
        perm_by_src=t(perm_by_src),
        rcv_rank=t(rcv_rank),
        tgt_rank=t(tgt_rank),
        src_sorted_rank=t(src_sorted_rank),
        src_to_rank=t(src_to_rank),
        src_from_rank=t(src_from_rank),
        fine_rank_by_src=t(np.ascontiguousarray(tgt_rank[perm_by_src])),
        fine_to_flat=t(fine_to_flat),
        fine_to_rcv=t(fine_to_rcv),
        fine_from_flat=t(fine_from_flat),
    )
    return GraphBatch(
        node_features=t(feats),
        node_mask=t(node_mask),
        node_graph_ids=t(gids),
        flat=flat,
        node_to_rank=t(node_to_rank),
        node_has_incoming=t(node_has_incoming),
        typed_incoming_counts=t(counts),
        graph_mask=t(graph_mask),
        num_graphs=int(num_graphs),
    )


def graph_to_device(graph: GraphBatch, device) -> GraphBatch:
    """Copy every tensor of a batch to `device` (ints stay host ints)."""
    def move(x):
        return x.to(device, non_blocking=True) if torch.is_tensor(x) else x

    flat = FlatEdges(*(move(x) for x in graph.flat))
    return graph._replace(
        flat=flat,
        **{k: move(getattr(graph, k)) for k in graph._fields
           if k not in ("flat", "num_graphs")},
    )
