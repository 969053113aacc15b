"""Static-shape batched graph representation (counterpart of
tf_gnn_samples_tpu/ops/graph.py).

The host-side construction is numpy, as in the JAX package, and every
emitted field equals the JAX package's array for the same input. The
batch carries the fields the ported layers read, the target-sorted view
(`perm_by_tgt`, `tgt_sorted_rank`, `tgt_to_rank`, `win_tgt`: the ranked
backward of gather_flat_tgt with `ranked`) among them. The
rank windows are plain ints here (the JAX package encodes them in array
shapes to keep them static under jit); the CUDA kernels reduce over
sorted ranks and ignore them, but `win_fine` gates the diluted src stream
and `win_sd` decides which src stream the layers feed, so both packages
walk the same edges. The port has no `unify_flat_windows`: the JAX
package makes a cached fold's windows and diluted-stream lengths common
only so that its batches stack into one jit shape, and the port runs, and
captures, each batch at its own (runtime/model.py batch_shape_key).

Padding contract: nodes are padded to `n_pad` and edges of each type to
`e_pads[l]`. Padded edges point their receiver at the dump row `n_pad`,
their flat source/target at `L * n_pad` (one past the type-stacked node
table, clamped by every gather), and share the final dump rank; dump and
slack rank-table rows are never mapped back to real nodes. Rank tables
keep the JAX package's heights (`fine_rank_table_rows`,
`src_rank_table_rows`, slack rows included), so every index map means the
same thing in both packages.
"""

from typing import NamedTuple, Optional, Sequence, Tuple

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
    perm_by_tgt: torch.Tensor  # [E_tot] int32; tgt_flat[perm] is sorted
    # Gap-free nondecreasing group ranks of the stream: coarse (receiver)
    # and fine (receiver, type); padded edges share the final dump rank.
    rcv_rank: torch.Tensor  # [E_tot] int32
    tgt_rank: torch.Tensor  # [E_tot] int32
    # Ranks of the src-sorted stream and the node-table <-> rank maps
    # (-1 = the slot sends no edge; 0 for slack rows of src_from_rank).
    src_sorted_rank: torch.Tensor  # [E_tot] int32 (by perm_by_src)
    src_to_rank: torch.Tensor  # [L * n_pad] int32
    src_from_rank: torch.Tensor  # [R_src] int32
    # The same for the tgt-sorted stream (gather_flat_tgt, ranked).
    tgt_sorted_rank: torch.Tensor  # [E_tot] int32 (by perm_by_tgt)
    tgt_to_rank: torch.Tensor  # [L * n_pad] int32
    # Fine rank of each edge of the src-sorted stream (tgt_rank[perm]).
    fine_rank_by_src: torch.Tensor  # [E_tot] int32
    # Fine-rank maps: flat node-table row / receiver of each fine rank
    # (slack rows -> 0 / dump row n_pad), and the inverse map.
    fine_to_flat: torch.Tensor  # [RPAD] int32
    fine_to_rcv: torch.Tensor  # [RPAD] int32
    fine_from_flat: torch.Tensor  # [L * n_pad] int32
    # Max aligned rank span of any 256-edge sub-block (rank_window; 0 = no
    # useful window): win_fine covers tgt_rank and rcv_rank, win_src the
    # src-sorted ranks, win_tgt the tgt-sorted ones, win_sd the diluted
    # stream below (0 = not engaged).
    win_fine: int
    win_src: int
    win_tgt: int
    win_sd: int
    # DILUTED src-sorted stream: the real edges of the src stream re-blocked
    # with inert fill slots so that every 256-edge sub-block's aligned rank
    # span fits win_sd. A fill slot repeats the previous rank and carries
    # SD_FILL in sd_fine / sd_coarse; consumers clamp it onto a zero row.
    # Length ceil(1.03 * E_tot / 2048) * 2048 where the fine window
    # engaged, else 0; with win_sd 0 it holds the undiluted stream.
    sd_rank: torch.Tensor  # [E_sd] int32
    sd_fine: torch.Tensor  # [E_sd] int32 (fill -> SD_FILL)
    sd_coarse: torch.Tensor  # [E_sd] int32 (fill -> SD_FILL)
    # TYPE-MAJOR view: the same edges in per-type-block order (the
    # concatenation of the receiver-sorted EdgeBlocks before the global
    # receiver sort). Each type's edges are CONTIGUOUS, at the static
    # offsets tm_offs, so a type-dependent per-edge dense stage runs as L
    # whole matmuls on slices (GNN-Edge-MLP1). tm_rank are the gap-free
    # nondecreasing (type, receiver) group ranks of this order (each
    # type's padded edges form a dump group of their own); tm_to_flat /
    # tm_from_flat / tm_to_rcv mirror the fine-rank maps. The src-SORTED
    # stream of this view has the same values as the receiver-major one's,
    # so src_sorted_rank / src_to_rank / win_src are shared and only the
    # permutation (tm_perm_by_src) differs. SELF-LOOP types (every real
    # edge has sender == receiver) are combined node-side by their
    # consumers: tm_self flags them, their tm_from_flat slots are -1 and
    # their rank rows map to the dump receiver, so stream-side values on
    # their rows never reach real nodes; win_tm is measured over the
    # 256-edge blocks that hold an edge of another type.
    tm_src_flat: torch.Tensor  # [E_tot] int32
    tm_rank: torch.Tensor  # [E_tot] int32
    tm_perm_by_src: torch.Tensor  # [E_tot] int32
    tm_rank_by_src: torch.Tensor  # [E_tot] int32 (tm_rank[tm_perm_by_src])
    tm_to_flat: torch.Tensor  # [RPAD] int32
    tm_from_flat: torch.Tensor  # [L * n_pad] int32
    tm_to_rcv: torch.Tensor  # [RPAD] int32
    win_tm: int
    tm_self: Tuple[bool, ...]  # per type: a pure self-loop type
    tm_offs: Tuple[int, ...]  # L + 1 offsets of the types' slices


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


def rank_window(ranks: np.ndarray, block: int = 256) -> int:
    """Max aligned rank span of any `block`-edge sub-block of gap-free
    nondecreasing `ranks`, rounded up to a power of two in [16, 128]; spans
    beyond 128 return 0 (no useful window)."""
    e = int(ranks.shape[0])
    if e == 0:
        return 16
    firsts = ranks[0:e:block].astype(np.int64) & ~7
    lasts = ranks[np.minimum(np.arange(block - 1, e + block - 1, block),
                             e - 1)]
    span = int((lasts - firsts).max()) + 1
    for cand in (16, 32, 64, 128):
        if span <= cand:
            return cand
    return 0


def _rank_window_masked(ranks: np.ndarray, relevant: np.ndarray,
                        block: int = 256) -> int:
    """rank_window over only the blocks that hold any `relevant` edge
    (FlatEdges.tm_self: blocks of self-loop edges alone are exempt, their
    rows never reach real nodes)."""
    e = int(ranks.shape[0])
    if e == 0:
        return 16
    firsts = ranks[0:e:block].astype(np.int64) & ~7
    lasts = ranks[np.minimum(np.arange(block - 1, e + block - 1, block),
                             e - 1)]
    keep = np.logical_or.reduceat(relevant, np.arange(0, e, block))
    span = int((lasts - firsts + 1)[keep].max()) if keep.any() else 0
    for cand in (16, 32, 64, 128):
        if span <= cand:
            return cand
    return 0


def _merge_windows(a: int, b: int) -> int:
    """Combine two window bounds: 0 (no window) dominates."""
    return max(a, b) if (a and b) else 0


# Fill-slot sentinel of the diluted companion arrays: consumers clamp it
# onto a zero row appended to whatever table they key.
SD_FILL = np.int32(2**31 - 1)


def _dilute_src_stream(ranks_real: np.ndarray, companions, cap: int,
                       block: int = 256):
    """Re-block a sorted gap-free rank stream with inert fill slots so
    every `block`-edge sub-block's aligned span fits the smallest W in
    {32, 64, 128} within the `cap` slot budget. Returns (sd_rank,
    [sd_companions], W) of length exactly `cap`, or None if no W fits.
    Fill slots repeat the previous rank and carry SD_FILL in every
    companion array (per-edge values gathered alongside the stream)."""
    e = int(ranks_real.shape[0])
    if e == 0 or cap < block:
        return None
    for W in (32, 64, 128):
        # limit[i] = first index whose rank falls outside the aligned
        # window that starts at ranks[i].
        limit = np.searchsorted(
            ranks_real, (ranks_real & ~np.int32(7)) + np.int32(W),
            side="left")
        pieces = []
        i = 0
        while i < e and len(pieces) * block <= cap:
            take = min(block, int(limit[i]) - i)
            pieces.append((i, take))
            i += take
        if len(pieces) * block > cap:
            continue
        sd_rank = np.empty((cap,), np.int32)
        sd_comp = [np.full((cap,), SD_FILL, np.int32) for _ in companions]
        pos = 0
        for i0, take in pieces:
            sd_rank[pos:pos + take] = ranks_real[i0:i0 + take]
            for arr, comp in zip(sd_comp, companions):
                arr[pos:pos + take] = comp[i0:i0 + take]
            sd_rank[pos + take:pos + block] = ranks_real[i0 + take - 1]
            pos += block
        sd_rank[pos:] = ranks_real[e - 1]
        return sd_rank, sd_comp, W
    return None


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
    perm_by_tgt = np.argsort(tgt_sorted, kind="stable").astype(np.int32)
    tvals = tgt_sorted[perm_by_tgt]
    tnew, tgt_sorted_rank = _group_ranks(tvals)
    tgt_to_rank = np.full((L * n_pad,), -1, dtype=np.int32)
    keep = tvals[tnew] < L * n_pad
    tgt_to_rank[tvals[tnew][keep]] = tgt_sorted_rank[tnew][keep]

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

    # Diluted src stream: the real edges are the src-sorted prefix (padded
    # edges carry the L * n_pad sentinel and sort last). Its cap is 1.03x
    # the flat stream, and it is gated on the FINE window: without one the
    # JAX package's consumers of the stream disengage.
    fine_by_src = np.ascontiguousarray(tgt_rank[perm_by_src])
    coarse_by_src = rcv_rank[perm_by_src]
    n_real_src = int((all_msk > 0).sum())
    win_fine = _merge_windows(rank_window(tgt_rank), rank_window(rcv_rank))
    cap_sd = (-(-103 * e_tot // (100 * 2048)) * 2048
              if (e_tot and win_fine) else 0)
    dil = _dilute_src_stream(
        src_sorted_rank[:n_real_src],
        [fine_by_src[:n_real_src], coarse_by_src[:n_real_src]], cap_sd)
    if dil is not None:
        sd_rank, (sd_fine, sd_coarse), win_sd = dil
    else:
        win_sd = 0
        sd_rank = np.zeros((cap_sd,), np.int32)
        sd_fine = np.full((cap_sd,), SD_FILL, np.int32)
        sd_coarse = np.full((cap_sd,), SD_FILL, np.int32)
        if cap_sd:
            sd_rank[:e_tot] = src_sorted_rank
            sd_rank[e_tot:] = src_sorted_rank[-1]
            sd_fine[:e_tot] = fine_by_src
            sd_coarse[:e_tot] = coarse_by_src

    # Type-major view: src_flat / tgt_flat / all_rcv above are in that
    # order. Each type block is receiver-sorted with its padded edges last,
    # so the group ranks over tgt_flat are nondecreasing and gap-free.
    tm_new, tm_rank = _group_ranks(tgt_flat)
    type_is_self = tuple(
        bool(adj.shape[0]) and bool(np.all(adj[:, 0] == adj[:, 1]))
        for adj in adjacency_lists)
    edge_is_self = np.asarray(type_is_self, dtype=bool)[all_type]
    tm_to_flat = np.zeros((rpad,), dtype=np.int32)
    tm_to_rcv = np.full((rpad,), n_pad, dtype=np.int32)
    tm_from_flat = np.full((L * n_pad,), -1, dtype=np.int32)
    if e_tot:
        tm_to_flat[tm_rank[tm_new]] = np.minimum(tgt_flat[tm_new],
                                                 L * n_pad - 1)
        tm_to_rcv[tm_rank[tm_new]] = np.where(edge_is_self[tm_new], n_pad,
                                              all_rcv[tm_new])
        real_tm = tm_new & (tgt_flat < L * n_pad) & ~edge_is_self
        tm_from_flat[tgt_flat[real_tm]] = tm_rank[real_tm]
    tm_perm_by_src = np.argsort(src_flat, kind="stable").astype(np.int32)
    tm_offs = np.cumsum([0] + [e.senders.shape[0] for e in edges])

    t = torch.from_numpy
    flat = FlatEdges(
        src_flat=t(src_in_stream),
        tgt_flat=t(tgt_sorted),
        receivers=t(rcv_sorted),
        edge_type=t(all_type[order]),
        mask=t(all_msk[order]),
        norm_scale=t(all_norm[order]),
        perm_by_src=t(perm_by_src),
        perm_by_tgt=t(perm_by_tgt),
        rcv_rank=t(rcv_rank),
        tgt_rank=t(tgt_rank),
        src_sorted_rank=t(src_sorted_rank),
        src_to_rank=t(src_to_rank),
        src_from_rank=t(src_from_rank),
        tgt_sorted_rank=t(tgt_sorted_rank),
        tgt_to_rank=t(tgt_to_rank),
        fine_rank_by_src=t(fine_by_src),
        fine_to_flat=t(fine_to_flat),
        fine_to_rcv=t(fine_to_rcv),
        fine_from_flat=t(fine_from_flat),
        win_fine=win_fine,
        win_src=rank_window(src_sorted_rank),
        win_tgt=rank_window(tgt_sorted_rank),
        win_sd=win_sd,
        sd_rank=t(sd_rank),
        sd_fine=t(sd_fine),
        sd_coarse=t(sd_coarse),
        tm_src_flat=t(src_flat),
        tm_rank=t(tm_rank),
        tm_perm_by_src=t(tm_perm_by_src),
        tm_rank_by_src=t(np.ascontiguousarray(tm_rank[tm_perm_by_src])),
        tm_to_flat=t(tm_to_flat),
        tm_from_flat=t(tm_from_flat),
        tm_to_rcv=t(tm_to_rcv),
        win_tm=_rank_window_masked(tm_rank, ~edge_is_self),
        tm_self=type_is_self,
        tm_offs=tuple(int(o) for o in tm_offs),
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
    """Copy every tensor of a batch to `device` (ints and tuples of
    static values stay on the host)."""
    def move(x):
        return x.to(device, non_blocking=True) if torch.is_tensor(x) else x

    flat = FlatEdges(*(move(x) for x in graph.flat))
    return graph._replace(
        flat=flat,
        **{k: move(getattr(graph, k)) for k in graph._fields
           if k not in ("flat", "num_graphs")},
    )
