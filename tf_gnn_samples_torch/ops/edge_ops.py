"""Edge-level gathers, aggregation and receiver softmaxes over the flat
edge stream (counterpart of the part of tf_gnn_samples_tpu/ops/edge_ops.py
the ported layers use).

Gathers clamp their indices as `jnp.take(..., mode="clip")` does: padded
edges carry src_flat / tgt_flat = L * n_pad, one row past the type-stacked
table, and torch's index_select does not clamp. Their (finite, garbage)
rows reach only the dump receiver or the dump rank, so their cotangents
are zero.
"""

import numpy as np
import torch

from .. import SMALL_NUMBER
from . import ranked_segment as rs
from .segment import segment_max, segment_sum


def _take_clip(table, idx):
    return table.index_select(0, idx.clamp(0, table.shape[0] - 1))


def gather_flat_src(table_flat, flat):
    """table_flat[[L*N, ...]][src_flat]: per-edge source-side rows."""
    return _take_clip(table_flat, flat.src_flat)


def ranked_gather_ok(table_flat, flat, rank_field: str) -> bool:
    """The JAX package's _ranked_gather_ok without its TPU, interpret-mode
    and VMEM terms (the CUDA kernel keeps no table on chip): the stream's
    sorted ranks `rank_field` are present, the rows have at least 64
    columns and the stream is whole STEP-edge rows."""
    if getattr(flat, rank_field, None) is None:
        return False
    if int(np.prod(table_flat.shape[1:], dtype=np.int64)) < 64:
        return False
    return rs.ranked_supported(flat.src_flat.shape[0])


def gather_flat_tgt(table_flat, flat, ranked=False):
    """table_flat[[L*N, ...]][tgt_flat]: per-edge target-side rows. With
    `ranked`, the backward sums over the tgt-sorted ranks (K5a,
    _GatherRanked) where ranked_gather_ok holds, as the JAX package's
    gather_flat_tgt does on the TPU. Only RGCN's edge-stream branch with
    use_both_source_and_target asks for it: the port's f32 branches keep
    the plain backward (as its source-side f32 branches keep
    gather_flat_src), because off the TPU the JAX package's gathers are
    f32 and its tests hold those branches to it at f32 tolerances."""
    if not (ranked and ranked_gather_ok(table_flat, flat, "tgt_sorted_rank")):
        return _take_clip(table_flat, flat.tgt_flat)
    tail = tuple(table_flat.shape[1:])
    out = _GatherRanked.apply(
        table_flat.reshape(table_flat.shape[0], -1), flat.tgt_flat,
        flat.perm_by_tgt, flat.tgt_sorted_rank, flat.tgt_to_rank)
    return out.reshape((flat.tgt_flat.shape[0],) + tail)


def _rank_rows_to_table(rank_table, to_rank, table_rows: int, dtype):
    """The node-table rows [table_rows, D] of a src-rank table: row i is
    rank_table[to_rank[i]], 0 where to_rank is -1 (no edge reads the row)
    and past to_rank's L * n_pad rows (a table may carry more)."""
    d = rank_table.index_select(0, to_rank.clamp(min=0))
    d = torch.where((to_rank >= 0)[:, None], d, 0.0).to(dtype)
    pad = table_rows - d.shape[0]
    return torch.nn.functional.pad(d, (0, 0, 0, pad)) if pad else d


class _GatherRanked(torch.autograd.Function):
    """table[idx] whose backward sums the per-edge cotangent through the
    ranked segment-sum (K5a) instead of a scatter (the JAX package's
    _gather_ranked): the cotangent is rounded to bf16 and permuted into
    idx-sorted order, summed in f32 per gap-free rank of that order, and
    rank rows are mapped back to table rows by one row take (`to_rank`,
    -1 = no edge reads the row). On the card the sum is deterministic up
    to K5a's seam atomics, where index_select's own backward would add
    bf16 values atomically in a random order."""

    @staticmethod
    def forward(ctx, table, idx, perm, sorted_rank, to_rank):
        ctx.save_for_backward(perm, sorted_rank, to_rank)
        ctx.table_rows, ctx.table_dtype = table.shape[0], table.dtype
        return _take_clip(table, idx)

    @staticmethod
    def backward(ctx, g):
        perm, sorted_rank, to_rank = ctx.saved_tensors
        rows = rs.src_rank_table_rows(ctx.table_rows, perm.shape[0], 256)
        g_perm = g.to(torch.bfloat16).index_select(0, perm)
        rank_table = rs.ranked_segment_sum_table(g_perm, sorted_rank, rows)
        return (_rank_rows_to_table(rank_table, to_rank, ctx.table_rows,
                                    ctx.table_dtype), None, None, None, None)


def gather_flat_src_ranked(table_flat, flat):
    """gather_flat_src of a 2-D table with the ranked backward (see
    _GatherRanked). The JAX package takes this form where its on-chip
    table budget allows; the CUDA kernel keeps no table on chip, so the
    port's callers that stream bf16 rows take it at every size."""
    return _GatherRanked.apply(table_flat, flat.src_flat, flat.perm_by_src,
                               flat.src_sorted_rank, flat.src_to_rank)


# ---- type-major stream ops (FlatEdges.tm_*) ------------------------------

_TM_FIELDS = ("tm_src_flat", "tm_rank", "tm_perm_by_src", "tm_to_flat",
              "tm_from_flat", "tm_to_rcv", "win_tm", "tm_self", "tm_offs",
              "src_sorted_rank", "src_to_rank", "win_src")


def tm_available(graph) -> bool:
    """Whether the batch carries the type-major view (every batch that
    pad_graph_batch builds does)."""
    return all(getattr(graph.flat, f, None) is not None for f in _TM_FIELDS)


def tm_self_types(graph):
    """Per-type self-loop flags of the type-major view."""
    return tuple(graph.flat.tm_self)


def gather_tm_src(table_flat, graph):
    """table_flat[tm_src_flat] over the TYPE-MAJOR stream; the backward is
    the ranked segment-sum (K5a) over the SHARED src-sorted ranks: both
    stream orders have the same src-sorted values, only the permutation
    (tm_perm_by_src) differs."""
    flat = graph.flat
    return _GatherRanked.apply(table_flat, flat.tm_src_flat,
                               flat.tm_perm_by_src, flat.src_sorted_rank,
                               flat.src_to_rank)


def gather_node_tgt(table, flat):
    """table[[N, ...]][receivers]: per-edge row of a node table; padded
    edges (receiver n_pad) read the last row."""
    return _take_clip(table, flat.receivers)


# ---- per-type block ops (ops/typed_stream.py TypedEdges blocks) ----------

def gather_src_stacked(table, te_l):
    """table[[N, ...]][senders] for one type's block (typed_stream
    type_block); padded senders (n_pad) read the last row."""
    return _take_clip(table, te_l.senders)


def gather_tgt_stacked(table, te_l):
    """table[[N, ...]][receivers] for one type's block; receivers sorted."""
    return _take_clip(table, te_l.receivers)


def aggregate_sum_block(messages, block, n_pad: int):
    """Sum one block's per-edge messages into receiver rows: [E, ...] ->
    [n_pad, ...] (padded edges go to the dump row n_pad, sliced off)."""
    return segment_sum(messages, block.receivers, n_pad + 1)[:n_pad]


def _per_node(count, like):
    """[n] -> [n, 1, ...] broadcastable against `like` [n, ...]."""
    return count.reshape(count.shape + (1,) * (like.dim() - 1))


def aggregate_flat_sum(messages, flat, n_pad: int):
    """Sum per-edge messages [E, ...] into receiver rows [n_pad, ...] over
    the WHOLE edge stream, every edge type in one segment-sum; the dump row
    n_pad (padded edges) is sliced off."""
    return segment_sum(messages, flat.receivers, n_pad + 1)[:n_pad]


def aggregate_flat(messages, flat, n_pad: int, aggregation: str):
    """Named aggregation (reference utils/utils.py:23-33) of per-edge
    messages into receiver rows over the whole stream; the dump row n_pad
    (padded edges) is sliced off."""
    if aggregation in ("sum", "unsorted_segment_sum"):
        return aggregate_flat_sum(messages, flat, n_pad)
    if aggregation in ("mean", "unsorted_segment_mean",
                       "sqrt_n", "unsorted_segment_sqrt_n"):
        total = aggregate_flat_sum(messages, flat, n_pad)
        count = segment_sum(flat.mask, flat.receivers, n_pad + 1)[:n_pad]
        count = count.clamp(min=1.0)
        if aggregation.endswith("sqrt_n"):
            count = torch.sqrt(count)
        return total / _per_node(count, total)
    if aggregation in ("max", "unsorted_segment_max"):
        return segment_max(messages, flat.receivers, n_pad + 1)[:n_pad]
    raise ValueError("Unknown aggregation function '%s'!" % aggregation)


def ranked_aggregation_ok(graph, aggregation: str) -> bool:
    """Whether aggregation takes the ranked segment-sum (K5a): the JAX
    package's gate without its device and VMEM terms (the CUDA kernels keep
    no table on chip), so it is the same on every device and the CPU runs
    the plain K5a. Max has no ranked form."""
    if aggregation in ("max", "unsorted_segment_max"):
        return False
    return rs.ranked_supported(graph.flat.rcv_rank.shape[0])


def ranked_table_to_nodes(table, graph):
    """Map a COARSE rank table [RPAD, D] back to node rows [n_pad, D]."""
    out = _take_clip(table, graph.node_to_rank)
    return out * graph.node_has_incoming[:, None]


def aggregate_flat_ranked(messages, graph, aggregation: str):
    """Named sum-family aggregation through the ranked segment-sum (K5a,
    whose VJP is K5b); the caller checked ranked_aggregation_ok."""
    n_pad = graph.n_pad
    table = rs.ranked_segment_sum_table(
        messages.reshape(messages.shape[0], -1), graph.flat.rcv_rank,
        rs.rank_table_rows(n_pad, 256))
    out = ranked_table_to_nodes(table, graph).reshape(
        (n_pad,) + tuple(messages.shape[1:]))
    if aggregation in ("sum", "unsorted_segment_sum"):
        return out
    count = graph.typed_incoming_counts.sum(0).clamp(min=1.0)
    if aggregation.endswith("sqrt_n"):
        count = torch.sqrt(count)
    return out / _per_node(count, out)


class _GatherSegsum(torch.autograd.Function):
    """table_flat[src] summed per COARSE receiver rank (K5a), with a
    SOURCE-ORDER backward (the JAX package's _gather_segsum): the forward
    is a plain segment-sum by receiver, so each edge's cotangent is its
    receiver's row of the table cotangent. The backward re-gathers that row
    per edge of the src-sorted stream from the small [rows, D] table
    cotangent (rounded to bf16) and sums it per src rank (K5a again), so no
    [E, D] cotangent is permuted between edge orders. `coarse_by_src` /
    `stream_rank` are the src-order stream of _src_bwd_stream; its fill
    slots (SD_FILL keys) and padded edges read zero rows."""

    @staticmethod
    def forward(ctx, table_flat, src_flat, rcv_rank, coarse_by_src,
                stream_rank, src_to_rank, rows, src_rows):
        m = _take_clip(table_flat, src_flat)
        ctx.save_for_backward(coarse_by_src, stream_rank, src_to_rank)
        ctx.rows, ctx.src_rows = rows, src_rows
        ctx.table_rows, ctx.table_dtype = table_flat.shape[0], table_flat.dtype
        return rs._segsum_table_impl(m, rcv_rank, table_rows=rows)

    @staticmethod
    def backward(ctx, g):
        coarse_by_src, stream_rank, src_to_rank = ctx.saved_tensors
        # Appended zero rows: the diluted stream's fill slots clamp onto
        # the first of them, so they stay inert for any cotangent.
        gz = rs._zero_extended(g.to(torch.bfloat16))
        g_edge = gz.index_select(0, coarse_by_src.clamp(max=ctx.rows))
        dt_table = rs._segsum_table_impl(g_edge, stream_rank,
                                         table_rows=ctx.src_rows)
        return (_rank_rows_to_table(dt_table, src_to_rank, ctx.table_rows,
                                    ctx.table_dtype),) + (None,) * 7


def _src_bwd_stream(flat):
    """(coarse_by_src, stream_rank) of the src-order backward: the DILUTED
    sd_coarse / sd_rank where its window engaged, else the receiver rank of
    each src-sorted edge and the undiluted src ranks (the stream the JAX
    package feeds its own kernels)."""
    if flat.win_sd:
        return flat.sd_coarse, flat.sd_rank
    return flat.rcv_rank.index_select(0, flat.perm_by_src), flat.src_sorted_rank


def gather_aggregate_src_ok(graph, aggregation: str) -> bool:
    """Eligibility of the fused gather + segment-sum: the JAX package's
    gate with its semantic terms (the src-sorted fields exist, sum-family
    aggregation on a ranked stream) and without its VMEM term (the CUDA
    kernel keeps no table on chip, so no width or height rules it out)."""
    flat = graph.flat
    if flat.src_sorted_rank is None or flat.src_to_rank is None:
        return False
    return ranked_aggregation_ok(graph, aggregation)


def gather_aggregate_src(table_flat, graph, aggregation: str):
    """aggregate_flat_ranked(gather_flat_src(table_flat)) as one op whose
    backward never materialises an [E, D] reorder (see _GatherSegsum).
    table_flat: type-stacked node table [L * n_pad (+ extra), D]; the caller
    checked gather_aggregate_src_ok."""
    flat = graph.flat
    coarse_by_src, stream_rank = _src_bwd_stream(flat)
    # The backward's src-rank table is as high as src_from_rank, the height
    # the batch gives every src-rank table (the JAX package's
    # _gather_src_rows may be one row higher; no row past the last rank is
    # read back).
    table = _GatherSegsum.apply(
        table_flat, flat.src_flat, flat.rcv_rank, coarse_by_src, stream_rank,
        flat.src_to_rank, rs.rank_table_rows(graph.n_pad, 256),
        flat.src_from_rank.shape[0])
    out = ranked_table_to_nodes(table, graph)
    if aggregation in ("sum", "unsorted_segment_sum"):
        return out
    count = graph.typed_incoming_counts.sum(0).clamp(min=1.0)
    if aggregation.endswith("sqrt_n"):
        count = torch.sqrt(count)
    return out / count[:, None]


class _GatherSegsumFine(torch.autograd.Function):
    """table_flat[src] (times the 1/c scale with `normalize`) summed per
    FINE (receiver, type) rank (K5a), with a SOURCE-ORDER backward (the
    JAX package's _gather_segsum_fine, the fine-rank sibling of
    _GatherSegsum): each edge's cotangent is its fine group's row of the
    table cotangent (times its scale), so the backward re-gathers that row
    per edge of the src-sorted stream from the bf16 [fine_rows, D] table
    cotangent and sums it per src rank (K5a again), without permuting an
    [E, D] cotangent between edge orders. The scaled forward stream is f32
    and K5a rounds each term to bf16 as it loads it, where the JAX kernel
    rounds; the scaled backward term is rounded to bf16 before K5a, as JAX
    does. `fine_by_src` / `stream_rank` are the src-order stream of
    gather_aggregate_fine; its fill slots (SD_FILL keys) and padded edges
    read zero rows."""

    @staticmethod
    def forward(ctx, table_flat, src_flat, tgt_rank, fine_by_src,
                stream_rank, src_to_rank, norm_scale, perm_by_src, fine_rows,
                src_rows, normalize):
        m = _take_clip(table_flat, src_flat)
        if normalize:
            m = m.to(torch.float32) * norm_scale[:, None]
            ctx.save_for_backward(fine_by_src, stream_rank, src_to_rank,
                                  norm_scale.index_select(0, perm_by_src))
        else:
            ctx.save_for_backward(fine_by_src, stream_rank, src_to_rank)
        ctx.fine_rows, ctx.src_rows, ctx.normalize = (fine_rows, src_rows,
                                                      normalize)
        ctx.table_rows, ctx.table_dtype = table_flat.shape[0], table_flat.dtype
        return rs._segsum_table_impl(m, tgt_rank, table_rows=fine_rows)

    @staticmethod
    def backward(ctx, g):
        fine_by_src, stream_rank, src_to_rank = ctx.saved_tensors[:3]
        # Appended zero rows: the diluted stream's fill slots clamp onto
        # the first of them, so they stay inert for any cotangent.
        gz = rs._zero_extended(g.to(torch.bfloat16))
        g_edge = gz.index_select(0, fine_by_src.clamp(max=ctx.fine_rows))
        if ctx.normalize:
            scale_by_src = ctx.saved_tensors[3]
            g_edge = (g_edge.to(torch.float32)
                      * scale_by_src[:, None]).to(torch.bfloat16)
        dt_table = rs._segsum_table_impl(g_edge, stream_rank,
                                         table_rows=ctx.src_rows)
        return (_rank_rows_to_table(dt_table, src_to_rank, ctx.table_rows,
                                    ctx.table_dtype),) + (None,) * 10


def gather_aggregate_fine_ok(graph) -> bool:
    """Eligibility of the fused gather + FINE-rank segment-sum: the JAX
    package's gate with its semantic terms (the src-sorted fields exist, a
    stream of whole STEP-edge rows) and without its device and VMEM terms
    (the CUDA kernel keeps no table on chip)."""
    flat = graph.flat
    if (flat.src_sorted_rank is None or flat.src_to_rank is None
            or flat.fine_rank_by_src is None):
        return False
    return rs.ranked_supported(flat.src_flat.shape[0])


def gather_aggregate_fine(table_flat, graph, normalize: bool):
    """ranked_segment_sum_table(gather_flat_src(table_flat) * norm) over
    FINE (receiver, type) ranks as one op whose backward never
    materialises an [E, D] reorder (see _GatherSegsumFine). table_flat:
    type-stacked node table [L * n_pad (+ extra), D]; the caller checked
    gather_aggregate_fine_ok. Returns the fine rank table [RPAD, D].

    The backward takes the DILUTED src stream where its window engaged and
    `normalize` is off; the normalised backward needs each edge's scale in
    src order (norm_scale[perm_by_src]), which the diluted stream does not
    carry, so it keeps the undiluted stream (as the JAX package)."""
    flat = graph.flat
    if not normalize and flat.win_sd:
        fine_by_src, stream_rank = flat.sd_fine, flat.sd_rank
    else:
        fine_by_src, stream_rank = flat.fine_rank_by_src, flat.src_sorted_rank
    # The backward's src-rank table is as high as src_from_rank (see
    # gather_aggregate_src).
    return _GatherSegsumFine.apply(
        table_flat, flat.src_flat, flat.tgt_rank, fine_by_src, stream_rank,
        flat.src_to_rank, flat.norm_scale, flat.perm_by_src,
        flat.fine_to_flat.shape[0], flat.src_from_rank.shape[0], normalize)


def _edge_mask(flat, like):
    """[E] stream mask broadcastable against `like` [E, ...]."""
    return flat.mask.reshape(flat.mask.shape + (1,) * (like.dim() - 1))


def segment_softmax_flat(logits, flat, n_pad: int):
    """Softmax per receiver over all incoming edges of all types (reference
    RGAT semantics, gnns/rgat.py:126-130) on the flat stream [E, ...]: one
    segment max and one segment sum. Padded edges get weight 0."""
    neg = torch.finfo(logits.dtype).min
    mask = _edge_mask(flat, logits)
    masked = torch.where(mask > 0, logits, neg)
    gmax = segment_max(masked, flat.receivers, n_pad + 1)[:n_pad]
    # exp over the MASKED logits: a padded edge sees neg minus a shift that
    # is either neg (exp(0) * mask = 0) or finite (exp(-huge) = 0); the raw
    # logits could overflow to inf there, and inf * 0 is NaN.
    ex = torch.exp(masked - gather_node_tgt(gmax, flat)) * mask
    denom = segment_sum(ex, flat.receivers, n_pad + 1)[:n_pad]
    return ex / (gather_node_tgt(denom, flat) + SMALL_NUMBER)


def _clamped_exp(logits, clamp: float):
    """exp(clip(logits, -clamp, clamp)). The clip is a minimum of a maximum
    so that its derivative is jnp.clip's: 1 inside, 0 outside and 1/2 at
    exactly +-clamp (torch.clamp's is 1 there). The bounds are filled on
    the logits' device (no host-to-device copy, so a CUDA graph can
    capture it)."""
    lo = logits.new_full((), -clamp)
    hi = logits.new_full((), clamp)
    return torch.exp(torch.minimum(torch.maximum(logits, lo), hi))


def segment_softmax_flat_ranked(logits, graph, clamp: float = 50.0):
    """Receiver softmax of [E, K] logits through the ranked segment-sum /
    expand pair (K5a, K5b) over the coarse receiver ranks.

    Uses a clamped exp instead of a max shift: softmax is shift-invariant,
    and clamping |logit| at 50 only distorts segments whose logit SPREAD
    exceeds 50 (attention weights below e^-50 are zero either way). A
    segment whose logits all clamp low gets the weights e^-50 / (n e^-50 +
    SMALL_NUMBER), which vanish, as in the JAX package. Padded edges get
    weight 0 via the stream mask. The denominator reaches the edges
    rounded to bf16 (K5b).

    No layer calls this row-major variant, here or in the JAX package
    (RGAT takes the head-major one below); it is the counterpart of that
    package's function of the same name and is held against it by the
    tests."""
    flat = graph.flat
    ex = _clamped_exp(logits, clamp) * _edge_mask(flat, logits)
    rows = rs.rank_table_rows(graph.n_pad, 256)
    den = rs.ranked_segment_sum_table(ex, flat.rcv_rank, rows)
    return ex / (rs.ranked_expand_table(den, flat.rcv_rank, rows)
                 + SMALL_NUMBER)


def segment_softmax_flat_ranked_t(logits_t, graph, clamp: float = 50.0):
    """Head-major variant of segment_softmax_flat_ranked: logits and the
    returned attention weights are [K, E], and the denominator runs
    through K6a and K6b."""
    flat = graph.flat
    ex = _clamped_exp(logits_t, clamp) * flat.mask[None, :]
    rows = rs.rank_table_rows(graph.n_pad, 256)
    den = rs.ranked_segment_sum_table_t(ex, flat.rcv_rank, rows)
    return ex / (rs.ranked_expand_table_t(den, flat.rcv_rank, rows)
                 + SMALL_NUMBER)


def dense_adjacency(graph):
    """Per-type dense adjacency [L, n_pad, n_pad] f32 with A[l, v, u] = the
    number of type-l edges u -> v, built from the flat stream (sender u =
    src_flat - type * n_pad). Padded edges (receiver n_pad) land in one
    dump slot past the matrices, as the JAX package's out-of-bounds
    scatter drops them."""
    flat = graph.flat
    n_pad, num_types = graph.n_pad, graph.num_edge_types
    size = num_types * n_pad * n_pad
    et = flat.edge_type.long()
    idx = (et * n_pad + flat.receivers.long()) * n_pad + (
        flat.src_flat.long() - et * n_pad)
    idx = torch.where(flat.receivers < n_pad, idx, size)
    adj = torch.zeros(size + 1, dtype=torch.float32, device=idx.device)
    adj.index_add_(0, idx, flat.mask)
    return adj[:size].reshape(num_types, n_pad, n_pad)


def dense_aggregate_linear(transformed, graph, normalize: bool):
    """Sum-aggregate per-type LINEAR messages through dense adjacency
    matmuls: transformed [L, N, D] (the message along a type-l edge u -> v
    is transformed[l, u]) -> [N, D]. The 1/c normalisation is applied per
    receiver row after the product. Plain f32 matmuls, outside any kernel,
    as the JAX package leaves them to XLA. Uses graph.dense_adj when the
    runtime built it once for the step, else builds it."""
    mats = graph.dense_adj
    if mats is None:
        mats = dense_adjacency(graph)
    out = None
    for l in range(mats.shape[0]):
        part = torch.matmul(mats[l], transformed[l])
        if normalize:
            c = graph.typed_incoming_counts[l]
            part = part * (1.0 / (c + SMALL_NUMBER))[:, None]
        out = part if out is None else out + part
    return out


class _InjectiveTake(torch.autograd.Function):
    """table[fwd_idx], 0 where fwd_idx is -1, whose backward is the INVERSE
    take through inv_idx (-1 = no row). Only the mutual pairs (fwd_idx[
    inv_idx[i]] == i) carry a cotangent: fwd_idx hits every real table slot
    at most once, and the rows it maps non-injectively (slack rows, the dump
    group) get exactly zero."""

    @staticmethod
    def forward(ctx, table, fwd_idx, inv_idx):
        ctx.save_for_backward(fwd_idx, inv_idx)
        rows = _take_clip(table, fwd_idx)
        return torch.where((fwd_idx >= 0)[:, None], rows, 0.0)

    @staticmethod
    def backward(ctx, g):
        fwd_idx, inv_idx = ctx.saved_tensors
        inv = inv_idx.clamp(min=0)
        mutual = (inv_idx >= 0) & (fwd_idx.index_select(0, inv) == torch.arange(
            inv_idx.shape[0], device=inv_idx.device, dtype=fwd_idx.dtype))
        d = g.index_select(0, inv)
        return torch.where(mutual[:, None], d, 0.0), None, None


def take_by_fine_rank(table_flat, graph):
    """table_flat rows at each FINE (receiver, type) rank: [RPAD, ...]."""
    flat = graph.flat
    return _InjectiveTake.apply(table_flat, flat.fine_to_flat,
                                flat.fine_from_flat)


def take_by_tm_rank(table_flat, graph):
    """table_flat rows at each TYPE-MAJOR (type, receiver) group rank:
    [RPAD, ...], with the inverse-take backward (see take_by_fine_rank;
    self-loop types' slots are -1, so their rows get no cotangent)."""
    flat = graph.flat
    return _InjectiveTake.apply(table_flat, flat.tm_to_flat,
                                flat.tm_from_flat)


def fine_table_to_flat(table, graph):
    """Read a FINE rank table [RPAD, D] back into type-stacked node rows
    [L * n_pad, D]: row l * n_pad + v is the row of group (v, l), or 0
    where v has no incoming type-l edge."""
    flat = graph.flat
    return _InjectiveTake.apply(table, flat.fine_from_flat, flat.fine_to_flat)


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


def tm_table_to_nodes(table, graph):
    """Combine a TYPE-MAJOR rank table [RPAD, D] into node rows [n_pad, D];
    self-loop types' rows are left out (their slots are -1)."""
    flat = graph.flat
    ffl = flat.tm_from_flat.reshape(graph.num_edge_types, graph.n_pad)
    return _FineCombine.apply(table, ffl, flat.tm_to_rcv, graph.n_pad)
