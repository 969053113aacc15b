"""Edge-level gathers, aggregation and receiver softmaxes over the flat
edge stream (counterpart of the part of tf_gnn_samples_tpu/ops/edge_ops.py
the ported layers use).

Gathers clamp their indices as `jnp.take(..., mode="clip")` does: padded
edges carry src_flat / tgt_flat = L * n_pad, one row past the type-stacked
table, and torch's index_select does not clamp. Their (finite, garbage)
rows reach only the dump receiver or the dump rank, so their cotangents
are zero.
"""

import torch

from .. import SMALL_NUMBER
from . import ranked_segment as rs
from .segment import segment_max, segment_sum


def _take_clip(table, idx):
    return table.index_select(0, idx.clamp(0, table.shape[0] - 1))


def gather_flat_src(table_flat, flat):
    """table_flat[[L*N, ...]][src_flat]: per-edge source-side rows."""
    return _take_clip(table_flat, flat.src_flat)


def gather_flat_tgt(table_flat, flat):
    """table_flat[[L*N, ...]][tgt_flat]: per-edge target-side rows."""
    return _take_clip(table_flat, flat.tgt_flat)


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
        d = rank_table.index_select(0, to_rank.clamp(min=0))
        d = torch.where((to_rank >= 0)[:, None], d, 0.0).to(ctx.table_dtype)
        # to_rank covers the L * n_pad node rows; a table may carry more.
        pad = ctx.table_rows - d.shape[0]
        if pad:
            d = torch.nn.functional.pad(d, (0, 0, 0, pad))
        return d, None, None, None, None


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


def _per_node(count, like):
    """[n] -> [n, 1, ...] broadcastable against `like` [n, ...]."""
    return count.reshape(count.shape + (1,) * (like.dim() - 1))


def aggregate_flat(messages, flat, n_pad: int, aggregation: str):
    """Named aggregation (reference utils/utils.py:23-33) of per-edge
    messages into receiver rows over the whole stream; the dump row n_pad
    (padded edges) is sliced off."""
    if aggregation in ("sum", "unsorted_segment_sum"):
        return segment_sum(messages, flat.receivers, n_pad + 1)[:n_pad]
    if aggregation in ("mean", "unsorted_segment_mean",
                       "sqrt_n", "unsorted_segment_sqrt_n"):
        total = segment_sum(messages, flat.receivers, n_pad + 1)[:n_pad]
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
        d = dt_table.index_select(0, src_to_rank.clamp(min=0))
        d = torch.where((src_to_rank >= 0)[:, None], d, 0.0).to(
            ctx.table_dtype)
        # src_to_rank covers the L * n_pad node rows; a table may carry more.
        pad = ctx.table_rows - d.shape[0]
        if pad:
            d = torch.nn.functional.pad(d, (0, 0, 0, pad))
        return d, None, None, None, None, None, None, None


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
    exactly +-clamp (torch.clamp's is 1 there)."""
    lo = torch.tensor(-clamp, dtype=logits.dtype, device=logits.device)
    return torch.exp(torch.minimum(torch.maximum(logits, lo), -lo))


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


def take_by_tm_rank(table_flat, graph):
    """table_flat rows at each TYPE-MAJOR (type, receiver) group rank:
    [RPAD, ...], with the inverse-take backward (see take_by_fine_rank;
    self-loop types' slots are -1, so their rows get no cotangent)."""
    flat = graph.flat
    return _InjectiveTake.apply(table_flat, flat.tm_to_flat,
                                flat.tm_from_flat)


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
