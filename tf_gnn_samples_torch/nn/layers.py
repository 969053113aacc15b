"""Relational message-passing layers (counterpart of
tf_gnn_samples_tpu/nn/layers.py). Ported so far: GGNN, RGCN, RGAT (its
streamed and plain branches), GNN-FiLM.

Each layer is a pair of functions over plain dicts of tensors:
    <name>_init(gen, num_edge_types, state_dim, **cfg) -> params
    <name>_apply(params, graph: GraphBatch, h: [N, D], **cfg) -> [N, D]
"""

import math

import torch

from ..ops import ranked_segment as rs
from ..ops.edge_ops import (
    aggregate_flat,
    aggregate_flat_ranked,
    dense_aggregate_linear,
    fine_table_to_nodes,
    gather_flat_src,
    gather_flat_src_ranked,
    gather_flat_tgt,
    ranked_aggregation_ok,
    ranked_table_to_nodes,
    segment_softmax_flat,
    segment_softmax_flat_ranked_t,
    take_by_fine_rank,
)
from ..ops.graph import GraphBatch
from .activations import _leaky_relu_02, get_activation
from .cells import cell_apply, cell_init
from .initializers import stacked_glorot_uniform
from .normalization import layer_norm, layer_norm_init


def typed_transform(h, W):
    """All-type node transform: [N, D_in] x [L, D_in, D_out] -> [L, N, D_out]
    (a plain f32 batched matmul, outside any kernel)."""
    return torch.matmul(h.unsqueeze(0), W)


def _flat(t):
    """[L, N, D] -> [L * N, D] type-stacked node table."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


def use_dense_strategy(graph: GraphBatch, aggregation: str,
                       strategy: str) -> bool:
    """Whether a LINEAR-message layer aggregates through per-type dense
    adjacency matmuls (ops/edge_ops.py dense_aggregate_linear) instead of
    the flat edge stream. "dense" and "segment"/"pallas" force the choice;
    "auto" takes the dense path up to n_pad 16,384 and L dense f32
    matrices of at most 3 * 16,384^2 entries. These thresholds are the
    JAX package's heuristic, kept so both packages pick the same path at
    the same shape; they are still to be measured on the H100."""
    if aggregation not in ("sum", "unsorted_segment_sum"):
        return False
    if strategy == "dense":
        return True
    if strategy in ("segment", "pallas"):
        return False
    adj_bytes = graph.num_edge_types * graph.n_pad * graph.n_pad * 4
    return graph.n_pad <= 16384 and adj_bytes <= 3 * 16384 * 16384 * 4


def aggregate_flat_auto(messages, graph: GraphBatch, aggregation: str,
                        strategy: str):
    """Flat-stream aggregation: the ranked segment-sum (K5a) when the shape
    qualifies and the strategy allows it ('auto' or 'pallas', the JAX
    configs' name for the kernel path), else plain segment ops."""
    if strategy in ("auto", "pallas") and ranked_aggregation_ok(graph,
                                                               aggregation):
        return aggregate_flat_ranked(messages, graph, aggregation)
    return aggregate_flat(messages, graph.flat, graph.n_pad, aggregation)


def _flat_linear_messages(h, W, graph, concat_target=False):
    """Per-edge linear messages of the whole flat stream: the type-l
    message along u -> v is (h @ W_l)[u], or with concat_target
    Dense(concat(h_u, h_v)), split into source and target halves of W so
    both products stay node-sided."""
    if concat_target:
        d = h.shape[-1]
        t_src = _flat(typed_transform(h, W[:, :d, :]))
        t_tgt = _flat(typed_transform(h, W[:, d:, :]))
        return (gather_flat_src(t_src, graph.flat)
                + gather_flat_tgt(t_tgt, graph.flat))
    return gather_flat_src(_flat(typed_transform(h, W)), graph.flat)


# --------------------------------------------------------------------------
# GGNN (reference: gnns/ggnn.py)
# --------------------------------------------------------------------------

def ggnn_init(gen, num_edge_types, state_dim, gated_unit_type="gru", **_):
    return {
        "W": stacked_glorot_uniform(gen, num_edge_types,
                                    (state_dim, state_dim)),
        "cell": cell_init(gen, gated_unit_type, state_dim),
    }


def ggnn_apply(
    params,
    graph: GraphBatch,
    h,
    *,
    num_timesteps=1,
    gated_unit_type="gru",
    activation_function="tanh",
    message_aggregation_function="sum",
    aggregation_strategy="auto",
    **_,
):
    """h' = Cell(input=aggregated messages, state=h): the reference feeds
    messages as the cell *input* and node state as the *hidden state*
    (gnns/ggnn.py:92)."""
    dense = use_dense_strategy(graph, message_aggregation_function,
                               aggregation_strategy)
    c = None
    for _step in range(num_timesteps):
        if dense:
            t = typed_transform(h, params["W"])
            agg = dense_aggregate_linear(t, graph, normalize=False)
        else:
            msgs = _flat_linear_messages(h, params["W"], graph)
            agg = aggregate_flat_auto(msgs, graph,
                                      message_aggregation_function,
                                      aggregation_strategy)
        h, c = cell_apply(params["cell"], gated_unit_type, agg, h,
                          activation_function, c)
    return h


# --------------------------------------------------------------------------
# RGCN (reference: gnns/rgcn.py)
# --------------------------------------------------------------------------

def rgcn_init(gen, num_edge_types, state_dim,
              use_both_source_and_target=False, **_):
    in_dim = 2 * state_dim if use_both_source_and_target else state_dim
    return {"W": stacked_glorot_uniform(gen, num_edge_types,
                                        (in_dim, state_dim))}


def rgcn_apply(
    params,
    graph: GraphBatch,
    h,
    *,
    num_timesteps=1,
    activation_function="tanh",
    message_aggregation_function="sum",
    normalize_by_num_incoming=True,
    use_both_source_and_target=False,
    aggregation_strategy="auto",
    **_,
):
    act = get_activation(activation_function)
    # The dense strategy needs source-only linear messages (1/c depends
    # only on (receiver, type), so it applies after the product).
    dense = not use_both_source_and_target and use_dense_strategy(
        graph, message_aggregation_function, aggregation_strategy)
    for _step in range(num_timesteps):
        if dense:
            t = typed_transform(h, params["W"])
            h = act(dense_aggregate_linear(t, graph,
                                           normalize_by_num_incoming))
            continue
        msgs = _flat_linear_messages(
            h, params["W"], graph, concat_target=use_both_source_and_target)
        if normalize_by_num_incoming:
            msgs = msgs * graph.flat.norm_scale[:, None]
        h = act(aggregate_flat_auto(msgs, graph, message_aggregation_function,
                                    aggregation_strategy))
    return h


# --------------------------------------------------------------------------
# RGAT (reference: gnns/rgat.py)
# --------------------------------------------------------------------------

def rgat_init(gen, num_edge_types, state_dim, num_heads=4, **_):
    # The reference declares the attention parameters as a flat (2 * D,)
    # glorot-initialised vector per type, later reshaped to [K, 2 * D / K]
    # (rgat.py:74-76, 110-111).
    limit = math.sqrt(6.0 / (2 * 2 * state_dim))
    w = stacked_glorot_uniform(gen, num_edge_types, (state_dim, state_dim))
    u = torch.rand((num_edge_types, 2 * state_dim), generator=gen,
                   dtype=torch.float32)
    return {"W": w, "att": (2.0 * u - 1.0) * limit}


def rgat_streamed_branch(graph: GraphBatch, state_dim: int, num_heads: int,
                         aggregation_strategy: str) -> bool:
    """Whether RGAT takes the head-major streamed pipeline (K6, K7): the
    JAX package's gate (nn/layers.py rgat_apply) without its device and
    VMEM terms. 'pallas' is the JAX configs' name for the kernel path;
    'segment' forces the plain branch."""
    return (aggregation_strategy in ("auto", "pallas")
            and state_dim % num_heads == 0
            and ranked_aggregation_ok(graph, "sum"))


def rgat_apply(
    params,
    graph: GraphBatch,
    h,
    *,
    num_timesteps=1,
    num_heads=4,
    activation_function="tanh",
    aggregation_strategy="auto",
    **_,
):
    state_dim = h.shape[-1]
    head_dim = state_dim // num_heads
    L = graph.num_edge_types
    n_pad = graph.n_pad
    flat = graph.flat
    act = get_activation(activation_function)
    # att[l] flat (2D,) -> per-head source/target halves [L, K, Dh]:
    att = params["att"].reshape(L, num_heads, 2 * head_dim)
    att_src, att_tgt = att[..., :head_dim], att[..., head_dim:]
    # The JAX package has a third, fused branch (rgat_fused_pass: the
    # backward recomputes the message cotangent in source order, kernels
    # K8 and K9) that it prefers where its tables fit; it is not ported
    # yet (ROADMAP.md, Queue 1 item 8), so every eligible shape takes the
    # streamed branch here, as the JAX package does at the tuned QM9 size.
    streamed = rgat_streamed_branch(graph, state_dim, num_heads,
                                    aggregation_strategy)

    for _step in range(num_timesteps):
        t = typed_transform(h, params["W"])  # [L, N, D]
        t_heads = t.reshape(L, n_pad, num_heads, head_dim)
        # Node-side halves of the attention logits (linearity of the dot
        # with concat(src, tgt) makes this exact):
        logit_tgt = torch.einsum("lnkd,lkd->lnk", t_heads, att_tgt)

        if streamed:
            # The per-edge work runs on one bf16 [E, D] message stream and
            # head-major [K, E] attention arrays. The gather's backward
            # sums its bf16 cotangent in f32 through K5a.
            m2 = gather_flat_src_ranked(_flat(t).to(torch.bfloat16), flat)
            e_tot = m2.shape[0]
            # Source logit half from the gathered stream: bf16-rounded
            # operands, f32 products and sums (a plain matmul outside any
            # kernel, upcast so that no device rounds the result to bf16).
            # a_all[k * Dh + d, l * K + q] = att_src[l, k, d] if k == q
            # else 0: every type's source attention vector, head-block-
            # diagonal; each edge then keeps its own type's K logits.
            eye = torch.eye(num_heads, dtype=att_src.dtype,
                            device=att_src.device)
            a_all = torch.einsum("lkd,kq->kdlq", att_src, eye).reshape(
                state_dim, L * num_heads)
            logits_all = torch.matmul(
                m2.to(torch.float32),
                a_all.to(torch.bfloat16).to(torch.float32))
            pick = flat.edge_type.long()[:, None, None]
            lsrc_t = logits_all.reshape(e_tot, L, num_heads).gather(
                1, pick.expand(e_tot, 1, num_heads))[:, 0].t().contiguous()

            # Target half: constant per (receiver, type) group, expanded
            # from the FINE rank table (K6b).
            lt_ranked_t = take_by_fine_rank(
                _flat(logit_tgt), graph).t().contiguous()  # [K, RPAD]
            ltgt_t = rs.ranked_expand_table_t(
                lt_ranked_t, flat.tgt_rank, lt_ranked_t.shape[1])
            # tf.nn.leaky_relu's default slope 0.2 (rgat.py:113).
            logits_t = _leaky_relu_02(lsrc_t + ltgt_t)  # [K, E] f32
            attn_t = segment_softmax_flat_ranked_t(logits_t, graph)
            table = rs.ranked_weighted_segment_sum_t(
                m2, attn_t, flat.rcv_rank, rs.rank_table_rows(n_pad, 256),
                num_heads)
            h = act(ranked_table_to_nodes(table, graph))
            continue

        logit_src = torch.einsum("lnkd,lkd->lnk", t_heads, att_src)
        # Per-edge logits and messages over the flat stream (one gather
        # each, regardless of the number of edge types):
        logits = _leaky_relu_02(
            gather_flat_src(_flat(logit_src), flat)
            + gather_flat_tgt(_flat(logit_tgt), flat))  # [E, K]
        msgs = gather_flat_src(_flat(t_heads), flat)  # [E, K, Dh]
        # Softmax per (target node, head) over all incoming edges of all
        # types (rgat.py:126-130):
        attn = segment_softmax_flat(logits, flat, n_pad)
        agg = aggregate_flat_auto(
            (msgs * attn[..., None]).reshape(-1, state_dim), graph, "sum",
            aggregation_strategy)
        h = act(agg.reshape(n_pad, state_dim))
    return h


# --------------------------------------------------------------------------
# GNN-FiLM (reference: gnns/gnn_film.py)
# --------------------------------------------------------------------------

def gnn_film_init(gen, num_edge_types, state_dim, **_):
    return {
        "W": stacked_glorot_uniform(gen, num_edge_types,
                                    (state_dim, state_dim)),
        "W_film": stacked_glorot_uniform(gen, num_edge_types,
                                         (state_dim, 2 * state_dim)),
        "ln": layer_norm_init(state_dim),
    }


def film_fused_branch(aggregation_strategy: str, aggregation: str,
                      activation_function: str,
                      normalize_by_num_incoming: bool) -> bool:
    """Whether GNN-FiLM takes the fused kernel pass (K1-K3).

    This is the JAX package's gate (nn/layers.py gnn_film_apply, with
    ranked_aggregation_ok and film_fused_src_supported) without its VMEM
    terms: only the semantic conditions stay. The CUDA kernels reduce over
    sorted ranks in device memory and keep no whole table on chip, so no
    table height rules them out. On the TPU the VMEM terms reject the tuned
    QM9 config (a 50,000-node batch: E = 161,792 edges, 162,056 fine-rank
    rows, film_column_splits = 0), which runs the XLA segment branch there;
    the port runs the fused pass at every size. Normalised messages need
    the JAX package's column-split kernel (K4, not yet ported) and take the
    plain segment branch here. 'pallas' is the JAX configs' name for the
    kernel path; 'segment' forces the plain branch."""
    return (aggregation_strategy in ("auto", "pallas")
            and aggregation in ("sum", "unsorted_segment_sum")
            and rs.film_act_supported(activation_function)
            and not normalize_by_num_incoming)


def gnn_film_apply(
    params,
    graph: GraphBatch,
    h,
    *,
    num_timesteps=1,
    activation_function="relu",
    message_aggregation_function="sum",
    normalize_by_num_incoming=False,
    aggregation_strategy="auto",
    **_,
):
    act = get_activation(activation_function)
    d = h.shape[-1]
    fused = film_fused_branch(aggregation_strategy,
                              message_aggregation_function,
                              activation_function, normalize_by_num_incoming)
    flat = graph.flat
    for _step in range(num_timesteps):
        t = typed_transform(h, params["W"])  # [L, N, D]
        film = typed_transform(h, params["W_film"])  # [L, N, 2D]
        if fused:
            # gamma|beta live in a FINE (receiver, type) rank table; the
            # bf16 message stream is gathered inside the pass, whose
            # backward recomputes dt in source order (K3).
            gb_ranked = take_by_fine_rank(_flat(film), graph)
            table = rs.film_fused_src_pass(
                _flat(t).to(torch.bfloat16), gb_ranked, flat.src_flat,
                flat.fine_rank_by_src, flat.src_sorted_rank,
                flat.src_to_rank, flat.src_from_rank, flat.tgt_rank,
                activation_function,
            )
            agg = fine_table_to_nodes(table, graph)
        else:
            m = gather_flat_src(_flat(t), flat)
            if normalize_by_num_incoming:
                m = m * flat.norm_scale[:, None]
            gb = gather_flat_tgt(_flat(film), flat)  # FiLM from *target*
            gamma, beta = gb[:, :d], gb[:, d:]
            msgs = act(gamma * m + beta)  # activation on messages
            agg = aggregate_flat(msgs, flat, graph.n_pad,
                                 message_aggregation_function)
        h = layer_norm(params["ln"], agg)  # unconditional LN
    return h


LAYERS = {
    "ggnn": (ggnn_init, ggnn_apply),
    "rgcn": (rgcn_init, rgcn_apply),
    "rgat": (rgat_init, rgat_apply),
    "gnn_film": (gnn_film_init, gnn_film_apply),
}
