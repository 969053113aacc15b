"""Relational message-passing layers (counterpart of
tf_gnn_samples_tpu/nn/layers.py). Ported so far: GGNN, RGCN, RGAT (its
fused, streamed and plain branches), GNN-FiLM (its gather-fused, ranked
and plain branches), GNN-Edge-MLP (its type-major branch with and without
the source-order recompute, its typed-dense, FiLM-kernel, ranked, scanned
and plain branches), RGIN (its ranked, scanned, unrolled and bare
branches) and RGDCN (its aggregate-first sum branch, with the fine-rank,
dense, scanned and per-type forms of its neighbour sums, and its
per-channel branch for max and mean, unrolled or scanned); the scanned
branches run ops/typed_stream.py's per-type scan.

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
    aggregate_sum_block,
    dense_aggregate_linear,
    dense_adjacency,
    fine_table_to_flat,
    fine_table_to_nodes,
    gather_aggregate_fine,
    gather_aggregate_fine_ok,
    gather_aggregate_src,
    gather_aggregate_src_ok,
    gather_flat_src,
    gather_flat_src_ranked,
    gather_flat_tgt,
    gather_src_stacked,
    gather_tgt_stacked,
    gather_tm_src,
    ranked_aggregation_ok,
    ranked_table_to_nodes,
    segment_softmax_flat,
    segment_softmax_flat_ranked_t,
    take_by_fine_rank,
    take_by_tm_rank,
    tm_available,
    tm_self_types,
    tm_table_to_nodes,
)
from .. import SMALL_NUMBER
from ..ops.graph import GraphBatch
from ..ops.segment import segment_sum
from ..ops.typed_stream import (scan_types_aggregate, scan_types_wanted,
                                stack_edges, type_block)
from .activations import _leaky_relu_02, get_activation
from .cells import cell_apply, cell_init
from .initializers import stacked_glorot_uniform, truncated_normal
from .mlp import mlp_apply, mlp_init
from .normalization import layer_norm, layer_norm_init


def typed_transform(h, W):
    """All-type node transform: [N, D_in] x [L, D_in, D_out] -> [L, N, D_out]
    (a plain f32 batched matmul, outside any kernel)."""
    return torch.matmul(h.unsqueeze(0), W)


def _flat(t):
    """[L, N, D] -> [L * N, D] type-stacked node table."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


def src_stream(flat):
    """(fine_rank_by_src, src_sorted_rank, win) for the src-order backward
    kernels (K3, K9): the DILUTED stream (ops/graph.py FlatEdges.sd_*)
    when its window engaged, else the undiluted one. The CUDA kernels walk
    sorted ranks and ignore the window; the port feeds them the stream the
    JAX package feeds its own, so both sum the same slots in the same
    order (the diluted one is at most 3 % longer)."""
    if flat.win_sd:
        return flat.sd_fine, flat.sd_rank, flat.win_sd
    return flat.fine_rank_by_src, flat.src_sorted_rank, flat.win_src


def use_dense_strategy(graph: GraphBatch, aggregation: str,
                       strategy: str) -> bool:
    """Whether a LINEAR-message layer aggregates through per-type dense
    adjacency matmuls (ops/edge_ops.py dense_aggregate_linear) instead of
    the flat edge stream. "dense" and "segment"/"pallas" force the choice;
    "auto" takes the dense path up to n_pad 16,384 and L dense f32
    matrices of at most 3 * 16,384^2 entries. These thresholds are the
    JAX package's heuristic, kept so both packages pick the same path at
    the same shape. On the H100 they are read, not yet tuned: chip_smoke.py
    ppi_headline trains RGCN on PPI's packs (at most 12,800 padded nodes,
    so dense under "auto") both ways, and PERF.md (Findings) holds the
    two edges/s."""
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


def _flat_linear_messages(h, W, graph, concat_target=False,
                          ranked_target=False):
    """Per-edge linear messages of the whole flat stream: the type-l
    message along u -> v is (h @ W_l)[u], or with concat_target
    Dense(concat(h_u, h_v)), split into source and target halves of W so
    both products stay node-sided. ranked_target: the target half's
    gather takes the ranked backward where its gate allows
    (gather_flat_tgt's `ranked`; RGCN's edge-stream branch, which the JAX
    package runs through its gated gather_flat_tgt)."""
    if concat_target:
        d = h.shape[-1]
        t_src = _flat(typed_transform(h, W[:, :d, :]))
        t_tgt = _flat(typed_transform(h, W[:, d:, :]))
        return (gather_flat_src(t_src, graph.flat)
                + gather_flat_tgt(t_tgt, graph.flat, ranked=ranked_target))
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
            h, params["W"], graph, concat_target=use_both_source_and_target,
            ranked_target=True)
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
    VMEM terms, with a term for the heads K7a and K7b hold
    (ops/ranked_segment.py MAX_HEADS; past it the plain branch runs, where
    the JAX package's gate has no head term and streams). 'pallas' is the
    JAX configs' name for the kernel path; 'segment' forces the plain
    branch."""
    return (aggregation_strategy in ("auto", "pallas")
            and state_dim % num_heads == 0
            and num_heads <= rs.MAX_HEADS
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
    streamed = rgat_streamed_branch(graph, state_dim, num_heads,
                                    aggregation_strategy)
    # Of the two kernel pipelines the fused one (rgat_fused_pass: K6, K7a
    # forward; K8, K6, K9 backward) is taken where its gate holds (dense
    # graphs: more edges than type-stacked node rows), the head-major
    # streamed one (K6, K7a; K7b, K6, K5a) elsewhere.
    fused = streamed and rs.rgat_fused_supported(
        flat.src_flat.shape[0], state_dim, num_heads,
        rs.rank_table_rows(n_pad, 256), flat.src_from_rank.shape[0])

    for _step in range(num_timesteps):
        t = typed_transform(h, params["W"])  # [L, N, D]
        t_heads = t.reshape(L, n_pad, num_heads, head_dim)
        # Node-side halves of the attention logits (linearity of the dot
        # with concat(src, tgt) makes this exact):
        logit_tgt = torch.einsum("lnkd,lkd->lnk", t_heads, att_tgt)

        if fused:
            # Same pipeline as the streamed branch below but for the
            # source logit halves, which are computed node-side and
            # rounded to bf16; the backward recomputes the message
            # cotangent in source order instead of permuting an [E, D]
            # stream.
            lt_ranked = take_by_fine_rank(_flat(logit_tgt), graph)
            sd_fine, sd_rank, _ = src_stream(flat)
            table = rs.rgat_fused_pass(
                _flat(t), lt_ranked, att_src, flat.src_flat, sd_fine,
                sd_rank, flat.src_to_rank, flat.src_from_rank,
                flat.rcv_rank, flat.tgt_rank, flat.mask, flat.fine_to_rcv,
                graph.node_to_rank, num_heads, n_pad)
            h = act(ranked_table_to_nodes(table, graph))
            continue

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


def _film_aggregate_splits(m, gb_ranked, graph, act_name, splits):
    """K1 / K4 over the gathered stream `m`, in `splits` column slices (the
    FiLM modulation is elementwise in d, so the slices are independent);
    the port's film_column_splits always says 1."""
    ranks = graph.flat.tgt_rank
    if splits == 1:
        return rs.film_ranked_aggregate(m, gb_ranked, ranks, act_name)
    d = m.shape[1]
    w = d // splits
    parts = []
    for i in range(splits):
        gb_i = torch.cat([gb_ranked[:, i * w:(i + 1) * w],
                          gb_ranked[:, d + i * w:d + (i + 1) * w]], dim=1)
        parts.append(rs.film_ranked_aggregate(
            m[:, i * w:(i + 1) * w].contiguous(), gb_i, ranks, act_name))
    return torch.cat(parts, dim=1)


def film_fused_branch(aggregation_strategy: str, aggregation: str,
                      activation_function: str) -> bool:
    """Whether GNN-FiLM takes the kernel branches (K1 forward; K2 and K3,
    or K4 and K5a, backward) rather than the plain f32 segment one.

    This is the JAX package's gate (nn/layers.py gnn_film_apply, with
    ranked_aggregation_ok) without its VMEM terms: only the semantic
    conditions stay. The CUDA kernels reduce over sorted ranks in device
    memory and keep no whole table on chip, so no table height rules them
    out. On the TPU the VMEM terms reject the tuned
    QM9 config (a 50,000-node batch: E = 161,792 edges, 162,056 fine-rank
    rows, film_column_splits = 0), which runs the XLA segment branch there;
    the port runs the kernels at every size. 'pallas' is the JAX configs'
    name for the kernel path; 'segment' forces the plain branch."""
    return (aggregation_strategy in ("auto", "pallas")
            and aggregation in ("sum", "unsorted_segment_sum")
            and rs.film_act_supported(activation_function))


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
                              activation_function)
    flat = graph.flat
    act_name = activation_function.lower()
    for _step in range(num_timesteps):
        t = typed_transform(h, params["W"])  # [L, N, D]
        film = typed_transform(h, params["W_film"])  # [L, N, 2D]
        if fused:
            # gamma|beta live in a FINE (receiver, type) rank table and
            # the messages are a bf16 stream.
            t_flat = _flat(t).to(torch.bfloat16)
            gb_ranked = take_by_fine_rank(_flat(film), graph)
            splits = rs.film_column_splits(flat.src_flat.shape[0], d,
                                           gb_ranked.shape[0])
            gather_fusible = (splits == 1 and not normalize_by_num_incoming
                              and rs.film_fused_src_supported(act_name))
            if gather_fusible:
                # The stream is gathered inside the pass, whose backward
                # recomputes dt in source order (K2, K3).
                sd_fine, sd_rank, _ = src_stream(flat)
                table = rs.film_fused_src_pass(
                    t_flat, gb_ranked, flat.src_flat, sd_fine, sd_rank,
                    flat.src_to_rank, flat.src_from_rank, flat.tgt_rank,
                    act_name)
            else:
                # A per-edge factor sits between the gather and the
                # modulation, so the message cotangent is needed per edge
                # (K4) and goes back through the ranked gather (K5a). The
                # 1/c scale multiplies in bf16, as in the JAX package.
                m = gather_flat_src_ranked(t_flat, flat)
                if normalize_by_num_incoming:
                    m = m * flat.norm_scale[:, None].to(m.dtype)
                table = _film_aggregate_splits(m, gb_ranked, graph,
                                               act_name, splits)
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


# --------------------------------------------------------------------------
# GNN-Edge-MLP (reference: gnns/gnn_edge_mlp.py)
# --------------------------------------------------------------------------

def gnn_edge_mlp_init(gen, num_edge_types, state_dim,
                      use_target_state_as_input=True,
                      num_edge_hidden_layers=1, **_):
    in_dim = 2 * state_dim if use_target_state_as_input else state_dim
    sizes = [in_dim] + [state_dim] * (num_edge_hidden_layers + 1)
    return {
        "edge_mlp": [
            stacked_glorot_uniform(gen, num_edge_types, (d_in, d_out))
            for d_in, d_out in zip(sizes[:-1], sizes[1:])
        ],
        "ln": layer_norm_init(state_dim),
    }


# The edge MLP's inner activation is a fixed elu.
_inner_elu = get_activation("elu")


def edge_mlp_branch(graph: GraphBatch, *, activation_function: str,
                    message_aggregation_function: str,
                    normalize_by_num_incoming: bool,
                    use_target_state_as_input: bool,
                    num_edge_hidden_layers: int,
                    typed_edge_scan: str, w1_dims) -> str:
    """Which branch GNN-Edge-MLP takes, for `typed_edge_scan` "auto"
    (`w1_dims`: the (Dh, D) of the MLP's last weight, [L, Dh, D]):

    * "tmajor1" (target state, one hidden layer, sum, no normalisation,
      the type-major view present; the tuned GNN-Edge-MLP1): K11a and one
      K12a launch over the non-self edge types' slices forward; one K12b
      launch over them, K11b and K5a (the type-major gather's backward)
      backward. With
      ops/ranked_segment.py ENABLE_EMLP1_SRC_PASS on (off by default, as
      in the JAX package) it takes its `fused_src1` form: the same
      forward, and K14 in place of the gather's backward;
    * "fused1" (the same configuration on a batch without the type-major
      view; every batch that pad_graph_batch builds has it, so only a
      caller that withholds the view reaches it) at the widths K10 holds
      (ops/ranked_segment.py typed_dense_agg_supported; wider: "plain"):
      K5b expands the target halves and the typed dense aggregate K10a
      runs the W1 products, the activation and the aggregation forward;
      K10b, and K5a for the expand's and the source gather's backward;
    * "fused0" (target state, no hidden layer, sum; the tuned
      GNN-Edge-MLP0): the FiLM kernels K1-K3 with gamma = 1 or 1/c;
    * "ranked" (no target state, a sum-family aggregation on a ranked
      stream): the whole MLP on the node tables, then one bf16 gather and
      ranked aggregation, the fused gather + segment-sum with its
      source-order backward (K5a both ways; RGIN's branch too), or with
      normalised messages the ranked gather and aggregation (K5a forward;
      K5b and K5a backward);
    * "scanned" (none of the above, and ops/typed_stream.py
      scan_types_wanted: "scan" / "always", or "auto" at eight or more
      edge types): the per-type scan, in f32 (_scanned_mlp_aggregate);
    * "plain" (everything else, and "unroll"): f32 PyTorch.

    These are the JAX package's gates (nn/layers.py gnn_edge_mlp_apply)
    with their semantic terms kept and their rank-window, VMEM and device
    terms dropped: the CUDA kernels walk sorted ranks in device memory,
    need no window and keep no table on chip, so no shape rules them out
    (on the TPU the tuned QM9 batch, whose rank windows are 0, runs the
    unrolled XLA branch). The rule is the same on the CPU, so that a batch
    takes the same branch on every device. The kernel branches are taken
    only under "auto", ahead of the scan, as in the JAX package."""
    if typed_edge_scan == "auto":
        branch = _edge_mlp_kernel_branch(
            graph, activation_function, message_aggregation_function,
            normalize_by_num_incoming, use_target_state_as_input,
            num_edge_hidden_layers, w1_dims)
        if branch is not None:
            return branch
    if scan_types_wanted(graph, typed_edge_scan):
        return "scanned"
    return "plain"


def _edge_mlp_kernel_branch(graph, activation_function, aggregation,
                            normalize, target, num_edge_hidden_layers,
                            w1_dims):
    """edge_mlp_branch's kernel branches under "auto", or None."""
    if not target:
        return "ranked" if ranked_aggregation_ok(graph, aggregation) else None
    kernels = (aggregation in ("sum", "unsorted_segment_sum")
               and rs.film_act_supported(activation_function))
    if kernels and num_edge_hidden_layers == 1 and not normalize:
        if tm_available(graph):
            return "tmajor1"
        if ranked_aggregation_ok(graph, "sum") and rs.typed_dense_agg_supported(
                graph.num_edge_types, activation_function, *w1_dims):
            return "fused1"
    if kernels and num_edge_hidden_layers == 0:
        return "fused0"
    return None


def _typed_mlp_messages_flat(h, weights, graph, concat_target,
                             inner_act=_inner_elu):
    """Stacked per-type edge MLP over the flat stream, in f32: the first
    linear layer node-sided, the later ones per edge with `inner_act` in
    front (the JAX package's _typed_mlp_messages). The later layers' weight
    depends on the edge's type, so the stream is brought into type-major
    order (a stable sort by type of the receiver-sorted stream is exactly
    that order), each type's slice multiplies its own matrix, and the
    result goes back to stream order."""
    flat = graph.flat
    msgs = _flat_linear_messages(h, weights[0], graph,
                                 concat_target=concat_target)
    if len(weights) == 1:
        return msgs
    perm = torch.argsort(flat.edge_type, stable=True)
    inverse = torch.empty_like(perm)
    inverse[perm] = torch.arange(perm.shape[0], device=perm.device)
    sizes = [b - a for a, b in zip(flat.tm_offs[:-1], flat.tm_offs[1:])]
    msgs = msgs.index_select(0, perm)
    for W in weights[1:]:
        parts = torch.split(inner_act(msgs), sizes)
        msgs = torch.cat([torch.matmul(x_l, W[l])
                          for l, x_l in enumerate(parts)])
    return msgs.index_select(0, inverse)


def _node_table_mlp(h, weights, inner_act):
    """The stacked per-type MLP on the NODE tables: [N, D] -> [L, N, D_out]
    (the JAX package's _node_table_mlp). Where the edge MLP reads the
    source state alone, the message is a function of (type, source), so
    every layer runs node-side and the per-edge stage is one gather and
    one ranked aggregation. Plain f32 batched matmuls, outside any
    kernel."""
    t = typed_transform(h, weights[0])
    for W in weights[1:]:
        t = torch.matmul(inner_act(t), W)
    return t


def _scanned_mlp_aggregate(h, weights, graph, concat_target, inner_act,
                           msg_post, aggregation):
    """The per-type edge MLP and its aggregation as the per-type scan
    (ops/typed_stream.py; the JAX package's _scanned_mlp_aggregate): the
    first linear layer node-sided, then per type its block's gathers, the
    later layers with `inner_act` in front, and msg_post(m, te_l) (the
    layer's activation, and 1/c), aggregated into the carry. f32 PyTorch,
    outside any kernel, as the JAX package's scan runs outside Pallas.
    The stacked transforms are unbound once: a select per type would give
    each type's backward a zeroed [L, N, D] tensor of its own."""
    te = stack_edges(graph)
    d0 = h.shape[-1]
    w0, rest = weights[0], weights[1:]
    out_dim = (rest[-1] if rest else w0).shape[-1]
    if concat_target:
        ts = typed_transform(h, w0[:, :d0, :]).unbind(0)
        tt = typed_transform(h, w0[:, d0:, :]).unbind(0)
    else:
        ts = typed_transform(h, w0).unbind(0)

    def msgs_fn(l, te_l):
        m = gather_src_stacked(ts[l], te_l)
        if concat_target:
            m = m + gather_tgt_stacked(tt[l], te_l)
        for w in rest:
            m = torch.matmul(inner_act(m), w[l])
        return msg_post(m, te_l)

    return scan_types_aggregate(graph, te, msgs_fn, out_dim, aggregation)


def _ranked_source_aggregate(t16, graph, aggregation):
    """Aggregate the bf16 type-stacked node table `t16`, gathered by
    source, per receiver: the fused gather + segment-sum with the
    source-order backward (K5a both ways) where it is eligible, else the
    gather and the ranked aggregation apart."""
    if gather_aggregate_src_ok(graph, aggregation):
        return gather_aggregate_src(t16, graph, aggregation)
    return aggregate_flat_ranked(gather_flat_src(t16, graph.flat), graph,
                                 aggregation)


def gnn_edge_mlp_apply(
    params,
    graph: GraphBatch,
    h,
    *,
    num_timesteps=1,
    activation_function="relu",
    message_aggregation_function="sum",
    normalize_by_num_incoming=False,
    use_target_state_as_input=True,
    num_edge_hidden_layers=1,
    typed_edge_scan="auto",
    **_,
):
    """The message along a type-l edge u -> v is act(MLP_l(h_u | h_v)) (or
    of h_u alone), an MLP of `num_edge_hidden_layers` hidden layers with a
    fixed inner elu; messages are aggregated per receiver and layer-normed.
    See edge_mlp_branch for the branches."""
    act = get_activation(activation_function)
    act_name = activation_function.lower()
    branch = edge_mlp_branch(
        graph, activation_function=act_name,
        message_aggregation_function=message_aggregation_function,
        normalize_by_num_incoming=normalize_by_num_incoming,
        use_target_state_as_input=use_target_state_as_input,
        num_edge_hidden_layers=num_edge_hidden_layers,
        typed_edge_scan=typed_edge_scan,
        w1_dims=tuple(params["edge_mlp"][-1].shape[-2:]))
    flat = graph.flat
    d0 = h.shape[-1]
    n_pad, num_types = graph.n_pad, graph.num_edge_types
    for _step in range(num_timesteps):
        if branch == "tmajor1":
            # One hidden layer and the target state (the tuned
            # GNN-Edge-MLP1), over the TYPE-MAJOR stream: the hidden x =
            # elu(ts[src] + tt[tgt]) assembles from a bf16 row gather and
            # the (type, receiver) rank table of the target halves (K11a);
            # the type-dependent output matrix W1 multiplies each type's
            # contiguous slice whole (bf16 operands, f32 accumulation,
            # rounded to bf16: plain matmuls outside any kernel); the
            # outer activation and the aggregation run per type through
            # K12a. The types' rank rows are disjoint, so every type's
            # call writes into the one table. Backward: one K12b launch
            # over the types' slices, the matmuls' own, K11b, and K5a in
            # the gather's.
            W0, W1 = params["edge_mlp"]
            ts = typed_transform(h, W0[:, :d0, :])
            tt = typed_transform(h, W0[:, d0:, :])
            self_types = tm_self_types(graph)
            offs = flat.tm_offs
            beta = take_by_tm_rank(_flat(tt), graph)  # [RPAD, D]
            rows = rs.fine_rank_table_rows(n_pad, num_types,
                                           flat.tm_rank.shape[0], 256)
            if rs.emlp1_src_supported(act_name, W1.shape[-1],
                                      self_types.count(False)):
                # fused_src1: the same forward inside one op whose backward
                # recomputes the message cotangent in source order (K14)
                # in place of the gather's [E, D] cotangent permute.
                table = rs.emlp1_tm_pass(
                    _flat(ts), beta, W1, flat.tm_src_flat, flat.tm_rank,
                    flat.tm_rank_by_src, flat.src_sorted_rank,
                    flat.src_to_rank, flat.src_from_rank, flat.mask, offs,
                    self_types, act_name, n_pad, rows)
            else:
                m = gather_tm_src(_flat(ts).to(torch.bfloat16), graph)
                table, _, _ = rs.emlp1_tm_forward(
                    m, beta, W1, flat.tm_rank, offs, self_types, act_name,
                    rows)
            agg = tm_table_to_nodes(table, graph)
            # Self-loop types node-side, in f32: the message along a self
            # loop is a function of its node alone, summed once per
            # incident self edge (typed_incoming_counts carries the
            # multiplicity; 0 for a node without one).
            for l in range(num_types):
                if self_types[l]:
                    y_self = torch.matmul(_inner_elu(ts[l] + tt[l]), W1[l])
                    agg = agg + act(y_self) * (
                        graph.typed_incoming_counts[l][:, None])
        elif branch == "fused1":
            # The tmajor1 configuration over the receiver-sorted stream:
            # the hidden x = elu(ts[src] + tt[tgt]) from a bf16 row gather
            # and the fine rank table of the target halves expanded per
            # edge (K5b); the typed dense aggregate (K10a) runs each edge's
            # W1 product, the activation and the aggregation into the
            # coarse receiver table in one pass, and its backward (K10b)
            # recomputes the products.
            W0, W1 = params["edge_mlp"]
            ts = typed_transform(h, W0[:, :d0, :])
            tt = typed_transform(h, W0[:, d0:, :])
            beta = take_by_fine_rank(_flat(tt), graph)
            m = gather_flat_src_ranked(_flat(ts).to(torch.bfloat16), flat)
            beta_e = rs.ranked_expand_table(beta, flat.tgt_rank, beta.shape[0])
            x = _inner_elu(m.to(torch.float32) + beta_e).to(torch.bfloat16)
            table = rs.typed_dense_aggregate(
                x, W1, flat.edge_type, flat.rcv_rank,
                rs.rank_table_rows(n_pad, 256), act_name)
            agg = ranked_table_to_nodes(table, graph)
        elif branch == "ranked":
            # No target state: the message is a function of (type, source)
            # alone, so the whole MLP runs on the node tables.
            t = _node_table_mlp(h, params["edge_mlp"], _inner_elu)
            if normalize_by_num_incoming:
                # 1/c belongs to the receiver, so it scales the per-edge
                # stream before the activation.
                m = gather_flat_src_ranked(_flat(t).to(torch.bfloat16), flat)
                agg = aggregate_flat_ranked(
                    act(m.to(torch.float32) * flat.norm_scale[:, None]),
                    graph, message_aggregation_function)
            else:
                agg = _ranked_source_aggregate(
                    _flat(act(t)).to(torch.bfloat16), graph,
                    message_aggregation_function)
        elif branch == "fused0":
            # No hidden layer and the target state (the tuned
            # GNN-Edge-MLP0): the message is act(norm * (ts[src] +
            # tt[tgt])), which is the fused FiLM pass with gamma = norm (1
            # or 1/c), constant per (receiver, type) group, and beta = norm
            # * tt rows. gamma is a constant, so the d_gamma half of K2's
            # output is dropped.
            W0 = params["edge_mlp"][0]
            ts = typed_transform(h, W0[:, :d0, :])
            tt = typed_transform(h, W0[:, d0:, :])
            beta = take_by_fine_rank(_flat(tt), graph)
            if normalize_by_num_incoming:
                counts = graph.typed_incoming_counts.reshape(-1)
                scale = 1.0 / (counts.index_select(0, flat.fine_to_flat)
                               + SMALL_NUMBER)
                gamma = scale[:, None].expand_as(beta)
                beta = beta * scale[:, None]
            else:
                gamma = torch.ones_like(beta)
            gb_ranked = torch.cat([gamma, beta], dim=1)
            ts16 = _flat(ts).to(torch.bfloat16)
            splits = rs.film_column_splits(flat.src_flat.shape[0], d0,
                                           gb_ranked.shape[0])
            # The 1/c scale is folded into gamma and beta per fine group,
            # so (unlike GNN-FiLM's per-edge scale) the gather-fused pass
            # applies even when normalising.
            if splits == 1 and rs.film_fused_src_supported(act_name):
                sd_fine, sd_rank, _ = src_stream(flat)
                table = rs.film_fused_src_pass(
                    ts16, gb_ranked, flat.src_flat, sd_fine, sd_rank,
                    flat.src_to_rank, flat.src_from_rank, flat.tgt_rank,
                    act_name)
            else:
                m = gather_flat_src_ranked(ts16, flat)
                table = _film_aggregate_splits(m, gb_ranked, graph,
                                               act_name, splits)
            agg = fine_table_to_nodes(table, graph)
        elif branch == "scanned":
            def finalize(m, te_l):
                if normalize_by_num_incoming:
                    m = m * te_l.norm_scale[:, None]
                return act(m)

            agg = _scanned_mlp_aggregate(
                h, params["edge_mlp"], graph, use_target_state_as_input,
                _inner_elu, finalize, message_aggregation_function)
        else:
            msgs = _typed_mlp_messages_flat(h, params["edge_mlp"], graph,
                                            use_target_state_as_input)
            if normalize_by_num_incoming:
                msgs = msgs * flat.norm_scale[:, None]
            agg = aggregate_flat(act(msgs), flat, n_pad,
                                 message_aggregation_function)
        h = layer_norm(params["ln"], agg)  # unconditional LN
    return h


# --------------------------------------------------------------------------
# RGIN (reference: gnns/rgin.py)
# --------------------------------------------------------------------------

def rgin_init(gen, num_edge_types, state_dim, use_target_state_as_input=False,
              num_edge_MLP_hidden_layers=1, num_aggr_MLP_hidden_layers=None,
              **_):
    params = {"ln": layer_norm_init(state_dim)}
    if num_edge_MLP_hidden_layers is not None:
        in_dim = 2 * state_dim if use_target_state_as_input else state_dim
        sizes = [in_dim] + [state_dim] * (num_edge_MLP_hidden_layers + 1)
        params["edge_mlp"] = [
            stacked_glorot_uniform(gen, num_edge_types, (d_in, d_out))
            for d_in, d_out in zip(sizes[:-1], sizes[1:])
        ]
    if num_aggr_MLP_hidden_layers is not None:
        params["aggr_mlp"] = mlp_init(gen, state_dim, state_dim,
                                      num_aggr_MLP_hidden_layers)
    return params


def rgin_branch(graph: GraphBatch, *, message_aggregation_function: str,
                use_target_state_as_input: bool, num_edge_MLP_hidden_layers,
                typed_edge_scan: str) -> str:
    """Which branch RGIN takes:

    * "ranked" (an edge MLP on the source state alone, "auto", a
      sum-family aggregation on a ranked stream; the tuned QM9 RGIN): the
      whole MLP on the node tables, then the fused gather + segment-sum
      with its source-order backward (K5a forward and backward);
    * "scanned" (an edge MLP otherwise, where ops/typed_stream.py
      scan_types_wanted says so: "scan" / "always", or "auto" at eight or
      more edge types): the per-type scan, in f32;
    * "unrolled" (an edge MLP otherwise, and "unroll"): the per-type MLP
      over the flat stream in f32;
    * "bare" (`num_edge_MLP_hidden_layers` None): the source states
      themselves are the messages.

    This is the JAX package's gate (nn/layers.py rgin_apply) without its
    window and VMEM terms, as edge_mlp_branch has it."""
    if num_edge_MLP_hidden_layers is None:
        return "bare"
    if (not use_target_state_as_input and typed_edge_scan == "auto"
            and ranked_aggregation_ok(graph, message_aggregation_function)):
        return "ranked"
    if scan_types_wanted(graph, typed_edge_scan):
        return "scanned"
    return "unrolled"


def rgin_apply(
    params,
    graph: GraphBatch,
    h,
    *,
    num_timesteps=1,
    activation_function="relu",
    message_aggregation_function="sum",
    use_target_state_as_input=False,
    num_edge_MLP_hidden_layers=1,
    num_aggr_MLP_hidden_layers=None,
    typed_edge_scan="auto",
    **_,
):
    """h' = LN(act(aggr_MLP(sum of act(MLP_l(h_u)) over in-edges))), the
    edge MLP with `act` between its layers and the aggregation MLP
    optional. See rgin_branch for the branches."""
    act = get_activation(activation_function)
    branch = rgin_branch(
        graph, message_aggregation_function=message_aggregation_function,
        use_target_state_as_input=use_target_state_as_input,
        num_edge_MLP_hidden_layers=num_edge_MLP_hidden_layers,
        typed_edge_scan=typed_edge_scan)
    for _step in range(num_timesteps):
        if branch == "ranked":
            t = act(_node_table_mlp(h, params["edge_mlp"], act))
            agg = _ranked_source_aggregate(_flat(t).to(torch.bfloat16), graph,
                                           message_aggregation_function)
        elif branch == "scanned":
            agg = _scanned_mlp_aggregate(
                h, params["edge_mlp"], graph, use_target_state_as_input, act,
                lambda m, te_l: act(m), message_aggregation_function)
        else:
            if branch == "unrolled":
                msgs = act(_typed_mlp_messages_flat(
                    h, params["edge_mlp"], graph, use_target_state_as_input,
                    inner_act=act))
            else:
                msgs = gather_flat_src(h.repeat(graph.num_edge_types, 1),
                                       graph.flat)
            agg = aggregate_flat(msgs, graph.flat, graph.n_pad,
                                 message_aggregation_function)
        if num_aggr_MLP_hidden_layers is not None:
            agg = mlp_apply(params["aggr_mlp"], agg, act)
        h = layer_norm(params["ln"], act(agg))  # act + unconditional LN
    return h


# --------------------------------------------------------------------------
# RGDCN (reference: gnns/rgdcn.py)
# --------------------------------------------------------------------------

def rgdcn_init(gen, num_edge_types, state_dim, num_channels=8,
               channel_dim=None, use_full_state_for_channel_weights=False,
               tie_channel_weights=False, **_):
    """W_wc [L, C_eff, in_dim, K * K]: truncated-normal kernels of stddev
    1 / K^2 computing each node's K x K dynamic convolutions from its state
    (rgdcn.py:99-104); C_eff is 1 with tied channel weights, in_dim the
    full state's width with use_full_state_for_channel_weights, else K."""
    if channel_dim is None:
        channel_dim = state_dim // num_channels
    c_eff = 1 if tie_channel_weights else num_channels
    in_dim = state_dim if use_full_state_for_channel_weights else channel_dim
    return {"W_wc": truncated_normal(
        gen, (num_edge_types, c_eff, in_dim, channel_dim * channel_dim),
        stddev=1.0 / channel_dim ** 2)}


def rgdcn_sums_form(graph: GraphBatch, aggregation_strategy: str,
                    typed_edge_scan: str) -> str:
    """How RGDCN's per-type neighbour sums are formed:

    * "dense" (use_dense_strategy for sum): the A_l @ h matmuls;
    * "fine" ("auto", gather_aggregate_fine_ok: a ranked stream with its
      src-sorted fields): one bf16 gather of the node states and one
      segment-sum over the FINE (receiver, type) ranks, read back per type
      (K5a forward; K5a over the src-sorted stream backward, through
      ops/edge_ops.py gather_aggregate_fine);
    * "scanned" (ops/typed_stream.py scan_types_wanted: "scan" /
      "always", ahead of the dense form too, or "auto" at eight or more
      edge types): f32 per-type segment sums, one type's block at a time;
    * "per_type" (everything else, and "unroll"): f32 segment sums per
      (type, receiver).

    This is the JAX package's gate (nn/layers.py _typed_neighbor_sums) with
    its semantic terms kept and its window term compressive_window dropped,
    as the other port gates drop theirs (the CUDA kernels walk sorted ranks
    and need no window). So at the tuned QM9 batch, whose fine window is 0,
    the port takes the fine form where the JAX package's gate takes the
    per-type one."""
    force_scan = typed_edge_scan in ("scan", "always")
    if not force_scan and use_dense_strategy(graph, "sum",
                                             aggregation_strategy):
        return "dense"
    if typed_edge_scan == "auto" and gather_aggregate_fine_ok(graph):
        return "fine"
    if scan_types_wanted(graph, typed_edge_scan):
        return "scanned"
    return "per_type"


def _typed_neighbor_sums(h, graph: GraphBatch, normalize: bool,
                         aggregation_strategy: str, typed_edge_scan: str):
    """Per-type neighbour sums S[l, v] = sum over type-l edges u -> v of
    h[u], optionally 1/c_{v,l}-normalised: [L, n_pad, D] f32 (the JAX
    package's _typed_neighbor_sums; forms in rgdcn_sums_form)."""
    n_pad, d = graph.n_pad, h.shape[-1]
    num_types = graph.num_edge_types
    flat = graph.flat
    form = rgdcn_sums_form(graph, aggregation_strategy, typed_edge_scan)
    if form == "dense":
        mats = graph.dense_adj
        if mats is None:
            mats = dense_adjacency(graph)
        parts = []
        for l in range(num_types):
            part = torch.matmul(mats[l], h)
            if normalize:
                c = graph.typed_incoming_counts[l]
                part = part * (1.0 / (c + SMALL_NUMBER))[:, None]
            parts.append(part)
        return torch.stack(parts)
    if form == "fine":
        # S[l, v] is the fine rank table's row of group (v, l).
        table16 = h.to(torch.bfloat16).expand(num_types, n_pad, d).reshape(
            num_types * n_pad, d)
        table = gather_aggregate_fine(table16, graph, normalize)
        return fine_table_to_flat(table, graph).reshape(num_types, n_pad, d)
    if form == "scanned":
        te = stack_edges(graph)
        parts = []
        for l in range(num_types):
            te_l = type_block(te, l)
            src = gather_src_stacked(h, te_l)
            if normalize:
                src = src * te_l.norm_scale[:, None]
            parts.append(aggregate_sum_block(src, te_l, n_pad))
        return torch.stack(parts)
    src = gather_flat_src(h.repeat(num_types, 1), flat)
    if normalize:
        src = src * flat.norm_scale[:, None]
    slot = torch.where(flat.receivers < n_pad,
                       flat.edge_type * n_pad + flat.receivers,
                       num_types * n_pad)
    sums = segment_sum(src, slot, num_types * n_pad + 1)[:num_types * n_pad]
    return sums.reshape(num_types, n_pad, d)


def _rgdcn_type_contraction(h, h_chunked, s_l, w_l, act, channel_dim,
                            use_full_state, tie_weights):
    """One edge type's part of the aggregate-first sum: out[v, c, j] =
    sum_i S_l[v, c, i] * K_l[c, v, i, j], the dynamic kernels K computed
    from the target state (rgdcn.py:95-143), for the four weight-sharing
    variants. Plain f32 einsums, outside any kernel, as the JAX package
    leaves them to XLA."""
    n = s_l.shape[0]
    if use_full_state:
        # Kernels from the FULL target state (rgdcn.py:134-136).
        kern = act(torch.einsum("nd,cdq->cnq", h, w_l))
        if tie_weights:
            # One kernel per node, shared by every channel.
            k3 = kern[0].reshape(n, channel_dim, channel_dim)
            return torch.einsum("nci,nij->ncj", s_l, k3)
    elif tie_weights:
        # Tied weights, per-channel input state (rgdcn.py:43-49).
        kern = act(torch.einsum("nck,kq->cnq", h_chunked, w_l[0]))
    else:
        kern = act(torch.einsum("nck,ckq->cnq", h_chunked, w_l))
    k4 = kern.reshape(kern.shape[0], n, channel_dim, channel_dim)
    return torch.einsum("nci,cnij->ncj", s_l, k4)


def rgdcn_apply(
    params,
    graph: GraphBatch,
    h,
    *,
    num_timesteps=1,
    num_channels=8,
    channel_dim=None,
    use_full_state_for_channel_weights=False,
    tie_channel_weights=False,
    activation_function="relu",
    message_aggregation_function="sum",
    normalize_by_num_incoming=True,
    typed_edge_scan="auto",
    aggregation_strategy="auto",
    **_,
):
    """Relational dynamic convolution: along a type-l edge u -> v, channel
    c's K-wide slice of h_u is multiplied by the K x K kernel act(W_wc[l,
    c] applied to v's state), then aggregated, activated and concatenated.

    Sum aggregation takes the aggregate-first form (the messages are linear
    in the source state and the activation follows the aggregation,
    rgdcn.py:143-160): the per-type neighbour sums (_typed_neighbor_sums),
    then node-level kernel contractions per type. Max and mean aggregation
    take the per-channel form over the flat stream, in f32 (the JAX
    package's unrolled branch), or, where ops/typed_stream.py
    scan_types_wanted says so, over each type's block in turn (its scanned
    branch). The scanned sum form starts its sum over the types from
    zeros, as the JAX package's scan carry does."""
    scanned = scan_types_wanted(graph, typed_edge_scan)
    n_pad = graph.n_pad
    if channel_dim is None:
        channel_dim = h.shape[-1] // num_channels
    act = get_activation(activation_function)
    w_wc = params["W_wc"]
    if message_aggregation_function in ("sum", "unsorted_segment_sum"):
        for _step in range(num_timesteps):
            h_chunked = h.reshape(n_pad, num_channels, channel_dim)
            sums = _typed_neighbor_sums(h, graph, normalize_by_num_incoming,
                                        aggregation_strategy, typed_edge_scan)
            sums = sums.reshape(-1, n_pad, num_channels, channel_dim)
            out = (torch.zeros((n_pad, num_channels, channel_dim),
                               device=h.device) if scanned else None)
            # Unbound once: a select per type would give each type's
            # backward a zeroed [L, N, D] tensor of its own.
            for l, sums_l in enumerate(sums.unbind(0)):
                part = _rgdcn_type_contraction(
                    h, h_chunked, sums_l, w_wc[l], act, channel_dim,
                    use_full_state_for_channel_weights, tie_channel_weights)
                out = part if out is None else out + part
            h = act(out).reshape(n_pad, num_channels * channel_dim)
        return h

    if scanned:
        te = stack_edges(graph)
        for _step in range(num_timesteps):
            channels = h.reshape(n_pad, num_channels, channel_dim).unbind(1)

            def msgs_fn(l, te_l):
                parts = []
                for c in range(num_channels):
                    c_eff = 0 if tie_channel_weights else c
                    wc_in = (h if use_full_state_for_channel_weights
                             else channels[c])
                    kernels = act(torch.matmul(wc_in, w_wc[l, c_eff])).reshape(
                        n_pad, channel_dim, channel_dim)
                    kern_e = gather_tgt_stacked(kernels, te_l)
                    src = gather_src_stacked(channels[c], te_l)
                    m = torch.einsum("ek,ekj->ej", src, kern_e)
                    if normalize_by_num_incoming:
                        m = m * te_l.norm_scale[:, None]
                    parts.append(m)
                return torch.cat(parts, dim=1)

            # act per aggregated channel == act on the channels' concat.
            h = act(scan_types_aggregate(
                graph, te, msgs_fn, num_channels * channel_dim,
                message_aggregation_function))
        return h

    flat = graph.flat
    num_types = graph.num_edge_types
    for _step in range(num_timesteps):
        h_chunked = h.reshape(n_pad, num_channels, channel_dim)
        new_channels = []
        for c in range(num_channels):
            c_eff = 0 if tie_channel_weights else c
            ch_state = h_chunked[:, c, :]  # [N, K]
            wc_in = h if use_full_state_for_channel_weights else ch_state
            # The dynamic K x K kernel at each node, per type; the reference
            # applies the activation to the kernel entries (rgdcn.py:99-104).
            kernels = act(torch.matmul(wc_in.unsqueeze(0), w_wc[:, c_eff]))
            kern_e = gather_flat_tgt(_flat(kernels), flat).reshape(
                -1, channel_dim, channel_dim)  # kernel at the target
            src = gather_flat_src(ch_state.repeat(num_types, 1), flat)
            msgs = torch.einsum("ek,ekj->ej", src, kern_e)
            if normalize_by_num_incoming:
                msgs = msgs * flat.norm_scale[:, None]
            new_channels.append(act(aggregate_flat(
                msgs, flat, n_pad, message_aggregation_function)))
        h = torch.cat(new_channels, dim=1)
    return h


LAYERS = {
    "gnn_edge_mlp": (gnn_edge_mlp_init, gnn_edge_mlp_apply),
    "rgin": (rgin_init, rgin_apply),
    "ggnn": (ggnn_init, ggnn_apply),
    "rgcn": (rgcn_init, rgcn_apply),
    "rgat": (rgat_init, rgat_apply),
    "gnn_film": (gnn_film_init, gnn_film_apply),
    "rgdcn": (rgdcn_init, rgdcn_apply),
}
