"""Relational message-passing layers (counterpart of
tf_gnn_samples_tpu/nn/layers.py). Ported so far: GNN-FiLM.

Each layer is a pair of functions over plain dicts of tensors:
    <name>_init(gen, num_edge_types, state_dim, **cfg) -> params
    <name>_apply(params, graph: GraphBatch, h: [N, D], **cfg) -> [N, D]
"""

import torch

from ..ops import ranked_segment as rs
from ..ops.edge_ops import (
    aggregate_flat,
    fine_table_to_nodes,
    gather_flat_src,
    gather_flat_tgt,
    take_by_fine_rank,
)
from ..ops.graph import GraphBatch
from .activations import get_activation
from .initializers import stacked_glorot_uniform
from .normalization import layer_norm, layer_norm_init


def typed_transform(h, W):
    """All-type node transform: [N, D_in] x [L, D_in, D_out] -> [L, N, D_out]
    (a plain f32 batched matmul, outside any kernel)."""
    return torch.matmul(h.unsqueeze(0), W)


def _flat(t):
    """[L, N, D] -> [L * N, D] type-stacked node table."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


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
    "gnn_film": (gnn_film_init, gnn_film_apply),
}
