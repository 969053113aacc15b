"""Shared graph propagation stack (counterpart of
tf_gnn_samples_tpu/nn/propagation.py):

  input projection to hidden_size (if feature size differs)
  then per layer:
    input dropout (keep prob `graph_layer_input_dropout_keep_prob`)
    averaging residual (cur + last)/2 every `graph_residual_connection_every_num_layers`
    the GNN layer itself (num_timesteps weight-tied repetitions)
    optional inter-layer LayerNorm (`graph_inter_layer_norm`)
    Dense(hidden, activation) every `graph_dense_between_every_num_gnn_layers`
"""

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.graph import GraphBatch
from .activations import get_activation
from .initializers import glorot_uniform
from .layers import LAYERS
from .mlp import dropout
from .normalization import layer_norm, layer_norm_init


def propagation_init(gen, model_params, num_edge_types, initial_feature_size,
                     layer_name, layer_kwargs):
    h_dim = model_params["hidden_size"]
    layer_init, _ = LAYERS[layer_name]
    params = {"layers": []}
    if initial_feature_size != h_dim:
        params["proj"] = glorot_uniform(gen, (initial_feature_size, h_dim))
    dense_every = model_params["graph_dense_between_every_num_gnn_layers"]
    for i in range(model_params["graph_num_layers"]):
        layer_params = {"gnn": layer_init(gen, num_edge_types, h_dim,
                                          **layer_kwargs)}
        if i % dense_every == 0:
            layer_params["dense"] = glorot_uniform(gen, (h_dim, h_dim))
        if model_params["graph_inter_layer_norm"]:
            layer_params["ln"] = layer_norm_init(h_dim)
        params["layers"].append(layer_params)
    return params


def propagation_apply(
    params,
    model_params,
    graph: GraphBatch,
    feats,
    layer_name,
    layer_kwargs,
    gen: Optional[torch.Generator] = None,
):
    """gen=None means eval mode (no dropout)."""
    _, layer_apply = LAYERS[layer_name]
    act = get_activation(model_params["graph_model_activation_function"])
    keep_prob = model_params["graph_layer_input_dropout_keep_prob"]
    residual_every = model_params["graph_residual_connection_every_num_layers"]
    dense_every = model_params["graph_dense_between_every_num_gnn_layers"]
    timesteps = model_params["graph_num_timesteps_per_layer"]

    h = feats
    if "proj" in params:
        h = act(torch.matmul(h, params["proj"]))

    def gnn_layer(gnn_params, hh):
        return layer_apply(gnn_params, graph, hh, num_timesteps=timesteps,
                           **layer_kwargs)

    remat = bool(model_params.get("remat_layers"))
    last_residual = torch.zeros_like(h)
    for i, layer_params in enumerate(params["layers"]):
        h = dropout(h, keep_prob, gen)
        if i % residual_every == 0:
            t = h
            if i > 0:
                h = (h + last_residual) / 2.0
            last_residual = t
        if remat:
            # Recompute the layer in the backward pass instead of keeping
            # its per-edge activations (same math, one extra forward).
            h = checkpoint(gnn_layer, layer_params["gnn"], h,
                           use_reentrant=False)
        else:
            h = gnn_layer(layer_params["gnn"], h)
        if "ln" in layer_params:
            h = layer_norm(layer_params["ln"], h)
        if i % dense_every == 0:
            h = act(torch.matmul(h, layer_params["dense"]))
    return h
