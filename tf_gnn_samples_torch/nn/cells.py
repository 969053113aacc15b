"""Recurrent cells for GGNN state updates (counterpart of
tf_gnn_samples_tpu/nn/cells.py).

The reference calls tf.keras.layers.{SimpleRNN,GRU,LSTM}Cell with the
*aggregated messages as the cell input* and the *previous node state as
the hidden state* (gnns/ggnn.py:92); that argument order is kept.

Gate maths follow the TF 1.13 keras defaults: GRU gate order (z, r, h)
with reset_after=False (the reset gate multiplies the hidden state BEFORE
the recurrent matmul), LSTM gate order (i, f, c, o) with unit_forget_bias,
and recurrent_activation = hard_sigmoid, clip(0.2 x + 0.5, 0, 1).
"""

import torch

from .activations import get_activation
from .initializers import glorot_uniform, orthogonal, zeros

_GATES = {"rnn": 1, "gru": 3, "lstm": 4}


def cell_init(gen: torch.Generator, cell_type: str, dim: int):
    cell_type = cell_type.lower()
    if cell_type not in _GATES:
        raise ValueError("Unknown RNN cell type '%s'." % cell_type)
    n_gates = _GATES[cell_type]
    params = {
        "kernel": glorot_uniform(gen, (dim, n_gates * dim)),
        "recurrent_kernel": orthogonal(gen, (dim, n_gates * dim)),
        "bias": zeros((n_gates * dim,)),
    }
    if cell_type == "lstm":
        # keras unit_forget_bias: the forget-gate bias starts at 1.
        params["bias"][dim:2 * dim] = 1.0
    return params


def _hard_sigmoid(x):
    """TF1-keras recurrent_activation default: clip(0.2 x + 0.5, 0, 1)."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def cell_apply(params, cell_type: str, x, h, activation: str = "tanh",
               c=None):
    """One cell step; returns (new_h, new_c), new_c None except for LSTM.

    x: [N, D] cell input (aggregated messages in GGNN); h: [N, D] hidden
    state (previous node states); c: [N, D] LSTM cell state, zeros when
    None."""
    cell_type = cell_type.lower()
    act = get_activation(activation)
    xw = torch.matmul(x, params["kernel"])
    U = params["recurrent_kernel"]
    if cell_type == "rnn":
        return act(xw + torch.matmul(h, U) + params["bias"]), None
    if cell_type == "gru":
        d3 = U.shape[-1]
        U_z, U_r, U_h = U[:, :d3 // 3], U[:, d3 // 3:2 * d3 // 3], U[:, 2 * d3 // 3:]
        xz, xr, xh = torch.chunk(xw + params["bias"], 3, dim=-1)
        z = _hard_sigmoid(xz + torch.matmul(h, U_z))
        r = _hard_sigmoid(xr + torch.matmul(h, U_r))
        # reset_after=False: the reset gate applies to the hidden state
        # before the recurrent matmul.
        hh_tilde = act(xh + torch.matmul(r * h, U_h))
        return z * h + (1.0 - z) * hh_tilde, None
    if cell_type == "lstm":
        if c is None:
            c = torch.zeros_like(h)
        gates = xw + torch.matmul(h, U) + params["bias"]
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        new_c = _hard_sigmoid(f) * c + _hard_sigmoid(i) * act(g)
        return _hard_sigmoid(o) * act(new_c), new_c
    raise ValueError("Unknown RNN cell type '%s'." % cell_type)
