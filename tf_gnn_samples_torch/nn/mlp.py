"""MLP with the reference's utils.MLP semantics (counterpart of
tf_gnn_samples_tpu/nn/mlp.py):

* `hidden_layers` is an int (that many hidden layers of `out_size` units)
  or a list of sizes,
* no biases by default,
* activation between layers, the final layer is always linear,
* dropout is applied to the input of each layer except the output layer.
"""

from typing import List, Optional, Union

import torch

from .initializers import glorot_uniform, zeros


def mlp_init(
    gen: torch.Generator,
    in_size: int,
    out_size: int,
    hidden_layers: Union[List[int], int] = 1,
    use_biases: bool = False,
):
    if isinstance(hidden_layers, int):
        hidden_sizes = [out_size] * hidden_layers
    else:
        hidden_sizes = list(hidden_layers)
    sizes = [in_size] + hidden_sizes + [out_size]
    layers = []
    for d_in, d_out in zip(sizes[:-1], sizes[1:]):
        layer = {"kernel": glorot_uniform(gen, (d_in, d_out))}
        if use_biases:
            layer["bias"] = zeros((d_out,))
        layers.append(layer)
    return {"layers": layers}


def _dense(layer, x):
    y = torch.matmul(x, layer["kernel"])
    if "bias" in layer:
        y = y + layer["bias"]
    return y


def dropout(x, keep_prob: float, gen: Optional[torch.Generator]):
    """Inverted dropout; identity when gen is None or keep_prob >= 1."""
    if gen is None or keep_prob >= 1.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def mlp_apply(params, x, activation_fn=torch.relu, dropout_rate=0.0,
              gen: Optional[torch.Generator] = None):
    """Apply the MLP. Dropout is active iff dropout_rate > 0 and gen given."""
    layers = params["layers"]
    h = x
    for layer in layers[:-1]:
        if dropout_rate > 0.0:
            h = dropout(h, 1.0 - dropout_rate, gen)
        h = activation_fn(_dense(layer, h))
    return _dense(layers[-1], h)
