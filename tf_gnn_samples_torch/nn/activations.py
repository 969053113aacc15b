"""Activation registry (counterpart of tf_gnn_samples_tpu/nn/activations.py).

Notes on parity with the reference's TF1 semantics:
* 'leaky_relu' uses alpha=0.2 (tf.nn.leaky_relu default), NOT 0.01.
* 'gelu' is the exact erf formulation, not the tanh approximation.
* 'linear' / None is identity.
"""

import math

import torch
import torch.nn.functional as F


def _gelu_erf(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _leaky_relu_02(x):
    # jax.nn.leaky_relu's form: its gradient at exactly 0 is 1, where
    # F.leaky_relu's is the slope. Sums of bf16-rounded messages (the
    # ranked aggregation) cancel to exact zeros often enough to matter.
    return torch.where(x >= 0, x, 0.2 * x)


_ACTIVATIONS = {
    "linear": lambda x: x,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "leaky_relu": _leaky_relu_02,
    "elu": F.elu,
    "selu": F.selu,
    "gelu": _gelu_erf,
    "sigmoid": torch.sigmoid,
}


def get_activation(name):
    if name is None:
        return lambda x: x
    key = name.lower()
    try:
        return _ACTIVATIONS[key]
    except KeyError:
        raise ValueError("Unknown activation function '%s'!" % name) from None
