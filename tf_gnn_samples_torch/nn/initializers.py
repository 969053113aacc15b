"""Weight initializers matching the TF1 layers the reference uses
(counterpart of tf_gnn_samples_tpu/nn/initializers.py).

Every initializer draws from an explicit `torch.Generator`; the numbers
differ from jax.random's for the same seed, the distributions do not.
"""

import math

import torch


def glorot_uniform(gen: torch.Generator, shape):
    """U(-l, l) with l = sqrt(6 / (fan_in + fan_out)); fan_in and fan_out
    are the last two axes (in_axis=-2, out_axis=-1)."""
    fan_in, fan_out = shape[-2], shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (2.0 * u - 1.0) * limit


def zeros(shape):
    return torch.zeros(shape, dtype=torch.float32)


def stacked_glorot_uniform(gen: torch.Generator, num_stack, shape):
    """[num_stack, *shape] with each slice glorot-initialized independently
    (fan-in/out per slice, as the reference's L separate Dense layers)."""
    return glorot_uniform(gen, (num_stack,) + tuple(shape))
