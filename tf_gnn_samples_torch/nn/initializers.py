"""Weight initializers matching the TF1 layers the reference uses
(counterpart of tf_gnn_samples_tpu/nn/initializers.py).

Every initializer draws from an explicit `torch.Generator`; for the same
seed the numbers are not the JAX package's, the distributions are.
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


def orthogonal(gen: torch.Generator, shape):
    """A matrix with orthonormal rows or columns, whichever side is smaller
    (the last axis holds the columns), drawn uniformly over such matrices:
    QR of a standard normal draw with the signs of R's diagonal folded into
    Q, as jax.nn.initializers.orthogonal does."""
    n_cols = shape[-1]
    n_rows = math.prod(shape) // n_cols
    a = torch.randn((max(n_rows, n_cols), min(n_rows, n_cols)),
                    generator=gen, dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.T
    return q.reshape(shape).contiguous()


def zeros(shape):
    return torch.zeros(shape, dtype=torch.float32)


def stacked_glorot_uniform(gen: torch.Generator, num_stack, shape):
    """[num_stack, *shape] with each slice glorot-initialized independently
    (fan-in/out per slice, as the reference's L separate Dense layers)."""
    return glorot_uniform(gen, (num_stack,) + tuple(shape))
