"""Layer normalization with learnable scale and shift (counterpart of
tf_gnn_samples_tpu/nn/normalization.py)."""

import torch


def layer_norm_init(dim):
    return {"scale": torch.ones((dim,), dtype=torch.float32),
            "bias": torch.zeros((dim,), dtype=torch.float32)}


def layer_norm(params, x, eps=1e-12):
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    normed = (x - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return normed * params["scale"] + params["bias"]
