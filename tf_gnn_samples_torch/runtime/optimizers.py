"""Optimizers with TF1 semantics (counterpart of
tf_gnn_samples_tpu/runtime/optimizers.py), updating parameter tensors in
place (the port owns its parameters; JAX rebuilt them functionally).

Semantics matched:
* SGD:      theta -= lr * g
* Adam:     (beta1=0.9, beta2=0.999, eps=1e-8, eps OUTSIDE the sqrt)
            lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
            m = b1*m + (1-b1)*g ; v = b2*v + (1-b2)*g^2
            theta -= lr_t * m / (sqrt(v) + eps)
* RMSProp:  (decay = params['learning_rate_decay'], momentum, eps=1e-10)
            ms  = decay*ms + (1-decay)*g^2
            mom = momentum*mom + lr * g / sqrt(ms + eps)
            theta -= mom
* clip_by_norm per tensor: g * clip/||g|| when ||g|| > clip.
"""

from typing import Any, Dict, List, NamedTuple

import torch


def clip_grads_per_tensor(grads: List[torch.Tensor], clip_norm: float):
    """tf.clip_by_norm applied to each tensor."""
    out = []
    for g in grads:
        norm = torch.sqrt(torch.sum(torch.square(g)))
        scale = torch.clamp(clip_norm / (norm + 1e-20), max=1.0)
        out.append(g * scale)
    return out


class OptimizerState(NamedTuple):
    step: int
    slots: Dict[str, List[torch.Tensor]]  # slot name -> one per parameter


class Optimizer:
    """An (init, update) pair over a list of parameter tensors."""

    def __init__(self, name: str, hparams: Dict[str, float]):
        name = name.lower()
        if name not in ("sgd", "adam", "rmsprop"):
            raise Exception('Unknown optimizer "%s".' % name)
        self.name = name
        self.hparams = hparams

    def init(self, params: List[torch.Tensor]) -> OptimizerState:
        def zeros():
            return [torch.zeros_like(p) for p in params]

        if self.name == "sgd":
            slots = {}
        elif self.name == "adam":
            slots = {"m": zeros(), "v": zeros()}
        else:
            slots = {"ms": zeros(), "mom": zeros()}
        return OptimizerState(step=0, slots=slots)

    @torch.no_grad()
    def update(self, grads, state: OptimizerState, params, lr):
        """Updates `params` and the state's slots in place; returns the new
        state. lr is a float or a 0-d tensor."""
        step = state.step + 1
        if self.name == "sgd":
            for p, g in zip(params, grads):
                p.sub_(lr * g)
            return OptimizerState(step, {})
        if self.name == "adam":
            b1, b2, eps = 0.9, 0.999, 1e-8
            t = torch.tensor(float(step), dtype=torch.float32)
            lr_t = lr * torch.sqrt(1.0 - b2 ** t) / (1.0 - b1 ** t)
            for p, g, m, v in zip(params, grads, state.slots["m"],
                                  state.slots["v"]):
                m.copy_(b1 * m + (1 - b1) * g)
                v.copy_(b2 * v + (1 - b2) * torch.square(g))
                p.sub_(lr_t.to(p.device) * m / (torch.sqrt(v) + eps))
            return OptimizerState(step, state.slots)
        decay = self.hparams.get("decay", 0.9)
        momentum = self.hparams.get("momentum", 0.0)
        eps = 1e-10
        for p, g, ms, mom in zip(params, grads, state.slots["ms"],
                                 state.slots["mom"]):
            ms.copy_(decay * ms + (1 - decay) * torch.square(g))
            mom.copy_(momentum * mom + lr * g / torch.sqrt(ms + eps))
            p.sub_(mom)
        return OptimizerState(step, state.slots)


def make_optimizer(model_params: Dict[str, Any]) -> Optimizer:
    """Build from the reference's hyperparameter names."""
    return Optimizer(
        model_params["optimizer"],
        {
            "decay": model_params.get("learning_rate_decay", 0.98),
            "momentum": model_params.get("momentum", 0.85),
        },
    )
