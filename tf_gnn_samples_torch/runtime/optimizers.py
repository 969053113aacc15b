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

The update is capturable in a CUDA graph (runtime/model.py's scanned
epochs): it reads no host value that changes from step to step. The step
count lives twice: as a host int (`step`, the JAX package's `opt_step` in
checkpoints) and as a 0-d f32 tensor beside the parameters (`step_t`),
which the update advances in place and Adam's bias correction reads, so a
replayed update advances it too. The caller keeps the host count of a
replayed update itself.
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
    # The step count as a 0-d f32 tensor on the parameters' device
    # (advanced in place by update).
    step_t: torch.Tensor


def step_tensor(step: int, params: List[torch.Tensor]) -> torch.Tensor:
    """A 0-d f32 step counter holding `step`, on the parameters' device."""
    device = params[0].device if params else None
    return torch.full((), float(step), dtype=torch.float32, device=device)


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
        return OptimizerState(step=0, slots=slots,
                              step_t=step_tensor(0, params))

    @torch.no_grad()
    def update(self, grads, state: OptimizerState, params, lr):
        """Updates `params`, the state's slots and its step_t in place;
        returns the new state (the host step one higher). lr is a float or
        a 0-d tensor; a float is a constant of a captured update, which is
        right where the caller's lr is constant for the captured batch."""
        step = state.step + 1
        step_t = state.step_t
        step_t.add_(1.0)
        if self.name == "sgd":
            for p, g in zip(params, grads):
                p.sub_(lr * g)
            return OptimizerState(step, {}, step_t)
        if self.name == "adam":
            b1, b2, eps = 0.9, 0.999, 1e-8
            # On the device from the device counter: no host value per
            # step.
            lr_t = lr * torch.sqrt(1.0 - b2 ** step_t) / (1.0 - b1 ** step_t)
            for p, g, m, v in zip(params, grads, state.slots["m"],
                                  state.slots["v"]):
                m.copy_(b1 * m + (1 - b1) * g)
                v.copy_(b2 * v + (1 - b2) * torch.square(g))
                p.sub_(lr_t * m / (torch.sqrt(v) + eps))
            return OptimizerState(step, state.slots, step_t)
        decay = self.hparams.get("decay", 0.9)
        momentum = self.hparams.get("momentum", 0.0)
        eps = 1e-10
        for p, g, ms, mom in zip(params, grads, state.slots["ms"],
                                 state.slots["mom"]):
            ms.copy_(decay * ms + (1 - decay) * torch.square(g))
            mom.copy_(momentum * mom + lr * g / torch.sqrt(ms + eps))
            p.sub_(mom)
        return OptimizerState(step, state.slots, step_t)


def make_optimizer(model_params: Dict[str, Any]) -> Optimizer:
    """Build from the reference's hyperparameter names."""
    return Optimizer(
        model_params["optimizer"],
        {
            "decay": model_params.get("learning_rate_decay", 0.98),
            "momentum": model_params.get("momentum", 0.85),
        },
    )
