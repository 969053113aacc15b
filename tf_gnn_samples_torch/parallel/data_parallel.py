"""Data-parallel steps over a process group (counterpart of
tf_gnn_samples_tpu/parallel/data_parallel.py).

The JAX package stacks a replica group's batches and runs one shard_map'd
step over a device mesh. Here each rank of a torch.distributed group steps
its own batch of the group (runtime/model.py _run_epoch_on_stream), so
nothing is stacked: no mesh, no unify_batch_windows, no
stack_task_batches.

Same math as the JAX step: the loss gradient of each rank's batch weighted
by num_graphs / total_graphs and summed over the ranks, then
clip_grads_per_tensor on the sum, then the optimizer update at
_effective_lr(total_graphs). Each rank writes n * g for every parameter and
n = num_graphs into ONE flat buffer; one all_reduce sums the buffers and
every rank divides by the summed n (the JAX step's psum(w * g) up to the
order of rounding). The reduced n and the learning rate stay device
tensors, so a step's two halves can be captured in CUDA graphs with the
all_reduce run eagerly between them (runtime/model.py scanned dp epochs).
"""

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..runtime.optimizers import clip_grads_per_tensor


def world(group=None) -> Tuple[int, int]:
    """(rank, size) of this process in `group` (default: the process
    group); (0, 1) where no process group was initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def _metric_parts(metrics: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    return [metrics[k].detach().reshape(-1).to(torch.float32)
            for k in sorted(metrics)]


def local_grads(model, batch, gen, reduce_metrics: bool = False,
                out: Optional[torch.Tensor] = None):
    """This rank's half of a train step: forward and backward on its own
    batch, dropout masks drawn from `gen` (None: none). Returns (buffer,
    metrics): the buffer holds n * g for every parameter (flattened, in
    model._leaves() order), with reduce_metrics n * v for every metric
    (sorted by name), and n = batch.num_graphs last; written into `out`
    where given. Reads no host value that changes between steps of one
    batch (n is the batch's constant)."""
    leaves = model._leaves()
    loss, metrics = model._forward(model.model_params_tree, batch, gen)
    grads = torch.autograd.grad(loss, leaves)
    parts = [g.reshape(-1) for g in grads]
    if reduce_metrics:
        parts += _metric_parts(metrics)
    parts.append(loss.new_ones(1))
    n = float(batch.num_graphs)
    if out is None:
        buf = torch.cat(parts).mul_(n)
    else:
        buf = torch.cat(parts, out=out).mul_(n)
    return buf, {k: v.detach() for k, v in metrics.items()}


def apply_reduced(model, buf: torch.Tensor) -> torch.Tensor:
    """The other half, after the all_reduce: every rank's sum of n * g over
    the summed n, clipped per tensor, then the optimizer update at the
    learning rate for the summed n, in place. Returns the summed n (a 0-d
    device tensor)."""
    leaves = model._leaves()
    total = buf[-1]
    sizes = [p.numel() for p in leaves]
    flat = buf[:sum(sizes)] / total
    grads = [g.view_as(p) for g, p in zip(flat.split(sizes), leaves)]
    grads = clip_grads_per_tensor(grads, model.params["clamp_gradient_norm"])
    model.opt_state = model._optimizer.update(
        grads, model.opt_state, leaves, model._effective_lr(total))
    return total


def _reduced_metrics(buf, metrics, offset, total):
    red, at = {}, offset
    for k in sorted(metrics):
        size = metrics[k].numel()
        red[k] = (buf[at:at + size] / total).view_as(metrics[k])
        at += size
    red["total_graphs"] = total
    return red


def dp_train_step(model, batch, group=None, reduce_metrics: bool = False):
    """One data-parallel train step of this rank on its `batch` (dropout
    from model._dropout_gen as it stands): one all_reduce over `group`.
    Returns this rank's metrics (device tensors); with reduce_metrics the
    graph-weighted metrics every rank shares, sum(v * n) / sum(n), and
    `total_graphs`, as the JAX package's multi-host step returns them."""
    buf, metrics = local_grads(model, batch, model._dropout_gen,
                               reduce_metrics)
    dist.all_reduce(buf, group=group)
    total = apply_reduced(model, buf)
    if not reduce_metrics:
        return metrics
    return _reduced_metrics(buf, metrics, sum(p.numel()
                                              for p in model._leaves()),
                            total)


@torch.no_grad()
def dp_eval_step(model, batch, group=None, reduce_metrics: bool = False):
    """This rank's eval metrics on its `batch`; with reduce_metrics every
    metric summed over `group` (one all_reduce) and loss = total_loss /
    total_graphs, the JAX package's reduced eval step."""
    metrics = model._eval_step(batch)
    if not reduce_metrics:
        return metrics
    parts = _metric_parts(metrics)
    parts.append(parts[0].new_full((1,), float(batch.num_graphs)))
    buf = torch.cat(parts)
    dist.all_reduce(buf, group=group)
    red = _reduced_metrics(buf, metrics, 0, 1.0)
    del red["total_graphs"]
    red["loss"] = red["total_loss"] / buf[-1]
    return red


def broadcast_state(model, group=None, src: int = 0) -> None:
    """Make every rank's parameters, optimizer slots and step counter rank
    `src`'s, in place (one broadcast), so that captured steps stay bound
    to the tensors they were captured with."""
    state = list(model._leaves())
    for ts in model.opt_state.slots.values():
        state += ts
    state.append(model.opt_state.step_t)
    buf = torch.cat([t.detach().reshape(-1) for t in state])
    dist.broadcast(buf, src, group=group)
    with torch.no_grad():
        for t, v in zip(state, buf.split([t.numel() for t in state])):
            t.copy_(v.view_as(t))


def gather_epoch(rows: List[Dict[str, torch.Tensor]], start_time: float,
                 group=None) -> Tuple[List[List[Dict[str, np.ndarray]]],
                                      float]:
    """Every rank's per-step metrics of an epoch (`rows`: this rank's, one
    dict of device tensors a step, the same keys and shapes on every rank)
    and its seconds since `start_time`, in one all_gather at the epoch's
    end. Returns ([rank][step] {name: array}, the largest seconds: the
    epoch ends when its last rank does). A single process gathers
    nothing: its own rows, as they are."""
    size = world(group)[1]
    if size == 1:
        return ([[{k: np.asarray(v.cpu()) for k, v in r.items()}
                  for r in rows]], time.time() - start_time)
    keys = sorted(rows[0])
    layout = [(k, tuple(rows[0][k].shape)) for k in keys]
    local = torch.stack([torch.cat([r[k].detach().reshape(-1).to(
        torch.float64) for k in keys]) for r in rows]).cpu()
    flat = torch.cat([local.reshape(-1), torch.tensor(
        [time.time() - start_time], dtype=torch.float64)])
    if dist.get_backend(group) == "nccl":
        flat = flat.cuda()
    got = [torch.empty_like(flat) for _ in range(size)]
    dist.all_gather(got, flat, group=group)
    got = [g.cpu().numpy() for g in got]
    per_rank = []
    for g in got:
        values = g[:-1].reshape(len(rows), -1)
        steps = []
        for row in values:
            at, m = 0, {}
            for k, shape in layout:
                n = int(np.prod(shape))
                m[k] = row[at:at + n].reshape(shape).astype(np.float32)
                at += n
            steps.append(m)
        per_rank.append(steps)
    return per_rank, max(float(g[-1]) for g in got)


def empty_like_batch(batch):
    """A zero-weight clone of a TaskBatch that pads a short final replica
    group (the JAX package's _empty_like_batch): node and graph masks
    zeroed and num_graphs 0, so its loss and gradient are finite and weigh
    0 in the sum; its metrics are dropped."""
    g = batch.graph
    graph = g._replace(node_mask=torch.zeros_like(g.node_mask),
                       graph_mask=torch.zeros_like(g.graph_mask),
                       num_graphs=0)
    return batch._replace(graph=graph, num_graphs=0, num_nodes=0,
                          num_edges=0)
