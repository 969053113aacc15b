"""Several processes, one replica or one graph partition each
(counterpart of tf_gnn_samples_tpu/parallel/multihost.py).

The JAX package drives a mesh of devices from one controller per host;
PyTorch's idiom is one process per replica over `torch.distributed`. So a
run of `num_model_replicas = N` is N processes (ranks), each stepping its
own batch of every replica group (parallel/data_parallel.py), and a run
of `graph_parallel = P` is P ranks, each stepping its partition of every
batch (parallel/graph_parallel.py), on its own card or on the CPU.
`initialize` joins them:

* the rendezvous is a coordinator "HOST:PORT" (a TCP store served by rank
  0 there, what init_method="tcp://HOST:PORT" builds) or a "file://PATH"
  store, from the arguments or the environment (GRAFT_COORDINATOR,
  GRAFT_NUM_PROCESSES, GRAFT_PROCESS_ID, as the JAX package reads them);
* the backend is explicit: NCCL for ranks that each own a GPU, gloo on the
  CPU. NCCL refuses two ranks on one device, so more ranks on a host than
  it has GPUs raise unless gloo is asked for by name (`backend="gloo"` or
  GRAFT_DIST_BACKEND=gloo), which lets ranks share a card. Nothing falls
  back quietly;
* a rank's device is cuda:(local rank % GPUs), its local rank its place
  among the ranks on its host, unless the caller asks for the CPU.

`make_hybrid_mesh` and `make_hybrid_gp_train_step` are the JAX package's
hybrid dp x gp step on process groups: gp groups of consecutive ranks on
one host, each row of them stepping its own batch partitioned over the
row, dp across the rows. As in the JAX package, no runtime path or CLI
reaches them (graph_parallel and num_model_replicas exclude each other);
parallel/_multihost_check.py (kind hybrid) drives them.

Launch (2 hosts, one GPU each):
    # host 0:
    python -m tf_gnn_samples_torch.train RGCN PPI \
        --coordinator host0:1234 --num-hosts 2 --host-id 0 \
        --model-param-overrides '{"num_model_replicas": 2}'
    # host 1: the same with --host-id 1
"""

import datetime
import os
import socket
from typing import Any, List, NamedTuple, Optional

import torch
import torch.distributed as dist

ENV_COORDINATOR = "GRAFT_COORDINATOR"
ENV_NUM_PROCESSES = "GRAFT_NUM_PROCESSES"
ENV_PROCESS_ID = "GRAFT_PROCESS_ID"
ENV_BACKEND = "GRAFT_DIST_BACKEND"
LAUNCH_FLAGS = "--coordinator HOST:PORT --num-hosts N --host-id I"


def _store(coordinator: str, num_processes: int, process_id: int):
    if coordinator.startswith("file://"):
        return dist.FileStore(coordinator[len("file://"):], num_processes)
    host, sep, port = coordinator.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError("coordinator %r is not HOST:PORT or file://PATH"
                         % coordinator)
    return dist.TCPStore(host, int(port), num_processes,
                         is_master=process_id == 0)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Optional[str] = None,
               backend: Optional[str] = None,
               timeout: Optional[float] = None) -> torch.device:
    """Join this process to the run's process group (the default group of
    torch.distributed) and return the device its replica runs on.

    Arguments left out are read from GRAFT_COORDINATOR,
    GRAFT_NUM_PROCESSES, GRAFT_PROCESS_ID and GRAFT_DIST_BACKEND. `device`
    is "cuda" (the default) or "cpu"; `backend` defaults to "nccl" for
    CUDA and "gloo" for the CPU. `timeout` (seconds; default the
    backend's own) bounds the rendezvous and every collective, so that a
    rank whose peers stepped elsewhere fails in that time instead of
    waiting out the backend's default."""
    coordinator_address = coordinator_address or os.environ.get(
        ENV_COORDINATOR)
    if num_processes is None and os.environ.get(ENV_NUM_PROCESSES):
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and os.environ.get(ENV_PROCESS_ID):
        process_id = int(os.environ[ENV_PROCESS_ID])
    if coordinator_address is None or num_processes is None or (
            process_id is None):
        raise ValueError(
            "a multi-process run needs its coordinator, process count and "
            "process id (%s, or %s, %s and %s); got %r, %r, %r" % (
                LAUNCH_FLAGS, ENV_COORDINATOR, ENV_NUM_PROCESSES,
                ENV_PROCESS_ID, coordinator_address, num_processes,
                process_id))
    if not 0 <= process_id < num_processes:
        raise ValueError("process id %d is outside 0..%d"
                         % (process_id, num_processes - 1))
    cuda = torch.device(device or "cuda").type == "cuda"
    backend = (backend or os.environ.get(ENV_BACKEND)
               or ("nccl" if cuda else "gloo")).lower()
    if backend not in ("nccl", "gloo"):
        raise ValueError("backend %r: nccl or gloo" % backend)
    if backend == "nccl" and not cuda:
        raise ValueError("the nccl backend needs CUDA ranks; the CPU takes "
                         "gloo")
    gpus = torch.cuda.device_count() if cuda else 0
    if cuda and not gpus and backend == "gloo":
        raise RuntimeError("No CUDA device is available; pass device 'cpu' "
                           "(--device cpu) to run on the CPU.")

    store = _store(coordinator_address, num_processes, process_id)
    limit = {} if timeout is None else {
        "timeout": datetime.timedelta(seconds=timeout)}
    if limit:
        store.set_timeout(limit["timeout"])
    # The ranks on this host, from every rank's host name.
    host = socket.gethostname()
    store.set("host/%d" % process_id, host)
    hosts = [store.get("host/%d" % r).decode() for r in range(num_processes)]
    local_rank, local_ranks = hosts[:process_id].count(host), hosts.count(host)
    if backend == "nccl" and local_ranks > gpus:
        raise ValueError(
            "%d ranks on host %s and %d visible GPUs: NCCL needs a GPU a "
            "rank. Ask for gloo by name (backend 'gloo', %s=gloo) to share "
            "a GPU between ranks." % (local_ranks, host, gpus, ENV_BACKEND))
    if cuda:
        device = torch.device("cuda", local_rank % gpus)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, **limit)
    return device


def shutdown() -> None:
    """Leave the process group, where this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ---- the hybrid dp x gp step ---------------------------------------------


class HybridGroups(NamedTuple):
    """This rank's place in a dp x gp layout: its gp group (the ranks of
    its row, which partition one batch) and its dp group (the ranks at its
    gp position in every row), its row and its position in the row."""

    gp: Any
    dp: Any
    row: int
    gp_rank: int
    dp_size: int


def hybrid_layout(hosts: List[str], gp: int,
                  dp: Optional[int] = None) -> List[List[int]]:
    """The rows (gp groups) of a dp x gp layout over ranks on `hosts`
    (every rank's host name, in rank order): consecutive ranks, each row
    on one host, as the JAX package's make_hybrid_mesh lays a (dp, gp)
    mesh over devices ordered by process. Raises its ValueErrors."""
    total = len(hosts)
    for host in dict.fromkeys(hosts):
        local = hosts.count(host)
        if gp > local or local % gp != 0:
            raise ValueError(
                "gp=%d must divide the local device count %d (gp collectives "
                "must stay within one host)" % (gp, local))
    if dp is None:
        dp = total // gp
    if dp * gp != total:
        raise ValueError("dp*gp=%d != %d global devices" % (dp * gp, total))
    rows = [list(range(r * gp, (r + 1) * gp)) for r in range(dp)]
    for row in rows:
        if len({hosts[i] for i in row}) != 1:
            raise ValueError(
                "ranks %s span hosts %s: each host's ranks must be "
                "consecutive (gp collectives must stay within one host)"
                % (row, sorted({hosts[i] for i in row})))
    return rows


def make_hybrid_mesh(gp: int = 1, dp: Optional[int] = None) -> HybridGroups:
    """This rank's gp and dp groups of the dp x gp layout over the process
    group (hybrid_layout over every rank's host name). Every rank creates
    every group, in one order (all rows, then all gp positions), as
    torch.distributed.new_group requires."""
    rank, total = dist.get_rank(), dist.get_world_size()
    hosts = [None] * total
    dist.all_gather_object(hosts, socket.gethostname())
    rows = hybrid_layout(hosts, gp, dp)
    gp_groups = [dist.new_group(row) for row in rows]
    dp_groups = [dist.new_group([row[j] for row in rows]) for j in range(gp)]
    row = rank // gp
    return HybridGroups(gp=gp_groups[row], dp=dp_groups[rank % gp], row=row,
                        gp_rank=rank % gp, dp_size=len(rows))


def seed_hybrid_dropout(model, seed: int, groups: HybridGroups) -> None:
    """A hybrid step's dropout streams, as the JAX step folds its key: the
    replicated models' generator alike within a row and different across
    rows (fold_in(rng, dp)), the propagation's different on every rank
    (then fold_in(., gp))."""
    row_seed = seed + (groups.row + 1) * 2**31
    model._dropout_gen.manual_seed(row_seed)
    model._gp_prop_gen.manual_seed(row_seed + (groups.gp_rank + 1) * 2**40)


def _dp_weight(num_graphs, total_graphs):
    """A row's share of the dp sum: its graphs over every row's."""
    return num_graphs / total_graphs


def make_hybrid_gp_train_step(model, groups: HybridGroups):
    """The hybrid dp x gp train step (the JAX package's
    make_hybrid_gp_train_step). step(batch, shard) with this row's padded
    batch and this rank's shard of it (GPShard or GPHaloShard), its
    dropout streams seeded by seed_hybrid_dropout beforehand: the
    propagation runs partitioned over the row (make_gp_task_steps on the
    gp group), the task models replicated within it; the gradients are
    averaged over gp, then summed over dp with the weight num_graphs /
    total_graphs (the total summed over dp), clipped per tensor and
    applied at _effective_lr(total_graphs). Returns the metrics
    psum_dp(pmean_gp(m) * weight) and total_graphs, the same on every
    rank."""
    from ..runtime.optimizers import clip_grads_per_tensor
    from .graph_parallel import _reduce_grads, make_gp_task_steps

    steps = make_gp_task_steps(model, groups.gp)
    clip_norm = model.params["clamp_gradient_norm"]

    def step(batch, shard):
        grads, metrics = steps.grads(batch, shard)
        names = sorted(metrics)
        metrics = _reduce_grads([metrics[k].float() for k in names],
                                groups.gp)
        device = grads[0].device
        total = torch.tensor(float(batch.num_graphs), device=device)
        dist.all_reduce(total, group=groups.dp)
        weight = _dp_weight(float(batch.num_graphs), total)
        reduced = _reduce_grads([g * weight for g in grads + metrics],
                                groups.dp, mean=False)
        grads = reduced[:len(grads)]
        model.opt_state = model._optimizer.update(
            clip_grads_per_tensor(grads, clip_norm), model.opt_state,
            model._leaves(), model._effective_lr(total))
        out = dict(zip(names, reduced[len(grads):]))
        out["total_graphs"] = total
        return out

    return step
