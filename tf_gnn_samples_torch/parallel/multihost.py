"""Several processes, one replica or one graph partition each
(counterpart of tf_gnn_samples_tpu/parallel/multihost.py, its
data-parallel part).

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
from typing import Optional

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
