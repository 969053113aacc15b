"""Training runtime (counterpart of the core of
tf_gnn_samples_tpu/runtime/model.py): model assembly (task input model ->
shared propagation stack -> task output model), per-tensor gradient
clipping and TF1 optimizers, a per-batch epoch driver with throughput
telemetry and an optional device-resident batch cache (with scanned
epochs over it: a CUDA graph a cached batch on the card), patience-based
early stopping with best-checkpoint pickling, full training-state
checkpoints to resume from, JSONL and TensorBoard metric writers, and
weight save/load with fresh-init of unmatched entries. Log lines are the
JAX package's, verbatim (run_qm9_benchs.py regexes them).

Parameters are a nested dict/list tree of tensors shaped as the JAX
package's pytree, and checkpoints key them by the same `flatten_params`
names (e.g. `prop/layers/0/gnn/W_film`), so a pickle written by either
package loads into the other.

Entry points run on CUDA unless the caller asks for the CPU; a missing
GPU raises instead of falling back.
"""

import os
import pickle
import random
import time
from abc import ABC
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..nn.layers import use_dense_strategy
from ..nn.propagation import propagation_apply, propagation_init
from ..ops import ranked_segment as rs
from ..ops.edge_ops import dense_adjacency
from ..ops.graph import graph_to_device
from ..parallel import data_parallel as dp
from ..parallel.multihost import LAUNCH_FLAGS
from ..tasks.base import DataFold, SparseGraphTask, TaskBatch
from ..utils.iterators import ThreadedIterator
from ..utils.metrics_writer import MetricsWriter
from ..utils.tb_writer import FoldedTensorBoardWriter
from .optimizers import (OptimizerState, clip_grads_per_tensor,
                         make_optimizer, step_tensor)

# Consecutive flagged validation epochs before the degenerate-basin
# warning fires.
COLLAPSE_WARN_EPOCHS = 5


def resolve_device(name: Optional[str] = None) -> torch.device:
    """'cuda' (the default) or 'cpu'. Asking for CUDA without a GPU raises:
    the port never carries on quietly on the CPU."""
    device = torch.device(name or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("No CUDA device is available; pass device 'cpu' "
                           "(--device cpu) to run on the CPU.")
    return device


# FlatEdges' diluted src stream, whose length the JAX package's
# unify_flat_windows makes common across a cached fold before it keys the
# fold's batches: batch_shape_key leaves it out.
_UNIFIED_FIELDS = ("sd_rank", "sd_fine", "sd_coarse")


def batch_shape_key(batch: TaskBatch):
    """The shape signature that groups a cached fold's batches as the JAX
    package's batch_shape_key groups the same fold: every tensor's shape
    and dtype (the graph's, its edge stream's and the task's aux tensors),
    the per-type edge slices (`tm_offs`, where the JAX batch carries a
    padded block a type) and the self-loop flags (`tm_self`, shape-encoded
    there). Left out is what the JAX package makes common across the fold
    before keying it (unify_flat_windows): the windows, which are ints
    here, and the diluted stream's length. Host counts (num_graphs, ...)
    are left out as there; so is a cached dense adjacency, which the JAX
    package does not stack."""
    g = batch.graph
    flat = g.flat
    key = []
    for name, x in list(zip(g._fields, g)) + list(zip(flat._fields, flat)):
        if torch.is_tensor(x) and name not in _UNIFIED_FIELDS + ("dense_adj",):
            key.append((name, tuple(x.shape), str(x.dtype)))
    key.append(("tm_offs", flat.tm_offs))
    key.append(("tm_self", flat.tm_self))
    for name in sorted(batch.aux):
        x = batch.aux[name]
        key.append((name, tuple(x.shape), str(x.dtype)))
    return tuple(key)


def shape_groups(batches: List[TaskBatch]) -> List[List[int]]:
    """The indices of `batches` grouped by batch_shape_key, groups in the
    order of their first batch (the JAX package's dict order)."""
    by_key: Dict[Any, List[int]] = {}
    for i, b in enumerate(batches):
        by_key.setdefault(batch_shape_key(b), []).append(i)
    return list(by_key.values())


class _Replay(NamedTuple):
    """One cached batch's captured step: the graph, the static tensors it
    writes the step's metrics into, and the kernel launches its capture
    counted (added to ops/ranked_segment.py's counters at every replay).
    A data-parallel train step is two graphs: `graph` writes the rank's
    weighted gradients into the model's reduction buffer, `update` reads
    the buffer after the eager all_reduce and updates the parameters."""

    graph: Any  # torch.cuda.CUDAGraph
    outs: Dict[str, torch.Tensor]
    launches: Dict[str, int]
    form_launches: Dict[str, int]
    update: Any = None


def _check_parallel_options(params: Dict[str, Any],
                            ranks_too: bool = True) -> None:
    """num_model_replicas and graph_parallel, held to the JAX package's
    checks (its runtime/model.py _run_epoch) with ranks in place of
    devices: the two options exclude each other, N replicas or P
    partitions are the N (P) ranks of a torch.distributed process group,
    one a replica (a partition), never one process standing in for
    several. ranks_too=False checks the options alone (a model may be
    built before its process group)."""
    replicas = int(params.get("num_model_replicas") or 1)
    gp = int(params.get("graph_parallel") or 1)
    if gp > 1 and replicas > 1:
        raise ValueError("graph_parallel and num_model_replicas are mutually "
                         "exclusive (got %d and %d)" % (gp, replicas))
    if not ranks_too:
        return
    name, want, one = (("graph_parallel", gp, "partition") if gp > 1
                       else ("num_model_replicas", replicas, "replica"))
    if want > 1 and not torch.distributed.is_initialized():
        raise ValueError(
            "%s=%d runs one process a %s in a torch.distributed process "
            "group, and none was initialized: launch %d processes with %s "
            "(parallel/multihost.py initialize)"
            % (name, want, one, want, LAUNCH_FLAGS))
    ranks = dp.world()[1]
    if ranks != want:
        raise ValueError("%s=%d but the process group has %d ranks (one "
                         "rank a %s)" % (name, want, ranks, one))


def flatten_params(tree, prefix: str = "") -> Dict[str, Any]:
    """Nested dict/list tree -> {path: leaf}, paths joined by '/' with dict
    keys sorted (the JAX package's checkpoint names)."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(flatten_params(v, "%s/%s" % (prefix, k) if prefix
                                   else str(k)))
    return flat


def _unflatten(flat: Dict[str, Any]):
    """Inverse of flatten_params: dicts whose keys are all digits are
    lists."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = root
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def params_from_jax(flat: Dict[str, np.ndarray], device=None):
    """The JAX package's `flatten_params` dict -> the port's parameter tree
    (float32 tensors on `device`). The port keeps the JAX names and layouts
    (W [L, D_in, D_out], W_film [L, D, 2D], RGAT's att [L, 2D], a GGNN
    cell's kernel and recurrent_kernel [D, G * D] and bias [G * D] under
    `.../gnn/cell/`, GNN-Edge-MLP's and RGIN's lists of stacked matrices
    under `.../gnn/edge_mlp/<i>` and their `.../gnn/ln/{scale,bias}`,
    RGIN's aggregation MLP under `.../gnn/aggr_mlp/layers/<i>/kernel`), so
    the map is name for name; entries whose names are all digits become
    lists."""
    return _unflatten({k: torch.tensor(np.asarray(v, dtype=np.float32),
                                       device=device)
                       for k, v in flat.items()})


def params_to_jax(tree) -> Dict[str, np.ndarray]:
    """Inverse of params_from_jax: {flatten_params name: float32 array}."""
    return {k: v.detach().cpu().numpy()
            for k, v in flatten_params(tree).items()}


def opt_state_to_jax(state: OptimizerState, tree) -> Dict[str, Any]:
    """An optimizer state over the leaves of `tree` -> {"slots":
    {"{slot}/{flatten_params name}": float32 array}, "step": int}: the
    JAX package's `flatten_params` of its {slot: parameter tree} dict and
    its step counter."""
    names = list(flatten_params(tree))
    return {"slots": {"%s/%s" % (slot, name): t.detach().cpu().numpy()
                      for slot, ts in state.slots.items()
                      for name, t in zip(names, ts)},
            "step": int(state.step)}


def opt_state_from_jax(slots: Dict[str, np.ndarray], step: int, tree,
                       fresh: OptimizerState) -> OptimizerState:
    """Inverse of opt_state_to_jax onto the leaves of `tree`: each slot of
    `fresh` (the optimizer's init over those leaves) takes the saved array
    of its name, in its dtype and on its device; a name missing from
    `slots` keeps the fresh value."""
    names = list(flatten_params(tree))
    return OptimizerState(
        step=int(step),
        slots={slot: [_saved_or(slots, "%s/%s" % (slot, n), t)
                      for n, t in zip(names, ts)]
               for slot, ts in fresh.slots.items()},
        step_t=step_tensor(int(step), list(flatten_params(tree).values())))


def _saved_or(saved: Dict[str, np.ndarray], key: str,
              current: torch.Tensor) -> torch.Tensor:
    """saved[key] in `current`'s dtype and on its device (shapes must
    agree), or `current` where `saved` has no such entry."""
    if key not in saved:
        return current
    value = torch.tensor(np.asarray(saved[key]), dtype=current.dtype,
                         device=current.device)
    assert value.shape == current.shape, (key, tuple(value.shape),
                                          tuple(current.shape))
    return value


def batch_to_device(batch: TaskBatch, device) -> TaskBatch:
    return batch._replace(
        graph=graph_to_device(batch.graph, device),
        aux={k: v.to(device, non_blocking=True) for k, v in batch.aux.items()},
    )


class _Fanout:
    """JSONL stream plus TensorBoard event files, fed the same (fold, step,
    scalars) records (the reference's --tensorboard writes event files;
    the JSONL stream is the always-readable extra)."""

    def __init__(self, sinks):
        self._sinks = sinks

    def write(self, fold, step, scalars):
        for sink in self._sinks:
            sink.write(fold, step, scalars)


class SparseGraphModel(ABC):
    """Abstract model: training loop + propagation stack around task heads."""

    layer_name: str = ""  # key into nn.layers.LAYERS

    @classmethod
    def default_params(cls):
        # Reference defaults: models/sparse_graph_model.py:22-45.
        return {
            "max_nodes_in_batch": 50000,
            "graph_num_layers": 8,
            "graph_num_timesteps_per_layer": 1,
            "graph_layer_input_dropout_keep_prob": 0.8,
            "graph_dense_between_every_num_gnn_layers": 1,
            "graph_model_activation_function": "tanh",
            "graph_residual_connection_every_num_layers": 2,
            "graph_inter_layer_norm": False,
            "max_epochs": 10000,
            "patience": 25,
            "optimizer": "Adam",
            "learning_rate": 0.001,
            "learning_rate_decay": 0.98,
            "lr_for_num_graphs_per_batch": None,
            "momentum": 0.85,
            "clamp_gradient_norm": 1.0,
            "random_seed": 0,
            # Keep each fold's padded batches resident on the device across
            # epochs: no per-epoch packing and host->device uploads. For
            # TRAIN the batch *order* is reshuffled per epoch but
            # graph-to-batch packing is frozen after the first epoch (the
            # reference re-packs after a full data shuffle each epoch,
            # ppi_task.py:204); `repack_cached_every` (K, read with
            # params.get, default off) re-packs every K epochs.
            "cache_batches_on_device": False,
            # `scan_epochs` (read with params.get, default off, as in the
            # JAX package): with the cache, every epoch of a fold after its
            # first runs the cached batches grouped by shape
            # (batch_shape_key), groups and batches in a drawn order, one
            # dropout seed a group; on the card each cached batch's train
            # and eval steps are CUDA graphs, captured at their first such
            # epoch and replayed.
            # Recompute each GNN layer in the backward pass instead of
            # keeping its activations (nn/propagation.py).
            "remat_layers": False,
        }

    @staticmethod
    def name(params: Dict[str, Any]) -> str:
        raise NotImplementedError()

    def layer_kwargs(self) -> Dict[str, Any]:
        return {}

    def __init__(
        self,
        params: Dict[str, Any],
        task: SparseGraphTask,
        run_id: str,
        result_dir: str,
        device=None,
    ) -> None:
        _check_parallel_options(params, ranks_too=False)
        self.params = params
        self.task = task
        self.run_id = run_id
        self.result_dir = result_dir
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # The typed transforms are f32 matmuls in the reference: keep
            # them in full f32 (no TF32) on the card.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        seed = params["random_seed"]
        random.seed(seed)
        np.random.seed(seed)
        self._init_gen = torch.Generator().manual_seed(seed)
        self._dropout_gen = torch.Generator(device=self.device)
        # graph_parallel: this rank's propagation dropout stream (the
        # replicated input and output models draw from _dropout_gen).
        self._gp_prop_gen = torch.Generator(device=self.device)
        self._optimizer = make_optimizer(params)
        self._step_rng = np.random.RandomState(seed)

        self.model_params_tree = self._init_params()
        self.opt_state = self._optimizer.init(self._leaves())
        # Batches run per fold (host telemetry: lets a caller check that
        # every batch went through the expected kernels).
        self.batches_run = {fold: 0 for fold in DataFold}
        # Device-resident batches per fold (cache_batches_on_device), the
        # dense adjacencies cached with them (GB, per fold and in all) and
        # the TRAIN epochs run, which set the re-pack cadence.
        self._batch_cache: Dict[DataFold, List[TaskBatch]] = {}
        self._dense_adj_cached_gb = 0.0
        self._fold_adj_gb: Dict[DataFold, float] = {}
        self._train_epochs_seen = 0
        self._warned_stream_cache = False
        # scan_epochs: per fold, the cached batches' shape groups and the
        # static tensors each cached batch's graph writes its metrics into
        # (the metrics of the fold's eager epoch, kept); per fold and
        # cached batch, its captured step (on the card). The graphs share
        # one memory pool and are captured and replayed on one side stream.
        self._scan_groups: Dict[DataFold, List[List[int]]] = {}
        self._scan_outs: Dict[DataFold, List[Dict[str, torch.Tensor]]] = {}
        self._graphs: Dict[DataFold, Dict[int, _Replay]] = {}
        self._graph_pool = None
        self._scan_stream = None
        # Per fold, as last packed: the graph counts of each replica
        # group's batches (one batch a group for a single process; a rank
        # caches only its own entry of each group) and the fold's graph,
        # node and edge totals. Data parallelism (num_model_replicas > 1,
        # one rank a replica): whether the ranks' parameters were made
        # rank 0's since they were last set; the reduction buffer of the
        # captured steps.
        self._fold_counts: Dict[DataFold, Tuple[List[List[int]],
                                              Tuple[int, int, int]]] = {}
        self._dp_synced = False
        self._dp_buffer = None
        # graph_parallel: the steps (parallel/graph_parallel.py
        # make_gp_task_steps) and, per fold, the cached (batch, this
        # rank's shard, num_graphs) entries and the fold's totals.
        self._gp_steps = None
        self._gp_batch_cache: Dict[DataFold, Tuple[List[Any],
                                                   Tuple[int, int, int]]] = {}

    def initialize_model(self) -> None:
        """Kept for API parity with the JAX package (reference
        initialize_model, sparse_graph_model.py:85-89); parameters are
        initialized in __init__."""

    # -------------------- files --------------------

    @property
    def log_file(self):
        return os.path.join(self.result_dir, "%s.log" % self.run_id)

    @property
    def best_model_file(self):
        return os.path.join(self.result_dir, "%s_best_model.pickle" % self.run_id)

    @property
    def training_state_file(self):
        return os.path.join(self.result_dir,
                            "%s_training_state.pickle" % self.run_id)

    # -------------------- parameters --------------------

    def _init_params(self):
        gen = self._init_gen
        tree = {
            "input": self.task.input_init(gen),
            "prop": propagation_init(
                gen, self.params, self.task.num_edge_types,
                self.task.initial_node_feature_size, self.layer_name,
                self.layer_kwargs(),
            ),
            "output": self.task.output_init(gen, self.params["hidden_size"]),
        }
        return self._as_leaves(flatten_params(tree))

    def _as_leaves(self, flat: Dict[str, torch.Tensor]):
        return _unflatten({
            k: v.detach().to(self.device, torch.float32).requires_grad_(True)
            for k, v in flat.items()
        })

    def _leaves(self) -> List[torch.Tensor]:
        return list(flatten_params(self.model_params_tree).values())

    # -------------------- forward and steps --------------------

    def _wants_dense_adj(self, graph) -> bool:
        # RGDCN qualifies through its aggregate-first form: its per-type
        # neighbour sums ride the same A_l matmuls (nn/layers.py
        # _typed_neighbor_sums).
        if self.layer_name not in ("rgcn", "ggnn", "rgdcn"):
            return False
        return use_dense_strategy(
            graph,
            self.layer_kwargs().get("message_aggregation_function", "sum"),
            self.params.get("aggregation_strategy", "auto"))

    def _forward(self, params, batch: TaskBatch, gen):
        """Task input model -> propagation stack -> task output model.
        gen=None means eval (no dropout)."""
        # The dense strategy's adjacency is built once per step and shared
        # by every layer (and the backward pass), as in the JAX package.
        if batch.graph.dense_adj is None and self._wants_dense_adj(
                batch.graph):
            batch = batch._replace(graph=batch.graph._replace(
                dense_adj=dense_adjacency(batch.graph)))
        # A task without input parameters has no "input" entry (no leaves).
        feats = self.task.input_apply(params.get("input", {}), batch, gen)
        final_h = propagation_apply(
            params["prop"], self.params, batch.graph, feats,
            self.layer_name, self.layer_kwargs(), gen=gen,
        )
        return self.task.output_apply(params["output"], batch, final_h,
                                      feats, gen)

    def _effective_lr(self, num_graphs):
        """The learning rate for a step over `num_graphs` graphs (an int, or
        the data-parallel step's reduced count, a 0-d device tensor)."""
        lr = self.params["learning_rate"]
        per_batch = self.params.get("lr_for_num_graphs_per_batch")
        if per_batch is not None:
            lr = lr * num_graphs / float(per_batch)
        return lr

    @property
    def _replicas(self) -> int:
        return int(self.params.get("num_model_replicas") or 1)

    @property
    def _partitions(self) -> int:
        return int(self.params.get("graph_parallel") or 1)

    def _seed_dropout(self, seed: int) -> None:
        """Seed the dropout generator from a step seed drawn from _step_rng,
        with this process's rank folded in (0 without a process group), as
        the JAX package's dp step folds in its axis index."""
        self._dropout_gen.manual_seed(seed + dp.world()[0] * 2**31)

    def _train_step(self, batch: TaskBatch):
        self._seed_dropout(int(self._step_rng.randint(0, 2**31 - 1)))
        if self._replicas > 1:
            return dp.dp_train_step(self, batch)
        return self._train_step_body(batch)

    def _train_step_body(self, batch: TaskBatch):
        """One train step drawing its dropout masks from _dropout_gen as it
        stands. Capturable: the learning rate is constant for a batch, the
        optimizer reads no host value that changes between steps, and the
        metrics stay on the device."""
        leaves = self._leaves()
        loss, metrics = self._forward(self.model_params_tree, batch,
                                      self._dropout_gen)
        grads = torch.autograd.grad(loss, leaves)
        grads = clip_grads_per_tensor(grads, self.params["clamp_gradient_norm"])
        self.opt_state = self._optimizer.update(
            grads, self.opt_state, leaves,
            self._effective_lr(batch.num_graphs))
        return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def _eval_step(self, batch: TaskBatch):
        _, metrics = self._forward(self.model_params_tree, batch, None)
        return metrics

    # -------------------- save / load --------------------

    def save_model(self, path: str) -> None:
        """Pickle the weights (rank 0 alone in a data-parallel run)."""
        if dp.world()[0]:
            return
        data_to_save = {
            "model_class": self.name(self.params),
            "task_class": self.task.name(),
            "model_params": self.params,
            "task_params": self.task.params,
            "task_metadata": self.task.get_metadata(),
            "weights": params_to_jax(self.model_params_tree),
        }
        with open(path, "wb") as f:
            pickle.dump(data_to_save, f, pickle.HIGHEST_PROTOCOL)

    def load_weights(self, weights: Dict[str, np.ndarray]) -> None:
        """Partial restore by flatten_params name: entries missing from
        `weights` keep their fresh initialization (reference
        sparse_graph_model.py:109-126)."""
        saved = flatten_params(params_from_jax(weights))
        current = flatten_params(self.model_params_tree)
        for key, leaf in current.items():
            if key in saved:
                assert saved[key].shape == leaf.shape, (
                    key, tuple(saved[key].shape), tuple(leaf.shape))
                current[key] = saved[key]
            else:
                print("Freshly initializing %s since no saved value was "
                      "found." % key)
        for key in saved:
            if key not in current:
                print("Saved weights for %s not used by model." % key)
        self.model_params_tree = self._as_leaves(current)
        self.opt_state = self._optimizer.init(self._leaves())
        # Captured steps update the tensors they were captured with.
        self._drop_graphs()
        self._dp_synced = False

    # -------------------- full training-state checkpoint ----------------
    # The reference's best-model pickle carries weights only. These
    # checkpoints also carry the optimizer's slots and step, the epoch, the
    # early-stopping state and the host RNGs, so that training continues
    # exactly where it stopped. Keys and names are the JAX package's.

    def save_training_state(self, path: str, epoch: int,
                            early_stop_state: Dict[str, Any]) -> None:
        if dp.world()[0]:
            return  # rank 0 alone writes the run's files
        opt = opt_state_to_jax(self.opt_state, self.model_params_tree)
        state = {
            "model_class": self.name(self.params),
            "task_class": self.task.name(),
            "model_params": self.params,
            "task_params": self.task.params,
            "task_metadata": self.task.get_metadata(),
            "weights": params_to_jax(self.model_params_tree),
            # {slot}/{parameter name}, as the JAX package flattens its
            # {slot: parameter tree} dict.
            "opt_slots": opt["slots"],
            "opt_step": opt["step"],
            "epoch": epoch,
            "early_stop_state": early_stop_state,
            # Every generator drawn from between steps: the dropout
            # generator is reseeded from _step_rng each step, and the global
            # numpy RNG drives the TRAIN shuffles (tasks/qm9.py
            # make_minibatch_iterator, the cached batch order). No task
            # draws from `random`.
            "step_rng_state": self._step_rng.get_state(),
            "np_random_state": np.random.get_state(),
        }
        with open(path, "wb") as f:
            pickle.dump(state, f, pickle.HIGHEST_PROTOCOL)

    def restore_training_state(self, path: str) -> Dict[str, Any]:
        """Load a full-state checkpoint onto the model's device; returns
        {'epoch', 'early_stop_state'} for the train loop to continue
        from. Entries missing from it keep their current values."""
        with open(path, "rb") as f:
            state = pickle.load(f)

        current = flatten_params(self.model_params_tree)
        self.model_params_tree = self._as_leaves({
            k: _saved_or(state["weights"], k, v) for k, v in current.items()})
        self.opt_state = opt_state_from_jax(
            state["opt_slots"], state["opt_step"], self.model_params_tree,
            self._optimizer.init(self._leaves()))
        self._step_rng.set_state(state["step_rng_state"])
        np.random.set_state(state["np_random_state"])
        self._drop_graphs()
        self._dp_synced = False
        return {"epoch": state["epoch"],
                "early_stop_state": state["early_stop_state"]}

    # -------------------- epoch driver --------------------

    def log_line(self, msg: str) -> None:
        """Print `msg`; append it to the log (rank 0 alone in a
        data-parallel run: every rank prints the same lines)."""
        if not dp.world()[0]:
            os.makedirs(self.result_dir, exist_ok=True)
            with open(self.log_file, "a") as f:
                f.write(msg + "\n")
        print(msg)

    def _attach_cached_dense_adj_fold(self, batches: List[TaskBatch],
                                      data_fold: DataFold) -> List[TaskBatch]:
        """When a fold's batches stay on the device across epochs, also
        cache the dense adjacency of those that take the dense strategy:
        built once per cached batch instead of once per step. All or
        nothing per fold, within `dense_adj_cache_budget_gb` (default 9.0)
        shared by the folds. Kept in f32, as `_forward` builds it (the
        JAX package stores bf16 for the MXU; the port's dense products are
        f32 without TF32, so a bf16 cache would change what a cached step
        computes), so counted at 4 bytes an entry."""
        wants = [self._wants_dense_adj(b.graph) for b in batches]
        # Per batch: a fold may mix n_pad levels.
        fold_gb = sum(
            b.graph.num_edge_types * b.graph.n_pad * b.graph.n_pad * 4 / 1e9
            for b, w in zip(batches, wants) if w)
        budget = float(self.params.get("dense_adj_cache_budget_gb", 9.0))
        if not fold_gb or self._dense_adj_cached_gb + fold_gb > budget:
            return batches
        self._dense_adj_cached_gb += fold_gb
        self._fold_adj_gb[data_fold] = fold_gb
        with torch.no_grad():
            return [
                b._replace(graph=b.graph._replace(
                    dense_adj=dense_adjacency(b.graph))) if w else b
                for b, w in zip(batches, wants)
            ]

    def _invalidate_fold_cache(self, data_fold: DataFold) -> None:
        """Drop a fold's device-resident batches (and their cached dense
        adjacencies) so that the next epoch re-packs from host data."""
        self._batch_cache.pop(data_fold, None)
        self._dense_adj_cached_gb -= self._fold_adj_gb.pop(data_fold, 0.0)
        # The fold's captured steps read the batches dropped here.
        self._scan_groups.pop(data_fold, None)
        self._scan_outs.pop(data_fold, None)
        self._graphs.pop(data_fold, None)
        self._fold_counts.pop(data_fold, None)
        self._gp_batch_cache.pop(data_fold, None)

    def _drop_graphs(self) -> None:
        """Drop every captured step (they update the tensors they were
        captured with; after a rebinding those are no longer the model's).
        The next scanned epoch captures anew."""
        self._graphs.clear()
        self._graph_pool = None

    def _run_epoch(
        self,
        epoch_name: str,
        data: Iterable[Any],
        data_fold: DataFold,
        quiet: bool = False,
    ) -> Tuple[float, List[Dict[str, Any]], int, float, float, float]:
        _check_parallel_options(self.params)
        if self._partitions > 1:
            return self._run_epoch_graph_parallel(epoch_name, data,
                                                  data_fold, quiet)
        if self.params.get("scan_epochs") and self.device.type == "cuda":
            # Every step of a scanning model runs on the side stream its
            # graphs are captured on: the eager epochs warm it up (cuBLAS
            # workspaces, the kernels' entry points) for the captures.
            if self._scan_stream is None:
                self._scan_stream = torch.cuda.Stream(self.device)
            self._scan_stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._scan_stream):
                result = self._run_epoch_on_stream(epoch_name, data,
                                                   data_fold, quiet)
            torch.cuda.current_stream().wait_stream(self._scan_stream)
            return result
        return self._run_epoch_on_stream(epoch_name, data, data_fold, quiet)

    def _count_epoch(self, data_fold: DataFold, cache_on_device) -> None:
        """Count a TRAIN epoch and drop the fold's cache where it is due to
        be re-packed: the reference re-shuffles graphs into fresh packs
        every epoch (ppi_task.py:204); frozen packs only reshuffle batch
        order. repack_cached_every=K re-packs (and re-uploads) every K
        epochs as a middle ground; 0/None keeps packs frozen."""
        if data_fold != DataFold.TRAIN:
            return
        self._train_epochs_seen += 1
        repack_every = int(self.params.get("repack_cached_every") or 0)
        if (cache_on_device and repack_every > 0
                and self._train_epochs_seen > 1
                and (self._train_epochs_seen - 1) % repack_every == 0):
            self._invalidate_fold_cache(data_fold)

    def _run_epoch_on_stream(self, epoch_name, data, data_fold, quiet):
        """One epoch over `data_fold`, one rank a replica (the JAX
        package's _run_epoch and _run_epoch_dp): the batches gather into
        replica groups of the world size by batch_shape_key (a short final
        group padded with zero-weight clones of its last batch), and this
        process steps entry `rank` of each group, uploading only that one;
        a single process is the world of one, each batch a group as it
        arrives. A data-parallel train step makes one all_reduce
        (parallel/data_parallel.py). Every rank draws the same host random
        numbers (the fold's shuffle, the cached order, one _step_rng seed
        a step, with the rank folded into its dropout generator's seed).
        With the cache, this process's entries stay on the device, the
        group membership frozen and TRAIN reshuffling the order
        (repack_cached_every re-packs); with scan_epochs too, the epochs
        after a fold's first run _run_epoch_scanned over them. The ranks'
        parameters are made rank 0's before the first data-parallel epoch
        and after every load. Returns what _run_epoch returns, every
        rank's per-batch metrics in fold order, padding dropped."""
        cache_on_device = self.params.get("cache_batches_on_device", False)
        if cache_on_device and getattr(data, "is_streaming", False):
            # A disk-resident streamed fold exists because the data does
            # not fit in one memory: never pin it to the device.
            if not self._warned_stream_cache:
                self._warned_stream_cache = True
                self.log_line(
                    "WARNING: cache_batches_on_device is ignored for a "
                    "streamed data fold (streaming_train_data).")
            cache_on_device = False
        self._count_epoch(data_fold, cache_on_device)
        rank, replicas = dp.world()
        if replicas > 1 and not self._dp_synced:
            dp.broadcast_state(self)
            self._dp_synced = True
        cached = self._batch_cache.get(data_fold) if cache_on_device else None
        if cached is not None and self.params.get("scan_epochs"):
            return self._run_epoch_scanned(cached, data_fold)
        start_time = time.time()
        run: List[int] = []  # the replica group of each step, in step order
        device_metrics: List[Dict[str, Any]] = []

        def step(i, batch):
            run.append(i)
            self.batches_run[data_fold] += 1
            device_metrics.append(self._train_step(batch)
                                  if data_fold == DataFold.TRAIN
                                  else self._eval_step(batch))

        if cached is not None:
            order = np.arange(len(cached))
            if data_fold == DataFold.TRAIN:
                np.random.shuffle(order)
            for i in order:
                step(i, cached[i])
        else:
            counts: List[List[int]] = []
            totals = [0, 0, 0]
            to_cache: List[TaskBatch] = []

            def run_group(group):
                counts.append([int(b.num_graphs) for b in group])
                while len(group) < replicas:
                    group.append(dp.empty_like_batch(group[-1]))
                mine = batch_to_device(group[rank], self.device)
                if cache_on_device:
                    to_cache.append(mine)
                step(len(counts) - 1, mine)

            # A worker thread packs the next batches (host numpy work)
            # while the card runs the current step. Batches gather into
            # replica groups of the world size by batch_shape_key; a
            # single process runs each batch as it arrives.
            pending: Dict[Any, List[TaskBatch]] = {}
            with ThreadedIterator(self.task.make_minibatch_iterator(
                    data, data_fold, self.params["max_nodes_in_batch"]),
                    max_queue_size=5) as batch_iterator:
                for batch_i, batch in enumerate(batch_iterator):
                    for j, n in enumerate((batch.num_graphs, batch.num_nodes,
                                           batch.num_edges)):
                        totals[j] += int(n)
                    key = batch_shape_key(batch) if replicas > 1 else None
                    group = pending.setdefault(key, [])
                    group.append(batch)
                    if len(group) == replicas:
                        run_group(group)
                        pending[key] = []
                    if not quiet and batch_i % 16 == 0:
                        print("Running %s, batch %i (has %i graphs)."
                              % (epoch_name, batch_i, batch.num_graphs),
                              end="\r")
                for group in pending.values():
                    if group:
                        run_group(group)
            self._fold_counts[data_fold] = (counts, tuple(totals))
            if cache_on_device:
                # The JAX package unifies the fold's window tokens first
                # (unify_win_tokens), only so that its cached batches
                # share one pytree shape for jit. PyTorch does not
                # recompile per shape, so each batch keeps its own
                # windows, and a cached step computes what the uncached
                # step on the same batch does.
                self._batch_cache[data_fold] = (
                    self._attach_cached_dense_adj_fold(to_cache, data_fold))
                if self.params.get("scan_epochs"):
                    # Allocated outside every graph's pool, so no graph's
                    # metrics live in memory another graph reuses.
                    self._scan_outs[data_fold] = [
                        {k: v.detach().clone(
                            memory_format=torch.contiguous_format)
                         for k, v in m.items()} for m in device_metrics]
        return self._epoch_result(data_fold, run, device_metrics, start_time)

    def _epoch_result(self, data_fold, run, device_metrics, start_time):
        """_run_epoch's result of an epoch whose steps took the replica
        groups `run` (batch indices, for a single process) and gave this
        process `device_metrics`. The fold's counts are those of its last
        packing. Data-parallel: every rank's metrics gathered in one
        collective (parallel/data_parallel.py gather_epoch), in step order
        and rank order within a step, the padding replicas dropped; the
        rates over the slowest rank's seconds, so that every rank logs
        the same line. One host sync, at the epoch's end: the device runs
        ahead of the host until the metrics are fetched."""
        counts, (graphs, nodes, edges) = self._fold_counts[data_fold]
        assert graphs > 0, "Can't run epoch over empty dataset."
        per_rank, seconds = dp.gather_epoch(device_metrics, start_time)
        task_metric_results, batch_graph_counts = [], []
        for s, i in enumerate(run):
            for r, n in enumerate(counts[i]):
                task_metric_results.append(per_rank[r][s])
                batch_graph_counts.append(n)
        epoch_loss = float(sum(
            float(m["loss"]) * n
            for m, n in zip(task_metric_results, batch_graph_counts)))
        return (epoch_loss / graphs, task_metric_results, graphs,
                graphs / seconds, nodes / seconds, edges / seconds)

    def _seed_gp_dropout(self, seed: int) -> None:
        """graph_parallel: seed the replicated models' generator alike on
        every rank (the JAX step's shared rng_in / rng_out) and the
        propagation's with the rank folded in (fold_in(rng, axis_index))."""
        self._dropout_gen.manual_seed(seed)
        self._gp_prop_gen.manual_seed(seed + (dp.world()[0] + 1) * 2**31)

    def _gp_pack(self, data, data_fold: DataFold):
        """(batch on the device, this rank's shard on the device, host
        batch) for each batch of the fold, packed and partitioned here (on
        the prefetch thread): each rank partitions every batch the same
        way and keeps its own piece; with graph_parallel_halo a
        GPHaloShard, its halo_pad measured on the batch, as in the JAX
        package."""
        from ..parallel import graph_parallel as gp

        rank, size = dp.world()
        partition = (gp.partition_task_batch_halo
                     if self.params.get("graph_parallel_halo")
                     else gp.partition_task_batch)
        for batch in self.task.make_minibatch_iterator(
                data, data_fold, self.params["max_nodes_in_batch"]):
            (shard,) = partition(batch, size, batch.graph.n_pad,
                                 gp.batch_edge_budget(batch),
                                 parts=[rank])[0]
            yield (batch_to_device(batch, self.device),
                   gp.shard_to_device(shard, self.device), batch)

    @staticmethod
    def _gp_batch_key(batch: TaskBatch, shard) -> Tuple[int, ...]:
        """What every rank's step must agree on: (n_pad, the edge budget,
        num_graphs, num_nodes, num_edges, halo_pad (0 without the halo
        exchange))."""
        from ..parallel import graph_parallel as gp

        send_idx = getattr(shard, "send_idx", None)
        return (int(batch.graph.n_pad), gp.shard_edge_slots(shard),
                int(batch.num_graphs), int(batch.num_nodes),
                int(batch.num_edges),
                0 if send_idx is None else int(send_idx.shape[1]))

    def _gp_agree(self, keys: List[Tuple[int, ...]], what: str) -> None:
        """Raise unless every rank holds the same `keys` (its batches'
        _gp_batch_key): a rank that steps another batch does not fail, it
        hangs in a collective or gathers mismatched shapes."""
        every = [None] * dp.world()[1]
        torch.distributed.all_gather_object(every, keys)
        for r, theirs in enumerate(every):
            if theirs != keys:
                raise RuntimeError(
                    "graph_parallel ranks out of step at %s: rank %d has "
                    "(n_pad, edge budget, graphs, nodes, edges, halo_pad) "
                    "%s, this rank %s"
                    % (what, r, theirs[:4], keys[:4]))

    def _run_epoch_graph_parallel(self, epoch_name, data, data_fold, quiet):
        """A graph-parallel epoch (the JAX package's
        _run_epoch_graph_parallel): every rank packs every batch, and
        partitions it across the ranks (parallel/graph_parallel.py), and
        steps its own partition with the whole padded batch for the
        replicated task models. With the cache, the (batch, shard) entries
        stay on the device, TRAIN reshuffles their order and
        repack_cached_every re-packs; scan_epochs does not apply (eager
        steps, as in the JAX package). Every rank draws the same host
        random numbers (the fold's shuffle, the cached order, one _step_rng
        seed a step), and the ranks' batch keys are compared at the first
        step and over the whole epoch at its end. Returns what _run_epoch
        returns; every rank computes the same replicated metrics."""
        from ..parallel import graph_parallel as gp

        cache_on = bool(self.params.get("cache_batches_on_device")) and (
            not getattr(data, "is_streaming", False))
        self._count_epoch(data_fold, cache_on)
        if not self._dp_synced:
            dp.broadcast_state(self)
            self._dp_synced = True
        if self._gp_steps is None:
            self._gp_steps = gp.make_gp_task_steps(self)
        train = data_fold == DataFold.TRAIN
        start_time = time.time()
        device_metrics: List[Dict[str, Any]] = []
        keys: List[Tuple[int, ...]] = []

        def step(i, dev_batch, shard):
            keys.append(self._gp_batch_key(dev_batch, shard))
            if i == 0:
                self._gp_agree(keys, "%s's first step" % epoch_name)
            self.batches_run[data_fold] += 1
            if train:
                self._seed_gp_dropout(int(self._step_rng.randint(0,
                                                                 2**31 - 1)))
                device_metrics.append(self._gp_steps.train(dev_batch, shard))
            else:
                device_metrics.append(self._gp_steps.eval(dev_batch, shard))
            if not quiet and i % 16 == 0:
                print("Running %s, batch %i (has %i graphs)."
                      % (epoch_name, i, dev_batch.num_graphs), end="\r")

        cached = self._gp_batch_cache.get(data_fold) if cache_on else None
        if cached is not None:
            entries, totals = cached
            order = np.arange(len(entries))
            if train:
                np.random.shuffle(order)
            for i, e in enumerate(order):
                step(i, *entries[e][:2])
            counts = [entries[e][2] for e in order]
        else:
            entries, counts, totals = [], [], [0, 0, 0]
            with ThreadedIterator(self._gp_pack(data, data_fold),
                                  max_queue_size=5) as packed:
                for i, (dev_batch, shard, batch) in enumerate(packed):
                    for j, n in enumerate((batch.num_graphs, batch.num_nodes,
                                           batch.num_edges)):
                        totals[j] += int(n)
                    counts.append(int(batch.num_graphs))
                    if cache_on:
                        entries.append((dev_batch, shard, counts[-1]))
                    step(i, dev_batch, shard)
            if cache_on:
                self._gp_batch_cache[data_fold] = (entries, tuple(totals))
        graphs, nodes, edges = totals
        assert graphs > 0, "Can't run epoch over empty dataset."
        self._gp_agree(keys, "the end of %s" % epoch_name)
        per_rank, seconds = dp.gather_epoch(device_metrics, start_time)
        task_metric_results = per_rank[0]
        epoch_loss = float(sum(float(m["loss"]) * n
                               for m, n in zip(task_metric_results, counts)))
        return (epoch_loss / graphs, task_metric_results, graphs,
                graphs / seconds, nodes / seconds, edges / seconds)

    def _run_epoch_scanned(
        self, cached: List[TaskBatch], data_fold: DataFold
    ) -> Tuple[float, List[Dict[str, Any]], int, float, float, float]:
        """An epoch over a fold's cached batches grouped by shape (the JAX
        package's _run_epoch_scanned, which scans each group in one
        dispatch): TRAIN draws the group order, then for each group the
        order of its batches and ONE dropout seed from _step_rng (the JAX
        package's per-group key), from which the group's steps draw their
        masks in turn; VALIDATION runs the groups and batches in order.
        On the card every step is a replayed CUDA graph (_scanned_step);
        the epoch syncs once, at its end. Returns what _run_epoch
        returns, the metrics in the order the steps ran. Data-parallel:
        `cached` holds this rank's entry of each replica group, every rank
        runs them in the same drawn order (the JAX package's
        _run_epoch_dp_scanned). The epoch ends as an eager one does
        (_epoch_result)."""
        start_time = time.time()
        groups = self._scan_groups.get(data_fold)
        if groups is None:
            groups = self._scan_groups[data_fold] = shape_groups(cached)
        run: List[int] = []
        device_metrics: List[Dict[str, Any]] = []
        if data_fold == DataFold.TRAIN:
            for gi in np.random.permutation(len(groups)):
                idxs = groups[gi]
                within = np.random.permutation(len(idxs))
                self._seed_dropout(int(self._step_rng.randint(0, 2**31 - 1)))
                for j in within:
                    run.append(idxs[j])
                    device_metrics.append(self._scanned_step(
                        data_fold, idxs[j], cached[idxs[j]]))
        else:
            for idxs in groups:
                for i in idxs:
                    run.append(i)
                    device_metrics.append(
                        self._scanned_step(data_fold, i, cached[i]))
        return self._epoch_result(data_fold, run, device_metrics, start_time)

    def _scanned_step(self, data_fold: DataFold, i: int, batch: TaskBatch):
        """Cached batch `i` of `data_fold`'s step in a scanned epoch: a
        train step for TRAIN (its masks drawn from _dropout_gen as it
        stands), else an eval step. On the CPU it runs eagerly. On the card
        it replays the batch's CUDA graph, captured at its first use; a
        capture or replay error raises. Returns the step's metrics (on the
        card, the graph's static tensors, which its next replay
        overwrites). A data-parallel train step replays the rank's two
        graphs around the eager all_reduce of the reduction buffer."""
        train = data_fold == DataFold.TRAIN
        self.batches_run[data_fold] += 1
        if self.device.type != "cuda":
            if not train:
                return self._eval_step(batch)
            if self._replicas > 1:
                return dp.dp_train_step(self, batch)
            return self._train_step_body(batch)
        graphs = self._graphs.setdefault(data_fold, {})
        replay = graphs.get(i)
        if replay is None:
            replay = graphs[i] = self._capture(
                train, batch, self._scan_outs[data_fold][i])
        replay.graph.replay()
        if replay.update is not None:
            torch.distributed.all_reduce(self._dp_buffer)
            replay.update.replay()
        for counts, delta in ((rs.LAUNCHES, replay.launches),
                              (rs.FORM_LAUNCHES, replay.form_launches)):
            for k, n in delta.items():
                counts[k] += n
        if train:
            # The graph advanced the optimizer's step_t; the host count
            # follows.
            self.opt_state = self.opt_state._replace(
                step=self.opt_state.step + 1)
        return replay.outs

    def _capture(self, train: bool, batch: TaskBatch,
                 outs: Dict[str, torch.Tensor]) -> _Replay:
        """Capture one train step (train) or eval step on `batch` into a
        CUDA graph that writes its metrics into `outs`, on the scan stream
        and into the pool every captured step shares. Capturing runs
        nothing: the parameters, the slots, the step counts and the launch
        counters are left as they were, and the launches the capture
        counted are returned for its replays to add. A train step's graph
        registers _dropout_gen, so that each replay draws fresh masks from
        the generator's state at that replay. A data-parallel train step is
        captured as its two halves (parallel/data_parallel.py local_grads
        into the model's reduction buffer, allocated outside the pool, and
        apply_reduced from it): gloo's collectives cannot be captured, so
        the all_reduce between them runs eagerly at each replay."""
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        if self._scan_stream is None:
            self._scan_stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        if train:
            graph.register_generator_state(self._dropout_gen)
        split = train and self._replicas > 1
        if split and self._dp_buffer is None:
            self._dp_buffer = torch.empty(
                sum(p.numel() for p in self._leaves()) + 1,
                device=self.device)
        update = torch.cuda.CUDAGraph() if split else None
        counts = (dict(rs.LAUNCHES), dict(rs.FORM_LAUNCHES))
        step = self.opt_state.step
        try:
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  stream=self._scan_stream):
                if split:
                    metrics = dp.local_grads(self, batch, self._dropout_gen,
                                             out=self._dp_buffer)[1]
                elif train:
                    metrics = self._train_step_body(batch)
                else:
                    metrics = self._eval_step(batch)
                for k, v in metrics.items():
                    outs[k].copy_(v)
                del metrics
            if split:
                with torch.cuda.graph(update, pool=self._graph_pool,
                                      stream=self._scan_stream):
                    dp.apply_reduced(self, self._dp_buffer)
        finally:
            self.opt_state = self.opt_state._replace(step=step)
            deltas = []
            for live, before in zip((rs.LAUNCHES, rs.FORM_LAUNCHES), counts):
                deltas.append({k: n - before.get(k, 0)
                               for k, n in live.items()
                               if n != before.get(k, 0)})
                live.clear()
                live.update(before)
        return _Replay(graph, outs, *deltas, update=update)

    def train(self, quiet: bool = False, tf_summary_path: Optional[str] = None,
              resume_from: Optional[str] = None):
        """Patience-based early-stopped training; log format kept verbatim
        (the bench scripts regex these lines).

        tf_summary_path: a directory that receives the per-epoch scalars as
        `metrics.jsonl` and as TensorBoard event files, one directory per
        fold. resume_from: a full-state checkpoint (save_training_state);
        training continues from the saved epoch with the optimizer's slots
        and the early-stopping state intact. `checkpoint_every_n_epochs`
        (model param, default off) writes such checkpoints to
        `training_state_file`."""
        total_time_start = time.time()
        metrics_writer = None
        if tf_summary_path is not None and not dp.world()[0]:
            metrics_writer = _Fanout([
                MetricsWriter(tf_summary_path),
                FoldedTensorBoardWriter(tf_summary_path, self.run_id),
            ])

        best_valid_metric, best_val_metric_epoch, best_val_metric_descr = (
            float("+inf"), 0, "",
        )
        collapse_streak, collapse_warned = 0, False
        total_num_graphs = 0  # metrics x-axis (reference sparse_graph_model.py:143-151)
        start_epoch = 1
        if resume_from is not None:
            resumed = self.restore_training_state(resume_from)
            start_epoch = resumed["epoch"] + 1
            es = resumed["early_stop_state"]
            best_valid_metric = es["best_valid_metric"]
            best_val_metric_epoch = es["best_val_metric_epoch"]
            best_val_metric_descr = es["best_val_metric_descr"]
            self.log_line("Resuming from %s at epoch %i."
                          % (resume_from, start_epoch))
        ckpt_every = self.params.get("checkpoint_every_n_epochs") or 0
        for epoch in range(start_epoch, self.params["max_epochs"] + 1):
            self.log_line("== Epoch %i" % epoch)
            (train_loss, train_task_metrics, train_num_graphs,
             train_graphs_p_s, train_nodes_p_s, train_edges_p_s) = self._run_epoch(
                "epoch %i (training)" % epoch,
                self.task._loaded_data[DataFold.TRAIN],
                DataFold.TRAIN,
                quiet=quiet,
            )
            if not quiet:
                print("\r\x1b[K", end="")
            self.log_line(
                " Train: loss: %.5f || %s || graphs/sec: %.2f | nodes/sec: %.0f | edges/sec: %.0f"
                % (
                    train_loss,
                    self.task.pretty_print_epoch_task_metrics(
                        train_task_metrics, train_num_graphs
                    ),
                    train_graphs_p_s, train_nodes_p_s, train_edges_p_s,
                )
            )
            total_num_graphs += train_num_graphs
            if metrics_writer is not None:
                metrics_writer.write(
                    "train", total_num_graphs,
                    {"loss": train_loss, "epoch": epoch,
                     "graphs_per_sec": train_graphs_p_s},
                )

            (valid_loss, valid_task_metrics, valid_num_graphs,
             valid_graphs_p_s, valid_nodes_p_s, valid_edges_p_s) = self._run_epoch(
                "epoch %i (validation)" % epoch,
                self.task._loaded_data[DataFold.VALIDATION],
                DataFold.VALIDATION,
                quiet=quiet,
            )
            if not quiet:
                print("\r\x1b[K", end="")
            early_stopping_metric = self.task.early_stopping_metric(
                valid_task_metrics, valid_num_graphs
            )
            valid_metric_descr = self.task.pretty_print_epoch_task_metrics(
                valid_task_metrics, valid_num_graphs
            )
            self.log_line(
                " Valid: loss: %.5f || %s || graphs/sec: %.2f | nodes/sec: %.0f | edges/sec: %.0f"
                % (valid_loss, valid_metric_descr,
                   valid_graphs_p_s, valid_nodes_p_s, valid_edges_p_s)
            )
            if metrics_writer is not None:
                metrics_writer.write(
                    "valid", total_num_graphs,
                    {"loss": valid_loss, "epoch": epoch,
                     "early_stopping_metric": early_stopping_metric},
                )

            # Degenerate-basin guard: warn loudly when the task reports the
            # validation fold stuck in a known collapsed basin.
            collapse_msg = self.task.collapse_diagnostic(
                valid_loss, valid_task_metrics, valid_num_graphs
            )
            if collapse_msg is None:
                collapse_streak = 0
            else:
                collapse_streak += 1
                if collapse_streak == COLLAPSE_WARN_EPOCHS and not collapse_warned:
                    collapse_warned = True
                    self.log_line(
                        "WARNING: collapsed-optimization basin suspected — %s "
                        "for %i consecutive epochs. The model is likely stuck "
                        "predicting a constant. If training on a small fold with "
                        "hypers tuned for a larger one, reduce the step size "
                        "(small-fold recipe: Adam, learning_rate 1e-4, "
                        "max_nodes_in_batch 10000 — see docs/PARITY.md)."
                        % (collapse_msg, COLLAPSE_WARN_EPOCHS)
                    )

            if early_stopping_metric < best_valid_metric:
                self.save_model(self.best_model_file)
                self.log_line(
                    "  (Best epoch so far, target metric decreased to %.5f from %.5f. Saving to '%s')"
                    % (early_stopping_metric, best_valid_metric, self.best_model_file)
                )
                best_valid_metric = early_stopping_metric
                best_val_metric_epoch = epoch
                best_val_metric_descr = valid_metric_descr
            elif epoch - best_val_metric_epoch >= self.params["patience"]:
                total_time = time.time() - total_time_start
                self.log_line(
                    "Stopping training after %i epochs without improvement on validation loss."
                    % self.params["patience"]
                )
                self.log_line(
                    "Training took %is. Best validation results: %s"
                    % (total_time, best_val_metric_descr)
                )
                break

            if ckpt_every and epoch % ckpt_every == 0:
                self.save_training_state(
                    self.training_state_file, epoch,
                    {"best_valid_metric": best_valid_metric,
                     "best_val_metric_epoch": best_val_metric_epoch,
                     "best_val_metric_descr": best_val_metric_descr},
                )

    def test(self, path: Optional[str], quiet: bool = False):
        self.log_line("== Running Test on %s ==" % (path,))
        data = self.task._loaded_data.get(DataFold.TEST)
        if data is None:
            data = self.task.load_eval_data_from_path(path)
        test_loss, test_task_metrics, test_num_graphs, _, _, _ = self._run_epoch(
            "Test", data, DataFold.TEST, quiet=quiet
        )
        if not quiet:
            print("\r\x1b[K", end="")
        self.log_line("Loss %.5f on %i graphs" % (test_loss, test_num_graphs))
        self.log_line(
            "Metrics: %s"
            % self.task.pretty_print_epoch_task_metrics(
                test_task_metrics, test_num_graphs
            )
        )


class GNN_FiLM_Model(SparseGraphModel):
    layer_name = "gnn_film"

    @classmethod
    def default_params(cls):
        params = super().default_params()
        params.update({
            "hidden_size": 128,
            "graph_activation_function": "ReLU",
            "message_aggregation_function": "sum",
            "normalize_messages_by_num_incoming": False,
        })
        return params

    @staticmethod
    def name(params):
        return "GNN-FiLM"

    def layer_kwargs(self):
        return {
            "aggregation_strategy": self.params.get("aggregation_strategy", "auto"),
            "activation_function": self.params["graph_activation_function"],
            "message_aggregation_function": self.params["message_aggregation_function"],
            "normalize_by_num_incoming": self.params[
                "normalize_messages_by_num_incoming"
            ],
        }


class GNN_Edge_MLP_Model(SparseGraphModel):
    layer_name = "gnn_edge_mlp"

    @classmethod
    def default_params(cls):
        params = super().default_params()
        params.update({
            "max_nodes_in_batch": 25000,
            "hidden_size": 128,
            "graph_activation_function": "gelu",
            "message_aggregation_function": "sum",
            "graph_inter_layer_norm": True,
            "use_target_state_as_input": True,
            "num_edge_hidden_layers": 1,
        })
        return params

    @staticmethod
    def name(params):
        # Parameterised name, as the reference's.
        return "GNN-Edge-MLP%i" % (params["num_edge_hidden_layers"])

    def layer_kwargs(self):
        return {
            "activation_function": self.params["graph_activation_function"],
            "message_aggregation_function": self.params["message_aggregation_function"],
            "use_target_state_as_input": self.params["use_target_state_as_input"],
            "num_edge_hidden_layers": self.params["num_edge_hidden_layers"],
            "typed_edge_scan": self.params.get("typed_edge_scan", "auto"),
        }


class GGNN_Model(SparseGraphModel):
    layer_name = "ggnn"

    @classmethod
    def default_params(cls):
        params = super().default_params()
        params.update({
            "hidden_size": 128,
            "graph_rnn_cell": "GRU",
            "graph_activation_function": "tanh",
            "message_aggregation_function": "sum",
            "graph_layer_input_dropout_keep_prob": 1.0,
            "graph_dense_between_every_num_gnn_layers": 10000,
            "graph_residual_connection_every_num_layers": 10000,
        })
        return params

    @staticmethod
    def name(params):
        return "GGNN"

    def layer_kwargs(self):
        return {
            "gated_unit_type": self.params["graph_rnn_cell"].lower(),
            "activation_function": self.params["graph_activation_function"],
            "message_aggregation_function": self.params["message_aggregation_function"],
            "aggregation_strategy": self.params.get("aggregation_strategy", "auto"),
        }


class RGCN_Model(SparseGraphModel):
    layer_name = "rgcn"

    @classmethod
    def default_params(cls):
        params = super().default_params()
        params.update({
            "hidden_size": 128,
            "graph_activation_function": "ReLU",
            "message_aggregation_function": "sum",
            "graph_layer_input_dropout_keep_prob": 1.0,
            "graph_dense_between_every_num_gnn_layers": 10000,
            "graph_residual_connection_every_num_layers": 10000,
        })
        return params

    @staticmethod
    def name(params):
        return "RGCN"

    def layer_kwargs(self):
        return {
            "activation_function": self.params["graph_activation_function"],
            "message_aggregation_function": self.params["message_aggregation_function"],
            "aggregation_strategy": self.params.get("aggregation_strategy", "auto"),
        }


class RGAT_Model(SparseGraphModel):
    layer_name = "rgat"

    @classmethod
    def default_params(cls):
        params = super().default_params()
        params.update({
            "hidden_size": 128,
            "num_heads": 4,
            "graph_activation_function": "tanh",
            "graph_layer_input_dropout_keep_prob": 1.0,
            "graph_dense_between_every_num_gnn_layers": 10000,
            "graph_residual_connection_every_num_layers": 10000,
        })
        return params

    @staticmethod
    def name(params):
        return "RGAT"

    def layer_kwargs(self):
        return {
            "num_heads": self.params["num_heads"],
            "activation_function": self.params["graph_activation_function"],
            "aggregation_strategy": self.params.get("aggregation_strategy", "auto"),
        }


class RGIN_Model(SparseGraphModel):
    layer_name = "rgin"

    @classmethod
    def default_params(cls):
        params = super().default_params()
        params.update({
            "hidden_size": 128,
            "graph_activation_function": "ReLU",
            "message_aggregation_function": "sum",
            "graph_dense_between_every_num_gnn_layers": 10000,
            "graph_inter_layer_norm": True,
            "use_target_state_as_input": False,
            "graph_num_edge_MLP_hidden_layers": 1,
            "graph_num_aggr_MLP_hidden_layers": None,
        })
        return params

    @staticmethod
    def name(params):
        return "RGIN"

    def layer_kwargs(self):
        return {
            "activation_function": self.params["graph_activation_function"],
            "message_aggregation_function": self.params["message_aggregation_function"],
            "use_target_state_as_input": self.params["use_target_state_as_input"],
            "num_edge_MLP_hidden_layers": self.params["graph_num_edge_MLP_hidden_layers"],
            "typed_edge_scan": self.params.get("typed_edge_scan", "auto"),
            "num_aggr_MLP_hidden_layers": self.params["graph_num_aggr_MLP_hidden_layers"],
        }


class RGDCN_Model(SparseGraphModel):
    layer_name = "rgdcn"

    @classmethod
    def default_params(cls):
        params = super().default_params()
        params.update({
            "max_nodes_in_batch": 25000,
            "hidden_size": 128,
            "num_channels": 8,
            "use_full_state_for_channel_weights": False,
            "tie_channel_weights": False,
            "graph_activation_function": "ReLU",
            "message_aggregation_function": "sum",
            "graph_inter_layer_norm": True,
        })
        return params

    @staticmethod
    def name(params):
        return "RGDCN"

    def __init__(self, params, task, run_id, result_dir, device=None):
        params["channel_dim"] = params["hidden_size"] // params["num_channels"]
        super().__init__(params, task, run_id, result_dir, device=device)

    def layer_kwargs(self):
        return {
            "num_channels": self.params["num_channels"],
            "channel_dim": self.params["channel_dim"],
            "use_full_state_for_channel_weights": self.params[
                "use_full_state_for_channel_weights"],
            "tie_channel_weights": self.params["tie_channel_weights"],
            "typed_edge_scan": self.params.get("typed_edge_scan", "auto"),
            "aggregation_strategy": self.params.get("aggregation_strategy",
                                                    "auto"),
            "activation_function": self.params["graph_activation_function"],
            "message_aggregation_function": self.params[
                "message_aggregation_function"],
        }
