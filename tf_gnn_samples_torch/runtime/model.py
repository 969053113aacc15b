"""Training runtime (counterpart of the core of
tf_gnn_samples_tpu/runtime/model.py): model assembly (task input model ->
shared propagation stack -> task output model), per-tensor gradient
clipping and TF1 optimizers, a per-batch epoch driver with throughput
telemetry and an optional device-resident batch cache, patience-based
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

import contextlib
import os
import pickle
import random
import time
from abc import ABC
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..nn.layers import use_dense_strategy
from ..nn.propagation import propagation_apply, propagation_init
from ..ops.edge_ops import dense_adjacency
from ..ops.graph import graph_to_device
from ..tasks.base import DataFold, SparseGraphTask, TaskBatch
from ..utils.iterators import ThreadedIterator
from ..utils.metrics_writer import MetricsWriter
from ..utils.tb_writer import FoldedTensorBoardWriter
from .optimizers import OptimizerState, clip_grads_per_tensor, make_optimizer

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
               for slot, ts in fresh.slots.items()})


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
        for key in ("num_model_replicas", "graph_parallel"):
            if int(params.get(key) or 1) > 1:
                raise NotImplementedError(
                    "%s > 1 is not yet ported to the PyTorch package." % key)
        if params.get("scan_epochs"):
            raise NotImplementedError(
                "scan_epochs (stacked one-dispatch epochs, ROADMAP Queue 1 "
                "item 7) is not yet ported to the PyTorch package.")
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

    def _effective_lr(self, num_graphs: int) -> float:
        lr = self.params["learning_rate"]
        per_batch = self.params.get("lr_for_num_graphs_per_batch")
        if per_batch is not None:
            lr = lr * float(num_graphs) / float(per_batch)
        return lr

    def _train_step(self, batch: TaskBatch):
        self._dropout_gen.manual_seed(
            int(self._step_rng.randint(0, 2**31 - 1)))
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

    # -------------------- full training-state checkpoint ----------------
    # The reference's best-model pickle carries weights only. These
    # checkpoints also carry the optimizer's slots and step, the epoch, the
    # early-stopping state and the host RNGs, so that training continues
    # exactly where it stopped. Keys and names are the JAX package's.

    def save_training_state(self, path: str, epoch: int,
                            early_stop_state: Dict[str, Any]) -> None:
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
        return {"epoch": state["epoch"],
                "early_stop_state": state["early_stop_state"]}

    # -------------------- epoch driver --------------------

    def log_line(self, msg: str) -> None:
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

    def _run_epoch(
        self,
        epoch_name: str,
        data: Iterable[Any],
        data_fold: DataFold,
        quiet: bool = False,
    ) -> Tuple[float, List[Dict[str, Any]], int, float, float, float]:
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
        if data_fold == DataFold.TRAIN:
            # Periodic re-packing of the device-resident TRAIN cache: the
            # reference re-shuffles graphs into fresh packs every epoch
            # (ppi_task.py:204); frozen packs only reshuffle batch order.
            # repack_cached_every=K re-packs (and re-uploads) every K
            # epochs as a middle ground; 0/None keeps packs frozen.
            self._train_epochs_seen += 1
            repack_every = int(self.params.get("repack_cached_every") or 0)
            if (cache_on_device and repack_every > 0
                    and self._train_epochs_seen > 1
                    and (self._train_epochs_seen - 1) % repack_every == 0):
                self._invalidate_fold_cache(data_fold)
        cached = self._batch_cache.get(data_fold) if cache_on_device else None
        if cached is not None:
            order = np.arange(len(cached))
            if data_fold == DataFold.TRAIN:
                np.random.shuffle(order)
            batches = contextlib.nullcontext(cached[i] for i in order)
        else:
            # A worker thread packs the next batches (host numpy work)
            # while the card runs the current step.
            batches = ThreadedIterator(
                self.task.make_minibatch_iterator(
                    data, data_fold, self.params["max_nodes_in_batch"]),
                max_queue_size=5)
        start_time = time.time()
        processed_graphs = processed_nodes = processed_edges = 0
        device_metrics: List[Dict[str, Any]] = []
        batch_graph_counts: List[int] = []
        to_cache: List[TaskBatch] = []
        with batches as batch_iterator:
            for step_i, batch in enumerate(batch_iterator):
                processed_graphs += int(batch.num_graphs)
                processed_nodes += int(batch.num_nodes)
                processed_edges += int(batch.num_edges)
                if cached is not None:
                    dev_batch = batch
                else:
                    dev_batch = batch_to_device(batch, self.device)
                    if cache_on_device:
                        to_cache.append(dev_batch)
                if data_fold == DataFold.TRAIN:
                    metrics = self._train_step(dev_batch)
                else:
                    metrics = self._eval_step(dev_batch)
                self.batches_run[data_fold] += 1
                device_metrics.append(metrics)
                batch_graph_counts.append(batch.num_graphs)
                if not quiet and step_i % 16 == 0:
                    print(
                        "Running %s, batch %i (has %i graphs)."
                        % (epoch_name, step_i, batch.num_graphs),
                        end="\r",
                    )

        assert processed_graphs > 0, "Can't run epoch over empty dataset."
        if cache_on_device and cached is None:
            # The JAX package unifies the fold's window tokens first
            # (unify_win_tokens), only so that its cached batches share one
            # pytree shape for jit. PyTorch does not recompile per shape,
            # so each batch keeps its own windows, and a cached step
            # computes what the uncached step on the same batch does.
            self._batch_cache[data_fold] = self._attach_cached_dense_adj_fold(
                to_cache, data_fold)
        # One host sync at epoch end: the device runs ahead of the host
        # until the metrics are fetched.
        task_metric_results = [
            {k: np.asarray(v.cpu()) for k, v in m.items()}
            for m in device_metrics
        ]
        epoch_loss = float(sum(
            float(m["loss"]) * n
            for m, n in zip(task_metric_results, batch_graph_counts)
        ))
        epoch_time = time.time() - start_time
        return (
            epoch_loss / processed_graphs,
            task_metric_results,
            processed_graphs,
            processed_graphs / epoch_time,
            processed_nodes / epoch_time,
            processed_edges / epoch_time,
        )

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
        if tf_summary_path is not None:
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
