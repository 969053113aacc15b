"""Abstract task interface (counterpart of tf_gnn_samples_tpu/tasks/base.py).

A task owns data loading, the input featurization, the output head (loss
and metrics), minibatching, the early-stopping metric and metric
pretty-printing; the model owns the propagation stack and the training
loop. Batches are packed under `max_nodes_in_batch` and padded to a few
fold-constant `BatchSpec` shapes, exactly as in the JAX package (the host
code is the same numpy), so both packages build equal batches.
"""

import gzip
import json
from abc import ABC, abstractmethod
from enum import Enum
from typing import Any, Dict, Iterable, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.graph import GraphBatch, bucket_size, pad_graph_batch


class DataFold(Enum):
    TRAIN = 0
    VALIDATION = 1
    TEST = 2


class TaskBatch(NamedTuple):
    """One minibatch: padded mega-graph + task tensors + host-side stats.

    Replaces the reference's `MinibatchData` feed dict
    (tasks/sparse_graph_task.py:16-20)."""

    graph: GraphBatch
    aux: Dict[str, torch.Tensor]  # task-specific padded tensors
    num_graphs: int  # host ints for throughput stats
    num_nodes: int
    num_edges: int


class BatchSpec(NamedTuple):
    """Static padded batch shape: all batches of a run fit this spec."""

    n_pad: int
    e_pads: Tuple[int, ...]  # per edge type
    g_pad: int


def compute_batch_spec(
    graph_sizes: Sequence[Tuple[int, Sequence[int]]],
    max_nodes: int,
    num_edge_types: int,
    min_bucket: int = 64,
) -> BatchSpec:
    """Single-shape variant of compute_batch_specs: the maximal spec that
    every greedy pack fits (one padded shape per fold)."""
    return compute_batch_specs(
        graph_sizes, max_nodes, num_edge_types, min_bucket, num_buckets=1
    )[-1]


def compute_batch_specs(
    graph_sizes: Sequence[Tuple[int, Sequence[int]]],
    max_nodes: int,
    num_edge_types: int,
    min_bucket: int = 64,
    num_buckets: int = 3,
) -> List[BatchSpec]:
    """Derive hard budgets so that greedy packing under them always fits.

    Args:
        graph_sizes: per graph (num_nodes, per-type edge counts).
        max_nodes: the reference's `max_nodes_in_batch` packing budget
            (models/sparse_graph_model.py:25).
        num_buckets: number of batch-shape levels per fold. The LAST
            returned spec is the packing spec (maximal); smaller levels
            pad below-average packs less.

    The per-type edge budget is the max per-type edge count over packs of
    SIMULATED greedy packing runs (the identity order plus seeded
    shuffles), never below the largest single graph. Budgets are hard:
    pack_greedy closes a pack early if the next graph would exceed one,
    so a future shuffle that packs denser than every simulation stays
    correct (it just splits that pack) — this keeps padding tied to
    ACHIEVABLE packs instead of the worst per-graph density times the
    full node budget, which overpadded dense folds by ~15-30%.
    """
    # Edge pads are multiples of 2048 (the JAX package's kernel grid step,
    # kept so both packages pad alike; the CUDA kernels need no multiple);
    # 16 buckets/octave keeps the round-up waste ~3-6%.
    edge_min_bucket = max(min_bucket, 2048)
    min_nodes = None
    max_graph_nodes = 0
    max_graph_edges = np.zeros(num_edge_types, dtype=np.int64)
    for n, e_counts in graph_sizes:
        n = max(int(n), 1)
        min_nodes = n if min_nodes is None else min(min_nodes, n)
        max_graph_nodes = max(max_graph_nodes, n)
        for l, e in enumerate(e_counts):
            max_graph_edges[l] = max(max_graph_edges[l], e)
    if min_nodes is None:
        min_nodes = 1
    # 16 buckets/octave: with ONE spec per fold the bucket only controls
    # cross-fold shape reuse, and coarse rounding is quadratically
    # expensive for the dense-adjacency families (4/octave rounded a
    # 12500-node budget to 14336 — +31% on every A @ t matmul).
    n_pad = bucket_size(max(max_nodes, max_graph_nodes),
                        min_size=min_bucket, buckets_per_octave=16)

    nodes_arr = np.array([max(int(n), 1) for n, _ in graph_sizes],
                         dtype=np.int64)
    edges_arr = np.array(
        [np.asarray(e, dtype=np.int64) for _, e in graph_sizes]
    ).reshape(len(graph_sizes), num_edge_types)
    sim_nodes: List[int] = []  # per simulated pack: node sum
    sim_edges: List[np.ndarray] = []  # per simulated pack: per-type edges
    rng = np.random.RandomState(0)  # deterministic spec across processes
    num_sims = 16
    for sim in range(num_sims + 1):
        if sim == 0:
            order = np.arange(len(nodes_arr))
        else:
            order = rng.permutation(len(nodes_arr))
        cur_nodes = 0
        cur_edges = np.zeros(num_edge_types, dtype=np.int64)
        for i in order:
            n = nodes_arr[i]
            if cur_nodes and cur_nodes + n >= max_nodes:  # strict <, as
                # in pack_greedy (reference ppi_task.py:220)
                sim_nodes.append(cur_nodes)
                sim_edges.append(cur_edges)
                cur_nodes, cur_edges = 0, np.zeros_like(cur_edges)
            cur_nodes += n
            cur_edges = cur_edges + edges_arr[i]
        if cur_nodes:
            sim_nodes.append(cur_nodes)
            sim_edges.append(cur_edges)

    sim_max = max_graph_edges.copy()
    if sim_edges:
        sim_max = np.maximum(sim_max, np.max(np.stack(sim_edges), axis=0))
    e_pads = tuple(
        bucket_size(max(int(sim_max[l]), 1), min_size=edge_min_bucket,
                    buckets_per_octave=16)
        for l in range(num_edge_types)
    )
    g_pad = bucket_size(
        max(int(np.ceil(n_pad / min_nodes)), 1), min_size=16
    )
    spec_max = BatchSpec(n_pad=n_pad, e_pads=e_pads, g_pad=g_pad)
    if num_buckets <= 1 or not sim_nodes:
        return [spec_max]

    # Sub-specs at node-count quantiles of the simulated packs: batch
    # packing quantizes at whole-graph granularity (a 2.4k-node graph that
    # does not fit leaves the pack ~2.4k nodes short), so real packs land
    # well below max_nodes and a single max-shape spec overpads the
    # average batch by 25-30% in BOTH nodes and edges (measured on the
    # PPI bench fold). Each level's edge budgets cover every simulated
    # pack at or below its node level; assignment (select_spec) falls
    # through to the next level when a dense small pack exceeds them.
    nodes_np = np.asarray(sim_nodes, dtype=np.int64)
    edges_np = np.stack(sim_edges)  # [num_packs, L]
    specs: List[BatchSpec] = []
    seen = set()
    for k in range(1, num_buckets):
        q = k / num_buckets
        n_level = int(np.quantile(nodes_np, q))
        np_k = bucket_size(max(n_level, 1), min_size=min_bucket,
                           buckets_per_octave=16)
        if np_k >= spec_max.n_pad:
            continue
        covered = nodes_np <= np_k
        if not covered.any():
            continue
        req = np.max(edges_np[covered], axis=0)
        ep_k = tuple(
            bucket_size(max(int(np.maximum(req[l], max_graph_edges[l])), 1),
                        min_size=edge_min_bucket, buckets_per_octave=16)
            for l in range(num_edge_types)
        )
        gp_k = bucket_size(max(int(np.ceil(np_k / min_nodes)), 1),
                           min_size=16)
        key = (np_k, ep_k, gp_k)
        if key in seen:
            continue
        seen.add(key)
        specs.append(BatchSpec(n_pad=np_k, e_pads=ep_k, g_pad=gp_k))
    specs.sort(key=lambda s: (s.n_pad, sum(s.e_pads)))
    specs.append(spec_max)
    return specs


def select_spec(
    specs: Sequence[BatchSpec],
    num_nodes: int,
    e_counts: Sequence[int],
    num_graphs: int,
) -> BatchSpec:
    """Smallest spec (specs sorted ascending; last must be the packing
    spec, which always fits by construction) that fits a packed batch."""
    e_counts = np.asarray(e_counts, dtype=np.int64)
    for spec in specs[:-1]:
        if (num_nodes <= spec.n_pad and num_graphs <= spec.g_pad
                and bool(np.all(e_counts <= np.asarray(spec.e_pads)))):
            return spec
    return specs[-1]


def pack_greedy(
    graph_sizes: Sequence[Tuple[int, Sequence[int]]],
    order: Sequence[int],
    spec: BatchSpec,
    max_nodes: int,
) -> Iterator[List[int]]:
    """Greedy packing of graphs into batches under the spec's hard budgets.

    Matches the reference's packing semantics (keep adding while
    node_offset + next_nodes < max_nodes, strict `<`; tasks/ppi_task.py:220,
    tasks/qm9_task.py:223) with the additional static edge/graph budgets.
    A graph too large for max_nodes alone is yielded as its own batch
    (the reference would loop forever / crash on these; see SURVEY §"quirks").
    """
    cur: List[int] = []
    cur_nodes = 0
    cur_edges = np.zeros(len(spec.e_pads), dtype=np.int64)
    for idx in order:
        n, e_counts = graph_sizes[idx]
        e_counts = np.asarray(e_counts, dtype=np.int64)
        fits = (
            cur_nodes + n < max_nodes
            and len(cur) < spec.g_pad
            and bool(np.all(cur_edges + e_counts <= np.asarray(spec.e_pads)))
        )
        if cur and not fits:
            yield cur
            cur, cur_nodes, cur_edges = [], 0, np.zeros_like(cur_edges)
        cur.append(idx)
        cur_nodes += n
        cur_edges += e_counts
    if cur:
        yield cur


class SparseGraphTask(ABC):
    """Abstract task (capability-parity with reference Sparse_Graph_Task)."""

    @classmethod
    def default_params(cls) -> Dict[str, Any]:
        return {}

    @staticmethod
    @abstractmethod
    def name() -> str:
        ...

    @staticmethod
    @abstractmethod
    def default_data_path() -> str:
        ...

    def __init__(self, params: Dict[str, Any]):
        self.params = params
        self._loaded_data: Dict[DataFold, Any] = {}
        self._spec_cache: Dict[Any, Any] = {}

    def cached_spec(self, data, max_nodes: int, compute):
        """Memoize the fold-constant batch spec: dataset statistics do not
        change across epochs, so scanning the whole dataset to rebuild an
        identical BatchSpec every epoch is wasted host time on the
        critical path.

        Keyed by (id(data), len(data), max_nodes) with the keyed object
        itself kept alive in the cache entry: holding the reference makes
        the id() stable (a GC'd list's address could otherwise be reused
        by a different fold and serve a stale spec)."""
        key = (id(data), len(data) if hasattr(data, "__len__") else -1,
               max_nodes)
        entry = self._spec_cache.get(key)
        if entry is None or entry[0] is not data:
            entry = (data, compute())
            self._spec_cache[key] = entry
        return entry[1]

    # ---- metadata travels with the checkpoint (sparse_graph_task.py:46-59)
    def get_metadata(self) -> Dict[str, Any]:
        return {"params": self.params}

    def restore_from_metadata(self, metadata: Dict[str, Any]) -> None:
        self.params = metadata["params"]

    @property
    @abstractmethod
    def num_edge_types(self) -> int:
        ...

    @property
    @abstractmethod
    def initial_node_feature_size(self) -> int:
        ...

    @abstractmethod
    def load_data(self, path: Optional[str]) -> None:
        ...

    def load_eval_data_from_path(self, path: str) -> Iterable[Any]:
        raise NotImplementedError()

    # ---- input model -----------------------------------------------------
    # Default: initial node features are given directly in the batch
    # (reference default make_task_input_model, sparse_graph_task.py:107-149).
    # Tasks with learned featurization (VarMisuse char CNN) override these.

    def input_init(self, gen: torch.Generator) -> Any:
        return {}

    def input_apply(self, params, batch: TaskBatch, gen=None):
        """Returns initial node features [N_pad, feature_size]."""
        return batch.graph.node_features

    # ---- output model ----------------------------------------------------

    @abstractmethod
    def output_init(self, gen: torch.Generator, hidden_size: int) -> Any:
        ...

    @abstractmethod
    def output_apply(
        self, params, batch: TaskBatch, final_h, initial_feats, gen=None
    ) -> Tuple[Any, Dict[str, Any]]:
        """Returns (loss, metrics dict of 0-d tensors). gen=None => eval."""
        ...

    # ---- batching ----------------------------------------------------------

    @abstractmethod
    def make_minibatch_iterator(
        self, data: Iterable[Any], data_fold: DataFold, max_nodes_per_batch: int
    ) -> Iterator[TaskBatch]:
        ...

    # ---- epoch-level metrics ----------------------------------------------

    @abstractmethod
    def early_stopping_metric(
        self, task_metric_results: List[Dict[str, np.ndarray]], num_graphs: int
    ) -> float:
        ...

    @abstractmethod
    def pretty_print_epoch_task_metrics(
        self, task_metric_results: List[Dict[str, np.ndarray]], num_graphs: int
    ) -> str:
        ...

    def collapse_diagnostic(
        self, valid_loss: float,
        task_metric_results: List[Dict[str, np.ndarray]], num_graphs: int,
    ) -> Optional[str]:
        """Per-epoch degenerate-optimization check, evaluated on the
        validation fold by the training loop. Return a short description
        when this epoch's validation statistics sit in a known collapsed
        basin (e.g. a constant-prediction head), else None. The trainer
        warns loudly after several consecutive flagged epochs. Tasks with
        no known degenerate basin keep this default."""
        return None


def read_jsonl_gz(path: str) -> List[Any]:
    """Minimal replacement for dpu_utils RichPath.read_by_file_suffix on
    .jsonl.gz / .json.gz / .jsonl / .json files (reference: train.py:27)."""
    if path.endswith(".gz"):
        opener = lambda: gzip.open(path, "rt", encoding="utf-8")  # noqa: E731
    else:
        opener = lambda: open(path, "rt", encoding="utf-8")  # noqa: E731
    with opener() as f:
        if ".jsonl" in path:
            return [json.loads(line) for line in f if line.strip()]
        return json.load(f)


def graph_sample_to_padded(
    node_features: np.ndarray,
    adjacency_lists: Sequence[np.ndarray],
    node_graph_ids: np.ndarray,
    num_graphs: int,
    spec: BatchSpec,
    typed_incoming_counts: Optional[np.ndarray] = None,
) -> GraphBatch:
    """Pad a packed batch to the fold's static BatchSpec."""
    return pad_graph_batch(
        node_features,
        adjacency_lists,
        node_graph_ids,
        num_graphs,
        n_pad=spec.n_pad,
        e_pads=spec.e_pads,
        g_pad=spec.g_pad,
        typed_incoming_counts=typed_incoming_counts,
    )
