"""PPI protein-protein interaction task: inductive node-level multi-label
classification, 121 labels (counterpart of tf_gnn_samples_tpu/tasks/ppi.py).

Capability-parity with the reference's `PPI_Task` (tasks/ppi_task.py:19-264):
DGL-format data ({fold}_graph.json + {fold}_{feats,labels,graph_id}.npy),
edge types fwd=0 / optional self-loop / optional distinct backward, a
dense output head with summed sigmoid cross-entropy averaged per node, and
per-batch micro-F1 averaged per epoch (not pooled over the epoch).

Batches are packed under `max_nodes_in_batch` and padded to the fold's
BatchSpec levels as in the JAX package; padded nodes are masked out of
both the loss and the F1 counts.
"""

import json
import os
from typing import Any, Dict, Iterable, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from .. import SMALL_NUMBER
from ..nn.initializers import glorot_uniform, zeros
from .base import (
    DataFold,
    SparseGraphTask,
    TaskBatch,
    compute_batch_specs,
    graph_sample_to_padded,
    pack_greedy,
    select_spec,
)


class GraphSample(NamedTuple):
    adjacency_lists: List[np.ndarray]
    type_to_node_to_num_incoming_edges: np.ndarray
    node_features: np.ndarray
    node_labels: np.ndarray


def micro_f1_counts(logits, labels, mask):
    """Masked true/false positive/negative counts for micro-F1.

    The reference computes F1 from rounded sigmoids per batch
    (utils/utils.py:61-74); the counts make the batch-level F1 exact under
    padding (padded nodes contribute nothing). torch.round rounds half to
    even, as jnp.round does."""
    preds = torch.round(torch.sigmoid(logits))
    m = mask[:, None]
    tp = torch.sum(preds * labels * m)
    fp = torch.sum(preds * (1 - labels) * m)
    fn = torch.sum((1 - preds) * labels * m)
    return tp, fp, fn


class PPI_Task(SparseGraphTask):
    @classmethod
    def default_params(cls):
        params = super().default_params()
        params.update({
            "add_self_loop_edges": True,
            "tie_fwd_bkwd_edges": False,
            "out_layer_dropout_keep_prob": 1.0,
        })
        return params

    @staticmethod
    def name() -> str:
        return "PPI"

    @staticmethod
    def default_data_path() -> str:
        return "data/ppi"

    def __init__(self, params: Dict[str, Any]):
        super().__init__(params)
        self.__num_edge_types = 0
        self.__initial_node_feature_size = 0
        self.__num_labels = 0

    def get_metadata(self) -> Dict[str, Any]:
        metadata = super().get_metadata()
        metadata["num_edge_types"] = self.__num_edge_types
        metadata["initial_node_feature_size"] = self.__initial_node_feature_size
        metadata["num_labels"] = self.__num_labels
        return metadata

    def restore_from_metadata(self, metadata: Dict[str, Any]) -> None:
        super().restore_from_metadata(metadata)
        self.__num_edge_types = metadata["num_edge_types"]
        self.__initial_node_feature_size = metadata["initial_node_feature_size"]
        self.__num_labels = metadata["num_labels"]

    @property
    def num_edge_types(self) -> int:
        return self.__num_edge_types

    @property
    def initial_node_feature_size(self) -> int:
        return self.__initial_node_feature_size

    # -------------------- Data loading --------------------

    def load_data(self, path: Optional[str]) -> None:
        path = path or self.default_data_path()
        self._loaded_data[DataFold.TRAIN] = self.__load_data(path, DataFold.TRAIN)
        self._loaded_data[DataFold.VALIDATION] = self.__load_data(
            path, DataFold.VALIDATION)

    def load_eval_data_from_path(self, path: str) -> Iterable[Any]:
        return self.__load_data(path, DataFold.TEST)

    def __load_data(self, data_dir: str, data_fold: DataFold) -> List[GraphSample]:
        data_name = {DataFold.TRAIN: "train", DataFold.VALIDATION: "valid",
                     DataFold.TEST: "test"}[data_fold]
        print(" Loading PPI %s data from %s." % (data_name, data_dir))
        with open(os.path.join(data_dir, "%s_graph.json" % data_name)) as f:
            graph_json_data = json.load(f)
        node_to_features = np.load(os.path.join(data_dir, "%s_feats.npy" % data_name))
        node_to_labels = np.load(os.path.join(data_dir, "%s_labels.npy" % data_name))
        node_to_graph_id = np.load(os.path.join(data_dir, "%s_graph_id.npy" % data_name))
        self.__initial_node_feature_size = node_to_features.shape[-1]
        self.__num_labels = node_to_labels.shape[-1]

        # Edge typing exactly as the reference (ppi_task.py:99-106): fwd 0,
        # then the self loops, then the untied backward edges.
        fwd_edge_type = 0
        self.__num_edge_types = 1
        self_loop_edge_type = bkwd_edge_type = None
        if self.params["add_self_loop_edges"]:
            self_loop_edge_type = self.__num_edge_types
            self.__num_edge_types += 1
        if not self.params["tie_fwd_bkwd_edges"]:
            bkwd_edge_type = self.__num_edge_types
            self.__num_edge_types += 1
        L = self.__num_edge_types

        # Split the flat node arrays into per-graph samples (graph ids are
        # contiguous in this format; ppi_task.py:108-127): one searchsorted
        # for every node's graph, then one mask over the links a graph.
        _, first_node = np.unique(node_to_graph_id, return_index=True)
        boundaries = list(np.sort(first_node)) + [len(node_to_graph_id)]
        links = graph_json_data["links"]
        srcs = np.array([e["source"] for e in links], dtype=np.int64)
        tgts = np.array([e["target"] for e in links], dtype=np.int64)
        offsets = np.array(boundaries[:-1], dtype=np.int64)
        slot_of_node = np.searchsorted(
            offsets, np.arange(len(node_to_graph_id)), side="right") - 1
        edge_slots = slot_of_node[srcs]

        final_graphs = []
        for slot in range(len(offsets)):
            lo, hi = boundaries[slot], boundaries[slot + 1]
            n = hi - lo
            sel = edge_slots == slot
            s = srcs[sel] - lo
            t = tgts[sel] - lo
            adj = [None] * L
            counts = np.zeros((L, n), dtype=np.float32)
            adj[fwd_edge_type] = np.stack([s, t], axis=1).astype(np.int32)
            np.add.at(counts[fwd_edge_type], t, 1.0)
            if self_loop_edge_type is not None:
                loops = np.arange(n, dtype=np.int32)
                adj[self_loop_edge_type] = np.stack([loops, loops], axis=1)
                counts[self_loop_edge_type, :] = 1.0
            if bkwd_edge_type is not None:
                adj[bkwd_edge_type] = np.stack([t, s], axis=1).astype(np.int32)
                np.add.at(counts[bkwd_edge_type], s, 1.0)
            final_graphs.append(GraphSample(
                adjacency_lists=adj,
                type_to_node_to_num_incoming_edges=counts,
                node_features=node_to_features[lo:hi].astype(np.float32),
                node_labels=node_to_labels[lo:hi].astype(np.float32),
            ))
        return final_graphs

    # -------------------- Output head --------------------

    def output_init(self, gen: torch.Generator, hidden_size: int):
        return {
            "kernel": glorot_uniform(gen, (hidden_size, self.__num_labels)),
            "bias": zeros((self.__num_labels,)),
        }

    def output_apply(self, params, batch: TaskBatch, final_h, initial_feats,
                     gen=None):
        g = batch.graph
        labels = batch.aux["target_labels"]  # [N_pad, num_labels]
        logits = torch.matmul(final_h, params["kernel"]) + params["bias"]
        # Summed sigmoid CE over real nodes, averaged per node
        # (ppi_task.py:181-190).
        per_elem = (torch.clamp(logits, min=0) - logits * labels
                    + torch.log1p(torch.exp(-torch.abs(logits))))
        total_loss = torch.sum(per_elem * g.node_mask[:, None])
        num_nodes = torch.clamp(torch.sum(g.node_mask), min=1.0)
        loss = total_loss / num_nodes

        tp, fp, fn = micro_f1_counts(logits, labels, g.node_mask)
        precision = tp / (tp + fp + SMALL_NUMBER)
        recall = tp / (tp + fn + SMALL_NUMBER)
        f1 = 2 * precision * recall / (precision + recall + SMALL_NUMBER)
        metrics = {"loss": loss, "total_loss": total_loss, "f1_score": f1}
        return loss, metrics

    # -------------------- Minibatching --------------------

    def make_minibatch_iterator(
        self, data, data_fold: DataFold, max_nodes_per_batch: int
    ) -> Iterator[TaskBatch]:
        def _compute():
            sz = [
                (len(s.node_features), [a.shape[0] for a in s.adjacency_lists])
                for s in data
            ]
            return sz, compute_batch_specs(
                sz, max_nodes_per_batch, self.num_edge_types,
                num_buckets=int(self.params.get("batch_spec_buckets", 3)),
            )

        sizes, specs = self.cached_spec(data, max_nodes_per_batch, _compute)
        order = np.arange(len(data))
        if data_fold == DataFold.TRAIN:
            np.random.shuffle(order)
        for pack in pack_greedy(sizes, order, specs[-1], max_nodes_per_batch):
            feats, gids, labels = [], [], []
            adj = [[] for _ in range(self.num_edge_types)]
            counts = []
            node_offset = 0
            num_edges = 0
            for gi, idx in enumerate(pack):
                s = data[idx]
                n = len(s.node_features)
                feats.append(s.node_features)
                labels.append(s.node_labels)
                gids.append(np.full((n,), gi, dtype=np.int32))
                for l in range(self.num_edge_types):
                    adj[l].append(s.adjacency_lists[l] + node_offset)
                    num_edges += s.adjacency_lists[l].shape[0]
                counts.append(s.type_to_node_to_num_incoming_edges)
                node_offset += n
            adj_cat = [np.concatenate(a) for a in adj]
            spec = select_spec(
                specs, node_offset, [a.shape[0] for a in adj_cat], len(pack)
            )
            graph = graph_sample_to_padded(
                np.concatenate(feats, axis=0),
                adj_cat,
                np.concatenate(gids),
                len(pack),
                spec,
                typed_incoming_counts=np.concatenate(counts, axis=1),
            )
            padded_labels = np.zeros((spec.n_pad, self.__num_labels), np.float32)
            padded_labels[:node_offset] = np.concatenate(labels, axis=0)
            yield TaskBatch(
                graph=graph,
                aux={"target_labels": torch.from_numpy(padded_labels)},
                num_graphs=len(pack),
                num_nodes=node_offset,
                num_edges=num_edges,
            )

    # -------------------- Epoch metrics --------------------

    def early_stopping_metric(self, task_metric_results, num_graphs: int) -> float:
        return float(
            np.sum([m["total_loss"] for m in task_metric_results]) / num_graphs
        )

    def pretty_print_epoch_task_metrics(self, task_metric_results, num_graphs: int) -> str:
        # The mean of the batches' F1 (ppi_task.py:262-264), not an F1 of
        # the epoch's pooled counts.
        avg_microf1 = np.average([m["f1_score"] for m in task_metric_results])
        return "Avg MicroF1: %.3f" % (avg_microf1,)
