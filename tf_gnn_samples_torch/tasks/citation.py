"""Citation-network node classification, Cora / Citeseer / Pubmed
(counterpart of tf_gnn_samples_tpu/tasks/citation.py).

Capability-parity with the reference's `Citation_Network_Task`
(tasks/citation_network_task.py:15-184): transductive single-graph
classification over Planetoid pickles, 2 edge types ([self-loops,
symmetrized citation edges]), row-normalized features, masked softmax
cross-entropy and masked accuracy; the whole graph is ONE batch with
num_graphs=1 and a float mask selecting the fold's nodes.

The Planetoid loader reproduces the standard Kipf & Welling `load_data`
semantics (reference utils/citation_network_utils.py:25-121, itself from
tkipf/gcn): splits train = first len(y) nodes, valid = next 500,
test = from the index file, with the citeseer isolated-node fix.
"""

import pickle
from typing import Any, Dict, Iterable, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from ..nn.initializers import glorot_uniform
from ..nn.mlp import dropout
from ..ops.graph import bucket_size
from .base import BatchSpec, DataFold, SparseGraphTask, TaskBatch, graph_sample_to_padded


class CitationData(NamedTuple):
    adj_lists: List[np.ndarray]
    num_incoming_edges: np.ndarray
    features: np.ndarray
    labels: np.ndarray
    mask: np.ndarray


def _parse_index_file(filename):
    with open(filename) as f:
        return [int(line.strip()) for line in f]


def load_planetoid_data(directory: str, dataset_str: str):
    """Load ind.{ds}.{x,y,tx,ty,allx,ally,graph,test.index} pickles.

    Returns (graph_dict, features, y_train, y_val, y_test, train_mask,
    val_mask, test_mask) with the exact split conventions of the
    reference loader (citation_network_utils.py:25-90). Unpickles the
    given files: pass only Planetoid data from a trusted source."""
    import scipy.sparse as sp

    objects = []
    for name in ["x", "y", "tx", "ty", "allx", "ally", "graph"]:
        with open("%s/ind.%s.%s" % (directory, dataset_str, name), "rb") as f:
            objects.append(pickle.load(f, encoding="latin1"))
    x, y, tx, ty, allx, ally, graph = objects
    test_idx_reorder = _parse_index_file(
        "%s/ind.%s.test.index" % (directory, dataset_str)
    )
    test_idx_range = np.sort(test_idx_reorder)

    if dataset_str == "citeseer":
        # Isolated-node fix: pad zero-rows into the test range
        # (citation_network_utils.py:58-67).
        full = range(min(test_idx_reorder), max(test_idx_reorder) + 1)
        tx_ext = sp.lil_matrix((len(full), x.shape[1]))
        tx_ext[test_idx_range - min(test_idx_range), :] = tx
        tx = tx_ext
        ty_ext = np.zeros((len(full), y.shape[1]))
        ty_ext[test_idx_range - min(test_idx_range), :] = ty
        ty = ty_ext

    features = sp.vstack((allx, tx)).tolil()
    features[test_idx_reorder, :] = features[test_idx_range, :]
    labels = np.vstack((ally, ty))
    labels[test_idx_reorder, :] = labels[test_idx_range, :]

    n = labels.shape[0]

    def mask_of(idx):
        m = np.zeros(n, dtype=bool)
        m[list(idx)] = True
        return m

    train_mask = mask_of(range(len(y)))
    val_mask = mask_of(range(len(y), len(y) + 500))
    test_mask = mask_of(test_idx_range.tolist())

    def select(m):
        out = np.zeros(labels.shape)
        out[m, :] = labels[m, :]
        return out

    return (graph, features, select(train_mask), select(val_mask),
            select(test_mask), train_mask, val_mask, test_mask)


def preprocess_features(features):
    """Row-normalize and densify (citation_network_utils.py:114-121)."""
    rowsum = np.asarray(features.sum(1)).flatten()
    r_inv = np.divide(1.0, rowsum, out=np.zeros_like(rowsum, dtype=np.float64),
                      where=rowsum != 0)
    return (features.multiply(r_inv[:, None])).toarray().astype(np.float32)


class Citation_Network_Task(SparseGraphTask):
    @classmethod
    def default_params(cls):
        params = super().default_params()
        params.update({
            "add_self_loop_edges": True,
            "use_graph": True,
            "activation_function": "tanh",
            "out_layer_dropout_keep_prob": 1.0,
        })
        return params

    @staticmethod
    def name() -> str:
        return "CitationNetwork"

    @staticmethod
    def default_data_path() -> str:
        return "data/citation-networks"

    def __init__(self, params: Dict[str, Any]):
        super().__init__(params)
        self.__num_edge_types = 2
        self.__initial_node_feature_size = 0
        self.__num_output_classes = 0

    def get_metadata(self) -> Dict[str, Any]:
        metadata = super().get_metadata()
        metadata["initial_node_feature_size"] = self.__initial_node_feature_size
        metadata["num_output_classes"] = self.__num_output_classes
        return metadata

    def restore_from_metadata(self, metadata: Dict[str, Any]) -> None:
        super().restore_from_metadata(metadata)
        self.__initial_node_feature_size = metadata["initial_node_feature_size"]
        self.__num_output_classes = metadata["num_output_classes"]

    @property
    def num_edge_types(self) -> int:
        return self.__num_edge_types

    @property
    def initial_node_feature_size(self) -> int:
        return self.__initial_node_feature_size

    # -------------------- Data loading --------------------

    def load_data(self, path: Optional[str]) -> None:
        train_data, valid_data, _ = self.__load_data(path or self.default_data_path())
        self._loaded_data[DataFold.TRAIN] = train_data
        self._loaded_data[DataFold.VALIDATION] = valid_data

    def load_eval_data_from_path(self, path: str) -> Iterable[Any]:
        _, _, test_data = self.__load_data(path)
        return test_data

    def __load_data(self, data_path: str):
        print(" Loading CitationNetwork data from %s." % (data_path,))
        (adj_list, features, train_labels, valid_labels, test_labels,
         train_mask, valid_mask, test_mask) = load_planetoid_data(
            data_path, self.params["data_kind"]
        )
        self.__initial_node_feature_size = features.shape[1]
        self.__num_output_classes = train_labels.shape[1]
        features = preprocess_features(features)

        def prep(labels, mask):
            return [self.__preprocess_data(
                adj_list, features, np.argmax(labels, axis=1), mask
            )]

        return (prep(train_labels, train_mask), prep(valid_labels, valid_mask),
                prep(test_labels, test_mask))

    def __preprocess_data(self, adj_list, features, labels, mask) -> CitationData:
        """Both directions of each citation edge share type 1; incoming
        counts are symmetric (citation_network_task.py:90-109)."""
        flat, loops = [], []
        num_incoming = np.zeros(len(adj_list), dtype=np.int32)
        for node, neighbours in adj_list.items():
            for nb in neighbours:
                flat.append((node, nb))
                flat.append((nb, node))
                num_incoming[nb] += 1
                num_incoming[node] += 1
            loops.append((node, node))
        counts = np.stack(
            [np.ones_like(num_incoming), num_incoming]
        ).astype(np.float32)
        return CitationData(
            adj_lists=[
                np.array(loops, dtype=np.int32),
                np.array(flat, dtype=np.int32) if flat else np.zeros((0, 2), np.int32),
            ],
            num_incoming_edges=counts,
            features=features,
            labels=labels.astype(np.int32),
            mask=mask.astype(np.float32),
        )

    # -------------------- Output head --------------------

    def output_init(self, gen: torch.Generator, hidden_size: int):
        return {"kernel": glorot_uniform(gen, (hidden_size, self.__num_output_classes))}

    def output_apply(self, params, batch: TaskBatch, final_h, initial_feats,
                     gen=None):
        labels = batch.aux["labels"]  # [N_pad] int32
        mask = batch.aux["mask"]  # [N_pad] float32 (already excludes padding)
        # Output dropout draws from the runtime's generator (the JAX
        # package draws jax.random.bernoulli from its step key).
        final_h = dropout(final_h, self.params["out_layer_dropout_keep_prob"],
                          gen)
        logits = torch.matmul(final_h, params["kernel"])
        log_probs = torch.log_softmax(logits, dim=-1)
        per_node = -torch.gather(log_probs, 1, labels.long()[:, None])[:, 0]
        num_masked = torch.sum(mask)
        total_loss = torch.sum(per_node * mask)
        correct = torch.argmax(logits, dim=1) == labels.long()
        accuracy = torch.sum(correct.to(torch.float32) * mask) / num_masked
        loss = total_loss / num_masked
        return loss, {"loss": loss, "total_loss": total_loss, "accuracy": accuracy}

    # -------------------- Minibatching --------------------

    def make_minibatch_iterator(
        self, data, data_fold: DataFold, max_nodes_per_batch: int
    ) -> Iterator[TaskBatch]:
        d: CitationData = next(iter(data))
        n = d.features.shape[0]
        spec = BatchSpec(
            n_pad=bucket_size(n),
            e_pads=tuple(bucket_size(a.shape[0]) for a in d.adj_lists),
            g_pad=16,
        )
        graph = graph_sample_to_padded(
            d.features,
            d.adj_lists,
            np.zeros(n, dtype=np.int32),
            1,
            spec,
            typed_incoming_counts=d.num_incoming_edges,
        )
        labels = np.zeros(spec.n_pad, np.int32)
        labels[:n] = d.labels
        mask = np.zeros(spec.n_pad, np.float32)
        mask[:n] = d.mask
        yield TaskBatch(
            graph=graph,
            aux={"labels": torch.from_numpy(labels),
                 "mask": torch.from_numpy(mask)},
            num_graphs=1,
            num_nodes=n,
            num_edges=sum(a.shape[0] for a in d.adj_lists),
        )

    # -------------------- Epoch metrics --------------------

    def early_stopping_metric(self, task_metric_results, num_graphs: int) -> float:
        return float(
            np.sum([m["total_loss"] for m in task_metric_results]) / num_graphs
        )

    def pretty_print_epoch_task_metrics(self, task_metric_results, num_graphs: int) -> str:
        return "Acc: %.2f%%" % (task_metric_results[0]["accuracy"] * 100,)
