"""Name -> class registries and checkpoint restore (counterpart of
tf_gnn_samples_tpu/utils/registry.py). Ported so far: the GGNN, RGCN, RGAT,
RGIN, GNN-FiLM and GNN-Edge-MLP models and the QM9 task; every other name
the JAX package knows raises "not yet ported"."""

import pickle
from typing import Any, Dict, Tuple, Type

_UNPORTED_TASKS = ("ppi", "varmisuse", "citationnetwork", "citation_network",
                   "cora", "citeseer", "pubmed")
_UNPORTED_MODELS = ("rgdcn", "rgdcn_model")


def name_to_task_class(name: str) -> Tuple[Type, Dict[str, Any]]:
    """Task name -> (class, additional params)."""
    name = name.lower()
    if name == "qm9":
        from ..tasks.qm9 import QM9_Task

        return QM9_Task, {}
    if name in _UNPORTED_TASKS:
        raise NotImplementedError(
            "Task '%s' is not yet ported to the PyTorch package." % name)
    raise ValueError("Unknown task type '%s'" % name)


def name_to_model_class(name: str) -> Tuple[Type, Dict[str, Any]]:
    """Model name -> (class, additional params). `gnn_edge_mlp0` and
    `gnn_edge_mlp1` pin `num_edge_hidden_layers`."""
    name = name.lower()
    if name in ("gnn_edge_mlp", "gnn-edge-mlp", "gnn_edge_mlp_model",
                "gnn_edge_mlp0", "gnn-edge-mlp0", "gnn_edge_mlp1",
                "gnn-edge-mlp1"):
        from ..runtime.model import GNN_Edge_MLP_Model

        if name[-1] in "01":
            return GNN_Edge_MLP_Model, {"num_edge_hidden_layers": int(name[-1])}
        return GNN_Edge_MLP_Model, {}
    if name in ("ggnn", "ggnn_model"):
        from ..runtime.model import GGNN_Model

        return GGNN_Model, {}
    if name in ("rgcn", "rgcn_model"):
        from ..runtime.model import RGCN_Model

        return RGCN_Model, {}
    if name in ("rgat", "rgat_model"):
        from ..runtime.model import RGAT_Model

        return RGAT_Model, {}
    if name in ("rgin", "rgin_model"):
        from ..runtime.model import RGIN_Model

        return RGIN_Model, {}
    if name in ("gnn_film", "gnn-film", "gnn_film_model"):
        from ..runtime.model import GNN_FiLM_Model

        return GNN_FiLM_Model, {}
    if name in _UNPORTED_MODELS:
        raise NotImplementedError(
            "Model '%s' is not yet ported to the PyTorch package." % name)
    raise ValueError("Unknown model type '%s'" % name)


def restore(saved_model_path: str, result_dir: str, run_id: str = None,
            device=None):
    """Rebuild task+model from a best-model pickle (written by either
    package) and load its weights. Unpickles the given file: pass only
    checkpoints this program or the JAX package wrote."""
    print("Loading model from file %s." % saved_model_path)
    with open(saved_model_path, "rb") as f:
        data_to_load = pickle.load(f)

    task_cls, _ = name_to_task_class(data_to_load["task_class"])
    task = task_cls(data_to_load["task_params"])
    task.restore_from_metadata(data_to_load["task_metadata"])

    model_cls, _ = name_to_model_class(data_to_load["model_class"])
    if run_id is None:
        run_id = "_".join([task_cls.name(),
                           model_cls.name(data_to_load["model_params"]),
                           "Restored"])
    model = model_cls(data_to_load["model_params"], task, run_id, result_dir,
                      device=device)
    model.load_weights(data_to_load["weights"])
    return model
