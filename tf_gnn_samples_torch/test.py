"""Evaluate a trained model snapshot (counterpart of the root test.py).

Restores the pickle snapshot (written by this package or the JAX one),
doubles `max_nodes_in_batch` for evaluation, and runs model.test on the
given or default data path. Runs on CUDA unless --device cpu is given;
with --coordinator / --num-hosts / --host-id the processes evaluate
together as the ranks of a process group (graph_parallel: one a
partition).

Usage:
    python -m tf_gnn_samples_torch.test [options] STORED_MODEL_PATH [DATA_PATH]
"""

import argparse
import json
from typing import Optional

import torch.distributed as dist

from .parallel.multihost import initialize, shutdown
from .utils.registry import restore


def test(model_path: str, test_data_path: Optional[str], result_dir: str,
         quiet: bool = False, run_id: str = None, device=None,
         model_param_overrides: Optional[dict] = None):
    model = restore(model_path, result_dir, run_id, device=device)
    # E.g. {"graph_parallel": 2}: evaluate a checkpoint as the ranks of a
    # process group, whatever it was trained with.
    model.params.update(model_param_overrides or {})
    # Larger batches are fine without training state (reference test.py:27).
    model.params["max_nodes_in_batch"] = 2 * model.params["max_nodes_in_batch"]
    for option in ("num_model_replicas", "graph_parallel"):
        ranks = int(model.params.get(option) or 1)
        if ranks > 1 and not dist.is_initialized():
            # Without --coordinator this CLI is one process.
            model.log_line("Evaluating on one process: the model was "
                           "trained with %s=%d." % (option, ranks))
            model.params[option] = 1
    test_data_path = test_data_path or model.task.default_data_path()
    model.log_line(" Using the following task params: %s" % json.dumps(model.task.params))
    model.log_line(" Using the following model params: %s" % json.dumps(model.params))
    model.test(test_data_path, quiet=quiet)
    return model


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("STORED_MODEL_PATH")
    parser.add_argument("DATA_PATH", nargs="?", default=None)
    parser.add_argument("--result-dir", default="trained_models")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu.")
    parser.add_argument("--model-param-overrides", default=None,
                        metavar="JSON",
                        help="Model parameters to set on the restored "
                             "model, e.g. '{\"graph_parallel\": 2}'.")
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="Evaluate as the ranks of a process group "
                             "(a model trained with graph_parallel or "
                             "num_model_replicas): process 0's address; "
                             "see parallel/multihost.py.")
    parser.add_argument("--num-hosts", type=int, default=None,
                        help="With --coordinator: total process count.")
    parser.add_argument("--host-id", type=int, default=None,
                        help="With --coordinator: this process's id.")
    args = parser.parse_args(argv)
    device = args.device
    joined = bool(args.coordinator or args.num_hosts)
    if joined:
        device = str(initialize(args.coordinator, args.num_hosts,
                                args.host_id, device=args.device))
    try:
        test(args.STORED_MODEL_PATH, args.DATA_PATH, args.result_dir,
             quiet=args.quiet, device=device,
             model_param_overrides=json.loads(
                 args.model_param_overrides or "{}"))
    finally:
        if joined:
            shutdown()


if __name__ == "__main__":
    main()
