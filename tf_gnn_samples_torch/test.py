"""Evaluate a trained model snapshot (counterpart of the root test.py).

Restores the pickle snapshot (written by this package or the JAX one),
doubles `max_nodes_in_batch` for evaluation, and runs model.test on the
given or default data path. Runs on CUDA unless --device cpu is given.

Usage:
    python -m tf_gnn_samples_torch.test [options] STORED_MODEL_PATH [DATA_PATH]
"""

import argparse
import json
from typing import Optional

from .utils.registry import restore


def test(model_path: str, test_data_path: Optional[str], result_dir: str,
         quiet: bool = False, run_id: str = None, device=None):
    model = restore(model_path, result_dir, run_id, device=device)
    # Larger batches are fine without training state (reference test.py:27).
    model.params["max_nodes_in_batch"] = 2 * model.params["max_nodes_in_batch"]
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
    args = parser.parse_args(argv)
    test(args.STORED_MODEL_PATH, args.DATA_PATH, args.result_dir,
         quiet=args.quiet, device=args.device)


if __name__ == "__main__":
    main()
