"""Train a GNN model on a task (counterpart of the root train.py).

4-level parameter merge (class defaults -> registry extras ->
default_hypers/{TASK}_{MODEL}.json -> CLI JSON overrides), data loaded
once and shared across a (possibly list-valued) random_seed sweep, per-run
log files whose format the bench scripts regex, and optional --run-test.
Runs on CUDA unless --device cpu is given.

Usage:
    python -m tf_gnn_samples_torch.train [options] MODEL_NAME TASK_NAME
"""

import argparse
import json
import os
import time

from .test import test
from .utils.registry import name_to_model_class, name_to_task_class

HYPERS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "default_hypers")


def get_train_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("MODEL_NAME",
                        help="GGNN, RGCN, RGAT, GNN-FiLM, GNN-Edge-MLP0 or "
                             "GNN-Edge-MLP1 (the ported models)")
    parser.add_argument("TASK_NAME", help="QM9 (the ported task)")
    parser.add_argument("--data-path", default=None)
    parser.add_argument("--result-dir", default="trained_models")
    parser.add_argument("--run-test", action="store_true")
    parser.add_argument("--model-param-overrides", default=None)
    parser.add_argument("--task-param-overrides", default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu.")
    return parser.parse_args(argv)


def run(args):
    """Train one model per random seed; returns the trained models."""
    model_cls, additional_model_params = name_to_model_class(args.MODEL_NAME)
    task_cls, additional_task_params = name_to_task_class(args.TASK_NAME)

    # 4-level parameter merge (reference train.py:38-59):
    task_params = task_cls.default_params()
    task_params.update(additional_task_params)
    model_params = model_cls.default_params()
    model_params.update(additional_model_params)

    hypers_file = os.path.join(
        HYPERS_DIR, "%s_%s.json" % (task_cls.name(), model_cls.name(model_params))
    )
    if os.path.exists(hypers_file):
        print("Loading task/model-specific default parameters from %s." % hypers_file)
        with open(hypers_file, "rt") as f:
            default_task_model_hypers = json.load(f)
        task_params.update(default_task_model_hypers["task_params"])
        model_params.update(default_task_model_hypers["model_params"])

    task_params.update(json.loads(args.task_param_overrides or "{}"))
    model_params.update(json.loads(args.model_param_overrides or "{}"))

    result_dir = args.result_dir
    os.makedirs(result_dir, exist_ok=True)
    task = task_cls(task_params)
    data_path = args.data_path or task.default_data_path()
    task.load_data(data_path)

    random_seeds = model_params["random_seed"]
    if not isinstance(random_seeds, list):
        random_seeds = [random_seeds]

    models = []
    for random_seed in random_seeds:
        model_params["random_seed"] = random_seed
        run_id = "_".join([
            task_cls.name(),
            model_cls.name(model_params),
            time.strftime("%Y-%m-%d-%H-%M-%S"),
            str(os.getpid()),
        ])
        model = model_cls(dict(model_params), task, run_id, result_dir,
                          device=args.device)
        model.log_line("Run %s starting." % run_id)
        model.log_line(" Using the following task params: %s" % json.dumps(task_params))
        model.log_line(" Using the following model params: %s" % json.dumps(model_params))
        model.train(quiet=args.quiet)
        if args.run_test:
            test(model.best_model_file, data_path, result_dir,
                 quiet=args.quiet, run_id=run_id, device=args.device)
        models.append(model)
    return models


if __name__ == "__main__":
    run(get_train_args())
