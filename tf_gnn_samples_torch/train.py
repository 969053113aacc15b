"""Train a GNN model on a task (counterpart of the root train.py).

4-level parameter merge (class defaults -> registry extras ->
default_hypers/{TASK}_{MODEL}.json -> CLI JSON overrides), data loaded
once and shared across a (possibly list-valued) random_seed sweep, per-run
log files whose format the bench scripts regex, optional --run-test,
full-state --resume, --tensorboard metric files, a --profile-dir trace and
azure:// data paths (--azure-info). Runs on CUDA unless --device cpu is
given.

Usage:
    python -m tf_gnn_samples_torch.train [options] MODEL_NAME TASK_NAME
"""

import argparse
import json
import os
import pdb
import subprocess
import sys
import time
import traceback

from .test import test
from .utils.paths import localize_path
from .utils.profiling import trace_if
from .utils.registry import name_to_model_class, name_to_task_class

HYPERS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "default_hypers")


def get_train_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("MODEL_NAME",
                        help="GGNN, RGCN, RGAT, RGIN, GNN-Edge-MLP "
                             "(GNN-Edge-MLP0 or GNN-Edge-MLP1), RGDCN or "
                             "GNN-FiLM: the seven ported model families")
    parser.add_argument("TASK_NAME",
                        help="QM9, PPI, VarMisuse, or a citation network "
                             "(CitationNetwork with a data_kind task param, "
                             "or cora, citeseer or pubmed): the four tasks")
    parser.add_argument("--data-path", default=None)
    parser.add_argument("--result-dir", default="trained_models")
    parser.add_argument("--run-test", action="store_true")
    parser.add_argument("--model-param-overrides", default=None)
    parser.add_argument("--task-param-overrides", default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--tensorboard", default=None, help="Dump metric JSONL files to DIR.")
    parser.add_argument("--profile-dir", default=None,
                        help="Capture a torch.profiler trace of training to DIR.")
    parser.add_argument("--resume", default=None, metavar="STATE_PICKLE",
                        help="Resume from a full training-state checkpoint "
                             "(written when checkpoint_every_n_epochs is set).")
    parser.add_argument("--azure-info", default="azure_auth.json",
                        help="dpu_utils-style auth JSON for azure:// data "
                             "paths (downloaded to a local cache up front; "
                             "needs the azure-storage-blob package).")
    parser.add_argument("--debug", action="store_true")
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
    # azure:// paths localize to a cache dir up front (reference
    # train.py:61-72 upgrades paths through RichPath.create instead).
    data_path = localize_path(data_path, args.azure_info)
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

        if sys.stdin.isatty():
            # Best-effort git tag of the run (reference train.py:88-94 via
            # dpu_utils.git_tag_run).
            try:
                sha = subprocess.check_output(
                    ["git", "rev-parse", "HEAD"], text=True,
                    stderr=subprocess.DEVNULL,
                ).strip()
                subprocess.check_call(
                    ["git", "tag", run_id],
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                )
                model.log_line(" git tagged as %s" % sha)
            except Exception:
                print(" Tried tagging run in git, but failed.")

        model.initialize_model()
        with trace_if(args.profile_dir):
            model.train(quiet=args.quiet, tf_summary_path=args.tensorboard,
                        resume_from=args.resume)
        if args.run_test:
            test(model.best_model_file, data_path, result_dir,
                 quiet=args.quiet, run_id=run_id, device=args.device)
        models.append(model)
    return models


if __name__ == "__main__":
    cli_args = get_train_args()
    try:
        run(cli_args)
    except Exception:
        if cli_args.debug:
            traceback.print_exc()
            pdb.post_mortem()
        else:
            raise
