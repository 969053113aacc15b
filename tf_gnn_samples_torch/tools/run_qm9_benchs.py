"""Reproduce the QM9 results table with this package: 7 models x 13
properties x N seeds (counterpart of the root run_qm9_benchs.py).

One `python -m tf_gnn_samples_torch.train --run-test MODEL QM9` subprocess
per (model, property, seed); the chemical-accuracy error ratio and the
training time are scraped from the run log (the reference's regexes,
copied here: the log lines are a public contract) and folded into the
paper's LaTeX-ish table (arXiv:1906.12192 Table 2).

Usage:
    python -m tf_gnn_samples_torch.tools.run_qm9_benchs [options] LOG_TARGET_DIR
"""

import argparse
import os
import re

from ..utils.bench_runner import (
    Trial, execute, mean_std, model_subset, train_argv,
)

#: Property names in task-id order (reference qm9_task.py CHEMICAL_ACC order).
PROPERTIES = ("mu", "alpha", "HOMO", "LUMO", "gap", "R2", "ZPVE",
              "U0", "U", "H", "G", "Cv", "Omega")

SCRAPE = {
    "mae_ratio": re.compile(
        r"^Metrics: MAEs: \d+:([0-9.]+) \| Error Ratios: \d+:([0-9.]+)"
    ),
    "train_secs": re.compile(r"^Training took (\d+)s"),
}


def property_subset(spec):
    """Comma-separated --properties filter (harness extension; names from
    PROPERTIES). Returns task ids; default = all 13."""
    if not spec:
        return list(range(len(PROPERTIES)))
    return [PROPERTIES.index(name) for name in spec.split(",")]


def build_grid(args):
    import json as _json
    overrides = (_json.loads(args.model_param_overrides)
                 if args.model_param_overrides else None)
    for model in model_subset(args.models):
        for prop_id in property_subset(args.properties):
            for seed in range(1, 1 + int(args.num_runs)):
                yield Trial(
                    argv=train_argv(model, "QM9", seed=seed, quiet=False,
                                    model_overrides=overrides,
                                    task_overrides={"task_ids": [prop_id]},
                                    data_path=args.data_path,
                                    result_dir=os.path.join(
                                        args.LOG_TARGET_DIR, "models"),
                                    device=args.device),
                    logfile=os.path.join(
                        args.LOG_TARGET_DIR,
                        "%s_task%i_seed%i.txt" % (model, prop_id, seed),
                    ),
                    scrape=SCRAPE,
                    tag=(model, prop_id, seed),
                )


def main(args):
    models = model_subset(args.models)
    results = execute(
        list(build_grid(args)),
        "Starting QM9 experiments, will write logfiles for runs into %s."
        % args.LOG_TARGET_DIR,
    )
    row_layout = "%7s " + "&% 35s " * len(models) + "\\\\"
    print(row_layout % tuple([""] + list(models)))
    for prop_id in property_subset(args.properties):
        prop = PROPERTIES[prop_id]
        cells = []
        for model in models:
            hits = [r for r in results if r.tag[:2] == (model, prop_id)]
            # group 1 of mae_ratio = the error ratio (MAE / chemical acc.)
            ratio_mean, ratio_std = mean_std(
                [v for r in hits for v in r.floats("mae_ratio", group=1)]
            )
            mins, _ = mean_std(
                [v / 60 for r in hits for v in r.floats("train_secs")]
            )
            cells.append("%.2f & ($\\pm %.2f$; $%.1f$min)"
                         % (ratio_mean, ratio_std, mins))
        print(row_layout % tuple([prop] + cells))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("LOG_TARGET_DIR")
    parser.add_argument("--num-runs", default=5)
    parser.add_argument("--data-path", default=None)
    parser.add_argument("--models", default=None,
                        help="Comma-separated subset of models to run "
                             "(extension; default = the reference's full list).")
    parser.add_argument("--properties", default=None,
                        help="Comma-separated subset of property names "
                             "(extension; default = all 13).")
    parser.add_argument("--model-param-overrides", default=None,
                        help="JSON model-param overrides applied to every "
                             "run (extension; e.g. the small-fold recipe "
                             "from docs/PARITY.md).")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu, for every run.")
    main(parser.parse_args())
