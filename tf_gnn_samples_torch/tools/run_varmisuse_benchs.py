"""Reproduce the VarMisuse results table with this package: 7 models x N
seeds, including the unseen-project "TestOnly" generalization split
(counterpart of the root run_varmisuse_benchs.py).

Per (model, seed), one `python -m tf_gnn_samples_torch.train --quiet
--run-test MODEL VarMisuse` subprocess gives the valid and test accuracies
and the saved pickle's path; a `python -m tf_gnn_samples_torch.test`
subprocess then evaluates that pickle on the held-out projects' fold
(`graphs-testonly`, reorg_varmisuse_data.sh:10) for the TestOnly column.
The scrape regexes are the reference's, copied here (the log lines are a
public contract).

Usage:
    python -m tf_gnn_samples_torch.tools.run_varmisuse_benchs [options] LOG_TARGET_DIR
"""

import argparse
import os
import re

from ..utils.bench_runner import (
    Trial, execute, mean_std, model_subset, test_argv, train_argv,
)

SCRAPE_TRAIN = {
    "test_acc": re.compile(r"^Metrics: Accuracy: (0.\d+)"),
    "valid_acc": re.compile(r"Best validation results: Accuracy: (0.\d+)"),
    "pickle": re.compile(r"^Loading model from file (.+)\."),
}
SCRAPE_EVAL = {"testonly_acc": re.compile(r"^Metrics: Accuracy: (0.\d+)")}


def main(args):
    models = model_subset(args.models)
    columns = {m: {"valid": [], "test": [], "testonly": []} for m in models}
    for model in models:
        for seed in range(1, 1 + int(args.num_runs)):
            stem = os.path.join(
                args.LOG_TARGET_DIR, "%s_seed%i" % (model.lower(), seed)
            )
            train_trial = Trial(
                argv=train_argv(model, "VarMisuse", seed=seed,
                                data_path=args.data_path,
                                result_dir=os.path.join(
                                    args.LOG_TARGET_DIR, "models"),
                                device=args.device),
                logfile=stem + ".txt",
                scrape=SCRAPE_TRAIN,
                tag=(model, seed),
            )
            (outcome,) = execute(
                [train_trial],
                "Running %s / seed %i." % (model, seed),
            )
            columns[model]["valid"] += outcome.floats("valid_acc")
            columns[model]["test"] += outcome.floats("test_acc")

            saved = outcome.last("pickle")
            if saved is None:
                raise RuntimeError(
                    "Run log %s has no saved-model line." % train_trial.logfile
                )
            eval_trial = Trial(
                argv=test_argv(saved, args.testonly_path,
                               result_dir=os.path.join(args.LOG_TARGET_DIR,
                                                       "models"),
                               device=args.device),
                logfile=stem + "-testonly.txt",
                scrape=SCRAPE_EVAL,
                tag=(model, seed, "testonly"),
            )
            columns[model]["testonly"] += eval_trial.run().floats(
                "testonly_acc"
            )

    print("| %- 14s | %- 17s | %- 17s | %- 17s |"
          % ("Model", "Valid Acc", "Test Acc", "TestOnly Acc"))
    print("|" + "-" * 16 + "|" + "-" * 19 + "|" + "-" * 19 + "|" + "-" * 19 + "|")
    for model in models:
        cells = []
        for fold in ("valid", "test", "testonly"):
            m, s = mean_std(columns[model][fold])
            cells.append("%.3f (+/- %.3f)" % (m, s))
        print("| %- 14s | %s | %s | %s |" % (model, *cells))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("LOG_TARGET_DIR")
    parser.add_argument("--num-runs", default=5)
    parser.add_argument("--data-path", default=None)
    parser.add_argument("--testonly-path",
                        default="data/varmisuse/graphs-testonly")
    parser.add_argument("--models", default=None,
                        help="Comma-separated subset of models to run "
                             "(extension; default = the reference's full list).")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu, for every run.")
    main(parser.parse_args())
