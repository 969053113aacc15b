"""Reproduce the PPI results table with this package: 7 models x N seeds
(counterpart of the root run_ppi_benchs.py).

One `python -m tf_gnn_samples_torch.train --quiet --run-test MODEL PPI`
subprocess per (model, seed); the final micro-F1 and the total training
seconds are scraped from the run log (the reference's regexes, copied
here: the log lines are a public contract) and reported as a mean +/- std
ASCII table.

Usage:
    python -m tf_gnn_samples_torch.tools.run_ppi_benchs [options] LOG_TARGET_DIR
"""

import argparse
import json
import os
import re

from ..utils.bench_runner import (
    Trial, execute, mean_std, model_subset, train_argv,
)

SCRAPE = {
    "micro_f1": re.compile(r"^Metrics: Avg MicroF1: (0.\d+)"),
    "train_secs": re.compile(r"^Training took (\d+)s"),
}


def build_grid(args):
    extra = json.loads(args.extra_model_overrides) \
        if args.extra_model_overrides else {}
    for model in model_subset(args.models):
        for seed in range(1, 1 + int(args.num_runs)):
            yield Trial(
                argv=train_argv(model, "PPI", seed=seed,
                                model_overrides=extra,
                                data_path=args.data_path,
                                result_dir=os.path.join(
                                    args.LOG_TARGET_DIR, "models"),
                                device=args.device),
                logfile=os.path.join(
                    args.LOG_TARGET_DIR, "%s_seed%i.txt" % (model.lower(), seed)
                ),
                scrape=SCRAPE,
                tag=(model, seed),
            )


def main(args):
    results = execute(
        list(build_grid(args)),
        "Starting PPI experiments, will write logfiles for runs into %s."
        % args.LOG_TARGET_DIR,
    )
    print("| %- 13s | %- 17s | %- 10s |" % ("Model", "Avg. MicroF1", "Avg. Time"))
    print("|" + "-" * 15 + "|" + "-" * 19 + "|" + "-" * 12 + "|")
    for model in model_subset(args.models):
        per_model = [r for r in results if r.tag[0] == model]
        f1_mean, f1_std = mean_std(
            [v for r in per_model for v in r.floats("micro_f1")]
        )
        t_mean, _ = mean_std(
            [v for r in per_model for v in r.floats("train_secs")]
        )
        print("| %- 13s | %.3f (+/- %.3f) |     % 4.1f |"
              % (model, f1_mean, f1_std, t_mean))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("LOG_TARGET_DIR")
    parser.add_argument("--num-runs", default=10)
    parser.add_argument("--data-path", default=None,
                        help="Optional PPI data directory forwarded to "
                             "the train CLI.")
    parser.add_argument("--models", default=None,
                        help="Comma-separated subset of models to run "
                             "(extension; default = the reference's full list).")
    parser.add_argument("--extra-model-overrides", default=None,
                        help="Extra JSON model-param overrides merged into "
                             "every run (extension; e.g. for smoke tests).")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu, for every run.")
    main(parser.parse_args())
