"""Shared machinery of the table harnesses (counterpart of
tf_gnn_samples_tpu/utils/bench_runner.py).

The three harnesses of tf_gnn_samples_torch/tools/ (run_qm9_benchs,
run_ppi_benchs, run_varmisuse_benchs) re-derive the reference's published
result tables by running this package's train and test CLIs as
subprocesses and scraping their logs, as the reference does. The log
lines and the scrape regexes are a public contract shared with the
reference and the JAX package; the orchestration is this package's own.

Each harness declares a grid of `Trial`s (command + logfile + named scrape
patterns); `execute` runs them one after another and returns one
`TrialResult` per trial with every pattern's captures, which the harness
folds into its table. The CLIs run on CUDA unless `device` says "cpu".
"""

import json
import os
import re
import subprocess
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: The seven model names of the reference's tables (README.md:143-149).
ALL_MODELS = ("GGNN", "RGCN", "RGAT", "RGIN",
              "GNN-Edge-MLP0", "GNN-Edge-MLP1", "GNN_FiLM")

# The directory that holds this package: the CLIs run as `python -m`
# modules of it from any working directory.
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _cli_env() -> Dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_PACKAGE_PARENT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                             else []))
    return env


@dataclass
class Trial:
    """One subprocess invocation plus what to scrape from its log."""

    argv: List[str]
    logfile: str
    scrape: Dict[str, re.Pattern]
    tag: Tuple = ()

    def run(self) -> "TrialResult":
        os.makedirs(os.path.dirname(self.logfile) or ".", exist_ok=True)
        with open(self.logfile, "w") as sink:
            subprocess.check_call(self.argv, stdout=sink, stderr=sink,
                                  env=_cli_env())
        return self.scrape_log()

    def scrape_log(self) -> "TrialResult":
        captures: Dict[str, List[Tuple[str, ...]]] = {
            name: [] for name in self.scrape
        }
        with open(self.logfile) as fh:
            for line in fh:
                for name, pattern in self.scrape.items():
                    hit = pattern.search(line)
                    if hit is not None:
                        captures[name].append(hit.groups())
        return TrialResult(tag=self.tag, captures=captures)


@dataclass
class TrialResult:
    tag: Tuple
    captures: Dict[str, List[Tuple[str, ...]]]

    def floats(self, name: str, group: int = 0) -> List[float]:
        return [float(g[group]) for g in self.captures.get(name, [])]

    def last(self, name: str, group: int = 0) -> Optional[str]:
        hits = self.captures.get(name) or []
        return hits[-1][group] if hits else None


def train_argv(model: str, task: str, *, seed: int,
               model_overrides: Optional[dict] = None,
               task_overrides: Optional[dict] = None,
               data_path: Optional[str] = None,
               result_dir: Optional[str] = None,
               quiet: bool = True, run_test: bool = True,
               device: str = "cuda") -> List[str]:
    """A `python -m tf_gnn_samples_torch.train` invocation, one a (model,
    seed) as the reference's protocol runs them (run_ppi_benchs.py:38-48)."""
    argv = [sys.executable, "-m", "tf_gnn_samples_torch.train",
            "--device", device]
    if quiet:
        argv.append("--quiet")
    if run_test:
        argv.append("--run-test")
    if result_dir:
        argv += ["--result-dir", result_dir]
    argv += [model, task]
    merged = dict(model_overrides or {})
    if "random_seed" in merged:
        print("WARNING: ignoring 'random_seed' in model overrides; the "
              "harness assigns one seed per trial.", file=sys.stderr)
    merged["random_seed"] = seed  # after overrides: every trial keeps its own seed
    argv += ["--model-param-overrides", json.dumps(merged)]
    if task_overrides:
        argv += ["--task-param-overrides", json.dumps(task_overrides)]
    if data_path:
        argv += ["--data-path", data_path]
    return argv


def test_argv(model_path: str, data_path: Optional[str], *,
              result_dir: Optional[str] = None, quiet: bool = True,
              device: str = "cuda") -> List[str]:
    """A `python -m tf_gnn_samples_torch.test` invocation on a saved
    model."""
    argv = [sys.executable, "-m", "tf_gnn_samples_torch.test",
            "--device", device]
    if quiet:
        argv.append("--quiet")
    if result_dir:
        argv += ["--result-dir", result_dir]
    argv.append(model_path)
    if data_path:
        argv.append(data_path)
    return argv


def execute(trials: Sequence[Trial], announce: str) -> List[TrialResult]:
    print(announce)
    return [t.run() for t in trials]


def mean_std(values: Sequence[float]) -> Tuple[float, float]:
    if not values:
        return float("nan"), float("nan")
    return float(np.mean(values)), float(np.std(values))


def model_subset(spec: Optional[str]) -> Sequence[str]:
    """Comma-separated --models filter (harness extension; defaults to the
    reference's full list)."""
    return spec.split(",") if spec else ALL_MODELS
