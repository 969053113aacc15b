"""The port's table harnesses (tf_gnn_samples_torch/utils/bench_runner.py
and tf_gnn_samples_torch/tools/run_*_benchs.py) on the CPU: their scrape
regexes are the root scripts' (the log lines are a public contract), a
Trial runs the port's train CLI on a 2-layer QM9 model and the QM9
harness's regexes read its log, and the QM9 harness builds its table from
one such run."""

import argparse
import gzip
import itertools
import json
import os
import sys

import pytest

import run_ppi_benchs
import run_qm9_benchs
import run_varmisuse_benchs
from tf_gnn_samples_torch.tools import run_ppi_benchs as t_ppi
from tf_gnn_samples_torch.tools import run_qm9_benchs as t_qm9
from tf_gnn_samples_torch.tools import run_varmisuse_benchs as t_varmisuse
from tf_gnn_samples_torch.utils import bench_runner

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 2 layers, 16 wide; a learning rate of 0, so that the second epoch's
# validation metric equals the first's and patience 1 stops the run there
# (the "Training took" line is written at early stopping only).
TINY = {"graph_num_layers": 2, "hidden_size": 16, "max_epochs": 5,
        "patience": 1, "learning_rate": 0.0, "max_nodes_in_batch": 600}


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """A working directory whose data/qm9 holds the first 60 train, 20
    valid and 20 test graphs of the bundled QM9 (the task's default data
    path: only there does --run-test find its test.jsonl.gz, as in the
    reference), made the current directory."""
    d = tmp_path / "work" / "data" / "qm9"
    d.mkdir(parents=True)
    for fold, count in (("train", 60), ("valid", 20), ("test", 20)):
        with gzip.open(os.path.join(ROOT, "data", "qm9",
                                    fold + ".jsonl.gz"), "rt") as fin, \
                gzip.open(str(d / (fold + ".jsonl.gz")), "wt") as fout:
            fout.writelines(itertools.islice(fin, count))
    monkeypatch.chdir(str(tmp_path / "work"))
    return tmp_path / "work"


@pytest.mark.parametrize("port, root, names", [
    (t_qm9, run_qm9_benchs, ("SCRAPE",)),
    (t_ppi, run_ppi_benchs, ("SCRAPE",)),
    (t_varmisuse, run_varmisuse_benchs, ("SCRAPE_TRAIN", "SCRAPE_EVAL"))])
def test_harness_regexes_are_the_root_scripts(port, root, names):
    for name in names:
        got, want = getattr(port, name), getattr(root, name)
        assert {k: p.pattern for k, p in got.items()} == {
            k: p.pattern for k, p in want.items()}
    assert bench_runner.ALL_MODELS == ("GGNN", "RGCN", "RGAT", "RGIN",
                                       "GNN-Edge-MLP0", "GNN-Edge-MLP1",
                                       "GNN_FiLM")


def test_argv_runs_the_port_cli():
    argv = bench_runner.train_argv("RGCN", "QM9", seed=3, device="cpu",
                                   model_overrides={"random_seed": 9})
    assert argv[:5] == [sys.executable, "-m", "tf_gnn_samples_torch.train",
                        "--device", "cpu"]
    assert '"random_seed": 3' in argv[argv.index("--model-param-overrides")
                                      + 1]
    assert bench_runner.test_argv("m.pickle", "d", device="cpu") == [
        sys.executable, "-m", "tf_gnn_samples_torch.test", "--device", "cpu",
        "--quiet", "m.pickle", "d"]


def test_trial_through_the_port_cli_is_scraped(workdir):
    """One Trial: `python -m tf_gnn_samples_torch.train --run-test RGCN
    QM9` (2 layers, 2 epochs) from a working directory outside the
    repository; the QM9 harness's regexes read one error ratio and the
    training time."""
    trial = bench_runner.Trial(
        argv=bench_runner.train_argv(
            "RGCN", "QM9", seed=1, quiet=False, model_overrides=TINY,
            task_overrides={"task_ids": [0]},
            result_dir=str(workdir / "models"), device="cpu"),
        logfile=str(workdir / "logs" / "RGCN_task0_seed1.txt"),
        scrape=t_qm9.SCRAPE, tag=("RGCN", 0, 1))
    result = trial.run()
    (ratio,) = result.floats("mae_ratio", group=1)
    (secs,) = result.floats("train_secs")
    assert ratio > 0 and secs >= 0 and result.tag == ("RGCN", 0, 1)
    assert result.last("mae_ratio", group=0) is not None


def test_qm9_harness_builds_its_table(workdir, capsys):
    args = argparse.Namespace(
        LOG_TARGET_DIR=str(workdir / "logs"), num_runs=1, data_path=None,
        models="GGNN", properties="mu", device="cpu",
        model_param_overrides=json.dumps(TINY))
    t_qm9.main(args)
    out = capsys.readouterr().out
    row = [line for line in out.splitlines() if line.lstrip().startswith("mu")]
    assert len(row) == 1 and "nan" not in row[0], out
    assert os.path.exists(str(workdir / "logs" / "GGNN_task0_seed1.txt"))
