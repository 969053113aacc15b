"""The port's train CLI's multi-process flags (--coordinator, --num-hosts,
--host-id): they parse and join the process group before the model is
built, and two CPU processes of one data-parallel run (gloo, a file://
rendezvous under the test's temporary directory) print the same Train and
Valid lines, rank 0 alone writing the run's log and checkpoint."""

import gzip
import itertools
import json
import os
import subprocess
import sys

import pytest

from tf_gnn_samples_torch import train as train_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Joined(Exception):
    pass


def test_multihost_flags_parse_and_call_initialize(monkeypatch):
    args = train_cli.get_train_args([
        "RGCN", "QM9", "--device", "cpu", "--coordinator", "host0:1234",
        "--num-hosts", "2", "--host-id", "1"])
    assert (args.coordinator, args.num_hosts, args.host_id) == (
        "host0:1234", 2, 1)
    calls = []

    def initialize(*a, **kw):
        calls.append((a, kw))
        raise Joined()

    monkeypatch.setattr(train_cli, "initialize", initialize)
    monkeypatch.setattr(train_cli, "name_to_model_class",
                        lambda name: pytest.fail("model before initialize"))
    with pytest.raises(Joined):
        train_cli.run(args)
    assert calls == [(("host0:1234", 2, 1), {"device": "cpu"})]

    # Without the flags (and GRAFT_COORDINATOR) it joins no process group.
    class Built(Exception):
        pass

    def build(name):
        raise Built()

    monkeypatch.delenv("GRAFT_COORDINATOR", raising=False)
    monkeypatch.setattr(train_cli, "name_to_model_class", build)
    with pytest.raises(Built):
        train_cli.run(train_cli.get_train_args(["RGCN", "QM9", "--device",
                                                "cpu"]))
    assert len(calls) == 1


def write_subset(src, dst, count):
    with gzip.open(src, "rt") as fin, gzip.open(dst, "wt") as fout:
        fout.writelines(itertools.islice(fin, count))


def test_two_processes_print_identical_train_lines(tmp_path):
    """RGCN on QM9, 1 epoch, 2 layers, hidden 16, num_model_replicas 2 over
    two `python -m tf_gnn_samples_torch.train --device cpu` processes."""
    data = tmp_path / "qm9"
    data.mkdir()
    for fold, count in (("train", 80), ("valid", 40)):
        write_subset(os.path.join(ROOT, "data", "qm9", fold + ".jsonl.gz"),
                     str(data / (fold + ".jsonl.gz")), count)
    out = tmp_path / "out"
    overrides = json.dumps({"max_epochs": 1, "graph_num_layers": 2,
                            "hidden_size": 16, "max_nodes_in_batch": 300,
                            "num_model_replicas": 2})
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tf_gnn_samples_torch.train", "RGCN", "QM9",
         "--device", "cpu", "--data-path", str(data), "--result-dir",
         str(out), "--quiet", "--model-param-overrides", overrides,
         "--coordinator", "file://%s" % (tmp_path / "store"),
         "--num-hosts", "2", "--host-id", str(r)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        results = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (stdout, stderr) in zip(procs, results):
        assert p.returncode == 0, stderr[-3000:]
    lines = [[ln for ln in stdout.splitlines()
              if ln.startswith((" Train:", " Valid:"))]
             for stdout, _ in results]
    assert len(lines[0]) == 2 and lines[0] == lines[1], lines
    assert len(list(out.glob("QM9_RGCN_*.log"))) == 1
    assert len(list(out.glob("QM9_RGCN_*_best_model.pickle"))) == 1
    log = next(out.glob("QM9_RGCN_*.log")).read_text()
    assert all(ln in log.splitlines() for ln in lines[0])
