"""The port's graph-parallel steps and epochs (parallel/graph_parallel.py
make_gp_task_steps, runtime/model.py _run_epoch_graph_parallel) against
the JAX package's make_gp_task_steps on 2 of the 8 virtual CPU devices and
against one process stepping the whole batch, on the CPU: two gloo ranks
started once by parallel/_multihost_check.py (kind gp) from the JAX
package's initial weights (carried across by name with params_from_jax),
RGCN and GNN-FiLM, each with plain SGD and clipping off (the update is the
gradient) and with the tuned QM9 optimizer and its clipping. Also cached
gp epochs equal on both ranks, a 2-process train CLI run and its test CLI
run, and the option checks' messages."""

import gzip
import itertools
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from tf_gnn_samples_tpu.parallel.data_parallel import make_mesh
from tf_gnn_samples_tpu.parallel.graph_parallel import (
    make_gp_task_steps, partition_task_batch)
from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
from tf_gnn_samples_tpu.utils.registry import (
    name_to_model_class as j_model_class)
from tf_gnn_samples_torch.parallel import _multihost_check as check
from tf_gnn_samples_torch.parallel import graph_parallel as gp
from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9
from tf_gnn_samples_torch.train import HYPERS_DIR

RANKS = 2
# tests/test_torch_data_parallel.py's bar (tests/test_runtime.py's).
PARAMS = dict(rtol=2e-4, atol=1e-6)
CASES = ["%s %s" % (m, o) for m in check.GP_MODELS
         for o in check.GP_OPTIMIZERS]


def jax_model(name, optimizer):
    """The JAX package's `name` at the ranks' config (check.gp_model's:
    the tuned QM9 file, GP_STEP_OVERRIDES, the optimizer variant),
    graph_parallel 2, on a QM9 task of one batch shape."""
    cls, extra = j_model_class(name)
    params = {**cls.default_params(), **extra}
    with open(os.path.join(HYPERS_DIR, "QM9_%s.json" % name)) as f:
        params.update(json.load(f)["model_params"])
    params.update(check.GP_STEP_OVERRIDES)
    params.update(check.GP_OPTIMIZERS[optimizer])
    params["graph_parallel"] = RANKS
    task = check.qm9_task(j_qm9, j_base, buckets=1)
    return cls(params, task, "j", "unused"), task


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the two ranks saw, started from the JAX package's
    initial weights of each model."""
    out = tmp_path_factory.mktemp("gp")
    init = {name: j_model.flatten_params(jax.device_get(
        jax_model(name, "tuned")[0].model_params_tree))
        for name in check.GP_MODELS}
    path = str(out / "init.pickle")
    with open(path, "wb") as f:
        pickle.dump({k: {n: np.asarray(v) for n, v in w.items()}
                     for k, w in init.items()}, f)
    line = check.run_multihost_check(RANKS, out_dir=str(out), kind="gp",
                                     init=path)
    assert "MULTIHOST_OK processes=2" in line and "kind=gp" in line
    return [torch.load(str(out / ("rank%d.pt" % r)), weights_only=False)
            for r in range(RANKS)], init


_JAX_STEPS = {}


def jax_step(case, init):
    """The JAX package's gp train and eval steps on 2 virtual devices from
    `init` on the first TRAIN batch: (weights after the train step, eval
    metrics); once a case."""
    if case not in _JAX_STEPS:
        _JAX_STEPS[case] = _jax_step(case, init)
    return _JAX_STEPS[case]


def _jax_step(case, init):
    name, optimizer = case.split(" ")
    jm, task = jax_model(name, optimizer)
    jm.model_params_tree = j_model.unflatten_like(jm.model_params_tree,
                                                  init[name])
    batch = check.step_batches(task, j_base, 1)[0]
    budget = gp.batch_edge_budget(check.step_batches(
        check.qm9_task(t_qm9, t_base, buckets=1), t_base, 1)[0])
    shards, _, _ = partition_task_batch(batch, RANKS, batch.graph.n_pad,
                                        budget)
    shards = jax.tree_util.tree_map(jax.numpy.asarray, shards)
    dev_batch = jm._device_batch(batch)
    train, evaluate = make_gp_task_steps(jm, make_mesh(RANKS,
                                                       axis_name="gp"))
    metrics = jax.device_get(evaluate(jm.model_params_tree, dev_batch,
                                      shards))
    p0 = jax.tree_util.tree_map(jax.numpy.copy, jm.model_params_tree)
    params, _, _ = train(p0, jm._optimizer.init(p0), jax.random.PRNGKey(0),
                         dev_batch, shards)
    return j_model.flatten_params(jax.device_get(params)), metrics


def assert_weights_close(got, want, **tol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("case", CASES)
def test_gp_step_matches_jax_and_the_single_process_step(case, ranks):
    """Each rank stepped its partition of the first TRAIN batch: both
    ranks' parameters equal bit for bit, and within rtol 2e-4 / atol 1e-6
    of the JAX package's 2-device gp step and of one process stepping the
    whole batch (the f32 segment branch); the step moved them."""
    (r0, r1), init = ranks
    rec = r0["steps"][case]
    assert r0["n_local"] * RANKS >= r0["n_pad"] > r0["num_nodes"]
    for k, v in rec["init"].items():
        assert np.array_equal(v, np.asarray(init[case.split(" ")[0]][k]))
    for k, v in rec["train"].items():
        assert np.array_equal(r1["steps"][case]["train"][k], v), k
    want, _ = jax_step(case, init)
    assert_weights_close(rec["train"], want, **PARAMS)
    assert_weights_close(rec["train"], rec["single_train"], **PARAMS)
    moved = max(float(np.abs(rec["train"][k] - rec["init"][k]).max())
                for k in want)
    assert moved > 1e-4


@pytest.mark.parametrize("case", CASES[::2])
def test_gp_eval_loss_matches_jax_and_the_single_process(case, ranks):
    """The gp eval step's loss against the JAX package's gp eval and the
    single-process eval on the same batch, rtol 1e-4
    (tests/test_graph_parallel.py's bar); the train step's metrics are
    every rank's the same."""
    (r0, r1), init = ranks
    rec = r0["steps"][case]
    _, metrics = jax_step(case, init)
    np.testing.assert_allclose(float(rec["eval"]["loss"]),
                               float(metrics["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(rec["eval"]["loss"]),
                               float(rec["single_eval"]["loss"]), rtol=1e-4)
    for k, v in rec["train_metrics"].items():
        assert np.array_equal(r1["steps"][case]["train_metrics"][k], v), k


def test_cached_gp_epochs_agree_across_ranks(ranks):
    """3 epochs of GNN-FiLM (dropout on) with the cache, re-packed every 2
    (TRAIN packed at 1 and 3, cached at 2): both ranks log the same
    per-batch and epoch losses and end with the same weights; every epoch
    counts the whole fold; the train loss falls."""
    (r0, r1), _ = ranks
    a = r0["epochs"]
    assert a == r1["epochs"] and len(a) == 2 * check.EPOCHS
    for k, v in r0["epoch_weights"].items():
        assert np.array_equal(r1["epoch_weights"][k], v), k
    for e in a:
        assert e["graphs"] == (check.TRAIN_GRAPHS if e["fold"] == "TRAIN"
                               else check.VALID_GRAPHS)
        assert np.isfinite(e["losses"]).all() and e["cached"]
    train = [e["loss"] for e in a if e["fold"] == "TRAIN"]
    assert train[-1] < train[0], train


@pytest.mark.parametrize("case", ["wrong_size", "no_process_group", "halo",
                                  "both_options"])
def test_option_checks_raise_with_their_messages(case, ranks, tmp_path):
    if case == "wrong_size":
        assert ranks[0][0]["wrong_size"] == (
            "graph_parallel=3 but the process group has 2 ranks (one rank a "
            "partition)")
        return
    task = check.qm9_task(t_qm9, t_base)
    params = check.model_params(t_model.RGCN_Model, graph_parallel=2,
                                **check.STEP_OVERRIDES)
    if case == "halo":
        # The halo exchange builds, and an epoch without a process group
        # raises as the all-gather's does.
        params["graph_parallel_halo"] = True
    if case == "both_options":
        params["num_model_replicas"] = 2
        with pytest.raises(ValueError, match="graph_parallel and "
                           "num_model_replicas are mutually exclusive"):
            t_model.RGCN_Model(params, task, "t", str(tmp_path),
                               device="cpu")
        return
    model = t_model.RGCN_Model(params, task, "t", str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="graph_parallel=2 runs one process "
                       "a partition .* --coordinator HOST:PORT --num-hosts N "
                       "--host-id I"):
        model._run_epoch("x", task._loaded_data[t_base.DataFold.TRAIN],
                         t_base.DataFold.TRAIN, quiet=True)


def write_subset(src, dst, count):
    with gzip.open(src, "rt") as fin, gzip.open(dst, "wt") as fout:
        fout.writelines(itertools.islice(fin, count))


def run_ranks(args, tmp_path, timeout=150):
    """Two CPU processes of `python -m tf_gnn_samples_torch.<args>`,
    joined at a file:// rendezvous; returns their (stdout, stderr)."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    store = "file://%s" % (tmp_path / ("store_%s" % args[0]))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tf_gnn_samples_torch." + args[0]] + args[1:]
        + ["--coordinator", store, "--num-hosts", "2", "--host-id", str(r)],
        cwd=check.ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        results = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, stderr) in zip(procs, results):
        assert p.returncode == 0, stderr[-3000:]
    return results


def test_train_and_test_clis_run_graph_parallel_as_two_ranks(tmp_path):
    """GNN-FiLM on QM9, 1 epoch, 2 layers, hidden 16, graph_parallel 2
    over two `python -m tf_gnn_samples_torch.train --device cpu`
    processes: both print the same Train and Valid lines, rank 0 alone
    writes the log and the checkpoint; the test CLI evaluates the
    checkpoint as two ranks (the same lines on both), and alone as one
    process (the same loss)."""
    data = tmp_path / "qm9"
    data.mkdir()
    for fold, count in (("train", 60), ("valid", 30), ("test", 30)):
        write_subset(os.path.join(check.ROOT, "data", "qm9",
                                  (fold if fold != "test" else "valid")
                                  + ".jsonl.gz"),
                     str(data / (fold + ".jsonl.gz")), count)
    out = tmp_path / "out"
    overrides = json.dumps({"max_epochs": 1, "graph_num_layers": 2,
                            "hidden_size": 16, "max_nodes_in_batch": 300,
                            "graph_parallel": 2,
                            # The f32 branch in the one-process evaluation
                            # too (the gp layers are f32).
                            "aggregation_strategy": "segment"})
    results = run_ranks(["train", "GNN-FiLM", "QM9", "--device", "cpu",
                         "--data-path", str(data), "--result-dir", str(out),
                         "--quiet", "--model-param-overrides", overrides],
                        tmp_path)
    keep = (" Train:", " Valid:", "Loss ", "Metrics:")
    lines = [[ln for ln in stdout.splitlines() if ln.startswith(keep)]
             for stdout, _ in results]
    assert len(lines[0]) == 2 and lines[0] == lines[1], lines
    assert len(list(out.glob("QM9_GNN-FiLM_*.log"))) == 1
    (ckpt,) = out.glob("QM9_GNN-FiLM_*_best_model.pickle")
    log = next(out.glob("QM9_GNN-FiLM_*.log")).read_text()
    assert all(ln in log.splitlines() for ln in lines[0])
    test_data = str(data / "test.jsonl.gz")
    results = run_ranks(["test", str(ckpt), test_data, "--device", "cpu",
                         "--result-dir", str(out), "--quiet",
                         "--model-param-overrides",
                         json.dumps({"graph_parallel": 2})], tmp_path)
    tested = [[ln for ln in stdout.splitlines() if ln.startswith(keep)]
              for stdout, _ in results]
    assert len(tested[0]) == 2 and tested[0] == tested[1], tested
    alone = subprocess.run(
        [sys.executable, "-m", "tf_gnn_samples_torch.test", str(ckpt),
         test_data, "--device", "cpu", "--result-dir", str(out), "--quiet"],
        cwd=check.ROOT, capture_output=True, text=True, timeout=120)
    assert alone.returncode == 0, alone.stderr[-3000:]
    assert ("Evaluating on one process: the model was trained with "
            "graph_parallel=2.") in alone.stdout
    single = [ln for ln in alone.stdout.splitlines() if ln.startswith(keep)]
    assert len(single) == 2
    np.testing.assert_allclose(float(single[0].split()[1]),
                               float(tested[0][0].split()[1]), rtol=1e-4)
