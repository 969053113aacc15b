"""The port's halo-exchange steps and epochs (make_gp_task_steps over
GPHaloShards, runtime/model.py _run_epoch_graph_parallel with
graph_parallel_halo) against the JAX package's make_gp_task_steps over
its halo shards on 2 of the 8 virtual CPU devices and against one process
stepping the whole batch, on the CPU: two gloo ranks started once by
parallel/_multihost_check.py (kind halo) from the JAX package's initial
weights (carried across by name with params_from_jax), RGCN and
GNN-FiLM, each with plain SGD and clipping off and with the tuned QM9
optimizer. Also cached halo epochs equal on both ranks and both CLIs as
two ranks with {"graph_parallel": 2, "graph_parallel_halo": true}."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax

from tf_gnn_samples_tpu.parallel.data_parallel import make_mesh
from tf_gnn_samples_tpu.parallel.graph_parallel import (
    make_gp_task_steps, partition_task_batch_halo)
from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_torch.parallel import _multihost_check as check
from tf_gnn_samples_torch.parallel import graph_parallel as gp
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9

from test_torch_graph_parallel_steps import (
    PARAMS, RANKS, assert_weights_close, jax_model, run_ranks, write_subset)

CASES = ["%s %s" % (m, o) for m in check.GP_MODELS
         for o in check.GP_OPTIMIZERS]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the two ranks saw, started from the JAX package's
    initial weights of each model."""
    out = tmp_path_factory.mktemp("halo")
    init = {name: j_model.flatten_params(jax.device_get(
        jax_model(name, "tuned")[0].model_params_tree))
        for name in check.GP_MODELS}
    path = str(out / "init.pickle")
    with open(path, "wb") as f:
        pickle.dump({k: {n: np.asarray(v) for n, v in w.items()}
                     for k, w in init.items()}, f)
    line = check.run_multihost_check(RANKS, out_dir=str(out), kind="halo",
                                     init=path)
    assert "MULTIHOST_OK processes=2" in line and "kind=halo" in line
    return [torch.load(str(out / ("rank%d.pt" % r)), weights_only=False)
            for r in range(RANKS)], init


_JAX_STEPS = {}


def jax_halo_step(case, init):
    """The JAX package's gp train and eval steps over its halo shards on 2
    virtual devices from `init` on the first TRAIN batch: (weights after
    the train step, eval metrics, halo_pad); once a case."""
    if case in _JAX_STEPS:
        return _JAX_STEPS[case]
    name, optimizer = case.split(" ")
    jm, task = jax_model(name, optimizer)
    jm.model_params_tree = j_model.unflatten_like(jm.model_params_tree,
                                                  init[name])
    batch = check.step_batches(task, j_base, 1)[0]
    budget = gp.batch_edge_budget(check.step_batches(
        check.qm9_task(t_qm9, t_base, buckets=1), t_base, 1)[0])
    shards, _, _, halo_pad = partition_task_batch_halo(
        batch, RANKS, batch.graph.n_pad, budget)
    shards = jax.tree_util.tree_map(jax.numpy.asarray, shards)
    dev_batch = jm._device_batch(batch)
    train, evaluate = make_gp_task_steps(jm, make_mesh(RANKS,
                                                       axis_name="gp"))
    metrics = jax.device_get(evaluate(jm.model_params_tree, dev_batch,
                                      shards))
    p0 = jax.tree_util.tree_map(jax.numpy.copy, jm.model_params_tree)
    params, _, _ = train(p0, jm._optimizer.init(p0), jax.random.PRNGKey(0),
                         dev_batch, shards)
    _JAX_STEPS[case] = (j_model.flatten_params(jax.device_get(params)),
                        metrics, halo_pad)
    return _JAX_STEPS[case]


@pytest.mark.parametrize("case", CASES)
def test_halo_step_matches_jax_and_the_single_process_step(case, ranks):
    """Each rank stepped its halo partition of the first TRAIN batch: both
    ranks' parameters equal bit for bit, and within rtol 2e-4 / atol 1e-6
    of the JAX package's 2-device step over its halo shards and of one
    process stepping the whole batch (the f32 segment branch); the ranks'
    halo_pad is JAX's; the step moved the parameters."""
    (r0, r1), init = ranks
    rec = r0["steps"][case]
    for k, v in rec["init"].items():
        assert np.array_equal(v, np.asarray(init[case.split(" ")[0]][k]))
    for k, v in rec["train"].items():
        assert np.array_equal(r1["steps"][case]["train"][k], v), k
    want, _, halo_pad = jax_halo_step(case, init)
    assert r0["halo_pad"] == r1["halo_pad"] == halo_pad
    assert_weights_close(rec["train"], want, **PARAMS)
    assert_weights_close(rec["train"], rec["single_train"], **PARAMS)
    moved = max(float(np.abs(rec["train"][k] - rec["init"][k]).max())
                for k in want)
    assert moved > 1e-4


@pytest.mark.parametrize("case", CASES[::2])
def test_halo_eval_loss_matches_jax_and_the_single_process(case, ranks):
    """The halo eval step's loss against the JAX package's halo eval and
    the single-process eval on the same batch, rtol 1e-4; the train
    step's metrics are both ranks' the same."""
    (r0, r1), init = ranks
    rec = r0["steps"][case]
    _, metrics, _ = jax_halo_step(case, init)
    np.testing.assert_allclose(float(rec["eval"]["loss"]),
                               float(metrics["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(rec["eval"]["loss"]),
                               float(rec["single_eval"]["loss"]), rtol=1e-4)
    for k, v in rec["train_metrics"].items():
        assert np.array_equal(r1["steps"][case]["train_metrics"][k], v), k


def test_cached_halo_epochs_agree_across_ranks(ranks):
    """3 epochs of GNN-FiLM (dropout on) with graph_parallel_halo and the
    cache, re-packed every 2: both ranks log the same per-batch and epoch
    losses and end with the same weights; every epoch counts the whole
    fold; the train loss falls; a process group of another size than
    graph_parallel raises."""
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
    assert r0["wrong_size"].startswith("graph_parallel=3 but the process "
                                       "group has 2 ranks")


def test_train_and_test_clis_run_the_halo_exchange_as_two_ranks(tmp_path):
    """GNN-FiLM on QM9, 1 epoch, 2 layers, hidden 16, {"graph_parallel":
    2, "graph_parallel_halo": true} over two `python -m
    tf_gnn_samples_torch.train --device cpu` processes: both print the
    same Train and Valid lines, rank 0 alone writes the log and the
    checkpoint; the test CLI evaluates it as two halo ranks (the same
    lines on both)."""
    data = tmp_path / "qm9"
    data.mkdir()
    for fold, count in (("train", 60), ("valid", 30)):
        write_subset(os.path.join(check.ROOT, "data", "qm9",
                                  "valid.jsonl.gz"),
                     str(data / (fold + ".jsonl.gz")), count)
    out = tmp_path / "out"
    halo = {"graph_parallel": 2, "graph_parallel_halo": True}
    overrides = json.dumps(dict(halo, max_epochs=1, graph_num_layers=2,
                                hidden_size=16, max_nodes_in_batch=300,
                                aggregation_strategy="segment"))
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
    results = run_ranks(["test", str(ckpt), str(data / "valid.jsonl.gz"),
                         "--device", "cpu", "--result-dir", str(out),
                         "--quiet", "--model-param-overrides",
                         json.dumps(halo)], tmp_path)
    tested = [[ln for ln in stdout.splitlines() if ln.startswith(keep)]
              for stdout, _ in results]
    assert len(tested[0]) == 2 and tested[0] == tested[1], tested
