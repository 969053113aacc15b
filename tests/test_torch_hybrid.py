"""The port's hybrid dp x gp step (tf_gnn_samples_torch/parallel/
multihost.py: hybrid_layout, make_hybrid_mesh, make_hybrid_gp_train_step)
on the CPU: the layout's rows and its ValueErrors (the JAX package's
make_hybrid_mesh's, tests/test_multihost.py), then four gloo ranks started
once by parallel/_multihost_check.py (kind hybrid) from the JAX package's
initial weights (carried across by name with params_from_jax): dp 2 x gp
2, RGCN and GNN-FiLM, SGD unclipped and tuned, by all-gather and by halo
exchange, one hybrid step against the JAX package's
make_hybrid_gp_train_step on a (dp 2, gp 2) mesh of 4 of the 8 virtual
CPU devices and against one process stepping the graph-weighted union of
the two rows' batches (the JAX check's bar, 1e-4)."""

import pickle

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from tf_gnn_samples_tpu.parallel.data_parallel import (
    stack_task_batches, unify_batch_windows)
from tf_gnn_samples_tpu.parallel.graph_parallel import (
    partition_task_batch, partition_task_batch_halo)
from tf_gnn_samples_tpu.parallel.multihost import make_hybrid_gp_train_step
from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_torch.parallel import _multihost_check as check
from tf_gnn_samples_torch.parallel import graph_parallel as gp
from tf_gnn_samples_torch.parallel.multihost import hybrid_layout
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9

from test_torch_graph_parallel_steps import (
    PARAMS, assert_weights_close, jax_model)

RANKS = 4
CASES = ["%s %s %s" % (m, o, s) for m in check.GP_MODELS
         for o in check.GP_OPTIMIZERS for s in check.HYBRID_STRATEGIES]


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    """What each of the four ranks saw, started from the JAX package's
    initial weights of each model; and those weights."""
    out = tmp_path_factory.mktemp("hybrid")
    init = {name: j_model.flatten_params(jax.device_get(
        jax_model(name, "tuned")[0].model_params_tree))
        for name in check.GP_MODELS}
    path = str(out / "init.pickle")
    with open(path, "wb") as f:
        pickle.dump({k: {n: np.asarray(v) for n, v in w.items()}
                     for k, w in init.items()}, f)
    line = check.run_multihost_check(RANKS, out_dir=str(out), kind="hybrid",
                                     init=path)
    assert "MULTIHOST_OK processes=4" in line and "dp=2 gp=2" in line
    return [torch.load(str(out / ("rank%d.pt" % r)), weights_only=False)
            for r in range(RANKS)], init


def test_hybrid_layout_keeps_gp_groups_inside_a_host():
    """Rows are consecutive ranks of one host (gp collectives stay inside
    it, dp crosses hosts); gp must divide every host's rank count, dp x gp
    must be the world size, and a host's ranks must be consecutive."""
    two_hosts = ["a"] * 4 + ["b"] * 4
    assert hybrid_layout(two_hosts, 2) == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert hybrid_layout(two_hosts, 4) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert hybrid_layout(["a"] * 4, 2, dp=2) == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="gp=3 must divide the local "
                       "device count 4"):
        hybrid_layout(two_hosts, 3)
    with pytest.raises(ValueError, match="gp=8 must divide"):
        hybrid_layout(two_hosts, 8)
    with pytest.raises(ValueError, match=r"dp\*gp=6 != 8 global devices"):
        hybrid_layout(two_hosts, 2, dp=3)
    with pytest.raises(ValueError, match="must be consecutive"):
        hybrid_layout(["a", "b", "a", "b"], 2)


@pytest.mark.parametrize("case", CASES)
def test_hybrid_step_matches_the_union_step(case, hybrid):
    """Row r stepped the r-th batch partitioned over its two ranks: every
    rank's parameters within 1e-4 of one process stepping the two batches'
    graph-weighted union from the same state (and within rtol 2e-4 / atol
    1e-6); the four ranks' parameters and metrics equal bit for bit;
    total_graphs the two batches' sum and the loss the union's
    graph-weighted loss; the step moved the parameters."""
    ranks, _ = hybrid
    r0 = ranks[0]
    assert [r["row"] for r in ranks] == [0, 0, 1, 1]
    assert [r["gp_rank"] for r in ranks] == [0, 1, 0, 1]
    rec = r0["steps"][case]
    for k, v in rec["union"].items():
        assert float(np.abs(rec["train"][k] - v).max()) < 1e-4, k
        np.testing.assert_allclose(rec["train"][k], v, rtol=2e-4, atol=1e-6,
                                   err_msg=k)
    for r in ranks[1:]:
        for k, v in rec["train"].items():
            assert np.array_equal(r["steps"][case]["train"][k], v), k
    assert float(rec["metrics"]["total_graphs"]) == sum(r0["num_graphs"])
    name, opt, _ = case.split(" ")
    np.testing.assert_allclose(float(rec["metrics"]["loss"]),
                               r0["union_loss_%s %s" % (name, opt)],
                               rtol=1e-5)
    assert max(float(np.abs(rec["train"][k] - rec["init"][k]).max())
               for k in rec["init"]) > 1e-4


def test_the_rows_step_batches_of_different_sizes(hybrid):
    """The two rows' batches hold different graph counts, so a dp sum
    weighted by graphs and an unweighted mean differ."""
    n = hybrid[0][0]["num_graphs"]
    assert len(n) == 2 and n[0] != n[1]


_JAX_STEPS = {}


def jax_hybrid_step(case, init):
    """The JAX package's make_hybrid_gp_train_step on a (dp 2, gp 2) mesh
    of 4 virtual devices from `init`, row r the r-th TRAIN batch, its
    shards by `case`'s strategy (the rows' edge budget and halo_pad pinned
    to the larger row's, as the rows stack into one array): (weights
    after the step, metrics); once a case."""
    if case in _JAX_STEPS:
        return _JAX_STEPS[case]
    name, optimizer, strategy = case.split(" ")
    jm, task = jax_model(name, optimizer)
    jm.model_params_tree = j_model.unflatten_like(jm.model_params_tree,
                                                  init[name])
    dp, gpn = RANKS // check.HYBRID_GP, check.HYBRID_GP
    rows = unify_batch_windows(check.step_batches(task, j_base, dp))
    n_pad = rows[0].graph.n_pad
    assert all(b.graph.n_pad == n_pad for b in rows)
    budget = max(gp.batch_edge_budget(b) for b in check.step_batches(
        check.qm9_task(t_qm9, t_base, buckets=1), t_base, dp))
    if strategy == "halo":
        pad = max(partition_task_batch_halo(b, gpn, n_pad, budget)[3]
                  for b in rows)
        shard_rows = [partition_task_batch_halo(
            b, gpn, n_pad, budget, halo_pad_target=pad)[0] for b in rows]
    else:
        shard_rows = [partition_task_batch(b, gpn, n_pad, budget)[0]
                      for b in rows]
    # [dp rows of [gp, ...]] -> [dp * gp, ...], dp-major.
    shards = jax.tree_util.tree_map(
        lambda *xs: np.concatenate([np.asarray(x) for x in xs], axis=0),
        *shard_rows)
    mesh = Mesh(np.array(jax.devices()[:RANKS]).reshape(dp, gpn),
                ("dp", "gp"))
    step = make_hybrid_gp_train_step(jm, mesh)
    p0 = jax.tree_util.tree_map(jax.numpy.copy, jm.model_params_tree)
    params, _, metrics = step(p0, jm._optimizer.init(p0),
                              jax.random.PRNGKey(0), stack_task_batches(rows),
                              shards)
    _JAX_STEPS[case] = (j_model.flatten_params(jax.device_get(params)),
                        {k: np.asarray(v) for k, v in
                         jax.device_get(metrics).items()})
    return _JAX_STEPS[case]


@pytest.mark.parametrize("case", CASES)
def test_hybrid_step_matches_jax(case, hybrid):
    """Every rank's parameters after the hybrid step, and its metrics
    (total_graphs among them), within rtol 2e-4 / atol 1e-6 of the JAX
    package's hybrid step from the same weights over the same two
    batches; the ranks started from the JAX weights."""
    ranks, init = hybrid
    name = case.split(" ")[0]
    want, metrics = jax_hybrid_step(case, init)
    assert float(metrics["total_graphs"]) == sum(ranks[0]["num_graphs"])
    for r in ranks:
        rec = r["steps"][case]
        for k, v in rec["init"].items():
            assert np.array_equal(v, np.asarray(init[name][k])), k
        assert_weights_close(rec["train"], want, **PARAMS)
        assert rec["metrics"].keys() == metrics.keys()
        for k, v in metrics.items():
            np.testing.assert_allclose(rec["metrics"][k], v, err_msg=k,
                                       **PARAMS)
