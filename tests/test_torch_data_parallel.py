"""The port's data parallelism (tf_gnn_samples_torch/parallel/: one process
a replica over torch.distributed) against the JAX package's (a shard_map
step over a mesh of virtual CPU devices), on the CPU with gloo: two ranks
started by parallel/_multihost_check.py at a file:// rendezvous under the
test's temporary directory (no port is shared between test workers). The
ranks' dp step against make_dp_train_step on 2 of the 8 virtual devices
and against one process stepping the union batch; their eval metrics,
each and reduced, against make_dp_eval_step; a short final group padded
with a zero-weight clone; cached and scanned dp epochs, equal on both
ranks; cached dp epochs against the JAX package's _run_epoch_dp; and the
checks' messages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tf_gnn_samples_tpu.parallel import make_dp_train_step, make_mesh
from tf_gnn_samples_tpu.parallel import stack_task_batches
from tf_gnn_samples_tpu.parallel.data_parallel import make_dp_eval_step
from tf_gnn_samples_tpu.runtime import model as j_model
from tf_gnn_samples_tpu.tasks import base as j_base
from tf_gnn_samples_tpu.tasks import qm9 as j_qm9
from tf_gnn_samples_torch.parallel import _multihost_check as check
from tf_gnn_samples_torch.parallel import multihost
from tf_gnn_samples_torch.runtime import model as t_model
from tf_gnn_samples_torch.tasks import base as t_base
from tf_gnn_samples_torch.tasks import qm9 as t_qm9

RANKS = 2
# tests/test_runtime.py test_dp_matches_single_device's bar.
PARAMS = dict(rtol=2e-4, atol=1e-6)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """What each of the two ranks of _multihost_check.main saw."""
    out = tmp_path_factory.mktemp("dp")
    line = check.run_multihost_check(RANKS, out_dir=str(out))
    assert "MULTIHOST_OK processes=2" in line
    return [torch.load(str(out / ("rank%d.pt" % r)), weights_only=False)
            for r in range(RANKS)]


@pytest.fixture(scope="module")
def jax_side(ranks):
    """The JAX package's RGCN at the ranks' config and initial weights,
    and its batches of the same graphs (one shape a fold)."""
    task = check.qm9_task(j_qm9, j_base, buckets=1)
    params = check.model_params(j_model.RGCN_Model, **check.STEP_OVERRIDES)
    model = j_model.RGCN_Model(params, task, "j", "unused")
    model.model_params_tree = j_model.unflatten_like(
        model.model_params_tree, ranks[0]["init"])
    batches = check.step_batches(task, j_base, RANKS + 1)
    assert [int(b.num_graphs) for b in batches] == ranks[0]["num_graphs"]
    return model, batches


def assert_weights_close(got, want, **tol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_dp_step_matches_jax_and_the_union_step(ranks, jax_side):
    """Rank r stepped batch r: every rank's parameters after the step
    equal each other's bit for bit, the JAX package's 2-device dp step's
    and one process's step over the union batch (graph-weighted mean loss,
    clipped, one update), within rtol 2e-4 / atol 1e-6."""
    jm, batches = jax_side
    p0 = jax.tree_util.tree_map(jnp.copy, jm.model_params_tree)
    step = make_dp_train_step(jm, make_mesh(RANKS))
    jparams, _, _ = step(p0, jm._optimizer.init(p0), jax.random.PRNGKey(0),
                         stack_task_batches(batches[:RANKS]))
    want = j_model.flatten_params(jax.device_get(jparams))
    for r in range(RANKS):
        for k in want:
            assert np.array_equal(ranks[r]["dp_step"][k],
                                  ranks[0]["dp_step"][k]), k
    assert_weights_close(ranks[0]["dp_step"], want, **PARAMS)
    assert_weights_close(ranks[0]["dp_step"], ranks[0]["union_step"],
                         **PARAMS)
    assert_weights_close(ranks[0]["union_step"], want, **PARAMS)
    moved = max(float(np.abs(want[k] - ranks[0]["init"][k]).max())
                for k in want)
    assert moved > 1e-4  # the step moved the weights


def test_dp_eval_metrics_match_jax(ranks, jax_side):
    """Each rank's eval metrics are the JAX dp eval step's for its
    device's batch; the reduced ones (every rank's the same) are its
    reduce_metrics output: each metric summed, loss = total_loss /
    total_graphs."""
    jm, batches = jax_side
    stacked = stack_task_batches(batches[:RANKS])
    mesh = make_mesh(RANKS)
    per_device = jax.device_get(make_dp_eval_step(jm, mesh)(
        jm.model_params_tree, stacked))
    reduced = jax.device_get(make_dp_eval_step(
        jm, mesh, reduce_metrics=True)(jm.model_params_tree, stacked))
    for r in range(RANKS):
        assert ranks[r]["eval"].keys() == per_device.keys()
        for k, v in per_device.items():
            np.testing.assert_allclose(ranks[r]["eval"][k], v[r], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        assert ranks[r]["eval_reduced"].keys() == reduced.keys()
        for k, v in reduced.items():
            np.testing.assert_allclose(ranks[r]["eval_reduced"][k], v,
                                       rtol=1e-5, atol=1e-6, err_msg=k)


def test_dp_step_reduces_metrics_by_graph_weight(ranks):
    """The train step's reduced metrics (the JAX package's multi-host step:
    sum(v * n) / sum(n), and total_graphs) from the ranks' own metrics on
    the same state (no dropout: the eval step's)."""
    n = np.array(ranks[0]["num_graphs"][:RANKS], np.float64)
    for r in range(RANKS):
        red = ranks[r]["dp_step_reduced"]
        assert float(red["total_graphs"]) == n.sum()
        for k, v in red.items():
            if k == "total_graphs":
                continue
            want = sum(float(ranks[q]["eval"][k]) * n[q]
                       for q in range(RANKS)) / n.sum()
            np.testing.assert_allclose(float(v), want, rtol=1e-5, err_msg=k)


def test_short_final_group_padded_with_a_zero_weight_batch(ranks):
    """Rank 0 stepped the last batch, rank 1 a zero-weight clone of it
    (its gradient buffer finite and exactly zero, checked in the rank):
    the step equals one process stepping that batch alone."""
    assert_weights_close(ranks[0]["padded_step"], ranks[0]["alone_step"],
                         **PARAMS)
    for k, v in ranks[0]["padded_step"].items():
        assert np.array_equal(ranks[1]["padded_step"][k], v), k


def test_cached_dp_epochs_agree_across_ranks(ranks):
    """3 epochs with the cache and scan_epochs, re-packed every 2 (TRAIN
    built at epochs 1 and 3, scanned at 2; VALIDATION built at 1, scanned
    after): both ranks step the replica groups in the same order and log
    the same per-batch losses and epoch losses; every epoch counts the
    whole fold once; the train loss falls."""
    a, b = ranks[0]["epochs"], ranks[1]["epochs"]
    assert a == b
    assert len(a) == 2 * check.EPOCHS
    for e in a:
        graphs = (check.TRAIN_GRAPHS if e["fold"] == "TRAIN"
                  else check.VALID_GRAPHS)
        assert e["graphs"] == graphs
        assert sorted(e["order"]) == list(range(len(e["order"])))
        assert np.isfinite(e["losses"]).all()
    train = [e for e in a if e["fold"] == "TRAIN"]
    assert train[-1]["loss"] < train[0]["loss"]
    # The scanned epoch drew its own group order.
    assert train[1]["order"] != list(range(len(train[1]["order"])))


@pytest.mark.parametrize("case", ["both_options", "no_process_group",
                                  "more_replicas_than_ranks",
                                  "nccl_more_ranks_than_gpus"])
def test_checks_raise_with_their_messages(case, ranks, tmp_path):
    if case == "more_replicas_than_ranks":
        assert ranks[0]["too_many_replicas"] == (
            "num_model_replicas=3 but the process group has 2 ranks (one "
            "rank a replica)")
        return
    if case == "nccl_more_ranks_than_gpus":
        if torch.cuda.is_available():
            pytest.skip("this host has a GPU for the one rank")
        with pytest.raises(ValueError, match="NCCL needs a GPU a rank"):
            multihost.initialize("file://%s" % (tmp_path / "store"), 1, 0,
                                 device="cuda", backend="nccl")
        assert not torch.distributed.is_initialized()
        return
    task = check.qm9_task(t_qm9, t_base)
    params = check.model_params(t_model.RGCN_Model, num_model_replicas=2,
                                **check.STEP_OVERRIDES)
    if case == "both_options":
        params["graph_parallel"] = 2
        with pytest.raises(ValueError, match="mutually exclusive"):
            t_model.RGCN_Model(params, task, "t", str(tmp_path),
                               device="cpu")
        return
    model = t_model.RGCN_Model(params, task, "t", str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="--coordinator HOST:PORT "
                       "--num-hosts N --host-id I"):
        model._run_epoch("x", task._loaded_data[t_base.DataFold.TRAIN],
                         t_base.DataFold.TRAIN, quiet=True)


def test_cached_dp_epochs_match_jax(ranks):
    """The ranks' cached RGCN dp epochs (folds packed in several shapes,
    two epochs from np.random.seed(3)) against the JAX package's
    _run_epoch_dp with num_model_replicas 2 on 2 of the 8 virtual devices
    from the same weights and seed: the same replica groups in the same
    order (each fold's per-batch losses, padding dropped, in step order),
    the epoch losses and the final weights, within
    tests/test_torch_scan_epochs.py's tolerances (losses rtol 1e-5;
    weights rtol 1e-5, atol 5e-4)."""
    task = check.qm9_task(j_qm9, j_base)
    params = check.model_params(j_model.RGCN_Model, num_model_replicas=RANKS,
                                cache_batches_on_device=True,
                                **check.STEP_OVERRIDES)
    jm = j_model.RGCN_Model(params, task, "j", "unused")
    jm.model_params_tree = j_model.unflatten_like(
        jm.model_params_tree, ranks[0]["jax_epochs_init"])
    jm.opt_state = jm._optimizer.init(jm.model_params_tree)
    np.random.seed(check.JAX_SEED)
    want = []
    for _ in range(check.JAX_EPOCHS):
        for fold in (j_base.DataFold.TRAIN, j_base.DataFold.VALIDATION):
            loss, metrics, *_ = jm._run_epoch(
                "j", task._loaded_data[fold], fold, quiet=True)
            want.append((fold.name, loss,
                         [float(m["loss"]) for m in metrics]))
    got = ranks[0]["jax_epochs"]
    assert got == ranks[1]["jax_epochs"]
    assert len(jm._dp_group_cache[j_base.DataFold.TRAIN][0]) > 1
    for (gf, gl, gls), (wf, wl, wls) in zip(got, want):
        assert gf == wf and len(gls) == len(wls), (gf, len(gls), len(wls))
        np.testing.assert_allclose(gls, wls, rtol=1e-5)
        np.testing.assert_allclose(gl, wl, rtol=1e-5)
    assert_weights_close(ranks[0]["jax_epochs_weights"],
                         j_model.flatten_params(jax.device_get(
                             jm.model_params_tree)), rtol=1e-5, atol=5e-4)


def small_task(name, tmp_path):
    """A task over a small fold: QM9's from the bundled data, the others
    written by tools/synthetic_data.py."""
    from tf_gnn_samples_torch.tools import synthetic_data as sd
    from tf_gnn_samples_torch.utils.registry import name_to_task_class

    if name == "QM9":
        return check.qm9_task(t_qm9, t_base)
    if name == "PPI":
        path = sd.make_synthetic_ppi(
            str(tmp_path), folds={"train": 2, "valid": 1, "test": 1},
            min_nodes=100, max_nodes=200, fwd_edges_per_node=4)
    elif name == "cora":
        path = sd.make_synthetic_planetoid(
            str(tmp_path), dataset="cora", num_nodes=700, num_edges=1400,
            num_features=20, num_classes=4, num_train=20, num_test=40)
    else:
        path = sd.make_synthetic_varmisuse(
            str(tmp_path), folds={"train": 3, "valid": 1, "test": 1},
            min_nodes=60, max_nodes=120)
    cls, extra = name_to_task_class(name)
    task = cls({**cls.default_params(), **extra})
    task.load_data(path)
    return task


@pytest.mark.parametrize("task_name", ["QM9", "PPI", "cora", "VarMisuse"])
def test_zero_weight_clone_is_finite_and_contributes_nothing(task_name,
                                                            tmp_path):
    """Each task's head on a zero-weight clone of a train batch (masks
    zeroed, num_graphs 0; parallel/data_parallel.py empty_like_batch):
    the loss and every gradient finite, and this rank's share of the
    step's buffer exactly zero, so the clone pads a replica group without
    moving the sum (0 * NaN would be NaN)."""
    from tf_gnn_samples_torch.parallel import data_parallel as dp
    from tf_gnn_samples_torch.utils.registry import name_to_model_class

    task = small_task(task_name, tmp_path)
    mcls, extra = name_to_model_class("GNN-FiLM")
    params = {**mcls.default_params(), **extra, "hidden_size": 16,
              "graph_num_layers": 2, "max_nodes_in_batch": 5000}
    model = mcls(params, task, "t", str(tmp_path), device="cpu")
    fold = t_base.DataFold.TRAIN
    batch = next(iter(task.make_minibatch_iterator(
        task._loaded_data[fold], fold, params["max_nodes_in_batch"])))
    empty = dp.empty_like_batch(batch)
    assert empty.num_graphs == empty.graph.num_graphs == 0
    loss, _ = model._forward(model.model_params_tree, empty, None)
    grads = torch.autograd.grad(loss, model._leaves(), allow_unused=True)
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all()) for g in grads if g is not None)
    buf, _ = dp.local_grads(model, empty, model._dropout_gen)
    assert buf.shape[0] == sum(p.numel() for p in model._leaves()) + 1
    assert not bool(buf.any())
